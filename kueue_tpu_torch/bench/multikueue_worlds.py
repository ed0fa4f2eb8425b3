"""The MultiKueue world of ``chip_smoke.py`` phase 33: a manager and three
worker engines, every one running its own device cycles, with two
MultiKueue controllers between them.

The manager is ``cycle_latency``'s world (``engine_worlds.FULL``,
``bench.py``'s ``baseline_like``: 200 cohorts x 5 = 1,000 ClusterQueues,
50,000 pending entries). Its ClusterQueues carry an admission check:
those of index ``% incremental_every == 0`` ``INCR_CHECK``, the rest
``MAIN_CHECK``. The workers ``worker1``, ``worker2`` and ``worker3``
each hold the same flavor, cohorts, ClusterQueues and LocalQueues, with
no check; ``worker1``'s quotas are ``1 / worker1_share`` of the
manager's, and its ``INCR_CHECK`` ClusterQueues preempt lower priorities
within the queue and start full, each with a local job of priority 0
admitted in one host cycle before the run.

The controllers:

  * ``main`` (``MAIN_CHECK``, AllAtOnce over ``worker1``, ``worker3``,
    ``worker2`` in that order): a copy of each reserved workload goes to
    every worker, the first worker in order to admit its copy wins and
    the other copies are deleted, so once ``worker1`` is full the win
    falls through to ``worker3`` (to ``worker2`` while ``worker3`` is
    lost).
    ``worker1`` and ``worker2`` are connected directly, ``worker3``
    through a ``RemoteClient`` over a kubeconfig file. Every
    ``jobs_every``-th entry of its share is a BatchJob created through
    the manager's ``JobReconciler``, and the winner's ``JobReconciler``
    gets the mirrored job (``attach_job_framework``).
  * ``incr`` (``INCR_CHECK``, Incremental, one cluster a round of
    ``round_seconds`` on the manager's clock, its own origin label):
    orchestrated preemption (remote copies behind a closed preemption
    gate, one cluster's gate opened at a time) and quota automation (the
    manager ClusterQueues' nominal set to the workers' sum), both from
    their gates, which ``run`` turns on and restores after.

The run: ``cycles`` cycles, each ``manager.schedule_once``, both
controllers' ``reconcile``, every worker's ``schedule_once``, both
``reconcile`` again (``tests/test_multikueue.py``'s pump), then: every
``finish_every``-th workload the cycle placed finishes on its worker (the
next reconcile syncs it back), each worker's ``JobReconciler`` reconciles
its jobs, and every engine's clock moves ``tick`` seconds. After cycle
``lost_at`` ``worker3``'s connection is lost: the manager evicts what it
placed there, every second copy admitted on ``worker3`` finishes during
the outage, ``outage_reconciles`` reconciles ``outage_step`` seconds
apart retry the connection under the ``retry_after`` backoff, then the
kubeconfig is rewritten and the next reconcile reconnects, so the next
cycle adopts the copies left on ``worker3`` and propagates the finished
ones instead of running them again. After cycle ``delete_at`` every
``delete_every``-th manager workload that ``incr`` has dispatched and
not placed is deleted (a user deleting it), which leaves its copies to
the origin-labeled orphan GC.

Uids and job workload names come from process-wide counters in both
packages: ``run`` starts them at fixed values and restores them after.
Each function takes a ``Kit`` (``engine_worlds.Kit``); the port's is the
default, and the tests pass the JAX package's to compute the same run
there.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import shutil
import tempfile
import time
import types
import zlib
from contextlib import contextmanager

from kueue_tpu_torch.bench import engine_worlds as ew

FULL = {"multikueue_world": dict(
    n_cohorts=200, cqs_per_cohort=5, n_entries=50_000, cycles=9,
    worker1_share=40, incremental_every=10, jobs_every=25, finish_every=5,
    lost_at=3, outage_reconciles=4, outage_step=20.0, delete_at=5,
    delete_every=3, tick=60.0, round_seconds=120.0, retry_increment=10.0,
    arm="full")}
# The small twin the CPU tests run against the JAX engine.
SMALL = {"multikueue_world": dict(FULL["multikueue_world"], n_cohorts=4,
                                  n_entries=800)}

WORKERS = ("worker1", "worker2", "worker3")
# ``main``'s order: a copy that worker1 cannot take is won on worker3,
# the worker reached through the kubeconfig, before worker2.
MAIN_ORDER = ("worker1", "worker3", "worker2")
MAIN_CHECK = "multikueue"
INCR_CHECK = "multikueue-incremental"
INCR_ORIGIN = "multikueue-incremental"
REMOTE = "worker3"  # the worker reached through a kubeconfig
ORIGIN_LABEL = "kueue.x-k8s.io/multikueue-origin"
GATES = ("MultiKueueOrchestratedPreemption",
         "MultiKueueManagerQuotaAutomation")
UID_START = 95_000_001
CPU = "cpu"
# The kubeconfig's two versions carry explicit mtimes, so the rewrite is
# seen on any filesystem's timestamp granularity.
MTIMES_NS = (1_000_000_000_000_000_000, 1_000_000_001_000_000_000)
ENGINES = ("manager",) + WORKERS

# What a run must reproduce against the JAX engines: per engine the
# PINNED numbers and pipeline_stats, and the controllers' counts.
COUNTS = ("evicted", "dispatched", "remote_deletes", "gc_collected",
          "gates_opened", "remote_finishes", "finishes_synced",
          "outage_finishes", "outage_propagated", "adopted",
          "connect_failures", "deleted", "quota_automated", "jobs_mirrored",
          "jobs_started", "fell_through", "rounds_grown")


@contextmanager
def pinned_counters(kit):
    t, jf = kit.types, kit.jobframework
    old = (t._uid_counter, jf._wl_suffix)
    t._uid_counter = itertools.count(UID_START)
    jf._wl_suffix = itertools.count(1)
    try:
        yield
    finally:
        t._uid_counter, jf._wl_suffix = old


@contextmanager
def gates_on(features):
    """The world's two gates on; their values restored after."""
    before = {name: features.enabled(name) for name in GATES}
    for name in GATES:
        features.set_feature(name, True)
    try:
        yield
    finally:
        features.apply(before)


class Fabric:
    """The kubeconfig's transport: endpoint name -> worker engine, with
    the endpoints that are down; ``connect`` raises for those, as a
    client build against a dead cluster does."""

    def __init__(self, workers: dict):
        self.workers = workers
        self.down: set = set()
        self.failures = 0

    def connect(self, config: dict):
        ep = config["endpoint"]
        if ep in self.down or ep not in self.workers:
            self.failures += 1
            raise ConnectionError(f"endpoint {ep} unreachable")
        return self.workers[ep]


def write_kubeconfig(path: str, endpoint: str, mtime_ns: int) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"endpoint": endpoint, "credential": "good"}, fh)
    os.utime(path, ns=(mtime_ns, mtime_ns))


def _cluster_queue(t, cq, checks=(), nominal=None, preempt=False):
    """``cq`` with ``checks``, its one flavor's cpu nominal set to
    ``nominal`` when given, and LowerPriority preemption within the
    queue when ``preempt``."""
    rg = cq.resource_groups[0]
    fq = rg.flavors[0]
    if nominal is not None:
        fq = t.FlavorQuotas(fq.name, {CPU: t.ResourceQuota(nominal)})
    kw = {}
    if preempt:
        kw["preemption"] = t.ClusterQueuePreemption(
            within_cluster_queue=t.PreemptionPolicy.LOWER_PRIORITY)
    return t.ClusterQueue(name=cq.name, cohort=cq.cohort,
                          resource_groups=(t.ResourceGroup(
                              rg.covered_resources, (fq,)),),
                          admission_checks=tuple(checks), **kw)


def _world_engine(kit, scen, cqs):
    eng = kit.engine(False)
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts:
        eng.create_cohort(co)
    for cq in cqs:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues:
        eng.create_local_queue(lq)
    return eng


def build(config: dict, kit, workdir: str):
    """The world of ``config`` (an entry of FULL or SMALL), oracles
    attached. Returns a namespace: ``engines`` (name -> engine, the
    manager first), ``main``, ``incr``, ``fabric``, ``kubeconfig``,
    ``recs`` (name -> JobReconciler), ``build_s`` (seconds to create the
    entries)."""
    t, mkm, ac = kit.types, kit.multikueue, kit.admissionchecks
    jf = kit.jobframework
    scen = kit.scenario.baseline_like(
        n_cohorts=config["n_cohorts"],
        cqs_per_cohort=config["cqs_per_cohort"],
        n_workloads=config["n_entries"])
    incr_cqs = {cq.name for i, cq in enumerate(scen.cluster_queues)
                if i % config["incremental_every"] == 0}
    manager = _world_engine(kit, scen, [
        _cluster_queue(t, cq, (INCR_CHECK if cq.name in incr_cqs
                               else MAIN_CHECK,))
        for cq in scen.cluster_queues])
    acm = ac.AdmissionCheckManager(manager)
    for check in (MAIN_CHECK, INCR_CHECK):
        acm.create_admission_check(ac.AdmissionCheck(check))
    engines = {"manager": manager}
    for name in WORKERS:
        cqs = list(scen.cluster_queues)
        if name == "worker1":
            cqs = [_cluster_queue(
                t, cq, nominal=cq.resource_groups[0].flavors[0]
                .resources[CPU].nominal // config["worker1_share"],
                preempt=cq.name in incr_cqs) for cq in cqs]
        engines[name] = _world_engine(kit, scen, cqs)
    # worker1's own jobs: one of priority 0 filling each INCR_CHECK
    # ClusterQueue's nominal, admitted in a host cycle before the run.
    worker1 = engines["worker1"]
    for cq in scen.cluster_queues:
        if cq.name in incr_cqs:
            worker1.submit(t.Workload(
                name=f"local-{cq.name}",
                queue_name=f"lq-{cq.name.rsplit('-', 1)[1]}", priority=0,
                pod_sets=(t.PodSet("main", 1, {CPU: worker1.cache
                          .cluster_queues[cq.name].resource_groups[0]
                          .flavors[0].resources[CPU].nominal}),)))
    worker1.schedule_once()
    w = types.SimpleNamespace(engines=engines, incr_cqs=incr_cqs)
    recs = w.recs = {name: jf.JobReconciler(eng)
                     for name, eng in engines.items()}

    w.fabric = Fabric({REMOTE: engines[REMOTE]})
    w.kubeconfig = os.path.join(workdir, f"{REMOTE}.kubeconfig")
    write_kubeconfig(w.kubeconfig, REMOTE, MTIMES_NS[0])
    main = w.main = mkm.MultiKueueController(
        manager, MAIN_CHECK, mkm.MultiKueueConfig(clusters=list(MAIN_ORDER)),
        dispatcher=mkm.Dispatcher.ALL_AT_ONCE)
    for name in WORKERS:
        if name != REMOTE:
            main.connect_cluster(name, engines[name])
    main.add_remote_cluster(REMOTE, w.kubeconfig, w.fabric.connect,
                            retry_increment=config["retry_increment"])
    main.attach_job_framework(recs["manager"],
                              {name: recs[name] for name in WORKERS})
    incr = w.incr = mkm.MultiKueueController(
        manager, INCR_CHECK, mkm.MultiKueueConfig(
            clusters=list(WORKERS),
            quota_management=mkm.QUOTA_MANAGEMENT_AUTOMATED),
        dispatcher=mkm.Dispatcher.INCREMENTAL, increment=1,
        round_seconds=config["round_seconds"],
        orchestrated_preemption=kit.features.enabled(
            "MultiKueueOrchestratedPreemption"))
    incr.origin = INCR_ORIGIN
    for name in WORKERS:
        incr.connect_cluster(name, engines[name])

    t0 = time.perf_counter()
    n_main = 0
    for i, e in enumerate(scen.workloads):
        manager.clock += 0.0001
        size = e.pod_sets[0].requests[CPU]
        cq = f"cq-{e.queue_name.rsplit('-', 1)[1]}"
        if cq not in incr_cqs:
            n_main += 1
            if n_main % config["jobs_every"] == 0:
                recs["manager"].create_job(jf.BatchJob(
                    name=f"job-{i}", queue_name=e.queue_name,
                    parallelism=1, requests={CPU: size},
                    priority=e.priority))
                continue
        manager.submit(t.Workload(
            name=f"wl-{i}", queue_name=e.queue_name, priority=e.priority,
            pod_sets=(t.PodSet("main", 1, {CPU: size}),)))
    w.build_s = time.perf_counter() - t0
    for eng in engines.values():
        kit.attach(eng)
    return w


def _count_deletes(mk, out) -> None:
    """Count every remote copy ``mk`` deletes (``remote_deletes``) and
    those its orphan GC deletes (``gc_collected``), through wrappers on
    the instance."""
    inner_delete, inner_gc = mk._delete_remote, mk.run_gc
    in_gc = [False]

    def _delete_remote(cluster, key):
        worker = mk.clusters.get(cluster)
        if worker is not None and key in worker.workloads:
            out["remote_deletes"] += 1
            if in_gc[0]:
                out["gc_collected"] += 1
        inner_delete(cluster, key)

    def run_gc():
        in_gc[0] = True
        try:
            inner_gc()
        finally:
            in_gc[0] = False

    mk._delete_remote = _delete_remote
    mk.run_gc = run_gc


def run(config: dict, kit=None, around=None) -> dict:
    """Build and drive the world of ``config`` on its loop arm, the
    world's gates on. ``around(name, fn)``, when given, makes each
    engine's ``schedule_once`` call (``fn()``) and returns its result
    (``chip_smoke.py`` counts each engine's heads launches there).
    Returns, per engine under its name, the PINNED numbers,
    ``pipeline_stats``, ``evicted`` and the ``cycle_seconds`` and
    ``phases`` of every cycle but the first; the COUNTS; ``reconcile_s``
    (both controllers' reconciles, seconds per cycle); ``build_s`` and
    ``engines``."""
    kit = kit or ew.port_kit()
    workdir = tempfile.mkdtemp(prefix="multikueue-world-")
    try:
        with ew.loop_arm(config.get("arm")), pinned_counters(kit), \
                gates_on(kit.features):
            return _run(config, kit, around or (lambda name, fn: fn()),
                        workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(config, kit, around, workdir) -> dict:
    w = build(config, kit, workdir)
    engines, main, incr = w.engines, w.main, w.incr
    mkm = kit.multikueue
    out = {"build_s": w.build_s, "reconcile_s": []}
    out.update(dict.fromkeys(COUNTS, 0))
    per = {}
    for name, eng in engines.items():
        per[name] = dict.fromkeys(ew.PINNED, 0)
        per[name].update(cycle_seconds=[], phases=[], timing=False,
                         calls=0, engine_s=0.0, pipeline=[])
        ew._instrument(eng, per[name])
    for mk in (main, incr):
        _count_deletes(mk, out)
    opened: set = set()
    placed: set = set()
    grown: set = set()

    def cycle(name, k):
        eng = engines[name]
        per[name]["timing"] = k > 1  # the first encodes every row
        r = around(name, eng.schedule_once)
        p = per[name]
        p["checksum"] = zlib.crc32(ew.decision_stream(r), p["checksum"])
        if r is not None:
            p["cycles"] += 1
            p["admitted"] += r.stats.admitted
            p["preempting"] += r.stats.preempting

    def reconcile():
        t0 = time.perf_counter()
        main.reconcile()
        incr.reconcile()
        dt = time.perf_counter() - t0
        for name in WORKERS:
            for key, remote in engines[name].workloads.items():
                if mkm.MULTIKUEUE_PREEMPTION_GATE in \
                        remote.status.open_preemption_gates:
                    opened.add((name, key))
        for key, st in incr.states.items():
            if len(st.nominated) > 1:
                grown.add(key)
        return dt

    manager = engines["manager"]
    for eng in engines.values():
        eng.apply_serving_gc_posture()
    try:
        for k in range(1, config["cycles"] + 1):
            cycle("manager", k)
            spent = reconcile()
            for name in WORKERS:
                cycle(name, k)
            spent += reconcile()
            out["reconcile_s"].append(spent)
            won = []
            for mk in (main, incr):
                for key, st in mk.states.items():
                    if st.cluster_name is not None and \
                            (mk.check_name, key) not in placed:
                        placed.add((mk.check_name, key))
                        won.append((mk, key, st.cluster_name))
                        if st.cluster_name != MAIN_ORDER[0] and \
                                mk is main:
                            out["fell_through"] += 1
            for n, (mk, key, cluster) in enumerate(won):
                worker = mk.clusters.get(cluster)
                remote = (worker.workloads.get(key)
                          if worker is not None else None)
                if n % config["finish_every"] == 0 and remote is not None \
                        and remote.is_admitted:
                    worker.finish(key)
                    out["remote_finishes"] += 1
            for name in WORKERS:
                w.recs[name].reconcile_all()
            for eng in engines.values():
                eng.tick(config["tick"])
            if k == config["lost_at"]:
                _outage(config, w, out)
            if k == config["lost_at"] + 1:
                _adopted(w, out)
            if k == config["delete_at"]:
                _delete_waiting(config, w, out)
    finally:
        gc.enable()
        gc.unfreeze()
    for name, eng in engines.items():
        p = per[name]
        b = eng.oracle
        evicted: dict = {}
        for e in eng.events:
            if e.kind == "Evicted":
                evicted[e.detail] = evicted.get(e.detail, 0) + 1
        p.update(on_device=b.cycles_on_device, hybrid=b.cycles_hybrid,
                 fallback=b.cycles_fallback,
                 preemptions=eng.metrics.preemptions_total,
                 pipeline_stats=dict(b.pipeline_stats),
                 evicted=dict(sorted(evicted.items())))
        out[name] = p
    out["evicted"] = sum(sum(out[n]["evicted"].values()) for n in ENGINES)
    fam = manager.registry.counter("workloads_dispatched_total")
    out["dispatched_by"] = {"/".join(k): int(v)
                            for k, v in sorted(fam.values.items())}
    out["dispatched"] = sum(out["dispatched_by"].values())
    out["gates_opened"] = len(opened)
    out["rounds_grown"] = len(grown)
    out["finishes_synced"] = sum(1 for wl in manager.workloads.values()
                                 if wl.is_finished)
    out["connect_failures"] = w.fabric.failures
    out["quota_automated"] = sum(
        1 for ok, reason, _m in incr.cq_conditions.values()
        if ok and reason == "QuotaAutomated")
    jobs = [job for name in WORKERS for job in w.recs[name].jobs.values()]
    out["jobs_mirrored"] = len(jobs)
    out["jobs_started"] = sum(1 for job in jobs if not job.is_suspended())
    out["engines"] = [engines[n] for n in ENGINES]
    out["controllers"] = (main, incr)
    return out


def _outage(config, w, out) -> None:
    """``worker3``'s connection lost, copies finished during the outage,
    reconnects failing under the backoff, then the kubeconfig rewritten
    and the cluster reconnected."""
    main, manager = w.main, w.engines["manager"]
    remote = w.engines[REMOTE]
    w.fabric.down.add(REMOTE)
    main.cluster_connection_lost(REMOTE, "watch closed")
    admitted = [key for key, wl in remote.workloads.items()
                if wl.labels.get(ORIGIN_LABEL)
                == main.origin and wl.is_admitted]
    w.left = {key: remote.workloads[key] for key in admitted}
    w.finished_in_outage = admitted[::2]
    for key in w.finished_in_outage:
        remote.finish(key)
    out["outage_finishes"] = len(w.finished_in_outage)
    for _ in range(config["outage_reconciles"]):
        manager.clock += config["outage_step"]
        main.reconcile()
    w.fabric.down.discard(REMOTE)
    write_kubeconfig(w.kubeconfig, REMOTE, MTIMES_NS[1])
    main.reconcile()


def _adopted(w, out) -> None:
    """After the cycle that follows the reconnect: the copies left on
    ``worker3`` that a manager workload took back (adopted, not created
    anew), and the finished ones whose result the manager took."""
    main, manager = w.main, w.engines["manager"]
    remote = w.engines[REMOTE]
    out["adopted"] = sum(
        1 for key, st in main.states.items()
        if st.created.get(REMOTE) == key and key in w.left
        and remote.workloads.get(key) is w.left[key])
    out["outage_propagated"] = sum(
        1 for key in w.finished_in_outage
        if key in manager.workloads and manager.workloads[key].is_finished)


def _delete_waiting(config, w, out) -> None:
    """Every ``delete_every``-th manager workload ``incr`` dispatched
    and has not placed, deleted from the manager as a user deletes it:
    its remote copies are left to the orphan GC."""
    manager = w.engines["manager"]
    waiting = [key for key, st in w.incr.states.items()
               if st.cluster_name is None and st.created
               and key in manager.workloads]
    for key in waiting[::config["delete_every"]]:
        wl = manager.workloads.pop(key)
        manager.cache.delete_workload(key)
        manager.queues.delete_workload(wl)
        out["deleted"] += 1


def pinned(r: dict) -> dict:
    """What a run must reproduce against the JAX engines': per engine
    its PINNED numbers, evictions by reason and pipeline_stats; the
    dispatches by (mode, cluster) and the COUNTS."""
    got = {name: dict({k: r[name][k] for k in ew.PINNED},
                      evicted=r[name]["evicted"],
                      pipeline_stats=r[name]["pipeline_stats"])
           for name in ENGINES}
    got["dispatched_by"] = r["dispatched_by"]
    got.update({k: r[k] for k in COUNTS})
    return got
