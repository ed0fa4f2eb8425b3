"""The controllers world of ``chip_smoke.py`` phase 32: WaitForPodsReady,
the CQ/LQ status controller with retention, the priority booster,
concurrent admission, the importer and the populator at full width
through the serving engine.

It starts from ``cycle_latency``'s world (``engine_worlds.FULL``,
``bench.py``'s ``baseline_like``: 200 cohorts x 5 = 1,000 ClusterQueues,
one ``default`` namespace, the ``cpu`` resource), whose 50,000 workloads
give each entry its LocalQueue, priority and size. The ClusterQueues of
index ``% 5 == 0`` (200) list a second flavor, ``spot``, after
``default``, with a quarter of its cpu nominal. With 200 cohorts, a
cohort holds five such ClusterQueues or none; ``cohort-0`` is one.

The engine is built from a config mapping through ``config.api.
from_dict`` (``ENGINE_CONFIG``): waitForPodsReady on (timeout 150 s, no
blockAdmission, backoff base 60 s, a backoff limit of one requeue) and
objectRetentionPolicies deleting finished workloads 60 s after they
finish and kueue-deactivated ones at once.

Before the entries: the namespace ``imported`` (label ``team=imported``),
where the populator (``AsClusterQueue`` mode, selector
``team=imported``) creates one LocalQueue per ClusterQueue; then the
importer maps running pods to those LocalQueues through
``MappingRules.for_label(QUEUE_LABEL)`` and admits them in place: five
pods of the smallest size class (1,000) on each ClusterQueue, except the
five of ``cohort-0``, which get pods that fill their ``default`` nominal
exactly, plus ``unlabelled`` pods without the label, which are skipped.
The pods run at priority ``IMPORTED_PRIORITY``, above every entry's;
every tenth imported workload never becomes ready.

The entries: counting the entries whose ClusterQueue lists ``spot``,
every 25th goes through ``submit_concurrent`` as a parent, alternately
with TryPreferredFlavors and RetainFirstAdmission, and so does the first
entry in queue order of each ClusterQueue of ``cohort-0`` (with
TryPreferredFlavors). The rest are submitted plain.

The run: ``cycles`` cycles on the default loop (``arm="full"``), the
first untimed. After each cycle, in this order: ``tick(60)`` (the
retention sweep); ``mark_pods_ready`` for every workload the cycle
admitted but every 7th in the cycle's entry order and the imported ones
that never become ready; the pods-ready reconcile; every fifth plain
entry the cycle admitted finishes; the booster (pending-age boost after
180 s, one a 60 s interval, at most 3; time sharing after 240 s
admitted, a boost of -1); the concurrent-admission reconcile; and the
status of ``POLLED`` ClusterQueues and LocalQueues, as a dashboard polls
them. After the last cycle, one ``reconcile_all``.

What that drives: in ``cohort-0`` every entry finds ``default`` full
and takes ``spot``, a TryPreferredFlavors parent's ``spot`` variant is
admitted there first, and once the never-ready imported workloads are
evicted (PodsReadyTimeout) the ``default`` variant is admitted and the
``spot`` one evicted and deactivated (the migration,
ConcurrentAdmissionLost). The evicted imported workloads come back
first in their queues, time out again and are deactivated
(RequeuingLimitExceeded), and retention deletes them a tick later, as it
deletes the finished entries.

Uids come from a process-wide counter in both packages: ``run`` starts
it at a fixed value and restores it after. Each function takes a
``Kit`` (``engine_worlds.Kit``); the port's is the default, and the tests
pass the JAX package's to compute the same run there.
"""

from __future__ import annotations

import gc
import itertools
import json
import time
import types
import zlib
from contextlib import contextmanager

from kueue_tpu_torch.bench import engine_worlds as ew

FULL = {"controllers_world": dict(n_cohorts=200, cqs_per_cohort=5,
                                  n_entries=50_000, imported_per_cq=5,
                                  unlabelled=100, cycles=9, arm="full")}
# The small twin the CPU tests run against the JAX engine.
SMALL = {"controllers_world": dict(n_cohorts=10, cqs_per_cohort=5,
                                   n_entries=2_500, imported_per_cq=5,
                                   unlabelled=10, cycles=9, arm="full")}

ENGINE_CONFIG = {
    "waitForPodsReady": {"enable": True, "timeout": 150,
                         "blockAdmission": False,
                         "requeuingStrategy": {"backoffBaseSeconds": 60,
                                               "backoffLimitCount": 1}},
    "objectRetentionPolicies": {"workloads": {
        "afterFinished": "60s", "afterDeactivatedByKueue": "0s"}},
}
UID_START = 90_000_001
CPU = "cpu"
SPOT = "spot"
SMALLEST = 1000
IMPORTED_NS = "imported"
IMPORTED_LABELS = {"team": "imported"}
QUEUE_LABEL = "kueue.x-k8s.io/queue-name"
IMPORTED_PRIORITY = 1000
TICK_S = 60.0
BOOST = dict(after_seconds=180.0, boost_per_interval=1,
             interval_seconds=60.0, max_boost=3)
TIME_SHARING = dict(time_sharing_interval_seconds=240.0,
                    negative_boost_value=-1)
POLLED = 10

# What a run must reproduce against the JAX engine: engine_worlds'
# PINNED numbers, the evictions by reason and pipeline_stats, the
# controllers' counts and the status checksums.
COUNTS = ("pods_ready_timeout", "requeuing_limit", "deleted",
          "boost_set", "boosted", "created_variant", "deactivated_variant",
          "migrations", "imported", "skipped", "populated", "status_crc",
          "reconcile_crc")


@contextmanager
def pinned_uids(kit):
    t = kit.types
    old = t._uid_counter
    t._uid_counter = itertools.count(UID_START)
    try:
        yield
    finally:
        t._uid_counter = old


def _cluster_queues(kit, scen):
    """The scenario's ClusterQueues, those of index % 5 == 0 with the
    spot flavor listed after default."""
    t = kit.types
    out = []
    for i, cq in enumerate(scen.cluster_queues):
        if i % 5 == 0:
            rg = cq.resource_groups[0]
            nominal = rg.flavors[0].resources[CPU].nominal
            cq = t.ClusterQueue(
                name=cq.name, cohort=cq.cohort,
                resource_groups=(t.ResourceGroup(rg.covered_resources, (
                    rg.flavors[0],
                    t.FlavorQuotas(SPOT, {CPU: t.ResourceQuota(
                        nominal // 4)}))),))
        out.append(cq)
    return out


def _pods(kit, config, cqs):
    """The running pods the importer adopts (module docstring)."""
    imp = kit.importer
    n_cohorts = config["n_cohorts"]
    pods = []
    for i, cq in enumerate(cqs):
        sizes = [SMALLEST] * config["imported_per_cq"]
        if i % n_cohorts == 0:  # cohort-0: fill default's nominal
            nominal = cq.resource_groups[0].flavors[0].resources[CPU].nominal
            sizes = [SMALLEST] * (nominal // SMALLEST)
            if nominal % SMALLEST:
                sizes.append(nominal % SMALLEST)
        for k, size in enumerate(sizes):
            pods.append(imp.PodToImport(
                f"pod-{i}-{k}", namespace=IMPORTED_NS,
                labels={QUEUE_LABEL: cq.name}, priority=IMPORTED_PRIORITY,
                requests={CPU: size}))
    for k in range(config["unlabelled"]):
        pods.append(imp.PodToImport(f"stray-{k}", namespace=IMPORTED_NS,
                                    labels={"app": "stray"},
                                    requests={CPU: SMALLEST}))
    return pods


def _first_in_queue(scen, n_cohorts: int) -> set:
    """The index of the first entry in queue order (priority, then
    creation) of each ClusterQueue of cohort-0."""
    best: dict = {}
    for i, w in enumerate(scen.workloads):
        cq = int(w.queue_name.rsplit("-", 1)[1])
        if cq % n_cohorts:
            continue
        rank = (-w.priority, i)
        if cq not in best or rank < best[cq]:
            best[cq] = rank
    return {i for _p, i in best.values()}


def build(config: dict, kit=None):
    """The world of ``config`` (an entry of FULL or SMALL), oracle
    attached. Returns ``(engine, ctl, build_s)``: ``ctl`` a namespace of
    the controllers (``pods_ready``, ``booster``, ``concurrent``,
    ``populated``, ``imported``, ``skipped``, ``never_ready``,
    ``plain``), ``build_s`` the seconds spent creating the entries."""
    kit = kit or ew.port_kit()
    t = kit.types
    scen = kit.scenario.baseline_like(
        n_cohorts=config["n_cohorts"],
        cqs_per_cohort=config["cqs_per_cohort"],
        n_workloads=config["n_entries"])
    cfg = kit.config_api.from_dict(ENGINE_CONFIG)
    eng = kit.engine(False, config=cfg)
    eng.set_namespace_labels(IMPORTED_NS, IMPORTED_LABELS)
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    eng.create_resource_flavor(t.ResourceFlavor(SPOT))
    for co in scen.cohorts:
        eng.create_cohort(co)
    cqs = _cluster_queues(kit, scen)
    for cq in cqs:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues:
        eng.create_local_queue(lq)
    ctl = types.SimpleNamespace()
    pop = kit.populator.PopulatorController(
        eng, name_mode=kit.populator.NAME_MODE_AS_CLUSTER_QUEUE,
        namespace_selector=dict(IMPORTED_LABELS))
    ctl.populated = len(pop.reconcile())
    wls, skipped = kit.importer.pods_to_workloads(
        _pods(kit, config, cqs), kit.importer.MappingRules.for_label(
            QUEUE_LABEL))
    mapping = {CPU: "default"}
    checked = kit.importer.check(eng, wls, mapping)
    if not checked.ok:
        raise AssertionError(f"importer check: {checked.errors}")
    imported = kit.importer.import_workloads(eng, wls, mapping).imported
    ctl.imported, ctl.skipped = len(imported), len(skipped)
    ctl.pods_ready = kit.podsready.PodsReadyManager(
        eng, cfg.wait_for_pods_ready)
    ctl.never_ready = set(imported[9::10])
    for key in imported:
        if key not in ctl.never_ready:
            ctl.pods_ready.mark_pods_ready(key)
    ctl.booster = kit.booster.PriorityBooster(
        eng, kit.booster.BoostPolicy(**BOOST),
        kit.booster.TimeSharingPolicy(**TIME_SHARING))
    cam = kit.concurrentadmission
    ca = ctl.concurrent = cam.ConcurrentAdmissionController(eng)
    modes = (cam.TRY_PREFERRED_FLAVORS, cam.RETAIN_FIRST_ADMISSION)
    first = _first_in_queue(scen, config["n_cohorts"])
    ctl.plain = set()
    n_spot = n_parents = 0
    t0 = time.perf_counter()
    for i, w in enumerate(scen.workloads):
        eng.clock += 0.0001
        wl = t.Workload(name=f"wl-{i}", queue_name=w.queue_name,
                        priority=w.priority, pod_sets=(t.PodSet(
                            "main", 1, dict(w.pod_sets[0].requests)),))
        mode = None
        if int(w.queue_name.rsplit("-", 1)[1]) % 5 == 0:
            if i in first:
                mode = cam.TRY_PREFERRED_FLAVORS
            elif n_spot % 25 == 0:
                mode = modes[n_parents % 2]
            n_spot += 1
        if mode is None:
            eng.submit(wl)
            ctl.plain.add(wl.key)
            continue
        wl.queue_name = ""
        ca.submit_concurrent(wl, w.queue_name,
                             cam.ConcurrentAdmissionPolicy(mode=mode))
        n_parents += 1
    build_s = time.perf_counter() - t0
    kit.attach(eng)
    return eng, ctl, build_s


def polled(eng, config) -> tuple:
    """The ClusterQueues and LocalQueues whose status each cycle reads:
    POLLED of each, spread over the world, the LocalQueues alternately
    of the ``default`` and ``imported`` namespaces."""
    n = config["n_cohorts"] * config["cqs_per_cohort"]
    idx = [j * n // POLLED for j in range(POLLED)]
    return ([f"cq-{j}" for j in idx],
            [f"default/lq-{j}" if k % 2 == 0 else f"{IMPORTED_NS}/cq-{j}"
             for k, j in enumerate(idx)])


def status_json(statuses) -> bytes:
    """A list or mapping of QueueStatus (or None) as the status routes
    dump them."""
    if isinstance(statuses, dict):
        return json.dumps({k: None if v is None else vars(v)
                           for k, v in statuses.items()}).encode()
    return json.dumps([None if v is None else vars(v)
                       for v in statuses]).encode()


def run(config: dict, kit=None, on_built=None, on_cycle=None) -> dict:
    """Build and drive the world of ``config`` on its loop arm.
    ``on_built(engine)`` runs once the world is built and its oracle
    attached (a test attaches a journal there); ``on_cycle(k, engine)``
    after cycle ``k``'s between-cycle steps. Returns engine_worlds'
    PINNED numbers, ``evicted`` (evictions by reason),
    ``pipeline_stats`` (the bridge's at the end) and ``pipeline`` (after
    each cycle), the COUNTS, ``build_s``, ``cycle_seconds`` and
    ``phases`` of every cycle but the first, ``controller_s`` (seconds
    spent in each between-cycle step, summed over the run, and in the
    final ``reconcile_all``), ``calls``, ``engine_s`` and ``engines``."""
    kit = kit or ew.port_kit()
    with ew.loop_arm(config.get("arm")), pinned_uids(kit):
        return _run(config, kit, on_built, on_cycle)


def _timed(out, name, fn, *args):
    t0 = time.perf_counter()
    got = fn(*args)
    out["controller_s"][name] = out["controller_s"].get(name, 0.0) + \
        time.perf_counter() - t0
    return got


def _run(config, kit, on_built, on_cycle) -> dict:
    out = dict.fromkeys(ew.PINNED, 0)
    out.update(cycle_seconds=[], phases=[], timing=False, calls=0,
               engine_s=0.0, pipeline=[], controller_s={}, boosted=0,
               status_crc=0)
    eng, ctl, out["build_s"] = build(config, kit)
    out.update(imported=ctl.imported, skipped=ctl.skipped,
               populated=ctl.populated)
    if on_built is not None:
        on_built(eng)
    ew._instrument(eng, out)
    sc = eng.status_controller
    sweep = sc.sweep_retention
    sc.sweep_retention = lambda: _timed(out, "retention_sweep", sweep)
    cq_poll, lq_poll = polled(eng, config)
    pr = ctl.pods_ready
    eng.apply_serving_gc_posture()
    try:
        for k in range(1, config["cycles"] + 1):
            out["timing"] = k > 1  # the first encodes every row
            r = eng.schedule_once()
            out["checksum"] = zlib.crc32(ew.decision_stream(r),
                                         out["checksum"])
            admitted = []
            if r is not None:
                out["cycles"] += 1
                out["admitted"] += r.stats.admitted
                out["preempting"] += r.stats.preempting
                admitted = [e.obj.key for e in r.entries
                            if e.status.value == "assumed"]
            eng.tick(TICK_S)
            for n, key in enumerate(admitted):
                if n % 7 != 6 and key not in ctl.never_ready:
                    pr.mark_pods_ready(key)
            _timed(out, "pods_ready", pr.reconcile)
            for key in [key for key in admitted if key in ctl.plain][::5]:
                wl = eng.workloads.get(key)
                if wl is not None and wl.is_admitted:
                    eng.finish(key)
            out["boosted"] += _timed(out, "booster", ctl.booster.reconcile)
            _timed(out, "concurrent", ctl.concurrent.reconcile)
            polls = _timed(out, "status_polls", lambda: [
                sc.cq_status(n) for n in cq_poll] + [
                sc.lq_status(q) for q in lq_poll])
            out["status_crc"] = zlib.crc32(status_json(polls),
                                           out["status_crc"])
            if on_cycle is not None:
                on_cycle(k, eng)
        _timed(out, "reconcile_all", sc.reconcile_all)
    finally:
        gc.enable()
        gc.unfreeze()
    out["timing"] = False
    out["reconcile_crc"] = zlib.crc32(status_json(sc.cq_statuses) + b"|"
                                      + status_json(sc.lq_statuses))
    b = eng.oracle
    out.update(on_device=b.cycles_on_device, hybrid=b.cycles_hybrid,
               fallback=b.cycles_fallback,
               preemptions=eng.metrics.preemptions_total,
               pipeline_stats=dict(b.pipeline_stats))
    evicted: dict = {}
    for e in eng.events:
        if e.kind == "Evicted":
            evicted[e.detail] = evicted.get(e.detail, 0) + 1
    out["evicted"] = dict(sorted(evicted.items()))
    out["pods_ready_timeout"] = evicted.get("PodsReadyTimeout", 0)
    out["requeuing_limit"] = evicted.get("RequeuingLimitExceeded", 0)
    out["migrations"] = evicted.get("ConcurrentAdmissionLost", 0)
    kinds = [e.kind for e in eng.events]
    for name, kind in (("deleted", "Deleted"),
                       ("boost_set", "PriorityBoostSet"),
                       ("created_variant", "CreatedVariant"),
                       ("deactivated_variant", "DeactivatedVariant")):
        out[name] = kinds.count(kind)
    out["engines"] = [eng]
    return out


def pinned(r: dict) -> dict:
    """What a run must reproduce against the JAX engine's: its PINNED
    numbers, evictions by reason, pipeline_stats and COUNTS."""
    got = {k: r[k] for k in ew.PINNED}
    got.update(evicted=r["evicted"], pipeline_stats=r["pipeline_stats"])
    got.update({k: r[k] for k in COUNTS})
    return got
