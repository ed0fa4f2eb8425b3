"""Two serving worlds that mix what the other worlds keep apart, driven
through the port's ``Engine``, and the runs ``chip_smoke.py`` phases 17
and 18 and ``profile_drain.py`` make of them.

``mixed_world`` is a copy of ``bench.py``'s ``bench_mixed`` (the
reference bench's "realistic world"): 30 cohort roots of 4
ClusterQueues, every fourth root multi-flavor (on-demand and spot), every
fourth topology-aware (an 8 x 8 rack/host forest) and the rest plain;
within-ClusterQueue preemption on every other queue; 10,000 workloads
(``random.Random(23)``) of priorities 0, 0, 1 and 5, with gangs of 2 or
4 pods on the TAS roots, and two-pod-set and node-selector workloads
sprinkled over the others; drained with ``bench.py``'s ``_drain_engine``
in one pass (the port compiles nothing, so it needs no warm-up drain).
Its TAS placements are pinned to the host descent.

``afs_serving`` is the ``cycle_latency`` world made multi-tenant:
``baseline_like()`` at its defaults (200 cohorts x 5 ClusterQueues,
50,000 workloads, seed 0), with
  * every ClusterQueue under admission fair sharing
    (``admission_scope="UsageBasedAdmissionFairSharing"``) and 4 tenant
    LocalQueues (``lq-<i>-t<k>``), tenant k of every queue starting at a
    decayed usage of ``k * 10000.0`` under the default
    ``AdmissionFairSharingConfig`` (half-life 600 s);
  * three WorkloadPriorityClasses, ``low`` 0, ``mid`` 100, ``high`` 1000;
  * the ClusterQueues of odd-numbered cohorts carrying
    ``AdmissionCheck("prov")``, served by a ``ProvisioningController``;
  * each initial workload moved to tenant ``random.Random(29).randrange(4)``
    and given the class ``choice(("low", "mid", "high", None))`` of the
    same generator (None keeps the baseline priority).
It runs 1 + 8 timed ``schedule_once`` cycles. After each cycle but the
last, in decision-stream order: the provisioning outcomes of the quota
reservations on ``prov`` queues (every tenth fails, which the controller
turns into a Retry eviction with its 60 s backoff, or after three
attempts a rejection; the rest are provisioned), recorded on the
controller's requests and applied by one controller pass (one pass per
outcome would rescan every workload each time); then ``tick(60.0)``;
then ``finish`` of every entry of the cycle that is now Admitted; then
as many new workloads, ``random.Random(31)`` choosing the size class
(``baseline_like``'s 70/20/10 mix of 1, 5 and 20 cpu), the
ClusterQueue, the tenant and the class. Each cycle so runs the AFS keys
frozen at push, the admission penalties, the decay across cycles, the
priority-class ranks, the per-entry checked admit and the Retry
evictions with backoff, at the width of ``cycle_latency``.

Each builder takes a ``Kit`` (``engine_worlds.port_kit`` by default; the
parity tests pass the JAX package's). ``run`` returns the PINNED numbers
(cycles that decided something, quota reservations, preempting entries,
evictions, finishes, the crc32 of the decision streams and of the TAS
placements, the bridge's device / hybrid / fallback cycles, the cycles
whose device call carried the sim nomination's slot overrides, the
bridge's reasons, and the crc32 of the final LocalQueue usage), each timed cycle's wall
seconds and ``last_cycle_phases``, and the engine.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import zlib

from kueue_tpu_torch.bench.engine_worlds import (
    _drain_engine,
    _instrument,
    decision_stream,
    loop_arm,
    port_kit,
)
from kueue_tpu_torch.bench.tas_engine_worlds import placement_stream
from kueue_tpu_torch.bench.tas_world import pinned

AFS_SCOPE = "UsageBasedAdmissionFairSharing"
TENANTS = 4
PRIORITY_CLASSES = (("low", 0), ("mid", 100), ("high", 1000))
SIZE_CLASSES = ((1000, 0.70), (5000, 0.20), (20000, 0.10))

FULL = {
    "mixed_world": dict(kind="mixed", n_workloads=10_000, n_roots=30,
                        cqs_per_root=4, arm="columnar"),
    "afs_serving": dict(kind="afs", kw=dict(n_cohorts=200, cqs_per_cohort=5,
                                            n_workloads=50_000), cycles=8,
                        arm="columnar"),
}
# The smaller twins the CPU tests run against the JAX engine.
QUARTER = {
    "mixed_world": dict(FULL["mixed_world"], n_workloads=2_500),
    "afs_serving": dict(FULL["afs_serving"],
                        kw=dict(n_cohorts=50, cqs_per_cohort=5,
                                n_workloads=12_500), cycles=4),
}
# The numbers a run must reproduce (against the JAX engine's).
PINNED = ("cycles", "admitted", "preempting", "evicted", "finished",
          "checksum", "placements", "on_device", "hybrid", "fallback",
          "overridden", "host_root_reasons", "fallback_reasons",
          "afs_usage")


def build_mixed(config: dict, kit=None):
    """``bench_mixed``'s world, in its order of calls and draws, oracle
    attached."""
    kit = kit or port_kit()
    t = kit.types
    n_workloads = config["n_workloads"]
    n_roots = config["n_roots"]
    cqs_per_root = config["cqs_per_root"]
    n_cqs = n_roots * cqs_per_root
    rng = random.Random(23)
    eng = kit.engine()
    eng.create_resource_flavor(t.ResourceFlavor("on-demand"))
    eng.create_resource_flavor(t.ResourceFlavor("spot"))
    eng.create_topology(t.Topology("dc", (
        t.TopologyLevel("rack"), t.TopologyLevel(kit.tas.HOSTNAME_LABEL))))
    eng.create_resource_flavor(t.ResourceFlavor(name="tas",
                                                topology_name="dc"))
    for r in range(8):
        for h in range(8):
            name = f"r{r}-h{h}"
            eng.create_node(kit.tas.Node(
                name=name,
                labels={"rack": f"r{r}", kit.tas.HOSTNAME_LABEL: name},
                capacity={"cpu": 16000, "pods": 64}))
    kinds = []
    ci = 0
    per_cq = max(1, n_workloads // n_cqs)
    nominal = per_cq * 700  # ~70% of demand fits
    for root in range(n_roots):
        eng.create_cohort(t.Cohort(f"root{root}"))
        kind = ("plain", "plain", "multiflavor", "tas")[root % 4]
        for _ in range(cqs_per_root):
            name = f"cq{ci}"
            if kind == "tas":
                rgs = (t.ResourceGroup(("cpu",), (t.FlavorQuotas(
                    "tas", {"cpu": t.ResourceQuota(nominal)}),)),)
            elif kind == "multiflavor":
                rgs = (t.ResourceGroup(("cpu",), (
                    t.FlavorQuotas("on-demand",
                                   {"cpu": t.ResourceQuota(nominal)}),
                    t.FlavorQuotas("spot",
                                   {"cpu": t.ResourceQuota(nominal)}),)),)
            else:
                rgs = (t.ResourceGroup(("cpu",), (t.FlavorQuotas(
                    "on-demand", {"cpu": t.ResourceQuota(nominal)}),)),)
            eng.create_cluster_queue(t.ClusterQueue(
                name=name, cohort=f"root{root}",
                preemption=t.ClusterQueuePreemption(
                    within_cluster_queue=(
                        t.PreemptionPolicy.LOWER_PRIORITY if ci % 2
                        else t.PreemptionPolicy.NEVER)),
                resource_groups=rgs))
            eng.create_local_queue(t.LocalQueue(f"lq{ci}", "default", name))
            kinds.append(kind)
            ci += 1
    for k in range(n_workloads):
        eng.clock += 0.0001
        qi = rng.randrange(n_cqs)
        kind = kinds[qi]
        pri = rng.choice([0, 0, 1, 5])
        if kind == "tas":
            ps = (t.PodSet("main", rng.choice([2, 4]), {"cpu": 500},
                           topology_request=t.PodSetTopologyRequest(
                               mode=rng.choice([t.TopologyMode.REQUIRED,
                                                t.TopologyMode.PREFERRED]),
                               level="rack")),)
        elif rng.random() < 0.05:
            ps = (t.PodSet("driver", 1, {"cpu": 200}),
                  t.PodSet("exec", 2, {"cpu": 400}))
        elif rng.random() < 0.05:
            ps = (t.PodSet("main", 1, {"cpu": rng.choice([400, 800])},
                           node_selector={"disk": "ssd"}),)
        else:
            ps = (t.PodSet("main", 1,
                           {"cpu": rng.choice([400, 800, 1600])}),)
        eng.submit(t.Workload(name=f"w{k}", queue_name=f"lq{qi}",
                              priority=pri, pod_sets=ps))
    kit.attach(eng)
    return eng


def build_afs(config: dict, kit=None):
    """The ``afs_serving`` world, every workload submitted, oracle
    attached. Returns the engine and its provisioning controller."""
    kit = kit or port_kit()
    checks = kit.admissionchecks
    scen = kit.scenario.baseline_like(**config["kw"])
    eng = kit.engine()
    acm = checks.AdmissionCheckManager(eng)
    acm.create_admission_check(checks.AdmissionCheck("prov"))
    prov = checks.ProvisioningController(eng, "prov")
    for name, value in PRIORITY_CLASSES:
        eng.create_workload_priority_class(name, value)
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts:
        eng.create_cohort(co)
    for cq in scen.cluster_queues:
        odd = int(cq.cohort.rsplit("-", 1)[1]) % 2 == 1
        eng.create_cluster_queue(dataclasses.replace(
            cq, admission_scope=AFS_SCOPE,
            admission_checks=("prov",) if odd else ()))
    for lq in scen.local_queues:
        for k in range(TENANTS):
            eng.create_local_queue(dataclasses.replace(
                lq, name=f"{lq.name}-t{k}"))
    afs = kit.afs.AfsManager(eng)
    for lq in scen.local_queues:
        for k in range(TENANTS):
            afs.usage[f"{lq.namespace}/{lq.name}-t{k}"] = kit.afs._LqUsage(
                value=k * 10000.0, last_update=eng.clock)
    rng = random.Random(29)
    for wl in scen.workloads:
        eng.clock += 0.0001
        k = rng.randrange(TENANTS)
        pclass = rng.choice(("low", "mid", "high", None))
        eng.submit(dataclasses.replace(
            wl, queue_name=f"{wl.queue_name}-t{k}",
            priority_class_name=pclass))
    kit.attach(eng)
    return eng, prov


def afs_step(eng, prov, result, rng: random.Random, n_cqs: int, kit,
             serial: list) -> tuple[int, int]:
    """The work between two ``afs_serving`` cycles (see the module
    docstring). ``serial`` holds the next new workload's number. Returns
    the provisioning outcomes applied and the workloads finished (and
    replaced)."""
    t = kit.types
    entries = [] if result is None else [
        e for e in result.entries if e.status.value == "assumed"]
    prov.reconcile()  # a request for every new reservation
    reserved = [e.obj.key for e in entries
                if e.obj.has_quota_reservation and not e.obj.is_admitted]
    for j, key in enumerate(reserved):
        req = prov.requests[key]
        if j % 10 == 9:
            req.failed = True
        else:
            req.provisioned = True
    if reserved:
        prov.reconcile()
    eng.tick(60.0)
    done = [e.obj.key for e in entries if e.obj.is_admitted]
    for key in done:
        eng.finish(key)
    for _ in done:
        r = rng.random()
        acc = 0.0
        size = SIZE_CLASSES[-1][0]
        for sz, frac in SIZE_CLASSES:
            acc += frac
            if r < acc:
                size = sz
                break
        qi = rng.randrange(n_cqs)
        k = rng.randrange(TENANTS)
        pclass = rng.choice(("low", "mid", "high"))
        eng.clock += 0.0001
        eng.submit(t.Workload(
            name=f"new-{serial[0]}", queue_name=f"lq-{qi}-t{k}",
            priority_class_name=pclass,
            pod_sets=(t.PodSet("main", 1, {"cpu": size}),)))
        serial[0] += 1
    return len(reserved), len(done)


def afs_usage_crc(eng) -> int:
    """crc32 of every LocalQueue's usage and last update, exact."""
    if eng.afs is None:
        return 0
    return zlib.crc32(repr(sorted(
        (k, u.value.hex(), u.last_update.hex())
        for k, u in eng.afs.usage.items())).encode())


def run(config: dict, kit=None) -> dict:
    """Drive one world of ``config`` (an entry of FULL or QUARTER; a
    mixed drain stops after ``config["max_cycles"]`` calls when that is
    set, for profiling windows).
    Returns the PINNED numbers, ``cycle_seconds`` and ``phases`` (wall
    seconds and ``last_cycle_phases`` of each timed cycle: every cycle of
    the mixed drain, all but the first of afs_serving), ``calls`` and
    ``engine_s`` (every schedule_once and their wall seconds),
    ``outcomes`` (provisioning outcomes applied), ``pipeline_stats`` and
    ``pipeline`` (the bridge's, at the end and after each schedule_once)
    and ``engine``. Runs on the loop arm ``config["arm"]``
    (engine_worlds.loop_arm)."""
    with loop_arm(config.get("arm")):
        return _run(config, kit or port_kit())


def _run(config: dict, kit) -> dict:
    out = dict.fromkeys(PINNED, 0)
    out.update(cycle_seconds=[], phases=[], timing=False, calls=0,
               engine_s=0.0, outcomes=0, pipeline=[])

    def on_cycle(r):
        out["checksum"] = zlib.crc32(decision_stream(r), out["checksum"])
        out["placements"] = zlib.crc32(placement_stream(r),
                                       out["placements"])
        if r is not None:
            out["cycles"] += 1
            out["admitted"] += r.stats.admitted
            out["preempting"] += r.stats.preempting

    if config["kind"] == "mixed":
        with pinned("host"):
            eng = build_mixed(config, kit)
            _instrument(eng, out)
            out["timing"] = True
            _drain_engine(eng, max_cycles=config.get("max_cycles", 5_000),
                          on_cycle=on_cycle)
    else:
        eng, prov = build_afs(config, kit)
        _instrument(eng, out)
        n_cqs = len(eng.cache.cluster_queues)
        rng = random.Random(31)
        serial = [0]
        eng.apply_serving_gc_posture()
        try:
            for k in range(config["cycles"] + 1):
                out["timing"] = k > 0  # the first cycle encodes every row
                r = eng.schedule_once()
                out["timing"] = False
                on_cycle(r)
                if k < config["cycles"]:
                    n_out, n_done = afs_step(eng, prov, r, rng, n_cqs,
                                             kit, serial)
                    out["outcomes"] += n_out
                    out["finished"] += n_done
        finally:
            gc.enable()
            gc.unfreeze()
    out["timing"] = False
    b = eng.oracle
    out["on_device"] = b.cycles_on_device
    out["hybrid"] = b.cycles_hybrid
    out["fallback"] = b.cycles_fallback
    out["pipeline_stats"] = dict(b.pipeline_stats)
    out["host_root_reasons"] = dict(sorted(b.host_root_reasons.items()))
    out["fallback_reasons"] = dict(sorted(b.fallback_reasons.items()))
    out["evicted"] = sum(1 for e in eng.events if e.kind == "Evicted")
    out["afs_usage"] = afs_usage_crc(eng)
    out["engine"] = eng
    return out
