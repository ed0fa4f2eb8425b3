"""The TAS worlds of the JAX package's bench, driven through the port's
serving engine, and the runs ``chip_smoke.py`` phases 14-16 make of them.

Copies of ``bench.py``'s ``bench_tas`` (640 nodes: 8 blocks x 8 racks x
10 hosts, cpu 8000 and pods 32 each; 8 ClusterQueues; 800 gang workloads
of 2, 4 or 8 pods at 1 cpu, REQUIRED, PREFERRED or UNCONSTRAINED at
block or rack; seed 11), ``bench_tas_large`` (5,120 nodes: 8 x 16 x 40,
pods 32; 8 ClusterQueues; 120 workloads of 4, 8 or 16 pods; seed 13) and
``bench_tas_churn`` (5,120 nodes with pods 8; 32 ClusterQueues in one
cohort; 320 REQUIRED rack or block workloads of one rack of pods less
64, one rack, or one rack plus 192, at 0.1 cpu; seed 11; 80 fill cycles,
then 20 churn cycles that each finish the first two admitted workloads
and schedule once), built with the same seeds and calls, and of
``bench._tas_crossover_measure`` (one host descent against one device
placement on the world's forest). Each builder takes a ``Kit``
(``engine_worlds.port_kit`` by default; the parity tests pass the JAX
package's).

``tas_lifecycle`` is the churn world through node failures and foreign
pods, on the default serving loop: before the first cycle one running
DaemonSet pod ``kube-system/ds-<node>`` of 0.5 cpu on every host of
blocks b0 and b1 whose index is a multiple of 8 (160 pods, each taking
one of its node's 8 pod slots); each churn cycle moves the clock by one
second, finishes the first two admitted workloads that wait on no node
replacement, deletes the c-th DaemonSet pod (name order) and, at the
cycles of ``failures``, fails one node (``mark_node_unhealthy``, reason
NodeDeleted): the first hostname, in name order, of the admitted
workload with the smallest key and no unhealthy node yet. The second
pass at the top of each cycle re-places the lost pods, retrying with its
backoff while the required domain is full.

A run pins the TAS path with ``KUEUE_TPU_DEVICE_TAS_MIN`` ("host":
1,000,000, "device": 0) and, for the churn, the feasibility batch with
``KUEUE_TPU_TAS_FEAS``, on both packages alike; ``run`` returns the
PINNED numbers (cycles that decided something, admitted entries, the
crc32 of the decision streams and of the placements, the bridge's device
/ hybrid / fallback cycles, its host-root reasons and TAS stats), the
tas_place_batch calls and heads, and each timed cycle's wall seconds.
"""

from __future__ import annotations

import random
import time
import zlib

from kueue_tpu_torch.bench.engine_worlds import (
    SPAN,
    _drain_engine,
    decision_stream,
    loop_arm,
    port_kit,
)
from kueue_tpu_torch.bench.tas_world import pinned

FULL = {
    "tas": dict(kind="drain", seed=11, dims=(8, 8, 10), pods=32, n_cqs=8,
                n_wl=800, counts=(2, 4, 8), arm="columnar"),
    "tas_large": dict(kind="drain", seed=13, dims=(8, 16, 40), pods=32,
                      n_cqs=8, n_wl=120, counts=(4, 8, 16), arm="columnar"),
    "tas_churn": dict(kind="churn", seed=11, dims=(8, 16, 40), n_cqs=32,
                      n_wl=320, fill_cycles=80, churn_cycles=20,
                      arm="columnar"),
    "tas_lifecycle": dict(kind="lifecycle", seed=11, dims=(8, 16, 40),
                          n_cqs=32, n_wl=320, fill_cycles=80,
                          churn_cycles=20, failures=(0, 4, 8, 12, 16),
                          ds_blocks=2, ds_every=8, ds_cpu=500, arm="full"),
}
# The smaller twins the CPU tests run against the JAX engine: a quarter
# of the workloads (and of the churn's cycles) on the same forests, so
# the churn's forest still clears the feasibility batch's 2,048 leaves.
QUARTER = {
    "tas": dict(FULL["tas"], n_wl=200),
    "tas_large": dict(FULL["tas_large"], n_wl=30),
    "tas_churn": dict(FULL["tas_churn"], n_wl=80, fill_cycles=20,
                      churn_cycles=5),
    "tas_lifecycle": dict(FULL["tas_lifecycle"], n_wl=80, fill_cycles=20,
                          churn_cycles=5, failures=(0, 4)),
}
# The numbers a run must reproduce (against the JAX engine's).
PINNED = ("cycles", "admitted", "checksum", "placements", "on_device",
          "hybrid", "fallback", "host_root_reasons", "placed_device",
          "placed_host", "memo_hits", "commit_drops")
# What a tas_lifecycle run pins besides: the NodeUnhealthy and
# NodeReplaced events, the second pass's retries, its replacement
# placements (``find_topology_assignments`` calls) and those that reached
# the device program, and the crc32 of the two events (in order, with
# their details) and of every admitted workload's final topology
# assignment (in key order).
LIFECYCLE_PINNED = ("node_unhealthy", "node_replaced", "retries",
                    "replace_calls", "replace_device", "events_crc",
                    "final_crc")
# The arms of a world: (TAS path, KUEUE_TPU_TAS_FEAS).
ARMS = {"tas": (("host", "1"), ("device", "1")),
        "tas_large": (("host", "1"), ("device", "1")),
        "tas_churn": (("host", "1"), ("device", "1"), ("host", "0"),
                      ("device", "0")),
        "tas_lifecycle": (("host", "1"), ("device", "1"))}


def arm_expect(expect: dict, path: str) -> dict:
    """The PINNED numbers and tas_place_batch calls one arm must give,
    from a world's expectation: the arms differ only in which path
    placed (``placed`` heads) and in the batch calls (device only)."""
    out = {k: v for k, v in expect.items()
           if k not in ("placed", "batch_calls")}
    device = path == "device"
    out["placed_device"] = expect["placed"] if device else 0
    out["placed_host"] = 0 if device else expect["placed"]
    out["batch_calls"] = expect["batch_calls"] if device else 0
    if "replace_calls" in expect:
        out["replace_device"] = expect["replace_calls"] if device else 0
    return out


def pinned_numbers(r: dict) -> dict:
    """A run's PINNED numbers and its tas_place_batch calls (and, for a
    tas_lifecycle run, its LIFECYCLE_PINNED numbers)."""
    keys = PINNED + ("batch_calls",)
    if "events_crc" in r:
        keys += LIFECYCLE_PINNED
    return {k: r[k] for k in keys}


def build(config: dict, kit=None):
    """One engine over the world of ``config`` (an entry of FULL or
    QUARTER), oracle attached, every workload submitted, in bench.py's
    order of calls and draws."""
    kit = kit or port_kit()
    t = kit.types
    rng = random.Random(config["seed"])
    eng = kit.engine()
    eng.create_topology(t.Topology("dc", (
        t.TopologyLevel("block"), t.TopologyLevel("rack"),
        t.TopologyLevel(kit.tas.HOSTNAME_LABEL))))
    eng.create_resource_flavor(t.ResourceFlavor(name="tas",
                                                topology_name="dc"))
    blocks, racks, hosts = config["dims"]
    churn = config["kind"] in ("churn", "lifecycle")
    pods = 8 if churn else config["pods"]
    for b in range(blocks):
        for r in range(racks):
            for h in range(hosts):
                name = f"b{b}-r{r}-h{h}"
                eng.create_node(kit.tas.Node(
                    name=name,
                    labels={"block": f"b{b}", "rack": f"b{b}-r{r}",
                            kit.tas.HOSTNAME_LABEL: name},
                    capacity={"cpu": 8000, "pods": pods}))
    if config["kind"] == "lifecycle":
        for name in daemonset_nodes(config):
            eng.observe_pod(kit.non_tas_usage.PodUsage(
                namespace="kube-system", name=f"ds-{name}", node_name=name,
                requests={"cpu": config["ds_cpu"]}))
    total = blocks * racks * hosts * 8000
    n_cqs = config["n_cqs"]
    for i in range(n_cqs):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort="shared" if churn else None,
            resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas("tas", {"cpu": t.ResourceQuota(
                    total // n_cqs)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq-{i}", "default",
                                            f"cq-{i}"))
    kit.attach(eng)
    rack_pods = hosts * 8
    for i in range(config["n_wl"]):
        eng.clock += 0.001
        if churn:
            level = rng.choice(["rack", "block"])
            cnt = rng.choice([rack_pods - 64, rack_pods, rack_pods + 192])
            eng.submit(t.Workload(
                name=f"t-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
                pod_sets=(t.PodSet(
                    "main", cnt, {"cpu": 100},
                    topology_request=t.PodSetTopologyRequest(
                        mode=t.TopologyMode.REQUIRED, level=level)),)))
            continue
        mode = rng.choice([t.TopologyMode.REQUIRED, t.TopologyMode.PREFERRED,
                           t.TopologyMode.UNCONSTRAINED])
        level = None if mode == t.TopologyMode.UNCONSTRAINED else \
            rng.choice(["block", "rack"])
        eng.submit(t.Workload(
            name=f"tas-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            pod_sets=(t.PodSet(
                "main", rng.choice(list(config["counts"])), {"cpu": 1000},
                topology_request=t.PodSetTopologyRequest(
                    mode=mode, level=level)),)))
    return eng


def daemonset_nodes(config: dict) -> list:
    """The hosts of a tas_lifecycle world that run a DaemonSet pod, in
    name order."""
    _, racks, hosts = config["dims"]
    return sorted(f"b{b}-r{r}-h{h}" for b in range(config["ds_blocks"])
                  for r in range(racks) for h in range(hosts)
                  if h % config["ds_every"] == 0)


def _topology_rows(wl) -> tuple:
    """(pod set, ((domain values, count), ...)) of a workload's
    admission, for its pod sets with a topology assignment."""
    return tuple(
        (psa.name, tuple((tuple(d.values), d.count)
                         for d in psa.topology_assignment.domains))
        for psa in wl.status.admission.pod_set_assignments
        if psa.topology_assignment is not None)


def _lifecycle_churn_cycle(eng, config: dict, c: int, ds: list) -> None:
    """The calls of tas_lifecycle churn cycle ``c`` before its
    schedule_once: clock, finishes, the DaemonSet pod delete, the node
    failure."""
    eng.clock += 1.0
    adm = sorted(k for k, w in eng.workloads.items()
                 if w.is_admitted and not w.is_finished
                 and not w.status.unhealthy_nodes)
    for k in adm[:2]:
        eng.finish(k)
    eng.observe_pod_deleted("kube-system", f"ds-{ds[c]}")
    if c in config["failures"] and len(adm) > 2:
        # adm[2]: the smallest key left with no unhealthy node.
        node = min(values[-1] for _, doms in _topology_rows(
            eng.workloads[adm[2]]) for values, _ in doms)
        eng.mark_node_unhealthy(node, reason="NodeDeleted")


def _watch_second_pass(eng, out: dict) -> None:
    """Count the second pass's retries, its replacement placements and
    those that reached the device program, and time it, through
    instance attributes of the engine (either package's)."""
    sp = eng.queues.second_pass
    queue = sp.queue

    def counted_queue(info, now=0.0, iteration=0):
        if iteration > 0:
            out["retries"] += 1
        return queue(info, now=now, iteration=iteration)

    sp.queue = counted_queue
    inner = eng._process_second_pass
    snapshot = eng.cache.snapshot

    def process_second_pass():
        forests = {}

        def watched_snapshot():
            snap = snapshot()
            for forest in snap.tas_flavors.values():
                if id(forest) in forests:
                    continue
                forests[id(forest)] = (
                    forest, getattr(forest, "device_placements", 0))
                find, host = (forest.find_topology_assignments,
                              forest.find_topology_assignments_host)

                def counted_find(*a, _find=find, **k):
                    out["replace_calls"] += 1
                    return _find(*a, **k)

                def counted_host(*a, _host=host, **k):
                    out["replace_host"] += 1
                    return _host(*a, **k)

                forest.find_topology_assignments = counted_find
                forest.find_topology_assignments_host = counted_host
            return snap

        eng.cache.snapshot = watched_snapshot
        t0 = time.perf_counter()
        try:
            inner()
        finally:
            dt = time.perf_counter() - t0
            del eng.cache.snapshot
            for forest, before in forests.values():
                del forest.find_topology_assignments
                del forest.find_topology_assignments_host
                if hasattr(forest, "device_placements"):
                    out["replace_device_placements"] += \
                        forest.device_placements - before
        out["second_pass_s"].append(dt)

    eng._process_second_pass = process_second_pass


def placement_stream(result) -> bytes:
    """The topology placements of one cycle's admitted entries, in entry
    order: workload key, pod set and (domain values, count) pairs."""
    if result is None:
        return b""
    rows = []
    for e in result.entries:
        if e.status.value != "assumed" or e.assignment is None:
            continue
        for psa in e.assignment.pod_sets:
            ta = psa.topology_assignment
            if ta is not None:
                rows.append((e.obj.key, psa.name, tuple(
                    (tuple(d.values), d.count) for d in ta.domains)))
    return repr(rows).encode()


def run(config: dict, path: str, feas: str = "1", kit=None,
        sync=None) -> dict:
    """Drive one world of ``config`` with the TAS path pinned to ``path``
    and the feasibility batch to ``feas``. Returns the PINNED numbers,
    ``batch_calls`` and ``batch_heads`` (tas_place_batch launches and
    the real heads they placed), ``tas_seconds`` (the planner's encode,
    place and decode), ``cycle_seconds`` (the wall seconds of every
    schedule_once of the drain, or of the churn cycles) and ``phases``
    (their ``last_cycle_phases``), ``calls`` and
    ``engine_s`` (every schedule_once and their wall seconds),
    ``pipeline_stats`` and ``pipeline`` (the bridge's, at the end and
    after each schedule_once), ``queues`` (each ClusterQueue's pending
    keys, active and inadmissible, at the end) and ``engine``; a
    tas_lifecycle run adds its LIFECYCLE_PINNED numbers,
    ``replace_host`` (the replacement placements the host descent made),
    ``replace_device_placements`` (the port's own count of them on the
    device program; 0 for the JAX package, which keeps none) and
    ``second_pass_s`` (the second pass's wall seconds, per churn cycle).
    Runs on the loop arm ``config["arm"]`` (engine_worlds.loop_arm).
    Each schedule_once is a profiler range named ``engine_worlds.SPAN``.
    ``sync()``, when given, runs after each cycle inside its timing
    (torch.cuda.synchronize on the card). A drain stops after ``config["max_cycles"]`` calls when
    that is set (profiling windows)."""
    from torch.profiler import record_function

    kit = kit or port_kit()
    out = dict.fromkeys(PINNED, 0)
    out.update(cycle_seconds=[], phases=[], placements=0, calls=0,
               engine_s=0.0, pipeline=[])
    lifecycle = config["kind"] == "lifecycle"
    if lifecycle:
        out.update(dict.fromkeys(LIFECYCLE_PINNED, 0), replace_host=0,
                   replace_device_placements=0, second_pass_s=[])
    with pinned(path, feas), loop_arm(config.get("arm")):
        eng = build(config, kit)
        inner = eng.schedule_once
        timing = [config["kind"] == "drain"]

        def schedule_once():
            with record_function(SPAN):
                t0 = time.perf_counter()
                r = inner()
                if sync is not None:
                    sync()
                dt = time.perf_counter() - t0
            out["calls"] += 1
            out["engine_s"] += dt
            out["pipeline"].append(dict(eng.oracle.pipeline_stats))
            if timing[0]:
                out["cycle_seconds"].append(dt)
                out["phases"].append(dict(eng.last_cycle_phases))
            out["checksum"] = zlib.crc32(decision_stream(r),
                                         out["checksum"])
            out["placements"] = zlib.crc32(placement_stream(r),
                                           out["placements"])
            if r is not None:
                out["cycles"] += 1
                out["admitted"] += r.stats.admitted
            return r

        eng.schedule_once = schedule_once
        if config["kind"] == "drain":
            _drain_engine(eng, max_cycles=config.get("max_cycles", 5_000))
        else:
            for _ in range(config["fill_cycles"]):
                if eng.schedule_once() is None:
                    break
            timing[0] = True
            if lifecycle:
                _watch_second_pass(eng, out)
                ds = daemonset_nodes(config)
            for c in range(config["churn_cycles"]):
                if lifecycle:
                    _lifecycle_churn_cycle(eng, config, c, ds)
                else:
                    adm = sorted(k for k, w in eng.workloads.items()
                                 if w.is_admitted and not w.is_finished)
                    for k in adm[:2]:
                        eng.finish(k)
                eng.schedule_once()
    if lifecycle:
        events = [(e.time, e.kind, e.workload, e.cluster_queue, e.detail)
                  for e in eng.events
                  if e.kind in ("NodeUnhealthy", "NodeReplaced")]
        out["node_unhealthy"] = sum(e[1] == "NodeUnhealthy" for e in events)
        out["node_replaced"] = sum(e[1] == "NodeReplaced" for e in events)
        out["events_crc"] = zlib.crc32(repr(events).encode())
        out["final_crc"] = zlib.crc32(repr([
            (k, _topology_rows(w)) for k, w in sorted(eng.workloads.items())
            if w.is_admitted and not w.is_finished]).encode())
        out["replace_device"] = out["replace_calls"] - out["replace_host"]
    out["queues"] = {
        name: (sorted(pcq.items), sorted(pcq.inadmissible))
        for name, pcq in sorted(eng.queues.cluster_queues.items())}
    b = eng.oracle
    out["on_device"] = b.cycles_on_device
    out["hybrid"] = b.cycles_hybrid
    out["fallback"] = b.cycles_fallback
    out["pipeline_stats"] = dict(b.pipeline_stats)
    out["host_root_reasons"] = dict(sorted(b.host_root_reasons.items()))
    for k in ("placed_device", "placed_host", "memo_hits", "commit_drops"):
        out[k] = int(b.tas_stats[k])
    out["batch_calls"] = sum(b.tas_heads_per_launch.values())
    out["batch_heads"] = sum(n * c for n, c in
                             b.tas_heads_per_launch.items())
    out["tas_seconds"] = {k: b.tas_stats[k + "_s"]
                          for k in ("encode", "place", "decode")}
    out["engine"] = eng
    return out


def crossover_measure(config: dict, kit=None, n_probe: int = 5,
                      sync=None, save: bool = False) -> dict:
    """``bench._tas_crossover_measure`` on the world of ``config``: the
    per-placement milliseconds of the host descent and of the device
    program for one REQUIRED rack request of 4 pods at 1 cpu, on a fork
    of the world's forest, the result memo cleared before each probe;
    ``sync()`` runs inside each timed placement. With ``save``, the
    measurement is written to the port's crossover record
    (tas/calibration.py), which ``worth_offloading`` then reads."""
    from kueue_tpu_torch.tas import calibration

    kit = kit or port_kit()
    t = kit.types
    eng = build(dict(config, n_wl=0), kit)
    snap = next(iter(eng.cache.tas_prototypes().values()))
    ps = t.PodSet("main", 4, {"cpu": 1000},
                  topology_request=t.PodSetTopologyRequest(
                      mode=t.TopologyMode.REQUIRED, level="rack"))
    req = kit.tas.TASPodSetRequest(pod_set=ps,
                                   single_pod_requests={"cpu": 1000},
                                   count=4)
    out = {}
    for label, path in (("host_place_ms", "host"),
                        ("device_place_ms", "device")):
        with pinned(path):
            fork = snap.fork()
            fork.find_topology_assignments(req)  # warm
            total = 0.0
            for _ in range(n_probe):
                fork._place_memo = None
                if sync is not None:
                    sync()
                t0 = time.perf_counter()
                fork.find_topology_assignments(req)
                if sync is not None:
                    sync()
                total += time.perf_counter() - t0
            out[label] = total / n_probe * 1e3
    if save:
        nl = len(snap.level_keys)
        calibration.save(snap.device.type, nl,
                         len(snap.domains_per_level[nl - 1]),
                         out["host_place_ms"], out["device_place_ms"])
        calibration.invalidate_cache()
    return out
