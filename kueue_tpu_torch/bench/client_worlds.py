"""The client world of ``chip_smoke.py`` phase 35: the typed client
layer (clientset, informers, listers, server-side apply), the remote
client's fan-out over the serving endpoint and ``kueuectl`` at full
width through the serving engine.

It is ``cycle_latency``'s world on the default loop
(``engine_worlds.DEFAULT_ARM``, ``bench.py``'s ``baseline_like``: 200
cohorts x 5 = 1,000 ClusterQueues, LocalQueues ``lq-i`` in ``default``,
50,000 entries), oracle attached, a journal attached once it is built
(``attach_new_journal``) and the SLO engine attached, driven for
``cycles`` + 1 cycles. Informer ``early`` starts before the entries are
created; informer ``late`` starts after the last cycle and replays the
engine's history. Below, index *i* is in the order of
``sorted(engine.workloads)``, ``n`` the number of ClusterQueues, and
``spread(xs, k)`` the k items ``xs[j * len(xs) // k]``.

Between the cycles, on the engine's own thread:

  * before cycle 1, through ``ApplyEngine``: manager ``tuner`` raises
    the priority of every 50th workload by ``TUNER_BOOST``; manager
    ``mover`` moves every 50th from index 25 on from ``lq-k`` to
    ``lq-((k+1) mod n)``; manager ``other`` applies ``CONFLICTS`` of
    tuner's priorities with other values, each an ``ApplyConflict``,
    then again with ``force=True``; ``ClusterQueueApply.with_cohort``
    moves 10 ClusterQueues to the next cohort; ``LocalQueueApply`` (manager
    ``ops``) sets ``Hold`` on 10 LocalQueues;
  * after cycle 1: ``kueuectl create clusterqueue`` (with
    ``--nominal-quota``) and ``create localqueue`` make ``cq-new`` and
    ``lq-new``, and ``mover`` moves ``MOVED_NEW`` pending workloads
    into ``lq-new``;
  * after cycle 2: ``kueuectl stop clusterqueue --drain`` on 5
    ClusterQueues, resumed (``kueuectl resume``) after cycle 5;
  * after cycle 3: ``ops`` sets ``HoldAndDrain`` on 5 more LocalQueues;
  * after cycle 4: ``kueuectl delete workload`` removes ``DELETED``
    pending workloads;
  * after cycle 6: ``ops`` puts all 15 LocalQueues back to ``None``,
    and the flight recorder is attached with ``bootstrap=True``;
  * after cycles 1 and the last, an in-process ``ServingEndpoint`` (port
    0, no token) is queried through ``RemoteClient`` while no cycle
    runs: ``pending_workloads_many`` over every ClusterQueue with
    ``FANOUT_WORKERS`` workers, ``list_cluster_queues``,
    ``list_workloads``, ``healthz``, ``metrics_text`` and ``debug_dump``.

The flight recorder starts after the last client write because those
writes (the apply engine's re-keys and queue moves, the stop policies,
the deletes) are not calls of the engine's recorded methods in either
package: a trace bootstrapped before them replays a world without them
and diverges at the next cycle. Bootstrapped after them, the trace holds
the world as it is and the cycles after the sixth, and replays
byte-identical.

After the run, the recorder is closed and ``kueuectl.run`` renders:
``list workloads`` and ``list localqueues``; ``describe`` of 10
workloads, 10 ClusterQueues and 10 LocalQueues;
``list pods --for`` 10 admitted workloads and ``get workloads NAME``
of each; ``explain --json`` of 20 pending workloads with the probe on;
``slo --json``; ``status --json`` (offline: the journal, no lease); and
``trace export --input`` of the recorded trace. Then
``kueuectl.main(["replay", TRACE, "--mode", "device"])`` (the port's
with ``--device``) replays it on the world's device in this process.

Uids come from a process-wide counter in both packages: ``run`` starts
it at a fixed value and restores it after. Each function takes a
``Kit`` (``engine_worlds.Kit``) whose ``client``, ``kueuectl``,
``http_server`` and ``journal`` are the package's client layer, CLI,
endpoint and journal modules; the port's kit is the default, and the
tests pass the JAX package's to compute the same run there.
"""

from __future__ import annotations

import contextlib
import gc
import io
import itertools
import json
import os
import re
import time
import zlib

from kueue_tpu_torch.bench import engine_worlds as ew

FULL = {"client_world": dict(n_cohorts=200, cqs_per_cohort=5,
                             n_workloads=50_000, cycles=8, arm="full")}
# The small twin the CPU tests run against the JAX engine.
SMALL = {"client_world": dict(n_cohorts=10, cqs_per_cohort=5,
                              n_workloads=2_500, cycles=8, arm="full")}

UID_START = 95_000_001
NS = "default"
STRIDE = 50
MOVE_OFFSET = 25
TUNER_BOOST = 1000
CONFLICTS = 10
COHORT_MOVES = 10
HOLDS = 10
DRAIN_HOLDS = 5
STOPPED = 5
MOVED_NEW = 200
NEW_NOMINAL = 100_000
DELETED = 100
DESCRIBED = 10
EXPLAINED = 20
FANOUT_WORKERS = 8
RECORD_AFTER = 6
ENDPOINT_AFTER = (1,)  # and the last cycle

# What a run must reproduce against the JAX engine: engine_worlds'
# PINNED numbers, the evictions by reason and pipeline_stats, the
# client layer's counts and the checksums of what it read.
COUNTS = ("rekeys", "moves", "conflicts", "held_events", "cohort_moves",
          "moved_new", "deleted", "cqs_fanned", "journal_records",
          "slo", "trace_events", "trace_trees", "replay")
CRCS = ("informer_crc", "fanout_crc", "remote_workloads_crc",
        "remote_cqs_crc", "list_workloads_crc", "list_localqueues_crc",
        "describe_crc", "pods_crc", "get_crc", "explain_crc",
        "status_crc")


@contextlib.contextmanager
def pinned_uids(kit):
    t = kit.types
    old = t._uid_counter
    t._uid_counter = itertools.count(UID_START)
    try:
        yield
    finally:
        t._uid_counter = old


def spread(xs: list, k: int) -> list:
    return [xs[j * len(xs) // k] for j in range(min(k, len(xs)))]


def crc(obj, prev: int = 0) -> int:
    return zlib.crc32(json.dumps(obj, sort_keys=True).encode(), prev)


def pending_keys(eng) -> list:
    """Keys of the active pending workloads, sorted."""
    return sorted(k for k, wl in eng.workloads.items()
                  if wl.active and not wl.is_finished
                  and wl.status.admission is None)


def informer_crc(inf) -> int:
    return crc([vars(r) for r in inf.store.values()])


def build(config: dict, kit, work: str):
    """The world of ``config``, journal, SLO engine and oracle attached,
    informer ``early`` started before its entries. Returns ``(engine,
    early, build_s)``."""
    scen = kit.scenario.baseline_like(
        n_cohorts=config["n_cohorts"],
        cqs_per_cohort=config["cqs_per_cohort"],
        n_workloads=config["n_workloads"])
    eng = kit.engine(False)
    client = kit.client.KueueClient(eng)
    for rf in scen.flavors:
        client.resource_flavors().create(rf)
    for co in scen.cohorts:
        client.cohorts().create(co)
    for cq in scen.cluster_queues:
        client.cluster_queues().create(cq)
    for lq in scen.local_queues:
        client.local_queues().create(lq)
    early = kit.client.Informer(eng)
    early.start()
    t0 = time.perf_counter()
    for w in scen.workloads:
        eng.clock += 0.0001
        client.workloads().create(w)
    build_s = time.perf_counter() - t0
    kit.journal.attach_new_journal(eng, os.path.join(work, "journal.jsonl"))
    eng.attach_slo()
    kit.attach(eng)
    return eng, early, build_s


def _timed(out, name, fn, *args):
    t0 = time.perf_counter()
    got = fn(*args)
    out["client_s"][name] = out["client_s"].get(name, 0.0) + \
        time.perf_counter() - t0
    return got


def _queues(n: int) -> dict:
    """The ClusterQueues and LocalQueues each step touches, spread over
    the world and disjoint."""
    def pick(k, offset):
        return [j * n // k + offset for j in range(k)]
    return dict(cohort_moves=[f"cq-{i}" for i in pick(COHORT_MOVES, 4)],
                holds=[f"{NS}/lq-{i}" for i in pick(HOLDS, 1)],
                drain_holds=[f"{NS}/lq-{i}" for i in pick(DRAIN_HOLDS, 2)],
                stopped=[f"cq-{i}" for i in pick(STOPPED, 3)])


def _before_first(eng, kit, out, q, n_cohorts, n_cqs):
    ap = kit.client.ApplyEngine(eng)
    c = kit.client
    keys = sorted(eng.workloads)
    tuned = keys[0::STRIDE]
    for key in tuned:
        wl = eng.workloads[key]
        ap.apply_workload(c.WorkloadApply(wl.namespace, wl.name)
                          .with_priority(wl.priority + TUNER_BOOST),
                          field_manager="tuner")
    out["rekeys"] = len(tuned)
    for key in keys[MOVE_OFFSET::STRIDE]:
        wl = eng.workloads[key]
        k = int(wl.queue_name.rsplit("-", 1)[1])
        ap.apply_workload(c.WorkloadApply(wl.namespace, wl.name)
                          .with_queue_name(f"lq-{(k + 1) % n_cqs}"),
                          field_manager="mover")
        out["moves"] += 1
    for key in tuned[:CONFLICTS]:
        wl = eng.workloads[key]
        cfg = c.WorkloadApply(wl.namespace, wl.name).with_priority(
            wl.priority + TUNER_BOOST)
        try:
            ap.apply_workload(cfg, field_manager="other")
        except c.ApplyConflict:
            out["conflicts"] += 1
        ap.apply_workload(cfg, field_manager="other", force=True)
    for name in q["cohort_moves"]:
        k = int(name.rsplit("-", 1)[1]) % n_cohorts
        ap.apply_cluster_queue(c.ClusterQueueApply(name).with_cohort(
            f"cohort-{(k + 1) % n_cohorts}"), field_manager="ops")
        out["cohort_moves"] += 1
    _stop_policy(eng, kit, ap, q["holds"], kit.types.StopPolicy.HOLD)
    return ap


def _stop_policy(eng, kit, ap, lqs, policy):
    for key in lqs:
        ns, name = key.split("/", 1)
        ap.apply_local_queue(kit.client.LocalQueueApply(ns, name)
                             .with_stop_policy(policy), field_manager="ops")


def _after_first(eng, kit, out, ap):
    kc = kit.kueuectl.run
    kc(eng, ["create", "clusterqueue", "cq-new", "--nominal-quota",
             f"default:cpu={NEW_NOMINAL}"])
    kc(eng, ["create", "localqueue", "lq-new", "--clusterqueue", "cq-new",
             "--namespace", NS])
    pend = pending_keys(eng)
    step = max(1, len(pend) // MOVED_NEW)
    for key in pend[10::step][:MOVED_NEW]:
        wl = eng.workloads[key]
        ap.apply_workload(kit.client.WorkloadApply(wl.namespace, wl.name)
                          .with_queue_name("lq-new"), field_manager="mover")
        out["moved_new"] += 1


def _query_endpoint(eng, kit, out, label):
    """The remote client's reads against an endpoint over ``eng``, while
    no cycle runs."""
    ep = kit.http_server.ServingEndpoint(eng, port=0)
    ep.start()
    try:
        rc = kit.client.RemoteClient(f"http://127.0.0.1:{ep.port}",
                                     timeout=120.0)
        cqs = sorted(eng.cache.cluster_queues)
        t0 = time.perf_counter()
        answers = rc.pending_workloads_many(cqs)
        fan_s = time.perf_counter() - t0
        out["fanout_crc"] = crc([answers[n] for n in cqs],
                                out["fanout_crc"])
        out["cqs_fanned"] += len(answers)
        out["remote_cqs_crc"] = crc(_timed(
            out, f"list_cluster_queues_{label}", rc.list_cluster_queues),
            out["remote_cqs_crc"])
        rows = _timed(out, f"list_workloads_{label}", rc.list_workloads)
        out["remote_rows"].append(len(rows))
        out["remote_workloads_crc"] = crc(rows, out["remote_workloads_crc"])
        if not rc.healthz():
            raise AssertionError("healthz answered not ok")
        out["metrics_bytes"].append(len(_timed(
            out, f"metrics_text_{label}", rc.metrics_text)))
        _timed(out, f"debug_dump_{label}", rc.debug_dump)
        out["fanout"].append(dict(after=label, cqs=len(cqs),
                                  seconds=fan_s,
                                  qps=len(cqs) / max(fan_s, 1e-9)))
    finally:
        ep.stop()


def _render(eng, kit, out, work, trace):
    """What ``kueuectl.run`` renders after the run (module docstring)."""
    kc = kit.kueuectl.run
    out["list_workloads_crc"] = zlib.crc32(
        _timed(out, "kc_list_workloads", kc, eng,
               ["list", "workloads"]).encode())
    out["list_localqueues_crc"] = zlib.crc32(
        kc(eng, ["list", "localqueues"]).encode())
    keys = sorted(eng.workloads)
    n = len(eng.cache.cluster_queues) - 1  # cq-new aside
    t0 = time.perf_counter()
    for key in spread(keys, DESCRIBED):
        ns, name = key.split("/", 1)
        out["describe_crc"] = zlib.crc32(kc(eng, [
            "describe", "workload", name, "--namespace", ns]).encode(),
            out["describe_crc"])
    for j in range(DESCRIBED):
        i = j * n // DESCRIBED
        out["describe_crc"] = zlib.crc32(kc(eng, [
            "describe", "clusterqueue", f"cq-{i}"]).encode(),
            out["describe_crc"])
        out["describe_crc"] = zlib.crc32(kc(eng, [
            "describe", "localqueue", f"lq-{i}", "--namespace", NS])
            .encode(), out["describe_crc"])
    out["client_s"]["kc_describe"] = time.perf_counter() - t0
    admitted = sorted(k for k, wl in eng.workloads.items()
                      if wl.is_admitted)
    for key in spread(admitted, DESCRIBED):
        ns, name = key.split("/", 1)
        out["pods_crc"] = zlib.crc32(kc(eng, [
            "list", "pods", "--for", key]).encode(), out["pods_crc"])
        out["get_crc"] = zlib.crc32(kc(eng, [
            "get", "workloads", name, "--namespace", ns]).encode(),
            out["get_crc"])
    t0 = time.perf_counter()
    for key in spread(pending_keys(eng), EXPLAINED):
        ns, name = key.split("/", 1)
        report = json.loads(kc(eng, ["explain", name, "--namespace", ns,
                                     "--json"]))
        (report.get("rebuild") or {}).pop("wall", None)
        (report.get("rebuild") or {}).pop("staleness_s", None)
        out["explain_crc"] = crc(report, out["explain_crc"])
        out["explained"].append(report.get("probe", {}).get("verdict"))
    out["client_s"]["kc_explain"] = time.perf_counter() - t0
    slo = json.loads(kc(eng, ["slo", "--json"]))
    out["slo"] = dict(objectives=sorted(slo["objectives"]),
                      cyclesObserved=slo["cyclesObserved"])
    status = json.loads(kc(eng, ["status", "--json"]))
    out["journal_records"] = status.get("journalRecords")
    out["status_crc"] = crc(status)
    perfetto = os.path.join(work, "trace.perfetto.json")
    line = kc(eng, ["trace", "export", "--input", trace, "--out",
                    perfetto])
    m = re.match(r"exported (\d+) trace event\(s\) from (\d+) cycle", line)
    out["trace_events"], out["trace_trees"] = int(m[1]), int(m[2])


@contextlib.contextmanager
def _replay_engines(kit, built):
    """Capture the engines the replayer builds, each with its executor
    calls counted from its first cycle on
    (``replay_world.count_dispatches``)."""
    from kueue_tpu_torch.bench import replay_world as rw

    mod = kit.replay.replayer
    inner = mod._fresh_engine

    def fresh(*args, **kwargs):
        eng = inner(*args, **kwargs)
        rec = {"engine": eng, "counter": None, "first_cycle": None}

        def first_cycle(seq, engine):
            if rec["first_cycle"] is None:
                rec["first_cycle"] = time.perf_counter()
                if engine.oracle is not None:
                    rec["counter"] = rw.count_dispatches(engine)

        eng.pre_cycle_hooks.append(first_cycle)
        built.append(rec)
        return eng

    mod._fresh_engine = fresh
    try:
        yield
    finally:
        mod._fresh_engine = inner


def _replay(kit, out, trace, device):
    """``kueuectl.main(["replay", TRACE, "--mode", "device"])`` in this
    process: its exit code, its digests and its engine's calls."""
    argv = ["replay", trace, "--mode", "device"]
    if device is not None:
        argv += ["--device", device]
    built: list = []
    text = io.StringIO()
    rc = 0
    t0 = time.perf_counter()
    with _replay_engines(kit, built), contextlib.redirect_stdout(text):
        try:
            kit.kueuectl.main(argv)
        except SystemExit as e:
            rc = 1 if e.code not in (None, 0) else 0
            text.write(str(e.code))
    replay_s = time.perf_counter() - t0
    rendered = text.getvalue()
    m = re.search(r"digest +recorded=(\S+) replayed=(\S+)", rendered)
    cyc = re.search(r"cycles +(\d+)", rendered)
    eng = built[-1]["engine"]
    b = eng.oracle
    counter = built[-1]["counter"] or {"calls": 0}
    out["replay"] = dict(rc=rc, recorded=m[1], replayed=m[2],
                         cycles=int(cyc[1]),
                         on_device=b.cycles_on_device,
                         hybrid=b.cycles_hybrid, fallback=b.cycles_fallback,
                         pipeline_stats=dict(b.pipeline_stats))
    out["replay_dispatched"] = counter["calls"]
    out["replay_rebuild_s"] = (built[-1]["first_cycle"] or t0) - t0
    out["replay_s"] = replay_s
    out["replay_text"] = rendered
    out["engines"].append(eng)


def run(config: dict, kit=None, work: str = None, device=None,
        before_replay=None) -> dict:
    """Build and drive the world of ``config`` on its loop arm, its
    journal, trace and export under the directory ``work``. ``device``
    goes to ``kueuectl main --device`` (the port's; None for the JAX
    package's, whose main has no such flag); ``before_replay()`` runs
    just before the replay. Returns engine_worlds' PINNED numbers,
    ``evicted`` (by reason), ``pipeline_stats``, ``pipeline`` (after
    each cycle), the COUNTS and CRCS, ``informer_late_crc``, and the
    timings: ``build_s``, ``cycle_seconds`` and ``phases`` of every
    cycle but the first, ``client_s`` (seconds of each client step),
    ``fanout`` (per endpoint query: ClusterQueues, seconds, queries a
    second), ``replay_rebuild_s`` and ``replay_s``, plus
    ``replay_dispatched`` (the replay engine's executor calls) and
    ``engines`` (the world's and the replay's)."""
    kit = kit or ew.port_kit()
    with ew.loop_arm(config.get("arm")), pinned_uids(kit):
        return _run(config, kit, work, device, before_replay)


def _run(config, kit, work, device, before_replay) -> dict:
    out = dict.fromkeys(ew.PINNED, 0)
    out.update(dict.fromkeys(CRCS, 0))
    out.update(cycle_seconds=[], phases=[], timing=False, calls=0,
               engine_s=0.0, pipeline=[], client_s={}, fanout=[],
               remote_rows=[], metrics_bytes=[], explained=[], rekeys=0,
               moves=0, conflicts=0, cohort_moves=0, moved_new=0,
               deleted=0, cqs_fanned=0)
    os.makedirs(work, exist_ok=True)
    trace = os.path.join(work, "client_world.trace.jsonl")
    n_cqs = config["n_cohorts"] * config["cqs_per_cohort"]
    eng, early, out["build_s"] = build(config, kit, work)
    ew._instrument(eng, out)
    q = _queues(n_cqs)
    kc = kit.kueuectl.run
    rec = None
    eng.apply_serving_gc_posture()
    try:
        ap = _timed(out, "apply_before_1", _before_first, eng, kit, out, q,
                    config["n_cohorts"], n_cqs)
        last = config["cycles"] + 1
        for k in range(1, last + 1):
            out["timing"] = k > 1  # the first encodes every row
            r = eng.schedule_once()
            out["checksum"] = zlib.crc32(ew.decision_stream(r),
                                         out["checksum"])
            if r is not None:
                out["cycles"] += 1
                out["admitted"] += r.stats.admitted
                out["preempting"] += r.stats.preempting
            out["timing"] = False
            if k == 1:
                _timed(out, "create_and_move_after_1", _after_first, eng,
                       kit, out, ap)
            elif k == 2:
                for name in q["stopped"]:
                    _timed(out, "stop_after_2", kc, eng,
                           ["stop", "clusterqueue", name, "--drain"])
            elif k == 3:
                _timed(out, "drain_hold_after_3", _stop_policy, eng, kit,
                       ap, q["drain_holds"],
                       kit.types.StopPolicy.HOLD_AND_DRAIN)
            elif k == 4:
                pend = pending_keys(eng)
                step = max(1, len(pend) // DELETED)
                for key in pend[5::step][:DELETED]:
                    ns, name = key.split("/", 1)
                    _timed(out, "delete_after_4", kc, eng,
                           ["delete", "workload", name, "--namespace", ns])
                    out["deleted"] += 1
            elif k == 5:
                for name in q["stopped"]:
                    _timed(out, "resume_after_5", kc, eng,
                           ["resume", "clusterqueue", name])
            elif k == RECORD_AFTER:
                _timed(out, "release_after_6", _stop_policy, eng, kit, ap,
                       q["holds"] + q["drain_holds"],
                       kit.types.StopPolicy.NONE)
                t0 = time.perf_counter()
                rec = kit.replay.FlightRecorder(eng, trace,
                                                label="client_world",
                                                bootstrap=True)
                out["client_s"]["record_bootstrap"] = \
                    time.perf_counter() - t0
            if k in ENDPOINT_AFTER or k == last:
                _query_endpoint(eng, kit, out, str(k))
    finally:
        gc.enable()
        gc.unfreeze()
        if rec is not None:
            rec.close()
    out["held_events"] = sum(1 for e in eng.events
                             if e.kind == "WorkloadHeld")
    late = kit.client.Informer(eng)
    late.start()
    out["informer_crc"] = informer_crc(early)
    out["informer_late_crc"] = informer_crc(late)
    early.stop()
    late.stop()
    eng.journal.sync()
    _render(eng, kit, out, work, trace)
    eng.journal.close()
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
    out["engines"] = [eng]
    if before_replay is not None:
        before_replay()
    _replay(kit, out, trace, device)
    return out


def pinned(r: dict) -> dict:
    """What a run must reproduce against the JAX engine's: its PINNED
    numbers, evictions by reason, pipeline_stats, COUNTS and CRCS."""
    got = {k: r[k] for k in ew.PINNED}
    got.update(evicted=r["evicted"], pipeline_stats=r["pipeline_stats"])
    got.update({k: r[k] for k in COUNTS + CRCS})
    return got
