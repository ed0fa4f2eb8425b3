"""The read-plane query surface: what a replica answers, canonically.

The port of ``kueue_tpu/readplane/queries.py``.

Every query family here is a pure function of engine state — no
wall-clock reads, no mutation (a replica's engine is a rebuilt read
model; perturbing it would desynchronize it from the journal position
it claims to answer from). The canonical encoding exists for the sim
oracle's read-replica invariant: a replica's answer at journal
position P must be byte-identical to the leader's answer at P, so the
encoding is fully deterministic (sorted keys, no whitespace, no
engine-identity leakage like tracer attachment or probe timings).
"""

from __future__ import annotations

import json

QUERY_KINDS = ("position", "quota", "pending", "explain")


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def position_answer(engine, cq_name: str) -> dict:
    """Pending positions for one ClusterQueue, in admission priority
    order — same item shape as the visibility API's pendingworkloads
    view, but computed over the full pending set (active heap AND the
    inadmissible backoff parking lot). Heap membership is transient
    scheduler state that is NOT journaled, so an answer keyed off it
    could never be replica-identical; the union is a pure function of
    the durable workload set and orders identically on any engine
    rebuilt to the same position."""
    pcq = engine.queues.cluster_queues.get(cq_name)
    items = []
    if pcq is not None:
        union = dict(pcq.items)
        union.update(pcq.inadmissible)
        ordered = sorted(
            union.values(),
            key=lambda info: (-info.obj.effective_priority,
                              info.obj.creation_time, info.obj.name))
        lq_positions: dict = {}
        for pos, info in enumerate(ordered):
            lq = info.obj.queue_name
            lq_pos = lq_positions.get(lq, 0)
            lq_positions[lq] = lq_pos + 1
            items.append({
                "name": info.obj.name,
                "namespace": info.obj.namespace,
                "local_queue": lq,
                "priority": info.obj.effective_priority,
                "position_in_cluster_queue": pos,
                "position_in_local_queue": lq_pos})
    return {"clusterQueue": cq_name, "items": items}


def quota_answer(engine) -> dict:
    """Per CQ x flavor x resource usage vs nominal."""
    from kueue_tpu_torch.visibility.server import capacity_summary

    rows = sorted(capacity_summary(engine),
                  key=lambda r: (r["clusterQueue"], r["flavor"],
                                 r["resource"]))
    return {"capacity": rows}


def pending_answer(engine) -> dict:
    """All pending workloads across every ClusterQueue, positioned."""
    out = {}
    for cq in sorted(engine.queues.cluster_queues):
        ans = position_answer(engine, cq)
        if ans["items"]:
            out[cq] = ans["items"]
    return {"pending": out}


def explain_answer(engine, key: str) -> dict:
    """Workload lifecycle + rationale. Probe-free by design: the live
    probe nominates against a snapshot (read-only but tracer/timing
    shaped), while this answer must be a pure function of journal
    state so replicas and the leader agree byte-for-byte."""
    from kueue_tpu_torch.obs.explain import explain_workload

    report = explain_workload(engine, key, probe=False)
    report.pop("trace", None)  # tracer attachment is engine-local
    report.pop("rebuild", None)  # stamped per-engine, not per-position
    return report


def answer_query(engine, kind: str, arg: str = None) -> dict:
    if kind == "position":
        return position_answer(engine, arg or "")
    if kind == "quota":
        return quota_answer(engine)
    if kind == "pending":
        return pending_answer(engine)
    if kind == "explain":
        return explain_answer(engine, arg or "")
    raise ValueError(f"unknown read-query kind {kind!r}")


def canonical_answer(engine) -> bytes:
    """One deterministic byte string covering the whole query surface
    at the engine's current state: pending positions per CQ, the quota
    table, and a probe-free explain for every known workload. Two
    engines rebuilt to the same journal position MUST produce the same
    bytes — the sim oracle's read_replica invariant asserts exactly
    that, and the readplane smoke spot-checks it between live
    processes."""
    body = {
        "pending": pending_answer(engine)["pending"],
        "quota": quota_answer(engine)["capacity"],
        "workloads": {key: explain_answer(engine, key)
                      for key in sorted(engine.workloads)},
    }
    return _dumps(body).encode()
