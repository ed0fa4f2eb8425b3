"""``explain``: why is my workload pending?

The port of ``kueue_tpu/obs/explain.py``, which ``kueuectl explain``
renders (``cli/kueuectl.py``).

Two evidence sources, merged into one report:

  * Retained spans (CycleTracer ring) — what the scheduler ACTUALLY
    decided the last time it considered the workload, on whichever path
    (sequential or oracle bridge) ran the cycle: per-flavor rejection
    reasons, preemption candidates considered vs chosen, TAS verdicts,
    with the cycle's correlation id for joining against the journal and
    flight-recorder frames.
  * A live probe — a one-shot nomination of the workload against a
    fresh snapshot through the real FlavorAssigner / Preemptor / TAS
    pass. This answers the question even when no tracer is attached
    (e.g. kueuectl run against a journal-rebuilt engine) and reflects
    capacity as of NOW rather than the last traced cycle. The probe
    reverts every snapshot mutation (snapshot.close, preemptor
    restore), so probing never perturbs scheduling state.
"""

from __future__ import annotations

from typing import Optional


def explain_workload(engine, key: str, probe: bool = True,
                     now: Optional[float] = None) -> dict:
    report: dict = {"workload": key, "found": False}
    wl = engine.workloads.get(key)
    if wl is None:
        report["error"] = f"workload {key!r} not found"
        return report
    report["found"] = True
    report["status"] = _lifecycle(wl)
    report["cluster_queue"] = (
        wl.status.admission.cluster_queue
        if wl.status.admission is not None
        else engine.queues.cluster_queue_for_workload(wl) or "")

    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        cycle, span = tracer.find_workload(key)
        if span is not None:
            report["trace"] = {
                "cid": cycle.attrs["cid"], "seq": cycle.attrs["seq"],
                "mode": cycle.attrs["mode"], "clock": cycle.attrs["clock"],
                **span.attrs}
    rebuild = _rebuild_stamp(engine, now)
    if rebuild is not None:
        report["rebuild"] = rebuild
    if probe and report["status"] == "pending":
        report["probe"] = _probe(engine, wl)
    return report


def _rebuild_stamp(engine,
                   now: Optional[float] = None) -> Optional[dict]:
    """Provenance of a journal-rebuilt engine: the position recovery
    replayed to and how stale that state is now. None for a live
    engine — the distinction the report must never blur (a rebuilt
    engine presenting as live answers "why is my workload pending"
    from a past world). ``now`` is the injectable clock seam: callers
    under virtual time pass their clock's reading; the read plane
    strips the whole stamp (explain_answer pops "rebuild")."""
    pos = getattr(engine, "rebuild_position", None)
    if pos is None:
        return None
    out = {"position": pos}
    wall = getattr(engine, "rebuild_wall", None)
    if wall is not None:
        if now is None:
            import time

            now = time.time()
        out["wall"] = wall
        out["staleness_s"] = round(max(0.0, now - wall), 3)
    return out


def _lifecycle(wl) -> str:
    if wl.is_finished:
        return "finished"
    if wl.status.admission is not None:
        return "admitted"
    return "pending"


def _probe(engine, wl) -> dict:
    """One-shot nomination through the real decision core."""
    from kueue_tpu_torch.obs import hooks
    from kueue_tpu_torch.scheduler.flavorassigner import Mode
    from kueue_tpu_torch.workload_info import WorkloadInfo

    info = engine.queues.rows.info_for(wl.key)
    if info is None:
        cq_name = engine.queues.cluster_queue_for_workload(wl)
        if cq_name is None:
            return {"error": "workload has no ClusterQueue mapping"}
        info = WorkloadInfo.from_workload(
            wl, cq_name, options=engine.queues.info_options)
    snapshot = engine.cache.snapshot()
    prev, hooks.CURRENT = hooks.CURRENT, hooks.RationaleBuffer()
    try:
        if info.cluster_queue in snapshot.inactive_cluster_queues:
            return {"verdict": "inadmissible",
                    "message": f"ClusterQueue {info.cluster_queue} "
                               "is inactive"}
        if snapshot.cluster_queue(info.cluster_queue) is None:
            return {"verdict": "inadmissible",
                    "message": f"ClusterQueue {info.cluster_queue} "
                               "not found"}
        assignment, targets = engine.cycle._get_assignments(
            info, snapshot, engine.clock)
        buf = hooks.CURRENT
        mode = assignment.representative_mode()
        out: dict = {
            "verdict": {Mode.FIT: "fits", Mode.PREEMPT: "preempt",
                        Mode.NO_FIT: "no-fit"}[mode],
            "borrowing": assignment.borrowing,
            "flavors": {ps.name: {res: fa.name
                                  for res, fa in ps.flavors.items()}
                        for ps in assignment.pod_sets if ps.flavors},
            "reasons": {ps.name: list(ps.reasons)
                        for ps in assignment.pod_sets if ps.reasons},
        }
        if mode != Mode.FIT and not out["reasons"]:
            out["message"] = assignment.message()
        if targets:
            out["preemption_chosen"] = sorted(
                [t.workload.key, t.reason] for t in targets)
        elif mode == Mode.PREEMPT:
            out["message"] = ("requires preemption, but no candidates "
                              "found")
        rationale = (buf.by_workload().get(info.key)
                     if buf is not None else None)
        if rationale:
            out["rationale"] = [{"kind": k, **a} for k, a in rationale]
        return out
    finally:
        hooks.CURRENT = prev
        snapshot.close()


def render_explain(report: dict) -> str:
    """Human rendering for the CLI."""
    lines = [f"Workload: {report['workload']}"]
    if not report.get("found"):
        lines.append(f"  {report.get('error', 'not found')}")
        return "\n".join(lines)
    lines.append(f"  Status:        {report['status']}")
    lines.append(f"  ClusterQueue:  {report['cluster_queue']}")
    rb = report.get("rebuild")
    if rb is not None:
        pos = rb.get("position") or {}
        where = (f"lineage {pos.get('lineage', '?')} "
                 f"seg {pos.get('segment', '?')} "
                 f"offset {pos.get('offset', '?')}")
        age = rb.get("staleness_s")
        lines.append(f"  Source:        journal rebuild @ {where}"
                     + (f" ({age:.1f}s ago)" if age is not None
                        else ""))
    tr = report.get("trace")
    if tr is not None:
        lines.append(f"  Last traced decision (cycle {tr['seq']}, "
                     f"mode={tr['mode']}, cid={tr['cid']}):")
        lines.append(f"    decision: {tr.get('decision', '?')}")
        _render_detail(lines, tr, indent="    ")
    probe = report.get("probe")
    if probe is not None:
        if "error" in probe:
            lines.append(f"  Probe: {probe['error']}")
        else:
            lines.append(f"  If scheduled now: {probe['verdict']}")
            _render_detail(lines, probe, indent="    ")
    if tr is None and probe is None:
        lines.append("  (no retained trace span; workload not pending)")
    return "\n".join(lines)


def _render_detail(lines: list, src: dict, indent: str) -> None:
    for ps, flavs in (src.get("flavors") or {}).items():
        pairs = ", ".join(f"{r}→{f}" for r, f in sorted(flavs.items()))
        lines.append(f"{indent}flavors[{ps}]: {pairs}")
    for ps, reasons in (src.get("reasons") or {}).items():
        for r in reasons:
            lines.append(f"{indent}rejected[{ps}]: {r}")
    if src.get("message"):
        lines.append(f"{indent}message: {src['message']}")
    if src.get("requeue_reason"):
        lines.append(f"{indent}requeue: {src['requeue_reason']}")
    for t in src.get("preemption_chosen", ()):
        lines.append(f"{indent}preempts: {t[0]} ({t[1]})")
    for ev in src.get("rationale", ()):
        kind = ev.get("kind")
        if kind == "preemption":
            lines.append(
                f"{indent}preemption[{ev.get('strategy', '?')}]: "
                f"considered {len(ev.get('considered', []))} "
                f"candidate(s), chose {len(ev.get('chosen', []))}")
        elif kind == "flavor_search":
            lines.append(
                f"{indent}flavor search[{ev.get('resource', '?')}]: "
                f"tried {ev.get('tried', [])} → "
                f"{ev.get('pmode', '?')}")
        elif kind == "tas":
            lines.append(
                f"{indent}tas: {ev.get('before', '?')} → "
                f"{ev.get('after', '?')} "
                f"(placed: {ev.get('placed', [])})")
