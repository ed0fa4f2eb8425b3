"""Chrome/Perfetto trace-event export for cycle span trees.

Emits the JSON object form (``{"traceEvents": [...]}``) of the Trace
Event Format understood by Perfetto and chrome://tracing. Two lanes:

  tid 1 "cycles"    — complete events ("ph":"X") for cycle and phase
                      spans; phases nest under their cycle by time
                      containment, which is how the viewers render
                      hierarchy on one track.
  tid 2 "decisions" — instant events ("ph":"i") for per-workload
                      decision spans, args carrying the structured
                      rationale (flavors tried, rejection reasons,
                      preemption candidates vs chosen, TAS verdicts).

The exporter serves live retained spans (CycleTracer) and offline
flight-recorder traces (``spans_from_flight_trace``: phase-level trees
rebuilt from cycle frames, with correlation ids regenerated
identically).
"""

from __future__ import annotations

import json
from typing import Iterable

from kueue_tpu_torch.obs.span import Span, correlation_id

PID = 1
TID_CYCLES = 1
TID_DECISIONS = 2


def to_perfetto(roots: Iterable[Span]) -> dict:
    events: list[dict] = [
        {"ph": "M", "pid": PID, "tid": 0, "ts": 0,
         "name": "process_name", "args": {"name": "kueue_tpu"}},
        {"ph": "M", "pid": PID, "tid": TID_CYCLES, "ts": 0,
         "name": "thread_name", "args": {"name": "cycles"}},
        {"ph": "M", "pid": PID, "tid": TID_DECISIONS, "ts": 0,
         "name": "thread_name", "args": {"name": "decisions"}},
    ]
    for root in roots:
        for s in root.walk():
            if s.kind == "workload":
                events.append({"name": s.name, "ph": "i", "s": "t",
                               "ts": s.ts, "pid": PID,
                               "tid": TID_DECISIONS, "args": s.attrs})
            else:
                events.append({"name": s.name, "ph": "X", "ts": s.ts,
                               "dur": s.dur, "pid": PID,
                               "tid": TID_CYCLES, "args": s.attrs})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(roots: Iterable[Span], path: str) -> int:
    """Write the export; returns the number of trace events."""
    doc = to_perfetto(roots)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, default=str)
    return len(doc["traceEvents"])


def spans_from_flight_trace(path: str) -> list[Span]:
    """Rebuild phase-level span trees from a flight-recorder trace.

    Cycle frames carry everything but wall-clock span bounds; the
    engine clock becomes the timeline (µs = clock * 1e6) and phases lay
    end-to-end from it. Workload spans carry the canonical decision
    record (admissions + preemptions); rationale attributes exist only
    in live-retained spans."""
    from kueue_tpu_torch.replay.trace import TraceReader

    roots: list[Span] = []
    for frame in TraceReader(path):
        if frame.get("f") != "cycle":
            continue
        seq = frame["seq"]
        decisions = frame.get("decisions", [])
        phases = dict(frame.get("phases", {}))
        sim = phases.pop("sim", None)
        if sim is not None and "encode" in phases:
            # The port's frames time the sim nomination apart; the JAX
            # encode holds it, and so does the span tree (obs/tracer.py).
            phases["encode"] += sim
        total = sum(phases.values()) * 1e6
        ts = frame.get("clock", 0.0) * 1e6
        cid = frame.get("cid") or correlation_id(seq, decisions)
        admitted = decisions[0] if decisions else []
        preempting = decisions[1] if len(decisions) > 1 else []
        root = Span(f"cycle/{seq}", "cycle", ts, total, {
            "seq": seq, "cid": cid, "mode": frame.get("mode", ""),
            "clock": frame.get("clock", 0.0),
            "admitted": len(admitted), "preempting": len(preempting),
            "digest": frame.get("digest", "")})
        cursor = ts
        for phase, secs in phases.items():
            root.child(f"phase/{phase}", "phase", cursor, secs * 1e6,
                       seconds=secs)
            cursor += secs * 1e6
        for key, cq, pod_sets in admitted:
            root.child(f"workload/{key}", "workload", ts, 0.0,
                       decision="admitted", cluster_queue=cq,
                       flavors={name: dict(flavs)
                                for name, flavs, *_ in pod_sets})
        for key, targets in preempting:
            root.child(f"workload/{key}", "workload", ts, 0.0,
                       decision="preempting", preemption_chosen=targets)
        roots.append(root)
    return roots
