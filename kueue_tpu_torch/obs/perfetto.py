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

The exporter serves live retained spans (CycleTracer). Flight-recorder
traces (``spans_from_flight_trace``) wait for the flight recorder,
ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import json
from typing import Iterable

from kueue_tpu_torch.obs.span import Span

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

    Needs the flight recorder's ``TraceReader`` (``replay/``), which the
    port does not have yet: ROADMAP Queue 1 item 4."""
    raise NotImplementedError(
        "spans_from_flight_trace needs the flight recorder's TraceReader,"
        " not ported yet (ROADMAP Queue 1 item 4)")
