"""Span model for admission tracing.

A scheduling cycle becomes a tree of spans:

    cycle/<seq>                      (kind="cycle")
    ├── phase/snapshot ...           (kind="phase"; sequential path)
    ├── phase/decide
    │   (device cycles: encode/device/apply/finalize instead)
    ├── phase/apply
    ├── workload/<key>               (kind="workload") — one per decided
    │     attrs: decision, flavors, reasons, preemption, rationale ...
    └── ...

Timestamps are microseconds relative to the tracer's epoch (a
perf_counter captured at attach), matching the Chrome/Perfetto
trace-event ``ts`` unit so export is a straight mapping.

``correlation_id`` is the cross-artifact join key: derived purely from
(cycle seq, canonical decisions), so the tracer, the journal and the
flight recorder compute the SAME id independently, in this package and
in the JAX package alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional


@dataclass(slots=True)
class Span:
    """One node of a cycle's span tree. Slotted: a traced bench drain
    allocates one span per decided workload per cycle, and the
    per-instance ``__dict__`` was a measurable share of the tracer's
    wall-clock overhead."""

    name: str
    kind: str                      # "cycle" | "phase" | "workload"
    ts: float                      # µs since tracer epoch
    dur: float                     # µs
    attrs: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    def child(self, name: str, kind: str, ts: float, dur: float,
              **attrs) -> "Span":
        s = Span(name, kind, ts, dur, dict(attrs))
        self.children.append(s)
        return s

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, pred: Callable[["Span"], bool]) -> Optional["Span"]:
        for s in self.walk():
            if pred(s):
                return s
        return None

    def to_dict(self) -> dict:
        """JSON shape served at /debug/trace."""
        return {"name": self.name, "kind": self.kind,
                "ts": round(self.ts, 1), "dur": round(self.dur, 1),
                "attrs": self.attrs,
                "children": [c.to_dict() for c in self.children]}


def correlation_id(seq: int, decisions: list) -> str:
    """Deterministic cross-artifact id for one cycle: ``<seq>-<crc32 of
    the canonical decision record>``. Every subsystem that holds (seq,
    decisions) — tracer, flight recorder, journal, replayer — derives
    the same id with no coordination."""
    from kueue_tpu_torch.replay.trace import decision_digest

    return f"{seq:06d}-{decision_digest(decisions):08x}"
