"""Rationale hooks: how decision-path code reports *why* to the tracer.

The scheduler's hot path (flavorassigner try-loop, preemptor candidate
search, TAS pass) must not pay for tracing when it is off, and must not
know about span trees. The contract is a single module-level slot:

    CURRENT — the active cycle's RationaleBuffer, or None (tracing off).

Emit sites guard on ``CURRENT is not None`` (one global load + identity
check — nanoseconds) and append plain tuples when tracing is on. The
CycleTracer installs a fresh buffer from Engine.pre_cycle_hooks and
drains it from Engine.cycle_listeners, so rationale events are scoped to
exactly one cycle. The hooks are strictly write-only from the decision
path: nothing in here can feed back into a scheduling decision, which is
what keeps traced and untraced runs decision-digest-identical.

Process-global by design (one engine per process is the serving
posture); a second concurrently-traced engine in the same process would
interleave rationale, not corrupt decisions.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

CURRENT: Optional["RationaleBuffer"] = None


class RationaleBuffer:
    """Per-cycle collection point for (kind, workload-key, attrs)."""

    __slots__ = ("events",)

    def __init__(self) -> None:
        self.events: list[tuple[str, str, dict]] = []

    def emit(self, kind: str, key: str, **attrs) -> None:
        self.events.append((kind, key, attrs))

    def by_workload(self) -> dict[str, list[tuple[str, dict]]]:
        out: dict[str, list[tuple[str, dict]]] = defaultdict(list)
        for kind, key, attrs in self.events:
            out[key].append((kind, attrs))
        return dict(out)


def emit(kind: str, key: str, **attrs) -> None:
    """Report one rationale event for ``key``; free when tracing is off."""
    buf = CURRENT
    if buf is not None:
        buf.emit(kind, key, **attrs)


def active() -> bool:
    return CURRENT is not None
