"""Informer/lister layer — event-driven local caches with handlers,
ported from ``kueue_tpu/client/informers.py``.

The reference's controllers never poll: client-go informers deliver
Add/Update/Delete callbacks from the watch stream and back a read-only
lister cache. Here the watch stream is the engine's event fan-out
(engine.event_listeners); the informer keeps a workload lister in sync
and dispatches typed handlers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class WorkloadRecord:
    key: str
    cluster_queue: str = ""
    phase: str = "Pending"  # Pending/Admitted/Finished/Evicted
    last_event: str = ""
    last_transition: float = 0.0


@dataclass
class Informer:
    """Subscribes to an engine's event stream, maintains a lister, and
    dispatches handlers. handlers: fn(event, record)."""

    engine: object
    handlers: list[Callable] = field(default_factory=list)
    store: dict[str, WorkloadRecord] = field(default_factory=dict)
    started: bool = False

    _PHASES = {
        "Submitted": "Pending",
        "Requeued": "Pending",
        "QuotaReserved": "Pending",
        "Admitted": "Admitted",
        "Evicted": "Pending",
        "Preempted": "Pending",
        "Finished": "Finished",
    }

    def start(self) -> None:
        """Replay history (informer initial LIST) then follow the live
        stream (WATCH)."""
        if self.started:
            return
        self.started = True
        for ev in self.engine.events:
            self._on_event(ev, replay=True)
        self.engine.event_listeners.append(self._on_event)

    def stop(self) -> None:
        if self._on_event in self.engine.event_listeners:
            self.engine.event_listeners.remove(self._on_event)
        self.started = False

    def add_handler(self, fn: Callable) -> None:
        self.handlers.append(fn)

    def get(self, key: str) -> Optional[WorkloadRecord]:
        return self.store.get(key)

    def list(self, phase: Optional[str] = None) -> list[WorkloadRecord]:
        out = list(self.store.values())
        if phase is not None:
            out = [r for r in out if r.phase == phase]
        return out

    def _on_event(self, ev, replay: bool = False) -> None:
        if not ev.workload:
            return
        rec = self.store.setdefault(ev.workload,
                                    WorkloadRecord(key=ev.workload))
        if ev.cluster_queue:
            rec.cluster_queue = ev.cluster_queue
        phase = self._PHASES.get(ev.kind)
        if phase is not None:
            rec.phase = phase
        rec.last_event = ev.kind
        rec.last_transition = ev.time
        if not replay:
            for fn in self.handlers:
                fn(ev, rec)
