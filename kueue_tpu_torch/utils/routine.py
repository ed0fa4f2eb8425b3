"""Async routine wrappers for admission API calls.

The port of ``kueue_tpu/utils/routine.py``, unchanged.

Reference: pkg/util/routine/wrapper.go — ``Wrapper.Run(f)`` runs ``f`` in a
goroutine with optional before/after hooks; the scheduler issues its
admission status patches through it (scheduler.go:870) so a slow apiserver
never blocks the scheduling loop, and unit tests swap in a synchronous
wrapper (scheduler.go:220 setAdmissionRoutineWrapper) for determinism.

The rebuild's engine is single-threaded and lock-free by design (SURVEY §5
race detection), so the engine requires the synchronous wrapper — it is
both the deterministic test mode and the correct in-memory behavior (there
is no apiserver round-trip to hide; the admission closure mutates engine
state directly). ``ThreadWrapper`` provides the reference's asynchronous
form for OUT-OF-PROCESS appliers whose closures only do I/O (socket
replies, journal shipping) — never hand it to an in-process Engine.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class SyncWrapper:
    """Run inline. The analog of the test wrapper the reference injects
    via setAdmissionRoutineWrapper."""

    def __init__(self, before: Optional[Callable] = None,
                 after: Optional[Callable] = None) -> None:
        self.before = before
        self.after = after

    def run(self, f: Callable[[], None]) -> None:
        if self.before is not None:
            self.before()
        try:
            f()
        finally:
            if self.after is not None:
                self.after()


class ThreadWrapper:
    """routine.wrapper: before() inline, then f (and after()) on a thread.
    ``join()`` drains in-flight routines (shutdown). Finished threads are
    pruned on every run() so a long-lived wrapper does not accumulate
    one Thread object per call."""

    def __init__(self, before: Optional[Callable] = None,
                 after: Optional[Callable] = None) -> None:
        self.before = before
        self.after = after
        self._threads: list[threading.Thread] = []

    def run(self, f: Callable[[], None]) -> None:
        if self.before is not None:
            self.before()

        def _body() -> None:
            try:
                f()
            finally:
                if self.after is not None:
                    self.after()

        self._threads = [t for t in self._threads if t.is_alive()]
        t = threading.Thread(target=_body, daemon=True)
        self._threads.append(t)
        t.start()

    def join(self, timeout: Optional[float] = None) -> None:
        """Drain with ``timeout`` as a TOTAL deadline, not per-thread."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        for t in self._threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - _time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]
