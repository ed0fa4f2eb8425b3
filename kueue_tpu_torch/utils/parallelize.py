"""Bounded parallel fan-out for I/O-bound work pieces: the port of
``kueue_tpu/utils/parallelize.py``.

Reference: pkg/util/parallelize/parallelize.go — ``Until`` runs N work
pieces over at most 8 workers and surfaces the FIRST error (ErrorChannel
keeps one error, the rest are dropped); the reference uses it for API-call
fan-outs like issuing evictions (preemption.go:207 ParallelizeUntil) and
MultiKueue remote-object cleanup.

Only hand this I/O-bound closures that do not touch shared engine state:
the in-process Engine/QueueManager are lock-free single-threaded by design
(SURVEY §5), so engine mutation must stay on the caller's thread. Remote
clients (client/http_client.py), journal shipping, and socket replies are
the intended work pieces.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

MAX_PARALLELISM = 8


class ErrorChannel:
    """parallelize.go ErrorChannel: keeps at most one error."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._err: Optional[BaseException] = None

    def send_error(self, err: Optional[BaseException]) -> None:
        if err is None:
            return
        with self._lock:
            if self._err is None:
                self._err = err

    def receive(self) -> Optional[BaseException]:
        with self._lock:
            err, self._err = self._err, None
            return err


def until(pieces: int, do_work_piece: Callable[[int], None],
          max_workers: int = MAX_PARALLELISM,
          cancel: Optional[threading.Event] = None
          ) -> Optional[BaseException]:
    """Run ``do_work_piece(i)`` for i in [0, pieces) over at most
    ``max_workers`` threads; returns the first raised exception (or
    None). ``cancel`` stops handing out new pieces once set — started
    pieces run to completion, matching ParallelizeUntil's ctx-cancel
    semantics."""
    if pieces <= 0:
        return None
    err_ch = ErrorChannel()
    # First error stops handing out new pieces (ErrorChannel's
    # SendErrorWithCancel semantics); started pieces run to completion.
    stop = threading.Event()

    def cancelled() -> bool:
        return stop.is_set() or (cancel is not None and cancel.is_set())

    if pieces == 1 or max_workers <= 1:
        for i in range(pieces):
            if cancelled():
                break
            try:
                do_work_piece(i)
            except Exception as e:  # noqa: BLE001
                err_ch.send_error(e)
                stop.set()
        return err_ch.receive()

    next_i = [0]
    lock = threading.Lock()

    def worker() -> None:
        while True:
            if cancelled():
                return
            with lock:
                i = next_i[0]
                if i >= pieces:
                    return
                next_i[0] = i + 1
            try:
                do_work_piece(i)
            except BaseException as e:  # noqa: BLE001 — SystemExit etc.
                # raised in a worker thread would otherwise vanish
                # (Python swallows them off the main thread) and the run
                # would falsely report success.
                err_ch.send_error(e)
                stop.set()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(min(pieces, max_workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return err_ch.receive()
