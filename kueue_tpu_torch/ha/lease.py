"""Fenced lease file: leader election with a monotonic epoch token.

The port of ``kueue_tpu/ha/lease.py``, unchanged.

The plain lease (`utils/leaderelection.py`) proved single-active-
scheduler handoff but its lease carries no fencing token: a deposed
leader that wakes from a long stall cannot be told apart from the
current one by anything it writes. This lease adds the classic fencing
fix — a **monotonic epoch** bumped on every acquisition by a new
holder term. Writers stamp their epoch into what they write (the
``ha_digest`` journal records) and check it before committing
(`store.journal.Journal.fence`), so a stale leader's writes are refused
rather than interleaved.

Durability discipline mirrors ``store/journal.py``: the lease is a
small JSON file written atomically (tempfile + fsync + rename) and
every read-modify-write runs under an fcntl lock on a sidecar file —
the CAS the reference gets from the API server's resourceVersion.
Without it two standbys could both read an expired lease and both
"win" the same epoch.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional


@dataclass
class LeaseState:
    """coordination.k8s.io/v1 Lease plus the fencing epoch."""

    holder: str = ""
    epoch: int = 0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration_seconds: float = 15.0

    def expired(self, now: float) -> bool:
        return (not self.holder
                or now - self.renew_time > self.lease_duration_seconds)


class FencedLease:
    """The durable lock object. All mutations are epoch-monotonic:
    ``epoch`` never decreases, and acquisition of a free/expired lease
    bumps it — each leadership term owns exactly one epoch."""

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"

    def _locked(self):
        import fcntl
        from contextlib import contextmanager

        @contextmanager
        def _hold():
            with open(self._lock_path, "a+") as lock_fh:
                fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lock_fh.fileno(), fcntl.LOCK_UN)
        return _hold()

    def read(self) -> Optional[LeaseState]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        return LeaseState(**raw)

    def _write(self, lease: LeaseState) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(vars(lease), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- the three verbs, each a single critical section --

    def try_acquire(self, identity: str, now: float,
                    duration: float) -> Optional[LeaseState]:
        """Acquire when free/expired (epoch bumps), renew when already
        held by ``identity`` (epoch unchanged — same term). Returns the
        held LeaseState, or None when another live holder owns it."""
        with self._locked():
            current = self.read()
            if current is not None and current.holder == identity:
                current.renew_time = now
                self._write(current)
                return current
            if current is None or current.expired(now):
                state = LeaseState(
                    holder=identity,
                    epoch=(current.epoch if current else 0) + 1,
                    acquire_time=now, renew_time=now,
                    lease_duration_seconds=duration)
                self._write(state)
                return state
        return None

    def renew(self, identity: str, epoch: int,
              now: float) -> Optional[LeaseState]:
        """Renew only our own term: holder AND epoch must still match —
        a renewed lease under a different epoch means we were deposed
        and re-elected without noticing, which the fencing contract
        treats as loss."""
        with self._locked():
            current = self.read()
            if (current is not None and current.holder == identity
                    and current.epoch == epoch):
                current.renew_time = now
                self._write(current)
                return current
        return None

    def release(self, identity: str) -> None:
        """Graceful handoff (ReleaseOnCancel): clear the holder but KEEP
        the epoch — the next acquirer must still fence us out."""
        with self._locked():
            current = self.read()
            if current is not None and current.holder == identity:
                self._write(LeaseState(
                    epoch=current.epoch,
                    lease_duration_seconds=current
                    .lease_duration_seconds))

    def epoch_of(self) -> int:
        current = self.read()
        return current.epoch if current is not None else 0
