"""Leader election: single-active-scheduler HA.

The port of ``kueue_tpu/utils/leaderelection.py``, unchanged.

Reference: the manager runs with controller-runtime lease-based leader
election (cmd/kueue main.go LeaderElection options, renew/lease
durations from the Configuration) and pkg/util/roletracker — only the
leader's scheduler admits; followers keep caches warm and take over when
the lease lapses.

Standalone design: a JSON lease file on shared storage is the Lease
object. ``LeaderElector.tick(now)`` drives acquire/renew against an
injected clock (tests use the engine clock; production passes
time.time). On acquire, the engine rebuilds from the shared journal (the
informer-resync a new leader performs); on lease loss it demotes and
stops scheduling.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 Lease, the fields that matter."""

    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration_seconds: float = 15.0


class LeaseFile:
    """The durable lock object. Writes are atomic (tempfile + rename);
    the read-modify-write of an acquire/renew is serialized by an fcntl
    lock on a sidecar file (the CAS the reference gets from the API
    server's resourceVersion) — without it two standbys could both read
    an expired lease and both acquire."""

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"

    def locked(self):
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

    def read(self) -> Optional[LeaseSpec]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        return LeaseSpec(**raw)

    def write(self, lease: LeaseSpec) -> None:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(vars(lease), f)
        os.replace(tmp, self.path)


class LeaderElector:
    """client-go leaderelection.LeaderElector semantics: acquire when
    the lease is free or expired, renew while holding, demote when a
    renew discovers another holder."""

    def __init__(self, identity: str, lease: LeaseFile,
                 lease_duration_seconds: float = 15.0,
                 on_started_leading=None, on_stopped_leading=None):
        self.identity = identity
        self.lease = lease
        self.lease_duration = lease_duration_seconds
        self.is_leader = False
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading

    def tick(self, now: float) -> bool:
        """One acquire-or-renew attempt; returns leadership. The whole
        read-check-write runs under the lease's file lock so only one
        replica can win an expired lease."""
        with self.lease.locked():
            current = self.lease.read()
            expired = (current is None or not current.holder
                       or now - current.renew_time
                       > current.lease_duration_seconds)
            if current is not None and current.holder == self.identity:
                # Renew (or re-acquire our own expired lease).
                current.renew_time = now
                self.lease.write(current)
                self._set_leader(True)
                return True
            if expired:
                self.lease.write(LeaseSpec(
                    holder=self.identity, acquire_time=now,
                    renew_time=now,
                    lease_duration_seconds=self.lease_duration))
                self._set_leader(True)
                return True
        self._set_leader(False)
        return False

    def release(self) -> None:
        """Graceful handoff (ReleaseOnCancel)."""
        with self.lease.locked():
            current = self.lease.read()
            if current is not None and current.holder == self.identity:
                self.lease.write(LeaseSpec(
                    lease_duration_seconds=current
                    .lease_duration_seconds))
        self._set_leader(False)

    def _set_leader(self, leading: bool) -> None:
        if leading and not self.is_leader:
            self.is_leader = True
            if self.on_started_leading is not None:
                self.on_started_leading()
        elif not leading and self.is_leader:
            self.is_leader = False
            if self.on_stopped_leading is not None:
                self.on_stopped_leading()


class HAEngine:
    """An engine replica under leader election: followers hold a warm
    standby; the winner rebuilds from the shared journal and schedules.

    The reference analog: every replica runs informers (cache warm), but
    the scheduler/controllers gate on the leadership role
    (roletracker)."""

    def __init__(self, identity: str, lease_path: str, journal_path: str,
                 lease_duration_seconds: float = 15.0):
        self.identity = identity
        self.journal_path = journal_path
        self.engine = None
        self.elector = LeaderElector(
            identity, LeaseFile(lease_path),
            lease_duration_seconds=lease_duration_seconds,
            on_started_leading=self._promote,
            on_stopped_leading=self._demote)

    def _promote(self) -> None:
        from kueue_tpu_torch.store.journal import rebuild_engine

        if os.path.exists(self.journal_path):
            self.engine = rebuild_engine(self.journal_path)
        else:
            from kueue_tpu_torch.controllers.engine import Engine
            from kueue_tpu_torch.store.journal import attach_new_journal

            self.engine = Engine()
            attach_new_journal(self.engine, self.journal_path)

    def _demote(self) -> None:
        self.engine = None  # follower: no scheduling, no journal writes

    def tick(self, now: float) -> None:
        self.elector.tick(now)

    def schedule_once(self):
        """Scheduling is leader-only (the roletracker gate)."""
        if not self.elector.is_leader or self.engine is None:
            return None
        return self.engine.schedule_once()
