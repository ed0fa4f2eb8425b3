"""The disk budget: a free-space preflight before every journal append
and checkpoint write, a read-only degraded mode, and re-arming when
space returns.

The port of ``kueue_tpu/store/diskguard.py``:

  * **preflight**: an append or a checkpoint first checks the free
    bytes of its filesystem against ``min_free_bytes``, and is refused
    before the write syscall, so a full disk never leaves a torn record
    behind;
  * **degraded**: a refused preflight (or a real ENOSPC) makes the
    budget read-only: journal appends raise ``JournalDegraded``
    (store/journal.py), POST ``/workloads`` answers 503 and the engine
    parks its cycles; reads and replay go on;
  * **re-arm**: ``rearm_probe()`` checks again and arms the budget as
    soon as the filesystem has room. While degraded, a refused write
    probes only every ``probe_every``-th time (one ``statvfs`` each).

``FREE_BYTES_PROBE`` is the test seam: set it to a function of the path
that returns the free bytes to walk a budget down and back up without
filling a disk.
"""

from __future__ import annotations

import os

# Test seam: when set, called with a path and returns the free bytes of
# its filesystem in place of statvfs.
FREE_BYTES_PROBE = None

ARMED, DEGRADED = "armed", "degraded"
_STATE_CODE = {ARMED: 0.0, DEGRADED: 1.0}


def free_bytes(path: str) -> int:
    """Free bytes this process may use on ``path``'s filesystem
    (f_bavail: the root reserve does not count)."""
    if FREE_BYTES_PROBE is not None:
        return int(FREE_BYTES_PROBE(path))
    st = os.statvfs(os.path.dirname(os.path.abspath(path)) or ".")
    return int(st.f_bavail) * int(st.f_frsize)


class DiskBudget:
    """The free-space budget of one journal file or checkpoint
    directory; ``min_free_bytes`` <= 0 turns the guard off."""

    def __init__(self, path: str, min_free_bytes: int = 0,
                 probe_every: int = 16, metrics=None):
        self.path = path
        self.min_free_bytes = max(0, int(min_free_bytes))
        self.probe_every = max(1, int(probe_every))
        self.metrics = metrics
        self.state = ARMED
        self.reason = ""
        self.checks = 0
        self.refusals = 0
        self.degradations = 0
        self.rearms = 0
        self._since_probe = 0

    @property
    def enabled(self) -> bool:
        return self.min_free_bytes > 0

    @property
    def degraded(self) -> bool:
        return self.state == DEGRADED

    def preflight(self, need_bytes: int = 0) -> bool:
        """True when a write of ``need_bytes`` may proceed; False means
        the budget is degraded and the caller refuses the write."""
        if not self.enabled:
            return True
        self.checks += 1
        if self.state == DEGRADED:
            self._since_probe += 1
            if self._since_probe >= self.probe_every:
                self._since_probe = 0
                if self._probe_ok(need_bytes):
                    self._rearm("probe: free space recovered")
                    return True
            self.refusals += 1
            return False
        if self._probe_ok(need_bytes):
            return True
        self._degrade(f"preflight: free < min_free_bytes="
                      f"{self.min_free_bytes}")
        self.refusals += 1
        return False

    def note_enospc(self, err: OSError) -> None:
        """A write hit ENOSPC past the preflight: degrade as a refused
        preflight would."""
        if self.enabled and self.state == ARMED:
            self._degrade(f"ENOSPC from kernel: {err}")

    def rearm_probe(self, need_bytes: int = 0) -> bool:
        """Check free space now and re-arm if it recovered. True when
        the budget is armed after the probe."""
        if not self.enabled or self.state == ARMED:
            return True
        self._since_probe = 0
        if self._probe_ok(need_bytes):
            self._rearm("rearm_probe: free space recovered")
            return True
        return False

    def _probe_ok(self, need_bytes: int) -> bool:
        try:
            free = free_bytes(self.path)
        except OSError:
            return True  # a failed statvfs never wedges the writes
        return free >= self.min_free_bytes + max(0, int(need_bytes))

    def _degrade(self, reason: str) -> None:
        self.state = DEGRADED
        self.reason = reason
        self.degradations += 1
        self._since_probe = 0
        self._export()

    def _rearm(self, reason: str) -> None:
        self.state = ARMED
        self.reason = reason
        self.rearms += 1
        self._export()

    def _export(self) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.gauge("disk_budget_state").set(
                (), _STATE_CODE[self.state])
            self.metrics.counter("disk_budget_transitions_total").inc(
                (self.state,))
        except KeyError:
            pass

    def status(self) -> dict:
        return {
            "state": self.state,
            "minFreeBytes": self.min_free_bytes,
            "reason": self.reason,
            "checks": self.checks,
            "refusals": self.refusals,
            "degradations": self.degradations,
            "rearms": self.rearms,
        }
