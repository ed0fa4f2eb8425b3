"""Oracle supervisor: structured degradation for executor faults
instead of an unstructured crash.

A copy of ``kueue_tpu/oracle/supervisor.py``; the state machine, its
jitter and its counters are the JAX package's, transition for
transition. The bridge hands it the engine's registry (``metrics``):
``oracle_breaker_state``, ``oracle_breaker_transitions_total`` and
``oracle_retry_total`` are written where the JAX package writes them.

Three layers, all decision-neutral (they decide WHERE a cycle is
decided, never WHAT it decides: the host path and the device path
decide the same):

  * **retry with backoff + jitter**: an executor call (cycle_step /
    classical_targets) that raises RemoteOracleError is retried up to
    ``max_attempts`` times, sleeping
    ``jitter * min(cap, base * 2^attempt)`` between attempts. The jitter
    fraction is deterministic (a CRC over the call site and attempt
    ordinal, not a PRNG), so replays stay bit-stable while a fleet of
    engines still decorrelates.
  * **circuit breaker**: after ``threshold`` consecutive failed calls
    the breaker OPENS: try_cycle is refused up front (fallback reason
    ``breaker-open``) and every cycle runs the host decision path,
    which burns no retry time and no socket timeouts.
  * **probing re-promotion**: after ``cooldown_cycles`` engine cycles
    the breaker goes HALF-OPEN: one cycle probes the device. Success
    closes the breaker; failure re-opens it with the cooldown doubled
    (capped at 8x).

Cooldown is measured in engine cycles, not wall time, so the state
machine is a deterministic function of the fault sequence.
"""

from __future__ import annotations

import time
import zlib
from typing import Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
_STATE_CODE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


def _jitter01(*parts) -> float:
    """Deterministic uniform-ish fraction in [0, 1): CRC-32 of the
    call coordinates. Not a PRNG on purpose — no hidden state, no
    draw-order coupling, digest-neutral by construction."""
    raw = zlib.crc32(":".join(str(p) for p in parts).encode("utf-8"))
    return (raw & 0xFFFFFFFF) / 4294967296.0


class OracleSupervisor:
    """Owns retry + breaker state for one OracleBridge."""

    def __init__(self, metrics=None, salt: str = "",
                 max_attempts: int = 3,
                 backoff_base: float = 0.02,
                 backoff_cap: float = 1.0,
                 threshold: int = 3,
                 cooldown_cycles: int = 8,
                 sleep=time.sleep):
        self.metrics = metrics
        self.salt = salt
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.threshold = max(1, int(threshold))
        self.cooldown_cycles = max(1, int(cooldown_cycles))
        self._sleep = sleep
        self.state = CLOSED
        self.consecutive_failures = 0
        self.total_retries = 0
        self.total_failures = 0
        self.demotions = 0
        self.repromotions = 0
        self._cooldown = self.cooldown_cycles
        self._reopen_at: Optional[int] = None  # cycle seq gating probe
        self._export_state()

    # -- the retry wrapper --

    def call(self, site: str, fn, *args, **kwargs):
        """Run one executor call with retry+backoff. Raises the final
        RemoteOracleError after ``max_attempts`` tries (the breaker
        bookkeeping happens in record_failure, called by the bridge's
        error path so non-transport errors count too)."""
        from kueue_tpu_torch.oracle.service import RemoteOracleError

        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except RemoteOracleError:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                self.total_retries += 1
                self._count("oracle_retry_total", (site,))
                delay = _jitter01(self.salt, site, self.total_retries,
                                  attempt) * min(
                    self.backoff_cap,
                    self.backoff_base * (2.0 ** attempt))
                if delay > 0:
                    self._sleep(delay)

    # -- the breaker --

    def allow_cycle(self, seq: int) -> bool:
        """Gate at the top of try_cycle. False = stay demoted (host
        path); True from OPEN means this cycle is the half-open
        probe."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._reopen_at is not None and seq >= self._reopen_at:
                self._transition(HALF_OPEN, "probe window")
                return True
            return False
        return True  # HALF_OPEN: the probe cycle itself

    def record_success(self) -> None:
        """An executor call answered: the device is back."""
        self.consecutive_failures = 0
        if self.state != CLOSED:
            self.repromotions += 1
            self._cooldown = self.cooldown_cycles
            self._transition(CLOSED, "probe succeeded")

    def record_failure(self, seq: int) -> None:
        """A call exhausted its retries (or the cycle died on a device
        fault). In HALF_OPEN the failed probe re-opens with the
        cooldown doubled; in CLOSED ``threshold`` consecutive failures
        demote to the host path."""
        self.consecutive_failures += 1
        self.total_failures += 1
        if self.state == HALF_OPEN:
            self._cooldown = min(self._cooldown * 2,
                                 self.cooldown_cycles * 8)
            self.demotions += 1
            self._reopen_at = seq + self._cooldown
            self._transition(OPEN, "probe failed")
        elif (self.state == CLOSED
              and self.consecutive_failures >= self.threshold):
            self.demotions += 1
            self._reopen_at = seq + self._cooldown
            self._transition(OPEN,
                             f"{self.consecutive_failures} consecutive "
                             f"failures")

    def demote(self, seq: int, reason: str = "external demotion") -> None:
        """Force the breaker OPEN from outside its own failure
        accounting. Probing re-promotion is unchanged: after the
        cooldown a half-open probe re-closes on success. Already-OPEN
        just extends the probe window (no double-counted demotion)."""
        if self.state == OPEN:
            self._reopen_at = max(self._reopen_at or 0,
                                  seq + self._cooldown)
            return
        self.demotions += 1
        self._reopen_at = seq + self._cooldown
        self._transition(OPEN, reason)

    def _transition(self, to: str, reason: str) -> None:
        if to == self.state:
            return
        self._count("oracle_breaker_transitions_total",
                    (self.state, to))
        self.state = to
        self._export_state()

    # -- observability --

    def _export_state(self) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.gauge("oracle_breaker_state").set(
                (), _STATE_CODE[self.state])
        except KeyError:
            pass

    def _count(self, family: str, labels: tuple) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.counter(family).inc(labels)
        except KeyError:
            pass

    def status(self) -> dict:
        return {
            "state": self.state,
            "consecutiveFailures": self.consecutive_failures,
            "totalRetries": self.total_retries,
            "totalFailures": self.total_failures,
            "demotions": self.demotions,
            "repromotions": self.repromotions,
            "cooldownCycles": self._cooldown,
            "reopenAt": self._reopen_at,
        }
