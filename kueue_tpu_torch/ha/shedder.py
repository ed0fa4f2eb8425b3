"""Admission-rate control: a token-bucket front door on the submit
path, with SLO burn rates driving the shed threshold, and the serving
plane's Retry-After hint.

The port of ``kueue_tpu/ha/shedder.py``. The bucket guards the SERVING
layer, not the engine: shed submissions are refused before they ever
become inputs, so a shed request leaves a counter and a fanout event,
never a journal record. The effective refill rate is ``rate * factor``,
where factor degrades as the worst SLO burns (obs/slo.py):

    status OK      → 1.00           (full configured rate)
    status WARN    → 1 / (1+burn)   floored at 0.25
    status BREACH  → ¼ · 1/(1+burn) floored at 0.05

``clamped_retry_after`` is the one Retry-After computation: the 429 of
a shed submit and the 503 of a degraded journal both hand out
``base * uniform(1 - jitter, 1 + jitter)``, never above the cap.
"""

from __future__ import annotations

from typing import Optional

STATUS_OK, STATUS_WARN, STATUS_BREACH = 0, 1, 2

# Ceiling on any Retry-After the serving plane hands out, in seconds.
RETRY_AFTER_MAX = 30.0


def clamped_retry_after(base: float, jitter: float = 0.5, rng=None,
                        cap: float = RETRY_AFTER_MAX) -> float:
    """``base * uniform(1 - jitter, 1 + jitter)``, rounded to ms and
    never above ``cap``: refused clients do not all come back in one
    wave."""
    import random

    j = max(0.0, min(1.0, float(jitter)))
    r = rng if rng is not None else random
    retry = round(max(0.0, base) * r.uniform(1.0 - j, 1.0 + j), 3)
    return min(retry, cap)


class TokenBucket:
    """Plain token bucket; refill is scaled by an external factor so
    the shedder can squeeze it without mutating configuration."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self.tokens = self.burst
        self._last: Optional[float] = None

    def take(self, now: float, n: float = 1.0,
             factor: float = 1.0) -> bool:
        if self._last is None:
            self._last = now
        elapsed = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst,
                          self.tokens + elapsed * self.rate * factor)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionShedder:
    """Decides accept/shed for one submission attempt. Stateless apart
    from the bucket — safe to consult from HTTP handler threads (the
    GIL serializes the float updates; drift under contention only
    mis-sizes the bucket by a token, never corrupts it)."""

    # Backward-compat alias for the module-level clamp (tests and
    # callers configured against the class attribute keep working).
    RETRY_AFTER_MAX = RETRY_AFTER_MAX

    def __init__(self, rate: float = 200.0, burst: Optional[float] = None,
                 slo=None, metrics=None, hub=None,
                 retry_jitter: float = 0.5, rng=None,
                 retry_after_max: Optional[float] = None):
        import random
        self.bucket = TokenBucket(rate, burst)
        self.slo = slo
        self.metrics = metrics
        self.hub = hub
        self.accepted = 0
        self.shed = 0
        self.factor = 1.0
        # Degradation-ladder override (ha/ladder.py): when set, the
        # effective factor is capped at this value regardless of what
        # the SLO coupling computes — the "new submissions" rung
        # squeezing the front door below its own floors (0.0 = shed
        # everything, the disk-degraded posture).
        self.degraded_factor: Optional[float] = None
        # Retry-After jitter: every shed client computing the same
        # deterministic retry delay would re-arrive in one synchronized
        # wave (thundering herd after a failover). Each 429 gets
        # base * uniform(1-j, 1+j) instead — same mean, decorrelated.
        self.retry_jitter = max(0.0, min(1.0, float(retry_jitter)))
        self.retry_after_max = float(
            retry_after_max if retry_after_max is not None
            else self.RETRY_AFTER_MAX)
        self._rng = rng if rng is not None else random.Random()

    def _factor(self) -> float:
        computed = self._slo_factor()
        if self.degraded_factor is not None:
            return min(computed, max(0.0, self.degraded_factor))
        return computed

    def _slo_factor(self) -> float:
        if self.slo is None:
            return 1.0
        try:
            status, burn = self.slo.worst()
        except Exception:  # noqa: BLE001 — SLO eval must not block intake
            return 1.0
        if status >= STATUS_BREACH:
            return max(0.05, 0.25 / (1.0 + burn))
        if status >= STATUS_WARN:
            return max(0.25, 1.0 / (1.0 + burn))
        return 1.0

    def admit(self, now: float, reason: str = "submit") -> dict:
        """Returns {"accepted": bool, "factor": float, "retryAfter": s}."""
        self.factor = self._factor()
        ok = self.bucket.take(now, 1.0, self.factor)
        if self.metrics is not None:
            try:
                self.metrics.gauge("admission_shed_factor").set(
                    (), self.factor)
                if not ok:
                    self.metrics.counter("admission_shed_total").inc(
                        (reason,))
            except KeyError:
                pass
        if ok:
            self.accepted += 1
        else:
            self.shed += 1
            if self.hub is not None:
                import json
                self.hub.publish("admission_shed", json.dumps({
                    "reason": reason, "factor": round(self.factor, 4)}))
        retry = self.retry_after_hint() if not ok else 0.0
        return {"accepted": ok, "factor": self.factor,
                "retryAfter": retry}

    def retry_after_hint(self) -> float:
        """One jittered, clamped Retry-After value for this shedder's
        current posture: base 1/(rate*factor), through the shared
        ``clamped_retry_after`` helper (also used by the front door's
        503 in visibility/http_server.py)."""
        base = 1.0 / max(1e-6, self.bucket.rate * self.factor)
        return clamped_retry_after(base, jitter=self.retry_jitter,
                                   rng=self._rng,
                                   cap=self.retry_after_max)

    def status(self) -> dict:
        return {"accepted": self.accepted, "shed": self.shed,
                "factor": round(self.factor, 4),
                "degradedFactor": self.degraded_factor,
                "rate": self.bucket.rate, "burst": self.bucket.burst,
                "tokens": round(self.bucket.tokens, 3),
                "retryAfterMax": self.retry_after_max}
