"""The serving plane's Retry-After hint.

The port of ``clamped_retry_after`` from ``kueue_tpu/ha/shedder.py``;
the admission shedder itself (the token bucket and its SLO coupling)
belongs to HA, which the port does not have yet. The front door's 503
on a degraded journal hands out ``clamped_retry_after(1.0)``, as a JAX
engine without a shedder does.
"""

from __future__ import annotations

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
