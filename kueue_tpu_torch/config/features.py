"""Feature gates the port reads, at their default values.

The port has no gate overrides yet: each gate below reads as in
``kueue_tpu/config/features.py`` with no override applied."""

from __future__ import annotations

_DEFAULTS: dict[str, bool] = {
    # FIFO timestamp of workloads preempted while their CQ borrowed.
    "PrioritySortingWithinCohort": True,
    # Reclaimable pods free their share of quota.
    "ReclaimablePods": True,
}


def enabled(name: str) -> bool:
    return _DEFAULTS.get(name, False)
