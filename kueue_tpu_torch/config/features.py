"""Feature gates the port reads, at their default values.

The port has no gate overrides yet: each gate below reads as in
``kueue_tpu/config/features.py`` with no override applied."""

from __future__ import annotations

_DEFAULTS: dict[str, bool] = {
    # FIFO timestamp of workloads preempted while their CQ borrowed.
    "PrioritySortingWithinCohort": True,
    # NoFit heads park their pending twins of the same shape with them.
    "SchedulingEquivalenceHashing": True,
    # Reclaimable pods free their share of quota.
    "ReclaimablePods": True,
    # TAS placement solved by the device program (ops/tas.tas_place).
    "DeviceTAS": True,
    # Balanced placement for preferred TAS requests (host-only).
    "TASBalancedPlacement": False,
    # Multi-layer slice constraints beyond the outermost layer.
    "TASMultiLayerTopology": True,
    # Unconstrained TAS placements use the LeastFreeCapacity ordering.
    "TASProfileMixed": True,
    # On-demand pending positions (GET .../pendingworkloads).
    "VisibilityOnDemand": True,
    # The per-reason unadmitted_workloads gauge families.
    "UnadmittedWorkloadsObservability": True,
    # Every per-LocalQueue series family, event-time and sync-time.
    "LocalQueueMetrics": True,
    # The cohort gauge families of sync_resource_metrics.
    "MetricsForCohorts": True,
    # Extra metric labels from ClusterQueue metadata.
    "CustomMetricLabels": True,
}


def enabled(name: str) -> bool:
    return _DEFAULTS.get(name, False)
