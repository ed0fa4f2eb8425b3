"""Feature gates the port reads, at the defaults of
``kueue_tpu/config/features.py``, with its process-wide overrides
(``set_feature``, ``apply``, ``reset``), so a test can set the same gate
in both packages. Gates no ported path reads are left out; an unknown
gate reads as off."""

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
    # Node failures record status.unhealthyNodes and arm the second
    # pass, which re-places the lost pods (off: the node only stops
    # taking new placements).
    "TASFailedNodeReplacement": True,
    # A failed replacement evicts instead of retrying with backoff.
    "TASFailedNodeReplacementFailFast": False,
    # The node-health controller's triggers beyond node deletion.
    "TASReplaceNodeOnPodTermination": False,
    "TASReplaceNodeOnNodeTaints": False,
    "TASReplaceNodeNotReadyOverFixedTime": False,
    # A single-pod-owned workload keeps its assignment on replacement.
    "SkipReassignmentForPodOwnedWorkloads": True,
    # Elastic workload slices (made by the elastic job integrations of
    # controllers/jobframework.py), and their delta-only TAS placement.
    "ElasticJobsViaWorkloadSlices": False,
    "ElasticJobsViaWorkloadSlicesWithTAS": True,
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
    # DRA: ResourceClaims resolve to quota-space requests through the
    # DeviceClass -> extended-resource mapping (controllers/dra.py).
    "KueueDRAIntegration": True,
    "KueueDRAIntegrationExtendedResource": True,
    # The job path (webhooks/, controllers/jobframework.py and
    # integrations.py): partial admission keeps a pod set's minCount, a
    # Cohort may name a parent, the admission-gated-by annotation is
    # validated, a job naming no queue joins its namespace's "default"
    # LocalQueue, the SparkApplication adapter is managed, and the
    # managed-jobs namespace selector gates jobs that name a queue too.
    "PartialAdmission": True,
    "HierarchicalCohorts": True,
    "AdmissionGatedBy": True,
    "LocalQueueDefaulting": True,
    "SparkApplicationIntegration": True,
    "ManagedJobsNamespaceSelectorAlwaysRespected": True,
    # controllers/podsready.py: an emergency off-switch over
    # waitForPodsReady's enable flag.
    "DisableWaitForPodsReady": False,
    # controllers/failurerecovery.py: node failures reach the recovery
    # controller's Replace and Requeue actions.
    "FailureRecoveryPolicy": True,
    # controllers/multikueue*.py: the subsystem, remote copies behind a
    # closed preemption gate opened one cluster at a time, the manager
    # ClusterQueues' quota summed from the workers', Incremental
    # dispatch rounds (off: AllAtOnce), and ClusterProfile sources.
    "MultiKueue": True,
    "MultiKueueOrchestratedPreemption": False,
    "MultiKueueManagerQuotaAutomation": False,
    "MultiKueueIncrementalDispatcherConfig": True,
    "MultiKueueClusterProfile": False,
}


_overrides: dict[str, bool] = {}


def enabled(name: str) -> bool:
    if name in _overrides:
        return _overrides[name]
    return _DEFAULTS.get(name, False)


def set_feature(name: str, value: bool) -> None:
    _overrides[name] = value


def apply(gates: dict[str, bool]) -> None:
    _overrides.update(gates)


def reset() -> None:
    _overrides.clear()


def all_gates() -> dict[str, bool]:
    out = dict(_DEFAULTS)
    out.update(_overrides)
    return out
