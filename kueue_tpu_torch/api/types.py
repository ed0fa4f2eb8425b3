"""Core API types for kueue-tpu.

These are the framework's equivalents of the reference CRDs
(`apis/kueue/v1beta2/*_types.go` in the reference tree): Workload,
ClusterQueue, Cohort, LocalQueue, ResourceFlavor, plus the nested config
shapes (ResourceGroup/FlavorQuotas/ResourceQuota, preemption policy,
flavor fungibility, fair sharing).

Design notes (TPU-first rebuild):
  * All quantities are integers in milli-units (the reference uses
    resource.Quantity milli-values; see pkg/resources). ``INF`` stands in
    for "Unlimited"; arithmetic helpers saturate instead of overflowing.
  * These dataclasses are the *control-plane* representation. The decision
    core consumes them via an immutable `Snapshot` (cache/snapshot.py) and,
    on the batched path, via a dense tensor encoding (tensor/schema.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Optional

# Saturating "Unlimited" sentinel (reference: resources.Amount saturation,
# pkg/resources; kept < 2**63 so int64 tensors can carry it).
INF: int = 1 << 61


def sat_add(a: int, b: int) -> int:
    """Saturating addition mirroring resources.Amount.Add: ±INF are
    absorbing (Unlimited ± finite = Unlimited)."""
    if a >= INF or b >= INF:
        return -INF if (a <= -INF or b <= -INF) else INF
    if a <= -INF or b <= -INF:
        return -INF
    s = a + b
    if s >= INF:
        return INF
    if s <= -INF:
        return -INF
    return s


def sat_sub(a: int, b: int) -> int:
    return sat_add(a, -b)


@dataclass(frozen=True, order=True)
class FlavorResource:
    """A (ResourceFlavor, resource name) pair — the quota coordinate.

    Reference: pkg/resources.FlavorResource.

    The hash is cached: quota coordinates key the usage/quota dicts on
    every accounting touch, and the generated dataclass __hash__
    rebuilds a field tuple per call — measurable at serving batch
    sizes.
    """

    flavor: str
    resource: str

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.flavor, self.resource))
            object.__setattr__(self, "_hash", h)
        return h


@dataclass(frozen=True)
class ResourceQuota:
    """Per-(flavor, resource) quota knobs.

    Reference: apis/kueue/v1beta2/clusterqueue_types.go:300 (ResourceQuota):
    nominalQuota, borrowingLimit (None = unlimited borrowing),
    lendingLimit (None = everything lendable).
    """

    nominal: int = 0
    borrowing_limit: Optional[int] = None
    lending_limit: Optional[int] = None


@dataclass(frozen=True)
class FlavorQuotas:
    """Quotas for one flavor over the covered resources of a resource group.

    Reference: apis/kueue/v1beta2/clusterqueue_types.go:283 (FlavorQuotas).
    """

    name: str  # ResourceFlavor reference
    resources: dict[str, ResourceQuota] = field(default_factory=dict)


@dataclass(frozen=True)
class ResourceGroup:
    """A group of resources sharing an ordered flavor list.

    Reference: apis/kueue/v1beta2/clusterqueue_types.go:255 (ResourceGroup).
    Flavor order is the assignment try-order (flavorassigner.go:959).
    """

    covered_resources: tuple[str, ...]
    flavors: tuple[FlavorQuotas, ...]


class QueueingStrategy(str, Enum):
    STRICT_FIFO = "StrictFIFO"
    BEST_EFFORT_FIFO = "BestEffortFIFO"


class PreemptionPolicy(str, Enum):
    """Reference: clusterqueue_types.go:517 (withinClusterQueue /
    reclaimWithinCohort enums)."""

    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"
    LOWER_OR_NEWER_EQUAL_PRIORITY = "LowerOrNewerEqualPriority"
    ANY = "Any"


class BorrowWithinCohortPolicy(str, Enum):
    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"


@dataclass(frozen=True)
class BorrowWithinCohort:
    """Reference: clusterqueue_types.go:573."""

    policy: BorrowWithinCohortPolicy = BorrowWithinCohortPolicy.NEVER
    max_priority_threshold: Optional[int] = None


@dataclass(frozen=True)
class ClusterQueuePreemption:
    """Reference: clusterqueue_types.go:517 (ClusterQueuePreemption)."""

    within_cluster_queue: PreemptionPolicy = PreemptionPolicy.NEVER
    reclaim_within_cohort: PreemptionPolicy = PreemptionPolicy.NEVER
    borrow_within_cohort: Optional[BorrowWithinCohort] = None


class FungibilityPolicy(str, Enum):
    BORROW = "Borrow"
    PREEMPT = "Preempt"
    TRY_NEXT_FLAVOR = "TryNextFlavor"


class FungibilityPreference(str, Enum):
    BORROWING_OVER_PREEMPTION = "BorrowingOverPreemption"
    PREEMPTION_OVER_BORROWING = "PreemptionOverBorrowing"


@dataclass(frozen=True)
class FlavorFungibility:
    """Reference: clusterqueue_types.go:456 (FlavorFungibility)."""

    when_can_borrow: FungibilityPolicy = FungibilityPolicy.BORROW
    when_can_preempt: FungibilityPolicy = FungibilityPolicy.TRY_NEXT_FLAVOR
    preference: Optional[FungibilityPreference] = None


@dataclass(frozen=True)
class FairSharing:
    """Per-CQ/Cohort fair sharing weight (clusterqueue_types.go fairSharing)."""

    weight: float = 1.0


class StopPolicy(str, Enum):
    NONE = "None"
    HOLD = "Hold"
    HOLD_AND_DRAIN = "HoldAndDrain"


@dataclass
class ClusterQueue:
    """Reference: apis/kueue/v1beta2/clusterqueue_types.go:608."""

    name: str
    resource_groups: tuple[ResourceGroup, ...] = ()
    cohort: Optional[str] = None
    # Object metadata (all reference CRDs carry these; sources for
    # custom metric labels, selectors, origin marks).
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    queueing_strategy: QueueingStrategy = QueueingStrategy.BEST_EFFORT_FIFO
    preemption: ClusterQueuePreemption = field(default_factory=ClusterQueuePreemption)
    flavor_fungibility: FlavorFungibility = field(default_factory=FlavorFungibility)
    fair_sharing: Optional[FairSharing] = None
    namespace_selector: Optional[dict[str, str]] = None  # None = match all
    stop_policy: StopPolicy = StopPolicy.NONE
    admission_checks: tuple[str, ...] = ()
    # Per-flavor check scoping (clusterqueue_types.go:166
    # admissionChecksStrategy): check name -> flavors it applies to
    # (empty tuple = all flavors). Mutually exclusive with
    # ``admission_checks`` in the reference; both supported here.
    admission_checks_strategy: dict[str, tuple[str, ...]] = field(
        default_factory=dict)
    # "UsageBasedAdmissionFairSharing" orders within the CQ by LocalQueue
    # usage (clusterqueue_types.go admissionScope).
    admission_scope: Optional[str] = None

    def flavor_resources(self) -> list[FlavorResource]:
        out = []
        for rg in self.resource_groups:
            for fq in rg.flavors:
                for res in fq.resources:
                    out.append(FlavorResource(fq.name, res))
        return out

    def quota_for(self, fr: FlavorResource) -> ResourceQuota:
        for rg in self.resource_groups:
            for fq in rg.flavors:
                if fq.name == fr.flavor and fr.resource in fq.resources:
                    return fq.resources[fr.resource]
        return ResourceQuota()

    @property
    def fair_weight(self) -> float:
        return self.fair_sharing.weight if self.fair_sharing else 1.0


@dataclass
class Cohort:
    """Reference: apis/kueue/v1beta2/cohort_types.go:24 — parent pointer plus
    optional quotas at interior nodes."""

    name: str
    parent: Optional[str] = None
    resource_groups: tuple[ResourceGroup, ...] = ()
    fair_sharing: Optional[FairSharing] = None

    @property
    def fair_weight(self) -> float:
        return self.fair_sharing.weight if self.fair_sharing else 1.0


@dataclass
class LocalQueue:
    """Reference: apis/kueue/v1beta2/localqueue_types.go:33."""

    name: str
    namespace: str = "default"
    cluster_queue: str = ""
    stop_policy: StopPolicy = StopPolicy.NONE
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ResourceFlavor:
    """Reference: apis/kueue/v1beta2/resourceflavor_types.go:52."""

    name: str
    node_labels: dict[str, str] = field(default_factory=dict)
    node_taints: tuple[Taint, ...] = ()
    tolerations: tuple[Toleration, ...] = ()
    topology_name: Optional[str] = None


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | NoExecute | PreferNoSchedule


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists matches all
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass(frozen=True)
class TopologyLevel:
    node_label: str


@dataclass
class Topology:
    """Reference: apis/kueue/v1beta2/topology_types.go:108 — ordered list of
    node-label levels, top (widest) first, e.g. block -> rack -> host."""

    name: str
    levels: tuple[TopologyLevel, ...] = ()


class TopologyMode(str, Enum):
    REQUIRED = "Required"
    PREFERRED = "Preferred"
    UNCONSTRAINED = "Unconstrained"


@dataclass(frozen=True)
class PodSetTopologyRequest:
    """Reference: workload_types.go:165 (PodSetTopologyRequest).

    ``mode=None`` encodes an empty request (no required/preferred/
    unconstrained field set in the Go API); the dataclass default is the
    implied-unconstrained form job adapters produce. ``slice_constraints``
    is the multi-layer list (workload_types.go:248
    PodsetSliceRequiredTopologyConstraints, max 3 layers, outermost
    first); ``slice_level``/``slice_size`` remain the single-layer
    legacy fields (util/tas/tas.go:116 normalizes both forms)."""

    mode: Optional[TopologyMode] = TopologyMode.UNCONSTRAINED
    level: Optional[str] = None  # node label of required/preferred level
    slice_level: Optional[str] = None
    slice_size: Optional[int] = None
    # ((topology_level_label, size), ...) — outermost layer first.
    slice_constraints: tuple = ()
    pod_set_group_name: Optional[str] = None
    pod_index_label: Optional[str] = None  # rank label for the ungater


@dataclass
class PodSet:
    """Reference: workload_types.go:556 (PodSet). ``requests`` are per-pod
    milli-quantities; total request = requests * count.

    When ``template`` is set (a utils.podtemplate.PodTemplate carrying the
    container-level resource stanzas), ``requests`` is derived from it by
    the effective-requests pipeline (overhead + LimitRange defaults +
    limits-as-missing-requests + the pod-requests aggregation;
    pkg/workload/resources.go:141 AdjustResources) at submit time."""

    name: str
    count: int
    requests: dict[str, int] = field(default_factory=dict)
    min_count: Optional[int] = None  # partial admission lower bound
    topology_request: Optional[PodSetTopologyRequest] = None
    node_selector: dict[str, str] = field(default_factory=dict)
    # requiredDuringSchedulingIgnoredDuringExecution node-affinity terms:
    # ORed terms, each a tuple of (key, operator, values) requirements
    # (operator in In|NotIn|Exists|DoesNotExist). The flavor assigner
    # evaluates these against a flavor's nodeLabels with non-flavor keys
    # ignored (flavorassigner.go:1146 flavorSelector).
    node_affinity: tuple[tuple[tuple[str, str, tuple[str, ...]], ...], ...] = ()
    tolerations: tuple[Toleration, ...] = ()
    template: Optional[object] = None  # utils.podtemplate.PodTemplate


class WorkloadConditionType(str, Enum):
    QUOTA_RESERVED = "QuotaReserved"
    ADMITTED = "Admitted"
    EVICTED = "Evicted"
    PREEMPTED = "Preempted"
    FINISHED = "Finished"
    PODS_READY = "PodsReady"
    REQUEUED = "Requeued"
    # The workload needed to preempt but a closed preemption gate blocked
    # it (workload_types.go:933) — the orchestrated-preemption signal
    # MultiKueue/ConcurrentAdmission coordinators act on.
    BLOCKED_ON_PREEMPTION_GATES = "BlockedOnPreemptionGates"


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass(frozen=True)
class PodSetAssignmentStatus:
    """Reference: workload_types.go:289 (PodSetAssignment in status)."""

    name: str
    flavors: dict[str, str] = field(default_factory=dict)  # resource -> flavor
    resource_usage: dict[str, int] = field(default_factory=dict)
    count: int = 0
    topology_assignment: Optional[object] = None  # tas.TopologyAssignment


@dataclass(frozen=True)
class Admission:
    """Reference: workload_types.go:267."""

    cluster_queue: str
    pod_set_assignments: tuple[PodSetAssignmentStatus, ...] = ()


@dataclass
class WorkloadStatus:
    conditions: dict[str, Condition] = field(default_factory=dict)
    admission: Optional[Admission] = None
    requeue_count: int = 0
    requeue_at: Optional[float] = None
    admission_check_states: dict[str, str] = field(default_factory=dict)
    # Additive per-PodSet modifications suggested by admission checks
    # (workload_types.go:845 PodSetUpdate), merged into the job's pod
    # sets at start; check name -> tuple of PodSetUpdate.
    admission_check_updates: dict[str, tuple] = field(default_factory=dict)
    # Backoff the next requeue should honor when a check flips to Retry
    # (UpdateAdmissionCheckRequeueState, provisioning/controller.go:576).
    check_retry_after_seconds: float = 0.0
    # TAS node replacement (workload_types.go:766): names of failed nodes
    # whose domains need re-placement (tas/node_controller.go).
    unhealthy_nodes: tuple[str, ...] = ()
    # Pods no longer needed per pod set (workload_types.go:874
    # reclaimablePods): frees their quota while the workload runs.
    reclaimable_pods: dict[str, int] = field(default_factory=dict)
    # Preemption gate positions (workload_types.go:909
    # PreemptionGateState): gate name -> open-transition time. A gate
    # named in spec but absent here is Closed.
    open_preemption_gates: dict[str, float] = field(default_factory=dict)
    # Eviction counts by reason (workload_types.go:728 schedulingStats).
    eviction_counts: dict[str, int] = field(default_factory=dict)
    # Execution time already consumed across past admissions
    # (workload_types.go accumulatedPastExecutionTimeSeconds) — the
    # maximum-execution-time budget spans evict/requeue cycles.
    accumulated_past_execution_time_seconds: float = 0.0
    # Effective per-PodSet total requests at consideration time
    # (workload_types.go:886 PodSetRequest — post LimitRange/transforms).
    resource_requests: dict[str, dict[str, int]] = field(
        default_factory=dict)
    # MultiKueue placement (workload_types.go status):
    nominated_cluster_names: tuple[str, ...] = ()
    cluster_name: Optional[str] = None


_uid_counter = itertools.count(1)

# How many times a Workload in this process was given a maximum
# execution time (a count that only grows): while it is 0 no workload
# can exceed a budget, and Engine.tick skips its scan of every admitted
# workload (the serve loop's tick over 50,000 of them).
_budgets_given = 0


def budgets_given() -> int:
    return _budgets_given


class _ExecutionBudget:
    """``Workload.maximum_execution_time_seconds``: a field like any other
    (None by default, kept in the instance's ``__dict__`` under its own
    name) whose setter counts every value but None in ``_budgets_given``;
    ``__init__``, ``dataclasses.replace`` and assignments all set it."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return None  # the field's default
        return obj.__dict__[self.name]

    def __set__(self, obj, value):
        if value is not None:
            global _budgets_given
            _budgets_given += 1
        obj.__dict__[self.name] = value


# cmd/experimental/kueue-priority-booster; constants.go:87.
PRIORITY_BOOST_ANNOTATION = "kueue.x-k8s.io/priority-boost"


@dataclass
class Workload:
    """Reference: apis/kueue/v1beta2/workload_types.go:1197.

    ``priority`` is the resolved WorkloadPriorityClass/PriorityClass value
    (reference resolves it via priorityClassRef; we carry the value).
    """

    name: str
    namespace: str = "default"
    queue_name: str = ""  # LocalQueue name
    pod_sets: tuple[PodSet, ...] = ()
    priority: int = 0
    priority_class_name: Optional[str] = None  # WorkloadPriorityClass ref
    priority_boost: int = 0  # priority-booster annotation equivalent
    creation_time: float = 0.0
    active: bool = True
    maximum_execution_time_seconds: Optional[int] = _ExecutionBudget()
    # Elastic scale-up: key of the admitted slice this workload replaces
    # (pkg/workloadslicing annotation equivalent).
    replaced_workload_slice: Optional[str] = None
    # Gates that must be Open before this workload may preempt others
    # (workload_types.go:86 preemptionGates).
    preemption_gates: tuple[str, ...] = ()
    # Concurrent-admission variant pin: only this ResourceFlavor may be
    # assigned (WorkloadAllowedResourceFlavorAnnotation).
    allowed_resource_flavor: Optional[str] = None
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    # ((api_version, kind, name, uid), ...) — metav1.OwnerReference
    # essentials; drives workload.OwnedBySinglePod (workload.go:1309).
    owner_references: tuple = ()
    uid: str = ""
    status: WorkloadStatus = field(default_factory=WorkloadStatus)

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"uid-{next(_uid_counter):08d}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def effective_priority(self) -> int:
        """priority.EffectivePriority: base + boost. The boost comes from
        the priority-booster's annotation when present (invalid values
        default to zero, pkg/util/priority); the in-process booster may
        also set the field directly."""
        ann = self.annotations.get(PRIORITY_BOOST_ANNOTATION)
        if ann is not None:
            try:
                boost = int(ann)
            except ValueError:
                boost = 0
            # The in-process booster writes BOTH the field and the
            # annotation; an out-of-band annotation alone must not mask a
            # later booster decision, so the stronger signal wins.
            return self.priority + (self.priority_boost
                                    if self.priority_boost != 0 else boost)
        return self.priority + self.priority_boost

    # -- condition helpers (pkg/workload helpers in the reference) --

    def condition(self, ctype: str) -> Optional[Condition]:
        return self.status.conditions.get(ctype)

    def has_condition(self, ctype: str) -> bool:
        c = self.status.conditions.get(ctype)
        return c is not None and c.status

    # -- preemption gates (workload.go:964-979) --

    def has_closed_preemption_gate(self) -> bool:
        return any(g not in self.status.open_preemption_gates
                   for g in self.preemption_gates)

    def open_preemption_gate(self, name: str, now: float = 0.0) -> None:
        """workload.OpenPreemptionGate: flip the gate's position."""
        self.status.open_preemption_gates[name] = now

    def ensure_preemption_gate(self, name: str) -> None:
        """workload.EnsurePreemptionGateOnSpec."""
        if name not in self.preemption_gates:
            self.preemption_gates = self.preemption_gates + (name,)

    def set_condition(self, ctype: str, status: bool, reason: str = "",
                      message: str = "", now: float = 0.0) -> None:
        prev = self.status.conditions.get(ctype)
        ltt = now if (prev is None or prev.status != status) else prev.last_transition_time
        self.status.conditions[ctype] = Condition(
            type=ctype, status=status, reason=reason, message=message,
            last_transition_time=ltt)

    @property
    def has_quota_reservation(self) -> bool:
        return self.has_condition(WorkloadConditionType.QUOTA_RESERVED)

    @property
    def is_admitted(self) -> bool:
        return self.has_condition(WorkloadConditionType.ADMITTED)

    @property
    def is_evicted(self) -> bool:
        return self.has_condition(WorkloadConditionType.EVICTED)

    @property
    def is_finished(self) -> bool:
        return self.has_condition(WorkloadConditionType.FINISHED)

    def quota_reservation_time(self, now: float) -> float:
        c = self.status.conditions.get(WorkloadConditionType.QUOTA_RESERVED)
        if c is None or not c.status:
            return now
        return c.last_transition_time

    def can_be_partially_admitted(self) -> bool:
        return any(ps.min_count is not None and ps.min_count < ps.count
                   for ps in self.pod_sets)

    def total_requests(self) -> list[dict[str, int]]:
        """Per-podset total (count-scaled) requests."""
        return [{r: q * ps.count for r, q in ps.requests.items()}
                for ps in self.pod_sets]


@dataclass
class WorkloadPriorityClass:
    """Reference: workloadpriorityclass_types.go."""

    name: str
    value: int


__all__ = [
    "INF", "sat_add", "sat_sub",
    "FlavorResource", "ResourceQuota", "FlavorQuotas", "ResourceGroup",
    "QueueingStrategy", "PreemptionPolicy", "BorrowWithinCohortPolicy",
    "BorrowWithinCohort", "ClusterQueuePreemption", "FungibilityPolicy",
    "FungibilityPreference", "FlavorFungibility", "FairSharing", "StopPolicy",
    "ClusterQueue", "Cohort", "LocalQueue", "ResourceFlavor", "Taint",
    "Toleration", "Topology", "TopologyLevel", "TopologyMode",
    "PodSetTopologyRequest", "PodSet", "WorkloadConditionType", "Condition",
    "PodSetAssignmentStatus", "Admission", "WorkloadStatus", "Workload",
    "WorkloadPriorityClass", "replace",
]
