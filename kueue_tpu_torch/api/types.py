"""Core API types, trimmed to what the batched drain reads.

A copy of the shapes in ``kueue_tpu/api/types.py`` (field names,
defaults and enum values unchanged) without the parts no port module
reads yet: the admission record, MultiKueue fields. All quantities are
integers in milli-units; ``INF`` stands in for "Unlimited" and the
helpers saturate.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

# Saturating "Unlimited" sentinel, kept < 2**63 so int64 tensors carry it.
INF: int = 1 << 61


def sat_add(a: int, b: int) -> int:
    """Saturating addition: ±INF are absorbing."""
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
    """A (ResourceFlavor, resource name) pair: the quota coordinate."""

    flavor: str
    resource: str


@dataclass(frozen=True)
class ResourceQuota:
    """nominalQuota, borrowingLimit (None = unlimited borrowing),
    lendingLimit (None = everything lendable)."""

    nominal: int = 0
    borrowing_limit: Optional[int] = None
    lending_limit: Optional[int] = None


@dataclass(frozen=True)
class FlavorQuotas:
    name: str  # ResourceFlavor reference
    resources: dict[str, ResourceQuota] = field(default_factory=dict)


@dataclass(frozen=True)
class ResourceGroup:
    """Resources sharing an ordered flavor list (the try-order)."""

    covered_resources: tuple[str, ...]
    flavors: tuple[FlavorQuotas, ...]


class QueueingStrategy(str, Enum):
    STRICT_FIFO = "StrictFIFO"
    BEST_EFFORT_FIFO = "BestEffortFIFO"


class PreemptionPolicy(str, Enum):
    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"
    LOWER_OR_NEWER_EQUAL_PRIORITY = "LowerOrNewerEqualPriority"
    ANY = "Any"


class BorrowWithinCohortPolicy(str, Enum):
    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"


@dataclass(frozen=True)
class BorrowWithinCohort:
    policy: BorrowWithinCohortPolicy = BorrowWithinCohortPolicy.NEVER
    max_priority_threshold: Optional[int] = None


@dataclass(frozen=True)
class ClusterQueuePreemption:
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
    when_can_borrow: FungibilityPolicy = FungibilityPolicy.BORROW
    when_can_preempt: FungibilityPolicy = FungibilityPolicy.TRY_NEXT_FLAVOR
    preference: Optional[FungibilityPreference] = None


@dataclass(frozen=True)
class FairSharing:
    weight: float = 1.0


@dataclass
class ClusterQueue:
    name: str
    resource_groups: tuple[ResourceGroup, ...] = ()
    cohort: Optional[str] = None
    queueing_strategy: QueueingStrategy = QueueingStrategy.BEST_EFFORT_FIFO
    preemption: ClusterQueuePreemption = field(
        default_factory=ClusterQueuePreemption)
    flavor_fungibility: FlavorFungibility = field(
        default_factory=FlavorFungibility)
    fair_sharing: Optional[FairSharing] = None

    def flavor_resources(self) -> list[FlavorResource]:
        return [FlavorResource(fq.name, res)
                for rg in self.resource_groups
                for fq in rg.flavors
                for res in fq.resources]

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
    name: str
    parent: Optional[str] = None
    resource_groups: tuple[ResourceGroup, ...] = ()
    fair_sharing: Optional[FairSharing] = None

    @property
    def fair_weight(self) -> float:
        return self.fair_sharing.weight if self.fair_sharing else 1.0


@dataclass
class LocalQueue:
    name: str
    namespace: str = "default"
    cluster_queue: str = ""


@dataclass
class ResourceFlavor:
    name: str


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
    """Ordered list of node-label levels, top (widest) first, e.g. block
    -> rack -> host."""

    name: str
    levels: tuple[TopologyLevel, ...] = ()


class TopologyMode(str, Enum):
    REQUIRED = "Required"
    PREFERRED = "Preferred"
    UNCONSTRAINED = "Unconstrained"


@dataclass(frozen=True)
class PodSetTopologyRequest:
    """``mode=None`` encodes an empty request; the default is the
    implied-unconstrained form. ``slice_constraints`` is the multi-layer
    list ((level_label, size), ...), outermost first;
    ``slice_level``/``slice_size`` are the single-layer fields."""

    mode: Optional[TopologyMode] = TopologyMode.UNCONSTRAINED
    level: Optional[str] = None  # node label of required/preferred level
    slice_level: Optional[str] = None
    slice_size: Optional[int] = None
    slice_constraints: tuple = ()
    pod_set_group_name: Optional[str] = None
    pod_index_label: Optional[str] = None  # rank label for the ungater


@dataclass
class PodSet:
    """``requests`` are per-pod milli-quantities; total = requests *
    count. Node selectors, affinity and tolerations only make a pod set
    ineligible for the dense drain path (the port has no flavor masks);
    TAS placement matches them against node labels and taints."""

    name: str
    count: int
    requests: dict[str, int] = field(default_factory=dict)
    min_count: Optional[int] = None  # partial admission lower bound
    topology_request: Optional[PodSetTopologyRequest] = None
    node_selector: dict[str, str] = field(default_factory=dict)
    # ORed terms, each a tuple of (key, operator, values) requirements.
    node_affinity: tuple = ()
    tolerations: tuple[Toleration, ...] = ()


class WorkloadConditionType(str, Enum):
    QUOTA_RESERVED = "QuotaReserved"
    ADMITTED = "Admitted"
    EVICTED = "Evicted"
    PREEMPTED = "Preempted"
    FINISHED = "Finished"
    PODS_READY = "PodsReady"
    REQUEUED = "Requeued"
    BLOCKED_ON_PREEMPTION_GATES = "BlockedOnPreemptionGates"


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class WorkloadStatus:
    conditions: dict[str, Condition] = field(default_factory=dict)
    # Pods no longer needed per pod set: frees their quota.
    reclaimable_pods: dict[str, int] = field(default_factory=dict)
    # Preemption gate name -> open-transition time; absent = Closed.
    open_preemption_gates: dict[str, float] = field(default_factory=dict)


PRIORITY_BOOST_ANNOTATION = "kueue.x-k8s.io/priority-boost"

_uid_counter = itertools.count(1)


@dataclass
class Workload:
    name: str
    namespace: str = "default"
    queue_name: str = ""  # LocalQueue name
    pod_sets: tuple[PodSet, ...] = ()
    priority: int = 0
    priority_boost: int = 0
    creation_time: float = 0.0
    # Elastic scale-up: key of the admitted slice this workload replaces.
    replaced_workload_slice: Optional[str] = None
    preemption_gates: tuple[str, ...] = ()
    allowed_resource_flavor: Optional[str] = None
    annotations: dict[str, str] = field(default_factory=dict)
    # Ties in the preemption-candidate order break on the uid; an empty
    # one takes the next of a process-wide counter.
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
        """Base priority plus boost; the booster's annotation counts
        when the field itself is unset (invalid values count as 0)."""
        ann = self.annotations.get(PRIORITY_BOOST_ANNOTATION)
        if ann is not None:
            try:
                boost = int(ann)
            except ValueError:
                boost = 0
            return self.priority + (self.priority_boost
                                    if self.priority_boost != 0 else boost)
        return self.priority + self.priority_boost

    def condition(self, ctype: str) -> Optional[Condition]:
        return self.status.conditions.get(ctype)

    def has_condition(self, ctype: str) -> bool:
        c = self.status.conditions.get(ctype)
        return c is not None and c.status

    def has_closed_preemption_gate(self) -> bool:
        return any(g not in self.status.open_preemption_gates
                   for g in self.preemption_gates)

    @property
    def has_quota_reservation(self) -> bool:
        return self.has_condition(WorkloadConditionType.QUOTA_RESERVED)

    @property
    def is_evicted(self) -> bool:
        return self.has_condition(WorkloadConditionType.EVICTED)

    def quota_reservation_time(self, now: float) -> float:
        """When the quota reservation became true; ``now`` when there is
        none."""
        c = self.status.conditions.get(WorkloadConditionType.QUOTA_RESERVED)
        if c is None or not c.status:
            return now
        return c.last_transition_time
