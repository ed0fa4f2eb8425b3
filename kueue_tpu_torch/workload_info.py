"""Workload accounting helpers — the equivalent of the reference's
pkg/workload (workload.Info, usage computation, eviction/admission helpers).

A ``WorkloadInfo`` wraps an api.Workload with its resolved ClusterQueue and
per-PodSet total requests plus (once assigned/admitted) the per-resource
flavor assignment, from which quota usage is derived.
Reference: pkg/workload/workload.go:215 (Info), resources.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import (
    Admission,
    FlavorResource,
    PodSetAssignmentStatus,
    Workload,
)


@dataclass
class PodSetResources:
    """Total (count-scaled) requests of one PodSet with flavor assignment.

    Reference: pkg/workload/workload.go (PodSetResources).
    """

    name: str
    count: int
    requests: dict[str, int] = field(default_factory=dict)  # total, not per-pod
    flavors: dict[str, str] = field(default_factory=dict)  # resource -> flavor

    def scaled_to(self, count: int) -> "PodSetResources":
        if self.count == count or self.count == 0:
            return PodSetResources(self.name, count, dict(self.requests),
                                   dict(self.flavors))
        scaled = {r: (q // self.count) * count for r, q in self.requests.items()}
        return PodSetResources(self.name, count, scaled, dict(self.flavors))

    def single_pod_requests(self) -> dict[str, int]:
        if self.count == 0:
            return {}
        return {r: q // self.count for r, q in self.requests.items()}


@dataclass(frozen=True)
class Ordering:
    """pkg/workload/workload.go (Ordering): which timestamp drives FIFO
    for workloads evicted by the WaitForPodsReady timeout —
    config.EvictionTimestamp (default) or config.CreationTimestamp."""

    pods_ready_requeuing_timestamp: str = "Eviction"


DEFAULT_ORDERING = Ordering()
_EPSILON = 1e-3  # the reference's time.Millisecond nudge


def queue_order_timestamp(wl: Workload,
                          ordering: Ordering = DEFAULT_ORDERING) -> float:
    """workload.go:1087 (Ordering.GetQueueOrderTimestamp): FIFO uses the
    eviction timestamp for PodsReady-timeout and admission-check
    evictions, and — when priority sorting is disabled — nudges
    InCohortReclaimWhileBorrowing preemptees just past their preemptor."""
    from kueue_tpu_torch.api.types import WorkloadConditionType as WCT
    from kueue_tpu_torch.config import features

    evicted = wl.condition(WCT.EVICTED)
    if evicted is not None and evicted.status:
        if (ordering.pods_ready_requeuing_timestamp == "Eviction"
                and evicted.reason == "PodsReadyTimeout"):
            return evicted.last_transition_time
        if evicted.reason == "AdmissionCheck":
            return evicted.last_transition_time
    if not features.enabled("PrioritySortingWithinCohort"):
        preempted = wl.condition(WCT.PREEMPTED)
        if (preempted is not None and preempted.status
                and preempted.reason == "InCohortReclaimWhileBorrowing"):
            return preempted.last_transition_time + _EPSILON
    return wl.creation_time


@dataclass
class WorkloadInfo:
    """Reference: pkg/workload/workload.go:215 (Info)."""

    obj: Workload
    cluster_queue: str = ""
    total_requests: list[PodSetResources] = field(default_factory=list)
    # Flavor-assignment resume state (reference: AssignmentClusterQueueState).
    last_assignment_flavor_idx: Optional[list[dict[str, int]]] = None
    last_assignment_generation: int = -1
    # AdmissionFairSharing: LocalQueue's historical usage, if AFS is on.
    local_queue_fs_usage: Optional[float] = None

    @classmethod
    def from_workload(cls, wl: Workload,
                      cluster_queue: str = "") -> "WorkloadInfo":
        info = cls(obj=wl, cluster_queue=cluster_queue)
        # Zero-quantity requests are KEPT: a zero request for a resource
        # the ClusterQueue covers still receives a flavor assignment
        # (flavorassigner_test.go "zero resource request defined in
        # clusterQueue should get flavor assigned"); zero requests for
        # uncovered resources are skipped at assignment time instead.
        info.total_requests = [
            PodSetResources(
                name=ps.name,
                count=ps.count,
                requests={r: q * ps.count for r, q in ps.requests.items()},
            )
            for ps in wl.pod_sets]
        if wl.status.admission is not None:
            info.apply_admission(wl.status.admission)
        # Reclaimable pods free their share of the quota while the rest of
        # the workload keeps running (workload_types.go:874, applied after
        # admission so the reduction survives count scaling). Gated:
        # kube_features.go ReclaimablePods.
        from kueue_tpu_torch.config import features
        if features.enabled("ReclaimablePods"):
            for psr in info.total_requests:
                reclaimed = wl.status.reclaimable_pods.get(psr.name, 0)
                if reclaimed > 0:
                    scaled = psr.scaled_to(max(psr.count - reclaimed, 0))
                    psr.count = scaled.count
                    psr.requests = scaled.requests
        return info

    @property
    def key(self) -> str:
        return self.obj.key

    def apply_admission(self, admission: Admission) -> None:
        """Sync flavors (and possibly reduced counts) from an Admission."""
        self.cluster_queue = admission.cluster_queue
        by_name = {psa.name: psa for psa in admission.pod_set_assignments}
        for psr in self.total_requests:
            psa = by_name.get(psr.name)
            if psa is None:
                continue
            if psa.count and psa.count != psr.count:
                scaled = psr.scaled_to(psa.count)
                psr.count = scaled.count
                psr.requests = scaled.requests
            psr.flavors = dict(psa.flavors)

    def usage(self) -> dict[FlavorResource, int]:
        """FlavorResource quantities this workload counts against quota.

        Reference: workload.Info.Usage / FlavorResourceUsage.
        """
        out: dict[FlavorResource, int] = {}
        for psr in self.total_requests:
            for res, qty in psr.requests.items():
                if qty == 0:
                    continue
                flavor = psr.flavors.get(res)
                if flavor is None:
                    continue
                fr = FlavorResource(flavor, res)
                out[fr] = out.get(fr, 0) + qty
        return out

    def tas_domains(self, tas_flavor_names) -> list:
        """TAS usage tuples (flavor, values, single_pod_requests, count)
        from the admission's topology assignments
        (workload.Info TASUsage)."""
        adm = self.obj.status.admission
        if adm is None:
            return []
        out = []
        by_name = {psr.name: psr for psr in self.total_requests}
        for psa in adm.pod_set_assignments:
            ta = psa.topology_assignment
            if ta is None:
                continue
            flavor = next((f for f in psa.flavors.values()
                           if f in tas_flavor_names), None)
            if flavor is None:
                continue
            psr = by_name.get(psa.name)
            single = psr.single_pod_requests() if psr else {}
            for dom in ta.domains:
                out.append((flavor, tuple(dom.values), single, dom.count))
        return out

    def uses_any(self, frs: set[FlavorResource]) -> bool:
        """Reference: classical.WorkloadUsesResources
        (candidate_generator.go:54)."""
        for psr in self.total_requests:
            for res, flavor in psr.flavors.items():
                if FlavorResource(flavor, res) in frs:
                    return True
        return False


def namespace_selector_mismatch(selector, labels) -> bool:
    """The CQ namespace-selector match predicate, shared by the
    nomination check (scheduler/cycle.py) and the device bridge's
    per-head demotion so the two can never diverge."""
    if selector is None:
        return False
    labels = labels or {}
    return any(labels.get(k) != v for k, v in selector.items())


def admission_from_assignment(cluster_queue: str, pod_sets) -> Admission:
    """Build an api Admission from scheduler PodSetAssignments."""
    return Admission(
        cluster_queue=cluster_queue,
        pod_set_assignments=tuple(
            PodSetAssignmentStatus(
                name=psa.name,
                flavors={res: getattr(fa, "name", fa)
                         for res, fa in psa.flavors.items()},
                resource_usage=dict(psa.requests),
                count=psa.count,
                topology_assignment=psa.topology_assignment,
            )
            for psa in pod_sets
        ),
    )
