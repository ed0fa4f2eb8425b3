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


@dataclass(frozen=True)
class ResourceTransformation:
    """One input-resource mapping applied to effective requests.

    Reference: apis/config/v1beta1/configuration_types.go:560
    (ResourceTransformation) — strategy Retain keeps the input resource
    alongside the outputs, Replace drops it; ``outputs`` maps output
    resource name -> factor multiplied into the input quantity;
    ``multiply_by`` optionally scales the input by another resource's
    quantity first (counter-based DRA resources)."""

    input: str
    outputs: dict[str, float] = field(default_factory=dict)
    strategy: str = "Retain"
    multiply_by: str = ""


@dataclass(frozen=True)
class InfoOptions:
    """Reference: pkg/workload/workload.go:123 (InfoOptions) — the knobs
    that shape effective requests at Info construction time."""

    excluded_resource_prefixes: tuple[str, ...] = ()
    transformations: dict[str, ResourceTransformation] = field(
        default_factory=dict)

    @classmethod
    def from_transform_list(cls, transforms, excluded=()) -> "InfoOptions":
        return cls(excluded_resource_prefixes=tuple(excluded),
                   transformations={t.input: t for t in transforms})


def apply_resource_transformations(
        requests: dict[str, int],
        transforms: dict[str, ResourceTransformation]) -> dict[str, int]:
    """pkg/workload/workload.go:516 applyResourceTransformations."""
    if not transforms or not any(r in transforms for r in requests):
        return requests
    out: dict[str, int] = {}
    for res, qty in requests.items():
        mapping = transforms.get(res)
        if mapping is None:
            out[res] = out.get(res, 0) + qty
            continue
        eff = qty
        if mapping.multiply_by and mapping.multiply_by in requests:
            # The multiplied quantity is what Retain keeps, matching the
            # reference (workload.go:530-546 mutates inputQuantity before
            # both the outputs loop and the Retain branch).
            eff = qty * requests[mapping.multiply_by]
        for out_name, factor in mapping.outputs.items():
            out[out_name] = out.get(out_name, 0) + int(eff * factor)
        if mapping.strategy == "Retain":
            out[res] = out.get(res, 0) + eff
    return out


def drop_excluded_resources(requests: dict[str, int],
                            prefixes: tuple[str, ...]) -> dict[str, int]:
    """pkg/workload/workload.go (dropExcludedResources)."""
    if not prefixes:
        return requests
    return {r: q for r, q in requests.items()
            if not any(r.startswith(p) for p in prefixes)}


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
    def from_workload(cls, wl: Workload, cluster_queue: str = "",
                      options: Optional[InfoOptions] = None) -> "WorkloadInfo":
        info = cls(obj=wl, cluster_queue=cluster_queue)
        # Zero-quantity requests are KEPT: a zero request for a resource
        # the ClusterQueue covers still receives a flavor assignment
        # (flavorassigner_test.go "zero resource request defined in
        # clusterQueue should get flavor assigned"); zero requests for
        # uncovered resources are skipped at assignment time instead.
        # Effective requests: drop excluded prefixes, then resource
        # transformations (workload.go:623-626 totalRequestsFromPodSets).
        info.total_requests = []
        for ps in wl.pod_sets:
            per_pod = ps.requests
            if options is not None:
                per_pod = drop_excluded_resources(
                    per_pod, options.excluded_resource_prefixes)
                per_pod = apply_resource_transformations(
                    per_pod, options.transformations)
            info.total_requests.append(PodSetResources(
                name=ps.name,
                count=ps.count,
                requests={r: q * ps.count for r, q in per_pod.items()},
            ))
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


def adjust_resources(wl: Workload, limit_ranges=None,
                     runtime_class_overheads=None) -> None:
    """The reference's pre-queue request adjustment
    (pkg/workload/resources.go:141 AdjustResources): for every PodSet
    carrying a pod template, resolve RuntimeClass overhead, merge
    LimitRange container defaults, promote limits to missing requests,
    and recompute the PodSet's per-pod ``requests`` with the pod-requests
    aggregation. PodSets without a template are left verbatim."""
    from kueue_tpu_torch.utils import limitrange as lr
    from kueue_tpu_torch.utils import podtemplate as pt

    summary = None
    if limit_ranges:
        in_ns = [r for r in limit_ranges if r.namespace == wl.namespace]
        if in_ns:
            summary = lr.summarize(in_ns)
    for ps in wl.pod_sets:
        template = ps.template
        if template is None:
            continue
        # Pod overhead from RuntimeClass (resources.go:59
        # handlePodOverhead): only when not already set on the template.
        if (template.runtime_class_name and not template.overhead
                and runtime_class_overheads):
            template.overhead = dict(runtime_class_overheads.get(
                template.runtime_class_name, {}))
        if summary is not None:
            lr.apply_defaults(template, summary)
        pt.use_limits_as_missing_requests(template)
        ps.requests = pt.pod_requests(template)


def namespace_selector_mismatch(selector, labels) -> bool:
    """The CQ namespace-selector match predicate, shared by the
    nomination check (scheduler/cycle.py) and the device bridge's
    per-head demotion so the two can never diverge."""
    if selector is None:
        return False
    labels = labels or {}
    return any(labels.get(k) != v for k, v in selector.items())


def validate_admissibility(wl: Workload, limit_ranges=None,
                           namespace_labels=None) -> Optional[str]:
    """pkg/workload/resources.go:233 ValidateAdmissibility:
    requests<=limits, LimitRange bounds. Returns the first failure
    message, or None when admissible. The namespace-selector check runs
    at nomination time (namespace_selector_mismatch)."""
    from kueue_tpu_torch.utils import limitrange as lr
    from kueue_tpu_torch.utils import podtemplate as pt

    summary = None
    if limit_ranges:
        in_ns = [r for r in limit_ranges if r.namespace == wl.namespace]
        if in_ns:
            summary = lr.summarize(in_ns)
    for ps in wl.pod_sets:
        if ps.template is None:
            continue
        errs = pt.validate_requests_under_limits(ps.template)
        if errs:
            return "resources validation failed: " + "; ".join(errs)
        if summary is not None:
            errs = lr.validate_template(ps.template, summary)
            if errs:
                return ("resources didn't satisfy LimitRange constraints: "
                        + "; ".join(errs))
    return None


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
