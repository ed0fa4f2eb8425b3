"""Workload accounting: a trimmed copy of ``kueue_tpu/workload_info.py``.

A ``WorkloadInfo`` wraps a Workload with its resolved ClusterQueue and
its per-PodSet total (count-scaled) requests; once flavors are set on
those, ``usage()`` gives what it counts against quota.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_tpu_torch.api.types import (
    FlavorResource,
    Workload,
    WorkloadConditionType,
)
from kueue_tpu_torch.config import features

_EPSILON = 1e-3  # the one-millisecond nudge past the preemptor


@dataclass
class PodSetResources:
    """Total (count-scaled) requests of one PodSet with its flavors."""

    name: str
    count: int
    requests: dict[str, int] = field(default_factory=dict)
    flavors: dict[str, str] = field(default_factory=dict)  # resource -> flavor

    def scaled_to(self, count: int) -> "PodSetResources":
        if self.count == count or self.count == 0:
            return PodSetResources(self.name, count, dict(self.requests),
                                   dict(self.flavors))
        scaled = {r: (q // self.count) * count
                  for r, q in self.requests.items()}
        return PodSetResources(self.name, count, scaled, dict(self.flavors))


def queue_order_timestamp(wl: Workload) -> float:
    """FIFO timestamp: the eviction time for PodsReady-timeout and
    admission-check evictions; with priority sorting off, preemptees of
    InCohortReclaimWhileBorrowing go just past their preemptor."""
    evicted = wl.condition(WorkloadConditionType.EVICTED)
    if evicted is not None and evicted.status:
        if evicted.reason in ("PodsReadyTimeout", "AdmissionCheck"):
            return evicted.last_transition_time
    if not features.enabled("PrioritySortingWithinCohort"):
        preempted = wl.condition(WorkloadConditionType.PREEMPTED)
        if (preempted is not None and preempted.status
                and preempted.reason == "InCohortReclaimWhileBorrowing"):
            return preempted.last_transition_time + _EPSILON
    return wl.creation_time


@dataclass
class WorkloadInfo:
    obj: Workload
    cluster_queue: str = ""
    total_requests: list[PodSetResources] = field(default_factory=list)

    @classmethod
    def from_workload(cls, wl: Workload,
                      cluster_queue: str = "") -> "WorkloadInfo":
        # Zero-quantity requests are kept: they make the workload
        # ineligible for the dense path (tensor/schema.py).
        info = cls(obj=wl, cluster_queue=cluster_queue)
        info.total_requests = [
            PodSetResources(
                name=ps.name, count=ps.count,
                requests={r: q * ps.count for r, q in ps.requests.items()})
            for ps in wl.pod_sets]
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

    def usage(self) -> dict[FlavorResource, int]:
        """FlavorResource quantities this workload counts against quota."""
        out: dict[FlavorResource, int] = {}
        for psr in self.total_requests:
            for res, qty in psr.requests.items():
                flavor = psr.flavors.get(res)
                if qty == 0 or flavor is None:
                    continue
                fr = FlavorResource(flavor, res)
                out[fr] = out.get(fr, 0) + qty
        return out
