"""The admitted-world snapshot, trimmed from ``kueue_tpu/cache/snapshot.py``.

Holds the cohort forest with per-node quotas, subtree quotas and usage,
which ``tensor/schema.encode_snapshot`` flattens into dense arrays. The
quota queries (available, potential, DRS) live on the device side
(``ops/quota.py``); this copy keeps only the bottom-up accumulation:
  * SubtreeQuota[n] = nominal[n] + sum_children (SubtreeQuota[c] -
    localQuota[c]), localQuota = max(0, SubtreeQuota - lendingLimit)
    when a lending limit is set, else 0;
  * cohort Usage = sum_children max(0, Usage[c] - localQuota[c]);
  * addUsage bubbles to the parent only the part beyond the node's
    local available.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    FlavorResource,
    ResourceFlavor,
    ResourceQuota,
    sat_add,
    sat_sub,
)
from kueue_tpu_torch.workload_info import WorkloadInfo


@dataclass
class ResourceNode:
    quotas: dict[FlavorResource, ResourceQuota] = field(default_factory=dict)
    subtree_quota: dict[FlavorResource, int] = field(default_factory=dict)
    usage: dict[FlavorResource, int] = field(default_factory=dict)

    def local_quota(self, fr: FlavorResource) -> int:
        """Capacity invisible to the parent."""
        q = self.quotas.get(fr)
        if q is not None and q.lending_limit is not None:
            return max(0, sat_sub(self.subtree_quota.get(fr, 0),
                                  q.lending_limit))
        return 0


class _Node:
    """Shared behavior of ClusterQueueSnapshot and CohortSnapshot."""

    name: str
    node: ResourceNode
    parent: Optional["CohortSnapshot"]
    fair_weight: float

    def local_available(self, fr: FlavorResource) -> int:
        r = self.node
        return max(0, sat_sub(r.local_quota(fr), r.usage.get(fr, 0)))

    def add_usage_fr(self, fr: FlavorResource, val: int) -> None:
        local_avail = self.local_available(fr)
        self.node.usage[fr] = sat_add(self.node.usage.get(fr, 0), val)
        if self.parent is not None and val > local_avail:
            self.parent.add_usage_fr(fr, sat_sub(val, local_avail))


class CohortSnapshot(_Node):
    def __init__(self, name: str, fair_weight: float = 1.0):
        self.name = name
        self.node = ResourceNode()
        self.parent: Optional[CohortSnapshot] = None
        self.fair_weight = fair_weight
        self.child_cohorts: list[CohortSnapshot] = []
        self.child_cqs: list[ClusterQueueSnapshot] = []

    def height(self) -> int:
        """1 for a cohort with only ClusterQueue children; one more than
        its tallest child cohort otherwise."""
        h = min(len(self.child_cohorts) + len(self.child_cqs), 1)
        for c in self.child_cohorts:
            h = max(h, c.height() + 1)
        return h


class ClusterQueueSnapshot(_Node):
    def __init__(self, cq: ClusterQueue):
        self.name = cq.name
        self.spec = cq
        self.node = ResourceNode()
        self.parent = None
        self.fair_weight = cq.fair_weight
        self.fair_sharing_enabled = cq.fair_sharing is not None
        for fr in cq.flavor_resources():
            self.node.quotas[fr] = cq.quota_for(fr)


class Snapshot:
    def __init__(self) -> None:
        self.cluster_queues: dict[str, ClusterQueueSnapshot] = {}
        self.cohorts: dict[str, CohortSnapshot] = {}
        self.resource_flavors: dict[str, ResourceFlavor] = {}

    def add_workload(self, info: WorkloadInfo) -> None:
        cq = self.cluster_queues[info.cluster_queue]
        for fr, q in info.usage().items():
            cq.add_usage_fr(fr, q)


def build_snapshot(
    cluster_queues: list[ClusterQueue],
    cohorts: list[Cohort],
    resource_flavors: list[ResourceFlavor],
    admitted_workloads: Optional[list[WorkloadInfo]],
) -> Snapshot:
    """Assemble a Snapshot, run the bottom-up subtree accumulation, then
    replay every admitted workload's usage."""
    snap = Snapshot()
    snap.resource_flavors = {f.name: f for f in resource_flavors}

    for co in cohorts:
        cs = CohortSnapshot(co.name, co.fair_weight)
        for rg in co.resource_groups:
            for fq in rg.flavors:
                for res, quota in fq.resources.items():
                    cs.node.quotas[FlavorResource(fq.name, res)] = quota
        snap.cohorts[co.name] = cs
    # Implicit cohorts: referenced by a CQ or a cohort parent but not defined.
    for cq in cluster_queues:
        if cq.cohort and cq.cohort not in snap.cohorts:
            snap.cohorts[cq.cohort] = CohortSnapshot(cq.cohort)
    for co in cohorts:
        if co.parent:
            if co.parent not in snap.cohorts:
                snap.cohorts[co.parent] = CohortSnapshot(co.parent)
            child = snap.cohorts[co.name]
            child.parent = snap.cohorts[co.parent]
            snap.cohorts[co.parent].child_cohorts.append(child)

    for cq in cluster_queues:
        cqs = ClusterQueueSnapshot(cq)
        snap.cluster_queues[cq.name] = cqs
        if cq.cohort:
            cqs.parent = snap.cohorts[cq.cohort]
            snap.cohorts[cq.cohort].child_cqs.append(cqs)

    for cs in snap.cohorts.values():
        if cs.parent is None:
            _update_cohort_resource_node(cs)
    for cqs in snap.cluster_queues.values():
        if cqs.parent is None:
            _update_cq_resource_node(cqs)

    for info in admitted_workloads or ():
        snap.add_workload(info)
    return snap


def _update_cq_resource_node(cq: ClusterQueueSnapshot) -> None:
    cq.node.subtree_quota = {fr: q.nominal
                             for fr, q in cq.node.quotas.items()}


def _update_cohort_resource_node(cohort: CohortSnapshot) -> None:
    cohort.node.subtree_quota = {
        fr: q.nominal for fr, q in cohort.node.quotas.items()}
    cohort.node.usage = {}
    for child in cohort.child_cohorts:
        _update_cohort_resource_node(child)
        _accumulate_from_child(cohort, child)
    for child_cq in cohort.child_cqs:
        _update_cq_resource_node(child_cq)
        _accumulate_from_child(cohort, child_cq)


def _accumulate_from_child(parent: CohortSnapshot, child: _Node) -> None:
    for fr, child_quota in child.node.subtree_quota.items():
        delta = sat_sub(child_quota, child.node.local_quota(fr))
        parent.node.subtree_quota[fr] = sat_add(
            parent.node.subtree_quota.get(fr, 0), delta)
    for fr, child_usage in child.node.usage.items():
        delta = max(0, sat_sub(child_usage, child.node.local_quota(fr)))
        parent.node.usage[fr] = sat_add(parent.node.usage.get(fr, 0), delta)
