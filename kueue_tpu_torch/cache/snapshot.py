"""The admitted-world snapshot: hierarchical quota math over the cohort tree.

This is the sequential (correctness-oracle) implementation of the reference's
snapshot layer:
  * resource-node math — pkg/cache/scheduler/resource_node.go
  * ClusterQueueSnapshot — pkg/cache/scheduler/clusterqueue_snapshot.go
  * CohortSnapshot + Snapshot — pkg/cache/scheduler/{cohort_snapshot,snapshot}.go
  * DRS (dominant resource share) — pkg/cache/scheduler/fair_sharing.go

The batched TPU path (kueue_tpu/ops) encodes the same state as dense arrays
and must produce identical numbers; tests/test_quota_parity.py checks that.

Semantics captured :
  * SubtreeQuota[n] = nominal[n] + sum_children min(SubtreeQuota[c], lend_c)
    where a child's contribution is its subtree quota minus its localQuota
    (resource_node.go:217-227 accumulateFromChild, :67 localQuota).
  * localQuota = max(0, SubtreeQuota - lendingLimit) if lendingLimit set
    else 0 (resource_node.go:67-72).
  * Cohort Usage = sum_children max(0, Usage_c - localQuota_c)
    (resource_node.go:223-226).
  * available(n) climbs to the root, clipping by borrowingLimit through
    storedInParent/usedInParent (resource_node.go:106-122).
  * addUsage/removeUsage bubble only the part exceeding localQuota
    (resource_node.go:144-165).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from kueue_tpu_torch.api.types import (
    INF,
    ClusterQueue,
    ClusterQueuePreemption,
    Cohort,
    FlavorFungibility,
    FlavorResource,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    sat_add,
    sat_sub,
)
from kueue_tpu_torch.obs import perf as _perf
from kueue_tpu_torch.workload_info import WorkloadInfo


@dataclass
class ResourceNode:
    """Reference: resource_node.go:30 (resourceNode)."""

    quotas: dict[FlavorResource, ResourceQuota] = field(default_factory=dict)
    subtree_quota: dict[FlavorResource, int] = field(default_factory=dict)
    usage: dict[FlavorResource, int] = field(default_factory=dict)

    def local_quota(self, fr: FlavorResource) -> int:
        """resource_node.go:67 — capacity invisible to the parent."""
        q = self.quotas.get(fr)
        if q is not None and q.lending_limit is not None:
            return max(0, sat_sub(self.subtree_quota.get(fr, 0), q.lending_limit))
        return 0


class _Node:
    """Shared behavior of ClusterQueueSnapshot and CohortSnapshot
    (flatResourceNode / hierarchicalResourceNode in the reference)."""

    name: str
    node: ResourceNode
    parent: Optional["CohortSnapshot"]
    fair_weight: float

    def has_parent(self) -> bool:
        return self.parent is not None

    def path_parent_to_root(self) -> Iterator["CohortSnapshot"]:
        a = self.parent
        while a is not None:
            yield a
            a = a.parent

    def root(self) -> "_Node":
        n: _Node = self
        while n.parent is not None:
            n = n.parent
        return n

    # -- quota math (resource_node.go) --

    def local_available(self, fr: FlavorResource) -> int:
        """resource_node.go:92 (LocalAvailable)."""
        r = self.node
        return max(0, sat_sub(r.local_quota(fr), r.usage.get(fr, 0)))

    def available_raw(self, fr: FlavorResource) -> int:
        """resource_node.go:106 (available) — may be negative on
        overadmission."""
        r = self.node
        if self.parent is None:
            return sat_sub(r.subtree_quota.get(fr, 0), r.usage.get(fr, 0))
        parent_available = self.parent.available_raw(fr)
        q = r.quotas.get(fr)
        if q is not None and q.borrowing_limit is not None:
            lq = r.local_quota(fr)
            stored_in_parent = sat_sub(r.subtree_quota.get(fr, 0), lq)
            used_in_parent = max(0, sat_sub(r.usage.get(fr, 0), lq))
            with_max = sat_add(sat_sub(stored_in_parent, used_in_parent),
                               q.borrowing_limit)
            parent_available = min(with_max, parent_available)
        return sat_add(self.local_available(fr), parent_available)

    def potential_available(self, fr: FlavorResource) -> int:
        """resource_node.go:129 (potentialAvailable)."""
        r = self.node
        if self.parent is None:
            return r.subtree_quota.get(fr, 0)
        avail = sat_add(r.local_quota(fr), self.parent.potential_available(fr))
        q = r.quotas.get(fr)
        if q is not None and q.borrowing_limit is not None:
            avail = min(sat_add(r.subtree_quota.get(fr, 0), q.borrowing_limit),
                        avail)
        return avail

    def add_usage_fr(self, fr: FlavorResource, val: int) -> None:
        """resource_node.go:144 (addUsage)."""
        local_avail = self.local_available(fr)
        self.node.usage[fr] = sat_add(self.node.usage.get(fr, 0), val)
        if self.parent is not None and val > local_avail:
            self.parent.add_usage_fr(fr, sat_sub(val, local_avail))

    def remove_usage_fr(self, fr: FlavorResource, val: int) -> None:
        """resource_node.go:156 (removeUsage)."""
        r = self.node
        stored_in_parent = sat_sub(r.usage.get(fr, 0), r.local_quota(fr))
        r.usage[fr] = sat_sub(r.usage.get(fr, 0), val)
        if stored_in_parent <= 0 or self.parent is None:
            return
        self.parent.remove_usage_fr(fr, min(val, stored_in_parent))

    def borrowing_with(self, fr: FlavorResource, val: int) -> bool:
        """clusterqueue_snapshot.go:162 / cohort_snapshot.go — usage + val
        exceeds this node's guaranteed quota.  For CQs the reference compares
        against nominal quota; for cohorts against SubtreeQuota."""
        raise NotImplementedError

    def quantities_fit_in_quota(
        self, requests: dict[FlavorResource, int]
    ) -> tuple[bool, dict[FlavorResource, int]]:
        """resource_node.go:233 (QuantitiesFitInQuota)."""
        fits = True
        remaining: dict[FlavorResource, int] = {}
        r = self.node
        for fr, v in requests.items():
            if r.subtree_quota.get(fr, 0) < sat_add(r.usage.get(fr, 0), v):
                fits = False
            remaining[fr] = max(0, sat_sub(v, self.local_available(fr)))
        return fits, remaining

    def is_within_nominal_in(self, frs) -> bool:
        """resource_node.go:247 (IsWithinNominalInResources)."""
        r = self.node
        return all(r.subtree_quota.get(fr, 0) >= r.usage.get(fr, 0)
                   for fr in frs)

    # -- DRS / fair sharing (fair_sharing.go) --

    def dominant_resource_share(
        self, wl_req: Optional[dict[FlavorResource, int]] = None
    ) -> "DRS":
        return dominant_resource_share(self, wl_req)


@dataclass
class DRS:
    """Dominant resource share value object (fair_sharing.go:43)."""

    fair_weight: float = 1.0
    unweighted_ratio: float = 0.0
    dominant_resource: str = ""
    borrowing: bool = False
    borrowed_frs: tuple[FlavorResource, ...] = ()

    @classmethod
    def negative(cls) -> "DRS":
        return cls(unweighted_ratio=-1.0)

    def is_zero(self) -> bool:
        return self.unweighted_ratio == 0

    def is_borrowing(self) -> bool:
        return self.borrowing

    def is_borrowing_on(self, requested_frs) -> bool:
        """fair_sharing.go:76 (IsBorrowingOn): borrowing on any
        FlavorResource positively present in ``requested_frs``."""
        if not requested_frs:
            return False
        return any(requested_frs.get(fr, 0) > 0
                   for fr in self.borrowed_frs)

    def _zero_weight_borrows(self) -> bool:
        return self.fair_weight == 0 and not self.is_zero()

    def precise_weighted_share(self) -> float:
        if self.is_zero():
            return 0.0
        if self.fair_weight == 0:
            return float("inf")
        return self.unweighted_ratio / self.fair_weight


def compare_drs(a: DRS, b: DRS) -> int:
    """fair_sharing.go:103 (CompareDRS)."""
    azb, bzb = a._zero_weight_borrows(), b._zero_weight_borrows()
    if azb and bzb:
        x, y = a.unweighted_ratio, b.unweighted_ratio
    elif azb:
        return 1
    elif bzb:
        return -1
    else:
        x, y = a.precise_weighted_share(), b.precise_weighted_share()
    return (x > y) - (x < y)


def dominant_resource_share(node: _Node,
                            wl_req: Optional[dict[FlavorResource, int]]) -> DRS:
    """fair_sharing.go:140 (dominantResourceShare)."""
    drs = DRS(fair_weight=node.fair_weight)
    if not node.has_parent():
        return drs
    r = node.node
    borrowed_frs: list[FlavorResource] = []
    borrowing: dict[str, int] = {}
    for fr, quota in r.subtree_quota.items():
        req = (wl_req or {}).get(fr, 0)
        amount_borrowed = sat_sub(sat_add(req, r.usage.get(fr, 0)), quota)
        if amount_borrowed > 0:
            borrowing[fr.resource] = sat_add(borrowing.get(fr.resource, 0),
                                             amount_borrowed)
            borrowed_frs.append(fr)
    if not borrowing:
        return drs
    drs.borrowing = True
    drs.borrowed_frs = tuple(borrowed_frs)

    lendable = calculate_lendable(node.parent)
    for rname, b in borrowing.items():
        lr = lendable.get(rname, 0)
        if lr > 0:
            ratio = float(b) * 1000.0 / float(lr)
            if ratio > drs.unweighted_ratio or (
                    ratio == drs.unweighted_ratio
                    and rname < drs.dominant_resource):
                drs.unweighted_ratio = ratio
                drs.dominant_resource = rname
    return drs


def calculate_lendable(node: _Node) -> dict[str, int]:
    """fair_sharing.go:177 (calculateLendable) — per-resource potential
    capacity visible to ``node``, aggregated over flavors."""
    root = node
    while root.parent is not None:
        root = root.parent
    lendable: dict[str, int] = {}
    for fr in root.node.subtree_quota:
        lendable[fr.resource] = sat_add(
            lendable.get(fr.resource, 0), node.potential_available(fr))
    return lendable


class CohortSnapshot(_Node):
    """Reference: pkg/cache/scheduler/cohort_snapshot.go."""

    def __init__(self, name: str, fair_weight: float = 1.0):
        self.name = name
        self.node = ResourceNode()
        self.parent: Optional[CohortSnapshot] = None
        self.fair_weight = fair_weight
        self.child_cohorts: list[CohortSnapshot] = []
        self.child_cqs: list[ClusterQueueSnapshot] = []

    def borrowing_with(self, fr: FlavorResource, val: int) -> bool:
        """A cohort borrows when child-usage stored here exceeds its subtree
        quota (cohort_snapshot.go BorrowingWith)."""
        return self.node.subtree_quota.get(fr, 0) < sat_add(
            self.node.usage.get(fr, 0), val)

    def child_count(self) -> int:
        return len(self.child_cohorts) + len(self.child_cqs)

    def height(self) -> int:
        """classical/hierarchical_preemption.go:209 (getNodeHeight)."""
        h = min(self.child_count(), 1)
        for c in self.child_cohorts:
            h = max(h, c.height() + 1)
        return h

    def subtree_cluster_queues(self) -> Iterator["ClusterQueueSnapshot"]:
        yield from self.child_cqs
        for c in self.child_cohorts:
            yield from c.subtree_cluster_queues()


class ClusterQueueSnapshot(_Node):
    """Reference: clusterqueue_snapshot.go:51."""

    def __init__(self, cq: ClusterQueue):
        self.name = cq.name
        self.spec = cq
        self.node = ResourceNode()
        self.parent = None
        self.fair_weight = cq.fair_weight
        self.preemption: ClusterQueuePreemption = cq.preemption
        self.flavor_fungibility: FlavorFungibility = cq.flavor_fungibility
        self.fair_sharing_enabled = cq.fair_sharing is not None
        self.workloads: dict[str, WorkloadInfo] = {}
        self.generation = 0
        # TAS flavor snapshots, populated by the TAS layer (flavor -> snapshot)
        self.tas_flavors: dict[str, object] = {}
        for fr in cq.flavor_resources():
            self.node.quotas[fr] = cq.quota_for(fr)

    def rg_by_resource(self, resource: str) -> Optional[ResourceGroup]:
        for rg in self.spec.resource_groups:
            if resource in rg.covered_resources:
                return rg
        return None

    def quota_for(self, fr: FlavorResource) -> ResourceQuota:
        return self.node.quotas.get(fr, ResourceQuota())

    def borrowing_with(self, fr: FlavorResource, val: int) -> bool:
        """clusterqueue_snapshot.go:162 — usage + val exceeds nominal."""
        return self.quota_for(fr).nominal < sat_add(
            self.node.usage.get(fr, 0), val)

    def borrowing(self, fr: FlavorResource) -> bool:
        return self.borrowing_with(fr, 0)

    def available(self, fr: FlavorResource) -> int:
        """clusterqueue_snapshot.go:170 — clipped at 0."""
        return max(0, self.available_raw(fr))

    def fits(self, usage: dict[FlavorResource, int]) -> bool:
        """clusterqueue_snapshot.go:137 (quota part of Fits)."""
        return all(self.available(fr) >= q for fr, q in usage.items())

    def add_usage(self, usage: dict[FlavorResource, int]) -> None:
        for fr, q in usage.items():
            self.add_usage_fr(fr, q)

    def remove_usage(self, usage: dict[FlavorResource, int]) -> None:
        for fr, q in usage.items():
            self.remove_usage_fr(fr, q)

    def simulate_usage_addition(
            self, usage: dict[FlavorResource, int]) -> Callable[[], None]:
        self.add_usage(usage)
        return lambda: self.remove_usage(usage)

    def simulate_usage_removal(
            self, usage: dict[FlavorResource, int]) -> Callable[[], None]:
        self.remove_usage(usage)
        return lambda: self.add_usage(usage)


class Snapshot:
    """One scheduling cycle's immutable-ish world copy (snapshot.go:51)."""

    def __init__(self) -> None:
        self.cluster_queues: dict[str, ClusterQueueSnapshot] = {}
        self.cohorts: dict[str, CohortSnapshot] = {}
        self.resource_flavors: dict[str, ResourceFlavor] = {}
        self.inactive_cluster_queues: set[str] = set()
        # flavor name -> tas.TASFlavorSnapshot, shared by all CQs
        # referencing the flavor (snapshot-level, like the reference).
        self.tas_flavors: dict[str, object] = {}

    def cluster_queue(self, name: str) -> Optional[ClusterQueueSnapshot]:
        return self.cluster_queues.get(name)

    def close(self) -> None:
        """End the TAS undo scopes opened by build_snapshot over live
        prototypes, reverting in-cycle usage mutations. Idempotent;
        no-op for from-scratch TAS forests (their scopes were never
        opened, and their mutations die with this object)."""
        _pt = _perf.begin()
        seen = set()
        for tas in self.tas_flavors.values():
            if id(tas) in seen:
                continue
            seen.add(id(tas))
            end = getattr(tas, "end_cycle", None)
            if end is not None:
                end()
        _perf.end("apply.undo_log_commit", _pt)

    # -- workload add/remove (snapshot.go AddWorkload/RemoveWorkload) --

    def add_workload(self, info: WorkloadInfo) -> None:
        cq = self.cluster_queues[info.cluster_queue]
        cq.workloads[info.key] = info
        cq.add_usage(info.usage())
        for flavor, values, single, count in info.tas_domains(
                self.tas_flavors):
            self.tas_flavors[flavor].add_usage(values, single, count)

    def remove_workload(self, info: WorkloadInfo) -> None:
        cq = self.cluster_queues[info.cluster_queue]
        cq.workloads.pop(info.key, None)
        cq.remove_usage(info.usage())
        for flavor, values, single, count in info.tas_domains(
                self.tas_flavors):
            self.tas_flavors[flavor].remove_usage(values, single, count)

    def simulate_workload_removal(
            self, infos: list[WorkloadInfo]) -> Callable[[], None]:
        """snapshot.go:77 (SimulateWorkloadRemoval). The revert restores
        each touched TAS forest's usage-version bookkeeping: a
        preemption candidate search runs hundreds of simulate/revert
        pairs per nomination, and letting each bump the version forever
        would invalidate every version-keyed memo (placement results,
        exclusion stats, device usage matrices) for state that is
        bit-identical after the revert. Reverts nest LIFO (the
        preemptor's search discipline), so the snapshots compose."""
        tas_vers = {id(t): (t, getattr(t, "_usage_version", 0),
                            getattr(t, "_usage_removals", 0))
                    for t in self.tas_flavors.values()}
        for info in infos:
            self.remove_workload(info)

        def revert() -> None:
            for info in infos:
                self.add_workload(info)
            for tas, ver, rem in tas_vers.values():
                # Cache/memo entries keyed at interim versions would
                # collide with future bumps after the restore and serve
                # results computed against the simulated (reverted)
                # state — purge any not keyed at the restored version.
                mc = getattr(tas, "_usage_matrix_cache", None)
                if mc:
                    for k in [k for k in mc if k[0] != ver]:
                        mc.pop(k)
                jc = getattr(tas, "_usage_tensor_cache", None)
                if jc is not None and jc[0][0] != ver:
                    tas._usage_tensor_cache = None
                pm = getattr(tas, "_place_memo", None)
                if pm is not None and pm[0] != ver:
                    tas._place_memo = None
                # The phase-1 memo (tas._p1) needs no purge here: usage
                # writes during the simulation AND its revert both land
                # the touched leaves in its stale set, and the next use
                # recomputes exactly those — version restoration cannot
                # alias it onto different state.
                sm = getattr(tas, "_stats_memo", None)
                if sm is not None and sm[0][1] != ver:
                    tas._stats_memo = None
                tas._usage_version = ver
                tas._usage_removals = rem
        return revert


def build_snapshot(
    cluster_queues: list[ClusterQueue],
    cohorts: list[Cohort],
    resource_flavors: list[ResourceFlavor],
    admitted_workloads: Optional[list[WorkloadInfo]],
    inactive_cluster_queues: Optional[set[str]] = None,
    topologies: Optional[list] = None,
    nodes: Optional[list] = None,
    tas_prototypes: Optional[dict] = None,
    cq_usage: Optional[dict] = None,
    cq_workloads: Optional[dict] = None,
    tas_usage_agg: Optional[dict] = None,
) -> Snapshot:
    """Assemble a Snapshot and run the tree-resource accumulation
    (resource_node.go:178 updateCohortTreeResources).

    Two feeding modes: ``admitted_workloads`` replays every admitted
    workload through add_workload (the from-scratch path used by tests
    and the perf harness), while ``cq_usage``/``cq_workloads``/
    ``tas_usage_agg`` install the live cache's incrementally-maintained
    aggregates directly — O(ClusterQueues + distinct TAS domains)
    instead of O(admitted workloads) per cycle (the reference's
    Snapshot() clones its live usage the same way, snapshot.go:161)."""
    snap = Snapshot()
    snap.resource_flavors = {f.name: f for f in resource_flavors}
    snap.inactive_cluster_queues = set(inactive_cluster_queues or ())

    # TAS flavor snapshots (tas_cache.go): one per flavor with a topology,
    # fed by the nodes matching the flavor's nodeLabels. Cached
    # prototypes (Cache.tas_prototypes) carry the LIVE admitted usage
    # and are shared zero-copy: the snapshot opens an undo scope on each
    # (begin_cycle) so in-cycle mutations revert at Snapshot.close() —
    # O(touched leaves) instead of the O(forest) fork of round 4.
    if tas_prototypes is not None:
        for name, proto in tas_prototypes.items():
            proto.begin_cycle()
            snap.tas_flavors[name] = proto
    elif topologies:
        from kueue_tpu_torch.tas.snapshot import TASFlavorSnapshot
        topo_by_name = {t.name: t for t in topologies}
        for rf in resource_flavors:
            if rf.topology_name and rf.topology_name in topo_by_name:
                tas_snap = TASFlavorSnapshot(
                    topo_by_name[rf.topology_name],
                    flavor_tolerations=tuple(rf.tolerations))
                for node in nodes or []:
                    if all(node.labels.get(k) == v
                           for k, v in rf.node_labels.items()):
                        tas_snap.add_node(node)
                snap.tas_flavors[rf.name] = tas_snap

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
        for rg in cq.resource_groups:
            for fq in rg.flavors:
                if fq.name in snap.tas_flavors:
                    cqs.tas_flavors[fq.name] = snap.tas_flavors[fq.name]

    # Incremental mode: install the live cache's per-CQ usage BEFORE the
    # bottom-up pass so cohort usage derives from it in the same sweep.
    if cq_usage is not None:
        for name, cqs in snap.cluster_queues.items():
            usage = cq_usage.get(name)
            if usage:
                cqs.node.usage = dict(usage)

    # Bottom-up subtree quota accumulation from the roots.
    for cs in snap.cohorts.values():
        if cs.parent is None:
            _update_cohort_resource_node(cs)
    for cqs in snap.cluster_queues.values():
        if cqs.parent is None:
            _update_cq_resource_node(cqs)

    if cq_workloads is not None:
        for name, cqs in snap.cluster_queues.items():
            wls = cq_workloads.get(name)
            if wls:
                cqs.workloads = dict(wls)
    # Live prototypes already carry the admitted usage (installed at
    # prototype build + written through on every cache commit); the
    # install loop only feeds from-scratch forests.
    if tas_usage_agg is not None and tas_prototypes is None:
        for flavor, by_values in tas_usage_agg.items():
            tas = snap.tas_flavors.get(flavor)
            if tas is None:
                continue
            for values, totals in by_values.items():
                if any(totals.values()):
                    tas.install_usage(values, totals)
    for info in admitted_workloads or ():
        snap.add_workload(info)
    return snap


def _update_cq_resource_node(cq: ClusterQueueSnapshot) -> None:
    """resource_node.go:167 (updateClusterQueueResourceNode)."""
    cq.generation += 1
    cq.node.subtree_quota = {fr: q.nominal for fr, q in cq.node.quotas.items()}


def _update_cohort_resource_node(cohort: CohortSnapshot) -> None:
    """resource_node.go:190 (updateCohortResourceNode)."""
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
    """resource_node.go:217 (accumulateFromChild)."""
    for fr, child_quota in child.node.subtree_quota.items():
        delta = sat_sub(child_quota, child.node.local_quota(fr))
        parent.node.subtree_quota[fr] = sat_add(
            parent.node.subtree_quota.get(fr, 0), delta)
    for fr, child_usage in child.node.usage.items():
        delta = max(0, sat_sub(child_usage, child.node.local_quota(fr)))
        parent.node.usage[fr] = sat_add(parent.node.usage.get(fr, 0), delta)


def find_height_of_lowest_subtree_that_fits(
        cq: ClusterQueueSnapshot, fr: FlavorResource,
        val: int) -> tuple[int, bool]:
    """classical/hierarchical_preemption.go:221
    (FindHeightOfLowestSubtreeThatFits). Returns (height, smaller-than-root).
    """
    if not cq.borrowing_with(fr, val) or not cq.has_parent():
        return 0, cq.has_parent()
    remaining = sat_sub(val, cq.local_available(fr))
    for tracking in cq.path_parent_to_root():
        if not tracking.borrowing_with(fr, remaining):
            return tracking.height(), tracking.has_parent()
        remaining = sat_sub(remaining, tracking.local_available(fr))
    root = cq.parent.root()
    assert isinstance(root, CohortSnapshot)
    return root.height(), False
