"""Admitted-side live cache: the in-memory world model the scheduler
snapshots each cycle.

Reference: pkg/cache/scheduler/cache.go:129 (Cache) — CQ/cohort/flavor
registries, admitted-workload usage, assume/forget, snapshotting.
Copied from ``kueue_tpu/cache/scheduler_cache.py`` without resource
transformations. TAS forests are built on ``tas_device`` (CUDA unless
the engine asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    ResourceFlavor,
    StopPolicy,
    Workload,
)
from kueue_tpu_torch.cache.snapshot import Snapshot, build_snapshot
from kueue_tpu_torch.workload_info import WorkloadInfo


class Cache:
    """pkg/cache/scheduler/cache.go:129."""

    def __init__(self) -> None:
        self.cluster_queues: dict[str, ClusterQueue] = {}
        self.cohorts: dict[str, Cohort] = {}
        self.resource_flavors: dict[str, ResourceFlavor] = {}
        self.topologies: dict[str, object] = {}  # api.Topology
        self.nodes: dict[str, object] = {}  # tas.Node
        # key -> admitted/assumed WorkloadInfo
        self.workloads: dict[str, WorkloadInfo] = {}
        # Incremental admitted-side accounting (cache.go keeps usage live
        # and Snapshot() clones it; round 1 recomputed it per cycle from
        # every admitted workload — O(A) Python per snapshot). The exact
        # quantities ADDED are remembered per workload so removal
        # subtracts what was added even if the live object mutated
        # (reclaimable pods shrink usage in place).
        self.cq_usage: dict[str, dict] = {}  # cq -> FlavorResource -> int
        self.cq_workloads: dict[str, dict[str, WorkloadInfo]] = {}
        # Bumped on every admitted-set change: consumers (the bridge's
        # admitted-tensor cache) key their encodes on it.
        self.admitted_version = 0
        # Admitted-change log: keys whose admitted-side encoding may
        # have changed (upsert/delete/evict-flag). Drained by the
        # bridge's incremental AdmittedRows (tensor/rowcache.py). With
        # no consumer attached the set is CAPPED: on overflow it is
        # dropped and the epoch bumped, which tells a (future) consumer
        # to full-resync instead of trusting the log.
        self.admitted_dirty: set[str] = set()
        self.admitted_dirty_epoch = 0
        # Bumped on every CQ/cohort spec change (views memoize on it).
        self.spec_version = 0
        # flavor -> domain values tuple -> {resource: total}
        self.tas_usage_agg: dict[str, dict[tuple, dict[str, int]]] = {}
        self._wl_usage: dict[str, tuple] = {}  # key -> (cq, usage dict)
        self._wl_tas: dict[str, list] = {}  # key -> tas_domains tuples
        # workload_info.InfoOptions, set by the engine.
        self.info_options = None
        # Hook returning the set of defined AdmissionCheck names
        # (installed by AdmissionCheckManager); None = no check registry.
        self.admission_check_names = None
        # Cached TAS forest prototypes (see tas_prototypes()), and the
        # device their tensors live on.
        self._tas_protos = None
        self.tas_device = None
        # Non-TAS pod usage (tas_non_tas_pod_cache.go): per-node totals
        # subtracted from TAS leaf capacity at prototype build.
        from kueue_tpu_torch.tas.non_tas_usage import NonTASUsageCache
        self.non_tas_usage = NonTASUsageCache()

    # -- object lifecycle --

    def add_or_update_cluster_queue(self, cq: ClusterQueue) -> None:
        is_new = cq.name not in self.cluster_queues
        if self.cluster_queues.get(cq.name) is not cq:
            # Identity check keeps no-op resyncs of the same object from
            # invalidating spec-keyed memos (world tensors, views).
            self.spec_version += 1
        self.cluster_queues[cq.name] = cq
        if is_new:
            # Workloads admitted while their CQ was absent were excluded
            # from the aggregates (_account guards on CQ liveness).
            self.rebuild_accounting()

    def delete_cluster_queue(self, name: str) -> None:
        if self.cluster_queues.pop(name, None) is not None:
            self.spec_version += 1
            # Drop the deleted CQ's contributions — TAS aggregates are
            # flavor-keyed, so without this its still-registered
            # workloads would keep occupying shared topology leaves that
            # the from-scratch encoder (which filters by live CQs) frees.
            self.rebuild_accounting()

    def add_or_update_cohort(self, cohort: Cohort) -> None:
        if self.cohorts.get(cohort.name) is not cohort:
            self.spec_version += 1
        self.cohorts[cohort.name] = cohort

    def delete_cohort(self, name: str) -> None:
        if self.cohorts.pop(name, None) is not None:
            self.spec_version += 1

    def _invalidate_tas_prototypes(self) -> None:
        self._tas_protos = None

    def add_or_update_resource_flavor(self, rf: ResourceFlavor) -> None:
        was_tas = self._tas_flavor_names()
        self.resource_flavors[rf.name] = rf
        self.spec_version += 1
        self._invalidate_tas_prototypes()
        if was_tas != self._tas_flavor_names():
            self.rebuild_accounting()

    def delete_resource_flavor(self, name: str) -> None:
        rf = self.resource_flavors.pop(name, None)
        self.spec_version += 1
        self._invalidate_tas_prototypes()
        if rf is not None and rf.topology_name:
            self.rebuild_accounting()

    def add_or_update_topology(self, topology) -> None:
        self.topologies[topology.name] = topology
        self.spec_version += 1
        self._invalidate_tas_prototypes()

    def delete_topology(self, name: str) -> None:
        self.topologies.pop(name, None)
        self.spec_version += 1
        self._invalidate_tas_prototypes()

    def add_or_update_node(self, node) -> None:
        self.nodes[node.name] = node
        self._invalidate_tas_prototypes()

    def delete_node(self, name: str) -> None:
        self.nodes.pop(name, None)
        self._invalidate_tas_prototypes()

    def set_node_ready(self, name: str, ready: bool) -> bool:
        """In-place readiness flip WITH prototype invalidation — the
        one sanctioned way to mutate a registered node (mutating the
        object directly would leave stale TAS forests serving)."""
        node = self.nodes.get(name)
        if node is None:
            return False
        node.ready = ready
        self._invalidate_tas_prototypes()
        return True

    def set_tas_device(self, device) -> None:
        """Build the TAS forests on ``device`` from now on."""
        if device != self.tas_device:
            self.tas_device = device
            self._invalidate_tas_prototypes()

    def tas_prototypes(self):
        """Cached per-flavor TAS forest prototypes (the tas_cache.go
        node-forest cache): rebuilt only when nodes/topologies/flavors
        change; snapshots fork them instead of re-adding every node."""
        if self._tas_protos is None:
            from kueue_tpu_torch.tas.snapshot import TASFlavorSnapshot

            protos = {}
            for rf in self.resource_flavors.values():
                topo = self.topologies.get(rf.topology_name) \
                    if rf.topology_name else None
                if topo is None:
                    continue
                snap = TASFlavorSnapshot(
                    topo, flavor_tolerations=tuple(rf.tolerations),
                    device=self.tas_device)
                for node in self.nodes.values():
                    if all(node.labels.get(k) == v
                           for k, v in rf.node_labels.items()):
                        snap.add_node(
                            node,
                            non_tas_usage=self.non_tas_usage.node_usage(
                                node.name))
                protos[rf.name] = snap
            # Prototypes carry the LIVE admitted usage from birth;
            # _account_tas/_unaccount write commits through from here on
            # (snapshots share the forest under an undo scope instead of
            # forking it — tas/snapshot.py begin_cycle).
            for name, proto in protos.items():
                for values, totals in self.tas_usage_agg.get(name,
                                                             {}).items():
                    if any(totals.values()):
                        proto.install_usage(values, totals)
            self._tas_protos = protos
        return self._tas_protos

    def mark_admitted_dirty(self, key: str) -> None:
        if len(self.admitted_dirty) > 100_000:
            # Nobody is draining the log (no oracle bridge attached):
            # drop it and signal full-resync via the epoch.
            self.admitted_dirty.clear()
            self.admitted_dirty_epoch += 1
        self.admitted_dirty.add(key)

    # -- workloads (cache.go:766 AddOrUpdateWorkload / assume) --

    def _tas_flavor_names(self) -> set:
        return {rf.name for rf in self.resource_flavors.values()
                if rf.topology_name}

    def _account(self, key: str, info: WorkloadInfo) -> None:
        if info.cluster_queue not in self.cluster_queues:
            # Mirrors the from-scratch encoder's live-CQ filter; the
            # CQ-(re)add path rebuilds accounting to pick these up.
            return
        usage = info.usage()
        cq_usage = self.cq_usage.setdefault(info.cluster_queue, {})
        for fr, v in usage.items():
            cq_usage[fr] = cq_usage.get(fr, 0) + v
        self.cq_workloads.setdefault(info.cluster_queue, {})[key] = info
        tas = info.tas_domains(self._tas_flavor_names())
        self._account_tas(tas)
        self._wl_usage[key] = (info.cluster_queue, usage)
        self._wl_tas[key] = tas

    def _account_tas(self, tas) -> None:
        protos = self._tas_protos
        for flavor, values, single, count in tas:
            by_values = self.tas_usage_agg.setdefault(flavor, {})
            totals = by_values.setdefault(values, {})
            for res, per_pod in single.items():
                totals[res] = totals.get(res, 0) + per_pod * count
            # Pod slots (tas_flavor_snapshot.go:321).
            totals["pods"] = totals.get("pods", 0) + count
            if protos is not None:
                proto = protos.get(flavor)
                if proto is not None:
                    deltas = {res: per_pod * count
                              for res, per_pod in single.items()}
                    deltas["pods"] = deltas.get("pods", 0) + count
                    proto.commit_usage(values, deltas)

    def _unaccount(self, key: str) -> None:
        entry = self._wl_usage.pop(key, None)
        if entry is not None:
            cq_name, usage = entry
            cq_usage = self.cq_usage.get(cq_name, {})
            for fr, v in usage.items():
                left = cq_usage.get(fr, 0) - v
                if left:
                    cq_usage[fr] = left
                else:
                    cq_usage.pop(fr, None)
            wls = self.cq_workloads.get(cq_name)
            if wls is not None:
                wls.pop(key, None)
        protos = self._tas_protos
        for flavor, values, single, count in self._wl_tas.pop(key, ()):
            totals = self.tas_usage_agg.get(flavor, {}).get(values)
            if totals is None:
                continue
            for res, per_pod in single.items():
                left = totals.get(res, 0) - per_pod * count
                if left:
                    totals[res] = left
                else:
                    totals.pop(res, None)
            left = totals.get("pods", 0) - count
            if left:
                totals["pods"] = left
            else:
                totals.pop("pods", None)
            if protos is not None:
                proto = protos.get(flavor)
                if proto is not None:
                    deltas = {res: -per_pod * count
                              for res, per_pod in single.items()}
                    deltas["pods"] = deltas.get("pods", 0) - count
                    proto.commit_usage(values, deltas)

    def rebuild_accounting(self) -> None:
        """Recompute the incremental aggregates from the workload
        registry — the recovery path after flavor/topology registry
        changes reclassify which flavors are TAS."""
        # Live prototypes carry the old aggregates — drop them so the
        # rebuild's _account write-throughs can't double-install (the
        # next tas_prototypes() call re-installs the fresh aggregates).
        self._invalidate_tas_prototypes()
        self.cq_usage = {}
        self.cq_workloads = {}
        self.tas_usage_agg = {}
        self._wl_usage = {}
        self._wl_tas = {}
        self.admitted_version += 1
        self.admitted_dirty.update(self.workloads.keys())
        for key, info in self.workloads.items():
            self._account(key, info)

    def add_or_update_workload(self, wl: Workload,
                               info: Optional[WorkloadInfo] = None) -> bool:
        """``info``: reuse an already-derived WorkloadInfo (the
        scheduler's entry info, with the admission applied) — deriving
        one from scratch runs the whole effective-requests pipeline and
        was the dominant per-admission cost at scale."""
        if wl.status.admission is None:
            return False
        if (info is None or info.obj is not wl
                or info.cluster_queue != wl.status.admission.cluster_queue
                or wl.status.reclaimable_pods):
            # Reclaimable pods interleave with admission count scaling in
            # a path-dependent way — re-derive so every accounting path
            # agrees with the canonical from-scratch pipeline.
            info = WorkloadInfo.from_workload(
                wl, wl.status.admission.cluster_queue,
                options=self.info_options)
        if info.cluster_queue not in self.cluster_queues:
            return False
        self._unaccount(wl.key)
        self.workloads[wl.key] = info
        self._account(wl.key, info)
        self.admitted_version += 1
        self.mark_admitted_dirty(wl.key)
        return True

    def delete_workload(self, key: str) -> bool:
        self._unaccount(key)
        removed = self.workloads.pop(key, None) is not None
        if removed:
            # Only an actual admitted-set change invalidates consumers'
            # encodes (this is called for never-admitted keys too).
            self.admitted_version += 1
            self.mark_admitted_dirty(key)
        return removed

    def is_assumed(self, key: str) -> bool:
        return key in self.workloads

    # -- status / metrics inputs --

    def usage_for_cq(self, name: str):
        return dict(self.cq_usage.get(name, {}))

    def admitted_count(self, name: str) -> int:
        return len(self.cq_workloads.get(name, {}))

    # -- snapshot (cache.go Snapshot / snapshot.go:161) --

    def cq_inactive_reasons(self, cq) -> list[tuple[str, str]]:
        """clusterqueue.go:300 (inactiveReason): why this CQ can't admit.
        The single source of truth shared by scheduling (CQs with any
        reason are excluded from the snapshot) and the status controller
        (the Active condition). ``admission_check_names`` is a hook set
        by the AdmissionCheckManager."""
        reasons: list[tuple[str, str]] = []
        if cq.stop_policy != StopPolicy.NONE:
            reasons.append(("Stopped", "is stopped"))
        missing = [fq.name for rg in cq.resource_groups
                   for fq in rg.flavors
                   if fq.name not in self.resource_flavors]
        if missing:
            reasons.append((
                "FlavorNotFound",
                f"references missing ResourceFlavor(s): {missing}"))
        for rg in cq.resource_groups:
            for fq in rg.flavors:
                rf = self.resource_flavors.get(fq.name)
                topo = getattr(rf, "topology_name", None) if rf else None
                if topo and topo not in self.topologies:
                    reasons.append((
                        "TopologyNotFound",
                        f"there is no Topology {topo!r} for TAS flavor "
                        f"{fq.name!r}"))
        if self.admission_check_names is not None and cq.admission_checks:
            known = self.admission_check_names()
            missing_checks = [c for c in cq.admission_checks
                              if c not in known]
            if missing_checks:
                reasons.append((
                    "AdmissionCheckNotFound",
                    f"references missing AdmissionCheck(s): "
                    f"{missing_checks}"))
        return reasons

    def inactive_cluster_queues(self) -> set[str]:
        return {name for name, cq in self.cluster_queues.items()
                if self.cq_inactive_reasons(cq)}

    def snapshot(self) -> Snapshot:
        return build_snapshot(
            list(self.cluster_queues.values()),
            list(self.cohorts.values()),
            list(self.resource_flavors.values()),
            None,
            inactive_cluster_queues=self.inactive_cluster_queues(),
            topologies=list(self.topologies.values()),
            nodes=list(self.nodes.values()),
            tas_prototypes=self.tas_prototypes(),
            cq_usage=self.cq_usage,
            cq_workloads=self.cq_workloads,
            tas_usage_agg=self.tas_usage_agg,
        )
