"""Admitted-side live cache: the in-memory world model the scheduler
snapshots each cycle.

Reference: pkg/cache/scheduler/cache.go:129 (Cache) — CQ/cohort/flavor
registries, admitted-workload usage, assume/forget, snapshotting.
Copied from ``kueue_tpu/cache/scheduler_cache.py`` without topologies,
nodes and the TAS usage aggregates (TAS inside the engine is not
ported).
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
        self._wl_usage: dict[str, tuple] = {}  # key -> (cq, usage dict)

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
            # Drop the deleted CQ's contributions.
            self.rebuild_accounting()

    def add_or_update_cohort(self, cohort: Cohort) -> None:
        if self.cohorts.get(cohort.name) is not cohort:
            self.spec_version += 1
        self.cohorts[cohort.name] = cohort

    def delete_cohort(self, name: str) -> None:
        if self.cohorts.pop(name, None) is not None:
            self.spec_version += 1

    def add_or_update_resource_flavor(self, rf: ResourceFlavor) -> None:
        if rf.topology_name:
            raise NotImplementedError(
                "topology-aware scheduling in the engine is not ported")
        self.resource_flavors[rf.name] = rf
        self.spec_version += 1

    def delete_resource_flavor(self, name: str) -> None:
        self.resource_flavors.pop(name, None)
        self.spec_version += 1

    def mark_admitted_dirty(self, key: str) -> None:
        if len(self.admitted_dirty) > 100_000:
            # Nobody is draining the log (no oracle bridge attached):
            # drop it and signal full-resync via the epoch.
            self.admitted_dirty.clear()
            self.admitted_dirty_epoch += 1
        self.admitted_dirty.add(key)

    # -- workloads (cache.go:766 AddOrUpdateWorkload / assume) --

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
        self._wl_usage[key] = (info.cluster_queue, usage)

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

    def rebuild_accounting(self) -> None:
        """Recompute the incremental aggregates from the workload
        registry (a ClusterQueue was added or deleted)."""
        self.cq_usage = {}
        self.cq_workloads = {}
        self._wl_usage = {}
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
                wl, wl.status.admission.cluster_queue)
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
        (the Active condition). Admission checks are not ported: with no
        check registry, as in an engine without one, a CQ's checks make
        it neither inactive nor slower to admit."""
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
            cq_usage=self.cq_usage,
            cq_workloads=self.cq_workloads,
        )
