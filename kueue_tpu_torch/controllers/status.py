"""CQ/LQ status controllers and finished-object retention.

The port of ``kueue_tpu/controllers/status.py``. Reference:
pkg/controller/core/clusterqueue_controller.go:505
(updateCqStatusIfChanged: flavorsReservation/flavorsUsage/pending/
reserving/admitted counts and the Active condition, whose reasons come
from pkg/cache/scheduler/clusterqueue.go:300 inactiveReason),
localqueue_controller.go (the LocalQueue mirror), and the
objectRetentionPolicies sweep (workload_controller.go retention:
finished and deactivated-by-kueue workloads deleted after a grace
period).

The JAX package builds each status with a scan of every cache workload,
so its ``reconcile_all`` scans them once per ClusterQueue and once per
LocalQueue: about 10^8 iterations at 1,000 ClusterQueues, 2,000
LocalQueues and 55,000 workloads. Here every status a call asks for is
built in one pass over the cache (``_build``), in the cache's order,
so each status and the insertion order of its ``flavors_reservation``
and ``flavors_usage`` dicts equal the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import StopPolicy, WorkloadConditionType

_FINISHED = WorkloadConditionType.FINISHED
_EVICTED = WorkloadConditionType.EVICTED


@dataclass
class QueueStatus:
    """The shared shape of ClusterQueueStatus / LocalQueueStatus
    (clusterqueue_types.go:369-392, localqueue_types.go)."""

    pending_workloads: int = 0
    reserving_workloads: int = 0
    admitted_workloads: int = 0
    # flavor -> resource -> total quantity
    flavors_reservation: dict[str, dict[str, int]] = field(
        default_factory=dict)
    flavors_usage: dict[str, dict[str, int]] = field(default_factory=dict)
    active: bool = True
    active_reason: str = "Ready"
    active_message: str = "Can admit new workloads"
    weighted_share: Optional[float] = None


@dataclass
class WorkloadRetentionPolicy:
    """configuration_types.go:656 (WorkloadRetentionPolicy), seconds."""

    after_finished: Optional[float] = None
    after_deactivated_by_kueue: Optional[float] = None


# The kueue-initiated deactivation reasons (the analog of the
# reference's DeactivatedDueTo* family): each eviction site that also
# flips active=False.
_DEACTIVATION_REASONS = ("AdmissionCheckRejected", "RequeuingLimitExceeded",
                         "MaximumExecutionTimeExceeded")


def _add(totals: dict, usage: dict) -> None:
    for fr, v in usage.items():
        per = totals.get(fr.flavor)
        if per is None:
            per = totals[fr.flavor] = {}
        per[fr.resource] = per.get(fr.resource, 0) + v


class StatusController:
    """Computes and publishes CQ/LQ statuses; owns the retention sweep."""

    def __init__(self, engine,
                 retention: Optional[WorkloadRetentionPolicy] = None,
                 attach: bool = True):
        """``attach=False`` builds a read-only view (used by the HTTP
        status endpoints) that must not install itself on the engine."""
        self.engine = engine
        self.retention = retention
        self.cq_statuses: dict[str, QueueStatus] = {}
        self.lq_statuses: dict[str, QueueStatus] = {}
        if attach:
            engine.status_controller = self

    # -- activeness (clusterqueue.go:300 inactiveReason) --

    def cq_active_condition(self, cq) -> tuple[bool, str, str]:
        """Delegates to the cache's single source of inactive reasons so
        the status surface can never disagree with what the scheduler
        actually excludes."""
        reasons = self.engine.cache.cq_inactive_reasons(cq)
        if reasons:
            return (False, reasons[0][0],
                    "Can't admit new workloads: "
                    + ", ".join(m for _, m in reasons))
        return True, "Ready", "Can admit new workloads"

    # -- status computation (clusterqueue_controller.go:505) --

    def cq_status(self, name: str, snap=None) -> Optional[QueueStatus]:
        return self._build((name,), (), snap)[0][name]

    def lq_status(self, key: str) -> Optional[QueueStatus]:
        """localqueue_controller.go status: the LQ-scoped mirror."""
        return self._build((), (key,))[1][key]

    def _build(self, cq_names, lq_keys, snap=None) -> tuple[dict, dict]:
        """The statuses of the ClusterQueues ``cq_names`` and the
        LocalQueues ``lq_keys`` (None for one that does not exist), in
        one pass over the cache's workloads."""
        eng = self.engine
        cache, queues = eng.cache, eng.queues
        active_of: dict[str, tuple] = {}

        def active(cq):
            got = active_of.get(cq.name)
            if got is None:
                got = active_of[cq.name] = self.cq_active_condition(cq)
            return got

        cqs: dict[str, Optional[QueueStatus]] = {}
        for name in cq_names:
            cq = cache.cluster_queues.get(name)
            if cq is None:
                cqs[name] = None
                continue
            st = cqs[name] = QueueStatus()
            pcq = queues.cluster_queues.get(name)
            if pcq is not None:
                st.pending_workloads = len(pcq.items) + len(pcq.inadmissible)
        lqs: dict[str, Optional[QueueStatus]] = {}
        pending_cqs = set()
        for key in lq_keys:
            lq = queues.local_queues.get(key)
            if lq is None:
                lqs[key] = None
                continue
            st = lqs[key] = QueueStatus()
            pending_cqs.add(lq.cluster_queue)
            cq = cache.cluster_queues.get(lq.cluster_queue)
            if cq is None:
                st.active = False
                st.active_reason = "ClusterQueueDoesNotExist"
                st.active_message = \
                    "Can't submit new workloads to clusterQueue"
                continue
            if not active(cq)[0]:
                st.active = False
                st.active_reason = "ClusterQueueIsInactive"
                st.active_message = \
                    "Can't submit new workloads to clusterQueue"
            if lq.stop_policy != StopPolicy.NONE:
                st.active = False
                st.active_reason = "Stopped"
                st.active_message = "LocalQueue is stopped"
        # An LQ's pending workloads are those of its ClusterQueue's queue
        # that name it.
        for cq_name in pending_cqs:
            pcq = queues.cluster_queues.get(cq_name)
            if pcq is None:
                continue
            for infos in (pcq.items, pcq.inadmissible):
                for info in infos.values():
                    wl = info.obj
                    key = f"{wl.namespace}/{wl.queue_name}"
                    st = lqs.get(key)
                    if st is not None and \
                            queues.local_queues[key].cluster_queue == cq_name:
                        st.pending_workloads += 1
        workloads = eng.workloads
        for key, info in cache.workloads.items():
            cst = cqs.get(info.cluster_queue)
            wl = workloads.get(key)
            lst = (lqs.get(f"{wl.namespace}/{wl.queue_name}")
                   if lqs and wl is not None else None)
            if cst is None and lst is None:
                continue
            admitted = wl is not None and wl.is_admitted
            usage = info.usage()
            for st in (cst, lst):
                if st is None:
                    continue
                st.reserving_workloads += 1
                st.admitted_workloads += 1 if admitted else 0
                _add(st.flavors_reservation, usage)
                if admitted:
                    _add(st.flavors_usage, usage)
        for name, st in cqs.items():
            if st is None:
                continue
            cq = cache.cluster_queues[name]
            st.active, st.active_reason, st.active_message = active(cq)
            if cq.fair_sharing is not None:
                from kueue_tpu_torch.cache.snapshot import (
                    dominant_resource_share,
                )

                if snap is None:
                    snap = cache.snapshot()
                node = snap.cluster_queues.get(name)
                if node is not None:
                    drs = dominant_resource_share(node, None)
                    # The cluster_queue_weighted_share gauge's formula
                    # (Engine.sync_resource_metrics): the two agree.
                    st.weighted_share = (drs.precise_weighted_share()
                                         if node.fair_weight
                                         else drs.unweighted_ratio)
        return cqs, lqs

    def reconcile_all(self) -> None:
        """Refresh every CQ/LQ status and the status gauges."""
        eng = self.engine
        g = eng.registry.gauge
        g("cluster_queue_status").clear()
        g("local_queue_status").clear()
        # One snapshot shared across every CQ (snapshot construction is
        # the expensive step; N CQs must not cost N snapshots).
        snap = (eng.cache.snapshot()
                if any(cq.fair_sharing is not None for cq in
                       eng.cache.cluster_queues.values())
                else None)
        self.cq_statuses, self.lq_statuses = self._build(
            list(eng.cache.cluster_queues), list(eng.queues.local_queues),
            snap)
        for name, st in self.cq_statuses.items():
            g("cluster_queue_status").set(
                (name, "active" if st.active else "inactive"), 1)
        for key, st in self.lq_statuses.items():
            g("local_queue_status").set(
                (key, "active" if st.active else "inactive"), 1)

    # -- retention sweep (objectRetentionPolicies) --

    def sweep_retention(self) -> list[str]:
        """Delete finished workloads past afterFinished and
        kueue-deactivated ones past afterDeactivatedByKueue
        (workload_controller.go retention handling). Returns deleted
        keys."""
        if self.retention is None:
            return []
        eng = self.engine
        now = eng.clock
        after_finished = self.retention.after_finished
        after_deactivated = self.retention.after_deactivated_by_kueue
        deleted = []
        # One pass over every workload on every tick, as the JAX sweep
        # makes (its cost is in PERF.md section 5); the conditions are
        # read from the map, not through the properties.
        for key, wl in eng.workloads.items():
            if wl.active and after_finished is None:
                continue  # neither policy can take it
            conds = wl.status.conditions
            fin = conds.get(_FINISHED)
            if fin is not None and fin.status:
                if after_finished is not None \
                        and now - fin.last_transition_time >= after_finished:
                    deleted.append(key)
                continue
            if not wl.active and after_deactivated is not None:
                ev = conds.get(_EVICTED)
                if ev and ev.reason in _DEACTIVATION_REASONS \
                        and now - ev.last_transition_time \
                        >= after_deactivated:
                    deleted.append(key)
        for key in deleted:
            wl = eng.workloads.pop(key)
            eng.cache.delete_workload(key)
            eng.queues.delete_workload(wl)
            eng.unadmitted.remove(key)
            eng._evicted_once.discard(wl.uid)
            if eng.journal is not None:
                eng.journal.delete("workload", key, ts=eng.clock)
            eng._event("Deleted", key, detail="retention")
        return deleted
