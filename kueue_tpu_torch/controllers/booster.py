"""Priority booster.

The port of ``kueue_tpu/controllers/booster.py``. Reference:
cmd/experimental/kueue-priority-booster (pkg/controller/controller.go:44):
once a workload has been ADMITTED for timeSharingInterval, set a
NEGATIVE priority boost so same-base-priority pending workloads can
preempt it under withinClusterQueue: LowerPriority (cooperative time
sharing). The boost clears when the workload is no longer admitted (or
leaves scope). ``maxWorkloadPriority`` bounds the scope: higher-priority
workloads are never demoted.

An age-based positive boost for long-PENDING workloads comes with it
(an anti-starvation mode the reference pairs with WorkloadPriorityClass
updates). A boost moves a workload's effective priority, so it moves the
rank the heads kernel reads for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from kueue_tpu_torch.api.types import (
    PRIORITY_BOOST_ANNOTATION,
    WorkloadConditionType,
)


@dataclass
class BoostPolicy:
    # Pending-age anti-starvation boost.
    after_seconds: float = 600.0
    boost_per_interval: int = 1
    interval_seconds: float = 300.0
    max_boost: int = 100


@dataclass
class TimeSharingPolicy:
    """controller.go:60 (PriorityBoostReconcilerOptions)."""

    time_sharing_interval_seconds: float = 3600.0
    negative_boost_value: int = -1
    # Workloads above this base priority are out of scope (never demoted).
    max_workload_priority: Optional[int] = None
    # Selector over workloads; the reserved key "queue" matches
    # queue_name (the reference uses a label selector).
    workload_selector: Optional[dict[str, str]] = None


class PriorityBooster:
    def __init__(self, engine, policy: BoostPolicy = None,
                 time_sharing: Optional[TimeSharingPolicy] = None):
        self.engine = engine
        self.policy = policy or BoostPolicy()
        self.time_sharing = time_sharing

    # -- pending-age anti-starvation boost --

    def reconcile(self) -> int:
        """Boost pending workloads by age; returns number changed."""
        p = self.policy
        now = self.engine.clock
        boosted = 0
        for pcq in self.engine.queues.cluster_queues.values():
            infos = list(pcq.items.values()) + \
                list(pcq.inadmissible.values())
            for info in infos:
                wl = info.obj
                waited = now - wl.creation_time
                if waited < p.after_seconds:
                    continue
                intervals = int((waited - p.after_seconds)
                                // p.interval_seconds) + 1
                boost = min(p.max_boost,
                            intervals * p.boost_per_interval)
                if boost > wl.priority_boost:
                    wl.priority_boost = boost
                    wl.annotations[PRIORITY_BOOST_ANNOTATION] = str(boost)
                    pcq.push_or_update(info)  # re-heapify
                    boosted += 1
        if self.time_sharing is not None:
            boosted += self.reconcile_time_sharing()
        return boosted

    # -- time-sharing negative boost (controller.go:118) --

    def _in_scope(self, wl) -> bool:
        ts = self.time_sharing
        if ts.max_workload_priority is not None \
                and wl.priority > ts.max_workload_priority:
            return False
        if ts.workload_selector:
            if ts.workload_selector.get("queue") not in (
                    None, wl.queue_name):
                return False
        return True

    def reconcile_time_sharing(self) -> int:
        """Demote workloads admitted past the time-sharing interval;
        clear the boost once they stop being admitted (computeBoost +
        clearBoostAnnotationIfPresent)."""
        ts = self.time_sharing
        now = self.engine.clock
        changed = 0
        for wl in self.engine.workloads.values():
            if wl.is_finished:
                continue
            if not wl.is_admitted or not self._in_scope(wl):
                # Out of scope / no longer admitted: a stale demotion is
                # cleared so the requeued workload competes at its base
                # priority (clearBoostAnnotationIfPresent).
                if wl.priority_boost < 0:
                    wl.priority_boost = 0
                    wl.annotations.pop(PRIORITY_BOOST_ANNOTATION, None)
                    if wl.active and not wl.is_admitted \
                            and not wl.is_finished:
                        # Re-heapify: the pending heap key baked in the
                        # demoted priority.
                        self.engine.queues.add_or_update_workload(wl)
                    changed += 1
                continue
            adm = wl.condition(WorkloadConditionType.ADMITTED)
            if adm is None \
                    or now - adm.last_transition_time \
                    < ts.time_sharing_interval_seconds:
                continue
            if wl.priority_boost != ts.negative_boost_value:
                wl.priority_boost = ts.negative_boost_value
                wl.annotations[PRIORITY_BOOST_ANNOTATION] = \
                    str(ts.negative_boost_value)
                self.engine._event("PriorityBoostSet", wl.key,
                                   detail=str(ts.negative_boost_value))
                changed += 1
        return changed
