"""WaitForPodsReady: gate admissions on previously admitted workloads
becoming ready, evict not-ready workloads after a timeout with exponential
requeue backoff, deactivate after too many requeues.

The port of ``kueue_tpu/controllers/podsready.py``. Reference: cache
WaitForPodsReady tracking (pkg/cache/scheduler/cache.go:199-246), the
not-ready timeout eviction and requeuingBackoff
(core/workload_controller.go:1161-1214), and the scheduler's
waitForPodsReadyIfBlocked (scheduler.go:535). The engine holds every
head while ``admission_blocked()`` (``Engine.schedule_once``), and the
oracle bridge leaves such a cycle to the host path.
"""

from __future__ import annotations

from kueue_tpu_torch.api.types import WorkloadConditionType
from kueue_tpu_torch.config import features
from kueue_tpu_torch.config.api import WaitForPodsReady


class PodsReadyManager:
    def __init__(self, engine, config: WaitForPodsReady):
        self.engine = engine
        self.config = config
        engine.pods_ready = self

    def mark_pods_ready(self, wl_key: str) -> None:
        """The job-side signal (PodsReady condition)."""
        wl = self.engine.workloads.get(wl_key)
        if wl is None or not wl.is_admitted:
            return
        adm = wl.condition(WorkloadConditionType.ADMITTED)
        wl.set_condition(WorkloadConditionType.PODS_READY, True,
                         reason="PodsReady", now=self.engine.clock)
        if adm is not None:
            self.engine.registry.counter(
                "ready_wait_time_seconds_total").inc(
                (), max(0.0, self.engine.clock - adm.last_transition_time))

    def all_admitted_ready(self) -> bool:
        """cache.PodsReadyForAllAdmittedWorkloads (cache.go:199)."""
        for key in self.engine.cache.workloads:
            wl = self.engine.workloads.get(key)
            if wl is None or not wl.is_admitted:
                continue
            if not wl.has_condition(WorkloadConditionType.PODS_READY):
                return False
        return True

    def _active(self) -> bool:
        """kube_features.go DisableWaitForPodsReady: an emergency
        off-switch over the config's enable flag."""
        return (self.config.enable
                and not features.enabled("DisableWaitForPodsReady"))

    def admission_blocked(self) -> bool:
        """scheduler.go:535: with blockAdmission, one not-ready admitted
        workload blocks further admissions."""
        return (self._active() and self.config.block_admission
                and not self.all_admitted_ready())

    def backoff_seconds(self, requeue_count: int) -> float:
        """Exponential requeue backoff
        (workload_controller.go requeuingBackoff)."""
        base = self.config.requeuing_backoff_base_seconds
        return min(float(base) * (2 ** max(0, requeue_count - 1)),
                   float(self.config.requeuing_backoff_max_seconds))

    def reconcile(self) -> None:
        """The not-ready timeout pass (workload_controller.go:1161)."""
        if not self._active():
            return
        now = self.engine.clock
        for key in list(self.engine.cache.workloads):
            wl = self.engine.workloads.get(key)
            if wl is None or not wl.is_admitted or wl.is_finished:
                continue
            if wl.has_condition(WorkloadConditionType.PODS_READY):
                continue
            adm = wl.condition(WorkloadConditionType.ADMITTED)
            if adm is None:
                continue
            if now - adm.last_transition_time <= self.config.timeout_seconds:
                continue
            limit = self.config.requeuing_backoff_limit_count
            if (limit is not None
                    and wl.status.requeue_count >= limit):
                # Deactivate after N requeues (:1214).
                wl.active = False
                self.engine.evict(wl, "RequeuingLimitExceeded",
                                  requeue=False)
                continue
            backoff = self.backoff_seconds(wl.status.requeue_count + 1)
            self.engine.evict(wl, "PodsReadyTimeout",
                              backoff_seconds=backoff)
