"""Admission fair sharing (AFS): order workloads *within* a ClusterQueue
by their LocalQueue's exponentially-decayed historical usage, with
penalties applied at admission time.

Reference: pkg/util/admissionfairsharing + the queue-cache hooks
(pkg/cache/queue/manager.go:68, cluster_queue.go:208-218) and the
scheduler integration (scheduler.go:308-311,897,930).

A copy of ``kueue_tpu/controllers/afs.py``. Reading a LocalQueue's usage
decays it in place, so the engine reads it only where the JAX engine
does: at push (``cache/queues.PendingClusterQueue._key``) and at
admission (``_on_admit``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from kueue_tpu_torch.api.types import Workload
from kueue_tpu_torch.config.api import AdmissionFairSharingConfig


@dataclass
class _LqUsage:
    value: float = 0.0
    last_update: float = 0.0


class AfsManager:
    """Per-LocalQueue decayed usage + admission penalties."""

    def __init__(self, engine, config: AdmissionFairSharingConfig = None):
        self.engine = engine
        self.config = config or AdmissionFairSharingConfig()
        self.usage: dict[str, _LqUsage] = {}  # lq key -> usage
        engine.afs = self
        # order within CQ by LQ usage (manager.go:68 hooks)
        engine.queues.lq_usage_fn = self.current_usage
        prev = engine.on_admit
        engine.on_admit = self._chain(prev, self._on_admit)

    @staticmethod
    def _chain(prev, new):
        if prev is None:
            return new

        def both(*a, **k):
            prev(*a, **k)
            new(*a, **k)
        return both

    def _decay(self, entry: _LqUsage, now: float) -> None:
        half_life = self.config.usage_half_life_seconds
        if half_life <= 0 or now <= entry.last_update:
            return
        dt = now - entry.last_update
        entry.value *= math.pow(0.5, dt / half_life)
        entry.last_update = now

    def current_usage(self, lq_key: str) -> float:
        entry = self.usage.get(lq_key)
        if entry is None:
            return 0.0
        self._decay(entry, self.engine.clock)
        return entry.value

    def _workload_weight(self, wl: Workload) -> float:
        total = 0.0
        for ps in wl.pod_sets:
            for res, q in ps.requests.items():
                w = self.config.resource_weights.get(res, 1.0)
                total += w * q * ps.count
        return total

    def _on_admit(self, wl: Workload, admission) -> None:
        """Entry penalty at admission (cluster_queue.go:208-218)."""
        lq_key = f"{wl.namespace}/{wl.queue_name}"
        entry = self.usage.setdefault(
            lq_key, _LqUsage(last_update=self.engine.clock))
        self._decay(entry, self.engine.clock)
        entry.value += self._workload_weight(wl)
