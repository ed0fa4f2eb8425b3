"""Per-reason unadmitted-workload bookkeeping.

A copy of ``kueue_tpu/cache/unadmitted.py``. Reference:
pkg/cache/queue/unadmitted_workloads.go — every unadmitted workload
carries a (ClusterQueue, LocalQueue, Reason, UnderlyingCause) status;
per-CQ and per-LQ aggregates feed the ``unadmitted_workloads`` gauges.
Transitions (reason changed, admitted, removed) adjust the
aggregate counters incrementally, never by rescanning.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class UnadmittedStatus:
    """unadmitted_workloads.go:35 (unadmittedWorkloadStatus)."""

    cluster_queue: str
    local_queue: str
    namespace: str
    reason: str
    cause: str = ""

    def cq_key(self) -> tuple:
        return (self.cluster_queue, self.reason, self.cause)

    def lq_key(self) -> tuple:
        return (f"{self.namespace}/{self.local_queue}", self.reason,
                self.cause)


class UnadmittedWorkloads:
    """unadmitted_workloads.go:59 (unadmittedWorkloads)."""

    def __init__(self, registry=None):
        self.statuses: dict[str, UnadmittedStatus] = {}
        self.per_cq: dict[tuple, int] = {}
        self.per_lq: dict[tuple, int] = {}
        self.registry = registry

    def update(self, wl_key: str, status: UnadmittedStatus) -> None:
        """A workload became (or stays) unadmitted with this reason."""
        prev = self.statuses.get(wl_key)
        if prev == status:
            return
        if prev is not None:
            self._adjust(prev, -1)
        self.statuses[wl_key] = status
        self._adjust(status, +1)

    def remove(self, wl_key: str) -> None:
        """Admitted, finished, or deleted: drop from the aggregates."""
        prev = self.statuses.pop(wl_key, None)
        if prev is not None:
            self._adjust(prev, -1)

    def remove_many(self, wl_keys) -> None:
        """Bulk removal with one gauge write per touched series (the
        serving cycle's whole admitted batch in one pass)."""
        cq_delta: dict[tuple, int] = {}
        lq_delta: dict[tuple, int] = {}
        for key in wl_keys:
            prev = self.statuses.pop(key, None)
            if prev is None:
                continue
            ck, lk = prev.cq_key(), prev.lq_key()
            cq_delta[ck] = cq_delta.get(ck, 0) - 1
            lq_delta[lk] = lq_delta.get(lk, 0) - 1
        gauges_on = self._gauges_on()
        for table, deltas, gauge in (
                (self.per_cq, cq_delta, "unadmitted_workloads"),
                (self.per_lq, lq_delta, "local_queue_unadmitted_workloads")):
            gauge_values = (self.registry.gauge(gauge).values
                            if gauges_on else None)
            for key, delta in deltas.items():
                value = table.get(key, 0) + delta
                if value <= 0:
                    table.pop(key, None)
                    value = 0
                else:
                    table[key] = value
                if gauge_values is not None:
                    gauge_values[key] = value

    def _gauges_on(self) -> bool:
        """kube_features.go UnadmittedWorkloadsObservability: the
        per-reason gauge families are gated; the status bookkeeping
        itself always runs (conditions/visibility depend on it)."""
        from kueue_tpu_torch.config import features
        return (self.registry is not None
                and features.enabled("UnadmittedWorkloadsObservability"))

    def _adjust(self, status: UnadmittedStatus, delta: int) -> None:
        for table, key, gauge in (
                (self.per_cq, status.cq_key(), "unadmitted_workloads"),
                (self.per_lq, status.lq_key(),
                 "local_queue_unadmitted_workloads")):
            value = table.get(key, 0) + delta
            if value <= 0:
                table.pop(key, None)
                value = 0
            else:
                table[key] = value
            if self._gauges_on():
                self.registry.gauge(gauge).set(key, value)

    def count_for_cq(self, cq: str, reason: str = None) -> int:
        return sum(v for (c, r, _), v in self.per_cq.items()
                   if c == cq and (reason is None or r == reason))
