"""Failure detection and recovery.

The port of ``kueue_tpu/controllers/failurerecovery.py``, over the
engine's ``mark_node_unhealthy`` (the Replace action's second pass) and
the cache's ``set_node_ready``. Reference:
pkg/controller/tas/node_controller.go (unhealthy-node detection),
workload unhealthyNodes status (workload_types.go:766), fail-fast
eviction (scheduler.go:403,804-817), and the FailureRecoveryPolicy
controller (pkg/controller/failurerecovery): on node failure,
reschedule affected workloads to a replacement domain or a different
flavor (a different cluster under MultiKueue, controllers/multikueue.py).

Workloads with placements on a failed node are replaced in place
(Replace) or evicted and requeued (Requeue), where the scheduler finds a
new placement, possibly on another flavor.
"""

from __future__ import annotations

from dataclasses import dataclass

from kueue_tpu_torch.api.types import WorkloadConditionType
from kueue_tpu_torch.config import features
from kueue_tpu_torch.tas.snapshot import HOSTNAME_LABEL


@dataclass
class FailureRecoveryPolicy:
    """FailureRecoveryPolicy CRD equivalent.

    Actions:
      * "Replace" — in-place TAS node replacement first
        (tas_flavor_snapshot.go:747 via the engine's second pass);
        pods on healthy nodes keep running. Falls back to the
        second-pass retry/evict semantics when no replacement exists.
      * "Requeue" — evict affected workloads immediately; the
        scheduler's next pass finds a new placement (possibly another
        flavor, or another cluster under MultiKueue).
    ``max_failures`` bounds per-workload churn: a workload evicted for
    node failures more than this many times is deactivated
    (fail-fast, scheduler.go:804-817)."""

    name: str = "default"
    action: str = "Replace"
    max_failures: int = 0  # 0 = unbounded


class FailureRecoveryController:
    def __init__(self, engine, policy: FailureRecoveryPolicy = None):
        self.engine = engine
        self.policy = policy or FailureRecoveryPolicy()
        self.unhealthy_nodes: set[str] = set()
        self.failure_counts: dict[str, int] = {}

    def node_failed(self, node_name: str) -> list[str]:
        """Node health event (tas/node_controller.go). Returns affected
        workload keys. Gated: kube_features.go FailureRecoveryPolicy."""
        if not features.enabled("FailureRecoveryPolicy"):
            return []
        self.unhealthy_nodes.add(node_name)
        self.engine.cache.set_node_ready(node_name, False)
        affected = self._workloads_on_node(node_name)
        over_limit = []
        for key in affected:
            self.failure_counts[key] = self.failure_counts.get(key, 0) + 1
            if self.policy.max_failures \
                    and self.failure_counts[key] > self.policy.max_failures:
                over_limit.append(key)
        if self.policy.action == "Replace":
            # In-place replacement path: annotate unhealthyNodes + arm
            # the second pass (engine.mark_node_unhealthy); keeps healthy
            # pods running while only the failed domains re-place.
            self.engine.mark_node_unhealthy(node_name, reason="NodeFailure")
        else:
            for key in affected:
                if key in over_limit:
                    continue  # deactivated below, under the right reason
                wl = self.engine.workloads.get(key)
                if wl is None or wl.is_finished:
                    continue
                wl.set_condition(WorkloadConditionType.EVICTED, False,
                                 reason="", now=self.engine.clock)
                self.engine.evict(wl, "NodeFailure")
        # Fail-fast deactivation for churners (scheduler.go:804-817).
        for key in over_limit:
            wl = self.engine.workloads.get(key)
            if wl is None or wl.is_finished:
                continue
            wl.active = False
            if wl.status.admission is not None or wl.has_quota_reservation:
                self.engine.evict(wl, "NodeFailureLimitExceeded",
                                  requeue=False)
            else:
                self.engine.queues.delete_workload(wl)
        self.engine.queues.queue_inadmissible_workloads()
        return affected

    def node_recovered(self, node_name: str) -> None:
        self.unhealthy_nodes.discard(node_name)
        self.engine.cache.set_node_ready(node_name, True)
        self.engine.queues.queue_inadmissible_workloads()

    def _workloads_on_node(self, node_name: str) -> list[str]:
        """Workloads whose topology assignment lands on the node (matched
        by the hostname level value)."""
        affected = []
        for key, info in list(self.engine.cache.workloads.items()):
            wl = self.engine.workloads.get(key)
            if wl is None or wl.status.admission is None:
                continue
            for psa in wl.status.admission.pod_set_assignments:
                ta = psa.topology_assignment
                if ta is None:
                    continue
                if HOSTNAME_LABEL not in ta.levels:
                    continue
                idx = list(ta.levels).index(HOSTNAME_LABEL)
                if any(d.values[idx] == node_name for d in ta.domains):
                    affected.append(key)
                    break
        return affected
