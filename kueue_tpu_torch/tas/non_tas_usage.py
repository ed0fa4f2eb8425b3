"""Non-TAS pod usage accounting for TAS capacity trees.

Reference: pkg/cache/scheduler/tas_non_tas_pod_cache.go (nonTasUsageCache —
per-pod usage entries plus pre-aggregated per-node totals, kept incrementally
to avoid the hot-path scan documented in kueue#8449) and
pkg/controller/tas/non_tas_usage_controller.go (the pod watch that feeds it:
only scheduled, non-terminated pods NOT managed by TAS belong in the cache;
deletes are idempotent so a missed Running→Terminated update still removes
usage).

TAS-managed pods are excluded because their usage is already accounted at
workload granularity through the scheduler cache; everything else running on
a topology-labeled node eats into the node's free capacity that
``TASFlavorSnapshot.add_node`` exposes to the placement algorithm.

A copy of ``kueue_tpu/tas/non_tas_usage.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_tpu_torch.tas.ungater import TOPOLOGY_GATE

PODS_RESOURCE = "pods"


@dataclass
class PodUsage:
    """The slice of corev1.Pod the accounting needs (we are standalone)."""

    namespace: str
    name: str
    node_name: str = ""
    requests: dict[str, int] = field(default_factory=dict)  # milli-units
    terminated: bool = False  # phase Succeeded/Failed
    scheduling_gates: tuple[str, ...] = ()
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_tas(self) -> bool:
        """utiltas.IsTAS: the pod is managed by topology-aware scheduling —
        it carries the topology scheduling gate or a TAS domain label."""
        if TOPOLOGY_GATE in self.scheduling_gates:
            return True
        return any(k.startswith("kueue.x-k8s.io/tas")
                   or k == "kueue.x-k8s.io/podset"
                   for k in self.labels)


def belongs_to_cache(pod: PodUsage) -> bool:
    """non_tas_usage_controller.go belongsToNonTASCache: scheduled,
    non-terminated, not TAS-managed."""
    if pod.is_tas():
        return False
    if not pod.node_name:
        return False  # unscheduled pods use no capacity
    if pod.terminated:
        return False
    return True


class NonTASUsageCache:
    """tas_non_tas_pod_cache.go nonTasUsageCache."""

    def __init__(self) -> None:
        self._pod_usage: dict[str, tuple[str, dict[str, int]]] = {}
        self._node_usage: dict[str, dict[str, int]] = {}
        # Bumped whenever any node total changes; lets the scheduler
        # cache invalidate its TAS forest prototypes only when needed.
        self.version = 0

    # -- mutation (update/delete under the controller's event stream) --

    def update(self, pod: PodUsage) -> None:
        """May add a pod to the cache, or delete a terminated pod; an
        existing entry is replaced (handles node migration / in-place
        resource resize)."""
        if pod.terminated:
            self.delete(pod.key)
            return
        old = self._pod_usage.get(pod.key)
        requests = dict(pod.requests)
        if old == (pod.node_name, requests):
            return  # resync of an unchanged pod: totals did not move
        if old is not None:
            del self._pod_usage[pod.key]
            self._remove_node_usage(*old)
        self._pod_usage[pod.key] = (pod.node_name, requests)
        self._add_node_usage(pod.node_name, requests)
        self.version += 1

    def delete(self, key: str) -> None:
        old = self._pod_usage.pop(key, None)
        if old is None:
            return
        self._remove_node_usage(*old)
        self.version += 1

    # -- read side --

    def node_usage(self, node: str) -> dict[str, int]:
        """Pre-aggregated totals for one node (incl. a ``pods`` count)."""
        return self._node_usage.get(node, {})

    def nodes(self) -> dict[str, dict[str, int]]:
        return self._node_usage

    def __len__(self) -> int:
        return len(self._pod_usage)

    # -- internals --

    def _add_node_usage(self, node: str, usage: dict[str, int]) -> None:
        totals = self._node_usage.setdefault(node, {})
        for res, v in usage.items():
            totals[res] = totals.get(res, 0) + v
        totals[PODS_RESOURCE] = totals.get(PODS_RESOURCE, 0) + 1

    def _remove_node_usage(self, node: str, usage: dict[str, int]) -> None:
        totals = self._node_usage.get(node)
        if totals is None:
            return
        for res, v in usage.items():
            totals[res] = totals.get(res, 0) - v
        totals[PODS_RESOURCE] = totals.get(PODS_RESOURCE, 0) - 1
        if totals[PODS_RESOURCE] <= 0:
            del self._node_usage[node]


class NonTASUsageController:
    """non_tas_usage_controller.go NonTasUsageReconciler: routes pod
    events into the cache and invalidates the owning scheduler cache's
    TAS prototypes when totals move."""

    def __init__(self, cache) -> None:
        # ``cache`` is the scheduler Cache owning a NonTASUsageCache.
        self.cache = cache

    def pod_event(self, pod: PodUsage) -> bool:
        """Create/Update events: reconcile the single pod. Returns True
        when node totals moved (TAS prototypes were invalidated)."""
        before = self.cache.non_tas_usage.version
        if belongs_to_cache(pod):
            self.cache.non_tas_usage.update(pod)
        else:
            self.cache.non_tas_usage.delete(pod.key)
        changed = self.cache.non_tas_usage.version != before
        if changed:
            self.cache._invalidate_tas_prototypes()
        return changed

    def pod_deleted(self, namespace: str, name: str) -> bool:
        """Delete events are not filtered on terminal phase: a missed
        Running→Terminated update must still remove usage (idempotent)."""
        before = self.cache.non_tas_usage.version
        self.cache.non_tas_usage.delete(f"{namespace}/{name}")
        changed = self.cache.non_tas_usage.version != before
        if changed:
            self.cache._invalidate_tas_prototypes()
        return changed
