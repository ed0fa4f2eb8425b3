"""Generated-lister analog: read-only, indexed, label-selectable views.

Reference: client-go/listers/kueue/v1beta2 — for every kind a
``<Kind>Lister`` with ``List(selector)`` / ``Get(name)`` plus
namespace-scoped sub-listers, all backed by the informer's indexed
store. Here the store is the engine's live state; each lister keeps the
same read-only contract (callers get snapshots, never engine internals)
and adds the indices kueue's controllers actually query: workloads by
ClusterQueue / LocalQueue / phase / namespace, ClusterQueues by cohort,
LocalQueues by ClusterQueue.

Label selection follows metav1.LabelSelector: ``match_labels`` equality
plus ``match_expressions`` with In / NotIn / Exists / DoesNotExist
operators.

Each index scans every workload of the engine per call, as the JAX
listers do (``by_cluster_queue`` looks up each workload's LocalQueue):
at 50,000 workloads a call visits 50,000 rows, so a caller asks a few
queues, never all of them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = ["LabelSelector", "Requirement", "WorkloadLister",
           "ClusterQueueLister", "LocalQueueLister", "Listers"]


@dataclass(frozen=True)
class Requirement:
    """metav1.LabelSelectorRequirement."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: tuple = ()

    def matches(self, labels: dict) -> bool:
        present = self.key in labels
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator == "In":
            return present and labels[self.key] in self.values
        if self.operator == "NotIn":
            return not present or labels[self.key] not in self.values
        raise ValueError(f"unknown operator {self.operator!r}")


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector; empty selects everything."""

    match_labels: tuple = ()  # ((key, value), ...)
    match_expressions: tuple = ()  # (Requirement, ...)

    @classmethod
    def of(cls, match_labels: Optional[dict] = None,
           match_expressions=()) -> "LabelSelector":
        return cls(tuple(sorted((match_labels or {}).items())),
                   tuple(match_expressions))

    def matches(self, labels: Optional[dict]) -> bool:
        labels = labels or {}
        return all(labels.get(k) == v for k, v in self.match_labels) \
            and all(r.matches(labels) for r in self.match_expressions)


_EVERYTHING = LabelSelector()


def _labels_of(obj) -> dict:
    return getattr(obj, "labels", None) or {}


class WorkloadLister:
    """WorkloadLister + WorkloadNamespaceLister, with the by-CQ /
    by-queue / by-phase indices the scheduler and visibility layers
    use (cache indexer keys)."""

    def __init__(self, engine):
        self._engine = engine

    def get(self, namespace: str, name: str):
        return self._engine.workloads.get(f"{namespace}/{name}")

    def list(self, selector: LabelSelector = _EVERYTHING,
             namespace: Optional[str] = None) -> list:
        out = []
        for wl in self._engine.workloads.values():
            if namespace is not None and wl.namespace != namespace:
                continue
            if selector.matches(_labels_of(wl)):
                out.append(wl)
        return out

    def namespaced(self, namespace: str) -> "_NamespacedWorkloads":
        return _NamespacedWorkloads(self, namespace)

    # -- indices --

    def by_cluster_queue(self, cq_name: str) -> list:
        out = []
        for wl in self._engine.workloads.values():
            lq = self._engine.queues.local_queues.get(
                f"{wl.namespace}/{wl.queue_name}")
            if lq is not None and lq.cluster_queue == cq_name:
                out.append(wl)
        return out

    def by_local_queue(self, namespace: str, queue_name: str) -> list:
        return [wl for wl in self._engine.workloads.values()
                if wl.namespace == namespace
                and wl.queue_name == queue_name]

    def by_phase(self, phase: str) -> list:
        """Pending | Admitted | Finished."""
        out = []
        for wl in self._engine.workloads.values():
            if wl.is_finished:
                p = "Finished"
            elif wl.is_admitted:
                p = "Admitted"
            else:
                p = "Pending"
            if p == phase:
                out.append(wl)
        return out


@dataclass
class _NamespacedWorkloads:
    lister: WorkloadLister
    namespace: str

    def get(self, name: str):
        return self.lister.get(self.namespace, name)

    def list(self, selector: LabelSelector = _EVERYTHING) -> list:
        return self.lister.list(selector, namespace=self.namespace)


class ClusterQueueLister:
    def __init__(self, engine):
        self._engine = engine

    def get(self, name: str):
        return self._engine.cache.cluster_queues.get(name)

    def list(self, selector: LabelSelector = _EVERYTHING) -> list:
        return [cq for cq in self._engine.cache.cluster_queues.values()
                if selector.matches(_labels_of(cq))]

    def by_cohort(self, cohort: str) -> list:
        return [cq for cq in self._engine.cache.cluster_queues.values()
                if cq.cohort == cohort]


class LocalQueueLister:
    def __init__(self, engine):
        self._engine = engine

    def get(self, namespace: str, name: str):
        return self._engine.queues.local_queues.get(
            f"{namespace}/{name}")

    def list(self, selector: LabelSelector = _EVERYTHING,
             namespace: Optional[str] = None) -> list:
        out = []
        for lq in self._engine.queues.local_queues.values():
            if namespace is not None and lq.namespace != namespace:
                continue
            if selector.matches(_labels_of(lq)):
                out.append(lq)
        return out

    def by_cluster_queue(self, cq_name: str) -> list:
        return [lq for lq in self._engine.queues.local_queues.values()
                if lq.cluster_queue == cq_name]


@dataclass
class Listers:
    """The listers bundle a controller receives (client-go's
    ``kueueinformers.Interface`` lister accessors)."""

    engine: object
    workloads: WorkloadLister = field(init=False)
    cluster_queues: ClusterQueueLister = field(init=False)
    local_queues: LocalQueueLister = field(init=False)

    def __post_init__(self):
        self.workloads = WorkloadLister(self.engine)
        self.cluster_queues = ClusterQueueLister(self.engine)
        self.local_queues = LocalQueueLister(self.engine)
