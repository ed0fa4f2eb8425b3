"""Populator: auto-create LocalQueues in namespaces matching a
ClusterQueue's namespace selector, over the engine's
``namespace_labels``.

The port of ``kueue_tpu/controllers/populator.py``. Reference:
cmd/experimental/kueue-populator (pkg/controller/controller.go:108
Reconcile, :218 ensureLocalQueueExists): for every
(ClusterQueue, matching namespace) pair, ensure a LocalQueue exists,
named either a fixed name (LocalQueueNameModeFixed, default "default")
or after the ClusterQueue (LocalQueueNameModeAsClusterQueue)."""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api.types import LocalQueue

NAME_MODE_FIXED = "Fixed"
NAME_MODE_AS_CLUSTER_QUEUE = "AsClusterQueue"


class PopulatorController:
    def __init__(self, engine, local_queue_name: str = "default",
                 name_mode: str = NAME_MODE_FIXED,
                 namespace_selector: Optional[dict[str, str]] = None):
        self.engine = engine
        self.local_queue_name = local_queue_name
        self.name_mode = name_mode
        # Populator-level selector intersected with each CQ's own.
        self.namespace_selector = namespace_selector
        self.created: list[str] = []

    def _matches(self, selector: Optional[dict[str, str]],
                 labels: dict[str, str]) -> bool:
        if selector is None:
            return True
        return all(labels.get(k) == v for k, v in selector.items())

    def reconcile(self) -> list[str]:
        """One pass over (CQ, namespace) pairs (controller.go:108).
        Returns the LocalQueue keys created this pass."""
        eng = self.engine
        created = []
        for cq in eng.cache.cluster_queues.values():
            for namespace, labels in eng.namespace_labels.items():
                if not self._matches(self.namespace_selector, labels):
                    continue
                if not self._matches(cq.namespace_selector, labels):
                    continue
                name = (cq.name if self.name_mode
                        == NAME_MODE_AS_CLUSTER_QUEUE
                        else self.local_queue_name)
                key = f"{namespace}/{name}"
                if key in eng.queues.local_queues:
                    continue
                eng.create_local_queue(LocalQueue(
                    name=name, namespace=namespace,
                    cluster_queue=cq.name))
                created.append(key)
        self.created.extend(created)
        return created
