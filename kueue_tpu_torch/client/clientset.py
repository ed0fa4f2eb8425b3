"""Typed clientset over a running engine, ported from
``kueue_tpu/client/clientset.py``.

Mirrors the shape of the reference's generated clientset
(client-go/clientset/versioned/typed/kueue/v1beta2): one typed handle per
kind with Create/Get/List/Delete (+ kind-specific verbs), so integrations
and tooling never reach into engine internals.
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    LocalQueue,
    ResourceFlavor,
    Workload,
)


class _KindClient:
    def __init__(self, engine):
        self._engine = engine


class ClusterQueuesClient(_KindClient):
    def create(self, cq: ClusterQueue) -> ClusterQueue:
        self._engine.create_cluster_queue(cq)
        return cq

    def get(self, name: str) -> Optional[ClusterQueue]:
        return self._engine.cache.cluster_queues.get(name)

    def list(self) -> list[ClusterQueue]:
        return list(self._engine.cache.cluster_queues.values())

    def delete(self, name: str) -> None:
        self._engine.cache.delete_cluster_queue(name)
        self._engine.queues.delete_cluster_queue(name)


class LocalQueuesClient(_KindClient):
    def create(self, lq: LocalQueue) -> LocalQueue:
        self._engine.create_local_queue(lq)
        return lq

    def get(self, namespace: str, name: str) -> Optional[LocalQueue]:
        return self._engine.queues.local_queues.get(
            f"{namespace}/{name}")

    def list(self) -> list[LocalQueue]:
        return list(self._engine.queues.local_queues.values())

    def delete(self, namespace: str, name: str) -> None:
        self._engine.queues.delete_local_queue(f"{namespace}/{name}")


class CohortsClient(_KindClient):
    def create(self, cohort: Cohort) -> Cohort:
        self._engine.create_cohort(cohort)
        return cohort

    def get(self, name: str) -> Optional[Cohort]:
        return self._engine.cache.cohorts.get(name)

    def list(self) -> list[Cohort]:
        return list(self._engine.cache.cohorts.values())

    def delete(self, name: str) -> None:
        self._engine.cache.delete_cohort(name)


class ResourceFlavorsClient(_KindClient):
    def create(self, rf: ResourceFlavor) -> ResourceFlavor:
        self._engine.create_resource_flavor(rf)
        return rf

    def get(self, name: str) -> Optional[ResourceFlavor]:
        return self._engine.cache.resource_flavors.get(name)

    def list(self) -> list[ResourceFlavor]:
        return list(self._engine.cache.resource_flavors.values())


class WorkloadsClient(_KindClient):
    def create(self, wl: Workload) -> Workload:
        self._engine.submit(wl)
        return wl

    def get(self, namespace: str, name: str) -> Optional[Workload]:
        return self._engine.workloads.get(f"{namespace}/{name}")

    def list(self, namespace: Optional[str] = None) -> list[Workload]:
        out = list(self._engine.workloads.values())
        if namespace is not None:
            out = [w for w in out if w.namespace == namespace]
        return out

    def finish(self, namespace: str, name: str) -> None:
        self._engine.finish(f"{namespace}/{name}")

    def evict(self, namespace: str, name: str,
              reason: str = "Evicted") -> None:
        wl = self.get(namespace, name)
        if wl is not None:
            self._engine.evict(wl, reason)


class KueueClient:
    """client-go `Clientset` analog: `client.cluster_queues().list()`,
    `client.workloads().create(wl)`, ..."""

    def __init__(self, engine):
        self._engine = engine
        self._cqs = ClusterQueuesClient(engine)
        self._lqs = LocalQueuesClient(engine)
        self._cohorts = CohortsClient(engine)
        self._rfs = ResourceFlavorsClient(engine)
        self._wls = WorkloadsClient(engine)

    def cluster_queues(self) -> ClusterQueuesClient:
        return self._cqs

    def local_queues(self) -> LocalQueuesClient:
        return self._lqs

    def cohorts(self) -> CohortsClient:
        return self._cohorts

    def resource_flavors(self) -> ResourceFlavorsClient:
        return self._rfs

    def workloads(self) -> WorkloadsClient:
        return self._wls
