"""The listing half of ``kueue_tpu/cli/kueuectl.py`` (cmd/kueuectl
list clusterqueues / workloads): what the serving endpoint's GET
``/clusterqueues`` and ``/workloads`` return. The rest of the CLI is not
ported.
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api.types import StopPolicy


class Kueuectl:
    def __init__(self, engine):
        self.engine = engine

    def list_cluster_queues(self) -> list[dict]:
        out = []
        for name, cq in sorted(self.engine.cache.cluster_queues.items()):
            pcq = self.engine.queues.cluster_queues.get(name)
            out.append({
                "name": name,
                "cohort": cq.cohort or "",
                "pending": pcq.pending() if pcq else 0,
                "admitted": self.engine.cache.admitted_count(name),
                "active": cq.stop_policy == StopPolicy.NONE,
            })
        return out

    def list_workloads(self, namespace: Optional[str] = None) -> list[dict]:
        out = []
        for key, wl in sorted(self.engine.workloads.items()):
            if namespace and wl.namespace != namespace:
                continue
            status = "Pending"
            if wl.is_finished:
                status = "Finished"
            elif wl.is_admitted:
                status = "Admitted"
            elif wl.has_quota_reservation:
                status = "QuotaReserved"
            elif wl.is_evicted:
                status = "Evicted"
            out.append({
                "name": wl.name, "namespace": wl.namespace,
                "queue": wl.queue_name, "priority": wl.effective_priority,
                "status": status, "active": wl.active,
            })
        return out
