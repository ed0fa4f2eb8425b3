"""Scheduling-equivalence hashing, from ``kueue_tpu/cache/queues.py``."""

from __future__ import annotations

from kueue_tpu_torch.api.types import Workload


def scheduling_hash(wl: Workload, cluster_queue: str) -> tuple:
    """Workloads with equal shape share admission outcomes within a
    cycle (a NoFit verdict parks all of them)."""
    return (
        cluster_queue,
        wl.priority,
        wl.allowed_resource_flavor,
        wl.has_closed_preemption_gate(),
        tuple(sorted(wl.status.reclaimable_pods.items())),
        tuple(sorted(
            (ps.name, ps.count, tuple(sorted(ps.requests.items())),
             tuple(sorted(ps.node_selector.items())),
             ps.node_affinity,
             ps.min_count,
             (ps.topology_request.mode.value
              if ps.topology_request.mode is not None else None,
              ps.topology_request.level,
              ps.topology_request.slice_level,
              ps.topology_request.slice_size,
              ps.topology_request.pod_set_group_name)
             if ps.topology_request is not None else None,
             ps.tolerations)
            for ps in wl.pod_sets)),
    )
