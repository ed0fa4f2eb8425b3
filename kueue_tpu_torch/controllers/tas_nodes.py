"""TAS node-health controller: detect failed nodes and trigger workload
re-placement.

Reference: pkg/controller/tas/node_controller.go — watches Nodes, and when
one becomes unfit (deleted, NotReady longer than a fixed window, tainted
with NoSchedule/NoExecute, or a workload pod on it terminates — gates
``TASReplaceNodeOnNodeTaints`` / ``TASReplaceNodeOnPodTermination`` /
``TASReplaceNodeNotReadyOverFixedTime``), records the node in the status
of every admitted TAS workload placed on it (``status.unhealthyNodes``,
workload_types.go:766) and pushes those workloads into the second-pass
queue. The scheduler's next pass runs the replacement algorithm
(tas_flavor_snapshot.go:747 findReplacementAssignment); with
``TASFailedNodeReplacementFailFast`` a failed replacement evicts instead
of retrying (scheduler.go:403,804-817).

A copy of ``kueue_tpu/controllers/tas_nodes.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from kueue_tpu_torch.config import features

NOT_READY_REPLACEMENT_WINDOW = 30.0  # nodeReplacementTimeout (seconds)


@dataclass
class _NodeHealth:
    ready: bool = True
    not_ready_since: float = 0.0
    tainted: bool = False


class NodeHealthController:
    """Feeds node failures into Engine.mark_node_unhealthy."""

    def __init__(self, engine):
        self.engine = engine
        self._health: dict[str, _NodeHealth] = {}

    # -- event intake (node_controller.go Reconcile) --

    def node_ready(self, name: str) -> None:
        self._health.pop(name, None)

    def node_not_ready(self, name: str, now: float) -> None:
        h = self._health.setdefault(name, _NodeHealth())
        if h.ready:
            h.ready = False
            h.not_ready_since = now

    def node_tainted(self, name: str) -> None:
        """NoSchedule/NoExecute taint added."""
        h = self._health.setdefault(name, _NodeHealth())
        h.tainted = True
        if features.enabled("TASReplaceNodeOnNodeTaints"):
            self.engine.mark_node_unhealthy(name, reason="NodeTainted")

    def node_deleted(self, name: str) -> None:
        self._health.pop(name, None)
        self.engine.mark_node_unhealthy(name, reason="NodeDeleted")

    def pod_terminated(self, node_name: str) -> None:
        """A workload pod on the node failed (e.g. device fault)."""
        if features.enabled("TASReplaceNodeOnPodTermination"):
            self.engine.mark_node_unhealthy(node_name,
                                            reason="PodTerminated")

    def tick(self, now: float) -> None:
        """NotReady-over-fixed-time detection
        (TASReplaceNodeNotReadyOverFixedTime)."""
        if not features.enabled("TASReplaceNodeNotReadyOverFixedTime"):
            return
        for name, h in list(self._health.items()):
            if not h.ready and \
                    now - h.not_ready_since >= NOT_READY_REPLACEMENT_WINDOW:
                self._health.pop(name, None)
                self.engine.mark_node_unhealthy(name,
                                                reason="NodeNotReady")
