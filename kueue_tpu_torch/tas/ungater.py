"""Topology ungater: hand each gated pod its topology domain.

Reference: pkg/controller/tas/topology_ungater.go. Once a workload has a
TopologyAssignment, its pods start gated (the jobframework injects the
``kueue.x-k8s.io/topology`` scheduling gate); the ungater removes the
gate and pins each pod to one domain — by rank when the pod set carries a
pod-index label (readRanksIfAvailable :446, rankToDomainID expansion), or
greedily by filling domains in assignment order while accounting for
already-running pods (assignGatedPodsToDomainsGreedy :403).

In our standalone framework a "pod" is the light record below; the engine
uses this to drive per-pod placement for the execution mimic and tests.

A copy of ``kueue_tpu/tas/ungater.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.tas.snapshot import TopologyAssignment

TOPOLOGY_GATE = "kueue.x-k8s.io/topology"


@dataclass
class PodStub:
    """The slice of corev1.Pod the ungater needs."""

    name: str
    labels: dict[str, str] = field(default_factory=dict)
    gated: bool = True
    # Domain values already pinned on ungated pods (node selector).
    domain_values: Optional[tuple[str, ...]] = None


def rank_to_domain(assignment: TopologyAssignment) -> list[tuple[str, ...]]:
    """rankToDomainID: expand the assignment into a rank-indexed list of
    domains (domains in assignment order, each repeated ``count`` times)."""
    out: list[tuple[str, ...]] = []
    for dom in assignment.domains:
        out.extend([tuple(dom.values)] * dom.count)
    return out


def assign_pods_to_domains(
    assignment: TopologyAssignment,
    pods: list[PodStub],
    pod_index_label: Optional[str] = None,
    offset: int = 0,
) -> list[tuple[PodStub, tuple[str, ...]]]:
    """assignGatedPodsToDomains :376: rank-based placement when every
    gated pod carries a valid in-range index label, greedy otherwise.
    Returns (pod, domain_values) for the pods to ungate."""
    ranks = rank_to_domain(assignment)
    max_rank = len(ranks)
    if pod_index_label is not None:
        by_rank: dict[int, PodStub] = {}
        ok = True
        for pod in pods:
            if not pod.gated:
                continue
            raw = pod.labels.get(pod_index_label)
            if raw is None or not raw.isdigit():
                ok = False
                break
            rank = int(raw) - offset
            if not (0 <= rank < max_rank) or rank in by_rank:
                ok = False
                break
            by_rank[rank] = pod
        if ok:
            return [(pod, ranks[rank])
                    for rank, pod in sorted(by_rank.items())]
    return _assign_greedy(assignment, pods)


def _assign_greedy(assignment: TopologyAssignment, pods: list[PodStub]
                   ) -> list[tuple[PodStub, tuple[str, ...]]]:
    """assignGatedPodsToDomainsGreedy :403: fill each domain up to its
    count, skipping capacity already taken by ungated pods."""
    gated = [p for p in pods if p.gated]
    ungated_per_domain: dict[tuple, int] = {}
    for p in pods:
        if not p.gated and p.domain_values is not None:
            ungated_per_domain[tuple(p.domain_values)] = \
                ungated_per_domain.get(tuple(p.domain_values), 0) + 1
    out: list[tuple[PodStub, tuple[str, ...]]] = []
    for dom in assignment.domains:
        already = ungated_per_domain.get(tuple(dom.values), 0)
        room = max(dom.count - already, 0)
        take = min(room, len(gated) - len(out))
        for _ in range(take):
            out.append((gated[len(out)], tuple(dom.values)))
    return out
