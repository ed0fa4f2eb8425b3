"""Topology-aware scheduling (TAS): the flavor's topology forest.

A trimmed copy of ``kueue_tpu/tas/snapshot.py`` (the reference's
pkg/cache/scheduler/tas_flavor_snapshot.go): the forest of topology
domains with per-leaf capacity and TAS usage, request resolution, node
matching (taints, selectors, affinity) and the not-fit messages. The
placement itself runs on the device (``tas/device.try_find`` ->
``ops/tas.tas_place``); the sequential host descent stays in the JAX
package as the oracle and is not copied. Requests the device program does
not take (leaders, elastic slices, balanced placement, multi-layer
slices, BestFit-unconstrained) raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import (
    PodSet,
    Taint,
    Toleration,
    Topology,
    TopologyMode,
)
from kueue_tpu_torch.config import features
from kueue_tpu_torch.device import resolve_device

HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclass
class Node:
    """A capacity-bearing leaf. ``capacity`` is per-resource
    milli-units."""

    name: str
    labels: dict[str, str] = field(default_factory=dict)
    capacity: dict[str, int] = field(default_factory=dict)
    taints: tuple[Taint, ...] = ()
    ready: bool = True
    # Cordoned nodes are left out of the forest like not-ready ones.
    unschedulable: bool = False


@dataclass
class TopologyDomainAssignment:
    values: tuple[str, ...]  # level values root->leaf
    count: int


@dataclass
class TopologyAssignment:
    levels: tuple[str, ...]
    domains: tuple[TopologyDomainAssignment, ...]


class _Domain:
    __slots__ = ("id", "values", "parent", "children", "free_capacity",
                 "tas_usage", "node_name", "node_labels", "node_taints")

    def __init__(self, domain_id, values):
        self.id = domain_id
        self.values = values
        self.parent: Optional[_Domain] = None
        self.children: list[_Domain] = []
        self.free_capacity: dict[str, int] = {}
        self.tas_usage: dict[str, int] = {}
        self.node_name: Optional[str] = None
        # Leaf-only node metadata for matchNode: taints and the full
        # label set for selectors and affinity.
        self.node_labels: dict[str, str] = {}
        self.node_taints: tuple = ()


def slice_topology_constraints(tr) -> tuple:
    """Normalize the multi-layer list and the single-layer fields to
    ((level_label_or_None, size), ...), outermost first. A ``None`` level
    means the topology's lowest level."""
    if tr is None:
        return ()
    extra = tuple(getattr(tr, "slice_constraints", ()) or ())
    if extra:
        return tuple((str(t), int(s)) for t, s in extra)
    if tr.slice_level is None and not tr.slice_size:
        return ()
    return ((tr.slice_level, int(tr.slice_size or 0)),)


def _taint_to_string(t) -> str:
    """corev1.Taint.ToString."""
    if not t.effect:
        return t.key if not t.value else f"{t.key}={t.value}:"
    if not t.value:
        return f"{t.key}:{t.effect}"
    return f"{t.key}={t.value}:{t.effect}"


def _node_affinity_term_matches(term, labels: dict) -> bool:
    """One required node-selector term against a node's full label set;
    ``term`` is ((key, op, values), ...) and every expression must
    match. Absent keys fail In/Exists."""
    for key, op, values in term:
        val = labels.get(key)
        if op == "In":
            if val is None or val not in values:
                return False
        elif op == "NotIn":
            if val is not None and val in values:
                return False
        elif op == "Exists":
            if val is None:
                return False
        elif op == "DoesNotExist":
            if val is not None:
                return False
        elif op in ("Gt", "Lt"):
            try:
                n = int(val)
                bound = int(values[0])
            except (TypeError, ValueError, IndexError):
                return False
            if op == "Gt" and not n > bound:
                return False
            if op == "Lt" and not n < bound:
                return False
        else:
            return False
    return True


class ExclusionStats:
    """Why nodes were excluded during placement, rendered into the
    not-fit message's tail."""

    __slots__ = ("taints", "node_selector", "affinity", "topology_domain",
                 "resources", "total_nodes")

    def __init__(self):
        self.taints: dict[str, int] = {}
        self.node_selector = 0
        self.affinity = 0
        self.topology_domain = 0
        self.resources: dict[str, int] = {}
        self.total_nodes = 0

    def has_exclusions(self) -> bool:
        return (self.node_selector > 0 or self.affinity > 0
                or self.topology_domain > 0 or bool(self.taints)
                or bool(self.resources))

    def format_reasons(self) -> str:
        """Entries string-sorted after rendering."""
        reasons = []
        if self.node_selector > 0:
            reasons.append(f"nodeSelector: {self.node_selector}")
        if self.affinity > 0:
            reasons.append(f"affinity: {self.affinity}")
        if self.topology_domain > 0:
            reasons.append(f"topologyDomain: {self.topology_domain}")
        for taint in sorted(self.taints):
            reasons.append(f'taint "{taint}": {self.taints[taint]}')
        for res in sorted(self.resources):
            reasons.append(f'resource "{res}": {self.resources[res]}')
        return ", ".join(sorted(reasons))


@dataclass
class TASPodSetRequest:
    pod_set: PodSet
    single_pod_requests: dict[str, int]
    count: int
    # Elastic workload slices: the admitted predecessor's assignment.
    # The port does not place such requests.
    previous_assignment: Optional[TopologyAssignment] = None


@dataclass
class _AssignState:
    """A resolved request: slice geometry, levels and mode flags."""
    count: int
    slice_size: int
    requested_level_idx: int
    slice_level_idx: int
    required: bool
    unconstrained: bool
    leader_count: int = 0
    # unconstrained under the TASProfileMixed gate: LeastFreeCapacity
    # ordering.
    least_free: bool = False
    # level idx -> inner slice size of the multi-layer constraints
    slice_size_at_level: dict = field(default_factory=dict)
    multi_layer: tuple = ()


class TASFlavorSnapshot:
    """One flavor's topology forest. Its device tensors live on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, topology: Topology,
                 flavor_tolerations: tuple[Toleration, ...] = (),
                 device=None):
        self.device = resolve_device(device)
        self.topology_name = topology.name
        self.level_keys = [lv.node_label for lv in topology.levels]
        self.flavor_tolerations = flavor_tolerations
        self.is_lowest_level_node = (
            bool(self.level_keys) and self.level_keys[-1] == HOSTNAME_LABEL)
        self.domains: dict[tuple, _Domain] = {}
        self.leaves: dict[tuple, _Domain] = {}
        self.roots: dict[tuple, _Domain] = {}
        self.domains_per_level: list[dict[tuple, _Domain]] = [
            {} for _ in self.level_keys]
        # Structure version: bumped whenever the forest or capacities
        # change; keys the device encoding (tas/device._structure).
        self._version = 0
        # Usage version: bumped on every usage change; keys the usage
        # matrices, the placement memo and the exclusion-stats memo.
        self._usage_version = 0
        # Usage removals: the feasibility batch's live verdicts hold only
        # while usage has not shrunk since the batch ran.
        self._usage_removals = 0
        # Parked feasibility verdicts (tas/feasibility.park) and the
        # removal count they hold for.
        self._feas = None
        self._feas_removals = 0
        self._used_leaves: Optional[set] = None
        self._any_taints = False
        self._match_cache = None
        self._place_memo = None
        self._stats_memo = None
        self._device_struct = None
        # Calls that reached the device program (memo hits do not).
        self.device_placements = 0
        self._usage_matrix_cache: Optional[dict] = None
        self._usage_tensor_cache = None

    # -- construction --

    def add_node(self, node: Node,
                 non_tas_usage: Optional[dict[str, int]] = None) -> None:
        if not node.ready or node.unschedulable:
            return
        self._version += 1
        values = tuple(node.labels.get(k, "") for k in self.level_keys)
        if "" in values:
            return  # node not labeled for this topology
        leaf = self._ensure_domain(values)
        leaf.node_name = node.name
        leaf.node_labels = dict(node.labels)
        sched_taints = tuple(t for t in node.taints
                             if t.effect in ("NoSchedule", "NoExecute"))
        leaf.node_taints = leaf.node_taints + sched_taints
        if sched_taints:
            self._any_taints = True
        for res, cap in node.capacity.items():
            used = (non_tas_usage or {}).get(res, 0)
            leaf.free_capacity[res] = leaf.free_capacity.get(res, 0) \
                + max(0, cap - used)

    def _ensure_domain(self, values: tuple) -> _Domain:
        domain = self.domains.get(values)
        if domain is not None:
            return domain
        domain = _Domain(values, values)
        self.domains[values] = domain
        level = len(values) - 1
        self.domains_per_level[level][values] = domain
        if level == len(self.level_keys) - 1:
            self.leaves[values] = domain
        if level == 0:
            self.roots[values] = domain
        else:
            parent = self._ensure_domain(values[:-1])
            domain.parent = parent
            parent.children.append(domain)
        return domain

    # -- usage accounting --

    def _touch_used(self, leaf) -> None:
        """Track leaves carrying TAS usage so dense encoders iterate the
        used subset, not the whole forest."""
        if self._used_leaves is None:
            self._used_leaves = set()
        self._used_leaves.add(leaf.values)

    def _apply_deltas(self, leaf, deltas: dict[str, int]) -> None:
        self._usage_version += 1
        self._touch_used(leaf)
        usage = leaf.tas_usage
        for res, d in deltas.items():
            usage[res] = usage.get(res, 0) + d

    def add_usage(self, values: tuple, requests: dict[str, int],
                  count: int) -> None:
        leaf = self.leaves.get(tuple(values))
        if leaf is None:
            return
        deltas = {res: per_pod * count for res, per_pod in requests.items()}
        # Each placed pod occupies a pod slot whatever its requests.
        deltas["pods"] = deltas.get("pods", 0) + count
        self._apply_deltas(leaf, deltas)

    def remove_usage(self, values: tuple, requests: dict[str, int],
                     count: int) -> None:
        leaf = self.leaves.get(tuple(values))
        if leaf is None:
            return
        self._usage_removals += 1
        deltas = {res: -per_pod * count for res, per_pod in requests.items()}
        deltas["pods"] = deltas.get("pods", 0) - count
        self._apply_deltas(leaf, deltas)

    # -- placement --

    def find_topology_assignments(
        self,
        workers: TASPodSetRequest,
        leader: Optional[TASPodSetRequest] = None,
        simulate_empty: bool = False,
        assumed_usage: Optional[dict[tuple, dict[str, int]]] = None,
        required_replacement_domain: tuple = (),
    ) -> tuple[Optional[dict[str, TopologyAssignment]], str]:
        """findTopologyAssignment on the device. Returns
        ({pod_set_name: assignment}, "") or (None, failure_reason)."""
        # Within-usage-version memo: the outcome is a pure function of
        # (request, usage state), so repeats are dict hits. Only
        # leaderless, unaccumulated calls qualify.
        memo_key = None
        if (leader is None and not assumed_usage
                and not required_replacement_domain
                and workers.previous_assignment is None):
            from kueue_tpu_torch.tas.feasibility import request_signature
            ver = self._usage_version
            memo = self._place_memo
            if memo is None or memo[0] != ver or len(memo[1]) > 4096:
                memo = (ver, {})
                self._place_memo = memo
            memo_key = (
                request_signature(workers.pod_set,
                                  workers.single_pod_requests,
                                  workers.count),
                workers.pod_set.name, bool(simulate_empty),
                tuple(sorted(workers.pod_set.node_selector.items())))
            hit = memo[1].get(memo_key)
            if hit is not None:
                return hit
        if not features.enabled("DeviceTAS"):
            raise NotImplementedError(
                "DeviceTAS is off and the port has no host TAS path")
        from kueue_tpu_torch.tas import device
        self.device_placements += 1
        out = device.try_find(self, workers, leader, simulate_empty,
                              assumed_usage, required_replacement_domain)
        if memo_key is not None:
            memo[1][memo_key] = out
        return out

    def resolve_request(self, workers: TASPodSetRequest,
                        has_leader: bool) -> tuple:
        """Request resolution (findTopologyAssignment): slice size,
        requested/slice level indices, mode flags, the multi-layer
        slice-size map. Returns (state, reason); state is an
        _AssignState on success."""
        tr = workers.pod_set.topology_request
        count = workers.count

        constraints = slice_topology_constraints(tr)
        if len(constraints) > 1 and not features.enabled(
                "TASMultiLayerTopology"):
            constraints = constraints[:1]
        if constraints:
            slice_size = constraints[0][1]
            if slice_size <= 0:
                return None, ("slice topology requested, but slice size "
                              "not provided")
        else:
            slice_size = 1
        if count % slice_size != 0:
            return None, (
                f"pod count {count} not divisible by slice size {slice_size}")

        implied = tr is None
        mode = tr.mode if tr is not None else None
        required = mode == TopologyMode.REQUIRED
        preferred = mode == TopologyMode.PREFERRED
        slice_only = (not required and not preferred and bool(constraints))
        unconstrained = (mode == TopologyMode.UNCONSTRAINED or implied
                         or slice_only)

        # Required/preferred name a level; slice-only anchors at the
        # highest level; unconstrained (implied too) at the lowest.
        if required or preferred:
            if tr.level is None or tr.level not in self.level_keys:
                return None, f"no requested topology level: {tr.level}"
            requested_level_idx = self.level_keys.index(tr.level)
        elif slice_only:
            requested_level_idx = 0
        elif unconstrained:
            requested_level_idx = len(self.level_keys) - 1
        else:
            return None, "topology level not specified"

        # The outermost constraint's level, defaulting to the lowest.
        slice_level_key = (constraints[0][0] if constraints
                           and constraints[0][0] is not None
                           else self.level_keys[-1])
        if slice_level_key not in self.level_keys:
            return None, (
                f"no requested topology level for slices: {slice_level_key}")
        slice_level_idx = self.level_keys.index(slice_level_key)
        if requested_level_idx > slice_level_idx:
            named = tr.level if (tr is not None and tr.level) else \
                self.level_keys[requested_level_idx]
            return None, (
                f"podset slice topology {slice_level_key} is above the "
                f"podset topology {named}")

        # Inner layers of a multi-layer request.
        slice_size_at_level: dict[int, int] = {}
        prev_size, prev_idx = slice_size, slice_level_idx
        for layer_key, layer_size in constraints[1:]:
            if layer_key not in self.level_keys:
                return None, ("no requested topology level for additional "
                              f"slice layer: {layer_key}")
            inner_idx = self.level_keys.index(layer_key)
            if inner_idx <= prev_idx:
                return None, (
                    f"additional slice layer topology {layer_key} must be "
                    f"at a lower level than {self.level_keys[prev_idx]}")
            if prev_size % layer_size != 0:
                return None, (
                    f"additional slice layer size {layer_size} must evenly "
                    f"divide parent layer size {prev_size}")
            for lvl in range(prev_idx + 1, inner_idx + 1):
                slice_size_at_level[lvl] = layer_size
            prev_size, prev_idx = layer_size, inner_idx

        state = _AssignState(
            count=count, slice_size=slice_size,
            requested_level_idx=requested_level_idx,
            slice_level_idx=slice_level_idx, required=required,
            unconstrained=unconstrained,
            leader_count=1 if has_leader else 0,
            least_free=(unconstrained
                        and features.enabled("TASProfileMixed")),
            slice_size_at_level=slice_size_at_level,
            multi_layer=constraints if slice_size_at_level else ())
        return state, ""

    def _match_excluded(self, pod_set) -> dict:
        """matchNode over every leaf: {leaf values: reason} where reason
        is ("taint", taint_string) | ("selector",) | ("affinity",). Only
        hostname-lowest topologies match nodes; the taint check folds in
        the flavor's tolerations. Memoized per (structure version,
        selector, tolerations, affinity)."""
        if not self.is_lowest_level_node:
            return {}
        selector = pod_set.node_selector or {}
        tolerations = tuple(pod_set.tolerations) + tuple(
            self.flavor_tolerations)
        affinity = tuple(tuple(term) for term in
                         (pod_set.node_affinity or ()))
        if not selector and not affinity and not self._any_taints:
            return {}
        key = (tuple(sorted(selector.items())), tolerations, affinity)
        cache = self._match_cache
        if cache is None or cache[0] != self._version:
            cache = (self._version, {})
            self._match_cache = cache
        hit = cache[1].get(key)
        if hit is not None:
            return hit
        excluded: dict[tuple, tuple] = {}
        for values, leaf in self.leaves.items():
            reason = None
            for taint in leaf.node_taints:
                if not any(t.tolerates(taint) for t in tolerations):
                    reason = ("taint", _taint_to_string(taint))
                    break
            if reason is None and selector:
                labels = leaf.node_labels
                if any(labels.get(k) != v for k, v in selector.items()):
                    reason = ("selector",)
            if reason is None and affinity:
                labels = leaf.node_labels
                if not any(_node_affinity_term_matches(term, labels)
                           for term in affinity):
                    reason = ("affinity",)
            if reason is not None:
                excluded[values] = reason
        if len(cache[1]) > 256:
            cache[1].clear()
        cache[1][key] = excluded
        return excluded

    def _exclusion_stats(self, pod_set, per_pod: dict[str, int],
                         simulate_empty: bool, assumed_usage: dict,
                         required_replacement_domain: tuple
                         ) -> ExclusionStats:
        """The failure message's ExclusionStats, a pure function of
        (request, forest state), built at failure time. Memoized per
        (request fingerprint, structure and usage version) for the
        unaccumulated call shape."""
        key = None
        memo = None
        if not assumed_usage and not required_replacement_domain:
            # One version key for both usage variants, so alternating
            # live and simulate-empty renders share the memo.
            ver = (self._version, self._usage_version)
            memo = self._stats_memo
            if memo is None or memo[0] != ver or len(memo[1]) > 1024:
                memo = (ver, {})
                self._stats_memo = memo
            key = (tuple(sorted(per_pod.items())),
                   tuple(sorted(pod_set.node_selector.items())),
                   tuple(pod_set.tolerations),
                   tuple(tuple(t) for t in (pod_set.node_affinity or ())),
                   bool(simulate_empty))
            hit = memo[1].get(key)
            if hit is not None:
                return hit
        stats = ExclusionStats()
        stats.total_nodes = len(self.leaves)
        excluded = self._match_excluded(pod_set)
        for reason in excluded.values():
            if reason[0] == "taint":
                stats.taints[reason[1]] = stats.taints.get(reason[1], 0) + 1
            elif reason[0] == "selector":
                stats.node_selector += 1
            else:
                stats.affinity += 1
        rrd = tuple(required_replacement_domain or ())
        res_order = [(res, need) for res, need in
                     sorted(per_pod.items()) if need > 0]
        if (len(self.leaves) >= 256 and not assumed_usage
                and self._np_resource_exclusions(
                    res_order, simulate_empty, excluded, rrd, stats)):
            pass  # the vectorized path filled the resource counts
        else:
            for values, leaf in self.leaves.items():
                if values in excluded:
                    continue
                if rrd and values[:len(rrd)] != rrd:
                    stats.topology_domain += 1
                    continue
                free = leaf.free_capacity
                usage = leaf.tas_usage if not simulate_empty else None
                assumed = assumed_usage.get(leaf.id) if not simulate_empty \
                    else None
                best = None
                limiting = ""
                for res, need in res_order:
                    if res == "pods" and res not in free:
                        continue
                    rem = free.get(res, 0)
                    if usage:
                        rem -= usage.get(res, 0)
                    if assumed:
                        rem -= assumed.get(res, 0)
                    cnt = max(0, rem) // need
                    if best is None or cnt < best:
                        best = cnt
                        limiting = res
                    if best == 0:
                        break  # sorted order: the first zero wins
                if best == 0 and limiting:
                    stats.resources[limiting] = \
                        stats.resources.get(limiting, 0) + 1
        if key is not None:
            memo[1][key] = stats
        return stats

    def _np_resource_exclusions(self, res_order, simulate_empty: bool,
                                excluded: dict, rrd: tuple,
                                stats: ExclusionStats) -> bool:
        """Resource-exclusion counting over the cached leaf matrices.
        Fills ``stats.resources``/``topology_domain``; returns False when
        the dense path cannot serve (unknown columns)."""
        from kueue_tpu_torch.tas import device

        struct = device._structure(self)
        cols = device._cols_for(struct, dict(res_order), {})
        col_of = {res: i for i, res in enumerate(cols)}
        if any(res not in col_of for res, _ in res_order):
            return False
        free = device._free_matrix(struct, cols)
        if simulate_empty:
            remaining = free
        else:
            remaining = free - device._usage_matrix(self, struct, cols)
        leaves = struct["leaves"]
        m = len(leaves)
        alive = struct["valid"][struct["nl"] - 1][:].copy()
        alive[m:] = False
        if excluded or rrd:
            for i, leaf in enumerate(leaves):
                if leaf.values in excluded:
                    alive[i] = False
                elif rrd and leaf.values[:len(rrd)] != rrd:
                    alive[i] = False
                    stats.topology_domain += 1
        # The first zero-count resource in sorted order per leaf: zero is
        # the global minimum and the first in sorted order wins ties.
        undecided = alive.copy()
        pods_cap = struct["has_pods_cap"]
        for res, need in res_order:
            ci = col_of[res]
            zero = remaining[:len(undecided), ci] < need
            if res == "pods":
                zero = zero & pods_cap[:len(undecided)]
            hit = undecided & zero
            n = int(hit.sum())
            if n:
                stats.resources[res] = stats.resources.get(res, 0) + n
                undecided = undecided & ~hit
        return True

    def _not_fit_message(self, fit: int, want: int, slice_size: int = 1,
                         stats: Optional[ExclusionStats] = None) -> str:
        """notFitMessage: quantities in slice units when slices are
        requested, with the exclusion-stats tail."""
        unit = "pod" if slice_size == 1 else "slice"
        if fit == 0:
            msg = (f'topology "{self.topology_name}" doesn\'t allow to fit '
                   f'any of {want} {unit}(s)')
        else:
            msg = (f'topology "{self.topology_name}" allows to fit only '
                   f'{fit} out of {want} {unit}(s)')
        if stats is not None and stats.has_exclusions():
            msg += (f". Total nodes: {stats.total_nodes}; "
                    f"excluded: {stats.format_reasons()}")
        return msg
