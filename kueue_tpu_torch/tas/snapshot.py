"""Topology-aware scheduling (TAS): the flavor's topology forest and
the placement descent.

The port of ``kueue_tpu/tas/snapshot.py`` (the reference's
pkg/cache/scheduler/tas_flavor_snapshot.go, KEP 2724): the forest of
topology domains with per-leaf capacity and TAS usage, request
resolution, node matching (taints, selectors, affinity), the sequential
host descent (phase 1 fill counts, phase 2 level descent, leaders and
multi-layer slices included) and the forest's per-cycle lifecycle (undo
scope, write-through commits, the phase-1 memo, forks).

``find_topology_assignments`` takes the device program
(``tas/device.try_find`` -> ``ops/tas.tas_place``) only when
``tas/device.worth_offloading`` says so (``KUEUE_TPU_DEVICE_TAS_MIN`` or
the port's crossover record, ``tas/calibration.py``), and the host
descent otherwise and on the corners the device program does not take.
Host work is Python/numpy; the device tensors live on ``device`` (CUDA
unless the caller asks for the CPU).

Also ported: unhealthy-node replacement (``find_replacement_assignment``,
which re-places only the lost pods, through the device program under
the device pin), elastic workload slices (``_handle_elastic_workload``:
the scale-up delta goes through ``find_topology_assignments``) and
balanced placement (``tas/balanced.py``, host-only as in the JAX
package).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
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

_INF = 1 << 60


@dataclass
class Node:
    """A capacity-bearing leaf (the reference uses corev1.Node; we are
    standalone). ``capacity`` is per-resource milli-units."""

    name: str
    labels: dict[str, str] = field(default_factory=dict)
    capacity: dict[str, int] = field(default_factory=dict)
    taints: tuple[Taint, ...] = ()
    ready: bool = True
    # corev1.NodeSpec.Unschedulable (kubectl cordon): excluded from the
    # forest like not-ready nodes (tas_nodes_cache.go node filtering).
    unschedulable: bool = False


@dataclass
class TopologyDomainAssignment:
    values: tuple[str, ...]  # level values root->leaf
    count: int


@dataclass
class TopologyAssignment:
    levels: tuple[str, ...]
    domains: tuple[TopologyDomainAssignment, ...]


def merge_topology_assignments(a: TopologyAssignment,
                               b: TopologyAssignment
                               ) -> TopologyAssignment:
    """mergeTopologyAssignments: sum counts per domain, sorted by
    domain values (the canonical order)."""
    counts: dict[tuple, int] = {}
    for ta in (a, b):
        for dom in ta.domains:
            counts[tuple(dom.values)] = \
                counts.get(tuple(dom.values), 0) + dom.count
    return TopologyAssignment(
        levels=a.levels,
        domains=tuple(TopologyDomainAssignment(values, count)
                      for values, count in sorted(counts.items())))


def truncate_assignment(prev: TopologyAssignment,
                        count: int) -> TopologyAssignment:
    """utiltas.TruncateAssignment: keep the first ``count`` pods in
    domain order (scale-down removes from the tail)."""
    kept = []
    remaining = count
    for dom in prev.domains:
        if remaining <= 0:
            break
        take = min(dom.count, remaining)
        kept.append(TopologyDomainAssignment(dom.values, take))
        remaining -= take
    return TopologyAssignment(levels=prev.levels, domains=tuple(kept))


class _Domain:
    __slots__ = ("id", "values", "parent", "children", "state",
                 "slice_state", "state_with_leader",
                 "slice_state_with_leader", "leader_state",
                 "free_capacity", "tas_usage", "node_name",
                 "node_labels", "node_taints")

    def __init__(self, domain_id, values):
        self.id = domain_id
        self.values = values
        self.parent: Optional[_Domain] = None
        self.children: list[_Domain] = []
        self.state = 0  # pods that fit (phase-1), then assigned count
        self.slice_state = 0
        self.state_with_leader = 0
        self.slice_state_with_leader = 0
        self.leader_state = 0
        self.free_capacity: dict[str, int] = {}
        self.tas_usage: dict[str, int] = {}
        self.node_name: Optional[str] = None
        # Leaf-only node metadata for matchNode (tas_flavor_snapshot.go
        # :1830 — taints, full label set for selectors/affinity).
        self.node_labels: dict[str, str] = {}
        self.node_taints: tuple = ()

    def clear_state(self):
        """tas_balanced_placement.go clearState."""
        self.state = 0
        self.slice_state = 0
        self.state_with_leader = 0
        self.slice_state_with_leader = 0
        self.leader_state = 0
        for c in self.children:
            c.clear_state()

    def clear_leader_capacity(self):
        """tas_balanced_placement.go clearLeaderCapacity."""
        self.state_with_leader = 0
        self.slice_state_with_leader = 0
        self.leader_state = 0
        for c in self.children:
            c.clear_leader_capacity()


def clone_domains(domains: list[_Domain]) -> list[_Domain]:
    """Deep-clone a forest of domains (tas_balanced_placement.go
    cloneDomains) so what-if pruning never mutates phase-1 state."""
    def clone(d: _Domain, parent) -> _Domain:
        c = _Domain(d.id, d.values)
        c.parent = parent
        c.state = d.state
        c.slice_state = d.slice_state
        c.state_with_leader = d.state_with_leader
        c.slice_state_with_leader = d.slice_state_with_leader
        c.leader_state = d.leader_state
        c.free_capacity = d.free_capacity
        c.tas_usage = d.tas_usage
        c.node_name = d.node_name
        c.children = [clone(ch, c) for ch in d.children]
        return c
    return [clone(d, None) for d in domains]


def slice_topology_constraints(tr) -> tuple:
    """util/tas/tas.go:116 (PodSetSliceRequiredTopologyConstraints):
    normalize the multi-layer list and the legacy single-layer fields to
    ((level_label_or_None, size), ...), outermost first. A ``None``
    level means the topology's lowest level (our historical API allowed
    ``slice_size`` alone; the resolver substitutes the leaf level)."""
    if tr is None:
        return ()
    extra = tuple(getattr(tr, "slice_constraints", ()) or ())
    if extra:
        return tuple((str(t), int(s)) for t, s in extra)
    if tr.slice_level is None and not tr.slice_size:
        return ()
    return ((tr.slice_level, int(tr.slice_size or 0)),)


def _taint_to_string(t) -> str:
    """corev1.Taint.ToString (k8s.io/api/core/v1/taint.go:28)."""
    if not t.effect:
        return t.key if not t.value else f"{t.key}={t.value}:"
    if not t.value:
        return f"{t.key}:{t.effect}"
    return f"{t.key}={t.value}:{t.effect}"


def _node_affinity_term_matches(term, labels: dict) -> bool:
    """One requiredDuringScheduling nodeSelectorTerm against a node's
    FULL label set (component-helpers nodeaffinity.NodeSelector.Match —
    unlike the flavor-restricted matcher in scheduler/flavorassigner.py,
    absent keys fail In/Exists here). ``term`` is ((key, op, values),...);
    all expressions must match."""
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
    """tas_flavor_snapshot.go:496 (ExclusionStats): why nodes were
    excluded during placement, rendered into the notFitMessage tail."""

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
        """formatReasons :551 — entries string-sorted after rendering."""
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
    # Elastic workload slices: the admitted predecessor's assignment —
    # scale-up places only the delta, scale-down truncates
    # (tas_elastic_workloads.go:35 handleElasticWorkload).
    previous_assignment: Optional["TopologyAssignment"] = None


@dataclass
class _AssignState:
    """findTopologyAssignmentState (the per-call scratch)."""
    count: int
    slice_size: int
    requested_level_idx: int
    slice_level_idx: int
    required: bool
    unconstrained: bool
    leader_count: int = 0
    # unconstrained under the TASProfileMixed gate → LeastFreeCapacity
    # ordering (tas_flavor_snapshot.go:1498 useLeastFreeCapacityAlgorithm)
    least_free: bool = False
    # level idx -> inner slice size (buildSliceSizeAtLevel :1174)
    slice_size_at_level: dict = field(default_factory=dict)
    # the normalized constraint list when multi-layer is active (drives
    # multiLayerNotFitMessage :2004)
    multi_layer: tuple = ()
    # lazy ExclusionStats builder, memoized per call
    stats_fn: Optional[object] = None
    _stats_memo: Optional[object] = None

    def stats(self):
        if self._stats_memo is None and self.stats_fn is not None:
            self._stats_memo = self.stats_fn()
        return self._stats_memo


class _Phase1Memo:
    """Phase-1 fill + per-level sort order, shared across the heads of
    one cycle. The fillInCounts pass depends on the request's per-pod
    shape, slice geometry, and exclusions — but NOT on its count or
    requested level — so the nominate loop's (typically homogeneous)
    heads can share one fill and one sort per level. Between placements
    only the previous head's descent mutations are reverted: phase 2
    touches nothing outside the per-level candidate lists (selection
    is pure, _update_counts_to_minimum and the descent loops clamp only
    domains handed to them), so the undo log is candidate-list-sized.

    The memo survives usage mutations: every write to a leaf's
    tas_usage while a memo is live lands the leaf in ``stale``
    (_apply_deltas / commit_usage), and the next hit repairs exactly
    those leaves' counts plus their ancestor sums (_p1_repair) instead
    of refilling the forest. That lets the hybrid device cycle — which
    never opens an undo scope on the prototype — reuse one fill across
    cycles, paying only for the handful of leaves each cycle's
    admissions touched.

    Leaderless only: with no leader, state_with_leader ≡ state and
    slice_state_with_leader ≡ slice_state at every domain (fillLeafCounts
    sets them equal at leaves and the bubble's min-diff term is zero),
    which also makes _sorted_with_leader order coincide with _sorted —
    the cached per-level sort serves both call sites."""

    __slots__ = ("key", "undo", "sorts", "stale", "_seen")

    def __init__(self, key: tuple):
        self.key = key
        self.undo: list = []
        self.sorts: dict = {}
        self.stale: set = set()
        self._seen: set = set()

    def restore(self) -> None:
        undo = self.undo
        if not undo:
            return
        for d, state, slice_state, slice_swl, leader_state in undo:
            d.state = state
            d.slice_state = slice_state
            d.slice_state_with_leader = slice_swl
            d.leader_state = leader_state
        undo.clear()
        self._seen.clear()

    def save_list(self, domains: list) -> None:
        """Log the pre-descent state of every domain the next descent
        step may write: _update_counts_to_minimum mutates only members
        of the list handed to it (commit / leader_state clears /
        best-fit swaps all pick from that list), and the slice re-anchor
        loop writes only the current fit set's children — so logging
        each level's candidate list is exact, where the old
        whole-subtree save paid for every descendant of the fit domains
        (~10x the touched set on block-level fits). Deduped per scope:
        a domain surviving several levels keeps its FIRST (pre-descent)
        state."""
        seen = self._seen
        save = self.undo.append
        for d in domains:
            i = id(d)
            if i not in seen:
                seen.add(i)
                save((d, d.state, d.slice_state,
                      d.slice_state_with_leader, d.leader_state))


class TASFlavorSnapshot:
    """tas_flavor_snapshot.go:115. Its device tensors live on ``device``
    (CUDA unless the caller asks for the CPU)."""

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
        self._init_state()

    def _init_state(self) -> None:
        """The versions, memos and caches every snapshot starts with."""
        # Structure version: bumped whenever the forest or capacities
        # change; keys the device encoding (tas/device._structure).
        self._version = 0
        # Usage version: bumped on every usage change; keys the usage
        # matrices, the placement memo and the exclusion-stats memo.
        self._usage_version = 0
        # Usage removals: the feasibility batch's live verdicts hold only
        # while usage has not shrunk since the batch ran.
        self._usage_removals = 0
        # Parked feasibility verdicts (tas/feasibility.precompute) and
        # the removal count they hold for.
        self._feas = None
        self._feas_removals = 0
        self._used_leaves: Optional[set] = None
        self._any_taints = False
        self._match_cache = None
        self._place_memo = None
        self._stats_memo = None
        self._device_struct = None
        # A fork's prototype: its device encoding is remapped, not
        # rebuilt (tas/device._structure).
        self._struct_donor = None
        self._worth_memo = None
        self._usage_matrix_cache: Optional[dict] = None
        self._usage_tensor_cache = None
        # The open undo scope (begin_cycle) and the phase-1 memo.
        self._txn = None
        self._txn_dirty = False
        self._txn_base_version = 0
        self._txn_base_removals = 0
        self._p1 = None
        # Calls that reached the device program (memo hits do not).
        self.device_placements = 0


        self._version = 0

    # -- per-cycle undo scope (the zero-copy snapshot share) --
    #
    # Round 4 forked the whole forest per scheduling cycle (fork(), ~6 ms
    # at 640 leaves / ~16 ms at 5,120) and re-installed every live usage
    # aggregate on the copy. Round 5 replaces that with the reference's
    # own revert-closure pattern (snapshot.go:77 SimulateWorkloadRemoval):
    # the live prototype carries the admitted usage, a cycle opens an
    # undo scope, every in-cycle mutation logs its DELTA, and closing the
    # scope reverts in O(touched leaves). Cache write-through commits
    # (admissions applied after the cycle) bypass the log via
    # commit_usage().

    def begin_cycle(self) -> None:
        """Open an undo scope. A dangling scope (a reader snapshot that
        never closed) is force-closed first — its log is empty, so the
        force-close is free and self-healing."""
        if self._txn is not None:
            self.end_cycle()
        self._txn = []
        self._txn_dirty = False
        self._txn_base_version = self._usage_version
        self._txn_base_removals = self._usage_removals

    def end_cycle(self) -> None:
        """Revert the scope's delta log (reverse order) and restore the
        usage-version bookkeeping so pre-cycle encodes stay valid. If a
        commit interleaved (``_txn_dirty``), versions move forward
        instead and the matrix caches are dropped — going backward would
        alias a stale cache entry onto restored-but-different state."""
        txn = self._txn
        if txn is None:
            return
        for leaf, deltas in reversed(txn):
            usage = leaf.tas_usage
            for res, d in deltas.items():
                left = usage.get(res, 0) - d
                if left:
                    usage[res] = left
                else:
                    usage.pop(res, None)
        if self._txn_dirty:
            self._usage_version = self._usage_version + 1
            self._usage_removals = self._usage_removals + 1
            self._usage_matrix_cache = None
            self._usage_tensor_cache = None
        elif txn:
            base = self._txn_base_version
            mc = self._usage_matrix_cache
            if mc:
                for k in [k for k in mc if k[0] != base]:
                    mc.pop(k)
            jc = self._usage_tensor_cache
            if jc is not None and jc[0][0] != base:
                self._usage_tensor_cache = None
            self._usage_version = base
            self._usage_removals = self._txn_base_removals
        self._txn = None
        self._feas = None
        self._place_memo = None
        self._stats_memo = None
        self._p1 = None

    def commit_usage(self, values: tuple, deltas: dict[str, int]) -> None:
        """Write-through from the live cache's admitted-side accounting
        (scheduler_cache._account_tas): NOT delta-logged, so the change
        survives end_cycle(). ``deltas`` are pre-aggregated (pod slots
        included), negative for removals."""
        leaf = self.leaves.get(tuple(values))
        if leaf is None:
            return
        self._usage_version = self._usage_version + 1
        if any(v < 0 for v in deltas.values()):
            self._usage_removals = self._usage_removals + 1
        if self._txn is not None:
            self._txn_dirty = True
        p1 = self._p1
        if p1 is not None:
            p1.stale.add(leaf)
        self._touch_used(leaf)
        usage = leaf.tas_usage
        for res, d in deltas.items():
            left = usage.get(res, 0) + d
            if left:
                usage[res] = left
            else:
                usage.pop(res, None)

    # -- construction (tas_flavor.go / tas_nodes_cache.go) --

    def fork(self) -> "TASFlavorSnapshot":
        """Full per-call copy of the forest (structure shared, usage
        copied): used by what-if probes that outlive a cycle scope
        (bench crossover measurement, tests). The serving path no longer
        forks per cycle — see begin_cycle()."""
        new = TASFlavorSnapshot.__new__(TASFlavorSnapshot)
        new._init_state()
        new.device = self.device
        new.topology_name = self.topology_name
        new.level_keys = self.level_keys
        new.flavor_tolerations = self.flavor_tolerations
        new.is_lowest_level_node = self.is_lowest_level_node
        new._version = self._version
        new.domains = {}
        new.leaves = {}
        new.roots = {}
        new.domains_per_level = [{} for _ in self.level_keys]

        # Iterative, level by level (parents first — _ensure_domain
        # inserts children before parents, so plain insertion order
        # won't do); direct slot assignment skips __init__ overhead.
        domains = new.domains
        mk = _Domain.__new__
        for level_table in self.domains_per_level:
            for values, d in level_table.items():
                c = mk(_Domain)
                c.id = d.id
                c.values = values
                c.state = 0
                c.slice_state = 0
                c.state_with_leader = 0
                c.slice_state_with_leader = 0
                c.leader_state = 0
                c.free_capacity = d.free_capacity  # shared, read-only
                c.tas_usage = dict(d.tas_usage) if d.tas_usage else {}
                c.node_name = d.node_name
                c.node_labels = d.node_labels  # shared, read-only
                c.node_taints = d.node_taints
                c.children = []
                parent = d.parent
                if parent is None:
                    c.parent = None
                else:
                    c.parent = domains[parent.values]
                    c.parent.children.append(c)
                domains[values] = c
                new.domains_per_level[len(values) - 1][values] = c
                if not d.children:
                    new.leaves[values] = c
        for values in self.roots:
            new.roots[values] = domains[values]
        used = self._used_leaves
        if used:
            new._used_leaves = set(used)
        new._usage_version = self._usage_version
        new._any_taints = self._any_taints
        # The device encoding (tas/device.py _structure) can remap its
        # cached arrays through the prototype instead of re-deriving.
        new._struct_donor = self
        return new

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

    def remove_node(self, node: Node) -> None:
        """Node deletion / NotReady transition (tas_nodes_cache.go): the
        leaf domain disappears, making assignments on it stale."""
        values = tuple(node.labels.get(k, "") for k in self.level_keys)
        leaf = self.leaves.pop(values, None)
        if leaf is None:
            return
        self._version += 1
        self.domains.pop(values, None)
        self.domains_per_level[len(values) - 1].pop(values, None)
        if leaf.parent is not None:
            leaf.parent.children.remove(leaf)

    # -- usage accounting (updateTASUsage) --

    def _touch_used(self, leaf) -> None:
        """Track leaves carrying TAS usage so dense encoders iterate
        the used subset, not the whole (possibly pod-slice-scale)
        forest."""
        used = self._used_leaves
        if used is None:
            used = self._used_leaves = set()
        used.add(leaf.values)

    def _apply_deltas(self, leaf, deltas: dict[str, int]) -> None:
        """Apply a usage delta to one leaf, logging it for revert when a
        cycle's undo scope is open (begin_cycle)."""
        self._usage_version = self._usage_version + 1
        p1 = self._p1
        if p1 is not None:
            p1.stale.add(leaf)
        self._touch_used(leaf)
        txn = self._txn
        if txn is not None:
            txn.append((leaf, deltas))
        usage = leaf.tas_usage
        for res, d in deltas.items():
            usage[res] = usage.get(res, 0) + d

    def add_usage(self, values: tuple, requests: dict[str, int],
                  count: int) -> None:
        leaf = self.leaves.get(tuple(values))
        if leaf is None:
            return
        deltas = {res: per_pod * count for res, per_pod in requests.items()}
        # Each placed pod occupies a pod slot regardless of its resource
        # requests (tas_flavor_snapshot.go:321 updateTASUsage adds
        # ResourcePods: count on top of the scaled requests).
        deltas["pods"] = deltas.get("pods", 0) + count
        self._apply_deltas(leaf, deltas)

    def remove_usage(self, values: tuple, requests: dict[str, int],
                     count: int) -> None:
        leaf = self.leaves.get(tuple(values))
        if leaf is None:
            return
        # Removals can make stale "doesn't fit" conclusions wrong; the
        # feasibility pre-pass keys its live-usage verdicts on this.
        self._usage_removals = self._usage_removals + 1
        deltas = {res: -per_pod * count for res, per_pod in requests.items()}
        deltas["pods"] = deltas.get("pods", 0) - count
        self._apply_deltas(leaf, deltas)

    def install_usage(self, values: tuple, usage: dict[str, int]) -> None:
        """Add PRE-AGGREGATED usage (already scaled by pod counts, pods
        slots included) to a leaf — the one-pass form the live cache's
        incremental aggregates feed through build_snapshot."""
        leaf = self.leaves.get(tuple(values))
        if leaf is None:
            return
        self._apply_deltas(leaf, dict(usage))

    def fits(self, domain_requests) -> bool:
        """clusterqueue_snapshot.go:137 TAS part: every requested domain has
        the free capacity."""
        for values, requests, count in domain_requests:
            leaf = self.leaves.get(tuple(values))
            if leaf is None:
                return False
            for res, per_pod in requests.items():
                free = leaf.free_capacity.get(res, 0) - \
                    leaf.tas_usage.get(res, 0)
                if per_pod * count > free:
                    return False
        return True

    # -- the placement entry points --

    def find_topology_assignments_for_flavor(
        self,
        requests: list[TASPodSetRequest],
        workload=None,
        simulate_empty: bool = False,
        assumed_usage: Optional[dict[tuple, dict[str, int]]] = None,
    ) -> tuple[dict[str, TopologyAssignment], str]:
        """FindTopologyAssignmentsForFlavor (tas_flavor_snapshot.go:642):
        group pod sets by topology group, pick leader+workers per group
        (findLeaderAndWorkers :729), route to the replacement path when the
        workload reports unhealthy nodes. Returns ({name: assignment},
        failure_reason); partial results on failure."""
        assumed = assumed_usage if assumed_usage is not None else {}
        groups: dict[str, list[TASPodSetRequest]] = {}
        order: list[str] = []
        for idx, tr in enumerate(requests):
            key = (tr.pod_set.topology_request.pod_set_group_name
                   if tr.pod_set.topology_request else None) or str(idx)
            if key not in groups:
                order.append(key)
            groups.setdefault(key, []).append(tr)

        unhealthy = tuple(getattr(
            getattr(workload, "status", None), "unhealthy_nodes", ()) or ())

        results: dict[str, TopologyAssignment] = {}
        for key in order:
            trs = groups[key]
            if unhealthy:
                for tr in trs:
                    existing = _existing_assignment(workload,
                                                   tr.pod_set.name)
                    if existing is None:
                        continue
                    if features.enabled(
                            "SkipReassignmentForPodOwnedWorkloads") \
                            and owned_by_single_pod(workload):
                        # The pod cannot relocate and the Workload cannot
                        # outlive it; keep the existing assignment so
                        # admit clears UnhealthyNodes without diverging
                        # from the node the pod actually runs on
                        # (tas_flavor_snapshot.go:679).
                        results[tr.pod_set.name] = existing
                        continue
                    new_assignment, repl, reason = \
                        self.find_replacement_assignment(
                            tr, existing, unhealthy, assumed)
                    if reason:
                        return results, reason
                    results[tr.pod_set.name] = new_assignment
                    _add_assumed(assumed, repl, tr)
                continue
            leader, workers = _find_leader_and_workers(trs)
            if (workers.previous_assignment is not None
                    and features.enabled(
                        "ElasticJobsViaWorkloadSlicesWithTAS")):
                # Delta-only elastic placement is its own sub-gate
                # (kube_features.go ElasticJobsViaWorkloadSlicesWithTAS);
                # off = the replacement places from scratch.
                applied, elastic, reason = self._handle_elastic_workload(
                    workers, leader, assumed,
                    simulate_empty=simulate_empty)
                if applied:
                    if reason:
                        return results, reason
                    results.update(elastic)
                    continue
            assignments, reason = self.find_topology_assignments(
                workers, leader, simulate_empty=simulate_empty,
                assumed_usage=assumed)
            if reason:
                return results, reason
            for tr in trs:
                ta = assignments.get(tr.pod_set.name)
                if ta is not None:
                    results[tr.pod_set.name] = ta
                    _add_assumed(assumed, ta, tr)
        return results, ""

    def _handle_elastic_workload(
        self, workers: TASPodSetRequest,
        leader: Optional[TASPodSetRequest],
        assumed: dict, simulate_empty: bool = False,
    ) -> tuple[bool, dict[str, "TopologyAssignment"], str]:
        """tas_elastic_workloads.go:35 (handleElasticWorkload): keep the
        previous slice's pods fixed — scale-up places only the delta and
        merges, scale-down truncates, same-count reuses. Returns
        (applied, results, failure_reason); applied=False falls back to
        standard placement (stale previous assignment)."""
        prev = workers.previous_assignment
        stale, _domain = self.is_topology_assignment_stale(prev)
        if stale:
            return False, {}, ""
        prev_count = sum(d.count for d in prev.domains)
        results: dict[str, TopologyAssignment] = {}
        if workers.count > prev_count:
            # handleScaleUp (:67): previous pods consume capacity, only
            # the delta is placed fresh, then merged.
            delta = replace(workers, count=workers.count - prev_count,
                            previous_assignment=None)
            _add_assumed(assumed, prev, workers)
            assignments, reason = self.find_topology_assignments(
                delta, leader, simulate_empty=simulate_empty,
                assumed_usage=assumed)
            if reason:
                return True, {}, reason
            merged = merge_topology_assignments(
                assignments[workers.pod_set.name], prev)
            results[workers.pod_set.name] = merged
            _add_assumed(assumed, assignments[workers.pod_set.name],
                         workers)
            if leader is not None:
                lta = assignments.get(leader.pod_set.name)
                if lta is not None:
                    results[leader.pod_set.name] = lta
                    _add_assumed(assumed, lta, leader)
            return True, results, ""
        if workers.count < prev_count:
            # handleScaleDown (:105): truncate, keep placement.
            kept = truncate_assignment(prev, workers.count)
        else:
            kept = prev
        results[workers.pod_set.name] = kept
        _add_assumed(assumed, kept, workers)
        if leader is not None and leader.previous_assignment is not None:
            results[leader.pod_set.name] = leader.previous_assignment
            _add_assumed(assumed, leader.previous_assignment, leader)
        return True, results, ""

    def find_topology_assignment(
        self,
        request: TASPodSetRequest,
        simulate_empty: bool = False,
        assumed_usage: Optional[dict[tuple, dict[str, int]]] = None,
    ) -> tuple[Optional[TopologyAssignment], str]:
        """Single-pod-set compatibility wrapper over
        find_topology_assignments."""
        assignments, reason = self.find_topology_assignments(
            request, None, simulate_empty=simulate_empty,
            assumed_usage=assumed_usage)
        if reason:
            return None, reason
        return assignments[request.pod_set.name], ""

    def find_topology_assignments(
        self,
        workers: TASPodSetRequest,
        leader: Optional[TASPodSetRequest] = None,
        simulate_empty: bool = False,
        assumed_usage: Optional[dict[tuple, dict[str, int]]] = None,
        required_replacement_domain: tuple = (),
    ) -> tuple[Optional[dict[str, TopologyAssignment]], str]:
        """tas_flavor_snapshot.go:946 (findTopologyAssignment). Returns
        ({pod_set_name: assignment}, failure_reason).

        The device program (tas/device.try_find -> ops/tas.tas_place)
        places only when tas/device.worth_offloading says so (the
        KUEUE_TPU_DEVICE_TAS_MIN leaf threshold, else the port's
        crossover record in tas/calibration.py); otherwise, and on the
        corners try_find returns NotImplemented for, the sequential
        host descent below places."""
        # Within-usage-version memo: an oversubscribed cycle retries
        # many heads with identical (signature, selector) requests — the
        # placement outcome is a pure function of (request, usage state),
        # so repeats are dict hits instead of phase-1 + descent reruns.
        # Only leaderless, ungrouped, unaccumulated calls qualify (the
        # assumed-usage dict threads state between a workload's pod
        # sets). Keyed on _usage_version: any usage mutation invalidates.
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
        out = None
        if features.enabled("DeviceTAS"):
            from kueue_tpu_torch.tas import device
            if device.worth_offloading(self):
                out = device.try_find(
                    self, workers, leader, simulate_empty, assumed_usage,
                    required_replacement_domain)
                if out is NotImplemented:
                    out = None
        if out is None:
            out = self.find_topology_assignments_host(
                workers, leader, simulate_empty, assumed_usage,
                required_replacement_domain)
        if memo_key is not None:
            memo[1][memo_key] = out
        return out

    def resolve_request(self, workers: TASPodSetRequest,
                        has_leader: bool) -> tuple:
        """Shared request resolution (findTopologyAssignment :978-1032):
        slice size, requested/slice level indices, mode flags, the
        multi-layer slice-size map. Returns (state, reason) — state is an
        _AssignState on success. Used by the host path, the device
        adapter, and the feasibility batch so the three can never
        disagree on what a request means."""
        tr = workers.pod_set.topology_request
        count = workers.count

        constraints = slice_topology_constraints(tr)
        if len(constraints) > 1 and not features.enabled(
                "TASMultiLayerTopology"):
            # Gate off: additional layers ignored (the annotation parser
            # only emits the list under the gate, jobframework/tas.go:91).
            constraints = constraints[:1]
        # getSliceSizeWithSinglePodAsDefault :1310.
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

        # levelKey :1273 + levelKeyWithImpliedFallback :1263: required/
        # preferred name a level; slice-only anchors at the HIGHEST
        # level; unconstrained (incl. implied) at the LOWEST.
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

        # sliceLevelKeyWithDefault :1248 — the OUTERMOST constraint's
        # level, defaulting to the lowest level.
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

        # buildSliceSizeAtLevel :1174 — inner layers.
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
        """matchNode (:1830) over every leaf: {leaf values: reason}
        where reason is ("taint", taint_string) | ("selector",) |
        ("affinity",). Only hostname-lowest topologies match nodes; the
        taint check folds in the flavor's tolerations. Memoized per
        (structure version, selector, tolerations, affinity) — the
        matchingLeavesCache / TASCacheNodeMatchResults analog."""
        if not self.is_lowest_level_node:
            return {}
        selector = pod_set.node_selector or {}
        tolerations = tuple(pod_set.tolerations) + tuple(
            self.flavor_tolerations)
        affinity = tuple(tuple(term) for term in
                         (pod_set.node_affinity or ()))
        if not selector and not affinity \
                and not self._any_taints:
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
        """Build the failure-path ExclusionStats lazily — a pure function
        of (request, forest state), so EVERY decision path (host walk,
        numpy phase-1, device kernel, feasibility batch) renders the
        identical message by calling this at failure time instead of
        collecting counters inline.

        The walk is O(leaves); a churn cycle renders failure messages
        for MANY homogeneous rejected heads (30 heads x 5,120 leaves
        regressed the device churn path 50x before the memo), so
        results are memoized per (request fingerprint, usage/structure
        version) for the common unaccumulated call shape."""
        key = None
        memo = None
        if not assumed_usage and not required_replacement_domain:
            # ONE version key for both usage variants: simulate-empty
            # stats don't depend on usage, but alternating live/empty
            # renders with differing memo versions would thrash the
            # single-slot memo (they interleave per head).
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
            pass  # vectorized path filled the resource counts
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
                        break  # sorted order: first zero IS the winner
                if best == 0 and limiting:
                    stats.resources[limiting] = \
                        stats.resources.get(limiting, 0) + 1
        if key is not None:
            memo[1][key] = stats
        return stats

    def _np_resource_exclusions(self, res_order, simulate_empty: bool,
                                excluded: dict, rrd: tuple,
                                stats: ExclusionStats) -> bool:
        """Vectorized resource-exclusion counting over the cached leaf
        matrices (device._free_matrix/_usage_matrix) — the per-leaf dict
        walk was the pod-slice-scale message-render bottleneck. Fills
        ``stats.resources``/``topology_domain``; returns False when the
        dense path can't serve (unknown columns)."""
        import numpy as np

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
        # First zero-count resource in sorted order per leaf (the
        # CountInWithLimitingResource min+lexicographic tie rule: zero
        # is the global minimum, first-in-sorted-order wins ties).
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

    def find_topology_assignments_host(
        self,
        workers: TASPodSetRequest,
        leader: Optional[TASPodSetRequest] = None,
        simulate_empty: bool = False,
        assumed_usage: Optional[dict[tuple, dict[str, int]]] = None,
        required_replacement_domain: tuple = (),
    ) -> tuple[Optional[dict[str, TopologyAssignment]], str]:
        """The sequential oracle path of find_topology_assignments."""
        state, reason = self.resolve_request(workers, leader is not None)
        if reason:
            return None, reason
        count = workers.count

        per_pod = dict(workers.single_pod_requests)
        per_pod["pods"] = per_pod.get("pods", 0) + 1
        leader_per_pod = None
        if leader is not None:
            leader_per_pod = dict(leader.single_pod_requests)
            leader_per_pod["pods"] = leader_per_pod.get("pods", 0) + 1

        assumed = assumed_usage or {}
        state.stats_fn = lambda: self._exclusion_stats(
            workers.pod_set, per_pod, simulate_empty, assumed,
            required_replacement_domain)

        # Phase 1: per-domain fit counts — memoized across the heads of
        # a cycle (_Phase1Memo). Balanced-placement candidates are
        # excluded because balanced.apply re-aggregates clones through
        # bubble_up, stomping counts outside any selected subtree.
        p1 = None
        if (leader is None and not assumed and not required_replacement_domain
                and not (features.enabled("TASBalancedPlacement")
                         and not state.required and not state.unconstrained)):
            excluded = self._match_excluded(workers.pod_set)
            p1_key = (
                self._version, bool(simulate_empty),
                tuple(sorted(per_pod.items())),
                state.slice_size, state.slice_level_idx,
                tuple(sorted(state.slice_size_at_level.items())),
                id(excluded) if excluded else 0)
            p1 = self._p1
            hit = p1 is not None and p1.key == p1_key
            if hit:
                p1.restore()
                if p1.stale:
                    # Simulate-empty counts ignore usage entirely; live
                    # counts get the touched leaves recomputed in place.
                    hit = simulate_empty or self._p1_repair(
                        p1, per_pod, excluded, state)
                    p1.stale.clear()
            if not hit:
                self._fill_in_counts(workers.pod_set, per_pod, None,
                                     state, simulate_empty, assumed,
                                     required_replacement_domain)
                p1 = _Phase1Memo(p1_key)
            self._p1 = p1
        else:
            self._fill_in_counts(workers.pod_set, per_pod, leader_per_pod,
                                 state, simulate_empty, assumed,
                                 required_replacement_domain)

        slice_size = state.slice_size
        slice_level_idx = state.slice_level_idx
        unconstrained = state.unconstrained
        slice_count = count // slice_size

        # Phase 2a: balanced placement (preferred mode only), else find
        # the level with fitting domains (tas_flavor_snapshot.go:1060-1087).
        fit_domains = None
        fit_level_idx = 0
        used_balanced = False
        if (features.enabled("TASBalancedPlacement")
                and not state.required and not unconstrained):
            from kueue_tpu_torch.tas import balanced
            cand, threshold = balanced.find_best_domains(self, state)
            if threshold > 0:
                fit_domains, fit_level_idx, reason = balanced.apply(
                    self, state, threshold, cand)
                used_balanced = not reason
        if not used_balanced:
            fit_level_idx, fit_domains, reason = self._find_level_with_fit(
                state.requested_level_idx, slice_count, state,
                sort_cache=p1.sorts if p1 is not None else None)
            if reason:
                return None, reason

        # Phase 2b: minimize the chosen domains, then descend
        # (tas_flavor_snapshot.go:1085-1130). The descent always orders
        # children with sortedDomains — leader consumption happens inside
        # the consume walk, not via the with-leader sort (that one is
        # selection-level only, :1387).
        if p1 is not None:
            p1.save_list(fit_domains)
        fit_domains = self._update_counts_to_minimum(
            fit_domains, count, state.leader_count, slice_size,
            state.least_free, use_slices=True)
        if fit_domains is None:
            return None, "internal: assignment accounting underflow"
        level = fit_level_idx
        while level < min(len(self.level_keys) - 1, slice_level_idx) \
                and not used_balanced:
            children = [c for d in fit_domains for c in d.children]
            if p1 is not None:
                p1.save_list(children)
            lower = self._sorted(children, state.least_free)
            fit_domains = self._update_counts_to_minimum(
                lower, count, state.leader_count, slice_size,
                state.least_free, use_slices=True)
            if fit_domains is None:
                return None, "internal: assignment accounting underflow"
            level += 1
        while level < len(self.level_keys) - 1:
            # At/below the slice level (or after balanced placement), pods
            # are distributed per parent domain
            # (tas_flavor_snapshot.go:1095-1130); inner multi-layer
            # constraints re-anchor the slice size per level.
            if level >= slice_level_idx:
                slice_on_level = state.slice_size_at_level.get(level + 1, 1)
            else:
                slice_on_level = slice_size
            new_fit = []
            for d in fit_domains:
                lower = self._sorted(d.children, state.least_free)
                if p1 is not None:
                    p1.save_list(lower)
                if slice_on_level > 1:
                    for c in lower:
                        c.slice_state = c.state // slice_on_level
                        c.slice_state_with_leader = \
                            c.state_with_leader // slice_on_level
                out = self._update_counts_to_minimum(
                    lower, d.state, d.leader_state, slice_on_level,
                    state.least_free, use_slices=slice_on_level > 1)
                if out is None:
                    return None, "internal: assignment accounting underflow"
                new_fit.extend(out)
            fit_domains = new_fit
            level += 1

        # Leader/worker split (tas_flavor_snapshot.go:1134-1157): leaders
        # land in the chosen domains that reserved leader capacity.
        assignments: dict[str, TopologyAssignment] = {}
        if leader is not None:
            leader_domains = []
            worker_domains = []
            for d in fit_domains:
                if d.leader_state > 0:
                    leader_domains.append(
                        TopologyDomainAssignment(d.values, d.leader_state))
                if d.state > 0:
                    worker_domains.append(d)
            assignments[leader.pod_set.name] = TopologyAssignment(
                tuple(self.level_keys),
                tuple(sorted(leader_domains, key=lambda a: a.values)))
            fit_domains = worker_domains

        domains = sorted(
            (TopologyDomainAssignment(d.values, d.state)
             for d in fit_domains if d.state > 0),
            key=lambda a: a.values)
        assignments[workers.pod_set.name] = TopologyAssignment(
            tuple(self.level_keys), tuple(domains))
        return assignments, ""

    # -- unhealthy-node replacement (tas_flavor_snapshot.go:747) --

    def is_topology_assignment_stale(
            self, assignment: TopologyAssignment) -> tuple[bool, str]:
        """IsTopologyAssignmentStale :878 — domains that no longer exist
        (node deleted / NotReady)."""
        for dom in assignment.domains:
            if tuple(dom.values) not in self.domains:
                return True, dom.values[0]
        return False, ""

    def find_replacement_assignment(
        self,
        tr: TASPodSetRequest,
        existing: TopologyAssignment,
        unhealthy_nodes,
        assumed_usage: dict,
    ) -> tuple[Optional[TopologyAssignment], Optional[TopologyAssignment],
               str]:
        """findReplacementAssignment :747: drop the unhealthy nodes'
        domains from the existing assignment, re-place only the affected
        pods (pinned to the required replacement domain when
        slices/required demand it), and merge. Unlike the reference (one
        node per pass), all currently-unhealthy nodes are replaced in one
        shot — in our model a failed node leaves the topology immediately,
        so a second dead node would otherwise trip the staleness check
        forever. Returns (new_full_assignment, replacement_only,
        reason)."""
        if isinstance(unhealthy_nodes, str):
            unhealthy_nodes = (unhealthy_nodes,)
        kept, affected = _delete_domains(existing, unhealthy_nodes)
        stale, stale_domain = self.is_topology_assignment_stale(kept)
        if stale:
            return None, None, (
                "cannot replace the node: existing topologyAssignment "
                f"contains the stale domain {stale_domain!r}")
        if affected == 0:
            return kept, TopologyAssignment(existing.levels, ()), ""
        required_domain = self._required_replacement_domain(tr, kept,
                                                           affected)
        tr_copy = TASPodSetRequest(tr.pod_set, tr.single_pod_requests,
                                   affected)
        treq = tr.pod_set.topology_request
        slice_size = (treq.slice_size or 1) if treq else 1
        if slice_size > 1 and required_domain and affected % slice_size != 0:
            # The replacement alone is not whole slices; keep leaf-level
            # grouping by dropping the slice constraint for the re-find
            # (the innermost dividing constraint, :768-789).
            tr_copy = TASPodSetRequest(
                replace(tr.pod_set,
                        topology_request=replace(treq, slice_size=None,
                                                 slice_level=None)),
                tr.single_pod_requests, affected)
        assignments, reason = self.find_topology_assignments(
            tr_copy, None, assumed_usage=assumed_usage,
            required_replacement_domain=required_domain)
        if reason:
            return None, None, reason
        repl = assignments[tr.pod_set.name]
        if not repl.domains:
            return None, None, (
                f"cannot find replacement assignment for unhealthy "
                f"node(s): {', '.join(unhealthy_nodes)}")
        merged = _merge_assignments(repl, kept)
        return merged, repl, ""

    def _required_replacement_domain(self, tr: TASPodSetRequest,
                                     kept: TopologyAssignment,
                                     missing: int) -> tuple:
        """requiredReplacementDomain :826: the domain the replacement must
        stay inside — the incomplete-slice domain for sliced pod sets, or
        the original required-level domain for required mode."""
        treq = tr.pod_set.topology_request
        if treq is None or not kept.domains:
            return ()
        slice_size = treq.slice_size or 1
        remaining = sum(d.count for d in kept.domains)
        if slice_size > 1 and (remaining + missing) % slice_size == 0 \
                and remaining % slice_size != 0:
            # findIncompleteSliceDomain :905: the slice-level domain whose
            # pod count needs topping up to a whole slice.
            slice_key = treq.slice_level or self.level_keys[-1]
            if slice_key not in self.level_keys:
                return ()
            slice_idx = self.level_keys.index(slice_key)
            usage: dict[tuple, int] = {}
            for dom in kept.domains:
                usage[tuple(dom.values[:slice_idx + 1])] = \
                    usage.get(tuple(dom.values[:slice_idx + 1]), 0) \
                    + dom.count
            for values, count in sorted(usage.items()):
                if (count + missing) % slice_size == 0:
                    return values
            return ()
        if treq.mode != TopologyMode.REQUIRED or treq.level is None:
            return ()
        if treq.level not in self.level_keys:
            return ()
        level_idx = self.level_keys.index(treq.level)
        return tuple(kept.domains[0].values[:level_idx + 1])

    def _leaf_fits(self, pod_set: PodSet, per_pod: dict[str, int],
                   leader_per_pod: Optional[dict[str, int]],
                   leaf: _Domain, simulate_empty: bool,
                   assumed_usage: dict,
                   required_replacement_domain: tuple,
                   excluded: dict) -> None:
        """fillLeafCounts :1864 — pods that fit, plus leader variants.
        ``excluded`` is the matchNode verdict map (_match_excluded):
        taints / full-label selectors / required node affinity."""
        leaf.state = 0
        leaf.leader_state = 0
        leaf.state_with_leader = 0
        if required_replacement_domain and \
                leaf.values[:len(required_replacement_domain)] != \
                required_replacement_domain:
            return
        if leaf.values in excluded:
            return

        remaining = dict(leaf.free_capacity)
        if not simulate_empty:
            for res, used in leaf.tas_usage.items():
                remaining[res] = remaining.get(res, 0) - used
            for res, used in assumed_usage.get(leaf.id, {}).items():
                remaining[res] = remaining.get(res, 0) - used

        def count_in(requests: dict[str, int]) -> int:
            counts = []
            for res, need in requests.items():
                if need == 0:
                    continue
                if res == "pods" and res not in leaf.free_capacity:
                    continue  # no explicit pod capacity: unlimited
                counts.append(max(0, remaining.get(res, 0)) // need)
            return min(counts) if counts else 0

        leaf.state = count_in(per_pod)
        if leader_per_pod is not None and count_in(leader_per_pod) > 0:
            leaf.leader_state = 1
            for res, need in leader_per_pod.items():
                remaining[res] = remaining.get(res, 0) - need
        # stateWithLeader is CountIn(remaining) UNCONDITIONALLY
        # (fillLeafCounts :1897): when the leader doesn't fit here it
        # equals state — the descent consume walk takes full worker
        # capacity from leaderless domains instead of wasting them.
        leaf.state_with_leader = count_in(per_pod)

    def _p1_repair(self, p1, per_pod: dict[str, int], excluded: dict,
                   state: _AssignState) -> bool:
        """Refresh phase-1 counts for the leaves whose tas_usage changed
        while the memo was live, plus their ancestor sums — the
        incremental form of fill_in_counts_np for the leaderless,
        no-assumed-usage, single-slice-size case (the memo's
        eligibility gate). Mirrors the vectorized leaf formula exactly:
        per-resource clamped floor-division, "pods" unconstrained for
        leaves without explicit pod capacity, matchNode exclusions
        zeroing the leaf. Returns False when the drift is too large to
        beat a refill or the geometry is out of scope."""
        if state.slice_size_at_level:
            return False
        if len(p1.stale) > 64:
            return False
        nl = len(self.level_keys)
        slice_size = state.slice_size
        slice_idx = state.slice_level_idx
        leaf_level = nl - 1
        changed: list = []
        parents: dict[int, _Domain] = {}
        for leaf in sorted(p1.stale, key=lambda d: d.values):
            if leaf.values not in self.leaves:
                continue  # removed node: _version bump misses the key
            if excluded and leaf.values in excluded:
                cnt = 0
            else:
                free = leaf.free_capacity
                usage = leaf.tas_usage
                cnt = _INF
                applied = False
                for res, need in per_pod.items():
                    if need <= 0:
                        continue
                    c = max(0, free.get(res, 0)
                            - usage.get(res, 0)) // need
                    if res == "pods":
                        if "pods" not in free:
                            continue  # unconstrained (fillLeafCounts)
                    applied = True
                    if c < cnt:
                        cnt = c
                if not applied:
                    cnt = 0
            leaf.state = cnt
            leaf.state_with_leader = cnt
            leaf.leader_state = 0
            sl = cnt // slice_size if leaf_level == slice_idx else 0
            leaf.slice_state = sl
            leaf.slice_state_with_leader = sl
            changed.append(leaf)
            d = leaf.parent
            while d is not None and id(d) not in parents:
                parents[id(d)] = d
                d = d.parent
        # Ancestors bottom-up (deepest level first): each sum reads the
        # children's already-current counts.
        for d in sorted(parents.values(), key=lambda a: -len(a.values)):
            st = 0
            for c in d.children:
                st += c.state
            lvl = len(d.values) - 1
            if lvl == slice_idx:
                sl = st // slice_size
            elif lvl < slice_idx:
                sl = 0
                for c in d.children:
                    sl += c.slice_state
            else:
                sl = 0
            d.state = st
            d.state_with_leader = st
            d.leader_state = 0
            d.slice_state = sl
            d.slice_state_with_leader = sl
            changed.append(d)
        if p1.sorts and changed:
            from bisect import insort
            by_level: dict[int, list] = {}
            for d in changed:
                by_level.setdefault(len(d.values) - 1, []).append(d)
            for (lvl, least_free), lst in p1.sorts.items():
                ch = by_level.get(lvl)
                if not ch:
                    continue
                if least_free:
                    def keyf(x):
                        return (-x.leader_state,
                                x.slice_state_with_leader,
                                x.state_with_leader, x.values)
                else:
                    def keyf(x):
                        return (-x.leader_state,
                                -x.slice_state_with_leader,
                                x.state_with_leader, x.values)
                try:
                    for d in ch:
                        lst.remove(d)  # identity (_Domain has no __eq__)
                except ValueError:
                    # A changed domain missing from a cached level order
                    # means the memo predates a structure change the key
                    # should have caught — discard it (the caller refills
                    # and builds a fresh memo).
                    return False
                for d in ch:
                    insort(lst, d, key=keyf)
        return True

    def _fill_in_counts(self, pod_set: PodSet, per_pod: dict[str, int],
                        leader_per_pod: Optional[dict[str, int]],
                        state: _AssignState, simulate_empty: bool,
                        assumed_usage: dict,
                        required_replacement_domain: tuple = ()) -> None:
        """fillInCounts :1750. The no-leader case runs as numpy
        reductions over the cached leaf matrices (tas/device.py
        fill_in_counts_np — ~10x the per-leaf dict walk); leader
        co-placement keeps the object walk (min-diff bubbling)."""
        # Any fill stomps every domain's count fields: whoever called —
        # including balanced pruning via bubble_up after this returns —
        # owns them now. The memoized host path re-installs its memo
        # right after this call; every other caller leaves it dead.
        self._p1 = None
        excluded = self._match_excluded(pod_set)
        if leader_per_pod is None:
            from kueue_tpu_torch.tas import device
            if device.fill_in_counts_np(
                    self, pod_set, per_pod, state.slice_size,
                    state.slice_level_idx, simulate_empty,
                    assumed_usage or {}, required_replacement_domain,
                    excluded, state.slice_size_at_level):
                return
        for d in self.domains.values():
            d.state = 0
            d.slice_state = 0
            d.state_with_leader = 0
            d.slice_state_with_leader = 0
            d.leader_state = 0
        for leaf in self.leaves.values():
            self._leaf_fits(pod_set, per_pod, leader_per_pod, leaf,
                            simulate_empty, assumed_usage,
                            required_replacement_domain, excluded)
        for root in self.roots.values():
            self.bubble_up(root, state.slice_size, state.slice_level_idx,
                           0, leader_required=state.leader_count > 0,
                           slice_size_at_level=state.slice_size_at_level)

    def bubble_up(self, domain: _Domain, slice_size: int,
                  slice_level_idx: int, level: int,
                  leader_required: bool,
                  slice_size_at_level: Optional[dict] = None) -> None:
        """fillInCountsHelper :1906 — roll child capacities up one subtree.
        Also used by balanced-placement pruning to re-aggregate clones.
        With multi-layer constraints, children at a constrained level
        contribute pods rounded down to multiples of the inner slice
        size (:1925-1930)."""
        if not domain.children:
            if level == slice_level_idx:
                domain.slice_state = domain.state // slice_size
                domain.slice_state_with_leader = \
                    domain.state_with_leader // slice_size
            return
        children_capacity = 0
        slice_capacity = 0
        has_leader_contributor = False
        min_state_diff = _INF
        min_slice_diff = _INF
        leader_state = 0
        inner = (slice_size_at_level or {}).get(level + 1)
        for child in domain.children:
            self.bubble_up(child, slice_size, slice_level_idx, level + 1,
                           leader_required,
                           slice_size_at_level=slice_size_at_level)
            child_state = child.state
            child_swl = child.state_with_leader
            if inner:
                child_state = (child_state // inner) * inner
                child_swl = (child_swl // inner) * inner
            children_capacity += child_state
            slice_capacity += child.slice_state
            if not leader_required or child.leader_state > 0:
                has_leader_contributor = True
                min_state_diff = min(min_state_diff,
                                     child_state - child_swl)
                min_slice_diff = min(
                    min_slice_diff,
                    child.slice_state - child.slice_state_with_leader)
            leader_state = max(leader_state, child.leader_state)
        domain.state = children_capacity
        slice_with_leader = 0
        if has_leader_contributor:
            domain.state_with_leader = children_capacity - min_state_diff
            slice_with_leader = slice_capacity - min_slice_diff
        else:
            domain.state_with_leader = 0
        domain.leader_state = leader_state
        if level == slice_level_idx:
            slice_capacity = domain.state // slice_size
            slice_with_leader = domain.state_with_leader // slice_size
        domain.slice_state = slice_capacity
        domain.slice_state_with_leader = slice_with_leader

    def _sorted(self, domains: list, least_free: bool) -> list:
        """sortedDomains :1721 — BestFit order (sliceState desc, state asc,
        values asc), or LeastFreeCapacity ascending under the
        TASProfileMixed unconstrained profile."""
        if least_free:
            return sorted(domains,
                          key=lambda d: (d.slice_state, d.state, d.values))
        return sorted(domains,
                      key=lambda d: (-d.slice_state, d.state, d.values))

    def _sorted_with_leader(self, domains: list,
                            least_free: bool) -> list:
        """sortedDomainsWithLeader :1683 — leader capacity first."""
        if least_free:
            return sorted(domains, key=lambda d: (
                -d.leader_state, d.slice_state_with_leader,
                d.state_with_leader, d.values))
        return sorted(domains, key=lambda d: (
            -d.leader_state, -d.slice_state_with_leader,
            d.state_with_leader, d.values))

    def _find_level_with_fit(self, level_idx: int, slice_count: int,
                             state: _AssignState, sort_cache=None):
        """findLevelWithFitDomains :1377. ``sort_cache`` (a _Phase1Memo
        sorts dict, leaderless callers only) shares the per-level sorted
        order across the heads of a cycle: selection never mutates
        counts, and the memo's restore() reverts descent mutations
        before the next head sorts, so the cached order stays exact."""
        sorted_domains = None
        cache_key = (level_idx, state.least_free)
        if sort_cache is not None:
            sorted_domains = sort_cache.get(cache_key)
        if sorted_domains is None:
            domains = list(self.domains_per_level[level_idx].values()) \
                if self.level_keys else []
            if not domains:
                level_name = (self.level_keys[level_idx]
                              if self.level_keys else "")
                return 0, [], f"no topology domains at level: {level_name}"
            sorted_domains = self._sorted_with_leader(domains,
                                                     state.least_free)
            if sort_cache is not None:
                sort_cache[cache_key] = sorted_domains
        top = sorted_domains[0]
        if not state.least_free \
                and top.slice_state_with_leader >= slice_count \
                and top.leader_state >= state.leader_count:
            # optimize the potentially last domain
            top = _best_fit_for_slices(sorted_domains, slice_count,
                                       state.leader_count)
        if state.least_free:
            # LeastFreeCapacity: the fullest single domain that fits.
            # Deliberate deviation: when a leader must co-place, the
            # single-domain scan also requires leader capacity — the
            # reference checks only sliceState (:1402) and then emits an
            # empty assignment when the chosen domain can't host the
            # leader; requiring it here lets such groups fall through to
            # the multi-domain greedy and place correctly.
            for d in sorted_domains:
                if d.slice_state >= slice_count and (
                        state.leader_count == 0
                        or (d.slice_state_with_leader >= slice_count
                            and d.leader_state >= state.leader_count)):
                    return level_idx, [d], ""
        if top.slice_state_with_leader < slice_count or \
                top.leader_state < state.leader_count:
            if state.required:
                return 0, [], self._not_fit(state, top.slice_state,
                                            slice_count, level_idx)
            if level_idx > 0 and not state.unconstrained:
                return self._find_level_with_fit(level_idx - 1, slice_count,
                                                 state,
                                                 sort_cache=sort_cache)
            # Multi-domain greedy (:1430-1469): leaders first, then the
            # remaining domains re-sorted by worker capacity.
            results = []
            remaining = slice_count
            remaining_leaders = state.leader_count
            idx = 0
            while remaining_leaders > 0 and idx < len(sorted_domains) \
                    and sorted_domains[idx].leader_state > 0:
                d = sorted_domains[idx]
                if not state.least_free and \
                        d.slice_state_with_leader >= remaining:
                    d = _best_fit_for_slices(sorted_domains[idx:], remaining,
                                             remaining_leaders)
                results.append(d)
                remaining_leaders -= d.leader_state
                remaining -= d.slice_state_with_leader
                idx += 1
            if remaining_leaders > 0:
                return 0, [], self._not_fit(
                    state, state.leader_count - remaining_leaders,
                    slice_count, level_idx)
            # Leaderless (sort_cache) with no leader loop entered: the
            # with-leader order degenerates to the plain order (every
            # leader_state is 0 and *_with_leader ≡ the plain counts),
            # so the cached list IS the re-sort — skip it.
            if sort_cache is not None and idx == 0:
                rest = sorted_domains
            else:
                rest = self._sorted(sorted_domains[idx:], state.least_free)
            for i, d in enumerate(rest):
                if remaining <= 0:
                    break
                if d.slice_state <= 0:
                    # Zero-capacity domains contribute nothing and are
                    # filtered at assignment build; under LeastFreeCapacity
                    # ordering they sort FIRST, and the reference appends
                    # them all (thousands of zero-take domains threaded
                    # through the descent on a full cluster) — skip.
                    continue
                if not state.least_free and d.slice_state >= remaining:
                    d = _best_fit_for_slices(rest[i:], remaining, 0)
                results.append(d)
                remaining -= d.slice_state
            if remaining > 0:
                return 0, [], self._not_fit(
                    state, slice_count - remaining, slice_count, level_idx)
            return level_idx, results, ""
        return level_idx, [top], ""

    def _update_counts_to_minimum(self, sorted_domains: list, count: int,
                                  leader_count: int, slice_size: int,
                                  least_free: bool,
                                  use_slices: bool) -> Optional[list]:
        """updateCountsToMinimumGeneric :1575 + consumeWithLeadersGeneric
        :1518: distribute ``count`` pods (and the leader) over a minimal
        prefix of the sorted domains, clamping each domain's state to
        its assigned amount.

        Deliberate deviation in the multi-domain leader walk: the
        reference consumes the leader at the FIRST capable domain in
        worker-sort order, while the phase-1 bubbling that admitted this
        placement promised the MIN-DIFF placement (fillInCountsHelper
        :1930 takes min(state - stateWithLeader) over capable children)
        — so the reference's own walk can fall short of its selection
        and abort with errCodeAssumptionsViolated on feasible worlds.
        Here the leader (when no single domain completes the whole
        request) lands at the capable domain minimizing lost worker
        capacity, honoring the selection's arithmetic; the
        single-domain tight-fit completion path is unchanged."""
        results = []
        rem = [count // slice_size if use_slices else count, leader_count]

        def primary(d):
            return d.slice_state if use_slices else d.state

        def primary_wl(d):
            return d.slice_state_with_leader if use_slices \
                else d.state_with_leader

        def commit(d, take, leaders):
            d.leader_state = leaders
            if use_slices:
                d.slice_state = take
                d.state = take * slice_size
            else:
                d.state = take
            rem[0] -= take
            rem[1] -= leaders

        for i, dom in enumerate(sorted_domains):
            if rem[0] <= 0 and rem[1] <= 0:
                break
            if rem[1] > 0:
                # Single-domain completion (with the leader-filtered
                # best-fit swap): the whole remainder + leader in one
                # tight domain.
                d = dom
                if not least_free and primary_wl(dom) >= rem[0] \
                        and dom.leader_state >= rem[1]:
                    d = (_best_fit_for_slices if use_slices
                         else _best_fit_for_pods)(
                        sorted_domains[i:], rem[0], rem[1])
                if primary_wl(d) >= rem[0] and d.leader_state >= rem[1]:
                    commit(d, rem[0] + 0, rem[1])
                    results.append(d)
                    return results
                # No completion here: the leader goes to the min-diff
                # capable domain among the remainder; everything else
                # contributes full worker capacity.
                capable = [d2 for d2 in sorted_domains[i:]
                           if d2.leader_state >= rem[1]]
                if not capable:
                    return None
                min_dom = min(capable,
                              key=lambda d2: primary(d2) - primary_wl(d2))
                if dom is min_dom:
                    commit(dom, min(primary_wl(dom), rem[0]), rem[1])
                else:
                    commit(dom, min(primary(dom), rem[0]), 0)
                if dom.state > 0 or dom.leader_state > 0:
                    results.append(dom)
                continue
            # No leaders remaining: tail without leaders.
            if not least_free and primary(dom) >= rem[0]:
                dom = (_best_fit_for_slices if use_slices
                       else _best_fit_for_pods)(sorted_domains[i:],
                                                rem[0], 0)
            dom.leader_state = 0
            if primary(dom) >= rem[0]:
                commit(dom, rem[0] + 0, 0)
                results.append(dom)
                return results
            commit(dom, primary(dom), 0)
            if dom.state > 0:
                results.append(dom)
        if rem[0] > 0 or rem[1] > 0:
            return None  # accounting violated upstream
        return results

    def _not_fit(self, state: _AssignState, fit: int, want: int,
                 level_idx: int) -> str:
        """notFitReason closure of findLevelWithFitDomains :1394."""
        if state.multi_layer:
            return self._multi_layer_not_fit_message(
                level_idx, state.count, state.multi_layer, state.stats())
        return self._not_fit_message(fit, want, state.slice_size,
                                     state.stats())

    def _not_fit_message(self, fit: int, want: int, slice_size: int = 1,
                         stats: Optional[ExclusionStats] = None) -> str:
        """notFitMessage :1971 — quantities in slice units when slices
        are requested, with the exclusion-stats tail."""
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

    def _multi_layer_not_fit_message(self, level_idx: int, count: int,
                                     constraints: tuple,
                                     stats: Optional[ExclusionStats]
                                     ) -> str:
        """multiLayerNotFitMessage :2004: per-layer best-case fit counts
        from the best domain at the required level."""
        msg = f'topology "{self.topology_name}" doesn\'t allow to fit'
        best = None
        for d in self.domains_per_level[level_idx].values():
            if best is None or d.slice_state > best.slice_state or (
                    d.slice_state == best.slice_state and d.id < best.id):
                best = d
        if best is None:
            return msg
        for layer_key, layer_size in constraints:
            if layer_key not in self.level_keys:
                continue
            target_idx = self.level_keys.index(layer_key)
            needed = count // layer_size
            fit = _count_slices_in_subtree(best, level_idx, target_idx,
                                           layer_size)
            msg += f"; {fit}/{needed} slice(s) fit on level {layer_key}"
        if stats is not None and stats.has_exclusions():
            msg += (f". Total nodes: {stats.total_nodes}; "
                    f"excluded: {stats.format_reasons()}")
        return msg


def _count_slices_in_subtree(d, current_level: int, target_level: int,
                             slice_size: int) -> int:
    """countSlicesInSubtree :1993."""
    if current_level == target_level:
        return d.state // slice_size
    return sum(_count_slices_in_subtree(c, current_level + 1, target_level,
                                        slice_size) for c in d.children)


def _best_fit_by(sorted_domains: list, needed: int, cap, ok=None):
    """findBestFitDomainBy :1355: the FIRST domain with the lowest
    capacity >= needed; the first (most-capacity) domain if none fit.
    ``ok`` is an extra candidacy filter (see the deviation below)."""
    best = sorted_domains[0]
    best_cap = cap(best)
    for d in sorted_domains:
        c = cap(d)
        if c >= needed and c < best_cap and (ok is None or ok(d)):
            best = d
            best_cap = c
    return best


def _best_fit_for_slices(sorted_domains: list, slice_count: int,
                         leader_count: int):
    """findBestFitDomainForSlices :1342. Deliberate deviation: when a
    leader must co-place, only leader-capable domains are best-fit
    candidates — the reference filters on sliceStateWithLeader alone,
    and (since stateWithLeader == state for leaderless domains,
    fillLeafCounts :1897) can swap in a smaller domain that cannot host
    the leader and then fail a placement that fits (review repro:
    2 hosts, the leader-infeasible one barely covers the workers)."""
    if leader_count > 0:
        return _best_fit_by(
            sorted_domains, slice_count,
            lambda d: d.slice_state_with_leader,
            ok=lambda d: d.leader_state >= leader_count)
    return _best_fit_by(sorted_domains, slice_count,
                        lambda d: d.slice_state)


def _best_fit_for_pods(sorted_domains: list, count: int, leader_count: int):
    """findBestFitDomain :1326 — pod-count flavor of the above, same
    leader-capability deviation."""
    if leader_count > 0:
        return _best_fit_by(sorted_domains, count,
                            lambda d: d.state_with_leader,
                            ok=lambda d: d.leader_state >= leader_count)
    return _best_fit_by(sorted_domains, count, lambda d: d.state)


def _find_leader_and_workers(trs: list[TASPodSetRequest]):
    """findLeaderAndWorkers :729 — in a 2-pod-set group the smaller-count
    pod set is the leader."""
    workers = trs[0]
    leader = None
    if len(trs) > 1:
        leader = trs[1]
        if leader.count > workers.count:
            leader, workers = workers, leader
    return leader, workers


def _add_assumed(assumed: dict, assignment: TopologyAssignment,
                 tr: TASPodSetRequest) -> None:
    """addAssumedUsage :799."""
    if assignment is None:
        return
    for dom in assignment.domains:
        bucket = assumed.setdefault(tuple(dom.values), {})
        for res, per_pod in tr.single_pod_requests.items():
            bucket[res] = bucket.get(res, 0) + per_pod * dom.count
        bucket["pods"] = bucket.get("pods", 0) + dom.count


IS_GROUP_WORKLOAD_ANNOTATION = "kueue.x-k8s.io/is-group-workload"


def owned_by_single_pod(workload) -> bool:
    """workload.OwnedBySinglePod (pkg/workload/workload.go:1309): one
    core/v1 Pod owner and not a pod-group workload."""
    if workload is None:
        return False
    refs = tuple(getattr(workload, "owner_references", ()) or ())
    if len(refs) != 1:
        return False
    anns = getattr(workload, "annotations", {}) or {}
    if anns.get(IS_GROUP_WORKLOAD_ANNOTATION) == "true":
        return False
    api_version, kind = refs[0][0], refs[0][1]
    return kind == "Pod" and api_version == "v1"


def _existing_assignment(workload, pod_set_name: str):
    """findPSA :810."""
    status = getattr(workload, "status", None)
    admission = getattr(status, "admission", None)
    if admission is None:
        return None
    for psa in admission.pod_set_assignments:
        if psa.name == pod_set_name and psa.topology_assignment is not None:
            return psa.topology_assignment
    return None


def _delete_domains(assignment: TopologyAssignment,
                    unhealthy_nodes) -> tuple[TopologyAssignment, int]:
    """deleteDomain :884 — drop the domains whose leaf value is an
    unhealthy node; return (kept, affected_pod_count)."""
    failed = set(unhealthy_nodes)
    kept = []
    affected = 0
    for dom in assignment.domains:
        if dom.values[-1] in failed:
            affected += dom.count
        else:
            kept.append(dom)
    return TopologyAssignment(assignment.levels, tuple(kept)), affected


def _merge_assignments(repl: TopologyAssignment,
                       kept: TopologyAssignment) -> TopologyAssignment:
    """mergeTopologyAssignments — sum counts per domain, lex order."""
    counts: dict[tuple, int] = {}
    for dom in list(kept.domains) + list(repl.domains):
        counts[tuple(dom.values)] = counts.get(tuple(dom.values), 0) \
            + dom.count
    return TopologyAssignment(kept.levels, tuple(
        TopologyDomainAssignment(values, count)
        for values, count in sorted(counts.items())))


def _add_assumed(assumed: dict, assignment: TopologyAssignment,
                 tr: TASPodSetRequest) -> None:
    """addAssumedUsage :799."""
    if assignment is None:
        return
    for dom in assignment.domains:
        bucket = assumed.setdefault(tuple(dom.values), {})
        for res, per_pod in tr.single_pod_requests.items():
            bucket[res] = bucket.get(res, 0) + per_pod * dom.count
        bucket["pods"] = bucket.get("pods", 0) + dom.count
