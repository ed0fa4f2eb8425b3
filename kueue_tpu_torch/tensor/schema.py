"""Dense numpy encoding of the scheduling world, trimmed from
``kueue_tpu/tensor/schema.py``: the arrays the device cycle consumes.

Layout conventions:
  * Nodes 0..C-1 are ClusterQueues, C..N-1 are Cohorts. -1 = "none".
  * A flavor-resource index is fl * S + s (dense NF x S grid); undefined
    pairs carry nominal 0 and INF borrowing and lending limits.

All quantity arrays are int64 (milli-units, INF sentinel = api.types.INF).
The arrays stay numpy here; the solver moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kueue_tpu_torch.api.types import (
    INF,
    BorrowWithinCohortPolicy,
    FungibilityPolicy,
    FungibilityPreference,
    PreemptionPolicy,
    QueueingStrategy,
)
from kueue_tpu_torch.cache.queues import scheduling_hash
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot, Snapshot
from kueue_tpu_torch.workload_info import WorkloadInfo, queue_order_timestamp


@dataclass
class WorldTensors:
    """The dense snapshot."""

    # -- dimensions --
    num_cqs: int
    num_nodes: int
    num_flavors: int
    num_resources: int
    max_flavors_per_group: int
    max_groups: int
    depth: int  # max ancestor-chain length

    # -- name maps (host-only) --
    cq_names: list
    cohort_names: list
    flavor_names: list
    resource_names: list

    # -- cohort forest --
    parent: np.ndarray  # int32[N] node index, -1 = root
    ancestors: np.ndarray  # int32[N, depth], padded -1, [i,0] = parent
    height: np.ndarray  # int32[N] subtree height (cohorts; CQs = 0)

    # -- quotas [N, R] where R = NF * S --
    nominal: np.ndarray  # int64
    borrow_limit: np.ndarray  # int64, INF = unlimited
    lend_limit: np.ndarray  # int64, INF = everything lendable
    usage: np.ndarray  # int64, CQ rows only; cohort rows derived in ops

    # -- per-CQ config --
    group_of_res: np.ndarray  # int32[C, S] resource-group id, -1 = uncovered
    group_flavors: np.ndarray  # int32[C, G, F] flavor ids in try order, -1 pad
    no_preemption: np.ndarray  # bool[C] all preemption policies Never
    can_preempt_while_borrowing: np.ndarray  # bool[C]
    can_always_reclaim: np.ndarray  # bool[C] reclaimWithinCohort == Any
    best_effort: np.ndarray  # bool[C] BestEffortFIFO (parks NoFit heads)
    fung_borrow_try_next: np.ndarray  # bool[C] whenCanBorrow == TryNextFlavor
    fung_preempt_try_next: np.ndarray  # bool[C] whenCanPreempt == TryNextFlavor
    fung_pref_preempt_first: np.ndarray  # bool[C] PreemptionOverBorrowing
    fair_weight: np.ndarray  # float64[N]

    # -- root grouping: admissions interact only within a root subtree,
    # so the commit runs per root, batched across roots --
    num_roots: int = 1
    root_members: np.ndarray = None  # int32[Rn, M] CQ ids per root, -1 pad
    root_nodes: np.ndarray = None  # int32[Rn, K] subtree node ids, -1 pad
    local_chain: np.ndarray = None  # int32[C, depth+1] chain positions
    #   into root_nodes[root_of(cq)], -1 pad
    root_parent_local: np.ndarray = None  # int32[Rn, K] parent position
    root_of_cq: np.ndarray = None  # int32[C] root row per ClusterQueue
    child_rank: np.ndarray = None  # int64[N] position in the parent's
    #   ordered child list (cohorts first, then CQs)
    local_depth: np.ndarray = None  # int32[Rn, K] distance from the root row


@dataclass
class WorkloadTensors:
    """Pending workloads on the fast path. The pod-set axis is padded to
    ``num_podsets`` (a power of two <= MAX_FAST_PODSETS); padding rows
    carry zero requests."""

    num_workloads: int
    keys: list  # host-side workload keys, aligned with rows
    cq: np.ndarray  # int32[W] CQ index
    priority: np.ndarray  # int64[W] effective priority
    timestamp: np.ndarray  # float64[W] queue-order timestamp
    requests: np.ndarray  # int64[W, P, S] count-scaled totals per podset
    has_quota_reservation: np.ndarray  # bool[W]
    eligible: np.ndarray  # bool[W] encodable on the fast path
    hash_id: np.ndarray = None  # int32[W] scheduling-equivalence id
    num_podsets: int = 1  # P


MAX_FAST_PODSETS = 8


def pow2_bucket(n: int, floor: int) -> int:
    """Power-of-two bucket for a dynamic axis length."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def pad_axis0(arr: np.ndarray, target: int, fill) -> np.ndarray:
    """Pad axis 0 to ``target`` rows with a sentinel fill."""
    a = np.asarray(arr)
    if a.shape[0] >= target:
        return a
    return np.concatenate(
        [a, np.full((target - a.shape[0],) + a.shape[1:], fill, a.dtype)])


# Workload-axis sentinel fills for bucket padding: rank/commit_rank BIG
# (never a head), cq 0 with pending=False.
WL_PAD_FILLS = dict(rank=np.int64(1) << 40, commit_rank=np.int64(1) << 40,
                    wl_cq=0, wl_req=0, wl_priority=0, wl_has_qr=False,
                    wl_hash=0, wl_ts=0.0)


def build_root_grouping(parent: np.ndarray, ancestors: np.ndarray,
                        num_cqs: int, max_depth: int):
    """Group the cohort forest by root subtree for the parallel commit.
    Nodes 0..num_cqs-1 must be the CQ rows.

    Returns (num_roots, root_members int32[Rn, M], root_nodes
    int32[Rn, K], local_chain int32[C, max_depth+1], root_parent_local
    int32[Rn, K], root_of_cq int32[C], local_depth int32[Rn, K])."""
    N = parent.shape[0]
    C = num_cqs
    root_of = np.arange(N, dtype=np.int32)
    for i in range(N):
        a = i
        while parent[a] >= 0:
            a = parent[a]
        root_of[i] = a
    roots = sorted(set(int(r) for r in root_of))
    root_idx = {r: i for i, r in enumerate(roots)}
    Rn = len(roots)
    members_of = [[] for _ in range(Rn)]
    nodes_of = [[] for _ in range(Rn)]
    for i in range(N):
        ri = root_idx[int(root_of[i])]
        nodes_of[ri].append(i)
        if i < C:
            members_of[ri].append(i)
    M = max((len(m) for m in members_of), default=1) or 1
    K = max((len(n) for n in nodes_of), default=1) or 1
    root_members = np.full((Rn, M), -1, np.int32)
    root_nodes = np.full((Rn, K), -1, np.int32)
    node_pos = {}
    for ri in range(Rn):
        for j, m in enumerate(members_of[ri]):
            root_members[ri, j] = m
        for j, nd in enumerate(nodes_of[ri]):
            root_nodes[ri, j] = nd
            node_pos[nd] = j
    local_chain = np.full((C, max_depth + 1), -1, np.int32)
    for ci in range(C):
        local_chain[ci, 0] = node_pos[ci]
        for d in range(max_depth):
            a = ancestors[ci, d]
            if a < 0:
                break
            local_chain[ci, d + 1] = node_pos[int(a)]
    root_parent_local = np.full((Rn, K), -1, np.int32)
    for ri in range(Rn):
        for j, nd in enumerate(nodes_of[ri]):
            p = parent[nd]
            if p >= 0:
                root_parent_local[ri, j] = node_pos[int(p)]
    root_of_cq = np.zeros(max(C, 1), np.int32)
    for ri in range(Rn):
        for m in members_of[ri]:
            root_of_cq[m] = ri
    local_depth = np.full((Rn, K), -1, np.int32)
    for ri in range(Rn):
        for j, nd in enumerate(nodes_of[ri]):
            d, a = 0, j
            while root_parent_local[ri, a] >= 0:
                a = int(root_parent_local[ri, a])
                d += 1
            local_depth[ri, j] = d
    return (Rn, root_members, root_nodes, local_chain, root_parent_local,
            root_of_cq, local_depth)


def encode_snapshot(snap: Snapshot, max_depth: int = 8) -> WorldTensors:
    """Flatten a Snapshot into dense arrays."""
    cq_names = sorted(snap.cluster_queues)
    cohort_names = sorted(snap.cohorts)
    cq_idx = {n: i for i, n in enumerate(cq_names)}
    cohort_idx = {n: len(cq_names) + i for i, n in enumerate(cohort_names)}
    C = len(cq_names)
    N = C + len(cohort_names)

    flavor_names = sorted(snap.resource_flavors)
    resource_names = sorted({
        fr.resource
        for cqs in snap.cluster_queues.values()
        for fr in cqs.node.quotas
    } | {
        fr.resource
        for cs in snap.cohorts.values()
        for fr in cs.node.quotas
    })
    # Flavors referenced in quotas but not registered as ResourceFlavor
    # objects still need ids.
    referenced = {
        fr.flavor
        for node in list(snap.cluster_queues.values()) + list(
            snap.cohorts.values())
        for fr in node.node.quotas
    }
    for f in sorted(referenced - set(flavor_names)):
        flavor_names.append(f)
    fl_idx = {n: i for i, n in enumerate(flavor_names)}
    s_idx = {n: i for i, n in enumerate(resource_names)}
    NF, S = len(flavor_names), len(resource_names)
    R = max(NF * S, 1)

    parent = np.full(N, -1, np.int32)
    fair_weight = np.ones(N, np.float64)

    def node_of(obj) -> int:
        if isinstance(obj, ClusterQueueSnapshot):
            return cq_idx[obj.name]
        return cohort_idx[obj.name]

    all_nodes = [snap.cluster_queues[n] for n in cq_names] + \
                [snap.cohorts[n] for n in cohort_names]
    for i, node in enumerate(all_nodes):
        if node.parent is not None:
            parent[i] = node_of(node.parent)
        fair_weight[i] = node.fair_weight

    ancestors = np.full((N, max_depth), -1, np.int32)
    for i in range(N):
        a, d = parent[i], 0
        while a >= 0 and d < max_depth:
            ancestors[i, d] = a
            a = parent[a]
            d += 1

    height = np.zeros(N, np.int32)
    for name, cs in snap.cohorts.items():
        height[cohort_idx[name]] = cs.height()

    nominal = np.zeros((N, R), np.int64)
    borrow_limit = np.full((N, R), INF, np.int64)
    lend_limit = np.full((N, R), INF, np.int64)
    usage = np.zeros((N, R), np.int64)
    for i, node in enumerate(all_nodes):
        for fr, q in node.node.quotas.items():
            if fr.flavor not in fl_idx or fr.resource not in s_idx:
                continue
            r = fl_idx[fr.flavor] * S + s_idx[fr.resource]
            nominal[i, r] = q.nominal
            if q.borrowing_limit is not None:
                borrow_limit[i, r] = q.borrowing_limit
            if q.lending_limit is not None:
                lend_limit[i, r] = q.lending_limit
        for fr, u in node.node.usage.items():
            if i >= C:
                continue  # cohort usage is derived
            if fr.flavor not in fl_idx or fr.resource not in s_idx:
                continue
            usage[i, fl_idx[fr.flavor] * S + s_idx[fr.resource]] = u

    G = max((len(snap.cluster_queues[n].spec.resource_groups)
             for n in cq_names), default=1) or 1
    F = 1
    for n in cq_names:
        for rg in snap.cluster_queues[n].spec.resource_groups:
            F = max(F, len(rg.flavors))

    group_of_res = np.full((C, S), -1, np.int32)
    group_flavors = np.full((C, G, F), -1, np.int32)
    no_preemption = np.zeros(C, bool)
    can_pwb = np.zeros(C, bool)
    can_always_reclaim = np.zeros(C, bool)
    best_effort = np.zeros(C, bool)
    fung_b_try = np.zeros(C, bool)
    fung_p_try = np.zeros(C, bool)
    fung_pref_p = np.zeros(C, bool)
    for ci, n in enumerate(cq_names):
        spec = snap.cluster_queues[n].spec
        for gi, rg in enumerate(spec.resource_groups):
            for res in rg.covered_resources:
                if res in s_idx:
                    group_of_res[ci, s_idx[res]] = gi
            for fi, fq in enumerate(rg.flavors):
                # A quota naming an unregistered ResourceFlavor is an
                # unusable slot: -1 keeps the flavor scan off it.
                if fq.name in snap.resource_flavors:
                    group_flavors[ci, gi, fi] = fl_idx[fq.name]
        best_effort[ci] = (spec.queueing_strategy
                           == QueueingStrategy.BEST_EFFORT_FIFO)
        p = spec.preemption
        can_always_reclaim[ci] = (p.reclaim_within_cohort
                                  == PreemptionPolicy.ANY)
        no_preemption[ci] = (
            p.within_cluster_queue == PreemptionPolicy.NEVER
            and p.reclaim_within_cohort == PreemptionPolicy.NEVER)
        can_pwb[ci] = (
            (p.borrow_within_cohort is not None
             and p.borrow_within_cohort.policy
             != BorrowWithinCohortPolicy.NEVER)
            or (snap.cluster_queues[n].fair_sharing_enabled
                and p.reclaim_within_cohort != PreemptionPolicy.NEVER))
        fung = spec.flavor_fungibility
        fung_b_try[ci] = (fung.when_can_borrow
                          == FungibilityPolicy.TRY_NEXT_FLAVOR)
        fung_p_try[ci] = (fung.when_can_preempt
                          == FungibilityPolicy.TRY_NEXT_FLAVOR)
        fung_pref_p[ci] = (fung.preference
                           == FungibilityPreference.PREEMPTION_OVER_BORROWING)

    (Rn, root_members, root_nodes, local_chain, root_parent_local,
     root_of_cq, local_depth) = build_root_grouping(parent, ancestors, C,
                                                    max_depth)

    child_rank = np.zeros(N, np.int64)
    for cs in snap.cohorts.values():
        children = list(cs.child_cohorts) + list(cs.child_cqs)
        for j, ch in enumerate(children):
            child_rank[node_of(ch)] = j

    return WorldTensors(
        num_cqs=C, num_nodes=N, num_flavors=NF, num_resources=S,
        max_flavors_per_group=F, max_groups=G, depth=max_depth,
        cq_names=cq_names, cohort_names=cohort_names,
        flavor_names=flavor_names, resource_names=resource_names,
        parent=parent, ancestors=ancestors, height=height,
        nominal=nominal, borrow_limit=borrow_limit, lend_limit=lend_limit,
        usage=usage, group_of_res=group_of_res, group_flavors=group_flavors,
        no_preemption=no_preemption, can_preempt_while_borrowing=can_pwb,
        can_always_reclaim=can_always_reclaim, best_effort=best_effort,
        fung_borrow_try_next=fung_b_try, fung_preempt_try_next=fung_p_try,
        fung_pref_preempt_first=fung_pref_p, fair_weight=fair_weight,
        num_roots=Rn, root_members=root_members, root_nodes=root_nodes,
        local_chain=local_chain, root_parent_local=root_parent_local,
        root_of_cq=root_of_cq, child_rank=child_rank,
        local_depth=local_depth,
    )


@dataclass
class AdmittedTensors:
    """Admitted workloads: the preemption-candidate pool."""

    num_admitted: int  # row count (== array length; may exceed ``live``)
    keys: list  # host-side workload keys, aligned with rows
    cq: np.ndarray  # int32[A]
    priority: np.ndarray  # int64[A]
    timestamp: np.ndarray  # float64[A] creation time
    qr_time: np.ndarray  # float64[A] quota-reservation time
    uid_rank: np.ndarray  # int64[A] rank of the uid (candidate tiebreak)
    evicted: np.ndarray  # bool[A]
    usage: np.ndarray  # int64[A, R] on the flavor-resource grid
    live: int = None  # live admitted count (None = num_admitted)


def encode_admitted(world: WorldTensors, infos: list,
                    now: float = 0.0) -> AdmittedTensors:
    """Encode admitted workloads (WorkloadInfos with their flavors set)
    for the preemption target selection."""
    A = len(infos)
    R = max(world.num_flavors * world.num_resources, 1)
    cq_idx = {n: i for i, n in enumerate(world.cq_names)}
    fl_idx = {n: i for i, n in enumerate(world.flavor_names)}
    s_idx = {n: i for i, n in enumerate(world.resource_names)}
    S = world.num_resources

    cq = np.full(A, -1, np.int32)
    priority = np.zeros(A, np.int64)
    timestamp = np.zeros(A, np.float64)
    qr_time = np.zeros(A, np.float64)
    evicted = np.zeros(A, bool)
    usage = np.zeros((A, R), np.int64)
    keys = []
    uids = []
    for i, info in enumerate(infos):
        keys.append(info.key)
        uids.append(info.obj.uid)
        cq[i] = cq_idx.get(info.cluster_queue, -1)
        priority[i] = info.obj.effective_priority
        timestamp[i] = info.obj.creation_time
        qr_time[i] = info.obj.quota_reservation_time(now)
        evicted[i] = info.obj.is_evicted
        for fr, v in info.usage().items():
            if fr.flavor in fl_idx and fr.resource in s_idx:
                # Saturate at INF: larger host ints would wrap in int64.
                usage[i, fl_idx[fr.flavor] * S + s_idx[fr.resource]] = \
                    v if v < INF else INF
    uid_rank = np.empty(A, np.int64)
    uid_rank[np.argsort(np.asarray(uids, dtype=object))] = np.arange(A)
    return AdmittedTensors(
        num_admitted=A, keys=keys, cq=cq, priority=priority,
        timestamp=timestamp, qr_time=qr_time, uid_rank=uid_rank,
        evicted=evicted, usage=usage)


def encode_podset_requests(info, ci: int, world, s_idx: dict,
                           out) -> bool:
    """Fill one workload's [P, S] request rows (with the implicit pods
    resource when the CQ covers it). Returns False when a positive
    request names a resource outside the world's column space."""
    pods_si = s_idx.get("pods")
    covers_pods = (pods_si is not None
                   and world.group_of_res[ci, pods_si] >= 0)
    ok = True
    for p, psr in enumerate(info.total_requests):
        reqs = dict(psr.requests)
        if covers_pods:
            reqs["pods"] = psr.count
        for res, q in reqs.items():
            si = s_idx.get(res)
            if si is None:
                if q > 0:
                    ok = False
                continue
            # Saturate at INF: larger host ints would wrap in int64.
            out[p, si] = q if q < INF else INF
    return ok


def dense_path_eligible(info) -> bool:
    """Whether a pending workload can be decided on the dense device
    path. Ineligible: more pod sets than MAX_FAST_PODSETS, partial
    admission (min_count), topology requests, node selectors, affinity
    or tolerations, explicit zero-quantity requests (the dense encoding
    cannot tell them from absent ones) and elastic slice replacements."""
    if len(info.total_requests) > MAX_FAST_PODSETS:
        return False
    if info.obj.replaced_workload_slice is not None:
        return False
    for psr, ps in zip(info.total_requests, info.obj.pod_sets):
        if ps.min_count is not None or ps.topology_request is not None:
            return False
        if any(q == 0 for q in psr.requests.values()):
            return False
        if ps.node_selector or ps.node_affinity or ps.tolerations:
            return False
    return True


def encode_workloads(world: WorldTensors,
                     infos: list[WorkloadInfo]) -> WorkloadTensors:
    """Encode pending workloads; those beyond the fast-path shape
    (dense_path_eligible) are marked ineligible."""
    W = len(infos)
    S = world.num_resources
    cq_idx = {n: i for i, n in enumerate(world.cq_names)}
    s_idx = {n: i for i, n in enumerate(world.resource_names)}

    cq = np.full(W, -1, np.int32)
    priority = np.zeros(W, np.int64)
    timestamp = np.zeros(W, np.float64)
    has_qr = np.zeros(W, bool)
    eligible = np.ones(W, bool)
    hash_id = np.zeros(W, np.int32)
    hash_codes: dict = {}
    keys = []

    P = 1
    for info in infos:
        n = len(info.total_requests)
        if 1 < n and dense_path_eligible(info):
            P = max(P, n)
    P = pow2_bucket(P, 1)
    requests = np.zeros((W, P, S), np.int64)

    for i, info in enumerate(infos):
        keys.append(info.key)
        h = scheduling_hash(info.obj, info.cluster_queue)
        hash_id[i] = hash_codes.setdefault(h, len(hash_codes))
        cq[i] = cq_idx.get(info.cluster_queue, -1)
        priority[i] = info.obj.effective_priority
        timestamp[i] = queue_order_timestamp(info.obj)
        has_qr[i] = info.obj.has_quota_reservation
        if cq[i] < 0 or not dense_path_eligible(info):
            eligible[i] = False
            continue
        if not encode_podset_requests(info, int(cq[i]), world, s_idx,
                                      requests[i]):
            eligible[i] = False
    return WorkloadTensors(
        num_workloads=W, keys=keys, cq=cq, priority=priority,
        timestamp=timestamp, requests=requests,
        has_quota_reservation=has_qr, eligible=eligible, hash_id=hash_id,
        num_podsets=P)
