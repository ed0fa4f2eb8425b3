"""Batched classical preemption: target selection for every ClusterQueue
head at once. The port of ``kueue_tpu/ops/preempt.py``.

The classical preemptor is a pure function of the cycle-start snapshot:

  1. candidates: admitted workloads of the preemptor's cohort root that
     use a resource needing preemption and pass the ClusterQueue's
     policies (withinClusterQueue, reclaimWithinCohort,
     borrowWithinCohort);
  2. order them: evicted first, then hierarchy / priority / same-queue
     buckets, then priority ascending, quota reservation most recent
     first, uid ascending;
  3. greedily remove candidates until the preemptor fits (with the
     dynamic within-nominal validity of each candidate), in up to two
     borrowing attempts;
  4. fill back: walk the targets in reverse, skipping the last, and
     re-add any whose re-addition keeps the fit.

The JAX version vmaps one slot's program over the C slots and scans over
the V ordered candidates. Here every tensor carries the slot axis first
([C, ...]) and the V steps are a Python loop. A step whose outcome is
already decided for every slot (no candidate left to try, or every slot
found) changes nothing, so the loops stop there: that is exact, and it
costs one host sync per step.
"""

from __future__ import annotations

import torch

from kueue_tpu_torch.ops.quota import (
    available_along_chain,
    local_quota,
    sat_sub,
)

# withinClusterQueue / reclaimWithinCohort policy codes.
POLICY_NEVER = 0
POLICY_LOWER = 1
POLICY_LOWER_OR_NEWER_EQ = 2
POLICY_ANY = 3

# Candidate variants (the preemption reasons).
V_NEVER = 0
V_WITHIN_CQ = 1
V_HIERARCHICAL_RECLAIM = 2
V_RECLAIM_WITHOUT_BORROWING = 3
V_RECLAIM_WHILE_BORROWING = 4

# bwc_threshold sentinel: "no maxPriorityThreshold".
NO_THRESHOLD = 1 << 62


def _policy_ok(policy, p_pri, p_ts, c_pri, c_ts):
    """Whether a preemptor (priority, creation time) may preempt a
    candidate under ``policy``; broadcasts."""
    lower = p_pri > c_pri
    newer_eq = (p_pri == c_pri) & (p_ts < c_ts)
    return torch.where(
        policy == POLICY_LOWER, lower,
        torch.where(policy == POLICY_LOWER_OR_NEWER_EQ, lower | newer_eq,
                    policy == POLICY_ANY))


def _adjust_chain_usage(g_usage, g_lq, removed, *, depth):
    """Usage rows along a chain [..., D+1, S] after removing ``removed``
    [..., S] from the ClusterQueue (position 0): the CQ row drops by
    ``removed``; each ancestor drops by the change in its child's usage
    above local quota (the inverse of the usage bubbling)."""
    cq_old = g_usage[..., 0, :]
    cq_new = torch.clamp(cq_old - removed, min=0)
    rows = [cq_new]
    over_old = torch.clamp(sat_sub(cq_old, g_lq[..., 0, :]), min=0)
    over_new = torch.clamp(sat_sub(cq_new, g_lq[..., 0, :]), min=0)
    delta = over_old - over_new
    for d in range(1, depth + 1):
        a_old = g_usage[..., d, :]
        a_new = torch.clamp(a_old - delta, min=0)
        rows.append(a_new)
        over_old = torch.clamp(sat_sub(a_old, g_lq[..., d, :]), min=0)
        over_new = torch.clamp(sat_sub(a_new, g_lq[..., d, :]), min=0)
        delta = over_old - over_new
    return torch.stack(rows, dim=-2)


def _lexsort(keys, shape):
    """Per-row stable lexicographic order of ``keys`` (least significant
    first, as ``jnp.lexsort`` takes them; each broadcastable to ``shape``
    [B, n]): chained stable argsorts, the most significant key last."""
    B, n = shape
    order = torch.arange(n, device=keys[0].device).expand(B, n)
    for k in keys:
        kk = torch.take_along_dim(k.expand(B, n), order, dim=1)
        order = torch.take_along_dim(
            order, torch.argsort(kk, dim=1, stable=True), dim=1)
    return order


def _rows(t, idx):
    """t [B, K, ...] gathered at idx [B, J] along K: [B, J, ...]."""
    idx = idx.long()
    return torch.take_along_dim(
        t, idx.reshape(idx.shape + (1,) * (t.dim() - 2)), dim=1)


def within_cq_targets(
    slot_need,  # bool[C] head needs within-CQ preemption on this slot
    slot_pri,  # int64[C] preemptor effective priority
    slot_ts,  # float64[C] preemptor creation time
    slot_fr,  # int32[C, S] chosen flavor-resource per resource (-1 none)
    slot_req,  # int64[C, S] requested amount per resource
    wcq_policy,  # int32[C] POLICY_* code per CQ
    adm_cq,  # int32[A] admitted workload's CQ
    adm_pri,  # int64[A]
    adm_ts,  # float64[A] creation time
    adm_qrt,  # float64[A] quota-reservation time (recent = larger)
    adm_uid,  # int64[A] uid rank (ascending tie-break)
    adm_evicted,  # bool[A]
    adm_usage,  # int64[A, R] usage on the fr grid
    usage,  # int64[N, R] cycle-start usage (aggregated)
    subtree_quota, lend_limit, borrow_limit, ancestors,
    *,
    depth: int,
    v_max: int,
):
    """Within-ClusterQueue preemption (reclaimWithinCohort Never): the
    candidates are the preemptor's own CQ's admitted workloads. Returns
    per slot: found bool[C], overflow bool[C] (more than v_max victims
    needed), target_mask bool[C, A], n_targets int64[C]."""
    C, S = slot_req.shape
    A = adm_cq.shape[0]
    V = min(v_max, A)
    dev = slot_req.device
    lq = local_quota(subtree_quota, lend_limit)
    c = torch.arange(C, device=dev)
    frs_safe = torch.clamp(slot_fr, min=0).long()
    active = (slot_fr >= 0) & (slot_req > 0)
    req = slot_req

    chain = torch.cat([c[:, None], ancestors[:C].long()], dim=1)
    chain_ok = chain >= 0
    chain_safe = torch.clamp(chain, min=0)
    rows, cols = chain_safe[:, :, None], frs_safe[:, None, :]
    g_sq = subtree_quota[rows, cols]  # [C, D+1, S]
    g_lq = lq[rows, cols]
    g_bl = borrow_limit[rows, cols]
    g_usage = usage[rows, cols]

    # Resources needing preemption: request above what is available.
    avail0 = available_along_chain(chain_ok, g_sq, g_lq, g_bl, g_usage,
                                   depth=depth)
    need_fr = active & (req > avail0)

    cand_usage = adm_usage[:, frs_safe].permute(1, 0, 2) \
        * active[:, None, :]  # [C, A, S]
    uses_any = torch.where(need_fr[:, None, :], cand_usage > 0,
                           False).any(dim=2)
    is_cand = slot_need[:, None] & (adm_cq[None, :] == c[:, None]) \
        & uses_any & _policy_ok(wcq_policy[:, None], slot_pri[:, None],
                                slot_ts[:, None], adm_pri[None, :],
                                adm_ts[None, :])

    # Evicted first, priority ascending, reserved most recently first,
    # uid ascending; non-candidates last.
    order = _lexsort([adm_uid, -adm_qrt, adm_pri,
                      torch.where(adm_evicted, 0, 1),
                      torch.where(is_cand, 0, 1)], (C, A))
    n_cand = is_cand.sum(dim=1)
    v_ids = order[:, :V]
    ks = torch.arange(V, device=dev)
    v_valid = torch.gather(is_cand, 1, v_ids) & (ks[None, :] < n_cand[:, None])
    v_usage = torch.where(v_valid[:, :, None], _rows(cand_usage, v_ids), 0)
    prefix = torch.cumsum(v_usage, dim=1)  # [C, V, S] removed after k+1

    def fits_with(removed):
        """removed [C, S] or [C, V, S] -> bool[C] or bool[C, V]."""
        lead = removed.dim() - 1
        ex = (lambda t: t[:, None]) if lead == 2 else (lambda t: t)
        adj = _adjust_chain_usage(ex(g_usage), ex(g_lq), removed,
                                  depth=depth)
        avail = available_along_chain(ex(chain_ok), ex(g_sq), ex(g_lq),
                                      ex(g_bl), adj, depth=depth)
        return torch.where(ex(active), ex(req) <= avail, True).all(dim=-1)

    fits_k = fits_with(prefix) & v_valid  # fits after k+1 removals
    any_fit = fits_k.any(dim=1)
    kstar = torch.argmax(fits_k.to(torch.int32), dim=1)  # first fit
    overflow = slot_need & ~any_fit & (n_cand > V)
    found = slot_need & any_fit

    # Fill-back over targets kstar-1 .. 0 (the last never fills back).
    kept = (ks[None, :] <= kstar[:, None]) & v_valid & found[:, None]
    n_fb = int(kstar[found].max()) if bool(found.any()) else 0
    for i in range(n_fb):
        idx = kstar - 1 - i
        in_range = (idx >= 0) & found
        idx_safe = torch.clamp(idx, min=0)
        trial = kept & (ks[None, :] != idx_safe[:, None])
        removed = torch.where(trial[:, :, None], v_usage, 0).sum(dim=1)
        ok = in_range & torch.gather(kept, 1, idx_safe[:, None])[:, 0] \
            & fits_with(removed)
        kept = torch.where(ok[:, None], trial, kept)

    target_mask = torch.zeros((C, A + 1), dtype=torch.bool, device=dev) \
        .scatter_(1, torch.where(kept, v_ids, A), True)[:, :A]
    return found, overflow, target_mask, kept.sum(dim=1)


def classical_targets_impl(
    slot_need,  # bool[C] head needs preemption on this slot
    slot_pri,  # int64[C] preemptor effective priority
    slot_ts,  # float64[C] preemptor creation time
    slot_fr,  # int32[C, S] chosen flavor-resource per resource (-1 none)
    slot_req,  # int64[C, S] requested amount per resource
    wcq_policy,  # int32[C] withinClusterQueue POLICY_* code
    reclaim_policy,  # int32[C] reclaimWithinCohort POLICY_* code
    bwc_forbidden,  # bool[C] borrowWithinCohort is Never/absent
    bwc_threshold,  # int64[C] maxPriorityThreshold (NO_THRESHOLD = none)
    cq_has_parent,  # bool[C]
    adm_cq,  # int32[A] admitted workload's CQ
    adm_pri,  # int64[A]
    adm_ts,  # float64[A] creation time
    adm_qrt,  # float64[A] quota-reservation time (recent = larger)
    adm_uid,  # int64[A] uid rank (ascending tie-break)
    adm_evicted,  # bool[A]
    adm_usage,  # int64[A, R] usage on the fr grid
    usage,  # int64[N, R] cycle-start usage (aggregated)
    subtree_quota, lend_limit, borrow_limit, nominal,  # int64[N, R]
    ancestors,  # int32[N, D]
    height,  # int32[N] subtree height per node
    local_chain,  # int32[C, D+1] positions into the CQ root's node row
    root_nodes,  # int32[Rn, K]
    root_of_cq,  # int32[C]
    slot_cq=None,  # int32[C'] CQ id per row (default: row index)
    adm_rank=None,  # int64[A] precomputed rank of the slot-independent
    #   ordering tail (priority asc, reservation recency desc, uid asc):
    #   one composite-key argsort per slot instead of a 6-key lexsort
    adm_by_root=None,  # int32[Rn, A_l] admitted ids grouped by cohort
    #   root (-1 pad): candidate work per slot is O(A_l), not O(A);
    #   victim ids in the outputs stay global
    *,
    depth: int,
    v_cap: int,
):
    """The full classical preemptor for all heads at once.

    Returns per slot: found bool[C], overflow bool[C], target_mask
    bool[C, A], n_targets int64[C], variant [C, A] (candidate variants),
    borrow_after int32[C] (the assignment's borrow level with the victims
    removed), victim ids int32[C, V] (global) and taken bool[C, V]."""
    C, S = slot_req.shape
    A = adm_cq.shape[0]
    A_l = A if adm_by_root is None else adm_by_root.shape[1]
    V = min(v_cap, A_l)
    dev = slot_req.device
    lq_all = local_quota(subtree_quota, lend_limit)
    ar = torch.arange(C, device=dev)

    adm_cq_safe = torch.clamp(adm_cq, min=0).long()
    adm_chain = torch.cat([adm_cq[:, None].long(),
                           ancestors[adm_cq_safe].long()], dim=1)  # [A, D+1]
    adm_loc = local_chain[adm_cq_safe].long()  # [A, D+1]

    c = ar if slot_cq is None else slot_cq.long()
    frs_safe = torch.clamp(slot_fr, min=0).long()
    active = (slot_fr >= 0) & (slot_req > 0)
    req = slot_req
    root_c = root_of_cq[c].long()

    # Candidate scope: with adm_by_root, only the slot's root's admitted
    # rows (candidates never cross cohort roots).
    if adm_by_root is None:
        g_rows = None
        rsafe = None
        l_ok = torch.ones((C, A), dtype=torch.bool, device=dev)
        l_cq, l_pri, l_ts, l_qrt, l_uid, l_ev = (
            t.expand(C, A) for t in (adm_cq, adm_pri, adm_ts, adm_qrt,
                                     adm_uid, adm_evicted))
        l_usage = adm_usage.expand((C,) + adm_usage.shape)
        l_chain = adm_chain.expand((C,) + adm_chain.shape)
        l_loc = adm_loc.expand((C,) + adm_loc.shape)
        l_rank = None if adm_rank is None else adm_rank.expand(C, A)
    else:
        g_rows = adm_by_root[root_c]  # [C, A_l] global ids
        l_ok = g_rows >= 0
        rsafe = torch.clamp(g_rows, min=0).long()
        l_cq = torch.where(l_ok, adm_cq[rsafe], -1)
        l_pri = adm_pri[rsafe]
        l_ts = adm_ts[rsafe]
        l_qrt = adm_qrt[rsafe]
        l_uid = adm_uid[rsafe]
        l_ev = adm_evicted[rsafe] & l_ok
        l_usage = torch.where(l_ok[:, :, None], adm_usage[rsafe], 0)
        l_chain = torch.where(l_ok[:, :, None], adm_chain[rsafe], -1)
        l_loc = torch.where(l_ok[:, :, None], adm_loc[rsafe], -1)
        # Pad rows sort last; they can never be candidates.
        l_rank = (None if adm_rank is None
                  else torch.where(l_ok, adm_rank[rsafe], A))

    # Root-local state over the slot's root, columns = the slot's chosen
    # flavor-resources: [C, K, S].
    nodes = root_nodes[root_c]
    node_ok = nodes >= 0
    nodes_safe = torch.clamp(nodes, min=0).long()

    def gather_l(arr):
        g = arr[nodes_safe[:, :, None], frs_safe[:, None, :]]
        return torch.where(node_ok[:, :, None], g, 0)

    usage_l0 = gather_l(usage)
    sq_l = gather_l(subtree_quota)
    lq_l = gather_l(lq_all)
    bl_l = gather_l(borrow_limit)
    nom_l = gather_l(nominal)
    height_l = torch.where(node_ok, height[nodes_safe], 0)

    loc_c = local_chain[c].long()  # [C, D+1] positions into K
    chain_ok_c = loc_c >= 0
    loc_c_safe = torch.clamp(loc_c, min=0)
    cq_row = loc_c_safe[:, 0]
    g_sq_c = _rows(sq_l, loc_c_safe)
    g_lq_c = _rows(lq_l, loc_c_safe)
    g_bl_c = _rows(bl_l, loc_c_safe)
    sq_cq = sq_l[ar, cq_row]

    def fits_with(usage_l, allow_borrow):
        avail = available_along_chain(chain_ok_c, g_sq_c, g_lq_c, g_bl_c,
                                      _rows(usage_l, loc_c_safe),
                                      depth=depth)
        ok = torch.where(active, req <= avail, True).all(dim=1)
        # Fits without borrowing: usage + req within the CQ's quota.
        nb_ok = torch.where(active, usage_l[ar, cq_row] + req <= sq_cq,
                            True).all(dim=1)
        return ok & (allow_borrow | nb_ok)

    avail0 = available_along_chain(chain_ok_c, g_sq_c, g_lq_c, g_bl_c,
                                   _rows(usage_l0, loc_c_safe), depth=depth)
    need_fr = active & (req > avail0)
    any_need = slot_need & need_fr.any(dim=1)

    # Hierarchical advantage: adv_before[:, d] says whether a strict
    # subtree below level d already fits the remaining request in quota.
    lavail0 = torch.clamp(lq_l - usage_l0, min=0)
    fits_cq = torch.where(active, sq_cq >= usage_l0[ar, cq_row] + req,
                          True).all(dim=1)
    rem = torch.where(active, torch.clamp(req - lavail0[ar, cq_row], min=0),
                      0)
    adv = fits_cq
    adv_before = [torch.zeros(C, dtype=torch.bool, device=dev)]
    for d in range(1, depth + 1):
        adv_before.append(adv)
        r = loc_c_safe[:, d]
        fits_d = torch.where(active, sq_l[ar, r] >= usage_l0[ar, r] + rem,
                             True).all(dim=1)
        adv = adv | (fits_d & chain_ok_c[:, d])
        rem = torch.where(active, torch.clamp(rem - lavail0[ar, r], min=0),
                          0)
    adv_before = torch.stack(adv_before, dim=1)  # [C, D+1]

    # --- candidate classification over the admitted rows in scope ---
    c_chain = torch.cat([c[:, None], ancestors[c].long()], dim=1)
    same_cq = l_cq == c[:, None]
    same_root = (l_ok if g_rows is not None else
                 root_of_cq[torch.clamp(l_cq, min=0).long()]
                 == root_of_cq[c][:, None])
    # LCA level: the lowest d >= 1 with c_chain[d] on the candidate's
    # chain.
    NO_LCA = depth + 9
    lca_level = torch.full(l_cq.shape, NO_LCA, dtype=torch.long, device=dev)
    for d in range(depth, 0, -1):
        on_chain = torch.zeros(l_cq.shape, dtype=torch.bool, device=dev)
        for e in range(depth + 1):
            on_chain = on_chain | (l_chain[:, :, e] == c_chain[:, d, None])
        on_chain = on_chain & (c_chain[:, d] >= 0)[:, None]
        lca_level = torch.where(on_chain, d, lca_level)
    has_lca = lca_level <= depth
    lca_clip = torch.clamp(lca_level, 0, depth)
    lca_node = torch.take_along_dim(c_chain, lca_clip, dim=1)
    # Candidate-chain position of the LCA.
    lca_pos = torch.full(l_cq.shape, NO_LCA, dtype=torch.long, device=dev)
    for e in range(depth, -1, -1):
        lca_pos = torch.where(l_chain[:, :, e] == lca_node, e, lca_pos)

    n_l = l_cq.shape[1]
    uses_any = ((torch.take_along_dim(
        l_usage, frs_safe[:, None, :].expand(C, n_l, S), dim=2) > 0)
        & need_fr[:, None, :]).any(dim=2)
    w_pol = wcq_policy[c][:, None]
    r_pol = reclaim_policy[c][:, None]
    pol = torch.where(same_cq, w_pol, r_pol)
    pol_gate = torch.where(same_cq, w_pol != POLICY_NEVER,
                           (r_pol != POLICY_NEVER) & cq_has_parent[c][:, None])
    pol_ok = _policy_ok(pol, slot_pri[:, None], slot_ts[:, None], l_pri, l_ts)

    adv_at_lca = torch.take_along_dim(adv_before, lca_clip, dim=1)
    bwc_forbidden_c = bwc_forbidden[c]
    rwob = bwc_forbidden_c[:, None] | (l_pri >= slot_pri[:, None]) \
        | (l_pri > bwc_threshold[c][:, None])
    variant = torch.where(
        same_cq, V_WITHIN_CQ,
        torch.where(adv_at_lca, V_HIERARCHICAL_RECLAIM,
                    torch.where(rwob, V_RECLAIM_WITHOUT_BORROWING,
                                V_RECLAIM_WHILE_BORROWING)))

    # Static within-nominal pruning: every node on the candidate's chain
    # strictly below the LCA must be above nominal in a needed resource.
    wn_rownominal = torch.where(need_fr[:, None, :], sq_l >= usage_l0,
                                True).all(dim=2)  # [C, K]
    static_bad = torch.zeros(l_cq.shape, dtype=torch.bool, device=dev)
    for e in range(depth + 1):
        loc_e = l_loc[:, :, e]
        below = (e < lca_pos) & (loc_e >= 0)
        static_bad = static_bad | (below & torch.take_along_dim(
            wn_rownominal, torch.clamp(loc_e, min=0), dim=1))

    is_cand = (any_need[:, None] & uses_any & pol_gate & pol_ok
               & (same_cq | (same_root & has_lca & ~static_bad)))
    bucket = torch.where(same_cq, 2, torch.where(adv_at_lca, 0, 1))

    no_other = ~(is_cand & ~same_cq).any(dim=1)
    no_hier = ~(is_cand & (bucket == 0)).any(dim=1)
    under_nominal = torch.where(need_fr, nom_l[ar, cq_row]
                                > usage_l0[ar, cq_row], True).all(dim=1)

    # Borrowing attempts.
    case1 = no_other | (bwc_forbidden_c & ~under_nominal)
    case2 = ~case1 & bwc_forbidden_c & no_hier
    b1, b2, en2 = ~case2, case2, ~case1

    # Evicted first, bucket, priority asc, reservation recency desc, uid
    # asc; non-candidates last.
    if l_rank is None:
        order = _lexsort([l_uid, -l_qrt, l_pri, bucket,
                          torch.where(l_ev, 0, 1),
                          torch.where(is_cand, 0, 1)], (C, n_l))
    else:
        # Only is_cand and bucket vary per slot; the rank is unique, so
        # one stable argsort of a composite key gives the order.
        lvl = (torch.where(is_cand, 0, 2) + torch.where(l_ev, 0, 1)) * 4 \
            + bucket
        order = torch.argsort(lvl.long() * (A + 1) + l_rank, dim=1,
                              stable=True)
    v_ids = order[:, :V]
    v_cand = torch.gather(is_cand, 1, v_ids)
    v_variant = torch.gather(variant, 1, v_ids)
    v_same = torch.gather(same_cq, 1, v_ids)
    v_loc = _rows(l_loc, v_ids)  # [C, V, D+1]
    v_lca_pos = torch.gather(lca_pos, 1, v_ids)
    v_usage = torch.take_along_dim(_rows(l_usage, v_ids),
                                   frs_safe[:, None, :], dim=2)  # [C, V, S]
    n_cand = is_cand.sum(dim=1)

    def add_row(usage_l, r, val):
        return usage_l.index_put((ar, r), val, accumulate=True)

    def remove_chain(usage_l, loc, val):
        """removeUsage along one chain per slot."""
        for e in range(depth + 1):
            row_ok = (loc[:, e] >= 0)[:, None]
            r = torch.clamp(loc[:, e], min=0)
            ssp = usage_l[ar, r] - lq_l[ar, r]
            usage_l = add_row(usage_l, r, torch.where(row_ok, -val, 0))
            val = torch.where(row_ok & (ssp > 0), torch.minimum(val, ssp), 0)
        return usage_l

    def add_chain(usage_l, loc, val):
        """addUsage along one chain per slot."""
        for e in range(depth + 1):
            row_ok = (loc[:, e] >= 0)[:, None]
            r = torch.clamp(loc[:, e], min=0)
            la = torch.clamp(lq_l[ar, r] - usage_l[ar, r], min=0)
            usage_l = add_row(usage_l, r, torch.where(row_ok, val, 0))
            val = torch.where(row_ok, torch.clamp(val - la, min=0), 0)
        return usage_l

    ks = torch.arange(V, device=dev)
    # Candidates sort first, so step i has one only where i < n_cand.
    n_steps = min(V, int(n_cand.max())) if C else 0

    def run_attempt(allow_borrow):
        usage_l = usage_l0
        found = torch.zeros(C, dtype=torch.bool, device=dev)
        taken = torch.zeros((C, V), dtype=torch.bool, device=dev)
        for i in range(n_steps):
            if i and not bool((~found & (n_cand > i)).any()):
                break  # every slot has found or run out of candidates
            ok = v_cand[:, i] & ~found
            # Dynamic candidate validity.
            bad_borrow = allow_borrow \
                & (v_variant[:, i] == V_RECLAIM_WITHOUT_BORROWING) \
                & ~v_same[:, i]
            wn_bad = torch.zeros(C, dtype=torch.bool, device=dev)
            for e in range(depth + 1):
                loc_e = v_loc[:, i, e]
                below = (e < v_lca_pos[:, i]) & (loc_e >= 0)
                r = torch.clamp(loc_e, min=0)
                wn = torch.where(need_fr, sq_l[ar, r] >= usage_l[ar, r],
                                 True).all(dim=1)
                wn_bad = wn_bad | (below & wn)
            valid = ok & ~bad_borrow & (v_same[:, i] | ~wn_bad)
            removed = remove_chain(usage_l, v_loc[:, i], v_usage[:, i])
            usage_l = torch.where(valid[:, None, None], removed, usage_l)
            taken[:, i] = valid
            found = found | (valid & fits_with(usage_l, allow_borrow))

        # Fill-back: reverse over the targets but the last, re-adding any
        # whose re-addition keeps the fit. Step i reads only taken[:, i],
        # which no earlier step changes, so the steps that consider some
        # slot are known up front.
        last_idx = torch.where(taken, ks, -1).max(dim=1).values
        consider = found[:, None] & taken & (ks[None, :] != last_idx[:, None])
        for i in sorted(torch.nonzero(consider.any(dim=0)).flatten()
                        .tolist(), reverse=True):
            trial = add_chain(usage_l, v_loc[:, i], v_usage[:, i])
            spared = consider[:, i] & fits_with(trial, allow_borrow)
            usage_l = torch.where(spared[:, None, None], trial, usage_l)
            taken[:, i] = taken[:, i] & ~spared
        return found, taken, usage_l

    def borrow_after_height(usage_l):
        """Height of the lowest subtree that fits the request against a
        root-local usage state; max over the slot's resources."""
        lavail = torch.clamp(lq_l - usage_l, min=0)
        borrowing_cq = nom_l[ar, cq_row] < usage_l[ar, cq_row] + req
        has_par = (chain_ok_c[:, 1] if depth >= 1
                   else torch.zeros(C, dtype=torch.bool, device=dev))
        remaining = torch.clamp(req - lavail[ar, cq_row], min=0)
        found_b = torch.zeros_like(active)
        found_h = torch.zeros(req.shape, dtype=height_l.dtype, device=dev)
        for d in range(1, depth + 1):
            r = loc_c_safe[:, d]
            okd = chain_ok_c[:, d, None]
            borrowing = sq_l[ar, r] < usage_l[ar, r] + remaining
            fits_here = okd & ~borrowing & ~found_b
            found_h = torch.where(fits_here, height_l[ar, r][:, None],
                                  found_h)
            found_b = found_b | fits_here
            remaining = torch.where(
                okd & ~found_b, torch.clamp(remaining - lavail[ar, r], min=0),
                remaining)
        root_h = torch.zeros(C, dtype=height_l.dtype, device=dev)
        for d in range(depth + 1):
            root_h = torch.where(chain_ok_c[:, d],
                                 height_l[ar, loc_c_safe[:, d]], root_h)
        h = torch.where(~borrowing_cq | ~has_par[:, None], 0,
                        torch.where(found_b, found_h, root_h[:, None]))
        return torch.where(active, h, 0).max(dim=1).values

    f1, t1, u1 = run_attempt(b1)
    if bool((~f1 & en2).any()):
        f2, t2, u2 = run_attempt(b2)
    else:  # the second attempt is read nowhere
        f2, t2, u2 = torch.zeros_like(f1), torch.zeros_like(t1), usage_l0
    use2 = ~f1 & en2 & f2
    found = (f1 | use2) & any_need
    taken = torch.where(f1[:, None], t1, torch.where(use2[:, None], t2,
                                                     False))
    overflow = slot_need & any_need & ~found & (n_cand > V)
    borrow_after = torch.where(
        f1, borrow_after_height(u1),
        torch.where(use2, borrow_after_height(u2), 0)).to(torch.int32)

    if g_rows is None:
        g_v_ids = v_ids
        variant_g = variant
    else:
        # Local victim positions and variants back to global ids.
        g_v_ids = torch.where(torch.gather(l_ok, 1, v_ids),
                              torch.gather(g_rows, 1, v_ids), -1)
        variant_g = torch.zeros((C, A + 1), dtype=variant.dtype,
                                device=dev).scatter_(
            1, torch.where(l_ok, rsafe, A), torch.where(l_ok, variant, 0)
        )[:, :A]
    target_mask = torch.zeros((C, A + 1), dtype=torch.bool, device=dev) \
        .scatter_(1, torch.where(taken & (g_v_ids >= 0), g_v_ids, A).long(),
                  True)[:, :A]
    return (found, overflow, target_mask, taken.sum(dim=1), variant_g,
            borrow_after,
            g_v_ids.to(torch.int32), taken)


def classical_targets(*args, depth: int, v_cap: int, slot_cq=None,
                      adm_rank=None, adm_by_root=None):
    """The standalone form: the first six outputs of
    ``classical_targets_impl`` (the packed victim lists only feed the
    fused cycle)."""
    return classical_targets_impl(*args, slot_cq=slot_cq, adm_rank=adm_rank,
                                  adm_by_root=adm_by_root, depth=depth,
                                  v_cap=v_cap)[:6]
