"""Sequential-equivalent commit: the port of ``kueue_tpu/ops/commit.py``
(the classical root-grouped commit with preemption victims, and the
fair-sharing tournament commit).

Nomination is parallel, but the scheduler commits entries one at a time
against evolving usage. Admissions never interact across root cohorts,
so each root's entries are committed in global key order against a
root-local usage carry, batched across roots: the sequential section is
the number of ClusterQueues per root, not the number of slots.
"""

from __future__ import annotations

import torch

from kueue_tpu_torch.api.types import INF
from kueue_tpu_torch.ops.quota import (
    available_along_chain,
    local_quota,
    sat_add,
    sat_sub,
)

ENTRY_SKIP = 0  # never commits (NoFit / ineligible slot)
ENTRY_FIT = 1  # commits if it still fits against evolving usage
ENTRY_RESERVE = 2  # preempt-mode without candidates: reserve capacity
ENTRY_FORCE = 3  # adds full usage unconditionally (replay of a decision)
ENTRY_PREEMPT = 4  # preempt-mode with selected victims: fit is checked
#   with the entry's victims removed; on success the removal persists for
#   later entries and the entry's usage is added, but the entry is
#   preempting, not admitted


def _entry_verdict(g_sq, g_lq, g_bl, g_usage, chain_ok, frs, req, kind,
                   borrows_k, cq_nom, cq_bl, cq_usage_now, *, depth):
    """Fit check and usage-bubbling amounts for a batch of entries.

    g_*: [B, D+1, S] gathers along each entry's ancestor chain (position
    0 = the CQ); chain_ok [B, D+1]; frs, req, cq_*: [B, S]; kind,
    borrows_k: [B]. Returns (fits bool[B], adds int64[B, D+1, S], the
    usage to add at each chain position, already masked)."""
    active = (frs >= 0) & (req > 0)
    g_local_avail = torch.clamp(sat_sub(g_lq, g_usage), min=0)
    avail = available_along_chain(chain_ok, g_sq, g_lq, g_bl, g_usage,
                                  depth=depth)

    fits = ((kind == ENTRY_FIT) | (kind == ENTRY_PREEMPT)) & torch.where(
        active, req <= avail, True).all(dim=-1)

    # Reservation amount: when borrowing, cap at nominal + borrowingLimit
    # - usage (full request without a limit); else clamp into the
    # remaining nominal headroom.
    borrowing_amt = torch.where(
        cq_bl >= INF, req,
        torch.minimum(req, sat_sub(sat_add(cq_nom, cq_bl), cq_usage_now)))
    nominal_amt = torch.clamp(
        torch.minimum(req, sat_sub(cq_nom, cq_usage_now)), min=0)
    reserve_req = torch.where(borrows_k[:, None] > 0, borrowing_amt,
                              nominal_amt)

    do_add = fits | (kind == ENTRY_RESERVE) | (kind == ENTRY_FORCE)
    v = torch.where((kind == ENTRY_RESERVE)[:, None], reserve_req, req)
    v = torch.where(active & do_add[:, None], v, 0)  # [B, S]

    # Usage bubbling: a node gets v, its parent max(0, v - local
    # available of the node).
    adds = []
    for d in range(depth + 1):
        adds.append(torch.where(chain_ok[:, d, None] & active, v, 0))
        v = torch.clamp(v - g_local_avail[:, d], min=0)
    return fits, torch.stack(adds, dim=1)


def _apply_victims(usage_l, lq_l, parent_local, rows, vals, *, depth):
    """Aggregated removal of victim usage over root-local node sets,
    batched over roots: victim usage is scattered at its CQ rows, then
    each row's share above local quota propagates to its parent, level by
    level. Exact against removing the victims one at a time: headroom use
    is monotone, so per-row sums give the same result.

    usage_l, lq_l: int64[Rn, K, R]; parent_local: int32[Rn, K]; rows:
    int32[Rn, V] victim CQ positions (-1 = none); vals: int64[Rn, V, R]."""
    Rn, K, R = usage_l.shape
    spare = usage_l.new_zeros((Rn, K + 1, R))
    idx = torch.where(rows >= 0, rows, K).long()
    rem = spare.scatter_add(1, idx[:, :, None].expand(-1, -1, R), vals)[:, :K]
    has_parent = parent_local >= 0
    p_idx = torch.where(has_parent, parent_local, K).long()[:, :, None] \
        .expand(-1, -1, R)
    for _ in range(depth + 1):
        prop = torch.clamp(torch.minimum(
            rem, torch.clamp(usage_l - lq_l, min=0)), min=0)
        usage_l = usage_l - rem
        rem = spare.scatter_add(
            1, p_idx, torch.where(has_parent[:, :, None], prop, 0))[:, :K]
    return usage_l


def _commit_one_local(usage_l, c, entry_fr, entry_req, entry_kind,
                      entry_borrows, subtree_quota, lq, borrow_limit,
                      nominal, ancestors, local_chain, *, depth,
                      victims=None, claimed=None):
    """Commit one entry per root: slot ``c`` [Rn] (-1 = none) against
    the root-local usage carry ``usage_l`` [Rn, K, R]. Shared by the
    grouped classical and fair commits.

    ``victims`` (optional): (row int32[C, V], vals int64[C, V, R], ids
    int32[C, V], lq_l [Rn, K, R], parent_local [Rn, K]), the victim sets
    of ENTRY_PREEMPT slots. Their fit is checked with the victims' usage
    removed along the victims' own chains, and the removal persists when
    they commit; an entry whose victims meet ``claimed`` bool[Rn, A]
    (preempted by an earlier entry of the root this cycle) is skipped.
    Returns (new_usage_l, new_claimed, fits bool[Rn])."""
    Rn = usage_l.shape[0]
    ok = c >= 0
    c_safe = torch.clamp(c, min=0).long()
    frs = entry_fr[c_safe]  # [Rn, S]
    req = torch.where(ok[:, None], entry_req[c_safe], 0)
    frs_safe = torch.clamp(frs, min=0).long()

    chain = torch.cat([c_safe[:, None], ancestors[c_safe].long()], dim=1)
    chain_ok = (chain >= 0) & ok[:, None]  # [Rn, D+1]
    chain_safe = torch.clamp(chain, min=0)
    loc_safe = torch.clamp(local_chain[c_safe], min=0).long()  # [Rn, D+1]

    rows = chain_safe[:, :, None]
    cols = frs_safe[:, None, :]
    g_sq = subtree_quota[rows, cols]  # [Rn, D+1, S]
    g_lq = lq[rows, cols]
    g_bl = borrow_limit[rows, cols]
    roots = torch.arange(Rn, device=usage_l.device)

    kind = torch.where(ok, entry_kind[c_safe], ENTRY_SKIP)
    is_pre = ok & (kind == ENTRY_PREEMPT)

    overlap = torch.zeros_like(ok)
    if victims is not None:
        v_row, v_vals, v_ids, lq_l, parent_local = victims
        trial = _apply_victims(
            usage_l, lq_l, parent_local,
            torch.where(is_pre[:, None], v_row[c_safe], -1), v_vals[c_safe],
            depth=depth)
        ids = v_ids[c_safe].long()  # [Rn, V]
        A = claimed.shape[1]
        overlap = is_pre & ((ids >= 0) & torch.gather(
            claimed, 1, torch.clamp(ids, 0, A - 1))).any(dim=1)
    else:
        trial = usage_l

    g_usage = trial[roots[:, None, None], loc_safe[:, :, None], cols]
    fits, adds = _entry_verdict(
        g_sq, g_lq, g_bl, g_usage, chain_ok, frs, req, kind,
        entry_borrows[c_safe], nominal[c_safe[:, None], frs_safe],
        borrow_limit[c_safe[:, None], frs_safe], g_usage[:, 0],
        depth=depth)
    fits = fits & ~overlap

    # ENTRY_PREEMPT: the victim removal persists only when the entry
    # commits. ``adds`` is already zero for entries that do not commit.
    new_usage = usage_l if victims is None else torch.where(
        (fits & is_pre)[:, None, None], trial, usage_l)
    # Accumulate: several resources of one entry can share a column
    # (masked ones all land on column 0 with a zero add).
    D1, S = adds.shape[1], adds.shape[2]
    new_usage = new_usage.index_put(
        (roots[:, None, None].expand(Rn, D1, S),
         loc_safe[:, :, None].expand(Rn, D1, S),
         frs_safe[:, None, :].expand(Rn, D1, S)),
        adds, accumulate=True)
    new_claimed = claimed
    if victims is not None:
        commit_pre = (fits & is_pre)[:, None] & (ids >= 0)
        A = claimed.shape[1]
        new_claimed = torch.cat([claimed, claimed.new_zeros((Rn, 1))],
                                dim=1).scatter_(
            1, torch.where(commit_pre, ids, A), True)[:, :A]
    return new_usage, new_claimed, fits & ok


def commit_grouped(
    entry_key,  # int64[C] commit-order sort key (lower = earlier)
    entry_valid,  # bool[C] slot participates this cycle
    entry_fr,  # int32[C, S]
    entry_req,  # int64[C, S]
    entry_kind,  # int32[C]
    entry_borrows,  # int32[C]
    usage0,  # int64[N, R]
    subtree_quota, lend_limit, borrow_limit, nominal, ancestors,
    root_members,  # int32[Rn, M] CQ/slot ids per root, -1 pad
    root_nodes,  # int32[Rn, K] subtree node ids per root, -1 pad
    local_chain,  # int32[C, D+1] chain positions into the root's node row
    root_parent_local=None,  # int32[Rn, K] parent positions (victims)
    slot_victim_row=None,  # int32[C, V] victim CQ local positions
    slot_victim_vals=None,  # int64[C, V, R] victim usage rows
    slot_victim_ids=None,  # int32[C, V] admitted-workload ids (overlap)
    claimed0=None,  # bool[A] initially claimed victims (usually zeros)
    *,
    depth: int,
):
    """Sequential-equivalent commit, batched across root subtrees: each
    root's entries are committed in global key order.

    ``slot_victim_*`` carry the preemption victims of ENTRY_PREEMPT
    slots: the fit check runs with the victims removed along their own
    chains, removals persist on success, and an entry whose victims were
    already claimed by an earlier entry of its root is skipped (one
    admission per cohort).

    Returns (admitted bool[C] by slot, final usage int64[N, R])."""
    C = entry_key.shape[0]
    BIGKEY = 1 << 62
    lq = local_quota(subtree_quota, lend_limit)
    # Invalid slots never commit, whatever their kind (valid keys of
    # entries without quota reservation carry bit 62 too).
    entry_kind = torch.where(entry_valid, entry_kind, ENTRY_SKIP)

    member_ok = root_members >= 0
    members_safe = torch.clamp(root_members, min=0).long()
    mkey = torch.where(member_ok & entry_valid[members_safe],
                       entry_key[members_safe], BIGKEY)
    morder = torch.argsort(mkey, dim=1, stable=True)
    sorted_members = torch.take_along_dim(root_members, morder, dim=1)

    node_ok = root_nodes >= 0
    nodes_safe = torch.clamp(root_nodes, min=0).long()
    usage_l = torch.where(node_ok[:, :, None],
                          usage0[nodes_safe], 0)  # [Rn, K, R]
    victims = claimed = None
    if slot_victim_row is not None:
        lq_locals = torch.where(node_ok[:, :, None], lq[nodes_safe], 0)
        victims = (slot_victim_row, slot_victim_vals, slot_victim_ids,
                   lq_locals, root_parent_local)
        claimed = claimed0[None, :].expand(root_members.shape[0], -1)
    fits_seq = []
    for m in range(sorted_members.shape[1]):
        usage_l, claimed, fits = _commit_one_local(
            usage_l, sorted_members[:, m], entry_fr, entry_req, entry_kind,
            entry_borrows, subtree_quota, lq, borrow_limit, nominal,
            ancestors, local_chain, depth=depth, victims=victims,
            claimed=claimed)
        fits_seq.append(fits)

    # Per-root verdicts back to slot order; slot C is the spare that
    # takes padding members.
    flat_members = sorted_members.reshape(-1)
    admitted = torch.zeros(C + 1, dtype=torch.bool, device=usage0.device)
    admitted[torch.where(flat_members >= 0, flat_members, C).long()] = \
        torch.stack(fits_seq, dim=1).reshape(-1)
    return admitted[:C], _scatter_local(usage0, root_nodes, usage_l)


def _scatter_local(usage0, root_nodes, usage_l):
    """Root-local usage [Rn, K, R] back into the node matrix (subtrees
    are disjoint and cover every node); row N is the spare for padding."""
    N, R = usage0.shape
    flat_nodes = root_nodes.reshape(-1)
    usage_final = torch.cat([usage0, usage0.new_zeros((1, R))])
    usage_final[torch.where(flat_nodes >= 0, flat_nodes, N).long()] = \
        usage_l.reshape(-1, R)
    return usage_final[:N]


def commit_grouped_fair(
    entry_valid,  # bool[C]
    entry_fr,  # int32[C, E] flavor-resource per entry column (-1 none)
    entry_req,  # int64[C, E]
    entry_kind,  # int32[C]
    entry_borrows,  # int32[C]
    entry_priority,  # int64[C]
    entry_ts,  # float64[C] creation time (ascending tiebreak)
    usage0,  # int64[N, R]
    subtree_quota, lend_limit, borrow_limit, nominal, ancestors,
    potential,  # int64[N, R] from quota.derive_world
    fair_weight,  # float64[N]
    parent,  # int32[N]
    root_members, root_nodes, local_chain,
    child_rank,  # int64[N] position in the parent's ordered child list
    local_depth,  # int32[Rn, K] chain distance from the root row
    root_parent_local,  # int32[Rn, K]
    *,
    depth: int,
    num_flavors: int,
):
    """Fair-sharing commit order: the hierarchical DRS tournament fused
    with the grouped commit. Per root subtree, repeat: simulate each
    candidate head's usage bubbled along its chain, compute the dominant
    resource share of every chain node (max over borrowed resources of
    borrowed * 1000 / lendable of the parent, divided by the fair-sharing
    weight; zero-weight borrowers last), run the bottom-up tournament over
    the cohort tree (at each cohort the surviving candidate of each child
    subtree competes on the DRS of its child-of-this-cohort node, then
    priority descending, creation time ascending, child order), and commit
    the root's winner against the evolving usage.

    The JAX version vmaps over roots and scans over M rounds; here the
    roots are a batch axis and the rounds a Python loop, stopped once no
    root has a candidate left (every later round commits nothing).

    Returns (admitted bool[C], round int32[C] commit round within the
    root (-1 = not admitted), usage int64[N, R])."""
    N, R = usage0.shape
    Rn, M = root_members.shape
    K = root_nodes.shape[1]
    NF = num_flavors
    # Resources per flavor, for the flavor-summed reshapes; the entry
    # column count E is independent (the cycle passes a dense
    # per-flavor-resource layout).
    S = R // NF
    D = depth
    dev = usage0.device
    lq = local_quota(subtree_quota, lend_limit)
    entry_kind = torch.where(entry_valid, entry_kind, ENTRY_SKIP)
    f64 = torch.float64
    INF_F = float("inf")

    member_ok = root_members >= 0
    # Lendable seen by node n: its parent's potential available summed
    # over flavors, per resource.
    lendable_node = torch.clamp(potential, max=INF).reshape(N, NF, S) \
        .sum(dim=1)  # [N, S]

    c = torch.clamp(root_members, min=0).long()  # [Rn, M]
    frs = entry_fr[c]  # [Rn, M, E]
    req = entry_req[c]
    frs_safe = torch.clamp(frs, min=0).long()
    active_fr = (frs >= 0) & (req > 0)
    chain = torch.cat([c[:, :, None], ancestors[c].long()], dim=2)
    chain_ok = chain >= 0  # [Rn, M, D+1]
    chain_safe = torch.clamp(chain, min=0)
    rows_safe = torch.clamp(local_chain[c], min=0).long()  # [Rn, M, D+1]
    g_lq_fr = lq[chain_safe[..., None], frs_safe[:, :, None, :]]
    sq_full = subtree_quota[chain_safe]  # [Rn, M, D+1, R]
    par_of_chain = parent[chain_safe]
    lend = lendable_node[torch.clamp(par_of_chain, min=0).long()]
    wgt = fair_weight[chain_safe]  # [Rn, M, D+1]
    has_par = chain_ok & (par_of_chain >= 0)
    pri_f = entry_priority[c].to(f64)
    ts = entry_ts[c]
    nodes = root_nodes
    crank_row = child_rank[torch.clamp(nodes, min=0).long()].to(f64)
    row0 = rows_safe[:, :, 0]
    kidx = torch.arange(K, device=dev)
    p_local = root_parent_local
    ld = local_depth
    roots = torch.arange(Rn, device=dev)
    m_idx = torch.arange(M, device=dev)
    E = frs.shape[2]
    scatter_cols = torch.where(frs >= 0, frs_safe, R - 1)[:, :, None, :] \
        .expand(Rn, M, D + 1, E)
    root_row = torch.argmax(((ld == 0) & (nodes >= 0)).to(torch.int32),
                            dim=1)

    def drs_keys(usage_l):
        """(zwb, key) per member per chain position: the DRS of chain
        node j after the member's simulated usage is added, which the
        tournament reads when the member competes at chain node j+1."""
        g_u_fr = usage_l[roots[:, None, None, None], rows_safe[..., None],
                         frs_safe[:, :, None, :]]  # [Rn, M, D+1, E]
        local_avail = torch.clamp(g_lq_fr - g_u_fr, min=0)
        v = torch.where(active_fr, req, 0)
        adds = []
        for d in range(D + 1):
            adds.append(torch.where(chain_ok[:, :, d:d + 1] & active_fr, v,
                                    0))
            v = torch.clamp(v - local_avail[:, :, d, :], min=0)
        adds = torch.stack(adds, dim=2)  # [Rn, M, D+1, E]
        u_full = usage_l[roots[:, None, None], rows_safe]  # [Rn, M, D+1, R]
        u_full = u_full.scatter_add(
            3, scatter_cols, torch.where(frs[:, :, None, :] >= 0, adds, 0))
        borrowed = torch.clamp(u_full - sq_full, min=0)
        by_res = borrowed.reshape(Rn, M, D + 1, NF, S).sum(dim=3)
        ratio_rs = torch.where(
            (by_res > 0) & (lend > 0),
            by_res.to(f64) * 1000.0 / torch.clamp(lend, min=1).to(f64), 0.0)
        ratio = torch.where(has_par, ratio_rs.amax(dim=3), 0.0)
        zwb = (wgt == 0) & (ratio > 0)
        keyv = torch.where(
            zwb, ratio,
            torch.where(wgt > 0, ratio / torch.clamp(wgt, min=1e-300), 0.0))
        return zwb.to(f64), keyv

    def seg_min(vals, seg, base):
        return torch.full((Rn, K + 1), base, dtype=vals.dtype, device=dev) \
            .scatter_reduce(1, seg, vals, "amin", include_self=True)

    def tournament(zwb, keyv, alive):
        """Bottom-up: the rows at depth d promote their surviving
        candidate to the parent row, competing on the candidate's DRS at
        its current chain position."""
        cand = torch.full((Rn, K + 1), -1, dtype=torch.long, device=dev) \
            .scatter_(1, torch.where(alive, row0, K),
                      m_idx.expand(Rn, M).clone())[:, :K]
        candj = torch.zeros((Rn, K), dtype=torch.long, device=dev)
        for d in range(D, 0, -1):
            at_d = (ld == d) & (cand >= 0)
            m = torch.clamp(cand, min=0)
            kz = torch.where(at_d, zwb[roots[:, None], m, candj], INF_F)
            ks = torch.where(at_d, keyv[roots[:, None], m, candj], INF_F)
            kp = torch.where(at_d, -torch.gather(pri_f, 1, m), INF_F)
            kt = torch.where(at_d, torch.gather(ts, 1, m), INF_F)
            kr = torch.where(at_d, crank_row, INF_F)
            seg = torch.where(at_d & (p_local >= 0), p_local, K).long()
            mask = at_d
            for kk in (kz, ks, kp, kt, kr):
                kk = torch.where(mask, kk, INF_F)
                mn = seg_min(kk, seg, INF_F)
                mask = mask & (kk == torch.gather(mn, 1, seg))
            wrow = seg_min(torch.where(mask, kidx, K), seg, K)[:, :K]
            got = wrow < K
            wsafe = torch.clamp(wrow, max=K - 1)
            cand = torch.where(got, torch.gather(cand, 1, wsafe), cand)
            candj = torch.where(got, torch.gather(candj, 1, wsafe) + 1,
                                candj)
        return torch.gather(cand, 1, root_row[:, None])[:, 0]

    node_ok = root_nodes >= 0
    usage_l = torch.where(node_ok[:, :, None],
                          usage0[torch.clamp(root_nodes, min=0).long()], 0)
    valid_m = member_ok & entry_valid[c]
    remaining = torch.ones((Rn, M), dtype=torch.bool, device=dev)
    # Each round takes one winner from every root with a candidate left.
    n_rounds = int(valid_m.sum(dim=1).max()) if Rn else 0
    win_seq, fit_seq = [], []
    for _ in range(n_rounds):
        alive = remaining & valid_m
        zwb, keyv = drs_keys(usage_l)
        win = tournament(zwb, keyv, alive)
        win_safe = torch.clamp(win, min=0)
        cw = torch.where(win >= 0, torch.gather(root_members, 1,
                                                win_safe[:, None])[:, 0], -1)
        usage_l, _, fits = _commit_one_local(
            usage_l, cw, entry_fr, entry_req, entry_kind, entry_borrows,
            subtree_quota, lq, borrow_limit, nominal, ancestors,
            local_chain, depth=depth)
        remaining = remaining & ~((m_idx[None, :] == win_safe[:, None])
                                  & (win >= 0)[:, None])
        win_seq.append(cw)
        fit_seq.append(fits)

    C = entry_valid.shape[0]
    admitted = torch.zeros(C + 1, dtype=torch.bool, device=dev)
    entry_round = torch.full((C + 1,), -1, dtype=torch.int32, device=dev)
    if n_rounds:
        flat_win = torch.stack(win_seq, dim=1).reshape(-1)
        flat_fit = torch.stack(fit_seq, dim=1).reshape(-1)
        rounds = torch.arange(n_rounds, dtype=torch.int32, device=dev) \
            .expand(Rn, n_rounds).reshape(-1)
        target = torch.where(flat_win >= 0, flat_win, C).long()
        admitted[torch.where(flat_fit, target, C)] = True
        entry_round = entry_round.scatter_reduce(
            0, torch.where(flat_fit, target, C), rounds, "amax",
            include_self=True)
    return (admitted[:C], entry_round[:C],
            _scatter_local(usage0, root_nodes, usage_l))


def make_commit_order_key(has_qr, borrows, priority, ts_rank):
    """Classical iterator sort key: quota-reserved first, fewer borrows,
    higher priority, FIFO. One int64 for a single argsort."""
    hq = torch.where(has_qr, 0, 1).long()
    b = torch.clamp(borrows, 0, 31).long()
    # Invert priority into a non-negative ascending component.
    p_inv = (1 << 31) - 1 - priority.long()
    r = torch.clamp(ts_rank.long(), 0, (1 << 24) - 1)
    return (hq << 62) | (b << 56) | (p_inv << 24) | r
