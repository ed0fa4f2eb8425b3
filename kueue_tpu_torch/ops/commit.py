"""Sequential-equivalent commit: the port of ``kueue_tpu/ops/commit.py``
(the classical root-grouped commit, without preemption victims).

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
ENTRY_PREEMPT = 4  # preempt-mode with victims (not ported yet)


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


def _commit_one_local(usage_l, c, entry_fr, entry_req, entry_kind,
                      entry_borrows, subtree_quota, lq, borrow_limit,
                      nominal, ancestors, local_chain, *, depth):
    """Commit one entry per root: slot ``c`` [Rn] (-1 = none) against
    the root-local usage carry ``usage_l`` [Rn, K, R]. Returns
    (new_usage_l, fits bool[Rn])."""
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
    g_usage = usage_l[roots[:, None, None], loc_safe[:, :, None], cols]

    kind = torch.where(ok, entry_kind[c_safe], ENTRY_SKIP)
    fits, adds = _entry_verdict(
        g_sq, g_lq, g_bl, g_usage, chain_ok, frs, req, kind,
        entry_borrows[c_safe], nominal[c_safe[:, None], frs_safe],
        borrow_limit[c_safe[:, None], frs_safe], g_usage[:, 0],
        depth=depth)

    # Accumulate: several resources of one entry can share a column
    # (masked ones all land on column 0 with a zero add).
    D1, S = adds.shape[1], adds.shape[2]
    new_usage = usage_l.index_put(
        (roots[:, None, None].expand(Rn, D1, S),
         loc_safe[:, :, None].expand(Rn, D1, S),
         frs_safe[:, None, :].expand(Rn, D1, S)),
        adds, accumulate=True)
    return new_usage, fits & ok


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
    *,
    depth: int,
):
    """Sequential-equivalent commit, batched across root subtrees: each
    root's entries are committed in global key order.

    Returns (admitted bool[C] by slot, final usage int64[N, R])."""
    N, R = usage0.shape
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

    nodes_safe = torch.clamp(root_nodes, min=0).long()
    usage_l = torch.where((root_nodes >= 0)[:, :, None],
                          usage0[nodes_safe], 0)  # [Rn, K, R]
    fits_seq = []
    for m in range(sorted_members.shape[1]):
        usage_l, fits = _commit_one_local(
            usage_l, sorted_members[:, m], entry_fr, entry_req, entry_kind,
            entry_borrows, subtree_quota, lq, borrow_limit, nominal,
            ancestors, local_chain, depth=depth)
        fits_seq.append(fits)

    # Per-root verdicts back to slot order; slot C is the spare that
    # takes padding members.
    flat_members = sorted_members.reshape(-1)
    admitted = torch.zeros(C + 1, dtype=torch.bool, device=usage0.device)
    admitted[torch.where(flat_members >= 0, flat_members, C).long()] = \
        torch.stack(fits_seq, dim=1).reshape(-1)

    # Local usage back into the node matrix (subtrees are disjoint and
    # cover every node); row N is the spare for padding.
    flat_nodes = root_nodes.reshape(-1)
    usage_final = torch.cat([usage0, usage0.new_zeros((1, R))])
    usage_final[torch.where(flat_nodes >= 0, flat_nodes, N).long()] = \
        usage_l.reshape(-1, R)
    return admitted[:C], usage_final[:N]


def make_commit_order_key(has_qr, borrows, priority, ts_rank):
    """Classical iterator sort key: quota-reserved first, fewer borrows,
    higher priority, FIFO. One int64 for a single argsort."""
    hq = torch.where(has_qr, 0, 1).long()
    b = torch.clamp(borrows, 0, 31).long()
    # Invert priority into a non-negative ascending component.
    p_inv = (1 << 31) - 1 - priority.long()
    r = torch.clamp(ts_rank.long(), 0, (1 << 24) - 1)
    return (hq << 62) | (b << 56) | (p_inv << 24) | r
