"""Batched hierarchical quota math on tensors: the port of
``kueue_tpu/ops/quota.py``.

Level-wise scatter/gather passes over the whole [N, R] node x
flavor-resource grid at once: a bottom-up pass for subtree quota and
usage aggregation, and a top-down pass for available and
potential-available. Every quantity is int64 with the saturating INF
arithmetic of ``api.types``; the expressions follow the JAX version
operation by operation so that results are bitwise equal.
"""

from __future__ import annotations

import torch

from kueue_tpu_torch.api.types import INF


def sat_add(a, b):
    """INF absorbs; finite sums clip into [-INF, INF]."""
    inf_mask = (a >= INF) | (b >= INF)
    return torch.clamp(a + b, -INF, INF).masked_fill(inf_mask, INF)


def sat_sub(a, b):
    inf_mask = (a >= INF) & (b < INF)
    return torch.clamp(a - b, -INF, INF).masked_fill(inf_mask, INF)


def local_quota(subtree_quota, lend_limit):
    """max(0, subtree - lendingLimit); an INF lending limit gives 0."""
    return torch.clamp(sat_sub(subtree_quota, lend_limit), min=0) \
        .masked_fill(lend_limit >= INF, 0)


def _segment_sum(values, segments, num_segments):
    """Rows of ``values`` summed into ``segments`` (all in range)."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, segments.long(), values)


def compute_subtree_quota(nominal, lend_limit, parent, level, *, depth):
    """Bottom-up: at each level from the deepest up, children contribute
    min(subtree, lend_limit) to their parent."""
    sq = nominal
    safe_parent = torch.clamp(parent, min=0)
    for lvl in range(depth, 0, -1):
        at_lvl = (level == lvl) & (parent >= 0)
        contrib = sat_sub(sq, local_quota(sq, lend_limit))  # min(sq, lend)
        contrib = torch.where(at_lvl[:, None], contrib, 0)
        sq = sat_add(sq, _segment_sum(contrib, safe_parent, sq.shape[0]))
    return sq


def compute_node_usage(cq_usage, subtree_quota, lend_limit, parent, level,
                       *, depth):
    """Bottom-up usage aggregation: each node passes max(0, usage -
    localQuota) to its parent. ``cq_usage`` has zeros in cohort rows."""
    usage = cq_usage
    lq = local_quota(subtree_quota, lend_limit)
    safe_parent = torch.clamp(parent, min=0)
    for lvl in range(depth, 0, -1):
        at_lvl = (level == lvl) & (parent >= 0)
        contrib = torch.clamp(sat_sub(usage, lq), min=0)
        contrib = torch.where(at_lvl[:, None], contrib, 0)
        usage = usage + _segment_sum(contrib, safe_parent, usage.shape[0])
    return usage


def compute_available(subtree_quota, usage, lend_limit, borrow_limit, parent,
                      level, *, depth):
    """Top-down available: the parent's available clipped by each
    child's borrowingLimit window, plus the child's local available.
    Returns the raw value (may be negative); callers clip CQ rows at 0."""
    lq = local_quota(subtree_quota, lend_limit)
    local_avail = torch.clamp(sat_sub(lq, usage), min=0)
    root_avail = sat_sub(subtree_quota, usage)
    avail = torch.where((parent < 0)[:, None], root_avail, 0)
    safe_parent = torch.clamp(parent, min=0).long()
    for lvl in range(1, depth + 1):
        at_lvl = (level == lvl) & (parent >= 0)
        parent_avail = avail[safe_parent]
        stored_in_parent = sat_sub(subtree_quota, lq)
        used_in_parent = torch.clamp(sat_sub(usage, lq), min=0)
        with_max = sat_add(sat_sub(stored_in_parent, used_in_parent),
                           borrow_limit)
        clipped = torch.where(borrow_limit >= INF, parent_avail,
                              torch.minimum(with_max, parent_avail))
        node_avail = sat_add(local_avail, clipped)
        avail = torch.where(at_lvl[:, None], node_avail, avail)
    return avail


def compute_potential_available(subtree_quota, lend_limit, borrow_limit,
                                parent, level, *, depth):
    """Top-down potentialAvailable."""
    lq = local_quota(subtree_quota, lend_limit)
    pot = torch.where((parent < 0)[:, None], subtree_quota, 0)
    safe_parent = torch.clamp(parent, min=0).long()
    for lvl in range(1, depth + 1):
        at_lvl = (level == lvl) & (parent >= 0)
        parent_pot = pot[safe_parent]
        node_pot = sat_add(lq, parent_pot)
        with_borrow = sat_add(subtree_quota, borrow_limit)
        node_pot = torch.where(borrow_limit >= INF, node_pot,
                               torch.minimum(with_borrow, node_pot))
        pot = torch.where(at_lvl[:, None], node_pot, pot)
    return pot


def available_along_chain(chain_ok, g_sq, g_lq, g_bl, g_usage, *, depth):
    """available(fr) for a CQ from gathers along its ancestor chain,
    walked root -> CQ: the root's headroom clipped at each level by the
    child's borrowingLimit window, plus local available; clipped at zero
    at the CQ.

    chain_ok: bool[..., D+1] (position 0 = the CQ); g_*: [..., D+1, S]
    gathers of subtree_quota / local_quota / borrow_limit / usage. The
    leading dimensions batch entries."""
    local_avail = torch.clamp(sat_sub(g_lq, g_usage), min=0)
    avail = torch.zeros_like(g_sq[..., 0, :])
    for d in range(depth, -1, -1):
        is_valid = chain_ok[..., d, None]
        is_root = is_valid if d == depth \
            else is_valid & ~chain_ok[..., d + 1, None]
        root_avail = sat_sub(g_sq[..., d, :], g_usage[..., d, :])
        stored = sat_sub(g_sq[..., d, :], g_lq[..., d, :])
        used_in_parent = torch.clamp(
            sat_sub(g_usage[..., d, :], g_lq[..., d, :]), min=0)
        with_max = sat_add(sat_sub(stored, used_in_parent), g_bl[..., d, :])
        clipped = torch.where(g_bl[..., d, :] >= INF, avail,
                              torch.minimum(with_max, avail))
        non_root = sat_add(local_avail[..., d, :], clipped)
        avail = torch.where(is_valid,
                            torch.where(is_root, root_avail, non_root), avail)
    return torch.clamp(avail, min=0)


def compute_level(parent, depth: int):
    """Distance from the root per node."""
    level = torch.zeros_like(parent)
    cur = parent
    for _ in range(depth):
        level = level + (cur >= 0).to(parent.dtype)
        cur = torch.where(cur >= 0, parent[torch.clamp(cur, min=0).long()],
                          -1)
    return level


def derive_world(nominal, lend_limit, borrow_limit, cq_usage, parent, *,
                 depth):
    """All per-(node, fr) quantities from the raw state.

    Returns a dict with level, subtree_quota, usage, local_quota,
    local_available, available (raw) and potential."""
    level = compute_level(parent, depth)
    sq = compute_subtree_quota(nominal, lend_limit, parent, level,
                               depth=depth)
    usage = compute_node_usage(cq_usage, sq, lend_limit, parent, level,
                               depth=depth)
    lq = local_quota(sq, lend_limit)
    local_avail = torch.clamp(sat_sub(lq, usage), min=0)
    avail = compute_available(sq, usage, lend_limit, borrow_limit, parent,
                              level, depth=depth)
    pot = compute_potential_available(sq, lend_limit, borrow_limit, parent,
                                      level, depth=depth)
    return {
        "level": level,
        "subtree_quota": sq,
        "usage": usage,
        "local_quota": lq,
        "local_available": local_avail,
        "available": avail,
        "potential": pot,
    }


def borrow_height(cq_node, fr, val, derived, ancestors, height, nominal, *,
                  depth):
    """Height of the lowest subtree that fits ``val`` more of ``fr`` for
    the CQ ``cq_node`` (FindHeightOfLowestSubtreeThatFits), batched.

    cq_node, fr: integer tensors of one batch shape; val: int64 of that
    shape. Returns (height int32, may_reclaim bool) of the same shape."""
    sq = derived["subtree_quota"]
    usage = derived["usage"]
    local_avail = derived["local_available"]
    cq_node = cq_node.long()
    fr = fr.long()

    cq_nominal = nominal[cq_node, fr]
    cq_usage = usage[cq_node, fr]
    cq_borrowing = cq_nominal < sat_add(cq_usage, val)
    has_parent = ancestors[cq_node, 0] >= 0

    remaining = sat_sub(val, local_avail[cq_node, fr])
    found_h = torch.zeros_like(val, dtype=torch.int32)
    found_smaller = torch.zeros_like(cq_borrowing)
    found = torch.zeros_like(cq_borrowing)
    for d in range(depth):
        anc = ancestors[cq_node, d]
        anc_ok = anc >= 0
        anc_safe = torch.clamp(anc, min=0).long()
        # Cohort borrowingWith: subtree_quota < usage + remaining.
        borrowing = sq[anc_safe, fr] < sat_add(usage[anc_safe, fr],
                                               remaining)
        fits_here = anc_ok & ~borrowing & ~found
        found_h = torch.where(fits_here, height[anc_safe], found_h)
        found_smaller = torch.where(fits_here, ancestors[anc_safe, 0] >= 0,
                                    found_smaller)
        found = found | fits_here
        remaining = torch.where(
            anc_ok & ~found,
            sat_sub(remaining, local_avail[anc_safe, fr]), remaining)

    # Root height for the not-found case: height of the root ancestor.
    root_idx = cq_node
    for d in range(depth):
        anc = ancestors[cq_node, d]
        root_idx = torch.where(anc >= 0, anc.long(), root_idx)
    not_found_h = height[root_idx]

    no_borrow = ~cq_borrowing | ~has_parent
    h = torch.where(no_borrow, 0,
                    torch.where(found, found_h, not_found_h))
    may = torch.where(no_borrow, has_parent, found & found_smaller)
    return h, may
