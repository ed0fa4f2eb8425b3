"""Batched TAS: the placement algorithm as PyTorch tensor programs.

The port of ``kueue_tpu/ops/tas.py``. The reference's placement
(tas_flavor_snapshot.go) runs per scheduling attempt in two phases:

  Phase 1 (fillInCounts): per-leaf pods that fit, with the leader
  variants, summed up the topology tree, converted to whole slices at
  the slice level.

  Phase 2 (findTopologyAssignment): pick the assignment level, then
  descend level by level, sorting child domains and taking a minimal
  prefix with a best-fit terminal domain.

Here:

  * ``leaf_states`` / ``bubble_counts``: the standalone phase 1. The leaf
    counts run as the CUDA kernel of ``ops/leaf.py`` on a CUDA tensor and
    as its plain version on a CPU tensor;
  * ``tas_place``: the full placement, phase 1 fused with the sorted
    descent;
  * ``tas_feasibility``: exact fit/no-fit verdicts for a batch of
    leaderless requests, phase 1 only.

The JAX functions' static arguments are plain Python arguments here that
select the same branches. Everything is int64 except the int32 outputs
of ``leaf_states``/``bubble_counts``, as in the reference. Three JAX
behaviours are reproduced exactly: ``lax.sort`` over several keys (a
chain of stable argsorts, last key first), empty
``segment_min``/``segment_max`` segments (int64 max and int64 min), and
``argmin`` ties (the first index, as ``torch.argmin`` gives).
"""

from __future__ import annotations

import numpy as np
import torch

from kueue_tpu_torch.ops.leaf import leaf_fit_counts

OK = 0
ERR_NOT_FIT = 1          # fit_arg = how much fit, want = slice_count
ERR_UNDERFLOW = 2        # "internal: assignment accounting underflow"

_IBIG = 1 << 60
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def leaf_states(free_capacity, tas_usage, assumed_usage, per_pod,
                leaf_mask):
    """Pods that fit per leaf: int32[L]. The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    return leaf_fit_counts(free_capacity, tas_usage, assumed_usage,
                           per_pod, leaf_mask)


def _segment_sum(data, seg, num_segments: int):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg, data)


def _segment_min(data, seg, num_segments: int):
    """jax.ops.segment_min: an empty segment is the int64 maximum."""
    out = torch.full((num_segments,), _I64_MAX, dtype=torch.int64,
                     device=data.device)
    return out.scatter_reduce_(0, seg, data, "amin", include_self=True)


def _segment_max(data, seg, num_segments: int):
    """jax.ops.segment_max: an empty segment is the int64 minimum."""
    out = torch.full((num_segments,), _I64_MIN, dtype=torch.int64,
                     device=data.device)
    return out.scatter_reduce_(0, seg, data, "amax", include_self=True)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def bubble_counts(leaf_state, parent_of_level, level_sizes_max: int,
                  slice_size: int, slice_level_idx: int, *,
                  num_levels: int):
    """Roll leaf pod counts up the topology tree and derive slice counts.

    leaf_state: int32[L] (deepest level); parent_of_level:
    int32[num_levels-1, max_domains], the parent index at the level above
    for each domain of each non-root level, -1 padded (row d maps level
    d+1 to level d). Returns (state int32[num_levels, max_domains],
    slice_state int32[num_levels, max_domains])."""
    M = level_sizes_max
    dev = leaf_state.device
    parent_of_level = torch.as_tensor(parent_of_level, device=dev)
    states = [None] * num_levels
    states[num_levels - 1] = torch.nn.functional.pad(
        leaf_state, (0, M - leaf_state.shape[0]))
    for lvl in range(num_levels - 2, -1, -1):
        parent = parent_of_level[lvl]
        child_state = states[lvl + 1]
        safe = torch.where(parent >= 0, parent, M - 1).long()
        contrib = torch.where(parent >= 0, child_state,
                              torch.zeros_like(child_state))
        states[lvl] = _segment_sum(contrib, safe, M)
    state = torch.stack(states)

    zero = torch.zeros(M, dtype=state.dtype, device=dev)
    slice_state = torch.stack([
        _floordiv(state[lvl], slice_size) if lvl == slice_level_idx
        else zero for lvl in range(num_levels)])
    # Above the slice level: aggregate child slice counts upward.
    for lvl in range(min(slice_level_idx, num_levels - 1) - 1, -1, -1):
        parent = parent_of_level[lvl]
        safe = torch.where(parent >= 0, parent, M - 1).long()
        contrib = torch.where(parent >= 0, slice_state[lvl + 1], zero)
        slice_state[lvl] = _segment_sum(contrib, safe, M)
    return state, slice_state


# ---------------------------------------------------------------------------
# Full placement: phase 1 (with leader variants) + phase 2 (sorted level
# descent). Status codes map to the reference's failure strings
# (tas/device.py renders the messages).
# ---------------------------------------------------------------------------


def _count_in(rem, req, has_pods_cap, pods_col: int):
    """count_in of fillLeafCounts: pods that fit per leaf given remaining
    capacity. A leaf without explicit "pods" capacity is unlimited on
    that resource; a leaf with zero applicable constraints fits zero
    pods."""
    app = (req > 0)[None, :].expand(rem.shape).clone()
    if pods_col >= 0:
        app[:, pods_col] = (req[pods_col] > 0) & has_pods_cap
    cnt = torch.where(
        app, _floordiv(torch.clamp(rem, min=0),
                       torch.clamp(req, min=1)[None, :]),
        torch.full_like(rem, _IBIG))
    n_app = app.sum(dim=1)
    return torch.where(n_app > 0, cnt.amin(dim=1),
                       torch.zeros_like(n_app))


def _phase1(free, usage, assumed, per_pod, leader_per_pod, leaf_mask,
            has_pods_cap, valid, parent, slice_size: int, *,
            num_levels: int, max_domains: int, pods_col: int,
            slice_level: int, has_leader: bool):
    """fillInCounts with the leader variants. Returns the five stacked
    state arrays, each int64[num_levels, max_domains]."""
    M = max_domains
    dev = free.device
    zeros = torch.zeros(M, dtype=torch.int64, device=dev)
    rem0 = free - usage - assumed
    st_leaf = torch.where(leaf_mask,
                          _count_in(rem0, per_pod, has_pods_cap, pods_col),
                          zeros)
    if has_leader:
        lead_fit = leaf_mask & (
            _count_in(rem0, leader_per_pod, has_pods_cap, pods_col) > 0)
        rem1 = rem0 - leader_per_pod[None, :]
        swl_leaf = torch.where(
            lead_fit, _count_in(rem1, per_pod, has_pods_cap, pods_col),
            zeros)
        ls_leaf = lead_fit.long()
    else:
        swl_leaf = st_leaf
        ls_leaf = zeros

    st = [None] * num_levels
    sst = [None] * num_levels
    swl = [None] * num_levels
    sstl = [None] * num_levels
    ls = [None] * num_levels
    leaf_lvl = num_levels - 1
    st[leaf_lvl] = st_leaf
    swl[leaf_lvl] = swl_leaf
    ls[leaf_lvl] = ls_leaf
    if leaf_lvl == slice_level:
        sst[leaf_lvl] = _floordiv(st_leaf, slice_size)
        sstl[leaf_lvl] = _floordiv(swl_leaf, slice_size)
    else:
        sst[leaf_lvl] = zeros
        sstl[leaf_lvl] = zeros

    ibig = torch.full((M,), _IBIG, dtype=torch.int64, device=dev)
    for lvl in range(num_levels - 2, -1, -1):
        child_valid = valid[lvl + 1]
        seg = torch.where(child_valid, parent[lvl + 1], M)
        stc, sstc, swlc, sstlc, lsc = (st[lvl + 1], sst[lvl + 1],
                                       swl[lvl + 1], sstl[lvl + 1],
                                       ls[lvl + 1])
        sum_st = _segment_sum(torch.where(child_valid, stc, zeros), seg,
                              M + 1)[:M]
        sum_sst = _segment_sum(torch.where(child_valid, sstc, zeros), seg,
                               M + 1)[:M]
        # Leader-capable children bound the with-leader variants (min of
        # state - stateWithLeader).
        cond = child_valid & (lsc > 0) if has_leader else child_valid
        min_diff = _segment_min(torch.where(cond, stc - swlc, ibig), seg,
                                M + 1)[:M]
        min_sdiff = _segment_min(torch.where(cond, sstc - sstlc, ibig), seg,
                                 M + 1)[:M]
        has_contrib = _segment_max(cond.long(), seg, M + 1)[:M] > 0
        st_p = sum_st
        swl_p = torch.where(has_contrib, sum_st - min_diff, zeros)
        sstl_p = torch.where(has_contrib, sum_sst - min_sdiff, zeros)
        ls_p = _segment_max(torch.where(child_valid, lsc, zeros), seg,
                            M + 1)[:M]
        if lvl == slice_level:
            sst_p = _floordiv(st_p, slice_size)
            sstl_p = _floordiv(swl_p, slice_size)
        else:
            sst_p = sum_sst
        v = valid[lvl]
        st[lvl] = torch.where(v, st_p, zeros)
        sst[lvl] = torch.where(v, sst_p, zeros)
        swl[lvl] = torch.where(v, swl_p, zeros)
        sstl[lvl] = torch.where(v, sstl_p, zeros)
        ls[lvl] = torch.where(v, ls_p, zeros)
    return (torch.stack(st), torch.stack(sst), torch.stack(swl),
            torch.stack(sstl), torch.stack(ls))


def _rank_of(keys, M: int):
    """Sort permutation + per-slot rank for a lexicographic key tuple:
    ``lax.sort(keys + (iota,), num_keys=len(keys), is_stable=True)`` as
    a chain of stable argsorts from the last key to the first."""
    dev = keys[0].device
    perm = torch.arange(M, dtype=torch.int64, device=dev)
    for key in reversed(keys):
        perm = perm[torch.argsort(key[perm], stable=True)]
    rank = torch.empty(M, dtype=torch.int64, device=dev).scatter_(
        0, perm, torch.arange(M, dtype=torch.int64, device=dev))
    return perm, rank


def _leader_keys(stl, sstl, ls, vr, valid, unconstrained: bool):
    """sortedDomainsWithLeader."""
    k0 = (~valid).long()
    if unconstrained:
        return (k0, -ls, sstl, stl, vr)
    return (k0, -ls, -sstl, stl, vr)


def _normal_keys(st, sst, vr, valid, unconstrained: bool):
    """sortedDomains: BestFit, or LeastFreeCapacity ascending."""
    k0 = (~valid).long()
    if unconstrained:
        return (k0, sst, st, vr)
    return (k0, -sst, st, vr)


def _consume(seg, cap, capwl, ls, tie_rank, need, leadp, *, nseg: int,
             unconstrained: bool):
    """The greedy minimal-prefix walk of updateCountsToMinimumGeneric /
    consumeWithLeadersGeneric, segmented.

    Elements are given in walk order; ``seg[i]`` is the segment id
    (>= nseg marks padding). Per segment: walk elements, the first one
    consuming the leader when ``leadp``; full takes until the first
    element whose own capacity covers the remainder; that terminal take
    goes to the best-fit domain in the suffix (least leftover capacity,
    earliest ``tie_rank`` on ties) unless unconstrained.

    Returns (cnt[i] units, lead[i], seg_ok[nseg], leader_ok[nseg],
    consumed[nseg])."""
    N = seg.shape[0]
    dev = seg.device
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    zeros = torch.zeros(N, dtype=torch.int64, device=dev)
    ibig = torch.full((N,), _IBIG, dtype=torch.int64, device=dev)
    valid = seg < nseg
    segc = torch.clamp(seg, 0, nseg - 1)
    segfull = torch.where(valid, seg, nseg)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          seg[1:] != seg[:-1]]) & valid
    lp_e = valid & leadp[segc]
    need_e = torch.where(valid, need[segc], zeros)
    eff = torch.where(is_first & lp_e, capwl, cap)
    eff = torch.where(valid, eff, zeros)
    cs = torch.cumsum(eff, dim=0)
    excl = cs - eff
    base = _segment_sum(torch.where(is_first, excl, zeros), segfull,
                        nseg + 1)
    prefix = excl - base[segfull]
    remaining = torch.clamp(need_e - prefix, min=0)
    # Terminal fit: own capacity covers the remainder (the leader-first
    # element additionally needs leader capacity).
    fit = valid & (eff >= remaining) & (~(is_first & lp_e) | (ls >= 1))
    t_pos = _segment_min(torch.where(fit, idx, ibig), segfull, nseg + 1)
    seg_ok = t_pos[:nseg] < _IBIG
    f_pos = _segment_min(torch.where(valid, idx, ibig), segfull, nseg + 1)
    f_safe = torch.clamp(f_pos[:nseg], 0, N - 1)
    leader_ok = ~leadp | ((f_pos[:nseg] < _IBIG) & (ls[f_safe] > 0))
    t_e = t_pos[segfull]
    t_safe = torch.clamp(t_e, 0, N - 1)
    rem_t_e = torch.where(t_e < _IBIG, remaining[t_safe], zeros)
    flt_e = lp_e & (t_e == f_pos[segfull])  # leader consumed at terminal
    bkey = torch.where(flt_e, capwl, cap)
    in_suf = valid & (idx >= t_e)
    cond = in_suf & (bkey >= rem_t_e) & (~flt_e | (ls >= 1))
    mk = _segment_min(torch.where(cond, bkey, ibig), segfull, nseg + 1)
    if unconstrained:
        is_b = valid & (idx == t_e)
    else:
        tie = torch.where(flt_e, tie_rank, idx)
        best = cond & (bkey == mk[segfull])
        bt = _segment_min(torch.where(best, tie, ibig), segfull, nseg + 1)
        is_b = best & (tie == bt[segfull])
    cnt = torch.where(valid & (idx < t_e), eff, zeros)
    cnt = cnt + torch.where(is_b, rem_t_e, zeros)
    lead = (flt_e & is_b).long() + torch.where(
        lp_e & is_first & ~flt_e, torch.clamp(ls, max=1), zeros)
    consumed = _segment_sum(eff, segfull, nseg + 1)[:nseg]
    return cnt, lead, seg_ok, leader_ok, consumed


def tas_place(free, usage, assumed, per_pod, leader_per_pod, leaf_mask,
              has_pods_cap, valid, vrank, parent, count: int,
              slice_size: int, *, num_levels: int, max_domains: int,
              pods_col: int, req_level: int, slice_level: int,
              required: bool, unconstrained: bool, has_leader: bool):
    """findTopologyAssignment end to end on the device.

    free/usage/assumed: int64[M, S] leaf-slot capacity state;
    per_pod/leader_per_pod: int64[S]; leaf_mask/has_pods_cap: bool[M];
    valid: bool[NL, M]; vrank: int64[NL, M] lexicographic value rank;
    parent: int64[NL, M] parent slot at the level above.

    Returns (status, fit_arg, cnt int64[M], lead int64[M]): status and
    fit_arg are 0-d int64 tensors; cnt/lead are the per-leaf-slot worker
    pod counts and leader placements."""
    NL, M = num_levels, max_domains
    dev = free.device
    i64 = dict(dtype=torch.int64, device=dev)
    zeros = torch.zeros(M, **i64)
    ibig = torch.full((M,), _IBIG, **i64)
    slice_count = count // slice_size
    st, sst, swl, sstl, ls = _phase1(
        free, usage, assumed, per_pod, leader_per_pod, leaf_mask,
        has_pods_cap, valid, parent, slice_size, num_levels=NL,
        max_domains=M, pods_col=pods_col, slice_level=slice_level,
        has_leader=has_leader)
    leader_count = 1 if has_leader else 0

    def scalar(v):
        return torch.tensor(v, **i64)

    def level_arrays(lvl):
        return st[lvl], sst[lvl], swl[lvl], sstl[lvl], ls[lvl]

    def at(vec, i):
        """vec[i] for a 0-d index tensor, without a host sync."""
        return vec.gather(0, i.reshape(1))[0]

    def placed_at(pick, value):
        return zeros.scatter(0, pick.reshape(1), scalar(value).reshape(1))

    # Per-level leader-order ranks and top-fit flags. Required and
    # unconstrained place at exactly req_level, so the selection sorts
    # of the levels above are dead and skipped.
    sel_levels = ((req_level,) if (required or unconstrained)
                  else range(req_level + 1))
    lperm, lrank, topfit, topslice = {}, {}, {}, {}
    for lvl in sel_levels:
        stl_, sst_, swl_, sstl_, ls_ = level_arrays(lvl)
        perm, rank = _rank_of(
            _leader_keys(swl_, sstl_, ls_, vrank[lvl], valid[lvl],
                         unconstrained), M)
        lperm[lvl], lrank[lvl] = perm, rank
        top = perm[0]
        topfit[lvl] = (at(valid[lvl], top) & (at(sstl_, top) >= slice_count)
                       & (at(ls_, top) >= leader_count))
        topslice[lvl] = torch.where(at(valid[lvl], top), at(sst_, top),
                                    scalar(0))

    # findLevelWithFitDomains: the deepest level whose best domain fits;
    # preferred climbs toward the root, required stays put.
    if required or unconstrained:
        fit_level = req_level
    else:
        fit_level = scalar(0)
        for lvl in range(req_level + 1):
            fit_level = torch.where(topfit[lvl], scalar(lvl), fit_level)

    def single_pick(lvl):
        """Top domain fits: findBestFitDomainForSlices over the whole
        level (ties in leader-sort order)."""
        _, sst_, _, sstl_, ls_ = level_arrays(lvl)
        cond = valid[lvl] & (sstl_ >= slice_count) & (ls_ >= leader_count)
        key = torch.where(cond, sstl_, ibig)
        mn = key.min()
        pick = torch.argmin(torch.where(cond & (key == mn), lrank[lvl],
                                        ibig))
        return (placed_at(pick, count), placed_at(pick, leader_count),
                scalar(OK), scalar(0))

    def unconstrained_pick(lvl):
        """LeastFreeCapacity scan: the fullest single domain that fits
        (by slice_state; the leader consume can then underflow, which
        the reference reports as an accounting underflow)."""
        _, sst_, _, sstl_, ls_ = level_arrays(lvl)
        cond = valid[lvl] & (sst_ >= slice_count)
        pick = torch.argmin(torch.where(cond, lrank[lvl], ibig))
        if has_leader:
            ok = (at(sstl_, pick) >= slice_count) & (at(ls_, pick)
                                                     >= leader_count)
            status = torch.where(ok, scalar(OK), scalar(ERR_UNDERFLOW))
        else:
            status = scalar(OK)
        return (placed_at(pick, count), placed_at(pick, leader_count),
                status, scalar(0))

    def greedy_pick(lvl):
        """Multi-domain greedy: the leader-capable pick first, then the
        rest re-sorted without the leader keys; one consume walk yields
        the same takes as the select+minimize pair."""
        st_, sst_, swl_, sstl_, ls_ = level_arrays(lvl)
        nk = _normal_keys(st_, sst_, vrank[lvl], valid[lvl], unconstrained)
        if has_leader:
            f0 = lperm[lvl][0]
            leader_bad = at(ls_, f0) <= 0
            kf = (torch.arange(M, device=dev) != f0).long()
            perm, _ = _rank_of((kf,) + nk, M)
        else:
            leader_bad = torch.tensor(False, device=dev)
            perm, _ = _rank_of(nk, M)
        validp = valid[lvl][perm]
        seg = (~validp).long()
        cnt_u, lead_u, seg_ok, _lok, consumed = _consume(
            seg, sst_[perm], sstl_[perm], ls_[perm], lrank[lvl][perm],
            scalar(slice_count).reshape(1),
            torch.tensor([has_leader], device=dev),
            nseg=1, unconstrained=unconstrained)
        cnt = zeros.scatter(0, perm,
                            torch.where(validp, cnt_u * slice_size, zeros))
        lead = zeros.scatter(0, perm, torch.where(validp, lead_u, zeros))
        status = torch.where(
            leader_bad, scalar(ERR_NOT_FIT),
            torch.where(seg_ok[0], scalar(OK), scalar(ERR_NOT_FIT)))
        fit_arg = torch.where(leader_bad, scalar(0), consumed[0])
        return cnt, lead, status, fit_arg

    def choose(flag, a, b):
        return tuple(torch.where(flag, x, y) for x, y in zip(a, b))

    def selection_at(lvl):
        if required:
            cnt, lead, status, fit_arg = single_pick(lvl)
            status = torch.where(topfit[lvl], status, scalar(ERR_NOT_FIT))
            fit_arg = torch.where(topfit[lvl], fit_arg, topslice[lvl])
            return cnt, lead, status, fit_arg
        if unconstrained:
            _, sst_, _, _, _ = level_arrays(lvl)
            found = torch.any(valid[lvl] & (sst_ >= slice_count))
            return choose(found, unconstrained_pick(lvl), greedy_pick(lvl))
        # preferred
        if lvl == 0:
            return choose(topfit[lvl], single_pick(lvl), greedy_pick(lvl))
        return single_pick(lvl)

    def pooled_step(lvl, cnt, lead):
        """First descent loop: children of all chosen domains pooled, one
        global sort + consume in slice units."""
        chosen = (cnt > 0) | (lead > 0)
        cv = valid[lvl + 1]
        par = torch.clamp(parent[lvl + 1], 0, M - 1)
        elig = cv & chosen[par]
        stc, sstc, swlc, sstlc, lsc = level_arrays(lvl + 1)
        if has_leader:
            keys = _leader_keys(swlc, sstlc, lsc, vrank[lvl + 1], elig,
                                unconstrained)
        else:
            keys = _normal_keys(stc, sstc, vrank[lvl + 1], elig,
                                unconstrained)
        perm, _ = _rank_of(keys, M)
        eligp = elig[perm]
        seg = (~eligp).long()
        pos = torch.arange(M, **i64)
        cnt_u, lead_u, seg_ok, lok, _cons = _consume(
            seg, sstc[perm], sstlc[perm], lsc[perm], pos,
            scalar(slice_count).reshape(1),
            torch.tensor([has_leader], device=dev),
            nseg=1, unconstrained=unconstrained)
        new_cnt = zeros.scatter(
            0, perm, torch.where(eligp, cnt_u * slice_size, zeros))
        new_lead = zeros.scatter(0, perm, torch.where(eligp, lead_u, zeros))
        status = torch.where(seg_ok[0] & lok[0], scalar(OK),
                             scalar(ERR_NOT_FIT))
        return new_cnt, new_lead, status, scalar(0)

    def per_parent_step(lvl, cnt, lead):
        """Second descent loop: pods distributed per chosen parent, in
        pod units (balanced placement never runs here, so slices are
        already anchored)."""
        chosen = (cnt > 0) | (lead > 0)
        cv = valid[lvl + 1]
        par = torch.clamp(parent[lvl + 1], 0, M - 1)
        elig = cv & chosen[par]
        leadp_parent = lead > 0
        child_lp = elig & leadp_parent[par]
        stc, sstc, swlc, sstlc, lsc = level_arrays(lvl + 1)
        vr = vrank[lvl + 1]
        if unconstrained:
            lk = (-lsc, sstlc, swlc, vr)
            nk = (sstc, stc, vr, zeros)
        else:
            lk = (-lsc, -sstlc, swlc, vr)
            nk = (-sstc, stc, vr, zeros)
        ka = [torch.where(child_lp, a, b) for a, b in zip(lk, nk)]
        pkey = torch.where(elig, parent[lvl + 1], M)
        perm, _ = _rank_of((pkey,) + tuple(ka), M)
        seg = pkey[perm]
        pos = torch.arange(M, **i64)
        cnt_u, lead_u, seg_ok, lok, _cons = _consume(
            seg, stc[perm], swlc[perm], lsc[perm], pos, cnt,
            leadp_parent, nseg=M, unconstrained=unconstrained)
        eligp = elig[perm]
        new_cnt = zeros.scatter(0, perm, torch.where(eligp, cnt_u, zeros))
        new_lead = zeros.scatter(0, perm,
                                 torch.where(eligp, lead_u, zeros))
        bad = chosen & (~seg_ok | (leadp_parent & ~lok))
        status = torch.where(torch.any(bad), scalar(ERR_UNDERFLOW),
                             scalar(OK))
        return new_cnt, new_lead, status, scalar(0)

    cnt = zeros
    lead = zeros
    status = scalar(OK)
    fit_arg = scalar(0)
    static_fit = required or unconstrained
    cand = range(req_level + 1) if not static_fit else (req_level,)
    sels = {lvl: selection_at(lvl) for lvl in cand}
    for lvl in range(NL):
        if lvl in sels:
            if static_fit:
                cnt, lead, status, fit_arg = sels[lvl]
            else:
                cnt, lead, status, fit_arg = choose(
                    fit_level == lvl, sels[lvl], (cnt, lead, status,
                                                  fit_arg))
        if lvl < NL - 1:
            if static_fit and lvl < req_level:
                continue  # statically above the placement level
            act = ((status == OK) if static_fit
                   else (fit_level <= lvl) & (status == OK))
            if lvl + 1 <= slice_level:
                step = pooled_step(lvl, cnt, lead)
            else:
                step = per_parent_step(lvl, cnt, lead)
            cnt, lead, status, fit_arg = choose(
                act, step, (cnt, lead, status, fit_arg))
    return status, fit_arg, cnt, lead


def encode_tas_snapshot(tas_snap, resources: list[str]):
    """Flatten a TASFlavorSnapshot into the arrays bubble_counts needs.
    Returns a dict of numpy arrays + the per-level domain lists
    (host-side, for mapping phase-2 results back)."""
    num_levels = len(tas_snap.level_keys)
    level_domains = [sorted(tas_snap.domains_per_level[lvl].values(),
                            key=lambda d: d.values)
                     for lvl in range(num_levels)]
    index_of = [{d.id: i for i, d in enumerate(doms)}
                for doms in level_domains]
    M = max((len(d) for d in level_domains), default=1)

    parent_of_level = np.full((max(num_levels - 1, 1), M), -1, np.int32)
    for lvl in range(1, num_levels):
        for i, d in enumerate(level_domains[lvl]):
            parent_of_level[lvl - 1, i] = index_of[lvl - 1][d.parent.id]

    leaves = level_domains[-1] if num_levels else []
    L = len(leaves)
    S = len(resources)
    free = np.zeros((L, S), np.int64)
    usage = np.zeros((L, S), np.int64)
    for i, leaf in enumerate(leaves):
        for s_i, res in enumerate(resources):
            free[i, s_i] = leaf.free_capacity.get(res, 0)
            usage[i, s_i] = leaf.tas_usage.get(res, 0)
    return {
        "num_levels": num_levels,
        "max_domains": M,
        "parent_of_level": parent_of_level,
        "free_capacity": free,
        "tas_usage": usage,
        "level_domains": level_domains,
    }


# ---------------------------------------------------------------------------
# Batched feasibility: exact fit/no-fit (and the notFitMessage argument)
# for leaderless, ungrouped single-pod-set requests, B at a time against
# one forest. Phase 1 only: segment reductions, no sorts.
# ---------------------------------------------------------------------------


def tas_feasibility(free, usage, per_pod, count, slice_size, slice_level,
                    req_level, mode, leaf_mask, valid, parent,
                    has_pods_cap, *, num_levels: int, max_domains: int,
                    pods_col: int):
    """Exact batched fit verdicts.

    free/usage: int64[M, S]; both the live world (free - usage) and the
    simulate-empty world (free) are evaluated; per_pod: int64[B, S];
    count/slice_size/slice_level/req_level/mode: int64[B] (mode
    0=required, 1=preferred, 2=unconstrained); leaf_mask: bool[B, M];
    valid: bool[NL, M]; parent: int64[NL, M]; has_pods_cap: bool[M].

    Returns (fit bool[2, B], fit_arg int64[2, B]): fit mirrors
    find_topology_assignments success for each usage variant; fit_arg
    is the notFitMessage argument the reference reports on failure."""
    NL, M = num_levels, max_domains
    B, S = per_pod.shape
    dev = free.device
    rem = torch.clamp(torch.stack([free - usage, free]), min=0)  # [2, M, S]

    # count_in batched: min over applicable resources of rem // req,
    # per (variant, request, leaf).
    cnt = torch.full((2, B, M), _IBIG, dtype=torch.int64, device=dev)
    any_app = torch.zeros((B, M), dtype=torch.bool, device=dev)
    for s in range(S):
        req_s = per_pod[:, s]                                  # [B]
        app = req_s > 0                                        # [B]
        if s == pods_col:
            app_m = app[:, None] & has_pods_cap[None, :]       # [B, M]
        else:
            app_m = app[:, None].expand(B, M)
        div = _floordiv(rem[:, :, s][:, None, :],
                        torch.clamp(req_s, min=1)[None, :, None])
        cnt = torch.where(app_m[None], torch.minimum(cnt, div), cnt)
        any_app = any_app | app_m
    # A leaf with zero applicable constraints fits zero pods; matchNode
    # exclusions zero the leaf for that request only.
    st = torch.where(valid[NL - 1][None, None, :] & any_app[None]
                     & leaf_mask[None], cnt, torch.zeros_like(cnt))

    ss = torch.clamp(slice_size, min=1)
    sc = _floordiv(count, ss)                                  # [B]
    zero3 = torch.zeros_like(st)
    sst = torch.where((slice_level == NL - 1)[None, :, None],
                      _floordiv(st, ss[None, :, None]), zero3)

    def level_stats(lvl, sst_l):
        v = valid[lvl][None, None, :]
        masked = torch.where(v, sst_l, zero3)
        return masked.amax(dim=2), masked.sum(dim=2)

    max_sst, sum_sst = [], []
    mx, sm = level_stats(NL - 1, sst)
    max_sst.append(mx)
    sum_sst.append(sm)
    for lvl in range(NL - 2, -1, -1):
        cv = valid[lvl + 1]
        seg = torch.where(cv, parent[lvl + 1], M)              # [M]
        st_c = torch.where(cv[None, None], st, zero3)
        sst_c = torch.where(cv[None, None], sst, zero3)
        sum_st = torch.zeros((2, B, M + 1), dtype=torch.int64,
                             device=dev).index_add_(2, seg, st_c)[:, :, :M]
        sum_ss = torch.zeros((2, B, M + 1), dtype=torch.int64,
                             device=dev).index_add_(2, seg, sst_c)[:, :, :M]
        v = valid[lvl][None, None, :]
        st = torch.where(v, sum_st, zero3)
        sst = torch.where(v, torch.where(
            (slice_level == lvl)[None, :, None],
            _floordiv(st, ss[None, :, None]), sum_ss), zero3)
        mx, sm = level_stats(lvl, sst)
        max_sst.append(mx)
        sum_sst.append(sm)
    max_sst = torch.stack(max_sst[::-1], dim=2)                # [2, B, NL]
    sum_sst = torch.stack(sum_sst[::-1], dim=2)

    rl = torch.clamp(req_level, 0, NL - 1)
    rl_idx = rl[None, :, None].expand(2, B, 1)
    at_req_max = torch.gather(max_sst, 2, rl_idx)[:, :, 0]
    at_req_sum = torch.gather(sum_sst, 2, rl_idx)[:, :, 0]
    lvl_idx = torch.arange(NL, dtype=torch.int64, device=dev)
    topfit_any = torch.any(
        (lvl_idx[None, None, :] <= rl[None, :, None])
        & (max_sst >= sc[None, :, None]), dim=2)
    sum0 = sum_sst[:, :, 0]

    scb = sc[None, :]
    fit_required = at_req_max >= scb
    fit_uncon = at_req_sum >= scb
    fit_pref = topfit_any | (sum0 >= scb)
    m = mode[None, :]
    fit = torch.where(m == 0, fit_required,
                      torch.where(m == 2, fit_uncon, fit_pref))
    fit_arg = torch.where(m == 0, at_req_max,
                          torch.where(m == 2, at_req_sum, sum0))
    return fit, fit_arg
