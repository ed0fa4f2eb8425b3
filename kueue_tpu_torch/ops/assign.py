"""Batched flavor assignment: the port of ``kueue_tpu/ops/assign.py``.

For every head at once: walk its ClusterQueue's flavor order per
resource group, classify each flavor as Fit / NoCandidates / NoFit with
a borrowing level, and fold with the FlavorFungibility preference
lattice. Pod sets are walked in order with the usage already assigned
to earlier pod sets counted against later ones.

The JAX version vmaps over workloads and scans over pod sets, groups
and flavors; here the workload axis is a batch dimension and the small
static axes (P, G, F) are Python loops.

Mode encoding: 0=NO_FIT, 1=NO_CANDIDATES, 4=FIT.
"""

from __future__ import annotations

import torch

from kueue_tpu_torch.ops.quota import borrow_height

P_NO_FIT = 0
P_NO_CANDIDATES = 1
P_FIT = 4
# Representative-mode key: big multiplier so pmode dominates borrow.
_BIG = 1 << 20


def _mode_key(pmode, borrow, pref_preempt_first):
    """Total order matching isPreferred: larger key = more preferred.
    Default (BorrowingOverPreemption): pmode major, -borrow minor.
    PreemptionOverBorrowing: -borrow major, pmode minor. NO_FIT is
    always least preferred."""
    pmode = pmode.long()
    borrow = borrow.long()
    default_key = pmode * _BIG - borrow
    pref_key = -borrow * _BIG + pmode
    no_fit = pmode == P_NO_FIT
    pref_key = pref_key.masked_fill(no_fit, -_BIG * _BIG)
    default_key = default_key.masked_fill(no_fit, -_BIG * _BIG)
    return torch.where(pref_preempt_first, pref_key, default_key)


def _classify_flavor(c, req, fl, avail, potential, nominal, derived,
                     ancestors, height, no_preemption, can_pwb, *, depth,
                     acc):
    """fitsResourceQuota before the preemption consult: classify flavor
    ``fl`` [W] for every resource of each workload. ``req`` [W, S] is
    checked as acc[fr] + req, where ``acc`` [W, R + 1] holds the usage
    already assigned to earlier pod sets (its last column is spare).
    Returns (pmode [W, S], borrow [W, S], oracle [W, S])."""
    S = req.shape[1]
    fr = fl.long()[:, None] * S + torch.arange(S, device=req.device)
    req = req + torch.where(req > 0, acc.gather(1, fr), 0)
    cc = c.long()[:, None].expand_as(fr)
    a = avail[cc, fr]
    p = potential[cc, fr]
    nom = nominal[cc, fr]
    no_fit = req > p
    fit = req <= a
    bh, may_reclaim = borrow_height(cc, fr, req, derived, ancestors, height,
                                    nominal, depth=depth)
    preempt_gate = (nom >= req) | may_reclaim | can_pwb[c.long()][:, None]
    pmode = torch.where(
        no_fit, P_NO_FIT,
        torch.where(fit, P_FIT,
                    torch.where(preempt_gate, P_NO_CANDIDATES, P_NO_FIT)))
    oracle = ~no_fit & ~fit & preempt_gate & ~no_preemption[c.long()][:, None]
    return pmode, bh, oracle


def _representative(keys, values, in_group):
    """values at the least key over the group's resources (first on
    ties); out-of-group columns carry the row's largest key."""
    masked = torch.where(in_group, keys, keys.max(dim=1, keepdim=True).values)
    return values.gather(1, masked.argmin(dim=1, keepdim=True))[:, 0], \
        masked.min(dim=1).values


def _eval_group(g, c, req, acc, g_of_res, flavors, avail, potential,
                nominal, derived, ancestors, height, no_preemption, can_pwb,
                try_next_borrow, pref, *, depth):
    """Scan group g's flavors for every workload: the chosen flavor, the
    group's representative pmode and borrow, and its oracle flag."""
    W, S = req.shape
    in_group = (g_of_res == g) & (req > 0)  # [W, S]
    best_key = torch.full((W,), -(_BIG * _BIG) - 1, dtype=torch.int64,
                          device=req.device)
    best_fl = torch.full((W,), -1, dtype=torch.int32, device=req.device)
    best_pmode = torch.full((W, S), P_NO_FIT, dtype=torch.int64,
                            device=req.device)
    best_borrow = torch.zeros((W, S), dtype=torch.int32, device=req.device)
    best_oracle = torch.zeros((W,), dtype=torch.bool, device=req.device)
    stopped = torch.zeros((W,), dtype=torch.bool, device=req.device)
    for f in range(flavors.shape[1]):
        fl = flavors[:, f]
        valid = fl >= 0
        pmode_s, borrow_s, oracle_s = _classify_flavor(
            c, req, torch.clamp(fl, min=0), avail, potential, nominal,
            derived, ancestors, height, no_preemption, can_pwb,
            depth=depth, acc=acc)
        # Resources outside the group count as perfectly fitting.
        pmode_s = torch.where(in_group, pmode_s, P_FIT)
        borrow_s = torch.where(in_group, borrow_s, 0)
        oracle_s = oracle_s & in_group
        keys = _mode_key(pmode_s, borrow_s, pref[:, None])
        rep_pmode, rep_key = _representative(keys, pmode_s, in_group)
        rep_borrow = torch.where(in_group, borrow_s, 0).max(dim=1).values
        # shouldTryNextFlavor (kernel modes only).
        try_next = (rep_pmode <= P_NO_CANDIDATES) | (
            (rep_borrow > 0) & try_next_borrow)
        consider = valid & ~stopped
        stop_here = consider & ~try_next
        take = (consider & (rep_key > best_key)) | stop_here
        best_key = torch.where(take, rep_key, best_key)
        best_fl = torch.where(take, fl, best_fl)
        best_pmode = torch.where(take[:, None], pmode_s, best_pmode)
        best_borrow = torch.where(take[:, None], borrow_s, best_borrow)
        best_oracle = torch.where(take, oracle_s.any(dim=1), best_oracle)
        stopped = stopped | stop_here
    group_active = in_group.any(dim=1)
    keys = _mode_key(best_pmode, best_borrow, pref[:, None])
    rep_pmode = torch.where(group_active,
                            _representative(keys, best_pmode, in_group)[0],
                            P_FIT)
    rep_pmode = torch.where(
        best_fl < 0, torch.where(group_active, P_NO_FIT, P_FIT), rep_pmode)
    group_borrow = torch.where(
        group_active & (best_fl >= 0),
        torch.where(in_group, best_borrow, 0).max(dim=1).values, 0)
    return best_fl, rep_pmode, group_borrow, best_oracle & group_active


def assign_flavors(
    wl_cq,  # int32[W]
    wl_req,  # int64[W, P, S] per-podset count-scaled requests
    derived,  # dict from quota.derive_world (usage-current)
    nominal,  # int64[N, R]
    ancestors,  # int32[N, D]
    height,  # int32[N]
    group_of_res,  # int32[C, S]
    group_flavors,  # int32[C, G, F]
    no_preemption,  # bool[C]
    can_pwb,  # bool[C]
    fung_borrow_try_next,  # bool[C]
    fung_pref_preempt_first,  # bool[C]
    *,
    depth: int,
    num_resources: int,
):
    """Returns per workload:
      flavor_of_res: int32[W, P, S] chosen flavor per (podset, resource),
          -1 none
      pmode: int64[W] representative mode (worst over pod sets)
      borrows: int32[W] borrowing level (max over pod sets)
      needs_oracle: bool[W]
      usage_fr: int64[W, P, S] flavor-resource index, -1 none
    Zero-request (padding) pod sets classify as fitting and choose no
    flavor."""
    S = num_resources
    R = nominal.shape[1]
    W, P = wl_req.shape[0], wl_req.shape[1]
    G = group_flavors.shape[1]
    dev = wl_req.device
    avail = torch.clamp(derived["available"], min=0)
    potential = derived["potential"]
    c = wl_cq.long()
    g_of_res = group_of_res[c]  # [W, S]
    pref = fung_pref_preempt_first[c]
    try_next_borrow = fung_borrow_try_next[c]
    s_ids = torch.arange(S, device=dev)

    acc = torch.zeros((W, R + 1), dtype=wl_req.dtype, device=dev)
    flavor_ps, pmode_ps, borrow_ps, oracle_ps, usage_fr_ps = \
        [], [], [], [], []
    for p in range(P):
        req = wl_req[:, p]  # [W, S]
        active = req > 0
        groups = [
            _eval_group(g, wl_cq, req, acc, g_of_res, group_flavors[c, g],
                        avail, potential, nominal, derived, ancestors,
                        height, no_preemption, can_pwb, try_next_borrow,
                        pref, depth=depth)
            for g in range(G)]
        g_fl = torch.stack([x[0] for x in groups], dim=1)  # [W, G]
        pmode = torch.stack([x[1] for x in groups], dim=1).min(dim=1).values
        borrows = torch.stack([x[2] for x in groups], dim=1) \
            .max(dim=1).values
        needs_oracle = torch.stack([x[3] for x in groups], dim=1).any(dim=1)
        # A requested resource no group covers makes the pod set NoFit.
        uncovered = (active & (g_of_res < 0)).any(dim=1)
        pmode = torch.where(uncovered, P_NO_FIT, pmode)
        flavor_of_res = torch.where(
            active & (g_of_res >= 0),
            g_fl.gather(1, torch.clamp(g_of_res, min=0).long()), -1)
        flavor_of_res = torch.where((pmode == P_NO_FIT)[:, None], -1,
                                    flavor_of_res)
        usage_fr = torch.where(flavor_of_res >= 0,
                               flavor_of_res.long() * S + s_ids, -1)
        # This pod set's usage counts against the next ones; column R
        # is the spare that takes unassigned resources.
        acc = acc.scatter_add(
            1, torch.where(usage_fr >= 0, usage_fr, R),
            torch.where(usage_fr >= 0, req, 0))
        flavor_ps.append(flavor_of_res)
        pmode_ps.append(pmode)
        borrow_ps.append(borrows)
        oracle_ps.append(needs_oracle)
        usage_fr_ps.append(usage_fr)
    return (torch.stack(flavor_ps, dim=1),
            torch.stack(pmode_ps, dim=1).min(dim=1).values,
            torch.stack(borrow_ps, dim=1).max(dim=1).values,
            torch.stack(oracle_ps, dim=1).any(dim=1),
            torch.stack(usage_fr_ps, dim=1))
