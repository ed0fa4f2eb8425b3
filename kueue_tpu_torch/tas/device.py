"""Device TAS: the serving-path adapter for ``ops/tas.tas_place``.

The port of ``kueue_tpu/tas/device.py``.
``TASFlavorSnapshot.find_topology_assignments`` dispatches here when
``worth_offloading`` says so; the sequential host descent in
``tas/snapshot.py`` places otherwise. The adapter:

  * encodes the topology forest once per structure change (slots sorted
    by values per level, parent pointers, value ranks), cached on the
    snapshot keyed by its structure version; a fork
    (``TASFlavorSnapshot.fork``) remaps its prototype's encoding instead
    of rebuilding it;
  * gathers the per-call leaf capacity state (free / TAS usage / assumed
    usage), the pod set's resource vectors, and the selector /
    replacement-domain leaf mask;
  * runs the placement program on the snapshot's device and renders the
    reference's failure strings from its status codes;
  * computes the host descent's leaderless phase 1 as numpy reductions
    over the same leaf matrices (``fill_in_counts_np``).

``try_find`` returns ``NotImplemented`` on the corners the program does
not take, as the reference does, and the host descent places them:
leader co-placement, elastic delta placement, balanced placement,
multi-layer slices, BestFit-unconstrained (TASProfileMixed off) and
level-less topologies.
"""

from __future__ import annotations

import numpy as np
import torch

from kueue_tpu_torch.config import features

_VRANK_PAD = 1 << 40


def worth_offloading(snap) -> bool:
    """True when per-placement device offload is enabled for this
    forest. KUEUE_TPU_DEVICE_TAS_MIN, when set, is an explicit leaf
    threshold (0 = always offload); otherwise the decision comes from
    the persisted crossover calibration, and with no calibration the
    host path wins (the pre-measurement default). Memoized per
    (structure version, env override) — the batched planner asks once
    per placement group per cycle."""
    import os

    from kueue_tpu_torch.tas import calibration

    if not snap.level_keys:
        return False
    override = os.environ.get("KUEUE_TPU_DEVICE_TAS_MIN")
    key = (snap._version, override, calibration.generation)
    cached = snap._worth_memo
    if cached is not None and cached[0] == key:
        return cached[1]
    nl = len(snap.level_keys)
    if override is not None:
        try:
            threshold = int(override)
        except ValueError:
            snap._worth_memo = (key, False)
            return False
        out = len(snap.domains_per_level[nl - 1]) >= threshold
        snap._worth_memo = (key, out)
        return out
    out = calibration.device_placement_wins(snap)
    snap._worth_memo = (key, out)
    return out


def _structure(snap):
    """Padded per-level slot arrays for the snapshot's forest, cached by
    the snapshot's structure version."""
    cached = snap._device_struct
    version = snap._version
    if cached is not None and cached["version"] == version:
        return cached
    # Forked snapshots (TASFlavorSnapshot.fork) share the prototype's
    # structure: remap the domain-object lists onto the fork's clones
    # and reuse every array and device tensor (same shapes, same slot
    # order). The struct is built on the prototype, so every later fork
    # shares it instead of re-encoding and re-uploading the forest.
    donor = snap._struct_donor
    if donor is not None:
        donor_struct = _structure(donor)
        if donor_struct["version"] == version:
            level_domains = [[snap.domains[d.values] for d in doms]
                             for doms in donor_struct["level_domains"]]
            cached = dict(donor_struct, level_domains=level_domains,
                          leaves=(level_domains[-1] if level_domains
                                  else []))
            snap._device_struct = cached
            return cached
    nl = len(snap.level_keys)
    level_domains = [
        sorted(snap.domains_per_level[lvl].values(),
               key=lambda d: d.values)
        for lvl in range(nl)]
    m = max(1, max((len(doms) for doms in level_domains), default=1))
    mp = max(8, 1 << (m - 1).bit_length())
    valid = np.zeros((nl, mp), bool)
    vrank = np.full((nl, mp), _VRANK_PAD, np.int64)
    parent = np.full((nl, mp), -1, np.int64)
    slot_of = [{d.id: i for i, d in enumerate(doms)}
               for doms in level_domains]
    for lvl, doms in enumerate(level_domains):
        for i, d in enumerate(doms):
            valid[lvl, i] = True
            vrank[lvl, i] = i
            if lvl > 0:
                parent[lvl, i] = slot_of[lvl - 1][d.parent.id]
    leaves = level_domains[nl - 1] if nl else []
    res_axis = sorted({res for leaf in leaves
                       for res in leaf.free_capacity} | {"pods"})
    has_pods_cap = np.zeros(mp, bool)
    for i, leaf in enumerate(leaves):
        has_pods_cap[i] = "pods" in leaf.free_capacity
    cached = dict(version=version, nl=nl, m=mp,
                  level_domains=level_domains, leaves=leaves,
                  slot_of_leaf_values={d.values: i
                                       for i, d in enumerate(leaves)},
                  slot_of_leaf_id={d.id: i
                                   for i, d in enumerate(leaves)},
                  res_axis=res_axis, valid=valid, vrank=vrank,
                  parent=parent, has_pods_cap=has_pods_cap,
                  free_cache={}, tensor_cache={})
    snap._device_struct = cached
    return cached


def _req_vector(requests: dict, cols: list[str]) -> np.ndarray:
    out = np.zeros(len(cols), np.int64)
    for i, res in enumerate(cols):
        out[i] = requests.get(res, 0)
    return out


def _cols_for(struct, per_pod: dict, leader_per_pod: dict) -> list[str]:
    """The column axis for a request pair: the forest's resources, then
    the request's other resources, padded to a multiple of 4."""
    axis = struct["res_axis"]
    extras = sorted((set(per_pod) | set(leader_per_pod)) - set(axis))
    cols = axis + extras
    sp = max(4, -(-len(cols) // 4) * 4)
    return cols + [f"__pad{i}" for i in range(sp - len(cols))]


def _free_matrix(struct, cols: list[str]) -> np.ndarray:
    cols_key = tuple(cols)
    free = struct["free_cache"].get(cols_key)
    if free is None:
        col_of = {res: i for i, res in enumerate(cols)}
        free = np.zeros((struct["m"], len(cols)), np.int64)
        for i, leaf in enumerate(struct["leaves"]):
            for res, cap in leaf.free_capacity.items():
                free[i, col_of[res]] = cap
        struct["free_cache"][cols_key] = free
    return free


_USAGE_LRU_CAP = 4


def _usage_matrix(snap, struct, cols: list[str]) -> np.ndarray:
    """Dense leaf usage for a column set, behind a small LRU keyed
    (usage_version, cols), so pod sets with different column axes
    alternating against one forest do not re-densify it per call."""
    cols_key = tuple(cols)
    uver = snap._usage_version
    ucache = snap._usage_matrix_cache
    if ucache is None:
        ucache = snap._usage_matrix_cache = {}
    hit = ucache.get((uver, cols_key))
    if hit is not None:
        # Recency bump: eviction drops the least recently used entry.
        ucache[(uver, cols_key)] = ucache.pop((uver, cols_key))
        return hit
    col_of = {res: i for i, res in enumerate(cols)}
    usage = np.zeros((struct["m"], len(cols)), np.int64)
    used_leaves = snap._used_leaves
    if used_leaves is None:
        leaf_iter = enumerate(struct["leaves"])
    else:
        # Only leaves that ever carried usage: O(used), not O(forest).
        slot_of = struct["slot_of_leaf_values"]
        leaves = struct["leaves"]
        leaf_iter = ((slot_of[v], leaves[slot_of[v]])
                     for v in used_leaves if v in slot_of)
    for i, leaf in leaf_iter:
        for res, used in leaf.tas_usage.items():
            if res in col_of:
                usage[i, col_of[res]] = used
    while len(ucache) >= _USAGE_LRU_CAP:
        ucache.pop(next(iter(ucache)))
    ucache[(uver, cols_key)] = usage
    return usage


def fill_in_counts_np(snap, pod_set, per_pod: dict, slice_size: int,
                      slice_level_idx: int, simulate_empty: bool,
                      assumed_usage: dict,
                      required_replacement_domain: tuple,
                      excluded: dict = None,
                      slice_size_at_level: dict = None) -> bool:
    """Vectorized phase-1 (fillInCounts, tas_flavor_snapshot.go:1750)
    for the NO-LEADER case: compute per-domain fit counts as numpy
    reductions over the cached leaf matrices and write them back into
    the domain objects the host phase-2 descent reads. Runs on the host
    CPU — at small forest sizes dispatching a device program per
    placement costs more than the whole computation, but the dense
    encoding still beats the per-leaf dict walk by ~10x. Returns False
    when the world is unsupported (leaders are bubbled with min-diff
    tracking on the Python path; multi-layer inner slice rounding
    stays on the host bubble)."""
    if not snap.level_keys:
        return False
    if slice_size_at_level:
        return False
    struct = _structure(snap)
    nl = struct["nl"]
    mp = struct["m"]
    leaves = struct["leaves"]
    if not leaves:
        return False
    cols = _cols_for(struct, per_pod, {})
    col_of = {res: i for i, res in enumerate(cols)}
    free = _free_matrix(struct, cols)
    if simulate_empty:
        remaining = free.astype(np.int64, copy=True)
    else:
        remaining = free - _usage_matrix(snap, struct, cols)
        if assumed_usage:
            slot_of_leaf = {leaf.id: i for i, leaf in enumerate(leaves)}
            for leaf_id, used in assumed_usage.items():
                i = slot_of_leaf.get(leaf_id)
                if i is None:
                    continue
                for res, v in used.items():
                    ci = col_of.get(res)
                    if ci is not None:
                        remaining[i, ci] -= v
    remaining = np.maximum(remaining, 0)

    # Per-leaf pod counts: min over requested resources of
    # remaining // need; "pods" is unconstrained for leaves without
    # explicit pod capacity (fillLeafCounts :1864).
    BIG = np.int64(1) << 60
    counts = np.full(mp, BIG, np.int64)
    applied = np.zeros(mp, bool)
    pods_cap = struct["has_pods_cap"]
    for res, need in per_pod.items():
        if need <= 0:
            continue
        ci = col_of[res]
        c = remaining[:, ci] // need
        if res == "pods":
            c = np.where(pods_cap, c, BIG)
            applied |= pods_cap
        else:
            applied[:] = True
        counts = np.minimum(counts, c)
    counts = np.where(applied, counts, 0)
    counts[~struct["valid"][nl - 1]] = 0

    # matchNode exclusions (taints / selectors / affinity, precomputed
    # by snapshot._match_excluded) + replacement-domain filtering.
    rrd = tuple(required_replacement_domain or ())
    if rrd or excluded:
        excluded = excluded or {}
        for i, leaf in enumerate(leaves):
            if rrd and leaf.values[:len(rrd)] != rrd:
                counts[i] = 0
            elif leaf.values in excluded:
                counts[i] = 0

    # Bottom-up aggregation (fillInCountsHelper :1906, no-leader form:
    # state_with_leader == state, leader_state == 0 throughout).
    state = np.zeros((nl, mp), np.int64)
    state[nl - 1] = counts
    for lvl in range(nl - 2, -1, -1):
        child_valid = struct["valid"][lvl + 1]
        np.add.at(state[lvl], struct["parent"][lvl + 1][child_valid],
                  state[lvl + 1][child_valid])
    slices = np.zeros((nl, mp), np.int64)
    for lvl in range(nl - 1, -1, -1):
        if lvl == slice_level_idx:
            slices[lvl] = state[lvl] // slice_size
        elif lvl < slice_level_idx and lvl < nl - 1:
            child_valid = struct["valid"][lvl + 1]
            np.add.at(slices[lvl],
                      struct["parent"][lvl + 1][child_valid],
                      slices[lvl + 1][child_valid])

    for lvl, doms in enumerate(struct["level_domains"]):
        s = state[lvl].tolist()  # bulk int conversion beats per-item
        sl = slices[lvl].tolist()
        for i, d in enumerate(doms):
            si = s[i]
            sli = sl[i]
            d.state = si
            d.slice_state = sli
            d.state_with_leader = si
            d.slice_state_with_leader = sli
            d.leader_state = 0
    return True


def _forest_tensors(snap, struct):
    """(has_pods_cap, valid, vrank, parent) on the snapshot's device,
    moved once per structure version."""
    tc = struct["tensor_cache"]
    if "consts" not in tc:
        tc["consts"] = tuple(
            torch.as_tensor(struct[k], device=snap.device)
            for k in ("has_pods_cap", "valid", "vrank", "parent"))
    return tc["consts"]


def _free_tensor(snap, struct, cols: list[str]):
    tc = struct["tensor_cache"]
    key = ("free", tuple(cols))
    if key not in tc:
        tc[key] = torch.as_tensor(_free_matrix(struct, cols),
                                  device=snap.device)
    return tc[key]


def _zeros_tensor(snap, struct, shape):
    tc = struct["tensor_cache"]
    key = ("zeros", shape)
    if key not in tc:
        tc[key] = torch.zeros(shape, dtype=torch.int64, device=snap.device)
    return tc[key]


def _usage_tensor(snap, struct, cols: list[str], usage: np.ndarray):
    """The live usage matrix on the device, kept between calls and
    keyed (usage_version, cols) like _usage_matrix, so a placement after
    add_usage never reads stale usage."""
    if not np.any(usage):
        return _zeros_tensor(snap, struct, usage.shape)
    ukey = (snap._usage_version, tuple(cols))
    cached = snap._usage_tensor_cache
    if cached is not None and cached[0] == ukey:
        return cached[1]
    t = torch.as_tensor(usage, device=snap.device)
    snap._usage_tensor_cache = (ukey, t)
    return t


def try_find(snap, workers, leader=None, simulate_empty=False,
             assumed_usage=None, required_replacement_domain=()):
    """Device findTopologyAssignment. Returns ({pod_set_name:
    assignment}, "") or (None, failure_reason), or NotImplemented on a
    corner the device program does not take (the host descent places
    those)."""
    from kueue_tpu_torch.ops import tas as tops
    from kueue_tpu_torch.tas.snapshot import (
        TopologyAssignment,
        TopologyDomainAssignment,
    )

    if not snap.level_keys:
        return NotImplemented
    if getattr(workers, "previous_assignment", None) is not None:
        return NotImplemented  # elastic delta placement
    if leader is not None:
        return NotImplemented  # leader co-placement
    count = workers.count
    state, reason = snap.resolve_request(workers, False)
    if state is None:
        return None, reason
    required = state.required
    unconstrained = state.unconstrained
    if (features.enabled("TASBalancedPlacement") and not required
            and not unconstrained):
        return NotImplemented  # balanced placement
    if state.slice_size_at_level:
        return NotImplemented  # multi-layer slice rounding
    if state.least_free != state.unconstrained:
        # TASProfileMixed off: the program's unconstrained branches
        # encode the LeastFreeCapacity profile.
        return NotImplemented
    slice_size = state.slice_size
    req_idx = state.requested_level_idx
    slice_idx = state.slice_level_idx

    struct = _structure(snap)
    if not struct["level_domains"][req_idx]:
        return None, ("no topology domains at level: "
                      f"{snap.level_keys[req_idx]}")

    per_pod = dict(workers.single_pod_requests)
    per_pod["pods"] = per_pod.get("pods", 0) + 1
    cols = _cols_for(struct, per_pod, {})
    sp = len(cols)
    mp = struct["m"]
    leaves = struct["leaves"]
    col_of = {res: i for i, res in enumerate(cols)}

    assumed = np.zeros((mp, sp), np.int64)
    if simulate_empty:
        usage = np.zeros((mp, sp), np.int64)
    else:
        usage = _usage_matrix(snap, struct, cols)
        if assumed_usage:
            slot_of_id = struct["slot_of_leaf_id"]
            for leaf_id, res_used in assumed_usage.items():
                i = slot_of_id.get(leaf_id)
                if i is None:
                    continue
                for res, used in res_used.items():
                    if res in col_of:
                        assumed[i, col_of[res]] = used

    # matchNode exclusions (taints / full-label selectors / affinity)
    # + replacement-domain leaf filtering.
    leaf_mask = struct["valid"][struct["nl"] - 1].copy()
    rrd = tuple(required_replacement_domain or ())
    excluded = snap._match_excluded(workers.pod_set)
    if rrd or excluded:
        for i, leaf in enumerate(leaves):
            if rrd and leaf.values[:len(rrd)] != rrd:
                leaf_mask[i] = False
            elif leaf.values in excluded:
                leaf_mask[i] = False

    dev = snap.device
    t_pods_cap, t_valid, t_vrank, t_parent = _forest_tensors(snap, struct)
    t_usage = _usage_tensor(snap, struct, cols, usage)
    if np.any(assumed):
        t_assumed = torch.as_tensor(assumed, device=dev)
    else:
        t_assumed = _zeros_tensor(snap, struct, assumed.shape)
    if rrd or excluded:
        t_mask = torch.as_tensor(leaf_mask, device=dev)
    else:
        t_mask = t_valid[struct["nl"] - 1]

    snap.device_placements += 1
    status, fit_arg, cnt, lead = tops.tas_place(
        _free_tensor(snap, struct, cols), t_usage, t_assumed,
        torch.as_tensor(_req_vector(per_pod, cols), device=dev),
        _zeros_tensor(snap, struct, (sp,)),
        t_mask, t_pods_cap, t_valid, t_vrank, t_parent, count,
        slice_size, num_levels=struct["nl"], max_domains=mp,
        pods_col=col_of["pods"], req_level=req_idx,
        slice_level=slice_idx, required=required,
        unconstrained=unconstrained, has_leader=False)
    # One transfer for the scalars, one for the counts.
    status, fit_arg = torch.stack([status, fit_arg]).tolist()
    cnt = cnt.cpu().numpy()
    if status == tops.ERR_NOT_FIT:
        # The same failure string as the reference's host walk: the
        # exclusion-stats tail is a pure function of (request, forest).
        stats = snap._exclusion_stats(
            workers.pod_set, per_pod, simulate_empty, assumed_usage or {},
            required_replacement_domain)
        return None, snap._not_fit_message(fit_arg, count // slice_size,
                                           slice_size, stats)
    if status == tops.ERR_UNDERFLOW:
        return None, "internal: assignment accounting underflow"

    domains = sorted(
        (TopologyDomainAssignment(leaves[i].values, int(cnt[i]))
         for i in np.nonzero(cnt > 0)[0]),
        key=lambda a: a.values)
    return {workers.pod_set.name: TopologyAssignment(
        tuple(snap.level_keys), tuple(domains))}, ""
