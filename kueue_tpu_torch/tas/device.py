"""Device TAS: the serving-path adapter for ``ops/tas.tas_place``.

The port of ``kueue_tpu/tas/device.py``.
``TASFlavorSnapshot.find_topology_assignments`` dispatches here. The
adapter:

  * encodes the topology forest once per structure change (slots sorted
    by values per level, parent pointers, value ranks), cached on the
    snapshot keyed by its structure version;
  * gathers the per-call leaf capacity state (free / TAS usage / assumed
    usage), the pod set's resource vectors, and the selector /
    replacement-domain leaf mask;
  * runs the placement program on the snapshot's device and renders the
    reference's failure strings from its status codes.

Corners the program does not take raise ``NotImplementedError``: leader
co-placement, elastic delta placement, balanced placement (preferred
mode under the TASBalancedPlacement gate), multi-layer slices,
BestFit-unconstrained (TASProfileMixed off) and level-less topologies.
The JAX package handles those on its sequential host path, which the
port does not have.
"""

from __future__ import annotations

import numpy as np
import torch

from kueue_tpu_torch.config import features

_VRANK_PAD = 1 << 40


def _structure(snap):
    """Padded per-level slot arrays for the snapshot's forest, cached by
    the snapshot's structure version."""
    cached = snap._device_struct
    if cached is not None and cached["version"] == snap._version:
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
    cached = dict(version=snap._version, nl=nl, m=mp,
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
    assignment}, "") or (None, failure_reason); raises
    NotImplementedError on a corner the device program does not take."""
    from kueue_tpu_torch.ops import tas as tops
    from kueue_tpu_torch.tas.snapshot import (
        TopologyAssignment,
        TopologyDomainAssignment,
    )

    if not snap.level_keys:
        raise NotImplementedError("TAS placement needs topology levels")
    if getattr(workers, "previous_assignment", None) is not None:
        raise NotImplementedError("elastic delta placement is not ported")
    if leader is not None:
        raise NotImplementedError("leader co-placement is not ported")
    count = workers.count
    state, reason = snap.resolve_request(workers, False)
    if state is None:
        return None, reason
    required = state.required
    unconstrained = state.unconstrained
    if (features.enabled("TASBalancedPlacement") and not required
            and not unconstrained):
        raise NotImplementedError("balanced placement is not ported")
    if state.slice_size_at_level:
        raise NotImplementedError("multi-layer slice placement is not "
                                  "ported")
    if state.least_free != state.unconstrained:
        raise NotImplementedError("BestFit-unconstrained placement is not "
                                  "ported")
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
