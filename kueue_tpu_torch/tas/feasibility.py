"""Batched TAS feasibility: fit/no-fit for many requests in one launch.

The port of ``kueue_tpu/tas/feasibility.py``. One launch of
``ops/tas.tas_feasibility`` per flavor forest decides fit/no-fit, with
the exact not-fit message argument, for every qualifying pod set, where
the placement path pays a phase 1 and a descent per request.

Exactness: a qualifying request's selection outcome is determined by
phase-1 counts (required: the top slice state at the requested level;
preferred: any level's top fit, else the level-0 greedy sum;
unconstrained: the requested level's sum), and the leaderless descent
below a successful selection cannot fail. So a verdict may reject
without running placement; successes still run the real placement.
Requests with leaders, pod-set groups, elastic previous slices or
multi-layer slices, and preferred requests under the balanced-placement
gate, do not qualify. Node selectors, taints and affinity qualify, as a
per-request leaf mask.

The live-usage verdict holds only while no TAS usage was removed from
the forest since the batch ran (``used_valid``); the simulate-empty
verdict holds whatever the usage.

``precompute`` runs the launches for a scheduling cycle's heads (the
host cycle's nomination calls it), gated by ``KUEUE_TPU_TAS_FEAS``,
``KUEUE_TPU_TAS_FEAS_MIN`` and ``KUEUE_TPU_TAS_FEAS_MIN_LEAVES`` as in
the reference. A failed launch raises out of the cycle: the port does
not turn it into a silent per-request fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from kueue_tpu_torch.api.types import TopologyMode
from kueue_tpu_torch.config import features

_MODE_NUM = {TopologyMode.REQUIRED: 0, TopologyMode.PREFERRED: 1,
             TopologyMode.UNCONSTRAINED: 2}


def enabled() -> bool:
    return os.environ.get("KUEUE_TPU_TAS_FEAS", "1") != "0"


@dataclass(frozen=True)
class Verdict:
    fit_used: bool
    arg_used: int
    fit_empty: bool
    arg_empty: int


def request_signature(pod_set, single_pod_requests, count):
    from kueue_tpu_torch.tas.snapshot import slice_topology_constraints
    tr = pod_set.topology_request
    mode = tr.mode if tr is not None else None
    return (mode, tr.level if tr else None,
            slice_topology_constraints(tr), int(count),
            tuple(sorted(single_pod_requests.items())),
            tuple(sorted((pod_set.node_selector or {}).items())),
            tuple(pod_set.tolerations or ()),
            tuple(tuple(term) for term in (pod_set.node_affinity or ())))


def _qualify(snap, pod_set, single, count):
    """Returns (slice_level_idx, req_level_idx, mode_num, slice_size,
    excluded_leaf_values) or None when the request does not qualify.
    Anchored on the snapshot's resolve_request, so the batch and the
    placement path agree on what a request means."""
    if not snap.level_keys:
        return None
    from kueue_tpu_torch.tas.snapshot import TASPodSetRequest
    tr = pod_set.topology_request
    mode = _MODE_NUM.get(tr.mode) if tr is not None else 2
    if mode is None:
        return None
    if features.enabled("TASBalancedPlacement") and mode == 1:
        return None
    if tr is not None and tr.pod_set_group_name:
        return None
    state, reason = snap.resolve_request(
        TASPodSetRequest(pod_set, single, count), has_leader=False)
    if state is None:
        return None
    if state.slice_size_at_level:
        return None  # multi-layer rounding
    excluded = snap._match_excluded(pod_set)
    return (state.slice_level_idx, state.requested_level_idx,
            2 if state.unconstrained else mode, state.slice_size,
            frozenset(excluded))


def collect_requests(wl, cq_snapshot):
    """(snap, sig, pod_set, single, count, params) tuples for every
    (TAS flavor x pod set) pair of a pending head that the batch can
    decide. The assigned flavor is not known before flavor assignment,
    so every candidate TAS flavor of the CQ is covered."""
    if wl.obj.replaced_workload_slice is not None:
        return []
    if getattr(wl.obj.status, "unhealthy_nodes", ()):
        return []
    out = []
    # Identity dedup in tas_flavors insertion order: several flavor
    # names can share a forest, and set() iteration order would vary
    # run to run (launch order feeds the decision stream).
    for snap in {id(s): s for s in
                 cq_snapshot.tas_flavors.values()}.values():
        for i, ps in enumerate(wl.obj.pod_sets):
            single = wl.total_requests[i].single_pod_requests()
            params = _qualify(snap, ps, single, ps.count)
            if params is None:
                continue
            sig = request_signature(ps, single, ps.count)
            out.append((snap, sig, ps, single, ps.count, params))
    return out


def precompute(heads, snapshot) -> None:
    """Run one feasibility launch per flavor forest for the cycle's
    pending heads and park the verdicts on each snap (``_feas`` /
    ``_feas_removals``). Below ``KUEUE_TPU_TAS_FEAS_MIN`` (default 12)
    qualifying head requests, or ``KUEUE_TPU_TAS_FEAS_MIN_LEAVES``
    (default 2048) leaves, a forest gets no launch: the instance count
    counts request instances, not distinct signatures, because the
    savings scale with the retries. A failed launch raises."""
    if not enabled():
        return
    min_batch = int(os.environ.get("KUEUE_TPU_TAS_FEAS_MIN", "12"))
    min_leaves = int(os.environ.get("KUEUE_TPU_TAS_FEAS_MIN_LEAVES",
                                    "2048"))
    by_snap: dict[int, tuple[object, dict, list[int]]] = {}
    for w in heads:
        cqs = snapshot.cluster_queue(w.cluster_queue)
        if cqs is None or not cqs.tas_flavors:
            continue
        for snap, sig, ps, single, count, params in \
                collect_requests(w, cqs):
            if len(snap.leaves) < min_leaves:
                continue
            _, reqs, n = by_snap.setdefault(id(snap), (snap, {}, [0]))
            reqs.setdefault(sig, (single, count, params))
            n[0] += 1
    for snap, reqs, n in by_snap.values():
        snap._feas = None
        if n[0] >= min_batch:
            park(snap, reqs)


def _launch(snap, reqs: dict) -> dict:
    """One feasibility launch for ``reqs`` ({signature: (single, count,
    _qualify params)}) against the snapshot's current usage. Returns
    {signature: Verdict}."""
    from kueue_tpu_torch.ops import tas as tops
    from kueue_tpu_torch.tas.device import (
        _cols_for,
        _forest_tensors,
        _free_tensor,
        _structure,
        _usage_matrix,
        _usage_tensor,
    )

    struct = _structure(snap)
    sigs = list(reqs)
    all_per_pod = []
    for sig in sigs:
        single, _count, _params = reqs[sig]
        pp = dict(single)
        pp["pods"] = pp.get("pods", 0) + 1
        all_per_pod.append(pp)
    union: dict[str, int] = {}
    for pp in all_per_pod:
        union.update(pp)
    cols = _cols_for(struct, union, {})
    col_of = {res: i for i, res in enumerate(cols)}
    usage = _usage_matrix(snap, struct, cols)

    B = len(sigs)
    Bp = 1 << (B - 1).bit_length()  # the reference's power-of-two padding
    S = len(cols)
    M = struct["m"]
    leaves_list = struct["leaves"]
    per_pod = np.zeros((Bp, S), np.int64)
    count = np.ones(Bp, np.int64)
    slice_size = np.ones(Bp, np.int64)
    slice_level = np.zeros(Bp, np.int64)
    req_level = np.zeros(Bp, np.int64)
    mode = np.zeros(Bp, np.int64)
    leaf_mask = np.ones((Bp, M), bool)
    for b, sig in enumerate(sigs):
        single, cnt_b, (slice_idx, req_idx, mode_n, ss, excluded) = \
            reqs[sig]
        for res, v in all_per_pod[b].items():
            if res in col_of:
                per_pod[b, col_of[res]] = min(v, 1 << 60)
        count[b] = cnt_b
        slice_size[b] = ss
        slice_level[b] = slice_idx
        req_level[b] = req_idx
        mode[b] = mode_n
        if excluded:
            for i, leaf in enumerate(leaves_list):
                if leaf.values in excluded:
                    leaf_mask[b, i] = False
    # Padding rows: count 1, zero requests: they fit trivially.

    dev = snap.device
    t_pods_cap, t_valid, _t_vrank, t_parent = _forest_tensors(snap, struct)
    fit, arg = tops.tas_feasibility(
        _free_tensor(snap, struct, cols),
        _usage_tensor(snap, struct, cols, usage),
        *(torch.as_tensor(a, device=dev)
          for a in (per_pod, count, slice_size, slice_level, req_level,
                    mode, leaf_mask)),
        t_valid, t_parent, t_pods_cap,
        num_levels=struct["nl"], max_domains=M, pods_col=col_of["pods"])
    fit = fit.cpu().numpy()
    arg = arg.cpu().numpy()
    return {sig: Verdict(bool(fit[0, b]), int(arg[0, b]),
                         bool(fit[1, b]), int(arg[1, b]))
            for b, sig in enumerate(sigs)}


def park(snap, reqs: dict) -> dict:
    """Run one launch for ``reqs`` and park the verdicts on the snapshot
    for ``lookup``, with the usage-removal count they hold for."""
    snap._feas = _launch(snap, reqs)
    snap._feas_removals = snap._usage_removals
    return snap._feas


def lookup(tas_snap, request):
    """The verdict for a request, or None. Callers use ``fit_used`` only
    while ``used_valid(tas_snap)`` holds."""
    verdicts = tas_snap._feas
    if not verdicts:
        return None
    if request.previous_assignment is not None:
        return None
    sig = request_signature(request.pod_set,
                            request.single_pod_requests, request.count)
    return verdicts.get(sig)


def used_valid(tas_snap) -> bool:
    """Live-usage verdicts assume usage only grew since the batch ran;
    any removal invalidates them."""
    return tas_snap._usage_removals == tas_snap._feas_removals
