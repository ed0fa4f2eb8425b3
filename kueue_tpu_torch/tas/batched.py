"""Batched device TAS: cycle-level topology placement for the hybrid path.

The port of ``kueue_tpu/tas/batched.py``: the placements run as one
``ops/tas.tas_place_batch`` PyTorch program per group on the forest's
device; a failed launch raises out of the cycle.

Before this module, any ClusterQueue carrying a TAS flavor demoted its
whole cohort root to the sequential path (engine_bridge._flavor_unsafe
treated ``topology_name`` like taints), so TAS-heavy worlds never ran a
device cycle. The planner here lifts topology-aware admission into the
hybrid cycle:

  * ``plan_cycle`` nominates a topology assignment for every device-
    eligible TAS head BEFORE the quota kernel launches, against the
    cycle-start forest state — exactly the sequential nominate loop's
    semantics, where apply_tas_pass runs once per head against the
    cycle snapshot before any entry commits. Identical request
    signatures share one placement (the snapshot's _place_memo), and
    when the persisted crossover calibration (tas/calibration.py) says
    the device wins, all remaining distinct signatures of a flavor
    forest go through ONE padded ops/tas.tas_place_batch launch per
    (column axis, selection statics) group instead of a descent each.
  * Heads that need a TAS feature the batch can't express — leaders /
    pod-set groups, elastic previous slices, unhealthy-node
    replacement, multi-layer slice rounding, balanced placement — or
    whose placement fails at nomination (the host owns the
    PREEMPT -> simulate-empty -> park ladder) demote ONLY their root,
    with a per-reason counter, instead of forcing the cycle sequential.
  * ``commit_plan`` is the commit-order re-check: device admits
    serialize in slot_position order through a local capacity overlay
    that mirrors TASFlavorSnapshot.fits + add_usage (including the
    implicit per-pod "pods" slot), and an admit whose nominated
    placement no longer fits is DROPPED — the batched form of
    _process_entry's "no longer fits after processing another
    workload" skip. Dropped rows stay pending (device rows are never
    popped), exactly like a sequential commit skip.

Everything here READS the prototype forests; the only usage writes
remain in the assume path (scheduler_cache._account_tas ->
commit_usage), so the undo-log discipline (U1) is untouched.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kueue_tpu_torch.api.types import TopologyMode
from kueue_tpu_torch.config import features

_FEATURE = "tas-feature"
_RESOLVE = "tas-resolve"
_NO_FIT = "tas-no-fit"
_PLAN_MISS = "tas-plan-miss"


def enabled() -> bool:
    """KUEUE_TPU_TAS_BATCH=0 restores the legacy demote-everything
    behavior (every TAS CQ runs sequential) — the toggle the digest
    equivalence suite flips."""
    return os.environ.get("KUEUE_TPU_TAS_BATCH", "1") != "0"


def _now() -> float:
    import time
    return time.perf_counter()  # phase timing only, never decision state


def cq_tas_info(cache) -> dict:
    """{cq_name: (candidate TAS flavor names in spec order, tas_only)}
    for every ClusterQueue referencing at least one TAS flavor,
    memoized by spec version. ``tas_only`` mirrors assigner._tas_only:
    every flavor the CQ references carries a topology, so pod sets
    WITHOUT a topology request still get an (implied unconstrained)
    placement."""
    ver = cache.spec_version
    cached = getattr(cache, "_tas_cq_info", None)
    if cached is not None and cached[0] == ver:
        return cached[1]
    tas_names = cache._tas_flavor_names()
    info: dict = {}
    for name, spec in cache.cluster_queues.items():
        flv: list = []
        referenced: list = []
        for rg in spec.resource_groups:
            for fq in rg.flavors:
                referenced.append(fq.name)
                if fq.name in tas_names and fq.name not in flv:
                    flv.append(fq.name)
        if flv:
            info[name] = (tuple(flv),
                          all(n in tas_names for n in referenced))
    cache._tas_cq_info = (ver, info)
    return info


@dataclass
class CyclePlan:
    """One cycle's nominated placements and demotion verdicts."""

    # ci -> {flavor: {pod_set_name: TopologyAssignment}}. A ci mapped
    # to an EMPTY dict admits plainly (no pod set routes through TAS
    # for any candidate flavor — workload_tas_requests would skip it).
    placements: dict = field(default_factory=dict)
    # ci -> [(pod_set_name, single_pod_requests, count)] for the
    # commit overlay math (mirrors tas_usage_of_assignment inputs).
    requests: dict = field(default_factory=dict)
    # reason -> [ci] (heads the planner hands to the host path).
    demote: dict = field(default_factory=dict)
    # ci -> frozenset of candidate flavor names (forest-closure input;
    # includes demoted heads — a host TAS head can commit on any of
    # its CQ's TAS flavors).
    flavors_of: dict = field(default_factory=dict)
    # Real (unpadded) heads per tas_place_batch launch.
    launch_sizes: list = field(default_factory=list)
    placed_device: int = 0
    placed_host: int = 0
    memo_hits: int = 0
    timings: dict = field(default_factory=lambda: {
        "encode": 0.0, "place": 0.0, "decode": 0.0})

    def demote_head(self, ci: int, reason: str) -> None:
        self.demote.setdefault(reason, []).append(int(ci))


def plan_cycle(eng, w, head_wid, need: np.ndarray) -> CyclePlan:
    """Nominate placements for the TAS heads in ``need`` (bool[C]).

    Each head either gets a plan entry (every candidate flavor placed,
    or no placement needed), or a demotion reason. Placements are
    computed against the LIVE prototype forests (cache.tas_prototypes)
    — the same state the assume path commits into — so verdicts equal
    what the sequential nominate would produce at cycle start."""
    from kueue_tpu_torch.tas.snapshot import TASPodSetRequest

    plan = CyclePlan()
    cache = eng.cache
    protos = cache.tas_prototypes()
    info_by_cq = cq_tas_info(cache)
    rows = eng.queues.rows
    balanced = features.enabled("TASBalancedPlacement")

    # flavor -> {memo_key: (req, state)}; insertion order is the
    # deterministic ci scan order below (D1: launch composition feeds
    # the decision stream through demotions).
    by_flavor: dict = {}
    # ci -> [(flavor, memo_key)] in candidate order, for assembly.
    head_keys: dict = {}

    for ci in np.nonzero(need)[0]:
        ci = int(ci)
        flv_only = info_by_cq.get(w.cq_names[ci])
        if flv_only is None:
            continue
        flv, tas_only = flv_only
        plan.flavors_of[ci] = frozenset(flv)
        winfo = rows.info_of[int(head_wid[ci])]
        wobj = winfo.obj
        if wobj.replaced_workload_slice is not None:
            plan.demote_head(ci, _FEATURE)  # elastic delta: host path
            continue
        if getattr(wobj.status, "unhealthy_nodes", ()):
            plan.demote_head(ci, _FEATURE)  # node replacement: host
            continue
        sigs = rows.tas_requests(int(head_wid[ci]))
        any_tr = any(s[1][0] is not None for s in sigs)
        if len(sigs) != 1:
            # Multi-podset TAS threads assumed usage between pod sets
            # (find_assignments' shared accumulator): host path. A
            # multi-podset head with no TAS routing at all admits
            # plainly — but such heads are not fast-path encodable
            # anyway, so this is defensive.
            if any_tr or tas_only:
                plan.demote_head(ci, _FEATURE)
            else:
                plan.placements[ci] = {}
            continue
        ps_name, sig, single, count, group = sigs[0]
        if sig[0] is None and not tas_only:
            # No topology request and the CQ has non-TAS flavors: the
            # sequential pass skips placement entirely.
            plan.placements[ci] = {}
            continue
        if group:
            plan.demote_head(ci, _FEATURE)  # leader/pod-set group
            continue
        if balanced and sig[0] == TopologyMode.PREFERRED:
            plan.demote_head(ci, _FEATURE)  # balanced placement: host
            continue
        ps = wobj.pod_sets[0]
        req = TASPodSetRequest(ps, single, count)
        keys = []
        failed = None
        for fname in flv:
            proto = protos.get(fname)
            if proto is None:
                failed = _RESOLVE
                break
            state, _reason = proto.resolve_request(req, False)
            if state is None:
                # The host path surfaces the resolve error as the
                # placement failure reason; it owns that ladder.
                failed = _RESOLVE
                break
            if state.slice_size_at_level:
                failed = _FEATURE  # multi-layer rounding: host only
                break
            key = (sig, ps_name, False,
                   tuple(sorted((ps.node_selector or {}).items())))
            by_flavor.setdefault(fname, {}).setdefault(
                key, (req, state))
            keys.append((fname, key))
        if failed is not None:
            plan.demote_head(ci, failed)
            continue
        head_keys[ci] = keys
        plan.requests[ci] = [(ps_name, single, count)]

    # One placement per distinct (flavor, signature) — memo first,
    # then a batched launch per group, host descent for the rest.
    results: dict = {}
    for fname in sorted(by_flavor):
        results[fname] = _place_flavor(protos[fname], by_flavor[fname],
                                       plan)

    for ci, keys in head_keys.items():
        fmap = {}
        ok = True
        for fname, key in keys:
            res = results[fname].get(key)
            if res is None:
                plan.demote_head(ci, _PLAN_MISS)  # defensive
                ok = False
                break
            assignments, _reason = res
            if assignments is None:
                # Placement failed on a candidate flavor at nominate:
                # the host owns PREEMPT -> simulate-empty -> park
                # (and the kernel's flavor pick is unknown pre-launch,
                # so any failing candidate demotes).
                plan.demote_head(ci, _NO_FIT)
                ok = False
                break
            fmap[fname] = assignments
        if ok:
            plan.placements[ci] = fmap
        else:
            plan.requests.pop(ci, None)
    return plan


def _place_flavor(proto, items: dict, plan: CyclePlan) -> dict:
    """Place every distinct request signature against one flavor
    forest. Returns {memo_key: (assignments | None, reason)} with the
    exact result shape find_topology_assignments memoizes — batched
    results are inserted into the snapshot's _place_memo so later
    same-cycle host calls (feasibility, the host tail) agree."""
    from kueue_tpu_torch.tas import device

    out: dict = {}
    ver = proto._usage_version
    memo = proto._place_memo
    if memo is None or memo[0] != ver or len(memo[1]) > 4096:
        memo = (ver, {})
        proto._place_memo = memo
    pending: dict = {}
    for key, (req, state) in items.items():
        hit = memo[1].get(key)
        if hit is not None:
            plan.memo_hits += 1
            out[key] = hit
        else:
            pending[key] = (req, state)
    if not pending:
        return out

    device_items: dict = {}
    host_keys: list = []
    if (features.enabled("DeviceTAS") and proto.level_keys
            and device.worth_offloading(proto)):
        for key, (req, state) in pending.items():
            if state.least_free != state.unconstrained:
                # BestFit-unconstrained (TASProfileMixed off): the
                # kernel encodes the LeastFree profile — host descent
                # for these heads, NOT a demotion.
                host_keys.append(key)
            else:
                device_items[key] = (req, state)
    else:
        host_keys = list(pending)

    if device_items:
        for key, res in _place_batch(proto, device_items, plan).items():
            out[key] = res
            memo[1][key] = res
            plan.placed_device += 1
    for key in host_keys:
        req, _state = pending[key]
        t0 = _now()
        # Routes through the snapshot's own memo + phase-1 memo; on
        # calibrated backends worth_offloading may still take the
        # per-placement device path inside.
        out[key] = proto.find_topology_assignments(req)
        plan.timings["place"] += _now() - t0
        plan.placed_host += 1
    return out


def _place_batch(proto, items: dict, plan: CyclePlan) -> dict:
    """One padded tas_place_batch launch per (column axis, selection
    statics) group of request signatures, decoded identically to
    device.try_find (same failure strings, same sorted domain
    order)."""
    import torch

    from kueue_tpu_torch.ops import tas as tops
    from kueue_tpu_torch.tas.device import (
        _cols_for,
        _forest_tensors,
        _free_tensor,
        _req_vector,
        _structure,
        _usage_matrix,
        _usage_tensor,
    )
    from kueue_tpu_torch.tas.snapshot import (
        TopologyAssignment,
        TopologyDomainAssignment,
    )

    t0 = _now()
    struct = _structure(proto)
    nl = struct["nl"]
    mp = struct["m"]
    leaves = struct["leaves"]
    out: dict = {}

    # Group by the launch statics + column axis; order is the caller's
    # deterministic insertion order.
    groups: dict = {}
    for key, (req, state) in items.items():
        per_pod = dict(req.single_pod_requests)
        per_pod["pods"] = per_pod.get("pods", 0) + 1
        cols = _cols_for(struct, per_pod, {})
        if not struct["level_domains"][state.requested_level_idx]:
            out[key] = (None, (
                "no topology domains at level: "
                f"{proto.level_keys[state.requested_level_idx]}"))
            continue
        gkey = (tuple(cols), state.requested_level_idx,
                state.slice_level_idx, state.required,
                state.unconstrained)
        groups.setdefault(gkey, []).append((key, req, state, per_pod))

    dev = proto.device
    t_pods_cap, t_valid, t_vrank, t_parent = _forest_tensors(proto, struct)
    valid_leaves = struct["valid"][nl - 1]
    plan.timings["encode"] += _now() - t0

    for gkey, members in groups.items():
        t0 = _now()
        cols_key, req_idx, slice_idx, required, unconstrained = gkey
        cols = list(cols_key)
        col_of = {res: i for i, res in enumerate(cols)}
        usage = _usage_matrix(proto, struct, cols)
        B = len(members)
        Bp = 1 << (B - 1).bit_length() if B > 1 else 1
        per_pod = np.zeros((Bp, len(cols)), np.int64)
        count = np.ones(Bp, np.int64)
        slice_size = np.ones(Bp, np.int64)
        leaf_mask = np.zeros((Bp, mp), bool)
        leaf_mask[:] = valid_leaves  # padding rows fit trivially
        for b, (key, req, state, pp) in enumerate(members):
            per_pod[b] = _req_vector(pp, cols)
            count[b] = state.count
            slice_size[b] = state.slice_size
            excluded = proto._match_excluded(req.pod_set)
            if excluded:
                for i, leaf in enumerate(leaves):
                    if leaf.values in excluded:
                        leaf_mask[b, i] = False
        t_free = _free_tensor(proto, struct, cols)
        t_usage = _usage_tensor(proto, struct, cols, usage)
        t_rows = [torch.as_tensor(a, device=dev)
                  for a in (per_pod, leaf_mask, count, slice_size)]
        plan.timings["encode"] += _now() - t0

        t0 = _now()
        status, fit_arg, cnt, _lead = tops.tas_place_batch(
            t_free, t_usage, *t_rows, t_pods_cap, t_valid, t_vrank,
            t_parent, num_levels=nl, max_domains=mp,
            pods_col=col_of["pods"], req_level=req_idx,
            slice_level=slice_idx, required=required,
            unconstrained=unconstrained)
        # One transfer for the scalars, one for the counts.
        status, fit_arg = torch.stack([status, fit_arg]).cpu().numpy()
        cnt = cnt.cpu().numpy()
        plan.timings["place"] += _now() - t0
        plan.launch_sizes.append(B)

        t0 = _now()
        for b, (key, req, state, pp) in enumerate(members):
            st = int(status[b])
            if st == tops.ERR_NOT_FIT:
                stats = proto._exclusion_stats(req.pod_set, pp, False,
                                               {}, ())
                out[key] = (None, proto._not_fit_message(
                    int(fit_arg[b]), state.count // state.slice_size,
                    state.slice_size, stats))
                continue
            if st == tops.ERR_UNDERFLOW:
                out[key] = (None,
                            "internal: assignment accounting underflow")
                continue
            domains = sorted(
                (TopologyDomainAssignment(leaves[i].values,
                                          int(cnt[b, i]))
                 for i in np.nonzero(cnt[b] > 0)[0]),
                key=lambda a: a.values)
            out[key] = ({req.pod_set.name: TopologyAssignment(
                tuple(proto.level_keys), tuple(domains))}, "")
        plan.timings["decode"] += _now() - t0
    return out


def commit_plan(eng, w, wls, plan: CyclePlan, wl_admitted: np.ndarray,
                slot_position: np.ndarray, flavor_of_res: np.ndarray,
                cq_on_device: np.ndarray, num_rows: int):
    """Commit-order re-check for the device admits that carry a plan.

    Mirrors the sequential commit loop: process admits in
    slot_position order; re-check the nominated placement against a
    local overlay of this cycle's earlier TAS commits (the exact
    fits() arithmetic: free_capacity - tas_usage - overlay, per
    domain, NO implicit pods on the check side); on success accumulate
    the overlay with add_usage semantics (scaled requests PLUS one
    "pods" slot per placed pod) and attach; on failure DROP the admit
    — the batched form of the SKIPPED "no longer fits after processing
    another workload" verdict. Rows were never popped, so a drop needs
    no queue action.

    Returns (attach, drops, demote_cis):
      attach: row -> {pod_set_name: TopologyAssignment} for admits
        that keep their verdict (empty placements admit plainly);
      drops: rows whose admit verdict must be cleared;
      demote_cis: slots whose ROOT must demote post-kernel — a drop on
        a multi-CQ root invalidates the root's later quota decisions
        (sequential would re-check them), so the host re-runs the
        whole root. Singleton roots (the common TAS world) never
        demote here."""
    protos = eng.cache.tas_prototypes()
    info_by_cq = cq_tas_info(eng.cache)
    admit_of: dict = {}
    for i in np.nonzero(wl_admitted[:num_rows])[0]:
        ci = int(wls.cq[i])
        if ci in plan.placements and cq_on_device[ci]:
            admit_of[ci] = int(i)
    overlay: dict = {}
    attach: dict = {}
    drops: list = []
    demote_cis: list = []
    root_of_cq = w.root_of_cq
    for ci in sorted(admit_of, key=lambda c: int(slot_position[c])):
        i = admit_of[ci]
        fmap = plan.placements[ci]
        if not fmap:
            continue  # nothing TAS-routed: plain admit
        flv = info_by_cq.get(w.cq_names[ci], ((), False))[0]
        fname = _kernel_pick(w, wls, flavor_of_res, ci, i,
                             frozenset(flv))
        if fname is None:
            # The kernel put every requesting pod set on a non-TAS
            # flavor: workload_tas_requests would skip it too.
            continue
        assignments = fmap.get(fname)
        proto = protos.get(fname)
        ok = assignments is not None and proto is not None
        if ok:
            for ps_name, single, _count in plan.requests.get(ci, ()):
                ta = assignments.get(ps_name)
                if ta is None:
                    continue
                for dom in ta.domains:
                    leaf = proto.leaves.get(tuple(dom.values))
                    if leaf is None:
                        ok = False
                        break
                    over = overlay.get((fname, dom.values))
                    for res, per_pod in single.items():
                        head = leaf.free_capacity.get(res, 0) \
                            - leaf.tas_usage.get(res, 0)
                        if over:
                            head -= over.get(res, 0)
                        if per_pod * dom.count > head:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
        if ok:
            for ps_name, single, _count in plan.requests.get(ci, ()):
                ta = assignments.get(ps_name)
                if ta is None:
                    continue
                for dom in ta.domains:
                    over = overlay.setdefault((fname, dom.values), {})
                    for res, per_pod in single.items():
                        over[res] = over.get(res, 0) \
                            + per_pod * dom.count
                    over["pods"] = over.get("pods", 0) + dom.count
            attach[i] = assignments
        else:
            drops.append(i)
            root = int(root_of_cq[ci])
            if int(np.count_nonzero(root_of_cq == root)) > 1:
                demote_cis.append(ci)
    return attach, drops, demote_cis


def _kernel_pick(w, wls, flavor_of_res, ci: int, i: int,
                 tas_names: frozenset) -> Optional[str]:
    """The TAS flavor the sequential pass would route this admit
    through: the first assigned flavor (in the entry's resource
    iteration order, matching _make_entry) that is a TAS flavor —
    workload_tas_requests' next(fa.name in cq.tas_flavors)."""
    P = flavor_of_res.shape[1]
    for p in range(P):
        for s_i in range(len(w.resource_names)):
            fl = int(flavor_of_res[ci, p, s_i])
            if fl < 0 or wls.requests[i, p, s_i] <= 0:
                continue
            name = w.flavor_names[fl]
            if name in tas_names:
                return name
    return None


def closure_demotions(plan: CyclePlan, info_by_cq: dict, w,
                      has_head: np.ndarray, tas_cq: np.ndarray,
                      host_root: np.ndarray) -> list:
    """Shared-forest closure: TAS heads on host roots commit through
    the same prototype forests the plan was nominated against, at an
    arbitrary point of the host tail — placements for a forest must
    serialize through ONE path per cycle. Returns the device TAS slots
    whose candidate forests are touched by any host-root TAS head,
    iterated to a fixpoint (each demotion exposes its own forests to
    the host side). Forests are per-flavor (TAS usage never crosses
    flavors), so flavor names key the closure."""
    root_of_cq = w.root_of_cq
    hosted: set = set()
    for ci in np.nonzero(has_head & tas_cq & host_root[root_of_cq])[0]:
        flv = info_by_cq.get(w.cq_names[int(ci)])
        if flv is not None:
            hosted.update(flv[0])
    demoted: list = []
    demoted_set: set = set()
    changed = True
    while changed:
        changed = False
        for ci, flavors in plan.flavors_of.items():
            if ci in demoted_set or host_root[root_of_cq[ci]]:
                continue
            if flavors & hosted:
                demoted.append(ci)
                demoted_set.add(ci)
                # Every device slot on this root flips host with it.
                root = root_of_cq[ci]
                for cj, fl2 in plan.flavors_of.items():
                    if root_of_cq[cj] == root:
                        hosted.update(fl2)
                hosted.update(flavors)
                changed = True
    return demoted
