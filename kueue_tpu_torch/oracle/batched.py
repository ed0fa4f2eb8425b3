"""The batched scheduling oracle on tensors: the port of
``kueue_tpu/oracle/batched.py``.

One cycle (``cycle_step``):
  1. derive quota state from current usage        [ops/quota.derive_world]
  2. pick per-CQ heads (priority/ts ranks)        [ops/heads: CUDA kernel]
  3. nominate all heads at once                   [ops/assign.assign_flavors]
  4. select preemption targets for the preempt-flagged heads, when the
     admitted set is given                  [ops/preempt.classical_targets]
  5. order and commit, sequential-equivalent per root: the classical
     iterator key and ops/commit.commit_grouped, or in fair mode the DRS
     tournament of ops/commit.commit_grouped_fair
  6. park NoFit heads (BestEffortFIFO inadmissible semantics)

``drain_loop`` runs cycles until one admits nothing, with one host sync
per cycle on the progress flag. The bridge overrides (kind, borrow level
and flavor per slot) and per-workload flavor masks are not ported yet:
passing any of them raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kueue_tpu_torch import carry
from kueue_tpu_torch.device import resolve_device
from kueue_tpu_torch.ops import assign as aops
from kueue_tpu_torch.ops import commit as cops
from kueue_tpu_torch.ops import heads as hops
from kueue_tpu_torch.ops import preempt as pops
from kueue_tpu_torch.ops import quota as qops
from kueue_tpu_torch.tensor.schema import (
    WL_PAD_FILLS,
    encode_snapshot,
    encode_workloads,
    pad_axis0,
    pow2_bucket,
)

BIG_RANK = 1 << 40

@dataclass
class DrainDecision:
    key: str
    cluster_queue: str
    cycle: int
    position: int  # commit position within the cycle
    flavors: dict  # resource -> flavor name (first pod set)
    podset_flavors: list = None  # per-podset flavor dicts


def _cycle_core(
    pending,  # bool[W]
    inadmissible,  # bool[W]
    usage,  # int64[N, R] (full node usage, invariant-consistent)
    rank,  # int64[W] global head-order rank (priority desc, ts asc)
    commit_rank,  # int64[W] FIFO tiebreak rank for the commit order
    wl_cq,  # int32[W]
    wl_req,  # int64[W, P, S]
    wl_priority,  # int64[W]
    wl_has_qr,  # bool[W]
    wl_hash,  # int32[W] scheduling-equivalence hash id
    nominal, lend_limit, borrow_limit, parent, ancestors, height,
    group_of_res, group_flavors, no_preemption, can_pwb, can_always_reclaim,
    best_effort, fung_borrow_try_next, fung_pref_preempt_first,
    root_members, root_nodes, local_chain,
    wl_ts=None,  # float64[W] creation time (fair and preemption order)
    fair_weight=None,  # float64[N]
    child_rank=None,  # int64[N] fair-tournament child-order tiebreak
    local_depth=None,  # int32[Rn, K] fair-tournament level structure
    slot_kind_override=None,  # not ported: raises
    slot_borrows_override=None,  # not ported: raises
    slot_flavor_override=None,  # not ported: raises
    root_parent_local=None,  # int32[Rn, K] (victim-removal bubbling)
    slot_victim_row=None,  # int32[C, V] victim CQ local positions
    slot_victim_vals=None,  # int64[C, V, R] victim usage rows
    slot_victim_ids=None,  # int32[C, V] admitted ids (overlap rule)
    claimed0=None,  # bool[A] initially claimed victims
    # Fused classical preemption: with the admitted tensors and the
    # policy config, preempt-flagged slots get their victims selected
    # inside the cycle (ops/preempt.classical_targets_impl against the
    # cycle-start usage).
    adm_cq=None,  # int32[A]
    adm_pri=None,  # int64[A]
    adm_ts=None,  # float64[A]
    adm_qrt=None,  # float64[A]
    adm_uid=None,  # int64[A]
    adm_evicted=None,  # bool[A]
    adm_usage=None,  # int64[A, R]
    pc_wcq_policy=None,  # int32[C]
    pc_reclaim_policy=None,  # int32[C]
    pc_bwc_forbidden=None,  # bool[C]
    pc_bwc_threshold=None,  # int64[C]
    pc_cq_has_parent=None,  # bool[C]
    root_of_cq=None,  # int32[C]
    adm_rank=None,  # int64[A] precomputed candidate-ordering rank
    adm_by_root=None,  # int32[Rn, A_l] admitted ids grouped by root
    wl_flavor_ok=None,  # not ported: raises
    slot_maybe=None,  # bool[C] host precheck: this slot's head could
    #   have preemption candidates (False only when provably none).
    #   Slots masked off take the "no candidates" outcome; a cycle with
    #   no such slot skips target selection.
    *,
    depth: int, num_resources: int, num_cqs: int,
    fair_mode: bool = False, num_flavors: int = 1, v_cap: int = 32,
):
    """One scheduling cycle, classical or fair (``fair_mode``), with
    fused classical preemption when the ``adm_*`` / ``pc_*`` arguments
    are given (ignored in fair mode, as in the JAX cycle). Returns the
    JAX cycle's 14 outputs."""
    unported = dict(slot_kind_override=slot_kind_override,
                    slot_borrows_override=slot_borrows_override,
                    slot_flavor_override=slot_flavor_override,
                    wl_flavor_ok=wl_flavor_ok)
    given = [k for k, v in unported.items() if v is not None]
    if given:
        raise NotImplementedError("not ported yet: " + ", ".join(given))
    W = pending.shape[0]
    C = num_cqs
    S = num_resources
    dev = pending.device

    # 1. Derive quota state from CQ usage rows.
    is_cq_row = (torch.arange(usage.shape[0], device=dev) < C)[:, None]
    cq_usage = torch.where(is_cq_row, usage, 0)
    derived = qops.derive_world(nominal, lend_limit, borrow_limit, cq_usage,
                                parent, depth=depth)

    # 2. Heads: per CQ, the lowest rank among active pending workloads.
    active = pending & ~inadmissible
    eff_rank = torch.where(active, rank, BIG_RANK)
    head_rank = hops.select_heads(eff_rank, wl_cq, C, BIG_RANK)
    cq_safe = torch.clamp(wl_cq, min=0).long()
    w_ids = torch.arange(W, dtype=torch.int32, device=dev)
    is_head = active & (eff_rank == head_rank[cq_safe]) \
        & (eff_rank < BIG_RANK)
    # CQ -> head workload index (-1 none). Heads are unique per CQ
    # because rank embeds the workload index; non-heads go to spare C.
    head_idx = torch.full((C + 1,), -1, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, torch.where(is_head, wl_cq, C).long(), w_ids,
                        "amax", include_self=True)[:C]

    slot_valid = head_idx >= 0
    h_safe = torch.clamp(head_idx, min=0).long()
    h_cq = torch.where(slot_valid, wl_cq[h_safe], 0).to(torch.int32)
    h_req = torch.where(slot_valid[:, None, None], wl_req[h_safe], 0)
    hc = h_cq.long()

    # 3. Nominate all heads at once.
    flavor_of_res, pmode, borrows, needs_oracle, usage_fr = \
        aops.assign_flavors(
            h_cq, h_req, derived, nominal, ancestors, height, group_of_res,
            group_flavors, no_preemption, can_pwb, fung_borrow_try_next,
            fung_pref_preempt_first, depth=depth, num_resources=S)

    # Dense per-flavor-resource entry form: requests summed over pod
    # sets per fr column, so columns are unique (two pod sets sharing a
    # flavor are fit-checked against their combined usage).
    R = nominal.shape[1]
    flat_fr = usage_fr.reshape(C, -1)
    flat_req = h_req.reshape(C, -1)
    req_fr = torch.zeros((C, R), dtype=h_req.dtype, device=dev).scatter_add(
        1, torch.where(flat_fr >= 0, flat_fr, 0),
        torch.where(flat_fr >= 0, flat_req, 0))
    entry_fr_d = torch.where(
        req_fr > 0, torch.arange(R, dtype=torch.int32, device=dev)[None, :],
        -1)

    # Entry kinds: FIT commits; preempt-mode without candidates reserves
    # capacity unless the CQ can always reclaim; everything else skips.
    kind = torch.where(
        ~slot_valid | needs_oracle, cops.ENTRY_SKIP,
        torch.where(pmode == aops.P_FIT, cops.ENTRY_FIT,
                    torch.where((pmode == aops.P_NO_CANDIDATES)
                                & ~can_always_reclaim[hc],
                                cops.ENTRY_RESERVE, cops.ENTRY_SKIP)))
    slot_oracle = needs_oracle & slot_valid
    # Commit against the freshly aggregated usage.
    full_usage = derived["usage"]

    # Fused classical preemption target selection.
    def no_slots():
        return torch.zeros((C,), dtype=torch.bool, device=dev)

    slot_overflow = no_slots()
    victim_mask = torch.zeros((C, 0), dtype=torch.bool, device=dev)
    victim_variant = torch.zeros((C, 0), dtype=torch.int32, device=dev)
    fused_preempt = no_slots()
    if adm_cq is not None and not fair_mode:
        h_pri = torch.where(slot_valid, wl_priority[h_safe], 0)
        h_ts = torch.where(slot_valid, wl_ts[h_safe], 0.0)
        oracle_eff = slot_oracle if slot_maybe is None \
            else slot_oracle & slot_maybe
        A = adm_cq.shape[0]
        V = min(v_cap, A if adm_by_root is None else adm_by_root.shape[1])
        if bool(oracle_eff.any()):
            out = pops.classical_targets_impl(
                oracle_eff, h_pri, h_ts, entry_fr_d, req_fr, pc_wcq_policy,
                pc_reclaim_policy, pc_bwc_forbidden, pc_bwc_threshold,
                pc_cq_has_parent, adm_cq, adm_pri, adm_ts, adm_qrt, adm_uid,
                adm_evicted, adm_usage, full_usage, derived["subtree_quota"],
                lend_limit, borrow_limit, nominal, ancestors, height,
                local_chain, root_nodes, root_of_cq, adm_rank=adm_rank,
                adm_by_root=adm_by_root, depth=depth, v_cap=v_cap)
            (pfound, poverflow, victim_mask, _, victim_variant, pborrow,
             pv_ids, ptaken) = out
            victim_variant = victim_variant.to(torch.int32)
            pborrow = pborrow.to(torch.int32)
        else:  # no slot could have candidates: the "none found" outcome
            pfound = poverflow = no_slots()
            victim_mask = torch.zeros((C, A), dtype=torch.bool, device=dev)
            victim_variant = torch.zeros((C, A), dtype=torch.int32,
                                         device=dev)
            pborrow = torch.zeros(C, dtype=torch.int32, device=dev)
            pv_ids = torch.zeros((C, V), dtype=torch.int32, device=dev)
            ptaken = torch.zeros((C, V), dtype=torch.bool, device=dev)
        pfound = pfound & oracle_eff
        fused_preempt = pfound
        slot_overflow = poverflow & oracle_eff
        # Precheck-masked slots land here too: no candidates is the
        # selection's found=False outcome.
        no_cand = slot_oracle & ~pfound & ~slot_overflow
        kind = torch.where(
            pfound, cops.ENTRY_PREEMPT,
            torch.where(slot_overflow, cops.ENTRY_SKIP,
                        torch.where(no_cand,
                                    torch.where(can_always_reclaim[hc],
                                                cops.ENTRY_SKIP,
                                                cops.ENTRY_RESERVE),
                                    kind)))
        borrows = torch.where(pfound, pborrow, borrows)
        # Pack each slot's victims into v_cap columns for the commit.
        pv_safe = torch.clamp(pv_ids, min=0).long()
        sel = ptaken & pfound[:, None]
        f_row = torch.where(
            sel, local_chain[torch.clamp(adm_cq[pv_safe], min=0).long(), 0],
            -1)
        f_vals = torch.where(sel[:, :, None], adm_usage[pv_safe], 0)
        f_ids = torch.where(sel, pv_safe, -1).to(torch.int32)
        if V < v_cap:
            pad = v_cap - V
            f_row = torch.cat([f_row, f_row.new_full((C, pad), -1)], dim=1)
            f_vals = torch.cat([f_vals, f_vals.new_zeros((C, pad, R))],
                               dim=1)
            f_ids = torch.cat([f_ids, f_ids.new_full((C, pad), -1)], dim=1)
        if slot_victim_row is None:
            slot_victim_row, slot_victim_vals, slot_victim_ids = \
                f_row, f_vals, f_ids
        else:
            m = pfound[:, None]
            slot_victim_row = torch.where(m, f_row, slot_victim_row)
            slot_victim_vals = torch.where(m[:, :, None], f_vals,
                                           slot_victim_vals)
            slot_victim_ids = torch.where(m, f_ids, slot_victim_ids)
        if claimed0 is None:
            claimed0 = torch.zeros((A,), dtype=torch.bool, device=dev)
        # Every flagged slot is decided in the cycle; overflow slots are
        # reported on their own.
        slot_oracle = no_slots()
    if fair_mode:
        # Fair-sharing tournament order fused with the commit: the DRS
        # is recomputed per root after every winner.
        slot_admitted, slot_round, _ = cops.commit_grouped_fair(
            slot_valid, entry_fr_d, req_fr, kind, borrows,
            torch.where(slot_valid, wl_priority[h_safe], 0),
            torch.where(slot_valid, wl_ts[h_safe], 0.0),
            full_usage, derived["subtree_quota"], lend_limit, borrow_limit,
            nominal, ancestors, derived["potential"], fair_weight, parent,
            root_members, root_nodes, local_chain, child_rank, local_depth,
            root_parent_local, depth=depth, num_flavors=num_flavors)
        slot_preempting = no_slots()
        # Positions: the tournament round within the root.
        slot_position = torch.clamp(slot_round, min=0)
        key = slot_round.long()  # replay order for usage_clean
    else:
        # 4. Commit order.
        key = cops.make_commit_order_key(
            wl_has_qr[h_safe] & slot_valid, borrows,
            torch.where(slot_valid, wl_priority[h_safe], 0),
            torch.where(slot_valid, commit_rank[h_safe], (1 << 24) - 1))
        order = torch.argsort(key, stable=True)
        # 5. Commit.
        slot_committed, _ = cops.commit_grouped(
            key, slot_valid, entry_fr_d, req_fr, kind, borrows, full_usage,
            derived["subtree_quota"], lend_limit, borrow_limit, nominal,
            ancestors, root_members, root_nodes, local_chain,
            root_parent_local, slot_victim_row, slot_victim_vals,
            slot_victim_ids, claimed0, depth=depth)
        slot_admitted = slot_committed & (kind != cops.ENTRY_PREEMPT)
        slot_preempting = slot_committed & (kind == cops.ENTRY_PREEMPT)
        # Positions report the global commit order.
        slot_position = torch.empty(C, dtype=torch.int32, device=dev)
        slot_position[order] = torch.arange(C, dtype=torch.int32, device=dev)
    adm_target = torch.where(slot_valid & slot_admitted, h_safe, W)
    wl_admitted = torch.zeros(W + 1, dtype=torch.bool, device=dev)
    wl_admitted[adm_target] = True
    wl_admitted = wl_admitted[:W]

    # 6. Park NoFit / no-candidate heads on BestEffortFIFO CQs, and with
    # them the pending workloads of the same scheduling-equivalence
    # hash. Preempting entries never park: they wait for their victims'
    # evictions, and their siblings must not be parked with them.
    preempt_override = fused_preempt & (kind == cops.ENTRY_PREEMPT)
    parked_slot = slot_valid & ~slot_admitted & best_effort[hc] & (
        (pmode == aops.P_NO_FIT) | (pmode == aops.P_NO_CANDIDATES)) \
        & ~preempt_override
    wl_parked = torch.zeros(W + 1, dtype=torch.bool, device=dev)
    wl_parked[torch.where(parked_slot, h_safe, W)] = True
    # Index W marks "no parked slot"; W + 1 takes hash ids past the
    # table, which the JAX scatter drops.
    parked_hash_mask = torch.zeros(W + 2, dtype=torch.bool, device=dev)
    parked_hash_mask[torch.clamp(
        torch.where(parked_slot, wl_hash[h_safe].long(), W), max=W + 1)] = True
    wl_parked = wl_parked[:W] | (
        active & parked_hash_mask[torch.clamp(wl_hash, max=W).long()])

    new_pending = pending & ~wl_admitted
    new_inadmissible = inadmissible | (wl_parked & new_pending)

    # Reservations are cycle-local: recompute post-cycle usage from the
    # admissions only.
    committed_kind = torch.where(slot_admitted, cops.ENTRY_FORCE,
                                 cops.ENTRY_SKIP)
    _, usage_clean = cops.commit_grouped(
        key, slot_valid, entry_fr_d, req_fr, committed_kind, borrows,
        full_usage, derived["subtree_quota"], lend_limit, borrow_limit,
        nominal, ancestors, root_members, root_nodes, local_chain,
        depth=depth)

    return (new_pending, new_inadmissible, usage_clean, wl_admitted,
            slot_admitted, slot_position, flavor_of_res, slot_oracle.any(),
            slot_oracle, slot_preempting, head_idx, slot_overflow,
            victim_mask, victim_variant)


cycle_step = _cycle_core


def drain_loop(
    pending, inadmissible, usage, rank, commit_rank, wl_cq, wl_req,
    wl_priority, wl_has_qr, wl_hash, nominal, lend_limit, borrow_limit,
    parent, ancestors, height, group_of_res, group_flavors, no_preemption,
    can_pwb, can_always_reclaim, best_effort, fung_borrow_try_next,
    fung_pref_preempt_first, root_members, root_nodes, local_chain,
    max_cycles, wl_ts=None, fair_weight=None, child_rank=None,
    local_depth=None, root_parent_local=None,
    *,
    depth: int, num_resources: int, num_cqs: int,
    fair_mode: bool = False, num_flavors: int = 1,
):
    """Run scheduling cycles until a cycle admits nothing (or
    max_cycles), recording per-workload verdicts. The host reads one
    flag per cycle. Returns:
      admit_cycle int32[W]  (-1 = not admitted)
      admit_pos   int32[W]  commit position within its cycle
      wl_flavor   int32[W, P, S] chosen flavor per (podset, resource)
      usage       final usage tensor
      cycles      int number of cycles run (including the empty one)
      oracle_flag bool tensor: any workload flagged for the preemptor
    """
    W = pending.shape[0]
    dev = pending.device
    cq_safe = torch.clamp(wl_cq, min=0).long()
    admit_cycle = torch.full((W,), -1, dtype=torch.int32, device=dev)
    admit_pos = torch.zeros((W,), dtype=torch.int32, device=dev)
    wl_flavor = torch.full((W, wl_req.shape[1], num_resources), -1,
                           dtype=torch.int32, device=dev)
    oracle_flag = torch.zeros((), dtype=torch.bool, device=dev)
    cycle, progress = 0, True
    while progress and cycle < max_cycles:
        (pending, inadmissible, usage, wl_admitted, _slot_admitted,
         slot_position, flavor_of_res, any_oracle, _slot_oracle,
         _slot_preempting, _head_idx, _slot_overflow, _vmask,
         _vvariant) = _cycle_core(
            pending, inadmissible, usage, rank, commit_rank, wl_cq, wl_req,
            wl_priority, wl_has_qr, wl_hash, nominal, lend_limit,
            borrow_limit, parent, ancestors, height, group_of_res,
            group_flavors, no_preemption, can_pwb, can_always_reclaim,
            best_effort, fung_borrow_try_next, fung_pref_preempt_first,
            root_members, root_nodes, local_chain, wl_ts, fair_weight,
            child_rank, local_depth, root_parent_local=root_parent_local,
            depth=depth, num_resources=num_resources, num_cqs=num_cqs,
            fair_mode=fair_mode, num_flavors=num_flavors)
        admit_cycle = torch.where(wl_admitted, cycle, admit_cycle)
        admit_pos = torch.where(wl_admitted, slot_position[cq_safe],
                                admit_pos)
        wl_flavor = torch.where(wl_admitted[:, None, None],
                                flavor_of_res[cq_safe], wl_flavor)
        oracle_flag = oracle_flag | any_oracle
        progress = bool(wl_admitted.any())
        cycle += 1
    return admit_cycle, admit_pos, wl_flavor, usage, cycle, oracle_flag


class BatchedDrainSolver:
    """Drive the cycle to quiescence over a pending set, on ``device``
    (CUDA unless the caller asks for the CPU); ``fair`` runs the
    fair-sharing cycle."""

    def __init__(self, snapshot, pending_infos, max_depth: int = 4,
                 fair: bool = False, device=None):
        self.device = resolve_device(device)
        self.world = encode_snapshot(snapshot, max_depth=max_depth)
        self.wls = encode_workloads(self.world, pending_infos)
        self.infos = pending_infos
        self.fair = fair

    @classmethod
    def from_tensors(cls, world, wls, fair: bool = False, device=None):
        """A solver over an already encoded world: ``world`` and ``wls``
        map WorldTensors / WorkloadTensors field names to numpy arrays
        and scalars (for example ``vars()`` of another encoder's
        output)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.world = carry.world_tensors(world)
        self.wls = carry.workload_tensors(wls)
        self.infos = None
        self.fair = fair
        return self

    def head_ranks(self) -> np.ndarray:
        """Heap order: priority desc, timestamp asc, stable by index."""
        W = self.wls.num_workloads
        order = np.lexsort((np.arange(W), self.wls.timestamp,
                            -self.wls.priority))
        rank = np.empty(W, np.int64)
        rank[order] = np.arange(W)
        return rank

    def commit_ranks(self) -> np.ndarray:
        """FIFO tiebreak for the commit order: queue-order timestamp
        ascending, stable by index."""
        W = self.wls.num_workloads
        order = np.lexsort((np.arange(W), self.wls.timestamp))
        rank = np.empty(W, np.int64)
        rank[order] = np.arange(W)
        return rank

    def _host_args(self):
        """The cycle's argument set as numpy arrays."""
        w, wl = self.world, self.wls
        return dict(
            rank=self.head_ranks(), commit_rank=self.commit_ranks(),
            wl_cq=wl.cq, wl_req=wl.requests, wl_priority=wl.priority,
            wl_has_qr=wl.has_quota_reservation, wl_hash=wl.hash_id,
            nominal=w.nominal, lend_limit=w.lend_limit,
            borrow_limit=w.borrow_limit, parent=w.parent,
            ancestors=w.ancestors, height=w.height,
            group_of_res=w.group_of_res, group_flavors=w.group_flavors,
            no_preemption=w.no_preemption,
            can_pwb=w.can_preempt_while_borrowing,
            can_always_reclaim=w.can_always_reclaim,
            best_effort=w.best_effort,
            fung_borrow_try_next=w.fung_borrow_try_next,
            fung_pref_preempt_first=w.fung_pref_preempt_first,
            root_members=w.root_members, root_nodes=w.root_nodes,
            local_chain=w.local_chain, wl_ts=wl.timestamp,
            fair_weight=w.fair_weight, child_rank=w.child_rank,
            local_depth=w.local_depth,
            root_parent_local=w.root_parent_local,
        )

    def _to_device(self, args: dict) -> dict:
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   device=self.device)
                for k, v in args.items()}

    def _statics(self):
        w = self.world
        return dict(depth=w.depth, num_resources=w.num_resources,
                    num_cqs=w.num_cqs, fair_mode=self.fair,
                    num_flavors=max(w.num_flavors, 1))

    def solve_one_cycle(self, usage=None):
        """Run exactly one scheduling cycle. Returns (admitted row ids
        np.int64[], usage np[N, R]) so a caller can carry usage across
        re-encoded cycles. The workload axis is padded to a power of two
        as in the JAX solver."""
        w, wl = self.world, self.wls
        W = wl.num_workloads
        Wp = pow2_bucket(W, 64)
        args = self._host_args()
        if Wp != W:
            for key, fill in WL_PAD_FILLS.items():
                args[key] = pad_axis0(args[key], Wp, fill)
        active = np.zeros(Wp, bool)
        active[:W] = wl.eligible & (wl.cq >= 0)
        args = self._to_device(args)
        pending = torch.as_tensor(active, device=self.device)
        inadmissible = torch.zeros(Wp, dtype=torch.bool, device=self.device)
        usage = torch.as_tensor(w.usage if usage is None else usage,
                                device=self.device)
        out = cycle_step(pending, inadmissible, usage, **args,
                         **self._statics())
        wl_admitted = out[3][:W].cpu().numpy()
        return np.nonzero(wl_admitted)[0], out[2].cpu().numpy()

    def solve(self, max_cycles: int = 10_000):
        """Drain until no cycle admits anything. Returns (decisions,
        stats)."""
        w, wl = self.world, self.wls
        pending = torch.as_tensor(wl.eligible & (wl.cq >= 0),
                                  device=self.device)
        inadmissible = torch.zeros(wl.num_workloads, dtype=torch.bool,
                                   device=self.device)
        usage = torch.as_tensor(np.broadcast_to(
            w.usage, (w.num_nodes, w.nominal.shape[1])).copy(),
            device=self.device)
        admit_cycle, admit_pos, wl_flavor, usage, cycles, oracle_flag = \
            drain_loop(pending, inadmissible, usage,
                       **self._to_device(self._host_args()),
                       max_cycles=max_cycles, **self._statics())
        admit_cycle = admit_cycle.cpu().numpy()
        admit_pos = admit_pos.cpu().numpy()
        wl_flavor = wl_flavor.cpu().numpy()

        decisions: list[DrainDecision] = []
        admitted_ids = np.nonzero(admit_cycle >= 0)[0]
        order = admitted_ids[np.lexsort((admit_pos[admitted_ids],
                                         admit_cycle[admitted_ids]))]
        P = wl.requests.shape[1]
        for wid in order:
            podset_flavors = []
            # Real pod sets only (the tensor axis is pow2-padded).
            n_real = P if self.infos is None \
                else min(len(self.infos[wid].total_requests), P)
            for p in range(n_real):
                flavors = {}
                for s_i, res in enumerate(w.resource_names):
                    fl = wl_flavor[wid, p, s_i]
                    if fl >= 0 and wl.requests[wid, p, s_i] > 0:
                        flavors[res] = w.flavor_names[fl]
                podset_flavors.append(flavors)
            decisions.append(DrainDecision(
                key=wl.keys[wid], cluster_queue=w.cq_names[wl.cq[wid]],
                cycle=int(admit_cycle[wid]), position=int(admit_pos[wid]),
                flavors=podset_flavors[0], podset_flavors=podset_flavors))
        return decisions, {
            "cycles": int(cycles),
            "needs_oracle": bool(oracle_flag),
            "admitted": len(decisions),
            "final_usage": usage.cpu().numpy(),
            "admit_cycle": admit_cycle,
            "admit_pos": admit_pos,
            "wl_flavor": wl_flavor,
        }
