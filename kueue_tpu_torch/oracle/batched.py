"""The batched scheduling oracle on tensors: the port of
``kueue_tpu/oracle/batched.py`` for the classical, no-preemption cycle.

One cycle (``cycle_step``):
  1. derive quota state from current usage        [ops/quota.derive_world]
  2. pick per-CQ heads (priority/ts ranks)        [ops/heads: CUDA kernel]
  3. nominate all heads at once                   [ops/assign.assign_flavors]
  4. order entries (classical iterator key)       [stable argsort]
  5. sequential-equivalent commit per root        [ops/commit.commit_grouped]
  6. park NoFit heads (BestEffortFIFO inadmissible semantics)

``drain_loop`` runs cycles until one admits nothing, with one host sync
per cycle on the progress flag. Fair sharing, fused classical
preemption, bridge overrides and preemption victims are not ported yet:
passing any of their arguments raises NotImplementedError.
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
from kueue_tpu_torch.ops import quota as qops
from kueue_tpu_torch.tensor.schema import (
    WL_PAD_FILLS,
    encode_snapshot,
    encode_workloads,
    pad_axis0,
    pow2_bucket,
)

BIG_RANK = 1 << 40

# Arguments of the JAX cycle that belong to paths not ported yet: bridge
# overrides and preemption victims, fused classical preemption, and
# per-workload flavor masks.
_UNPORTED_ARGS = frozenset({
    "slot_kind_override", "slot_borrows_override", "slot_flavor_override",
    "slot_victim_row", "slot_victim_vals", "slot_victim_ids", "claimed0",
    "adm_cq", "adm_pri", "adm_ts", "adm_qrt", "adm_uid", "adm_evicted",
    "adm_usage", "adm_rank", "adm_by_root", "pc_wcq_policy",
    "pc_reclaim_policy", "pc_bwc_forbidden", "pc_bwc_threshold",
    "pc_cq_has_parent", "root_of_cq", "wl_flavor_ok", "slot_maybe",
})


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
    wl_ts=None, fair_weight=None, child_rank=None, local_depth=None,
    root_parent_local=None,
    *,
    depth: int, num_resources: int, num_cqs: int,
    fair_mode: bool = False, num_flavors: int = 1, v_cap: int = 32,
    **unported,
):
    """One classical scheduling cycle. ``wl_ts``, ``fair_weight``,
    ``child_rank``, ``local_depth``, ``root_parent_local``,
    ``num_flavors`` and ``v_cap`` only matter to the fair-sharing and
    preemption paths; they are accepted, as the JAX cycle accepts them,
    and not read. Returns the JAX cycle's 14 outputs."""
    unknown = sorted(set(unported) - _UNPORTED_ARGS)
    if unknown:
        raise TypeError(f"unexpected arguments: {unknown}")
    given = sorted(k for k, v in unported.items() if v is not None)
    if fair_mode or given:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(
                (["fair_mode"] if fair_mode else []) + given))
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

    # 4. Commit order.
    key = cops.make_commit_order_key(
        wl_has_qr[h_safe] & slot_valid, borrows,
        torch.where(slot_valid, wl_priority[h_safe], 0),
        torch.where(slot_valid, commit_rank[h_safe], (1 << 24) - 1))
    order = torch.argsort(key, stable=True)
    # 5. Commit.
    slot_admitted, _ = cops.commit_grouped(
        key, slot_valid, entry_fr_d, req_fr, kind, borrows, full_usage,
        derived["subtree_quota"], lend_limit, borrow_limit, nominal,
        ancestors, root_members, root_nodes, local_chain, depth=depth)
    # Positions report the global commit order.
    slot_position = torch.empty(C, dtype=torch.int32, device=dev)
    slot_position[order] = torch.arange(C, dtype=torch.int32, device=dev)
    adm_target = torch.where(slot_valid & slot_admitted, h_safe, W)
    wl_admitted = torch.zeros(W + 1, dtype=torch.bool, device=dev)
    wl_admitted[adm_target] = True
    wl_admitted = wl_admitted[:W]

    # 6. Park NoFit / no-candidate heads on BestEffortFIFO CQs, and with
    # them the pending workloads of the same scheduling-equivalence
    # hash.
    parked_slot = slot_valid & ~slot_admitted & best_effort[hc] & (
        (pmode == aops.P_NO_FIT) | (pmode == aops.P_NO_CANDIDATES))
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

    no_slots = torch.zeros((C,), dtype=torch.bool, device=dev)
    return (new_pending, new_inadmissible, usage_clean, wl_admitted,
            slot_admitted, slot_position, flavor_of_res, slot_oracle.any(),
            slot_oracle, no_slots, head_idx, no_slots.clone(),
            torch.zeros((C, 0), dtype=torch.bool, device=dev),
            torch.zeros((C, 0), dtype=torch.int32, device=dev))


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
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, snapshot, pending_infos, max_depth: int = 4,
                 device=None):
        self.device = resolve_device(device)
        self.world = encode_snapshot(snapshot, max_depth=max_depth)
        self.wls = encode_workloads(self.world, pending_infos)
        self.infos = pending_infos

    @classmethod
    def from_tensors(cls, world, wls, device=None):
        """A solver over an already encoded world: ``world`` and ``wls``
        map WorldTensors / WorkloadTensors field names to numpy arrays
        and scalars (for example ``vars()`` of another encoder's
        output)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.world = carry.world_tensors(world)
        self.wls = carry.workload_tensors(wls)
        self.infos = None
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
                    num_cqs=w.num_cqs, num_flavors=max(w.num_flavors, 1))

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
