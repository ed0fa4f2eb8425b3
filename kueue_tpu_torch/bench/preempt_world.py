"""The preemption world: BASELINE config 4's shape (preemption-heavy,
20,000 workloads churning) at 1,000 ClusterQueues, with the host loop
that drives the fused classical-preemption cycle over it.

The world is the reference bench's ``bench_preempt_churn``
(``bench.py:272-335``) built without the engine:

  * ClusterQueues ``cq-{i}`` in cohort ``co-{i % n_cohorts}``, flavor
    ``default``, cpu nominal 4,000; withinClusterQueue LowerPriority;
    reclaimWithinCohort LowerPriority for odd i, Never for even i.
  * The fill: ``n_cqs * 4000 * 8 // (10 * 1000)`` workloads of priority
    0, one pod of cpu 1,000 (80% of capacity; 3,200 at 1,000 CQs).
  * The wave: ``n_wave`` workloads of priority 10 or 50 and cpu 1,000 or
    2,000 (16,800 at full width: fill and wave are 20,000).
  * Queues, priorities and sizes come from one ``random.Random(7)`` in
    the bench's order; creation times from the bench's running clock,
    ``+= 0.001`` before each submission (``bench.py:322,330``).
  * uids are ``uid-{index:08d}`` in submission order, set explicitly:
    the candidate order breaks ties on the uid, and the reference's
    counter is process-wide.

The fill is admitted by the port's classical drain
(``BatchedDrainSolver``); its rows reserve quota at the clock after the
last fill submission, since the bench's drain does not advance the
clock (``bench.py:256-270``: ``tick(0.0)``). Fill rows the drain left
unadmitted start pending with the wave.

The host loop (``run``) is numpy only, and the cycle function is a
parameter (``TorchExecutor.cycle_step`` of the port, or the JAX
package's executor in the tests). The workload axis holds fill and wave;
each workload's state lives in arrays (pending, inadmissible, admitted,
reservation time, usage), and the API objects stay as submitted. Each
cycle:

  1. builds the fused arguments with ``oracle/engine_bridge`` (policy
     codes, padded admitted set, the slot precheck from the host's own
     head selection), as the engine bridge's cycle encode does, and
     calls the cycle;
  2. adds the ``wl_admitted`` rows to the admitted set, reserving at the
     cycle's clock (the clock after the last wave submission: the bench
     never advances it while draining) with their chosen flavors' usage;
     a re-admitted row is not evicted (reservation resets the Evicted
     condition, ``engine.py:1539``);
  3. the victims of ``slot_preempting`` slots leave the admitted set,
     their usage leaves the ClusterQueue rows of the carried usage (the
     cycle derives the cohort rows), and they return to pending and
     active at once (``evict(requeue=True)``, ``engine.py:1703,1770``:
     no backoff for preemption, same creation time, so the same rank);
  4. every ClusterQueue under the cohort root of a ClusterQueue that
     lost a victim gets its inadmissible workloads back
     (``_requeue_cohorts_bulk``, ``engine.py:1860``);
  5. stops after a cycle that admits nothing and preempts nothing, or
     at ``MAX_CYCLES``.

Where the loop differs from the engine: the engine hands a root with an
overflow slot (more than ``v_cap`` victims needed) or an ineligible head
to its host preemptor, which the port does not have; here such slots
stay pending and are counted. The loop decides nothing itself: every
admission, victim and parking comes from the cycle.
"""

from __future__ import annotations

import random
import zlib
from dataclasses import dataclass

import numpy as np

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    ClusterQueuePreemption,
    Cohort,
    FlavorQuotas,
    PodSet,
    PreemptionPolicy,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_tpu_torch.cache.snapshot import build_snapshot
from kueue_tpu_torch.oracle import engine_bridge as eb
from kueue_tpu_torch.oracle.batched import BatchedDrainSolver
from kueue_tpu_torch.tensor.schema import (
    AdmittedTensors,
    encode_snapshot,
    encode_workloads,
)
from kueue_tpu_torch.workload_info import WorkloadInfo

NOMINAL = 4000
FULL = dict(n_cohorts=200, cqs_per_cohort=5, n_wave=16_800)
SMALL = dict(n_cohorts=4, cqs_per_cohort=5, n_wave=336)
MAX_CYCLES = 500
_BIG_RANK = np.int64(1) << 40


@dataclass
class World:
    cluster_queues: list
    cohorts: list
    flavors: list
    workloads: list  # fill then wave, in submission order
    infos: list  # WorkloadInfo per workload
    n_fill: int
    fill_admitted: np.ndarray  # bool[n_fill] admitted by the fill drain
    fill_clock: float  # the clock after the last fill submission
    wave_clock: float  # the clock after the last wave submission
    world: object  # WorldTensors, with the admitted fill's usage
    wls: object  # WorkloadTensors over fill and wave


def _cluster_queue(i: int, n_cohorts: int) -> ClusterQueue:
    return ClusterQueue(
        name=f"cq-{i}", cohort=f"co-{i % n_cohorts}",
        preemption=ClusterQueuePreemption(
            within_cluster_queue=PreemptionPolicy.LOWER_PRIORITY,
            reclaim_within_cohort=(PreemptionPolicy.LOWER_PRIORITY if i % 2
                                   else PreemptionPolicy.NEVER)),
        resource_groups=(ResourceGroup(
            ("cpu",), (FlavorQuotas("default",
                                    {"cpu": ResourceQuota(NOMINAL)}),)),))


def build(n_cohorts: int, cqs_per_cohort: int, n_wave: int,
          device=None) -> World:
    """The world, with the fill admitted by the port's classical drain on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    n_cqs = n_cohorts * cqs_per_cohort
    rng = random.Random(7)
    cohorts = [Cohort(f"co-{c}") for c in range(n_cohorts)]
    cqs = [_cluster_queue(i, n_cohorts) for i in range(n_cqs)]
    flavors = [ResourceFlavor("default")]
    # LocalQueue lq-{i} points at cq-{i}.
    lq_to_cq = {f"lq-{i}": f"cq-{i}" for i in range(n_cqs)}

    clock = 0.0
    workloads = []
    n_fill = n_cqs * NOMINAL * 8 // (10 * 1000)
    for i in range(n_fill):
        clock += 0.001
        workloads.append(Workload(
            name=f"low-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            priority=0, pod_sets=(PodSet("main", 1, {"cpu": 1000}),),
            creation_time=clock, uid=f"uid-{len(workloads):08d}"))
    fill_clock = clock
    for i in range(n_wave):
        clock += 0.001
        workloads.append(Workload(
            name=f"high-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            priority=rng.choice([10, 50]),
            pod_sets=(PodSet("main", 1,
                             {"cpu": rng.choice([1000, 2000])}),),
            creation_time=clock, uid=f"uid-{len(workloads):08d}"))
    infos = [WorkloadInfo.from_workload(w, lq_to_cq[w.queue_name])
             for w in workloads]

    # Admit the fill with the classical drain.
    solver = BatchedDrainSolver(build_snapshot(cqs, cohorts, flavors, []),
                                infos[:n_fill], device=device)
    decisions, _ = solver.solve()
    fill_admitted = np.zeros(n_fill, bool)
    admitted_infos = []
    row_of = {w.key: i for i, w in enumerate(workloads[:n_fill])}
    for d in decisions:
        row = row_of[d.key]
        fill_admitted[row] = True
        info = WorkloadInfo.from_workload(workloads[row], d.cluster_queue)
        for psr, fl in zip(info.total_requests, d.podset_flavors):
            psr.flavors = dict(fl)
        admitted_infos.append(info)
    world = encode_snapshot(build_snapshot(cqs, cohorts, flavors,
                                           admitted_infos), max_depth=4)
    return World(cluster_queues=cqs, cohorts=cohorts, flavors=flavors,
                 workloads=workloads, infos=infos,
                 n_fill=n_fill, fill_admitted=fill_admitted,
                 fill_clock=fill_clock, wave_clock=clock, world=world,
                 wls=encode_workloads(world, infos))


def _world_args(w) -> dict:
    return dict(
        nominal=w.nominal, lend_limit=w.lend_limit,
        borrow_limit=w.borrow_limit, parent=w.parent,
        ancestors=w.ancestors, height=w.height,
        group_of_res=w.group_of_res, group_flavors=w.group_flavors,
        no_preemption=w.no_preemption, can_pwb=w.can_preempt_while_borrowing,
        can_always_reclaim=w.can_always_reclaim, best_effort=w.best_effort,
        fung_borrow_try_next=w.fung_borrow_try_next,
        fung_pref_preempt_first=w.fung_pref_preempt_first,
        root_members=w.root_members, root_nodes=w.root_nodes,
        local_chain=w.local_chain, fair_weight=w.fair_weight,
        child_rank=w.child_rank, local_depth=w.local_depth,
        root_parent_local=w.root_parent_local)


def _ranks(*keys) -> np.ndarray:
    """Row ranks of a lexicographic order (numpy lexsort keys)."""
    order = np.lexsort(keys)
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return rank


def run(pw: World, cycle_fn, max_cycles: int = MAX_CYCLES) -> dict:
    """Drive ``cycle_fn(tensors, statics) -> 14 numpy outputs`` to
    quiescence (the module docstring has the rules). Returns the counts
    of cycles, admissions, preempting entries, victims and overflow
    slots, and the crc32 of the per-cycle stream of wl_admitted,
    slot_preempting, victim rows with their variants, and
    slot_overflow."""
    w, wl = pw.world, pw.wls
    W, C = wl.num_workloads, w.num_cqs
    R = w.nominal.shape[1]
    S = w.num_resources
    cq = wl.cq.astype(np.int64)
    creation = np.array([x.creation_time for x in pw.workloads], np.float64)
    uid_rank = np.empty(W, np.int64)  # global rank of each row's uid
    uid_rank[np.argsort(np.asarray([x.uid for x in pw.workloads],
                                   dtype=object))] = np.arange(W)
    rank = _ranks(np.arange(W), wl.timestamp, -wl.priority)
    row_args = dict(
        rank=rank, commit_rank=_ranks(np.arange(W), wl.timestamp),
        wl_cq=wl.cq, wl_req=wl.requests, wl_priority=wl.priority,
        wl_has_qr=wl.has_quota_reservation, wl_hash=wl.hash_id,
        wl_ts=wl.timestamp, **_world_args(w))
    pcfg = eb.cq_policy_cfg(w, {q.name: q for q in pw.cluster_queues})
    pc_args = {f"pc_{k}": v for k, v in pcfg.items()}
    statics = dict(depth=w.depth, num_resources=S, num_cqs=C,
                   fair_mode=False, num_flavors=max(w.num_flavors, 1))

    admitted = np.zeros(W, bool)
    admitted[:pw.n_fill] = pw.fill_admitted
    qr_time = np.where(admitted, pw.fill_clock, 0.0)
    adm_usage = np.zeros((W, R), np.int64)
    for s in range(S):  # the fill's one flavor
        adm_usage[admitted, s] = wl.requests[admitted, 0, s]
    pending = wl.eligible & (wl.cq >= 0) & ~admitted
    inadmissible = np.zeros(W, bool)
    usage = np.broadcast_to(w.usage, (w.num_nodes, R)).copy()
    cq_root = w.root_of_cq[np.maximum(wl.cq, 0)]

    crc = 0
    counts = dict(cycles=0, admitted=0, preempting=0, victims=0, overflow=0)
    for _ in range(max_cycles):
        # Heads on the host, for the precheck (the device picks its own).
        active = pending & ~inadmissible
        eff = np.where(active, rank, _BIG_RANK)
        head_rank = np.full(C, _BIG_RANK, np.int64)
        np.minimum.at(head_rank, np.maximum(cq, 0), eff)
        is_head = active & (eff == head_rank[np.maximum(cq, 0)])
        head_pri = np.zeros(C, np.int64)
        head_pri[cq[is_head]] = wl.priority[is_head]

        rows = np.nonzero(admitted)[0]
        adm = AdmittedTensors(
            num_admitted=len(rows), keys=[wl.keys[r] for r in rows],
            cq=wl.cq[rows], priority=wl.priority[rows],
            timestamp=creation[rows], qr_time=qr_time[rows],
            uid_rank=_ranks(uid_rank[rows]),
            evicted=np.zeros(len(rows), bool), usage=adm_usage[rows])
        ap = eb.adm_padded(adm, w)
        tensors = dict(
            pending=pending, inadmissible=inadmissible, usage=usage,
            **row_args, **pc_args, root_of_cq=w.root_of_cq,
            adm_cq=ap["adm_cq"], adm_pri=ap["adm_pri"], adm_ts=ap["adm_ts"],
            adm_qrt=ap["adm_qrt"], adm_uid=ap["adm_uid"],
            adm_evicted=ap["adm_ev"], adm_usage=ap["adm_usage"],
            adm_rank=ap["adm_rank"], adm_by_root=ap["adm_by_root"],
            slot_maybe=eb.slot_maybe(w, pcfg, adm, head_pri))
        out = cycle_fn(tensors, statics)
        wl_admitted = np.asarray(out[3], bool)
        flavor_of_res = out[6]
        slot_preempting = np.asarray(out[9], bool)
        slot_overflow = np.asarray(out[11], bool)

        # Admissions reserve at the cycle's clock with their flavors.
        new = np.nonzero(wl_admitted)[0]
        admitted[new] = True
        qr_time[new] = pw.wave_clock
        adm_usage[new] = 0
        for p in range(wl.requests.shape[1]):
            for s in range(S):
                fl = flavor_of_res[cq[new], p, s]
                ok = (fl >= 0) & (wl.requests[new, p, s] > 0)
                np.add.at(adm_usage, (new[ok], fl[ok] * S + s),
                          wl.requests[new[ok], p, s])
        pending = np.array(out[0], bool)
        inadmissible = np.array(out[1], bool)
        usage = np.array(out[2])

        # Victims of the preempting slots, slot by slot.
        victim_rows, variants = [], []
        for slot in np.nonzero(slot_preempting)[0]:
            ids = np.nonzero(out[12][slot])[0]
            victim_rows.append(rows[ids])
            variants.append(out[13][slot, ids])
        victim_rows = (np.concatenate(victim_rows) if victim_rows
                       else np.zeros(0, np.int64))
        variants = (np.concatenate(variants) if variants
                    else np.zeros(0, np.int32))
        if len(victim_rows):
            np.subtract.at(usage, cq[victim_rows], adm_usage[victim_rows])
            admitted[victim_rows] = False
            adm_usage[victim_rows] = 0
            pending[victim_rows] = True
            inadmissible[victim_rows] = False
            inadmissible &= ~np.isin(cq_root, cq_root[victim_rows])

        crc = zlib.crc32(wl_admitted.tobytes(), crc)
        crc = zlib.crc32(slot_preempting.tobytes(), crc)
        crc = zlib.crc32(victim_rows.astype(np.int32).tobytes(), crc)
        crc = zlib.crc32(variants.astype(np.int32).tobytes(), crc)
        crc = zlib.crc32(slot_overflow.tobytes(), crc)
        counts["cycles"] += 1
        counts["admitted"] += len(new)
        counts["preempting"] += int(slot_preempting.sum())
        counts["victims"] += len(victim_rows)
        counts["overflow"] += int(slot_overflow.sum())
        if not len(new) and not slot_preempting.any():
            break
    counts["checksum"] = crc
    return counts
