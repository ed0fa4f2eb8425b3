"""The numpy argument helpers of the fused-preemption cycle, trimmed
from ``kueue_tpu/oracle/engine_bridge.py`` (the bridge's
``_cq_policy_cfg``, ``_adm_padded`` and ``_slot_maybe``) to plain
functions of the encoded world, the admitted set and the ClusterQueue
specs. The rest of the bridge (the engine hooks, overrides and the sim
nomination) is not ported.
"""

from __future__ import annotations

import numpy as np

from kueue_tpu_torch.api.types import BorrowWithinCohortPolicy, \
    PreemptionPolicy
from kueue_tpu_torch.ops import preempt as pops
from kueue_tpu_torch.tensor.schema import pad_axis0, pow2_bucket

_POLICY_CODE = {
    PreemptionPolicy.NEVER: pops.POLICY_NEVER,
    PreemptionPolicy.LOWER_PRIORITY: pops.POLICY_LOWER,
    PreemptionPolicy.LOWER_OR_NEWER_EQUAL_PRIORITY:
        pops.POLICY_LOWER_OR_NEWER_EQ,
    PreemptionPolicy.ANY: pops.POLICY_ANY,
}


def cq_policy_cfg(world, cluster_queues) -> dict:
    """Per-CQ preemption policy codes for the classical preemptor.
    ``cluster_queues`` maps a ClusterQueue name to its spec. Returns
    wcq_policy, reclaim_policy int32[C], bwc_forbidden bool[C],
    bwc_threshold int64[C] (NO_THRESHOLD = none) and cq_has_parent
    bool[C]."""
    C = world.num_cqs
    wcq_policy = np.zeros(C, np.int32)
    reclaim_policy = np.zeros(C, np.int32)
    bwc_forbidden = np.ones(C, bool)
    bwc_threshold = np.full(C, pops.NO_THRESHOLD, np.int64)
    cq_has_parent = np.zeros(C, bool)
    for ci, name in enumerate(world.cq_names):
        spec = cluster_queues[name]
        p = spec.preemption
        wcq_policy[ci] = _POLICY_CODE[p.within_cluster_queue]
        reclaim_policy[ci] = _POLICY_CODE[p.reclaim_within_cohort]
        if (p.borrow_within_cohort is not None
                and p.borrow_within_cohort.policy
                != BorrowWithinCohortPolicy.NEVER):
            bwc_forbidden[ci] = False
            thr = p.borrow_within_cohort.max_priority_threshold
            if thr is not None:
                bwc_threshold[ci] = thr
        cq_has_parent[ci] = spec.cohort is not None
    return dict(wcq_policy=wcq_policy, reclaim_policy=reclaim_policy,
                bwc_forbidden=bwc_forbidden, bwc_threshold=bwc_threshold,
                cq_has_parent=cq_has_parent)


def adm_padded(adm, world) -> dict:
    """The admitted axis padded to a power of two (padded rows have cq
    -1 and zero usage, so they are never candidates), the admitted ids
    grouped by cohort root (``adm_by_root`` int32[Rn, A_l], -1 pad; A_l
    the power-of-two bucket of the largest root's count) and the
    composite candidate-ordering rank (priority asc, reservation recency
    desc, uid asc). Keys: adm_cq, adm_pri, adm_ts, adm_qrt, adm_uid,
    adm_ev, adm_rank, adm_by_root, adm_usage."""
    A = adm.num_admitted
    Ap = pow2_bucket(A, 8)
    Rn = world.root_members.shape[0]
    root_of = np.where(adm.cq >= 0, world.root_of_cq[np.maximum(
        adm.cq, 0)], Rn) if A else np.zeros(0, np.int64)
    counts = np.bincount(root_of, minlength=Rn + 1)[:Rn]
    A_l = pow2_bucket(int(counts.max()) if counts.size else 1, 8)
    adm_by_root = np.full((max(Rn, 1), A_l), -1, np.int32)
    if A:
        order = np.argsort(root_of, kind="stable")
        sr = root_of[order]
        pos = np.arange(A) - np.searchsorted(sr, sr)
        valid = sr < Rn
        adm_by_root[sr[valid], pos[valid]] = order[valid]
    rank = np.empty(A, np.int64)
    rank[np.lexsort((adm.uid_rank, -adm.qr_time, adm.priority))] = \
        np.arange(A)
    tail = np.arange(A, Ap, dtype=np.int64)
    return dict(
        adm_cq=pad_axis0(adm.cq, Ap, -1),
        adm_pri=pad_axis0(adm.priority, Ap, 0),
        adm_ts=pad_axis0(adm.timestamp, Ap, 0.0),
        adm_qrt=pad_axis0(adm.qr_time, Ap, 0.0),
        adm_uid=(np.concatenate([adm.uid_rank, tail])
                 if Ap != A else adm.uid_rank),
        adm_ev=pad_axis0(adm.evicted, Ap, False),
        adm_rank=np.concatenate([rank, tail]) if Ap != A else rank,
        adm_by_root=adm_by_root,
        adm_usage=pad_axis0(adm.usage, Ap, 0))


def slot_maybe(world, pcfg, adm, head_pri) -> np.ndarray:
    """bool[C]: this slot's head could have preemption candidates, a
    conservative precheck against the admitted set (False only when no
    admitted workload can be a candidate). Cross-CQ reclaim is never
    prechecked; within-CQ policies are checked against each CQ's lowest
    admitted priority. ``head_pri`` int64[C] is each CQ head's priority
    (0 where there is none)."""
    C = world.num_cqs
    maybe = ((pcfg["reclaim_policy"] != pops.POLICY_NEVER)
             & pcfg["cq_has_parent"])
    wcq = pcfg["wcq_policy"]
    A = adm.num_admitted
    if A:
        valid = adm.cq >= 0
        cq_safe = np.where(valid, adm.cq, 0)
        big = np.iinfo(np.int64).max
        minpri = np.full(C, big, np.int64)
        np.minimum.at(minpri, cq_safe, np.where(valid, adm.priority, big))
        count = np.bincount(cq_safe, weights=valid, minlength=C)
        within = np.where(
            wcq == pops.POLICY_ANY, count > 0,
            np.where(wcq == pops.POLICY_LOWER, minpri < head_pri,
                     np.where(wcq == pops.POLICY_LOWER_OR_NEWER_EQ,
                              minpri <= head_pri, False)))
        maybe = maybe | within
    return maybe
