"""Preemption target selection: classical (hierarchical) and fair-sharing.

Sequential correctness-oracle implementation of the reference's
pkg/scheduler/preemption/{preemption.go,classical/*,common/*,fairsharing/*}.

Semantics captured:
  * candidate classification Never/WithinCQ/HierarchicalReclaim/
    ReclaimWithoutBorrowing/ReclaimWhileBorrowing
    (classical/hierarchical_preemption.go:31-123).
  * hierarchical candidate collection walking parent-to-root with
    QuantitiesFitInQuota remainders (hierarchical_preemption.go:149-206).
  * candidate ordering: evicted first, other-CQ first, lower priority
    first, newer quota-reservation first, UID tiebreak
    (common/ordering.go:42-84).
  * greedy remove-until-fits + reverse fill-back
    (preemption.go:277-347).
  * attempt option sequencing for borrowWithinCohort
    (preemption.go:287-311).
  * fair-sharing preemption: DRS-ordered CQ tournament with strategies
    LessThanOrEqualToFinalShare / LessThanInitialShare
    (preemption.go:377-544, fairsharing/*).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from kueue_tpu_torch.api.types import (
    BorrowWithinCohortPolicy,
    FlavorResource,
    PreemptionPolicy,
    Workload,
)
from kueue_tpu_torch.cache.snapshot import (
    ClusterQueueSnapshot,
    CohortSnapshot,
    DRS,
    Snapshot,
    compare_drs,
    find_height_of_lowest_subtree_that_fits,
)
from kueue_tpu_torch.scheduler.flavorassigner import (
    Assignment,
    PMode,
    flavor_resources_need_preemption,
)
from kueue_tpu_torch.workload_info import WorkloadInfo

# Preemption reasons (reference: kueue API constants).
IN_CLUSTER_QUEUE = "InClusterQueue"
IN_COHORT_RECLAMATION = "InCohortReclamation"
IN_COHORT_RECLAIM_WHILE_BORROWING = "InCohortReclaimWhileBorrowing"
IN_COHORT_FAIR_SHARING = "InCohortFairSharing"

# Preemption variants (classical/hierarchical_preemption.go:31).
NEVER = 0
WITHIN_CQ = 1
HIERARCHICAL_RECLAIM = 2
RECLAIM_WITHOUT_BORROWING = 3
RECLAIM_WHILE_BORROWING = 4

_VARIANT_REASON = {
    WITHIN_CQ: IN_CLUSTER_QUEUE,
    HIERARCHICAL_RECLAIM: IN_COHORT_RECLAMATION,
    RECLAIM_WITHOUT_BORROWING: IN_COHORT_RECLAMATION,
    RECLAIM_WHILE_BORROWING: IN_COHORT_RECLAIM_WHILE_BORROWING,
}


@dataclass
class Target:
    """preemption.go:113."""

    workload: WorkloadInfo
    reason: str


def satisfies_preemption_policy(preemptor: Workload, candidate: Workload,
                                policy: PreemptionPolicy) -> bool:
    """common/preemption_policy.go:32 (SatisfiesPreemptionPolicy).

    Queue-order timestamp is creation time (no eviction-requeue ordering in
    the sequential core yet)."""
    lower = preemptor.effective_priority > candidate.effective_priority
    if policy == PreemptionPolicy.LOWER_PRIORITY:
        return lower
    if policy == PreemptionPolicy.LOWER_OR_NEWER_EQUAL_PRIORITY:
        newer_equal = (preemptor.effective_priority
                       == candidate.effective_priority
                       and preemptor.creation_time < candidate.creation_time)
        return lower or newer_equal
    return policy == PreemptionPolicy.ANY


def candidates_ordering_key(info: WorkloadInfo, preemptor_cq: str,
                            now: float):
    """common/ordering.go:42 (CandidatesOrdering) as a sort key."""
    wl = info.obj
    return (
        0 if wl.is_evicted else 1,
        0 if info.cluster_queue != preemptor_cq else 1,
        wl.effective_priority,
        -wl.quota_reservation_time(now),
        wl.uid,
    )


@dataclass
class _CandidateElem:
    wl: WorkloadInfo
    lca: Optional[CohortSnapshot]
    variant: int


def is_borrowing_within_cohort_forbidden(
        cq: ClusterQueueSnapshot) -> tuple[bool, Optional[int]]:
    """hierarchical_preemption.go:71."""
    bwc = cq.preemption.borrow_within_cohort
    if bwc is None or bwc.policy == BorrowWithinCohortPolicy.NEVER:
        return True, None
    return False, bwc.max_priority_threshold


class _HierarchicalCtx:
    def __init__(self, preemptor: WorkloadInfo, cq: ClusterQueueSnapshot,
                 frs_need_preemption: set[FlavorResource],
                 requests: dict[FlavorResource, int], now: float):
        self.preemptor = preemptor
        self.cq = cq
        self.frs = frs_need_preemption
        self.requests = requests
        self.now = now


def _classify_variant(ctx: _HierarchicalCtx, wl: WorkloadInfo,
                      hierarchical_advantage: bool) -> int:
    """hierarchical_preemption.go:81 (classifyPreemptionVariant)."""
    if not wl.uses_any(ctx.frs):
        return NEVER
    if wl.cluster_queue == ctx.cq.name:
        policy = ctx.cq.preemption.within_cluster_queue
    else:
        policy = ctx.cq.preemption.reclaim_within_cohort
    if not satisfies_preemption_policy(ctx.preemptor.obj, wl.obj, policy):
        return NEVER
    if wl.cluster_queue == ctx.cq.name:
        return WITHIN_CQ
    if hierarchical_advantage:
        return HIERARCHICAL_RECLAIM
    forbidden, threshold = is_borrowing_within_cohort_forbidden(ctx.cq)
    if forbidden:
        return RECLAIM_WITHOUT_BORROWING
    cand_pri = wl.obj.effective_priority
    inc_pri = ctx.preemptor.obj.effective_priority
    if cand_pri >= inc_pri or (threshold is not None and cand_pri > threshold):
        return RECLAIM_WITHOUT_BORROWING
    return RECLAIM_WHILE_BORROWING


def _candidates_from_cq(cq: ClusterQueueSnapshot,
                        lca: Optional[CohortSnapshot],
                        ctx: _HierarchicalCtx,
                        hierarchical_advantage: bool) -> list[_CandidateElem]:
    out = []
    for wl in cq.workloads.values():
        variant = _classify_variant(ctx, wl, hierarchical_advantage)
        if variant != NEVER:
            out.append(_CandidateElem(wl, lca, variant))
    return out


def _collect_same_queue_candidates(ctx: _HierarchicalCtx) -> list[_CandidateElem]:
    if ctx.cq.preemption.within_cluster_queue == PreemptionPolicy.NEVER:
        return []
    return _candidates_from_cq(ctx.cq, None, ctx, False)


def _collect_hierarchical_candidates(
        ctx: _HierarchicalCtx
) -> tuple[list[_CandidateElem], list[_CandidateElem]]:
    """hierarchical_preemption.go:149 (collectCandidatesForHierarchicalReclaim)."""
    hierarchy_cands: list[_CandidateElem] = []
    priority_cands: list[_CandidateElem] = []
    if (not ctx.cq.has_parent()
            or ctx.cq.preemption.reclaim_within_cohort
            == PreemptionPolicy.NEVER):
        return hierarchy_cands, priority_cands
    prev_root: Optional[CohortSnapshot] = None
    has_advantage, remaining = ctx.cq.quantities_fit_in_quota(ctx.requests)
    for subtree_root in ctx.cq.path_parent_to_root():
        bucket = hierarchy_cands if has_advantage else priority_cands
        _collect_in_subtree(ctx, subtree_root, subtree_root, prev_root,
                            has_advantage, bucket)
        fits, remaining = subtree_root.quantities_fit_in_quota(remaining)
        has_advantage = has_advantage or fits
        prev_root = subtree_root
    return hierarchy_cands, priority_cands


def _collect_in_subtree(ctx: _HierarchicalCtx, current: CohortSnapshot,
                        subtree_root: CohortSnapshot,
                        skip: Optional[CohortSnapshot],
                        has_advantage: bool,
                        result: list[_CandidateElem]) -> None:
    """hierarchical_preemption.go:179 (collectCandidatesInSubtree)."""
    for child in current.child_cohorts:
        if child is skip:
            continue
        if child.is_within_nominal_in(ctx.frs):
            continue
        _collect_in_subtree(ctx, child, subtree_root, skip, has_advantage,
                            result)
    for child_cq in current.child_cqs:
        if child_cq is ctx.cq:
            continue
        if not child_cq.is_within_nominal_in(ctx.frs):
            result.extend(_candidates_from_cq(child_cq, subtree_root, ctx,
                                              has_advantage))


class CandidateIterator:
    """classical/candidate_generator.go:35 (candidateIterator)."""

    def __init__(self, ctx: _HierarchicalCtx, snapshot: Snapshot):
        self.ctx = ctx
        self.snapshot = snapshot
        same_queue = _collect_same_queue_candidates(ctx)
        hierarchy, prio = _collect_hierarchical_candidates(ctx)
        key = lambda c: candidates_ordering_key(  # noqa: E731
            c.wl, ctx.cq.name, ctx.now)
        same_queue.sort(key=key)
        prio.sort(key=key)
        hierarchy.sort(key=key)

        def split_evicted(cands):
            ev = [c for c in cands if c.wl.obj.is_evicted]
            nev = [c for c in cands if not c.wl.obj.is_evicted]
            return ev, nev

        ev_h, nev_h = split_evicted(hierarchy)
        ev_p, nev_p = split_evicted(prio)
        ev_s, nev_s = split_evicted(same_queue)
        self.candidates = ev_h + ev_p + ev_s + nev_h + nev_p + nev_s
        self.no_candidate_from_other_queues = not hierarchy and not prio
        self.no_candidate_for_hierarchical_reclaim = not hierarchy
        self.run_index = 0

    def reset(self) -> None:
        self.run_index = 0

    def next(self, borrow: bool) -> tuple[Optional[WorkloadInfo], str]:
        while self.run_index < len(self.candidates):
            cand = self.candidates[self.run_index]
            self.run_index += 1
            if self._valid(cand, borrow):
                return cand.wl, _VARIANT_REASON[cand.variant]
        return None, ""

    def _valid(self, cand: _CandidateElem, borrow: bool) -> bool:
        """candidate_generator.go:136 (candidateIsValid)."""
        if self.ctx.cq.name == cand.wl.cluster_queue:
            return True
        if borrow and cand.variant == RECLAIM_WITHOUT_BORROWING:
            return False
        cq = self.snapshot.cluster_queue(cand.wl.cluster_queue)
        if cq.is_within_nominal_in(self.ctx.frs):
            return False
        for node in cq.path_parent_to_root():
            if node is cand.lca:
                break
            if node.is_within_nominal_in(self.ctx.frs):
                return False
        return True


@dataclass
class PreemptionCtx:
    preemptor: WorkloadInfo
    preemptor_cq: ClusterQueueSnapshot
    snapshot: Snapshot
    workload_usage: dict[FlavorResource, int]
    frs_need_preemption: set[FlavorResource]
    now: float = 0.0


class Preemptor:
    """preemption.go:60 (Preemptor) — the decision part only: GetTargets and
    the oracle. Eviction issuance lives in the scheduler/controller layer."""

    def __init__(self, enable_fair_sharing: bool = False):
        self.enable_fair_sharing = enable_fair_sharing
        # Rationale capture (obs.hooks): candidate keys examined during
        # an explicit get_targets call. None = not collecting — the
        # flavorassigner's oracle simulations go through _get_targets
        # directly and stay silent, so the emitted event reflects the
        # REAL target search, not per-flavor what-ifs.
        self._considered: Optional[list[str]] = None

    def get_targets(self, wl: WorkloadInfo, assignment: Assignment,
                    snapshot: Snapshot, now: float = 0.0) -> list[Target]:
        """preemption.go:129 (GetTargets)."""
        from kueue_tpu_torch.obs import hooks as _obs

        cq = snapshot.cluster_queue(wl.cluster_queue)
        tracing = _obs.CURRENT is not None
        if tracing:
            self._considered = []
        try:
            targets = self._get_targets(PreemptionCtx(
                preemptor=wl,
                preemptor_cq=cq,
                snapshot=snapshot,
                workload_usage=assignment.total_requests_for(wl),
                frs_need_preemption=flavor_resources_need_preemption(
                    assignment),
                now=now,
            ))
        finally:
            considered, self._considered = self._considered, None
        if tracing:
            _obs.emit(
                "preemption", wl.key,
                strategy=("fair" if self.enable_fair_sharing
                          else "classical"),
                considered=sorted(set(considered or ())),
                chosen=sorted([t.workload.key, t.reason]
                              for t in targets))
        return targets

    def _get_targets(self, ctx: PreemptionCtx) -> list[Target]:
        if self.enable_fair_sharing:
            return self._fair_preemptions(ctx)
        return self._classical_preemptions(ctx)

    # -- classical --

    def _classical_preemptions(self, ctx: PreemptionCtx) -> list[Target]:
        """preemption.go:277 (classicalPreemptions)."""
        hctx = _HierarchicalCtx(ctx.preemptor, ctx.preemptor_cq,
                                ctx.frs_need_preemption, ctx.workload_usage,
                                ctx.now)
        gen = CandidateIterator(hctx, ctx.snapshot)
        forbidden, _ = is_borrowing_within_cohort_forbidden(ctx.preemptor_cq)
        if gen.no_candidate_from_other_queues or (
                forbidden and not _queue_under_nominal(ctx)):
            attempts = [True]
        elif forbidden and gen.no_candidate_for_hierarchical_reclaim:
            attempts = [False, True]
        else:
            attempts = [True, False]

        for allow_borrowing in attempts:
            targets: list[Target] = []
            gen.reset()
            while True:
                cand, reason = gen.next(allow_borrowing)
                if cand is None:
                    break
                if self._considered is not None:
                    self._considered.append(cand.key)
                ctx.snapshot.remove_workload(cand)
                targets.append(Target(cand, reason))
                if _workload_fits(ctx, allow_borrowing):
                    targets = _fill_back(ctx, targets, allow_borrowing)
                    _restore(ctx.snapshot, targets)
                    return targets
            _restore(ctx.snapshot, targets)
        return []

    # -- fair sharing --

    def _fair_preemptions(self, ctx: PreemptionCtx) -> list[Target]:
        """preemption.go:491 (fairPreemptions)."""
        candidates = self._find_candidates(ctx)
        if self._considered is not None:
            self._considered.extend(w.key for w in candidates)
        if not candidates:
            return []
        candidates.sort(key=lambda c: candidates_ordering_key(
            c, ctx.preemptor_cq.name, ctx.now))

        revert = ctx.preemptor_cq.simulate_usage_addition(ctx.workload_usage)
        fits, targets, retry = self._run_first_fs_strategy(ctx, candidates)
        if not fits:
            fits, targets = self._run_second_fs_strategy(ctx, retry, targets)
        revert()
        if not fits:
            _restore(ctx.snapshot, targets)
            return []
        targets = _fill_back(ctx, targets, True)
        _restore(ctx.snapshot, targets)
        return targets

    def _find_candidates(self, ctx: PreemptionCtx) -> list[WorkloadInfo]:
        """preemption.go:588 (findCandidates)."""
        cq = ctx.preemptor_cq
        out: list[WorkloadInfo] = []
        if cq.preemption.within_cluster_queue != PreemptionPolicy.NEVER:
            out.extend(self._filter_policy(
                ctx, cq.workloads, cq.preemption.within_cluster_queue))
        if (cq.has_parent() and cq.preemption.reclaim_within_cohort
                != PreemptionPolicy.NEVER):
            root = cq.parent.root()
            assert isinstance(root, CohortSnapshot)
            for cohort_cq in root.subtree_cluster_queues():
                if cohort_cq is cq or not _cq_is_borrowing(
                        cohort_cq, ctx.frs_need_preemption):
                    continue
                out.extend(self._filter_policy(
                    ctx, cohort_cq.workloads,
                    cq.preemption.reclaim_within_cohort))
        return out

    def _filter_policy(self, ctx: PreemptionCtx, workloads,
                       policy: PreemptionPolicy) -> list[WorkloadInfo]:
        return [
            w for w in workloads.values()
            if satisfies_preemption_policy(ctx.preemptor.obj, w.obj, policy)
            and w.uses_any(ctx.frs_need_preemption)]

    def _run_first_fs_strategy(self, ctx: PreemptionCtx,
                               candidates: list[WorkloadInfo]):
        """preemption.go:377 (runFirstFsStrategy), with the default
        strategies: LessThanOrEqualToFinalShare first (rule S2-a), then
        LessThanInitialShare (_run_second_fs_strategy)."""
        ordering = _TargetCQOrdering(ctx.preemptor_cq, candidates, ctx.now)
        targets: list[Target] = []
        retry: list[WorkloadInfo] = []
        for cand_cq in ordering.iterate():
            if cand_cq.target_cq is ctx.preemptor_cq:
                wl = cand_cq.pop()
                ctx.snapshot.remove_workload(wl)
                targets.append(Target(wl, IN_CLUSTER_QUEUE))
                if _workload_fits_fs(ctx):
                    return True, targets, []
                continue
            preemptor_new, _ = cand_cq.compute_shares(ordering)
            while cand_cq.has_workload():
                wl = cand_cq.pop()
                target_new = cand_cq.share_after_removal(ordering, wl)
                if compare_drs(preemptor_new, target_new) <= 0:
                    ctx.snapshot.remove_workload(wl)
                    targets.append(Target(wl, IN_COHORT_FAIR_SHARING))
                    if _workload_fits_fs(ctx):
                        return True, targets, []
                    break  # re-pick CQ: shares changed
                retry.append(wl)
        return False, targets, retry

    def _run_second_fs_strategy(self, ctx: PreemptionCtx,
                                retry: list[WorkloadInfo],
                                targets: list[Target]):
        """preemption.go:456 (runSecondFsStrategy) — rule S2-b."""
        ordering = _TargetCQOrdering(ctx.preemptor_cq, retry, ctx.now)
        for cand_cq in ordering.iterate():
            preemptor_new, target_old = cand_cq.compute_shares(ordering)
            wl = cand_cq.pop()
            if compare_drs(preemptor_new, target_old) < 0:
                ctx.snapshot.remove_workload(wl)
                targets.append(Target(wl, IN_COHORT_FAIR_SHARING))
                if _workload_fits_fs(ctx):
                    return True, targets
            ordering.drop_queue(cand_cq)
        return False, targets


class _TargetCQ:
    """fairsharing/target.go (TargetClusterQueue)."""

    def __init__(self, ordering: "_TargetCQOrdering",
                 target_cq: ClusterQueueSnapshot):
        self.ordering = ordering
        self.target_cq = target_cq

    def has_workload(self) -> bool:
        return bool(self.ordering.cq_to_targets.get(self.target_cq.name))

    def pop(self) -> WorkloadInfo:
        lst = self.ordering.cq_to_targets[self.target_cq.name]
        head = lst.pop(0)
        return head

    def compute_shares(self, ordering) -> tuple[DRS, DRS]:
        p_alca, t_alca = _get_almost_lcas(ordering.preemptor_cq,
                                          self.target_cq)
        return (p_alca.dominant_resource_share(),
                t_alca.dominant_resource_share())

    def share_after_removal(self, ordering, wl: WorkloadInfo) -> DRS:
        revert = self.target_cq.simulate_usage_removal(wl.usage())
        try:
            _, t_alca = _get_almost_lcas(ordering.preemptor_cq,
                                         self.target_cq)
            return t_alca.dominant_resource_share()
        finally:
            revert()


class _TargetCQOrdering:
    """fairsharing/ordering.go (TargetClusterQueueOrdering)."""

    def __init__(self, preemptor_cq: ClusterQueueSnapshot,
                 candidates: list[WorkloadInfo], now: float):
        self.preemptor_cq = preemptor_cq
        self.now = now
        self.preemptor_ancestors = set(
            id(a) for a in preemptor_cq.path_parent_to_root())
        self.cq_to_targets: dict[str, list[WorkloadInfo]] = {}
        for c in candidates:
            self.cq_to_targets.setdefault(c.cluster_queue, []).append(c)
        self.pruned_cqs: set[int] = set()
        self.pruned_cohorts: set[int] = set()

    def drop_queue(self, cq: _TargetCQ) -> None:
        self.pruned_cqs.add(id(cq.target_cq))

    def iterate(self) -> Iterator[_TargetCQ]:
        if not self.preemptor_cq.has_parent():
            t = _TargetCQ(self, self.preemptor_cq)
            while t.has_workload():
                yield t
            return
        root = self.preemptor_cq.parent.root()
        while id(root) not in self.pruned_cohorts:
            t = self._next_target(root)
            if t is None:
                continue
            yield t

    def _has_workload(self, cq: ClusterQueueSnapshot) -> bool:
        return bool(self.cq_to_targets.get(cq.name))

    def _next_target(self, cohort: CohortSnapshot) -> Optional[_TargetCQ]:
        """fairsharing/ordering.go:142 (nextTarget)."""
        highest_cq: Optional[ClusterQueueSnapshot] = None
        highest_cq_drs = DRS.negative()
        for cq in cohort.child_cqs:
            if id(cq) in self.pruned_cqs:
                continue
            drs = cq.dominant_resource_share()
            if ((not drs.is_borrowing() and cq is not self.preemptor_cq)
                    or not self._has_workload(cq)):
                self.pruned_cqs.add(id(cq))
            elif compare_drs(drs, highest_cq_drs) == 0:
                new_wl = self.cq_to_targets[cq.name][0]
                cur_wl = self.cq_to_targets[highest_cq.name][0]
                if (candidates_ordering_key(new_wl, self.preemptor_cq.name,
                                            self.now)
                        < candidates_ordering_key(
                            cur_wl, self.preemptor_cq.name, self.now)):
                    highest_cq = cq
            elif compare_drs(drs, highest_cq_drs) > 0:
                highest_cq_drs = drs
                highest_cq = cq

        highest_cohort: Optional[CohortSnapshot] = None
        highest_cohort_drs = DRS.negative()
        for child in cohort.child_cohorts:
            if id(child) in self.pruned_cohorts:
                continue
            drs = child.dominant_resource_share()
            if (not drs.is_borrowing()
                    and id(child) not in self.preemptor_ancestors):
                self.pruned_cohorts.add(id(child))
            elif compare_drs(drs, highest_cohort_drs) >= 0:
                highest_cohort_drs = drs
                highest_cohort = child

        if highest_cohort is None and highest_cq is None:
            self.pruned_cohorts.add(id(cohort))
            return None
        if compare_drs(highest_cohort_drs, highest_cq_drs) >= 0:
            return self._next_target(highest_cohort)
        return _TargetCQ(self, highest_cq)


def _get_almost_lcas(preemptor_cq: ClusterQueueSnapshot,
                     target_cq: ClusterQueueSnapshot):
    """fairsharing/least_common_ancestor.go:27 (getAlmostLCAs)."""
    preemptor_ancestors = set(id(a)
                              for a in preemptor_cq.path_parent_to_root())
    lca = None
    for ancestor in target_cq.path_parent_to_root():
        if id(ancestor) in preemptor_ancestors:
            lca = ancestor
            break
    assert lca is not None, "no common ancestor"

    def almost(cq):
        node = cq
        for ancestor in cq.path_parent_to_root():
            if ancestor is lca:
                return node
            node = ancestor
        raise AssertionError("LCA not on path")

    return almost(preemptor_cq), almost(target_cq)


def _cq_is_borrowing(cq: ClusterQueueSnapshot,
                     frs: set[FlavorResource]) -> bool:
    """preemption.go:609."""
    if not cq.has_parent():
        return False
    return any(cq.borrowing(fr) for fr in frs)


def _workload_fits(ctx: PreemptionCtx, allow_borrowing: bool) -> bool:
    """preemption.go:624 (workloadFits) — quota part (TAS handled in the
    TAS layer)."""
    for fr, v in ctx.workload_usage.items():
        if not allow_borrowing and ctx.preemptor_cq.borrowing_with(fr, v):
            return False
        if v > ctx.preemptor_cq.available(fr):
            return False
    return True


def _workload_fits_fs(ctx: PreemptionCtx) -> bool:
    """preemption.go:644 — usage of the incoming workload is simulated-in
    during fair sharing; remove it for the fit check."""
    revert = ctx.preemptor_cq.simulate_usage_removal(ctx.workload_usage)
    try:
        return _workload_fits(ctx, True)
    finally:
        revert()


def _fill_back(ctx: PreemptionCtx, targets: list[Target],
               allow_borrowing: bool) -> list[Target]:
    """preemption.go:334 (fillBackWorkloads)."""
    i = len(targets) - 2
    while i >= 0:
        ctx.snapshot.add_workload(targets[i].workload)
        if _workload_fits(ctx, allow_borrowing):
            targets[i] = targets[-1]
            targets.pop()
        else:
            ctx.snapshot.remove_workload(targets[i].workload)
        i -= 1
    return targets


def _restore(snapshot: Snapshot, targets: list[Target]) -> None:
    for t in targets:
        snapshot.add_workload(t.workload)


def _queue_under_nominal(ctx: PreemptionCtx) -> bool:
    """preemption.go:654 (queueUnderNominalInResourcesNeedingPreemption)."""
    for fr in sorted(ctx.frs_need_preemption):
        if (ctx.preemptor_cq.quota_for(fr).nominal
                <= ctx.preemptor_cq.node.usage.get(fr, 0)):
            return False
    return True


def can_always_reclaim(cq: ClusterQueueSnapshot) -> bool:
    """preemption/policy.go (CanAlwaysReclaim): reclaimWithinCohort=Any means
    nominal quota can always be reclaimed."""
    return cq.preemption.reclaim_within_cohort == PreemptionPolicy.ANY


class Oracle:
    """preemption_oracle.go:34 (PreemptionOracle)."""

    def __init__(self, preemptor: Preemptor, snapshot: Snapshot,
                 now: float = 0.0):
        self.preemptor = preemptor
        self.snapshot = snapshot
        self.now = now

    def simulate_preemption(self, cq: ClusterQueueSnapshot, wl: WorkloadInfo,
                            fr: FlavorResource,
                            quantity: int) -> tuple[PMode, int]:
        """preemption_oracle.go:41 (SimulatePreemption)."""
        targets = self.preemptor._get_targets(PreemptionCtx(
            preemptor=wl,
            preemptor_cq=self.snapshot.cluster_queue(wl.cluster_queue),
            snapshot=self.snapshot,
            frs_need_preemption={fr},
            workload_usage={fr: quantity},
            now=self.now,
        ))
        if not targets:
            borrow, _ = find_height_of_lowest_subtree_that_fits(
                cq, fr, quantity)
            return PMode.NO_CANDIDATES, borrow
        infos = [t.workload for t in targets]
        revert = self.snapshot.simulate_workload_removal(infos)
        borrow_after, _ = find_height_of_lowest_subtree_that_fits(
            cq, fr, quantity)
        revert()
        if any(t.workload.cluster_queue == cq.name for t in targets):
            return PMode.PREEMPT, borrow_after
        return PMode.RECLAIM, borrow_after
