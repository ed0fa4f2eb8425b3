"""One scheduling cycle: nominate → order → commit.

Copied from ``kueue_tpu/scheduler/cycle.py``, with its TAS passes: the
batched feasibility pre-pass at nomination, the topology placement of
each assignment (``tas/assigner.apply_tas_pass``) and the TAS domain
capacity in the commit's fits check.

Sequential correctness-oracle implementation of the reference's
pkg/scheduler/scheduler.go:286 (schedule) and
pkg/scheduler/fair_sharing_iterator.go. The cycle is a pure function of
(queue heads, snapshot): it returns per-entry outcomes; the control plane
applies them (assume into cache / issue evictions / requeue).

Semantics captured:
  * nominate() filtering (scheduler.go:614-654).
  * classical iterator ordering: quota-reserved first, fewer borrows first,
    higher priority first, FIFO (scheduler.go:971-1014).
  * fair-sharing tournament over the cohort tree with DRS-after-admission
    (fair_sharing_iterator.go:47-256).
  * processEntry: one-admission-per-cohort-overlap rule, fits re-check with
    simulated removal of already-preempted workloads, usage accumulation
    (scheduler.go:371-485).
  * capacity reservation for unreclaimable preemptions
    (scheduler.go:499-504,708-726).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from kueue_tpu_torch.api.types import FlavorResource
from kueue_tpu_torch.cache.snapshot import (
    ClusterQueueSnapshot,
    CohortSnapshot,
    Snapshot,
    compare_drs,
    sat_add,
    sat_sub,
)
from kueue_tpu_torch.scheduler.flavorassigner import (
    Assignment,
    FlavorAssigner,
    Mode,
    PodSetReducer,
)
from kueue_tpu_torch.scheduler.preemption import (
    Oracle,
    Preemptor,
    Target,
    can_always_reclaim,
)
from kueue_tpu_torch.workload_info import WorkloadInfo


class EntryStatus(str, Enum):
    """scheduler.go:564-579 (entryStatus)."""

    NOT_NOMINATED = ""
    NOMINATED = "nominated"
    SKIPPED = "skipped"
    ASSUMED = "assumed"
    PREEMPTING = "preempting"  # nominated + preemptions issued this cycle
    INADMISSIBLE = "inadmissible"


class RequeueReason(str, Enum):
    """pkg/cache/queue RequeueReason."""

    GENERIC = "Generic"
    NO_FIT = "NoFit"
    PREEMPTION_NO_CANDIDATES = "PreemptionNoCandidates"
    PREEMPTION_GATED = "PreemptionGated"
    FAILED_AFTER_NOMINATION = "FailedAfterNomination"
    NAMESPACE_MISMATCH = "NamespaceMismatch"


@dataclass(slots=True)
class Entry:
    """scheduler.go:582 (entry). __slots__ via the dataclass decorator:
    a serving cycle constructs one per verdict, so instance-dict
    allocation is measurable at 1k admissions/cycle."""

    info: WorkloadInfo
    assignment: Optional[Assignment] = None
    preemption_targets: list[Target] = field(default_factory=list)
    status: EntryStatus = EntryStatus.NOT_NOMINATED
    inadmissible_msg: str = ""
    requeue_reason: RequeueReason = RequeueReason.GENERIC
    cq_snapshot: Optional[ClusterQueueSnapshot] = None
    commit_position: int = -1  # order processed within the cycle

    @property
    def obj(self):
        return self.info.obj

    def assignment_usage(self) -> dict[FlavorResource, int]:
        """scheduler.go:596,697 (netUsage): once quota is reserved, the
        workload's quota usage is already accounted in the cache."""
        if self.obj.has_quota_reservation:
            return {}
        return dict(self.assignment.usage)


@dataclass
class CycleStats:
    admitted: int = 0
    preempting: int = 0
    skipped: int = 0
    inadmissible: int = 0
    preemption_skips: dict[str, int] = field(default_factory=dict)


@dataclass
class CycleResult:
    entries: list[Entry] = field(default_factory=list)
    inadmissible: list[Entry] = field(default_factory=list)
    stats: CycleStats = field(default_factory=CycleStats)

    @property
    def assumed(self) -> list[Entry]:
        return [e for e in self.entries if e.status == EntryStatus.ASSUMED]


class SchedulerCycle:
    """The decision core of scheduler.go:76 (Scheduler), cycle part."""

    def __init__(self, enable_fair_sharing: bool = False,
                 workload_ordering=None):
        self.enable_fair_sharing = enable_fair_sharing
        # workload_info.Ordering shared with the pending heaps, so heap
        # pops and entry ordering agree (None: the default ordering).
        self.workload_ordering = workload_ordering
        self.preemptor = Preemptor(enable_fair_sharing=enable_fair_sharing)
        # namespace -> labels provider for the nomination-time namespace
        # selector check (scheduler.go:636 ValidateAdmissibility); the
        # engine wires its namespace registry in. None = skip the check.
        self.namespace_labels_of = None

    def schedule(self, heads: list[WorkloadInfo], snapshot: Snapshot,
                 now: float = 0.0,
                 already_admitted: Optional[set[str]] = None) -> CycleResult:
        """scheduler.go:286 (schedule), steps 3-5. ``heads`` is one pending
        head per ClusterQueue (queue manager's Heads())."""
        result = CycleResult()
        entries = self._nominate(heads, snapshot, result,
                                 already_admitted or set(), now)
        ordered = self._make_iterator(entries, snapshot)
        preempted_workloads: dict[str, WorkloadInfo] = {}
        for pos, e in enumerate(ordered):
            e.commit_position = pos
            self._process_entry(e, snapshot, preempted_workloads, result, now)
        for e in entries:
            if e.status == EntryStatus.ASSUMED:
                result.stats.admitted += 1
            elif e.status == EntryStatus.PREEMPTING:
                result.stats.preempting += 1
            elif e.status == EntryStatus.SKIPPED:
                result.stats.skipped += 1
        result.entries = entries
        result.stats.inadmissible = len(result.inadmissible)
        return result

    # -- nomination (scheduler.go:614) --

    def _nominate(self, heads: list[WorkloadInfo], snapshot: Snapshot,
                  result: CycleResult, already_admitted: set[str],
                  now: float) -> list[Entry]:
        from kueue_tpu_torch.tas import feasibility

        # One batched launch per TAS forest decides fit/no-fit for every
        # qualifying head before the per-entry walk; apply_tas_pass
        # consults the verdicts and skips the sequential descent for
        # provably-unplaceable entries.
        feasibility.precompute(heads, snapshot)
        entries: list[Entry] = []
        for w in heads:
            e = Entry(info=w)
            e.cq_snapshot = snapshot.cluster_queue(w.cluster_queue)
            if w.key in already_admitted:
                continue
            if w.cluster_queue in snapshot.inactive_cluster_queues:
                e.inadmissible_msg = (
                    f"ClusterQueue {w.cluster_queue} is inactive")
                e.status = EntryStatus.INADMISSIBLE
                result.inadmissible.append(e)
            elif e.cq_snapshot is None:
                e.inadmissible_msg = (
                    f"ClusterQueue {w.cluster_queue} not found")
                e.status = EntryStatus.INADMISSIBLE
                result.inadmissible.append(e)
            elif self._namespace_mismatch(w, e.cq_snapshot):
                # scheduler.go:636: admissibility is validated at
                # nomination; a selector mismatch requeues the workload
                # as inadmissible (RequeueReasonNamespaceMismatch).
                e.inadmissible_msg = ("workload namespace doesn't match "
                                      "ClusterQueue selector")
                e.requeue_reason = RequeueReason.NAMESPACE_MISMATCH
                e.status = EntryStatus.INADMISSIBLE
                result.inadmissible.append(e)
            else:
                assignment, targets = self._get_assignments(w, snapshot, now)
                e.assignment = assignment
                e.preemption_targets = targets
                entries.append(e)
        return entries

    def _namespace_mismatch(self, w: WorkloadInfo, cq_snapshot) -> bool:
        from kueue_tpu_torch.workload_info import namespace_selector_mismatch
        if self.namespace_labels_of is None:
            return False
        return namespace_selector_mismatch(
            getattr(cq_snapshot.spec, "namespace_selector", None),
            self.namespace_labels_of(w.obj.namespace))

    def _get_assignments(self, wl: WorkloadInfo, snapshot: Snapshot,
                         now: float) -> tuple[Assignment, list[Target]]:
        """scheduler.go:733,762 (getAssignments / getInitialAssignments)."""
        from kueue_tpu_torch.tas.assigner import apply_tas_pass

        cq = snapshot.cluster_queue(wl.cluster_queue)
        oracle = Oracle(self.preemptor, snapshot, now)

        # Elastic workload slices (workloadslicing.ReplacedWorkloadSlice,
        # scheduler.go:765): the replaced slice's usage is freed for this
        # workload's assignment and it becomes a replacement target.
        slice_targets: list[Target] = []
        revert_slice = None
        old_info = None
        old_key = wl.obj.replaced_workload_slice
        if old_key is not None:
            # Captured BEFORE simulate_workload_removal drops it from the
            # snapshot: the TAS pass needs the predecessor's topology
            # assignment for delta-only elastic placement.
            old_info = cq.workloads.get(old_key)
            if old_info is not None:
                slice_targets.append(
                    Target(old_info, "WorkloadSliceReplaced"))
                revert_slice = snapshot.simulate_workload_removal(
                    [old_info])

        try:
            assigner = FlavorAssigner(
                wl, cq, snapshot.resource_flavors,
                enable_fair_sharing=self.enable_fair_sharing, oracle=oracle,
                preempt_workload_slice=old_info)
            full = assigner.assign()
            apply_tas_pass(full, wl, cq, previous_slice=old_info)
        finally:
            if revert_slice is not None:
                revert_slice()
        mode = full.representative_mode()
        if mode == Mode.FIT:
            return full, slice_targets
        if mode == Mode.PREEMPT:
            targets = self.preemptor.get_targets(wl, full, snapshot, now)
            if targets:
                return full, slice_targets + targets
        if wl.obj.can_be_partially_admitted():
            def try_counts(counts):
                assignment = assigner.assign(counts)
                apply_tas_pass(assignment, wl, cq,
                               previous_slice=old_info)
                m = assignment.representative_mode()
                if m == Mode.FIT:
                    return (assignment, []), True
                if m == Mode.PREEMPT:
                    t = self.preemptor.get_targets(wl, assignment, snapshot,
                                                   now)
                    if t:
                        return (assignment, t), True
                return None, False

            reducer = PodSetReducer(wl.obj.pod_sets, try_counts)
            found, ok = reducer.search()
            if ok:
                return found[0], slice_targets + found[1]
        return full, []

    # -- ordering (scheduler.go:945, fair_sharing_iterator.go) --

    def _make_iterator(self, entries: list[Entry],
                       snapshot: Snapshot) -> list[Entry]:
        if self.enable_fair_sharing:
            return list(_fair_sharing_order(entries))
        return sorted(entries, key=lambda e: _classical_key(
            e, self.workload_ordering))

    # -- commit (scheduler.go:371 processEntry) --

    def _process_entry(self, e: Entry, snapshot: Snapshot,
                       preempted_workloads: dict[str, WorkloadInfo],
                       result: CycleResult, now: float) -> None:
        cq = e.cq_snapshot
        mode = e.assignment.representative_mode()

        if mode == Mode.NO_FIT:
            e.requeue_reason = RequeueReason.NO_FIT
            e.inadmissible_msg = e.assignment.message()
            return

        if mode == Mode.PREEMPT and not e.preemption_targets:
            e.requeue_reason = RequeueReason.PREEMPTION_NO_CANDIDATES
            e.inadmissible_msg = (
                "Workload requires preemption, but no candidates found")
            # scheduler.go:499 reserveCapacityForUnreclaimablePreempt.
            if not can_always_reclaim(cq):
                cq.add_usage(self._quota_to_reserve(e, cq))
            return

        # Orchestrated preemption / concurrent admission: a closed gate
        # blocks the preemptor (scheduler.go:422 markPreemptionGated).
        if mode == Mode.PREEMPT and e.obj.has_closed_preemption_gate():
            e.requeue_reason = RequeueReason.PREEMPTION_GATED
            e.inadmissible_msg = (
                "Workload requires preemption, but it's gated")
            return

        # One-admission-per-cohort overlap rule (scheduler.go:432).
        if any(t.workload.key in preempted_workloads
               for t in e.preemption_targets):
            e.status = EntryStatus.SKIPPED
            e.inadmissible_msg = (
                "Workload has overlapping preemption targets with another "
                "workload")
            result.stats.preemption_skips[cq.name] = \
                result.stats.preemption_skips.get(cq.name, 0) + 1
            return

        from kueue_tpu_torch.tas.assigner import tas_usage_of_assignment

        usage = e.assignment_usage()
        tas_usage = tas_usage_of_assignment(e.assignment, e.info, cq)
        if not self._fits(snapshot, cq, usage, preempted_workloads,
                          e.preemption_targets, tas_usage):
            e.status = EntryStatus.SKIPPED
            e.inadmissible_msg = (
                "Workload no longer fits after processing another workload")
            if mode == Mode.PREEMPT:
                result.stats.preemption_skips[cq.name] = \
                    result.stats.preemption_skips.get(cq.name, 0) + 1
            return

        for t in e.preemption_targets:
            preempted_workloads[t.workload.key] = t.workload
        cq.add_usage(usage)
        for flavor, values, single, count in tas_usage:
            cq.tas_flavors[flavor].add_usage(values, single, count)

        if mode == Mode.PREEMPT:
            e.status = EntryStatus.PREEMPTING
            e.inadmissible_msg = (
                f"Preempting {len(e.preemption_targets)} workload(s)")
            return

        e.status = EntryStatus.ASSUMED

    @staticmethod
    def _fits(snapshot: Snapshot, cq: ClusterQueueSnapshot,
              usage: dict[FlavorResource, int],
              preempted_workloads: dict[str, WorkloadInfo],
              targets: list[Target], tas_usage=()) -> bool:
        """scheduler.go:680 (fits), incl. the TAS domain capacity check
        (clusterqueue_snapshot.go:143-150)."""
        to_remove = list(preempted_workloads.values()) + [
            t.workload for t in targets]
        revert = snapshot.simulate_workload_removal(to_remove)
        try:
            if not cq.fits(usage):
                return False
            for flavor, values, single, count in tas_usage:
                if not cq.tas_flavors[flavor].fits([(values, single,
                                                     count)]):
                    return False
            return True
        finally:
            revert()

    @staticmethod
    def _quota_to_reserve(e: Entry,
                          cq: ClusterQueueSnapshot) -> dict[FlavorResource, int]:
        """scheduler.go:708 (quotaResourcesToReserve), Preempt branch."""
        reserved: dict[FlavorResource, int] = {}
        for fr, usage in e.assignment.usage.items():
            quota = cq.quota_for(fr)
            cq_usage = cq.node.usage.get(fr, 0)
            if e.assignment.borrowing > 0:
                if quota.borrowing_limit is None:
                    reserved[fr] = usage
                else:
                    reserved[fr] = min(usage, sat_sub(
                        sat_add(quota.nominal, quota.borrowing_limit),
                        cq_usage))
            else:
                reserved[fr] = max(0, min(usage,
                                          sat_sub(quota.nominal, cq_usage)))
        return reserved


def _classical_key(e: Entry, ordering=None):
    """scheduler.go:971 (makeClassicalIterator sort): quota-reserved
    first, fewer borrows, priority (unless PrioritySortingWithinCohort is
    off), then FIFO by the queue-order timestamp (eviction-aware)."""
    from kueue_tpu_torch.config import features
    from kueue_tpu_torch.workload_info import (
        DEFAULT_ORDERING,
        queue_order_timestamp,
    )

    prio = (-e.obj.effective_priority
            if features.enabled("PrioritySortingWithinCohort") else 0)
    return (
        0 if e.obj.has_quota_reservation else 1,
        e.assignment.borrows(),
        prio,
        queue_order_timestamp(e.obj, ordering or DEFAULT_ORDERING),
    )


def _fair_sharing_order(entries: list[Entry]):
    """fair_sharing_iterator.go:47 — repeated tournament over the cohort
    forest, yielding one winner per pop."""
    cq_to_entry: dict[int, Entry] = {
        id(e.cq_snapshot): e for e in entries}
    cq_by_id: dict[int, ClusterQueueSnapshot] = {
        id(e.cq_snapshot): e.cq_snapshot for e in entries}

    while cq_to_entry:
        some_cq = next(iter(cq_by_id[k] for k in cq_to_entry))
        if not some_cq.has_parent():
            e = cq_to_entry.pop(id(some_cq))
            yield e
            continue
        root = some_cq.parent.root()
        assert isinstance(root, CohortSnapshot)
        drs_values = _compute_drs(root, cq_to_entry, cq_by_id)
        winner = _run_tournament(root, cq_to_entry, drs_values)
        if winner is None:
            # Entries whose CQs live under a different root.
            e = cq_to_entry.pop(id(some_cq))
            yield e
            continue
        cq_to_entry.pop(id(winner.cq_snapshot))
        yield winner


def _compute_drs(root: CohortSnapshot, cq_to_entry: dict[int, Entry],
                 cq_by_id) -> dict[tuple[str, str], object]:
    """fair_sharing_iterator.go:220 (computeDRS): DRS of each node on the
    CQ→root path after simulated admission of the CQ's nominated workload."""
    drs_values: dict[tuple[str, str], object] = {}
    for cq in root.subtree_cluster_queues():
        e = cq_to_entry.get(id(cq))
        if e is None:
            continue
        usage = e.assignment_usage()
        revert = cq.simulate_usage_addition(usage)
        try:
            drs = cq.dominant_resource_share()
            for ancestor in cq.path_parent_to_root():
                drs_values[(ancestor.name, e.obj.key)] = drs
                drs = ancestor.dominant_resource_share()
        finally:
            revert()
    return drs_values


def _run_tournament(cohort: CohortSnapshot, cq_to_entry: dict[int, Entry],
                    drs_values) -> Optional[Entry]:
    """fair_sharing_iterator.go:125 (runTournament)."""
    candidates: list[Entry] = []
    for child in cohort.child_cohorts:
        c = _run_tournament(child, cq_to_entry, drs_values)
        if c is not None:
            candidates.append(c)
    for child_cq in cohort.child_cqs:
        e = cq_to_entry.get(id(child_cq))
        if e is not None:
            candidates.append(e)
    if not candidates:
        return None
    best = candidates[0]
    for cur in candidates[1:]:
        if _entry_less(cur, best, cohort.name, drs_values):
            best = cur
    return best


def _entry_less(a: Entry, b: Entry, parent_cohort: str, drs_values) -> bool:
    """fair_sharing_iterator.go:176 (entryComparer.less)."""
    from kueue_tpu_torch.cache.snapshot import DRS
    a_drs = drs_values.get((parent_cohort, a.obj.key), DRS())
    b_drs = drs_values.get((parent_cohort, b.obj.key), DRS())
    c = compare_drs(a_drs, b_drs)
    if c != 0:
        return c == -1
    if a.obj.effective_priority != b.obj.effective_priority:
        return a.obj.effective_priority > b.obj.effective_priority
    return a.obj.creation_time < b.obj.creation_time
