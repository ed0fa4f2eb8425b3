"""Flavor assignment: pick a ResourceFlavor per (podset, resource).

Copied from ``kueue_tpu/scheduler/flavorassigner.py`` without the
tracing hooks.

Sequential correctness-oracle implementation of the reference's
pkg/scheduler/flavorassigner/flavorassigner.go. The batched TPU path
(kueue_tpu/ops/assign.py) reimplements the same decision lattice as array
programs; differential tests pin the two together.

Semantics captured :
  * modes: NoFit < Preempt < Fit (flavorassigner.go:404-421); internal
    granular modes noFit < noPreemptionCandidates < preempt < reclaim < fit
    with a borrowing level = height of the smallest fitting cohort subtree
    (flavorassigner.go:435-480).
  * isPreferred ordering with FlavorFungibility preference
    (flavorassigner.go:483-514).
  * flavor try-order resume via LastTriedFlavorIdx (flavorassigner.go:958).
  * shouldTryNextFlavor policy (flavorassigner.go:1127-1144).
  * fitsResourceQuota: maxCapacity / available checks, preemption oracle
    consult (flavorassigner.go:1198-1247).
  * taints/node-selector flavor eligibility (flavorassigner.go:1076-1125).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Protocol

from kueue_tpu_torch.api.types import (
    FlavorFungibility,
    FlavorResource,
    FungibilityPolicy,
    FungibilityPreference,
    ResourceQuota,
    Taint,
    Toleration,
    sat_add,
    sat_sub,
)
from kueue_tpu_torch.cache.snapshot import (
    ClusterQueueSnapshot,
    Snapshot,
    find_height_of_lowest_subtree_that_fits,
)
from kueue_tpu_torch.workload_info import WorkloadInfo


class Mode(IntEnum):
    """flavorassigner.go:404 (FlavorAssignmentMode)."""

    NO_FIT = 0
    PREEMPT = 1
    FIT = 2


class PMode(IntEnum):
    """flavorassigner.go:470 (preemptionMode)."""

    NO_FIT = 0
    NO_CANDIDATES = 1
    PREEMPT = 2
    RECLAIM = 3
    FIT = 4

    def to_mode(self) -> Mode:
        if self == PMode.NO_FIT:
            return Mode.NO_FIT
        if self == PMode.FIT:
            return Mode.FIT
        return Mode.PREEMPT


@dataclass(frozen=True)
class GranularMode:
    """flavorassigner.go:457 (granularMode)."""

    pmode: PMode
    borrow: int

    def is_preempt_mode(self) -> bool:
        return self.pmode in (PMode.PREEMPT, PMode.RECLAIM)


WORST = GranularMode(PMode.NO_FIT, 1 << 30)
BEST = GranularMode(PMode.FIT, 0)


def is_preferred(a: GranularMode, b: GranularMode,
                 fungibility: FlavorFungibility) -> bool:
    """True if a is better than b (flavorassigner.go:483 isPreferred)."""
    if a.pmode == PMode.NO_FIT:
        return False
    if b.pmode == PMode.NO_FIT:
        return True

    def borrowing_over_preemption() -> bool:
        if a.pmode != b.pmode:
            return a.pmode > b.pmode
        return a.borrow < b.borrow

    def preemption_over_borrowing() -> bool:
        if a.borrow != b.borrow:
            return a.borrow < b.borrow
        return a.pmode > b.pmode

    if fungibility.preference == FungibilityPreference.PREEMPTION_OVER_BORROWING:
        return preemption_over_borrowing()
    return borrowing_over_preemption()


def should_try_next_flavor(mode: GranularMode,
                           fungibility: FlavorFungibility) -> bool:
    """flavorassigner.go:1127 (shouldTryNextFlavor)."""
    if mode.pmode in (PMode.NO_FIT, PMode.NO_CANDIDATES):
        return True
    if (mode.is_preempt_mode()
            and fungibility.when_can_preempt == FungibilityPolicy.TRY_NEXT_FLAVOR):
        return True
    if (mode.borrow > 0
            and fungibility.when_can_borrow == FungibilityPolicy.TRY_NEXT_FLAVOR):
        return True
    return False


@dataclass
class FlavorAssignment:
    """flavorassigner.go:565."""

    name: str
    mode: Mode
    tried_flavor_idx: int = -1
    borrow: int = 0


@dataclass
class PodSetAssignment:
    """flavorassigner.go:325 (PodSetAssignment)."""

    name: str
    flavors: dict[str, FlavorAssignment] = field(default_factory=dict)
    reasons: list[str] = field(default_factory=list)
    requests: dict[str, int] = field(default_factory=dict)
    count: int = 0
    topology_assignment: Optional[object] = None
    # A hard error (e.g. multiple TAS flavors in one podset) forces
    # NoFit even when per-resource modes are Fit (Status.err in Go).
    error: Optional[str] = None

    def representative_mode(self) -> Mode:
        if self.error is not None:
            return Mode.NO_FIT
        # Status-clean means Fit even with no flavors (empty requests)
        # (flavorassigner.go:340-343).
        if not self.reasons:
            return Mode.FIT
        if not self.flavors:
            return Mode.NO_FIT
        return Mode(min(fa.mode for fa in self.flavors.values()))

    def update_mode(self, mode: Mode) -> None:
        for fa in self.flavors.values():
            fa.mode = mode


@dataclass
class Assignment:
    """flavorassigner.go:50 (Assignment)."""

    pod_sets: list[PodSetAssignment] = field(default_factory=list)
    borrowing: int = 0
    usage: dict[FlavorResource, int] = field(default_factory=dict)
    last_tried_flavor_idx: list[dict[str, int]] = field(default_factory=list)
    _representative: Optional[Mode] = None

    def representative_mode(self) -> Mode:
        if not self.pod_sets:
            return Mode.NO_FIT
        if self._representative is not None:
            return self._representative
        mode = Mode(min(ps.representative_mode() for ps in self.pod_sets))
        self._representative = mode
        return mode

    def update_mode(self, ps_name: str, mode: Mode) -> None:
        for ps in self.pod_sets:
            if ps.name == ps_name:
                ps.update_mode(mode)
                self._representative = mode

    def borrows(self) -> int:
        return self.borrowing

    def message(self) -> str:
        parts = []
        for ps in self.pod_sets:
            if ps.representative_mode() != Mode.FIT and ps.reasons:
                parts.append(
                    f"couldn't assign flavors to pod set {ps.name}: "
                    + ", ".join(sorted(ps.reasons)))
        return "; ".join(parts)

    def total_requests_for(self, wl: WorkloadInfo) -> dict[FlavorResource, int]:
        """flavorassigner.go:217 (TotalRequestsFor) — counts may have been
        reduced by partial admission."""
        usage: dict[FlavorResource, int] = {}
        for i, psr in enumerate(wl.total_requests):
            scaled = psr.scaled_to(self.pod_sets[i].count)
            for res, q in scaled.requests.items():
                if q == 0:
                    continue
                fa = self.pod_sets[i].flavors.get(res)
                if fa is None:
                    continue
                fr = FlavorResource(fa.name, res)
                usage[fr] = usage.get(fr, 0) + q
        return usage


class PreemptionOracle(Protocol):
    """flavorassigner.go:572 — lets the assigner ask whether preemption
    could free a flavor-resource."""

    def simulate_preemption(
        self, cq: ClusterQueueSnapshot, wl: WorkloadInfo,
        fr: FlavorResource, quantity: int,
    ) -> tuple[PMode, int]:
        """Returns (one of NO_CANDIDATES/PREEMPT/RECLAIM, borrow-after)."""
        ...


class _NeverPreemptOracle:
    def simulate_preemption(self, cq, wl, fr, quantity):
        borrow, _ = find_height_of_lowest_subtree_that_fits(cq, fr, quantity)
        return PMode.NO_CANDIDATES, borrow


NEVER_PREEMPT_ORACLE = _NeverPreemptOracle()


def flavor_matches_podset(flavor, pod_set) -> Optional[str]:
    """Taint/selector eligibility (flavorassigner.go:1076
    checkFlavorForPodSets). Returns a reason string if ineligible."""
    # TAS match (tas_flavorassigner.go checkPodSetAndFlavorMatchForTAS):
    # a pod set with an explicit topology PLACEMENT request needs a TAS
    # flavor. A topology request carrying only a pod-set group name (the
    # LeaderWorkerSet co-assignment contract) places no TAS demand
    # (mode is None in that encoding).
    tr = pod_set.topology_request
    if (tr is not None and getattr(tr, "mode", None) is not None
            and flavor.topology_name is None):
        return (f"Flavor {flavor.name} does not support "
                "TopologyAwareScheduling")
    tolerations = tuple(pod_set.tolerations) + tuple(flavor.tolerations)
    for taint in flavor.node_taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return f"untolerated taint {taint.key} in flavor {flavor.name}"
    # Node-selector match restricted to this flavor's own label keys
    # (flavorassigner.go:1092-1095,1146 flavorSelector).
    for key, val in pod_set.node_selector.items():
        if key in flavor.node_labels and flavor.node_labels[key] != val:
            return f"flavor {flavor.name} doesn't match node affinity"
    # requiredDuringScheduling affinity: ORed terms; within a term,
    # expressions whose key is not one of the flavor's own labels are
    # ignored (so a term of only foreign keys matches any flavor).
    if pod_set.node_affinity:
        if not any(_affinity_term_matches(term, flavor.node_labels)
                   for term in pod_set.node_affinity):
            return f"flavor {flavor.name} doesn't match node affinity"
    return None


def _affinity_term_matches(term, labels: dict) -> bool:
    for key, op, values in term:
        if key not in labels:
            continue  # foreign key: restricted selector ignores it
        val = labels[key]
        if op == "In":
            if val not in values:
                return False
        elif op == "NotIn":
            if val in values:
                return False
        elif op == "DoesNotExist":
            return False
        elif op == "Exists":
            pass  # key present — satisfied
        elif op in ("Gt", "Lt"):
            # k8s numeric comparison: single integer value.
            try:
                lv, rv = int(val), int(values[0])
            except (ValueError, IndexError):
                return False
            if op == "Gt" and not lv > rv:
                return False
            if op == "Lt" and not lv < rv:
                return False
        else:
            return False  # unknown operator never matches
    return True


class FlavorAssigner:
    """flavorassigner.go:576."""

    def __init__(
        self,
        wl: WorkloadInfo,
        cq: ClusterQueueSnapshot,
        resource_flavors: dict,
        enable_fair_sharing: bool = False,
        oracle: PreemptionOracle = NEVER_PREEMPT_ORACLE,
        preempt_workload_slice: Optional[WorkloadInfo] = None,
    ):
        self.wl = wl
        self.cq = cq
        self.resource_flavors = resource_flavors
        self.enable_fair_sharing = enable_fair_sharing
        self.oracle = oracle
        # Elastic scale-up: the admitted slice this workload replaces.
        # The replacement must land on the original slice's flavors
        # (flavorassigner.go preemptWorkloadSlice — pods keep running).
        self.preempt_workload_slice = preempt_workload_slice

    def assign(self, counts: Optional[list[int]] = None) -> Assignment:
        # Drop stale resume state (flavorassigner.go:615,624).
        if (self.wl.last_assignment_flavor_idx is not None
                and self.cq.generation > self.wl.last_assignment_generation):
            self.wl.last_assignment_flavor_idx = None
        return self._assign_flavors(counts)

    def _assign_flavors(self, counts: Optional[list[int]]) -> Assignment:
        if counts is None:
            requests = [psr.scaled_to(psr.count)
                        for psr in self.wl.total_requests]
        else:
            requests = [psr.scaled_to(c)
                        for psr, c in zip(self.wl.total_requests, counts)]
        # Implicit "pods" resource when the CQ covers it
        # (flavorassigner.go:671-673).
        if self.cq.rg_by_resource("pods") is not None:
            for psr in requests:
                psr.requests["pods"] = psr.count

        assignment = Assignment()

        # Group podsets: by default each podset is its own group; TAS podset
        # groups share one flavor pick (flavorassigner.go:699-704).
        groups: dict[str, list[int]] = {}
        order: list[str] = []
        for i, ps in enumerate(self.wl.obj.pod_sets):
            key = str(i)
            if ps.topology_request and ps.topology_request.pod_set_group_name:
                key = ps.topology_request.pod_set_group_name
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(i)

        ps_assignments: dict[int, PodSetAssignment] = {}
        for i, psr in enumerate(requests):
            ps_assignments[i] = PodSetAssignment(
                name=psr.name, requests=dict(psr.requests), count=psr.count)

        failed = False
        for key in order:
            ps_ids = groups[key]
            group_requests: dict[str, int] = {}
            for i in ps_ids:
                for res, q in requests[i].requests.items():
                    group_requests[res] = group_requests.get(res, 0) + q

            group_flavors: dict[str, FlavorAssignment] = {}
            group_reasons: list[str] = []
            group_failed = False
            for res in group_requests:
                if self.cq.rg_by_resource(res) is None:
                    if group_requests[res] == 0:
                        continue
                if res in group_flavors:
                    continue  # same resource group already assigned
                flavors, reasons, ok = self._find_flavor_for_podsets(
                    ps_ids, group_requests, res, assignment.usage)
                if not ok:
                    # A failed search REPLACES the accumulated status —
                    # only the failing resource's reasons survive
                    # (flavorassigner.go:766-771: psAssignment.Flavors =
                    # nil; psAssignment.Status = status; break).
                    group_flavors = {}
                    group_reasons = reasons
                    group_failed = True
                    break
                group_reasons.extend(reasons)
                group_flavors.update(flavors)

            for i in ps_ids:
                psa = ps_assignments[i]
                psa.flavors = {
                    res: FlavorAssignment(fa.name, fa.mode,
                                          fa.tried_flavor_idx, fa.borrow)
                    for res, fa in group_flavors.items()
                    if res in requests[i].requests}
                psa.reasons = list(group_reasons)
                # A podset with a topology placement request must land on
                # ONE TAS flavor: resources split across different TAS
                # flavors cannot be co-placed in a single topology
                # (flavorassigner_test.go "multiple TAS flavors assigned
                # to different resources in the same PodSet leads to
                # NoFit"; MultipleTASFlavorsAssignedError).
                tr = self.wl.obj.pod_sets[i].topology_request
                if tr is not None and getattr(tr, "mode", None) is not None:
                    tas_used = sorted({
                        fa.name for fa in psa.flavors.values()
                        if (fl := self.resource_flavors.get(fa.name))
                        is not None and fl.topology_name})
                    if len(tas_used) > 1:
                        psa.error = ("multiple TAS flavors assigned: "
                                     + ", ".join(tas_used))
                        failed = True
                self._append(assignment, requests[i], psa)
                # Only POSITIVE requests demand a flavor: a podset whose
                # requests are all explicit zeros of uncovered resources
                # is status-clean Fit with no flavors
                # (flavorassigner.go:340-343) and must not abort the
                # remaining podsets.
                if group_failed or (
                        any(requests[i].requests.values())
                        and not psa.flavors):
                    failed = True
            if failed:
                return assignment
        return assignment

    def _append(self, assignment: Assignment, psr, psa: PodSetAssignment) -> None:
        """flavorassigner.go:887 (Assignment.append)."""
        flavor_idx: dict[str, int] = {}
        assignment.pod_sets.append(psa)
        for res, fa in psa.flavors.items():
            assignment.borrowing = max(assignment.borrowing, fa.borrow)
            fr = FlavorResource(fa.name, res)
            assignment.usage[fr] = assignment.usage.get(fr, 0) \
                + psr.requests.get(res, 0)
            flavor_idx[res] = fa.tried_flavor_idx
        assignment.last_tried_flavor_idx.append(flavor_idx)
        assignment._representative = None

    def _slice_pinned_flavor(self, ps_id: int, res: str) -> Optional[str]:
        """The original slice's flavor for (podset, resource), or None."""
        slice_reqs = self.preempt_workload_slice.total_requests
        name = self.wl.obj.pod_sets[ps_id].name
        for psr in slice_reqs:
            if psr.name == name:
                return psr.flavors.get(res)
        return None

    def _resume_idx(self, ps_id: int, res: str) -> int:
        """LastAssignment.NextFlavorToTryForPodSetResource
        (flavorassigner.go:958)."""
        state = self.wl.last_assignment_flavor_idx
        if state is None or ps_id >= len(state):
            return 0
        last = state[ps_id].get(res, -1)
        return last + 1 if last >= 0 else 0

    def _find_flavor_for_podsets(
        self,
        ps_ids: list[int],
        requests: dict[str, int],
        res_name: str,
        assignment_usage: dict[FlavorResource, int],
    ) -> tuple[dict[str, FlavorAssignment], list[str], bool]:
        """flavorassigner.go:932 (findFlavorForPodSets). Returns
        (flavors, reasons, ok). With tracing on (obs.hooks.CURRENT set)
        it reports the flavors tried and the verdict as a
        ``flavor_search`` rationale event."""
        from kueue_tpu_torch.obs import hooks as _obs

        rg = self.cq.rg_by_resource(res_name)
        if rg is None:
            if _obs.CURRENT is not None:
                _obs.emit("flavor_search", self.wl.key, resource=res_name,
                          tried=[], pmode="NO_FIT",
                          reasons=[f"resource {res_name} unavailable in "
                                   "ClusterQueue"])
            return {}, [f"resource {res_name} unavailable in ClusterQueue"], False

        tried: Optional[list] = [] if _obs.CURRENT is not None else None
        reasons: list[str] = []
        group_requests = {r: q for r, q in requests.items()
                          if r in rg.covered_resources}

        best: dict[str, FlavorAssignment] = {}
        best_mode = WORST
        fungibility = self.cq.flavor_fungibility

        attempted_idx = -1
        idx = self._resume_idx(ps_ids[0], res_name)
        flavor_quotas = rg.flavors
        while idx < len(flavor_quotas):
            attempted_idx = idx
            f_name = flavor_quotas[idx].name
            if tried is not None:
                tried.append(f_name)
            flavor = self.resource_flavors.get(f_name)
            if flavor is None:
                reasons.append(f"flavor {f_name} not found")
                idx += 1
                continue
            # Concurrent-admission variants are pinned to one flavor
            # (WorkloadAllowedResourceFlavorAnnotation,
            # concurrentadmission/controller.go:371 generateVariant).
            allowed = getattr(self.wl.obj, "allowed_resource_flavor", None)
            if allowed and f_name != allowed:
                reasons.append(
                    f"flavor {f_name} excluded by allowed-flavor pin")
                idx += 1
                continue
            mismatch = None
            for i in ps_ids:
                mismatch = flavor_matches_podset(flavor,
                                                 self.wl.obj.pod_sets[i])
                if mismatch:
                    break
            if mismatch:
                reasons.append(mismatch)
                idx += 1
                continue
            # Workload-slice pinning: the scale-up replacement must reuse
            # the original slice's flavor for each resource — its pods
            # keep running on those nodes (flavorassigner_test.go
            # "workload slice preemption fits in the original workload
            # resource flavor").
            if self.preempt_workload_slice is not None:
                pinned = next(
                    (p for i in ps_ids
                     if (p := self._slice_pinned_flavor(i, res_name))
                     is not None), None)
                if pinned is not None and pinned != f_name:
                    reasons.append(
                        f"could not assign {f_name} flavor since the"
                        f" original workload is assigned: {pinned}")
                    idx += 1
                    continue

            assignments: dict[str, FlavorAssignment] = {}
            representative = BEST
            for r_name, val in group_requests.items():
                fr = FlavorResource(f_name, r_name)
                quota = self.cq.quota_for(fr)
                pmode, borrow, reason = self._fits_resource_quota(
                    fr, assignment_usage.get(fr, 0), val, quota)
                if reason:
                    reasons.append(reason)
                mode = GranularMode(pmode, borrow)
                if is_preferred(representative, mode, fungibility):
                    representative = mode
                if representative.pmode == PMode.NO_FIT:
                    break
                assignments[r_name] = FlavorAssignment(
                    name=f_name, mode=pmode.to_mode(), borrow=borrow)

            if not should_try_next_flavor(representative, fungibility):
                best = assignments
                best_mode = representative
                break
            if is_preferred(representative, best_mode, fungibility):
                best = assignments
                best_mode = representative
            idx += 1

        for fa in best.values():
            fa.tried_flavor_idx = (
                -1 if attempted_idx == len(flavor_quotas) - 1 else attempted_idx)
        if tried is not None:
            _obs.emit("flavor_search", self.wl.key, resource=res_name,
                      tried=tried, pmode=best_mode.pmode.name,
                      borrow=best_mode.borrow,
                      chosen=sorted({fa.name for fa in best.values()}),
                      reasons=list(reasons))
        ok = bool(best) or not group_requests
        if best_mode.pmode == PMode.FIT:
            return best, [], ok
        return best, reasons, ok

    def _can_preempt_while_borrowing(self) -> bool:
        """flavorassigner.go:1249."""
        from kueue_tpu_torch.api.types import (
            BorrowWithinCohortPolicy,
            PreemptionPolicy,
        )
        p = self.cq.preemption
        if (p.borrow_within_cohort is not None
                and p.borrow_within_cohort.policy
                != BorrowWithinCohortPolicy.NEVER):
            return True
        return (self.enable_fair_sharing
                and p.reclaim_within_cohort != PreemptionPolicy.NEVER)

    def _fits_resource_quota(
        self, fr: FlavorResource, assumed_usage: int, request: int,
        quota: ResourceQuota,
    ) -> tuple[PMode, int, Optional[str]]:
        """flavorassigner.go:1198 (fitsResourceQuota)."""
        available = self.cq.available(fr)
        max_capacity = self.cq.potential_available(fr)
        val = sat_add(assumed_usage, request)

        if val > max_capacity:
            return PMode.NO_FIT, 0, (
                f"insufficient quota for {fr.resource} in flavor {fr.flavor},"
                f" request > maximum capacity ({max_capacity})")

        borrow, may_reclaim = find_height_of_lowest_subtree_that_fits(
            self.cq, fr, val)
        if val <= available:
            return PMode.FIT, borrow, None

        reason = (f"insufficient unused quota for {fr.resource} in flavor "
                  f"{fr.flavor}, {val - available} more needed")
        if (quota.nominal >= val or may_reclaim
                or self._can_preempt_while_borrowing()):
            pmode, borrow_after = self.oracle.simulate_preemption(
                self.cq, self.wl, fr, val)
            return pmode, borrow_after, reason
        return PMode.NO_FIT, borrow, reason


def flavor_resources_need_preemption(
        assignment: Assignment) -> set[FlavorResource]:
    """preemption.go:546 (flavorResourcesNeedPreemption)."""
    out: set[FlavorResource] = set()
    for ps in assignment.pod_sets:
        for res, fa in ps.flavors.items():
            if fa.mode == Mode.PREEMPT:
                out.add(FlavorResource(fa.name, res))
    return out


class PodSetReducer:
    """Partial admission binary search over per-podset counts
    (flavorassigner/podset_reducer.go)."""

    def __init__(self, pod_sets, try_counts):
        self.pod_sets = pod_sets
        self.try_counts = try_counts  # fn(list[int]) -> (result|None, ok)

    def search(self):
        downs = [ps.min_count if ps.min_count is not None else ps.count
                 for ps in self.pod_sets]
        ups = [ps.count for ps in self.pod_sets]
        if downs == ups:
            return None, False
        result, ok = self.try_counts(downs)
        if not ok:
            return None, False
        best = result
        # Binary search on the interpolation parameter between min and full.
        lo, hi = 0, 1 << 20
        best_counts = downs
        while lo < hi:
            mid = (lo + hi + 1) // 2
            counts = [d + (u - d) * mid // (1 << 20)
                      for d, u in zip(downs, ups)]
            if counts == best_counts:
                lo = mid
                continue
            result, ok = self.try_counts(counts)
            if ok:
                best, best_counts, lo = result, counts, mid
            else:
                hi = mid - 1
        return best, True
