"""Validating/defaulting webhooks (standalone validators).

The port of ``kueue_tpu/webhooks/validators.py``, unchanged.

Reference: pkg/webhooks/{clusterqueue,cohort,resourceflavor,workload}
_webhook.go — quota shape validation, cohort references, pod-set
invariants — plus pkg/cache/hierarchy/cycle.go:31 (HasCycle)."""

from __future__ import annotations

import re
from typing import Optional

from kueue_tpu_torch.api.types import (
    BorrowWithinCohortPolicy,
    ClusterQueue,
    Cohort,
    PreemptionPolicy,
    ResourceFlavor,
    Workload,
)

_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$")
MAX_PODSETS = 8


def _name_errors(name: str, what: str) -> list[str]:
    if not name:
        return [f"{what}: name must not be empty"]
    if len(name) > 253 or not _NAME_RE.match(name):
        return [f"{what}: invalid name {name!r}"]
    return []


def validate_cluster_queue(cq: ClusterQueue) -> list[str]:
    """clusterqueue_webhook.go."""
    errs = _name_errors(cq.name, "clusterQueue")
    if cq.cohort:
        errs += _name_errors(cq.cohort, "clusterQueue.cohortName")
    seen_resources: set[str] = set()
    for gi, rg in enumerate(cq.resource_groups):
        if not rg.covered_resources:
            errs.append(f"resourceGroups[{gi}]: coveredResources empty")
        if not rg.flavors:
            errs.append(f"resourceGroups[{gi}]: flavors empty")
        for res in rg.covered_resources:
            if res in seen_resources:
                errs.append(
                    f"resourceGroups[{gi}]: resource {res} already covered "
                    "by another group")
            seen_resources.add(res)
        for fq in rg.flavors:
            # Each flavor must quota exactly the covered resources.
            if set(fq.resources) != set(rg.covered_resources):
                errs.append(
                    f"resourceGroups[{gi}].flavors[{fq.name}]: resources "
                    "must match coveredResources")
            for res, q in fq.resources.items():
                if q.nominal < 0:
                    errs.append(
                        f"flavor {fq.name}/{res}: nominalQuota < 0")
                if q.borrowing_limit is not None and q.borrowing_limit < 0:
                    errs.append(
                        f"flavor {fq.name}/{res}: borrowingLimit < 0")
                if q.lending_limit is not None and q.lending_limit < 0:
                    errs.append(
                        f"flavor {fq.name}/{res}: lendingLimit < 0")
                if (q.lending_limit is not None and not cq.cohort):
                    errs.append(
                        f"flavor {fq.name}/{res}: lendingLimit requires a "
                        "cohort")
                if (q.borrowing_limit is not None and not cq.cohort):
                    errs.append(
                        f"flavor {fq.name}/{res}: borrowingLimit requires "
                        "a cohort")
    p = cq.preemption
    if (p.borrow_within_cohort is not None
            and p.borrow_within_cohort.policy
            != BorrowWithinCohortPolicy.NEVER
            and p.reclaim_within_cohort == PreemptionPolicy.NEVER):
        errs.append(
            "preemption.borrowWithinCohort requires reclaimWithinCohort "
            "!= Never")
    return errs


def validate_cohort(cohort: Cohort) -> list[str]:
    errs = _name_errors(cohort.name, "cohort")
    if cohort.parent:
        from kueue_tpu_torch.config import features
        if not features.enabled("HierarchicalCohorts"):
            errs.append("cohort: parentName requires the"
                        " HierarchicalCohorts feature gate")
        errs += _name_errors(cohort.parent, "cohort.parentName")
        if cohort.parent == cohort.name:
            errs.append("cohort: parentName must differ from name")
    return errs


def validate_resource_flavor(rf: ResourceFlavor) -> list[str]:
    errs = _name_errors(rf.name, "resourceFlavor")
    for k in rf.node_labels:
        if not k:
            errs.append("resourceFlavor: empty nodeLabel key")
    return errs


def default_workload(wl: Workload) -> None:
    """workload_webhook.go Default: drop minCounts when PartialAdmission
    is gated off; name a sole anonymous PodSet "main"."""
    from kueue_tpu_torch.config import features

    if not features.enabled("PartialAdmission"):
        for ps in wl.pod_sets:
            ps.min_count = None
    if len(wl.pod_sets) == 1 and not wl.pod_sets[0].name:
        wl.pod_sets[0].name = "main"


def validate_workload(wl: Workload) -> list[str]:
    """workload_webhook.go: pod-set invariants."""
    errs = _name_errors(wl.name, "workload")
    if not wl.pod_sets:
        errs.append("workload: podSets must not be empty")
    if len(wl.pod_sets) > MAX_PODSETS:
        errs.append(f"workload: at most {MAX_PODSETS} podSets")
    names = set()
    for ps in wl.pod_sets:
        if ps.name in names:
            errs.append(f"workload: duplicate podSet name {ps.name}")
        names.add(ps.name)
        if ps.count < 1:
            errs.append(f"podSet {ps.name}: count must be >= 1")
        if ps.min_count is not None and not (
                0 < ps.min_count <= ps.count):
            errs.append(
                f"podSet {ps.name}: minCount must be in (0, count]")
        for res, q in ps.requests.items():
            if q < 0:
                errs.append(f"podSet {ps.name}: negative request {res}")
        tr = ps.topology_request
        if tr is not None and tr.slice_size is not None:
            if tr.slice_size <= 0:
                errs.append(f"podSet {ps.name}: sliceSize must be > 0")
            elif ps.count % tr.slice_size != 0:
                errs.append(
                    f"podSet {ps.name}: count must be a multiple of "
                    "sliceSize")
    return errs


def validate_workload_update(old: Workload, new: Workload) -> list[str]:
    """Admission immutability (workload_webhook.go): pod sets can't change
    while quota is reserved."""
    errs = []
    if old.has_quota_reservation:
        old_shape = [(ps.name, ps.count, tuple(sorted(ps.requests.items())))
                     for ps in old.pod_sets]
        new_shape = [(ps.name, ps.count, tuple(sorted(ps.requests.items())))
                     for ps in new.pod_sets]
        if old_shape != new_shape:
            errs.append(
                "workload: podSets are immutable while quota is reserved")
    return errs


def find_cohort_cycle(cohorts: list[Cohort]) -> Optional[list[str]]:
    """hierarchy/cycle.go:31 (HasCycle): returns a cycle path or None."""
    parent = {c.name: c.parent for c in cohorts}
    for start in parent:
        seen: list[str] = []
        cur: Optional[str] = start
        while cur is not None:
            if cur in seen:
                return seen[seen.index(cur):]
            seen.append(cur)
            cur = parent.get(cur)
    return None
