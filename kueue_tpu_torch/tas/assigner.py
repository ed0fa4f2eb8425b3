"""TAS x flavor-assignment glue: after quota-level flavor assignment,
compute topology placements and adjust the assignment mode.

The port of ``kueue_tpu/tas/assigner.py`` without the tracing hook.

Reference: pkg/scheduler/flavorassigner/tas_flavorassigner.go and the TAS
block of assignFlavors (flavorassigner.go:783-821):
  * Fit assignment -> try real placement; failure downgrades the pod set
    to Preempt;
  * Preempt assignment -> re-try with simulate-empty; failure downgrades
    to NoFit; success keeps Preempt and records the reservation
    assignment (scheduler.go:836-847).
"""

from __future__ import annotations

from kueue_tpu_torch.scheduler.flavorassigner import Assignment, Mode
from kueue_tpu_torch.tas.snapshot import TASPodSetRequest
from kueue_tpu_torch.workload_info import WorkloadInfo


def workload_tas_requests(assignment: Assignment, wl: WorkloadInfo,
                          cq_snapshot, previous_slice=None
                          ) -> dict[str, list]:
    """Group the workload's TAS-needing pod sets by assigned TAS flavor
    (flavorassigner.Assignment.WorkloadsTopologyRequests). An elastic
    scale-up/-down slice carries its predecessor's per-pod-set topology
    assignments (``previous_slice``, captured by the cycle before the
    old slice is simulated out of the snapshot) so placement is
    delta-only (tas_elastic_workloads.go:35)."""
    prev_by_ps: dict[str, object] = {}
    old_adm = (previous_slice.obj.status.admission
               if previous_slice is not None
               and previous_slice.obj.status.admission else None)
    if old_adm is not None:
        prev_by_ps = {psa.name: psa.topology_assignment
                      for psa in old_adm.pod_set_assignments
                      if psa.topology_assignment is not None}
    requests: dict[str, list] = {}
    for i, psa in enumerate(assignment.pod_sets):
        ps = wl.obj.pod_sets[i]
        flavor = next((fa.name for fa in psa.flavors.values()
                       if fa.name in cq_snapshot.tas_flavors), None)
        if flavor is None:
            continue
        if ps.topology_request is None and not _tas_only(cq_snapshot):
            continue
        psr = wl.total_requests[i]
        single = psr.single_pod_requests()
        requests.setdefault(flavor, []).append(
            (psa, TASPodSetRequest(
                ps, single, psa.count,
                previous_assignment=prev_by_ps.get(ps.name))))
    return requests


def _tas_only(cq_snapshot) -> bool:
    return bool(cq_snapshot.tas_flavors) and set(
        cq_snapshot.tas_flavors) >= {
        fq.name for rg in cq_snapshot.spec.resource_groups
        for fq in rg.flavors}


def find_assignments(cq_snapshot, tas_requests: dict[str, list],
                     simulate_empty: bool = False, workload=None):
    """Run placement per flavor, accumulating assumed usage between pod
    sets of the same workload
    (clusterqueue_snapshot.go:207 FindTopologyAssignmentsForWorkload;
    grouping/leader/replacement handled by
    FindTopologyAssignmentsForFlavor, tas_flavor_snapshot.go:642).
    Returns (results {psa_name: TopologyAssignment}, failure_reason)."""
    results = {}
    for flavor in sorted(tas_requests):
        tas_snap = cq_snapshot.tas_flavors[flavor]
        pairs = tas_requests[flavor]
        flavor_results, reason = tas_snap.find_topology_assignments_for_flavor(
            [request for _, request in pairs], workload=workload,
            simulate_empty=simulate_empty)
        if reason:
            failed = next((psa.name for psa, request in pairs
                           if psa.name not in flavor_results),
                          pairs[0][0].name)
            return None, (failed, reason)
        results.update(flavor_results)
    return results, None


def _precomputed_failure(tas_requests: dict[str, list], cq_snapshot,
                         simulate_empty: bool):
    """A batched-feasibility rejection for the request the sequential
    path would fail on FIRST (the first order group of the first sorted
    flavor), or None to run the real placement. Exact: the verdict
    carries the notFitMessage argument the host descent would report."""
    from kueue_tpu_torch.tas import feasibility

    flavor = sorted(tas_requests)[0]
    pairs = tas_requests[flavor]
    psa, request = pairs[0]
    tr = request.pod_set.topology_request
    if tr is not None and tr.pod_set_group_name:
        return None  # the first group may pair a leader
    snap = cq_snapshot.tas_flavors[flavor]
    vd = feasibility.lookup(snap, request)
    if vd is None:
        return None
    from kueue_tpu_torch.tas.snapshot import slice_topology_constraints
    constraints = slice_topology_constraints(tr)
    slice_size = constraints[0][1] if constraints else 1
    if slice_size <= 0:
        return None
    sc = request.count // slice_size

    def message(arg):
        # Identical string to the host walk: stats built lazily from the
        # same (request, forest) inputs (snapshot._exclusion_stats).
        per_pod = dict(request.single_pod_requests)
        per_pod["pods"] = per_pod.get("pods", 0) + 1
        stats = snap._exclusion_stats(request.pod_set, per_pod,
                                      simulate_empty, {}, ())
        return snap._not_fit_message(arg, sc, slice_size, stats)

    if simulate_empty:
        if vd.fit_empty:
            return None
        return psa.name, message(vd.arg_empty)
    if vd.fit_used or not feasibility.used_valid(snap):
        return None
    return psa.name, message(vd.arg_used)


def apply_tas_pass(assignment: Assignment, wl: WorkloadInfo,
                   cq_snapshot, previous_slice=None) -> None:
    """The flavorassigner.go:783-821 TAS block."""
    from kueue_tpu_torch.obs import hooks as _obs

    tas_requests = workload_tas_requests(assignment, wl, cq_snapshot,
                                         previous_slice=previous_slice)
    if not tas_requests:
        return
    if _obs.CURRENT is None:
        _apply_tas_pass(assignment, wl, cq_snapshot, tas_requests)
        return
    before = assignment.representative_mode()
    try:
        _apply_tas_pass(assignment, wl, cq_snapshot, tas_requests)
    finally:
        # The feasibility verdict, as the span tree records it: the
        # mode transition the topology pass imposed plus which podsets
        # got a concrete placement.
        _obs.emit(
            "tas", wl.key, before=before.name,
            after=assignment.representative_mode().name,
            placed=sorted(psa.name for psa in assignment.pod_sets
                          if psa.topology_assignment is not None))


def _apply_tas_pass(assignment: Assignment, wl: WorkloadInfo,
                    cq_snapshot, tas_requests) -> None:
    if assignment.representative_mode() == Mode.FIT:
        failure = _precomputed_failure(tas_requests, cq_snapshot,
                                       simulate_empty=False)
        results = None
        if failure is None:
            results, failure = find_assignments(cq_snapshot, tas_requests)
        if failure is not None:
            ps_name, reason = failure
            for psa in assignment.pod_sets:
                if psa.name == ps_name:
                    psa.reasons.append(reason)
            assignment.update_mode(ps_name, Mode.PREEMPT)
        else:
            for psa in assignment.pod_sets:
                if psa.name in results:
                    psa.topology_assignment = results[psa.name]
    if assignment.representative_mode() == Mode.PREEMPT:
        failure = _precomputed_failure(tas_requests, cq_snapshot,
                                       simulate_empty=True)
        if failure is not None:
            ps_name, _ = failure
            assignment.update_mode(ps_name, Mode.NO_FIT)
            return
        results, failure = find_assignments(
            cq_snapshot, tas_requests, simulate_empty=True)
        if failure is not None:
            ps_name, _ = failure
            assignment.update_mode(ps_name, Mode.NO_FIT)
        else:
            # Quota may fit in aggregate while placement is fragmented:
            # keep Preempt and record the simulated reservation.
            for psa in assignment.pod_sets:
                if psa.name in results:
                    psa.topology_assignment = results[psa.name]


def tas_usage_of_assignment(assignment: Assignment, wl: WorkloadInfo,
                            cq_snapshot) -> list:
    """(flavor, values, single_pod_requests, count) tuples for the
    assignment's topology placements (Assignment.ComputeTASNetUsage)."""
    out = []
    for i, psa in enumerate(assignment.pod_sets):
        if psa.topology_assignment is None:
            continue
        flavor = next((fa.name for fa in psa.flavors.values()
                       if fa.name in cq_snapshot.tas_flavors), None)
        if flavor is None:
            continue
        single = wl.total_requests[i].single_pod_requests()
        for dom in psa.topology_assignment.domains:
            out.append((flavor, tuple(dom.values), single, dom.count))
    return out
