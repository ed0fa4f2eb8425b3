"""Visibility: pending-workload positions and the serving endpoint's
JSON views of a live engine.

The port of ``kueue_tpu/visibility/server.py`` (pkg/visibility
server.go:82, storage/pending_workloads_*.go and the debugger dump,
pkg/debugger/debugger.go:42), with ``eviction_summary`` over the
engine's registry, and the debug bodies of the obs layer:
``trace_summary`` (/debug/trace), ``perf_summary`` (/debug/perf) and
``slo_summary`` (/debug/slo, with the ladder, watchdog, disk-budget and
shedder blocks when those are attached).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

from kueue_tpu_torch.api.types import FlavorResource


@dataclass
class PendingWorkload:
    """apis/visibility/v1beta2/types.go:66 (PendingWorkload)."""

    name: str
    namespace: str
    local_queue: str
    priority: int
    position_in_cluster_queue: int
    position_in_local_queue: int


@dataclass
class PendingWorkloadsSummary:
    cluster_queue: str
    items: list


# cohort_tree's memo, keyed weakly by engine.
_cohort_tree_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class VisibilityServer:
    def __init__(self, engine):
        self.engine = engine

    def pending_workloads_for_cq(self, cq_name: str,
                                 limit: int = 1000,
                                 offset: int = 0) -> PendingWorkloadsSummary:
        """storage/pending_workloads_cq.go: heap-ordered positions."""
        pcq = self.engine.queues.cluster_queues.get(cq_name)
        items: list[PendingWorkload] = []
        if pcq is not None:
            ordered = sorted(
                pcq.items.values(),
                key=lambda info: (-info.obj.effective_priority,
                                  info.obj.creation_time))
            lq_positions: dict[str, int] = {}
            for pos, info in enumerate(ordered):
                lq = info.obj.queue_name
                lq_pos = lq_positions.get(lq, 0)
                lq_positions[lq] = lq_pos + 1
                if pos < offset or len(items) >= limit:
                    continue
                items.append(PendingWorkload(
                    name=info.obj.name, namespace=info.obj.namespace,
                    local_queue=lq, priority=info.obj.effective_priority,
                    position_in_cluster_queue=pos,
                    position_in_local_queue=lq_pos))
        return PendingWorkloadsSummary(cluster_queue=cq_name, items=items)

    def pending_workloads_for_lq(self, namespace: str,
                                 lq_name: str) -> list:
        lq = self.engine.queues.local_queues.get(f"{namespace}/{lq_name}")
        if lq is None:
            return []
        summary = self.pending_workloads_for_cq(lq.cluster_queue)
        return [it for it in summary.items
                if it.local_queue == lq_name and it.namespace == namespace]


def capacity_summary(engine) -> list:
    """Per ClusterQueue x flavor x resource: usage against nominal quota
    (clusterqueue_controller.go:556 usage reporting)."""
    rows = []
    for name, cq in list(engine.cache.cluster_queues.items()):
        usage = engine.cache.usage_for_cq(name)
        for rg in cq.resource_groups:
            for fq in rg.flavors:
                for res, quota in fq.resources.items():
                    u = usage.get(FlavorResource(fq.name, res), 0)
                    rows.append({
                        "clusterQueue": name, "cohort": cq.cohort,
                        "flavor": fq.name, "resource": res,
                        "usage": u, "nominal": quota.nominal,
                        "borrowed": max(0, u - quota.nominal)})
    return rows


def cohort_tree(engine) -> list:
    """The cohort forest with aggregated subtree quota and usage (the
    cohort gauges of pkg/cache/scheduler/cohort_metrics.go, as JSON),
    memoized by the admitted-set and spec versions."""
    key = (engine.cache.admitted_version, engine.cache.spec_version)
    cached = _cohort_tree_memo.get(engine)
    if cached is not None and cached[0] == key:
        return cached[1]
    snap = engine.cache.snapshot()
    out = []
    for name, cs in sorted(snap.cohorts.items()):
        out.append({
            "name": name,
            "parent": cs.parent.name if cs.parent is not None else None,
            "fairWeight": cs.fair_weight,
            "childCohorts": sorted(c.name for c in cs.child_cohorts),
            "childCQs": sorted(c.name for c in cs.child_cqs),
            "subtreeQuota": {f"{fr.flavor}/{fr.resource}": v
                             for fr, v in cs.node.subtree_quota.items()},
            "usage": {f"{fr.flavor}/{fr.resource}": v
                      for fr, v in cs.node.usage.items()},
        })
    _cohort_tree_memo[engine] = (key, out)
    return out


def eviction_summary(engine) -> list:
    """Evictions by ClusterQueue x reason (evicted_workloads_total),
    summed over the custom-label suffixes of the counter's keys."""
    ctr = engine.registry.counter("evicted_workloads_total")
    agg: dict[tuple, float] = {}
    for labels, v in list(ctr.values.items()):
        key = (labels[0] if labels else "",
               labels[1] if len(labels) > 1 else "")
        agg[key] = agg.get(key, 0.0) + v
    return [{"clusterQueue": cq, "reason": reason, "count": v}
            for (cq, reason), v in sorted(agg.items())]


def oracle_stats(engine) -> dict:
    """Device-path diagnostics: cycle counts, fallback and host-root
    reasons, the last cycle's phase split, and (beyond the JAX
    package's view) the speculation pipeline's counts."""
    b = engine.oracle
    if b is None:
        return {"attached": False}
    return {"attached": True,
            "cyclesOnDevice": b.cycles_on_device,
            "cyclesFallback": b.cycles_fallback,
            "cyclesHybrid": b.cycles_hybrid,
            "fallbackReasons": dict(b.fallback_reasons),
            "hostRootReasons": dict(b.host_root_reasons),
            "lastCyclePhases": dict(engine.last_cycle_phases),
            "pipelineStats": dict(b.pipeline_stats)}


def dump_state(engine) -> dict:
    """pkg/debugger/debugger.go:42: the queues and the admitted set, the
    last cycle's phase timings and the unadmitted workloads per
    (ClusterQueue, reason, cause)."""
    queues = {}
    for name, pcq in engine.queues.cluster_queues.items():
        queues[name] = {
            "active": sorted(pcq.items),
            "inadmissible": sorted(pcq.inadmissible),
        }
    admitted = {}
    for key, info in engine.cache.workloads.items():
        admitted[key] = {
            "clusterQueue": info.cluster_queue,
            "usage": {f"{fr.flavor}/{fr.resource}": q
                      for fr, q in info.usage().items()},
        }
    return {"queues": queues, "admitted": admitted,
            "lastCyclePhases": dict(engine.last_cycle_phases),
            "unadmittedByReason": {
                "/".join(k): v for k, v in engine.unadmitted.per_cq.items()}}


def trace_summary(engine) -> dict:
    """The /debug/trace body: retained per-cycle span trees from the
    attached CycleTracer (obs/), oldest first, plus enough envelope for
    a client to know what it is looking at."""
    tracer = getattr(engine, "tracer", None)
    if tracer is None:
        return {"enabled": False, "cycles": []}
    cycles = tracer.trees()
    for row in cycles:
        # Lift the correlation id to the row envelope: the browser-side
        # join key against journal cycle_trace records, flight-recorder
        # frames and SSE summaries, without digging into attrs.
        row["cid"] = row.get("attrs", {}).get("cid")
    return {"enabled": True,
            "retain": tracer.retain,
            "cyclesTraced": tracer.cycles_traced,
            "lastCid": tracer.last_cid,
            "cycles": cycles}


def perf_summary(engine) -> dict:
    """The /debug/perf body: apply sub-phase histogram aggregates from
    the attached PerfRecorder (obs.perf)."""
    perf = getattr(engine, "perf", None)
    if perf is None:
        return {"enabled": False}
    return {"enabled": True, **perf.summary()}


def slo_summary(engine) -> dict:
    """The /debug/slo body: declarative objectives with their
    multi-window burn rates (obs.slo), plus the overload posture —
    degradation-ladder rung and cycle-watchdog breaker — when those
    components are attached (the one endpoint answering "how degraded
    are we, and why")."""
    slo = getattr(engine, "slo", None)
    out = {"enabled": False} if slo is None else {
        "enabled": True, **slo.summary()}
    ladder = getattr(engine, "ladder", None)
    if ladder is not None:
        out["ladder"] = ladder.status()
    watchdog = getattr(engine, "watchdog", None)
    if watchdog is not None:
        out["watchdog"] = watchdog.status()
    budget = getattr(getattr(engine, "journal", None), "budget", None)
    if budget is not None and budget.enabled:
        out["diskBudget"] = budget.status()
    shedder = getattr(engine, "shedder", None)
    if shedder is not None:
        out["shedder"] = shedder.status()
    return out
