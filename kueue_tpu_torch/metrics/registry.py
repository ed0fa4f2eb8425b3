"""Metrics: the framework's Prometheus-equivalent series.

A copy of ``kueue_tpu/metrics/registry.py`` (pkg/metrics/metrics.go:
345-870): admission attempts and their duration, pending / admitted /
evicted / preempted counts, wait-time histograms, per-CQ resource usage
and the north-star self-metrics. Every family the JAX package registers
is registered here too, and ``render()`` lists every family, empty ones
included, under the same ``kueue_tpu_`` prefix: scrapes and dashboards
read one exposition from either package.

Standalone design: a tiny in-process registry with counters, gauges and
histograms, exposable as Prometheus text format (render()).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Counter:
    name: str
    help: str = ""
    values: dict[tuple, float] = field(default_factory=lambda:
                                       defaultdict(float))

    def inc(self, labels: tuple = (), amount: float = 1.0) -> None:
        self.values[labels] += amount

    def get(self, labels: tuple = ()) -> float:
        return self.values.get(labels, 0.0)


@dataclass
class Gauge:
    name: str
    help: str = ""
    values: dict[tuple, float] = field(default_factory=dict)

    def set(self, labels: tuple, value: float) -> None:
        self.values[labels] = value

    def get(self, labels: tuple = ()) -> float:
        return self.values.get(labels, 0.0)

    def clear(self) -> None:
        """Drop every series (families fully re-populated each sync —
        stale keys must disappear, the prometheus DeletePartialMatch
        analog)."""
        self.values.clear()


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60, 300,
                   1800)

# Fixed log-spaced edges for the perf-telemetry histograms (obs.perf):
# quarter-decade steps spanning 1µs..10s. The edges are a compile-time
# constant — never derived from observed data — so histograms from any
# two runs/processes are bucket-compatible and merge by plain
# element-wise addition.
PERF_BUCKETS = tuple(round(10.0 ** (k / 4.0), 12) for k in range(-24, 5))


@dataclass
class Histogram:
    name: str
    help: str = ""
    buckets: tuple = DEFAULT_BUCKETS
    counts: dict[tuple, list] = field(default_factory=dict)
    sums: dict[tuple, float] = field(default_factory=lambda:
                                     defaultdict(float))
    totals: dict[tuple, int] = field(default_factory=lambda:
                                     defaultdict(int))

    def observe(self, value: float, labels: tuple = ()) -> None:
        if labels not in self.counts:
            self.counts[labels] = [0] * (len(self.buckets) + 1)
        idx = bisect.bisect_left(self.buckets, value)
        self.counts[labels][idx] += 1
        self.sums[labels] += value
        self.totals[labels] += 1

    def observe_many(self, values, labels: tuple = ()) -> None:
        """Bulk observation: one vectorized bucket pass for a whole
        serving cycle's samples (the per-entry loop the reference pays
        at scheduler.go:856 is amortized here)."""
        if len(values) < 64:
            # numpy dispatch overhead dwarfs bisect below this size (the
            # per-LocalQueue series typically get a handful of samples).
            for v in values:
                self.observe(v, labels)
            return
        import numpy as np

        vals = np.asarray(values, dtype=np.float64)
        if labels not in self.counts:
            self.counts[labels] = [0] * (len(self.buckets) + 1)
        idx = np.searchsorted(np.asarray(self.buckets), vals, side="left")
        binned = np.bincount(idx, minlength=len(self.buckets) + 1)
        row = self.counts[labels]
        for i, c in enumerate(binned):
            if c:
                row[i] += int(c)
        self.sums[labels] += float(vals.sum())
        self.totals[labels] += int(vals.size)

    def quantile(self, q: float, labels: tuple = ()) -> float:
        """Approximate quantile from bucket counts (upper bound).

        The zero-total case is guarded explicitly: with total == 0 the
        target q*total is 0 and ``acc >= target`` holds at the very
        first bucket, returning buckets[0] instead of the 0.0 an empty
        series must report (a race-visible state — a scraper can land
        between a concurrent observe creating counts[labels] and the
        total increment)."""
        counts = self.counts.get(labels)
        if not counts:
            return 0.0
        total = self.totals.get(labels, 0)
        if total <= 0:
            return 0.0
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc and acc >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")

    def reset(self, labels: Optional[tuple] = None) -> None:
        """Drop one series, or every series (test isolation)."""
        if labels is None:
            self.counts.clear()
            self.sums.clear()
            self.totals.clear()
        else:
            self.counts.pop(labels, None)
            self.sums.pop(labels, None)
            self.totals.pop(labels, None)


@dataclass(frozen=True)
class CustomLabelEntry:
    """configuration_types.go (ControllerMetricsCustomLabel): one extra
    Prometheus label sourced from object metadata."""

    name: str
    source_label_key: str = ""
    source_annotation_key: str = ""


class CustomMetricLabels:
    """pkg/metrics/custom_labels.go: extract configured extra label
    values from an object's labels/annotations; rendered as
    ``custom_<name>="value"`` pairs appended to supported series."""

    def __init__(self, entries: list[CustomLabelEntry]):
        self.entries = list(entries)

    def extract(self, labels: dict, annotations: dict) -> tuple:
        """custom_labels.go:88 ExtractValues, as render-ready pairs."""
        out = []
        for e in self.entries:
            if e.source_annotation_key:
                val = (annotations or {}).get(e.source_annotation_key, "")
            else:
                val = (labels or {}).get(
                    e.source_label_key or e.name, "")
            out.append((f"custom_{e.name}", val))
        return tuple(out)

    def for_object(self, obj) -> tuple:
        if not self.entries:
            return ()
        if obj is None:
            # A deleted/unknown object still gets the configured pairs
            # (empty-valued): every series in a family must carry the
            # same label set or the exposition is invalid.
            return self.extract({}, {})
        return self.extract(getattr(obj, "labels", {}),
                            getattr(obj, "annotations", {}))


class MetricsRegistry:
    """The kueue metric families (metrics.go), standalone."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        c, g, h = self._counter, self._gauge, self._histogram
        # scheduler north-star metrics (metrics.go:345-383)
        c("admission_attempts_total", "scheduling attempts by result")
        h("admission_attempt_duration_seconds", "cycle latency by result")
        c("admission_cycle_preemption_skips",
          "preemptions skipped per cycle per CQ")
        h("scheduler_phase_duration_seconds",
          "per-cycle phase durations (snapshot|decide|apply|encode|device)")
        # workload lifecycle
        c("quota_reserved_workloads_total", "per CQ")
        h("quota_reserved_wait_time_seconds", "queued->reserved per CQ")
        c("admitted_workloads_total", "per CQ")
        h("admission_wait_time_seconds", "queued->admitted per CQ")
        h("admission_checks_wait_time_seconds", "reserved->admitted per CQ")
        c("evicted_workloads_total", "per CQ x reason")
        c("evicted_workloads_once_total",
          "first eviction per workload, per CQ x reason")
        c("preempted_workloads_total", "per preempting CQ x reason")
        c("finished_workloads_total", "per CQ x reason")
        h("workload_eviction_latency_seconds",
          "admitted->evicted per CQ x reason")
        h("workload_creation_latency_seconds", "creation->queued")
        c("replaced_workload_slices_total", "elastic slice swaps per CQ")
        c("workloads_dispatched_total", "MultiKueue dispatches per mode")
        # queue state
        g("pending_workloads", "per CQ x status(active|inadmissible)")
        g("reserving_active_workloads", "per CQ")
        g("admitted_active_workloads", "per CQ")
        g("cluster_queue_status", "per CQ x status")
        g("unadmitted_workloads", "per CQ x reason x cause")
        # LocalQueue mirrors (metrics.go local_queue_* families)
        g("local_queue_pending_workloads", "per LQ x status")
        c("local_queue_quota_reserved_workloads_total", "per LQ")
        h("local_queue_quota_reserved_wait_time_seconds", "per LQ")
        c("local_queue_admitted_workloads_total", "per LQ")
        h("local_queue_admission_wait_time_seconds", "per LQ")
        c("local_queue_evicted_workloads_total", "per LQ x reason")
        c("local_queue_finished_workloads_total", "per LQ x reason")
        g("local_queue_reserving_active_workloads", "per LQ")
        g("local_queue_admitted_active_workloads", "per LQ")
        g("local_queue_status", "per LQ x status")
        g("local_queue_unadmitted_workloads", "per LQ x reason x cause")
        g("local_queue_resource_usage", "per LQ x flavor x resource")
        g("local_queue_resource_reservation", "per LQ x flavor x resource")
        g("local_queue_admission_fair_sharing_usage", "decayed AFS usage")
        # resource state (per CQ x flavor x resource)
        g("cluster_queue_resource_usage", "")
        g("cluster_queue_resource_reservation", "")
        g("cluster_queue_resource_pending", "")
        g("cluster_queue_nominal_quota", "")
        g("cluster_queue_borrowing_limit", "")
        g("cluster_queue_lending_limit", "")
        g("cluster_queue_weighted_share", "fair sharing share per CQ")
        # cohort hierarchy (metrics.go:892-940)
        g("cohort_weighted_share", "per cohort")
        g("cohort_subtree_quota", "per cohort x flavor x resource")
        g("cohort_subtree_resource_reservations",
          "per cohort x flavor x resource")
        g("cohort_subtree_admitted_active_workloads", "per cohort")
        g("cohort_info", "parent edge per cohort")
        g("cluster_queue_info", "cohort membership per CQ")
        g("build_info", "framework build identity")
        c("ready_wait_time_seconds_total", "admitted->ready")
        # span-derived exemplar families (obs.tracer): traced cycles
        # per decision path and workload decision spans per outcome
        c("trace_cycles_total", "traced scheduling cycles per mode")
        c("trace_workload_decisions_total",
          "traced workload decision spans per outcome")
        # oracle fast-path posture: the bridge's diagnostic dicts
        # (fallback_reasons / host_root_reasons / cycle counts),
        # promoted from bench-only detail blobs to first-class series.
        c("oracle_cycles_total",
          "oracle-path cycles per mode (device|hybrid|fallback)")
        c("oracle_fallback_total", "whole-cycle fallbacks per reason")
        c("oracle_host_root_total",
          "cohort roots demoted to the host path per reason")
        # perf telemetry (obs.perf): apply-phase micro-attribution and
        # device-side counters. The subphase histogram uses the fixed
        # log-spaced PERF_BUCKETS so series merge across processes.
        h("apply_subphase_duration_seconds",
          "apply-phase sub-step durations per (subphase, mode)",
          buckets=PERF_BUCKETS)
        c("perf_kernel_launches_total", "device program launches per site")
        c("perf_transfer_bytes_total",
          "host<->device transfer bytes per (site, direction)")
        c("perf_jit_cache_events_total",
          "jit shape-signature cache events per (site, outcome)")
        c("perf_tas_cycle_mix_total",
          "TAS placement cycles per kind (batched|host_fallback)")
        # SLO engine (obs.slo): declarative objectives over multi-window
        # burn rates.
        g("slo_burn_rate", "error-budget burn rate per (objective, window)")
        g("slo_status",
          "objective status per objective (0 ok | 1 warn | 2 breach)")
        g("slo_objective_target", "declared target per objective")
        # HA serving plane (kueue_tpu/ha): replica role and lease
        # fencing state, follower replay lag, sharded SSE fanout
        # accounting, and submit-path load shedding.
        g("ha_role",
          "replica role (0 follower | 1 leader | 2 candidate | 3 fenced)")
        g("ha_lease_epoch", "fencing epoch of the HA lease")
        c("ha_role_transitions_total", "role transitions per (from, to)")
        g("ha_replay_lag_records",
          "journal records not yet folded into the follower read model")
        g("sse_clients_connected", "fanout hub subscribers")
        c("sse_events_dropped_total",
          "events dropped on full client/shard queues")
        c("sse_clients_evicted_total", "slow consumers evicted")
        c("admission_shed_total", "submissions shed per reason")
        g("admission_shed_factor",
          "current SLO-driven rate factor on the submit token bucket")
        # Bounded-time recovery (store/checkpoint.py + oracle
        # supervisor): sealed checkpoint cadence and the device
        # circuit-breaker lifecycle.
        c("checkpoints_written_total", "sealed checkpoints written")
        c("checkpoint_failures_total",
          "checkpoint write failures per errno name")
        g("checkpoint_last_seq", "cycle seq of the newest checkpoint")
        c("oracle_retry_total", "executor call retries per site")
        c("oracle_breaker_transitions_total",
          "breaker transitions per (from, to)")
        g("oracle_breaker_state",
          "breaker state (0 closed | 1 open | 2 half-open)")
        # Federation dispatcher (kueue_tpu/federation): per-cell health
        # and breaker lifecycle, route-state population, and the
        # dispatch/redispatch/revocation flow of cross-cell handoffs.
        g("federation_cell_up", "cell availability per cell (0|1)")
        g("federation_cell_breaker_state",
          "per-cell breaker state (0 closed | 1 open | 2 half-open)")
        c("federation_breaker_transitions_total",
          "per-cell breaker transitions per (cell, from, to)")
        c("federation_dispatch_total",
          "workload handoffs attempted per (cell, outcome)")
        c("federation_redispatch_total",
          "routes re-pointed off a drained/dead cell per cell")
        c("federation_revocations_total",
          "zombie-cell admissions revoked on rejoin per cell")
        g("federation_routes", "routes per state (intent|acked|admitted)")
        h("federation_handoff_latency_seconds",
          "intent-durable to cell-ack latency per cell")
        # Overload survival (obs/watchdog.py, ha/ladder.py,
        # store/diskguard.py, visibility/fanout.py): cycle watchdog
        # breaker lifecycle, the degradation-ladder rung, disk-budget
        # read-only posture, and suppressed SSE detail chatter.
        c("watchdog_cycle_overruns_total",
          "completed cycles past the deadline per mode")
        c("watchdog_hung_cycles_total",
          "in-flight cycles past the hang threshold")
        g("watchdog_state",
          "watchdog breaker state (0 closed | 1 open | 2 half-open)")
        c("watchdog_transitions_total",
          "watchdog breaker transitions per (from, to)")
        c("watchdog_demotions_total",
          "watchdog demotions per offending cycle mode")
        g("overload_ladder_rung",
          "degradation rung (0 normal | 1 trace | 2 fanout | "
          "3 submit | 4 device)")
        c("overload_ladder_transitions_total",
          "ladder rung transitions per (from, to)")
        g("disk_budget_state",
          "disk budget state (0 armed | 1 degraded)")
        c("disk_budget_transitions_total",
          "disk budget transitions per resulting state")
        c("sse_detail_suppressed_total",
          "detail events suppressed at the fanout boundary per kind")
        # Global read plane (kueue_tpu/readplane): staleness-bounded
        # query replicas. The staleness histogram shares PERF_BUCKETS
        # so per-replica series merge; the visibility counter is the
        # leader-side proof of zero read traffic (it must stay flat on
        # a leader fronted by the read plane).
        h("readplane_staleness_seconds",
          "advertised staleness bound per answered query",
          buckets=PERF_BUCKETS)
        h("readplane_query_duration_seconds",
          "read-query service latency per kind",
          buckets=PERF_BUCKETS)
        c("readplane_queries_total", "read queries per (kind, result)")
        g("readplane_replay_lag_records",
          "journal records durable but not folded into the replica "
          "read model")
        g("readplane_last_applied_age_seconds",
          "wall age of the replica read model's rebuild point")
        h("readplane_rebuild_seconds",
          "read-model rebuild (checkpoint base + suffix) durations",
          buckets=PERF_BUCKETS)
        c("readplane_frontend_routes_total",
          "front-end read routings per (target, reason)")
        c("visibility_queries_total",
          "engine-backed read queries served per route class")
        self.gauge("build_info").set(
            (("name", "kueue_tpu"), ("version", "0.2.0")), 1)

    def _counter(self, name, help=""):
        self._metrics[name] = Counter(name, help)

    def _gauge(self, name, help=""):
        self._metrics[name] = Gauge(name, help)

    def _histogram(self, name, help="", buckets=None):
        if buckets is None:
            self._metrics[name] = Histogram(name, help)
        else:
            self._metrics[name] = Histogram(name, help, buckets=buckets)

    def __getitem__(self, name: str):
        return self._metrics[name]

    def counter(self, name: str) -> Counter:
        return self._metrics[name]

    def gauge(self, name: str) -> Gauge:
        return self._metrics[name]

    def histogram(self, name: str) -> Histogram:
        return self._metrics[name]

    # -- update hooks used by the engine --

    def report_admission_attempt(self, result: str, seconds: float) -> None:
        self.counter("admission_attempts_total").inc((result,))
        self.histogram("admission_attempt_duration_seconds").observe(
            seconds, (result,))

    def report_pending(self, cq: str, active: int, inadmissible: int) -> None:
        self.gauge("pending_workloads").set((cq, "active"), active)
        self.gauge("pending_workloads").set((cq, "inadmissible"),
                                            inadmissible)

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        # The exposition name users' scrapes read: the JAX package's.
        prefix = "kueue_tpu_"
        for name, metric in sorted(self._metrics.items()):
            lines.append(f"# HELP {prefix}{name} {metric.help}")
            if isinstance(metric, Counter):
                lines.append(f"# TYPE {prefix}{name} counter")
                for labels, v in sorted(metric.values.items()):
                    lines.append(f"{prefix}{name}{_fmt(labels)} {v}")
            elif isinstance(metric, Gauge):
                lines.append(f"# TYPE {prefix}{name} gauge")
                for labels, v in sorted(metric.values.items()):
                    lines.append(f"{prefix}{name}{_fmt(labels)} {v}")
            else:
                lines.append(f"# TYPE {prefix}{name} histogram")
                for labels, counts in sorted(metric.counts.items()):
                    acc = 0
                    for i, b in enumerate(metric.buckets):
                        acc += counts[i]
                        lines.append(
                            f"{prefix}{name}_bucket"
                            f"{_fmt(labels + (('le', b),))} {acc}")
                    # The mandatory +Inf bucket (== _count): scrapers
                    # reject a histogram without it.
                    lines.append(
                        f"{prefix}{name}_bucket"
                        f"{_fmt(labels + (('le', '+Inf'),))} "
                        f"{acc + counts[len(metric.buckets)]}")
                    lines.append(
                        f"{prefix}{name}_sum{_fmt(labels)} "
                        f"{metric.sums[labels]}")
                    lines.append(
                        f"{prefix}{name}_count{_fmt(labels)} "
                        f"{metric.totals[labels]}")
        return "\n".join(lines) + "\n"


def _esc(value) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote and newline must appear as \\\\, \\" and
    \\n inside the quoted value (exposition_formats.md) — unescaped
    they truncate the value or split the sample line, producing
    exposition text scrapers reject."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(labels: tuple) -> str:
    if not labels:
        return ""
    parts = []
    for i, item in enumerate(labels):
        if isinstance(item, tuple) and len(item) == 2:
            parts.append(f'{item[0]}="{_esc(item[1])}"')
        else:
            parts.append(f'label_{i}="{_esc(item)}"')
    return "{" + ",".join(parts) + "}"
