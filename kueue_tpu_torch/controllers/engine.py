"""The standalone control-plane engine: queue manager + cache + scheduler
cycle + workload lifecycle, wired together in-process.

A trimmed copy of ``kueue_tpu/controllers/engine.py`` for the port's
serving path: object admin, submit / finish / tick on the engine clock,
eviction and preemption, and ``schedule_once`` through the batched
oracle (``attach_oracle``, an ``oracle/engine_bridge.OracleBridge`` over
a ``TorchExecutor``) or the sequential host cycle, topology-aware
scheduling included (``create_topology`` / ``create_node`` /
``delete_node``, topology requests placed by the host descent or, in a
device cycle, by the batched TAS planner), WorkloadPriorityClasses,
admission fair sharing (``controllers/afs.AfsManager`` attaches itself
and orders AFS-scoped ClusterQueues by LocalQueue usage) and admission
checks (``controllers/admissionchecks.AdmissionCheckManager``: quota is
reserved, and Admitted follows once every check is Ready;
``reconcile_workload`` evicts on Retry and Rejected), the durable
journal (``attach_journal``: every object creation and workload
transition is journaled as the JAX engine journals it, synced at each
non-idle cycle boundary; ``restore_workload`` is the rebuild path of
``store/journal.rebuild_engine``) and a remote oracle
(``attach_oracle(remote_address=...)``: a transport failure becomes a
``remote-error`` host cycle), the metrics registry (``registry``, a
``metrics.registry.MetricsRegistry`` written at the JAX engine's write
sites with its values, in its order; ``unadmitted``, the per-reason
unadmitted-workload gauges; ``sync_resource_metrics`` for the resource
and cohort gauges; phases timed on ``wall_clock``) and the columnar
apply of a device cycle's admitted batch (``controllers/colapply``,
``KUEUE_TPU_COLUMNAR``), and the TAS node lifecycle: non-TAS pod usage
(``observe_pod`` / ``observe_pod_deleted``), node failures
(``mark_node_unhealthy``, fed by ``controllers/tas_nodes``) and the
second pass that re-places the lost pods at the top of the next cycle
(``_process_second_pass``). ``schedule_once`` has the JAX engine's
capture points (``pre_cycle_hooks``, ``pre_sync_hooks``,
``cycle_listeners``) and its disk-budget gate (the journal's
``writable()`` parks a cycle), the event listeners (``event_listeners``,
fired with each EngineEvent as the JAX engine fires them; a listener
that raises only warns) and the observability slots the obs layer
attaches to (``attach_tracer``, ``attach_perf``, ``attach_slo``,
``profiled``; ``watchdog``, ``ladder``, ``fanout`` and ``shedder``
attach themselves), with the JAX engine's perf scopes around the apply's
sub-steps. Decisions are the JAX package's engine's, cycle by cycle, and
nothing the obs layer records feeds back into one. Left out: the flight
recorder, pods-ready, MultiKueue, holds, LimitRanges and RuntimeClasses
(pod templates, which raise NotImplementedError) and the preemption
expectation store (evictions are observed synchronously).

Lifecycle semantics mirrored from the reference:
  * admit: set QuotaReserved + Admitted, write Admission, assume in cache
    (scheduler.go:856 admit, :920 assumeWorkload).
  * preemption: targets get Evicted/Preempted conditions, their usage is
    released, and they are requeued pending
    (preemption.go:194 IssuePreemptions + core/workload_controller.go).
  * finish: Finished condition, removal from cache, and inadmissible
    workloads of the cohort are re-queued (workload event handlers,
    core/workload_controller.go:1228+).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

from kueue_tpu_torch.api import types as _types
from kueue_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    Condition,
    LocalQueue,
    ResourceFlavor,
    Workload,
    WorkloadConditionType,
)
from kueue_tpu_torch.cache.queues import QueueManager
from kueue_tpu_torch.cache.scheduler_cache import Cache
from kueue_tpu_torch.obs import perf as _perf
from kueue_tpu_torch.scheduler.cycle import (
    CycleResult,
    EntryStatus,
    RequeueReason,
    SchedulerCycle,
)
from kueue_tpu_torch.workload_info import (
    WorkloadInfo,
    admission_from_assignment,
)


def _call_observer(what: str, fn, seq: int, result) -> None:
    """Run a pre-sync hook or cycle listener: an observer that raises
    must not unwind the scheduling loop, so its error becomes a
    warning."""
    try:
        fn(seq, result)
    except Exception as e:  # noqa: BLE001 — observers only
        import warnings
        warnings.warn(f"{what} {fn!r} raised: {e!r}")


def _call_listener(fn, ev) -> None:
    """Run one event listener: a handler that raises must not unwind the
    scheduling cycle (client-go informers isolate handler panics the
    same way), so its error becomes a warning."""
    try:
        fn(ev)
    except Exception as e:  # noqa: BLE001 — listeners only
        import warnings
        warnings.warn(f"event listener {fn!r} raised: {e!r}")


@dataclass
class EngineEvent:
    time: float
    kind: str  # Admitted | Preempted | Requeued | Finished | Submitted
    workload: str
    cluster_queue: str = ""
    detail: str = ""


@dataclass
class EngineMetrics:
    """The north-star self-metrics (pkg/metrics/metrics.go:345-383)."""

    admission_attempts_total: int = 0
    admission_cycles: int = 0
    admissions_total: int = 0
    preemptions_total: int = 0
    admission_cycle_preemption_skips: dict[str, int] = field(
        default_factory=dict)


class _BulkAdmitCtx:
    """Per-cycle state of the batched serving path: the Condition
    instances every admission of the cycle shares, the Admission
    flyweights, and the metric, unadmitted-gauge and journal writes that
    flush_bulk_admit applies once."""

    __slots__ = ("qr_cond", "adm_cond", "reset_conds", "counts", "waits",
                 "removed_unadmitted", "journal_keys", "admissions")

    def __init__(self, now: float):
        self.qr_cond = Condition(
            type=WorkloadConditionType.QUOTA_RESERVED, status=True,
            reason="QuotaReserved", last_transition_time=now)
        self.adm_cond = Condition(
            type=WorkloadConditionType.ADMITTED, status=True,
            reason="Admitted", last_transition_time=now)
        self.reset_conds = tuple(
            (ct, Condition(type=ct, status=False, reason="QuotaReserved",
                           last_transition_time=now))
            for ct in (WorkloadConditionType.EVICTED,
                       WorkloadConditionType.PREEMPTED,
                       WorkloadConditionType.BLOCKED_ON_PREEMPTION_GATES))
        # Per-family aggregation: {name: {labels: n}} and {name:
        # {labels: [values]}}, so the flush fetches each series once.
        self.counts: dict = {}
        self.waits: dict = {}
        self.removed_unadmitted: list = []
        self.journal_keys: list = []
        self.admissions: dict = {}  # (cq, assignment-id) -> Admission

    def count(self, name: str, labels: tuple, n: int = 1) -> None:
        fam = self.counts.get(name)
        if fam is None:
            fam = self.counts[name] = {}
        fam[labels] = fam.get(labels, 0) + n

    def wait(self, name: str, labels: tuple, value: float) -> None:
        fam = self.waits.get(name)
        if fam is None:
            fam = self.waits[name] = {}
        lst = fam.get(labels)
        if lst is None:
            fam[labels] = [value]
        else:
            lst.append(value)


class Engine:
    def __init__(self, enable_fair_sharing: bool = False, device=None,
                 config=None):
        """``config`` is an optional ``config.api.Configuration``; the
        engine reads its ``metrics_custom_labels``."""
        self.config = config
        self.queues = QueueManager()
        self.cache = Cache()
        # Where the TAS forests' tensors and the oracle live: CUDA unless
        # the caller asks for the CPU (here or in attach_oracle).
        self.device = device
        self.cache.set_tas_device(device)
        # When a cycle is active, cohort-inadmissible requeues triggered
        # by evictions are deferred to cycle end (one pass per distinct
        # cohort root instead of one per victim).
        self._deferred_cohort_requeue: Optional[set] = None
        self.cycle = SchedulerCycle(enable_fair_sharing=enable_fair_sharing)
        self.cycle.namespace_labels_of = \
            lambda ns: self.namespace_labels.get(ns)
        # Engine time: every decision reads this clock; callers advance
        # it (``eng.clock += dt`` / ``tick``).
        self.clock: float = 0.0
        # Wall-clock source for phase timing and metrics, which no
        # decision reads; a caller may inject another (a fixed-step
        # clock makes the phase histograms deterministic).
        import time as _time
        self.wall_clock: Callable[[], float] = _time.perf_counter
        self.events: list[EngineEvent] = []
        # Watch fan-out (client-go informer analog): called with each
        # EngineEvent as it is recorded.
        self.event_listeners: list[Callable] = []
        self.metrics = EngineMetrics()
        from kueue_tpu_torch.cache.unadmitted import UnadmittedWorkloads
        from kueue_tpu_torch.metrics.registry import (
            CustomMetricLabels,
            MetricsRegistry,
        )
        self.registry = MetricsRegistry()
        self.unadmitted = UnadmittedWorkloads(self.registry)
        # Extra metric labels from CQ metadata (pkg/metrics/
        # custom_labels.go), configured via metrics.customLabels.
        self.custom_labels = CustomMetricLabels(
            config.metrics_custom_labels if config is not None else [])
        self._cq_labels_cache = None  # (spec_version, {cq: labels})
        # First-eviction-per-workload tracking
        # (evicted_workloads_once_total, metrics.go:666).
        self._evicted_once: set[str] = set()
        self._serving_gc = False  # apply_serving_gc_posture() active
        # Last cycle's phase durations, and which path decided it:
        # "sequential", "device", or "hybrid" (device roots + host tail).
        self.last_cycle_phases: dict[str, float] = {}
        self.last_cycle_mode: str = ""
        # Cycles attempted (idle ones included): the supervisor's clock.
        self.cycle_seq: int = 0
        # Capture points around schedule_once: pre_cycle_hooks fire with
        # (seq, engine) before each attempt; pre_sync_hooks with (seq,
        # result) after a non-idle cycle, before journal.sync(), so what
        # they append rides inside the cycle's fsync; cycle_listeners
        # with (seq, result) after the sync, result None for an idle or
        # parked cycle (store/checkpoint.Checkpointer listens here).
        self.pre_cycle_hooks: list[Callable] = []
        self.pre_sync_hooks: list[Callable] = []
        self.cycle_listeners: list[Callable] = []
        # The obs layer attaches itself here: the admission tracer
        # (obs.tracer.CycleTracer), perf telemetry (obs.perf), the SLO
        # engine (obs.slo), the cycle watchdog (obs.watchdog), the
        # degradation ladder (ha.ladder), the SSE fanout hub
        # (visibility.fanout) and the submit-path shedder (ha.shedder).
        self.tracer = None
        self.perf = None
        self.slo = None
        self.watchdog = None
        self.ladder = None
        self.fanout = None
        self.shedder = None
        # The HA replica that promoted this engine (ha/replica.py sets it;
        # None outside HA mode, where a lease-stall fault raises).
        self.ha = None
        # Durable store (store/journal.py), via attach_journal(), and the
        # periodic checkpoint writer (store/checkpoint.Checkpointer
        # attaches itself here).
        self.journal = None
        self.checkpointer = None
        self.workloads: dict[str, Workload] = {}
        # hook: called with (workload, admission) after each admission.
        self.on_admit: Optional[Callable] = None
        # AdmissionCheckManager attaches itself here (two-phase admission).
        self.admission_checks = None
        # AfsManager attaches itself here (admission fair sharing).
        self.afs = None
        # WorkloadPriorityClass registry (workloadpriorityclass_types.go).
        self.workload_priority_classes: dict[str, int] = {}
        # OracleBridge (batched device path), via attach_oracle().
        self.oracle = None
        # Second-pass retry bookkeeping (second_pass_queue.go backoff).
        self._second_pass_attempts: dict[str, int] = {}
        # Namespace labels for CQ namespace-selector admissibility
        # (set_namespace_labels; a namespace without labels matches no
        # non-empty selector).
        self.namespace_labels: dict[str, dict[str, str]] = {}

    # -- durability (store/journal.py) --

    def attach_journal(self, journal, record_existing: bool = True) -> None:
        """Journal every object creation and workload status transition.
        With ``record_existing``, the engine's current state is written
        first (a journal introduced after boot)."""
        self.journal = journal
        if record_existing:
            for cohort in self.cache.cohorts.values():
                journal.apply("cohort", cohort, ts=self.clock)
            for rf in self.cache.resource_flavors.values():
                journal.apply("resource_flavor", rf, ts=self.clock)
            for cq in self.cache.cluster_queues.values():
                journal.apply("cluster_queue", cq, ts=self.clock)
            for lq in self.queues.local_queues.values():
                journal.apply("local_queue", lq, ts=self.clock)
            for topo in self.cache.topologies.values():
                journal.apply("topology", topo, ts=self.clock)
            for node in self.cache.nodes.values():
                journal.apply("node", node, ts=self.clock)
            for name, value in self.workload_priority_classes.items():
                journal.apply("workload_priority_class",
                              {"name": name, "value": value},
                              ts=self.clock)
            for wl in self.workloads.values():
                journal.apply("workload", wl, ts=self.clock)

    def _journal_obj(self, kind: str, obj) -> None:
        if self.journal is not None:
            self.journal.apply(kind, obj, ts=self.clock)

    def restore_workload(self, wl: Workload) -> None:
        """The rebuild path (restart recovery): re-register a workload
        from durable state without resetting its status. Admitted
        workloads re-assume their cache usage, pending active ones
        re-enter the queues with their requeue backoff intact."""
        self.workloads[wl.key] = wl
        if wl.is_finished:
            return
        if wl.status.admission is not None:
            self.cache.add_or_update_workload(wl)
            if wl.status.unhealthy_nodes:
                # Pending node replacement: re-arm the second pass
                # (mark_node_unhealthy had queued it before the restart).
                info = WorkloadInfo.from_workload(
                    wl, wl.status.admission.cluster_queue)
                self.queues.second_pass.prequeue(wl.key)
                self.queues.second_pass.queue(info, now=self.clock)
        elif wl.active:
            self.queues.add_or_update_workload(wl)

    # -- object admin --

    def create_cluster_queue(self, cq: ClusterQueue) -> None:
        self.cache.add_or_update_cluster_queue(cq)
        self.queues.add_cluster_queue(cq)
        self._journal_obj("cluster_queue", cq)

    def create_cohort(self, cohort: Cohort) -> None:
        self.cache.add_or_update_cohort(cohort)
        self._journal_obj("cohort", cohort)

    def create_resource_flavor(self, rf: ResourceFlavor) -> None:
        self.cache.add_or_update_resource_flavor(rf)
        # A CQ may have been inactive for referencing this flavor
        # (inactiveReason FlavorNotFound): re-queue parked workloads.
        self.queues.queue_inadmissible_workloads()
        self._journal_obj("resource_flavor", rf)

    def create_local_queue(self, lq: LocalQueue) -> None:
        self.queues.add_local_queue(lq)
        self._journal_obj("local_queue", lq)

    def create_topology(self, topology) -> None:
        self.cache.add_or_update_topology(topology)
        self.queues.queue_inadmissible_workloads()
        self._journal_obj("topology", topology)

    def create_node(self, node) -> None:
        """Node lifecycle (tas/node_controller.go)."""
        self.cache.add_or_update_node(node)
        self.queues.queue_inadmissible_workloads()
        self._journal_obj("node", node)

    def observe_pod(self, pod) -> None:
        """Non-TAS pod usage intake (tas/non_tas_usage_controller.go):
        pods not managed by TAS consume node capacity that the TAS
        placement must not double-book. Re-queues inadmissible TAS
        workloads only when totals actually moved."""
        from kueue_tpu_torch.tas.non_tas_usage import NonTASUsageController
        if NonTASUsageController(self.cache).pod_event(pod):
            self.queues.queue_inadmissible_workloads()

    def observe_pod_deleted(self, namespace: str, name: str) -> None:
        from kueue_tpu_torch.tas.non_tas_usage import NonTASUsageController
        if NonTASUsageController(self.cache).pod_deleted(namespace, name):
            self.queues.queue_inadmissible_workloads()

    def delete_node(self, name: str) -> None:
        self.cache.delete_node(name)
        self.queues.queue_inadmissible_workloads()
        if self.journal is not None:
            self.journal.delete("node", name, ts=self.clock)

    def mark_node_unhealthy(self, name: str, reason: str = "") -> None:
        """tas/node_controller.go: a node failed — record it on every
        admitted TAS workload placed there (status.unhealthyNodes,
        workload_types.go:766) and arm the second-pass queue so the next
        scheduling pass runs the replacement algorithm.

        kube_features.go TASFailedNodeReplacement (the parent gate of
        the per-trigger TASReplaceNode* gates) disables only the
        replacement machinery — the node stops receiving new placements
        either way."""
        from kueue_tpu_torch.config import features
        if not features.enabled("TASFailedNodeReplacement"):
            self.cache.set_node_ready(name, False)
            # Persist the not-ready state: a restart must not resurrect
            # the dead node as placeable.
            node = self.cache.nodes.get(name)
            if node is not None:
                self._journal_obj("node", node)
            self._event("NodeUnhealthy", "", detail=name)
            return
        self.cache.delete_node(name)
        if self.journal is not None:
            self.journal.delete("node", name, ts=self.clock)
        for wl in self.workloads.values():
            if wl.is_finished or wl.status.admission is None:
                continue
            touched = any(
                dom.values[-1] == name
                for psa in wl.status.admission.pod_set_assignments
                if psa.topology_assignment is not None
                for dom in psa.topology_assignment.domains)
            if touched and name not in wl.status.unhealthy_nodes:
                wl.status.unhealthy_nodes = \
                    wl.status.unhealthy_nodes + (name,)
                info = WorkloadInfo.from_workload(
                    wl, wl.status.admission.cluster_queue)
                self.queues.second_pass.prequeue(wl.key)
                self.queues.second_pass.queue(info, now=self.clock)
                self._event("NodeUnhealthy", wl.key,
                            cluster_queue=info.cluster_queue,
                            detail=f"{name}: {reason}")
        self.queues.queue_inadmissible_workloads()

    def _process_second_pass(self) -> None:
        """Replacement pass for workloads with unhealthy nodes
        (scheduler.go second-pass handling + tas_flavor_snapshot.go:747).
        On success the admission's TopologyAssignments are patched in
        place (pods on healthy nodes keep running); on failure either
        fail-fast evict (TASFailedNodeReplacementFailFast) or retry with
        backoff. The replacement places through find_topology_assignments,
        so on the device program when the TAS path says so."""
        from kueue_tpu_torch.config import features
        from kueue_tpu_torch.tas.snapshot import TASPodSetRequest

        for info in self.queues.second_pass.take_all_ready(self.clock):
            wl = self.workloads.get(info.key)
            if wl is None or wl.is_finished \
                    or wl.status.admission is None \
                    or not wl.status.unhealthy_nodes:
                continue
            snapshot = self.cache.snapshot()
            by_flavor: dict[str, list[TASPodSetRequest]] = {}
            for i, psa in enumerate(wl.status.admission.pod_set_assignments):
                if psa.topology_assignment is None:
                    continue
                flavor = next((f for f in psa.flavors.values()
                               if f in snapshot.tas_flavors), None)
                if flavor is None:
                    continue
                by_flavor.setdefault(flavor, []).append(TASPodSetRequest(
                    wl.pod_sets[i],
                    info.total_requests[i].single_pod_requests(),
                    psa.count))
            reason = ""
            patches: dict[str, object] = {}
            try:
                for flavor in sorted(by_flavor):
                    # One grouped call per flavor: the replacement path
                    # threads a shared assumed-usage dict across the
                    # workload's pod sets so two replacements can't
                    # double-book one free slot.
                    results, reason = snapshot.tas_flavors[flavor] \
                        .find_topology_assignments_for_flavor(
                            by_flavor[flavor], workload=wl)
                    if reason:
                        break
                    patches.update(results)
            finally:
                snapshot.close()
            if reason:
                if features.enabled("TASFailedNodeReplacementFailFast"):
                    # Clear before evicting so the journaled eviction
                    # state is final.
                    wl.status.unhealthy_nodes = ()
                    self.evict(wl, "NodeFailureReplacementFailed")
                else:
                    attempt = self._second_pass_attempts.get(info.key, 0) + 1
                    self._second_pass_attempts[info.key] = attempt
                    self.queues.second_pass.prequeue(info.key)
                    self.queues.second_pass.queue(info, now=self.clock,
                                                  iteration=attempt)
                continue
            adm = wl.status.admission
            wl.status.admission = replace(adm, pod_set_assignments=tuple(
                replace(psa, topology_assignment=patches[psa.name])
                if psa.name in patches else psa
                for psa in adm.pod_set_assignments))
            self._second_pass_attempts.pop(info.key, None)
            replaced = ", ".join(wl.status.unhealthy_nodes)
            wl.status.unhealthy_nodes = ()
            self.cache.add_or_update_workload(wl)
            self._event("NodeReplaced", wl.key,
                        cluster_queue=info.cluster_queue, detail=replaced)

    # -- workload lifecycle --

    def create_workload_priority_class(self, name: str, value: int) -> None:
        self.workload_priority_classes[name] = value
        self._journal_obj("workload_priority_class",
                          {"name": name, "value": value})

    def set_namespace_labels(self, namespace: str,
                             labels: dict[str, str]) -> None:
        """Namespace (re)labeled: workloads parked for a selector
        mismatch can only be cured by this event, so requeue the
        inadmissible sets of every selector-bearing CQ (the reference
        requeues on Namespace update events)."""
        self.namespace_labels[namespace] = dict(labels)
        sel_cqs = {n for n, cq in self.cache.cluster_queues.items()
                   if cq.namespace_selector is not None}
        if sel_cqs:
            self.queues.queue_inadmissible_workloads(sel_cqs)

    def submit(self, wl: Workload) -> bool:
        if not wl.creation_time:
            wl.creation_time = self.clock
        for ps in wl.pod_sets:
            if ps.template is not None:
                raise NotImplementedError(
                    "pod templates (LimitRanges, RuntimeClass overheads) "
                    "are not ported")
        # Resolve priorityClassRef (pkg/util/priority). An explicitly
        # named class always resolves — this is not gated.
        if (wl.priority_class_name
                and wl.priority_class_name in self.workload_priority_classes):
            wl.priority = self.workload_priority_classes[
                wl.priority_class_name]
        self.workloads[wl.key] = wl
        info = self.queues.add_or_update_workload(wl)
        if info is None:
            # Registered but unqueued (unknown LocalQueue): persist so a
            # restarted engine carries the same object.
            self._journal_obj("workload", wl)
            return False
        self.registry.histogram("workload_creation_latency_seconds").observe(
            max(0.0, self.clock - wl.creation_time))
        # status.resourceRequests: the effective totals at consideration
        # time (workload_types.go:886 PodSetRequest).
        wl.status.resource_requests = {
            psr.name: dict(psr.requests) for psr in info.total_requests}
        self._track_unadmitted(wl, info.cluster_queue, "NoReservation")
        self._event("Submitted", wl.key,
                    cluster_queue=info.cluster_queue)
        return True

    def _track_unadmitted(self, wl: Workload, cq_name: str,
                          reason: str, cause: str = "") -> None:
        """unadmitted_workloads.go:75 (update)."""
        from kueue_tpu_torch.cache.unadmitted import UnadmittedStatus

        self.unadmitted.update(wl.key, UnadmittedStatus(
            cluster_queue=cq_name, local_queue=wl.queue_name,
            namespace=wl.namespace, reason=reason, cause=cause))

    def _lq_key(self, wl: Workload) -> tuple:
        return (f"{wl.namespace}/{wl.queue_name}",)

    def _lq_metrics_on(self) -> bool:
        # kube_features.go LocalQueueMetrics: every per-LocalQueue
        # series family, event-time and sync-time alike.
        from kueue_tpu_torch.config import features
        return features.enabled("LocalQueueMetrics")

    def _custom_cq_labels(self, cq_name: str) -> tuple:
        # kube_features.go CustomMetricLabels, memoized by (spec
        # version, gate state): label values come from CQ metadata.
        from kueue_tpu_torch.config import features
        on = features.enabled("CustomMetricLabels")
        ver = (self.cache.spec_version, on)
        cached = self._cq_labels_cache
        if cached is None or cached[0] != ver:
            cached = (ver, {})
            self._cq_labels_cache = cached
        labels = cached[1].get(cq_name)
        if labels is None:
            if not on:
                labels = ()
            else:
                labels = self.custom_labels.for_object(
                    self.cache.cluster_queues.get(cq_name))
            cached[1][cq_name] = labels
        return labels

    def finish(self, key: str) -> None:
        wl = self.workloads.get(key)
        if wl is None:
            return
        finished = wl.condition(WorkloadConditionType.FINISHED)
        reason = (finished.reason if finished is not None and finished.reason
                  else "Succeeded")
        wl.set_condition(WorkloadConditionType.FINISHED, True,
                         reason=reason, now=self.clock)
        cq_name = (wl.status.admission.cluster_queue
                   if wl.status.admission else "")
        self.cache.delete_workload(key)
        self.queues.delete_workload(wl)
        self.unadmitted.remove(key)
        self._evicted_once.discard(wl.uid)  # bound the set to live objects
        self.registry.counter("finished_workloads_total").inc(
            (cq_name, reason))
        if self._lq_metrics_on():
            self.registry.counter(
                "local_queue_finished_workloads_total").inc(
                self._lq_key(wl) + (reason,))
        self._event("Finished", key, cluster_queue=cq_name)
        self._requeue_cohort_inadmissible(cq_name)

    # -- the scheduling loop --

    def tick(self, dt: float) -> None:
        """Advance the clock and enforce maximum execution time
        (workload_controller.go:838 reconcileMaxExecutionTime)."""
        self.clock += dt
        if not _types.budgets_given():
            # No workload in this process was ever given a budget: none
            # can exceed one, and the scan below (a dict lookup per
            # admitted workload, every serve loop iteration) finds none.
            return
        # The budget test first, in one pass: most admitted workloads
        # carry none, and the condition scans below are the costly part
        # of a tick over tens of thousands of admitted workloads.
        budgeted = [wl for wl in map(self.workloads.get,
                                     list(self.cache.workloads))
                    if wl is not None
                    and wl.maximum_execution_time_seconds is not None]
        for wl in budgeted:
            if not wl.is_admitted or wl.is_finished:
                continue
            max_s = wl.maximum_execution_time_seconds
            adm = wl.condition(WorkloadConditionType.ADMITTED)
            spent = wl.status.accumulated_past_execution_time_seconds
            if adm and spent + (self.clock - adm.last_transition_time) \
                    > max_s:
                wl.active = False
                self.evict(wl, "MaximumExecutionTimeExceeded",
                           requeue=False)

    def attach_oracle(self, max_depth: int = 4, device=None,
                      remote_address: Optional[tuple] = None) -> None:
        """Enable the batched device path for scheduling cycles: an
        OracleBridge over a TorchExecutor on ``device`` (the engine's
        device when not given: CUDA unless the caller asks for the CPU;
        raises when CUDA is absent), or, with ``remote_address`` ((host,
        port)), over a RemoteExecutor to an oracle sidecar
        (oracle/service.py); the bridge then encodes on the engine's
        device. The TAS forests move to the same device. Executor calls
        go through the bridge's supervisor: a transport failure becomes
        a ``remote-error`` host cycle; any other executor error
        propagates out of schedule_once."""
        from kueue_tpu_torch.oracle.engine_bridge import OracleBridge
        from kueue_tpu_torch.oracle.service import (
            RemoteExecutor,
            TorchExecutor,
        )

        if device is not None:
            self.device = device
            self.cache.set_tas_device(device)
        if remote_address is not None:
            executor = RemoteExecutor(*remote_address)
        else:
            executor = TorchExecutor(self.device)
        self.oracle = OracleBridge(self, executor, max_depth=max_depth)

    def attach_tracer(self, retain: int = 64, **kwargs):
        """Enable admission tracing: per-cycle span trees with decision
        rationale (obs.CycleTracer), retained in a bounded ring and
        served at /debug/trace and by ``obs.explain``."""
        from kueue_tpu_torch.obs import attach_tracer
        return attach_tracer(self, retain=retain, **kwargs)

    def attach_perf(self):
        """Enable perf telemetry (obs.perf.PerfRecorder): apply-phase
        sub-step histograms and device-side counters, on /metrics."""
        from kueue_tpu_torch.obs.perf import attach_perf
        return attach_perf(self)

    def attach_slo(self, **kwargs):
        """Enable the SLO engine (obs.slo.SLOEngine): declarative
        objectives evaluated over multi-window burn rates, on /metrics
        and /debug/slo."""
        from kueue_tpu_torch.obs.slo import attach_slo
        return attach_slo(self, **kwargs)

    @contextmanager
    def profiled(self, trace_dir: Optional[str] = None):
        """Context manager: a ``torch.profiler`` session around
        everything inside, written as a Chrome trace into the directory
        (utils.structlog.device_trace; CUDA kernels included unless the
        engine runs on the CPU). Directory precedence: explicit arg >
        Configuration.profile_dir > KUEUE_TPU_PROFILE; none of them
        set, it profiles nothing."""
        import os as _os

        from kueue_tpu_torch.utils.structlog import device_trace

        trace_dir = (trace_dir
                     or (self.config.profile_dir if self.config else None)
                     or _os.environ.get("KUEUE_TPU_PROFILE"))
        with device_trace(trace_dir or None, device=self.device):
            yield

    def schedule_once(self) -> Optional[CycleResult]:
        """One schedule() cycle (scheduler.go:286), bracketed as the JAX
        engine brackets it: the pre-cycle hooks; the journal's
        ``writable()`` gate, which parks the cycle as idle while the
        disk budget is degraded (``cycle_seq`` still advances and the
        listeners still run, with None); the cycle; after a non-idle
        cycle the pre-sync hooks and the journal's crash-safe sync; then
        the cycle listeners. A hook or listener that raises becomes a
        warning."""
        seq = self.cycle_seq
        for fn in tuple(self.pre_cycle_hooks):
            fn(seq, self)
        writable = getattr(self.journal, "writable", None)
        if writable is not None and not writable():
            # Scheduling would admit workloads the journal cannot
            # record: park, and let the next gate probe re-arm.
            result = None
        elif not self._serving_gc:
            result = self._schedule_once_impl()
        else:
            try:
                result = self._schedule_once_impl()
            finally:
                # Serving GC posture: sweep the young generation and
                # re-freeze survivors after every cycle.
                import gc
                gc.collect(0)
                gc.freeze()
        self.cycle_seq = seq + 1
        if result is not None and self.journal is not None:
            for fn in tuple(self.pre_sync_hooks):
                _call_observer("pre-sync hook", fn, seq, result)
            # Every record this cycle wrote reaches the disk before the
            # decisions take further effect: a SIGKILL between cycles
            # never loses an applied admission.
            self.journal.sync()
        for fn in tuple(self.cycle_listeners):
            _call_observer("cycle listener", fn, seq, result)
        return result

    def _schedule_once_impl(self) -> Optional[CycleResult]:
        self._process_second_pass()
        if self.oracle is not None:
            from kueue_tpu_torch.oracle.service import RemoteOracleError

            t0 = self.wall_clock()
            try:
                result = self.oracle.try_cycle()
            except RemoteOracleError:
                # Transport failure before any verdict was applied: the
                # sequential path owns this cycle.
                self.oracle._fallback("remote-error")
                result = None
            if result is not None:
                if not result.entries and not result.inadmissible:
                    return None  # idle
                self.metrics.admission_cycles += 1
                outcome = ("success" if result.stats.admitted
                           else "inadmissible")
                self.registry.report_admission_attempt(
                    outcome, self.wall_clock() - t0)
                return result
            self.oracle.cycles_fallback += 1
            self.registry.counter("oracle_cycles_total").inc(("fallback",))

        heads = self.queues.heads(self.clock)
        if not heads:
            return None
        return self._sequential_cycle(heads)

    def _sequential_cycle(self, heads, count_cycle: bool = True) \
            -> CycleResult:
        """The sequential decision path for a set of popped heads. Also
        used by the oracle bridge for the host-handled cohort roots of a
        hybrid cycle (roots never interact, so running them after the
        device roots is cycle-equivalent); the bridge passes
        count_cycle=False."""
        t0 = self.wall_clock()
        if count_cycle:
            self.metrics.admission_cycles += 1
            self.last_cycle_mode = "sequential"
        snapshot = self.cache.snapshot()
        t_snap = self.wall_clock()
        already = set(self.cache.workloads)
        try:
            result = self.cycle.schedule(heads, snapshot, now=self.clock,
                                         already_admitted=already)
        finally:
            snapshot.close()
        t_decide = self.wall_clock()
        deferred: set = set()
        self._deferred_cohort_requeue = deferred
        try:
            for e in result.entries:
                self.metrics.admission_attempts_total += 1
                if e.status == EntryStatus.ASSUMED:
                    self._admit(e)
                elif e.status == EntryStatus.PREEMPTING:
                    self._issue_preemptions(e)
                    self._requeue(e)
                else:
                    self._requeue(e)
            for e in result.inadmissible:
                self._requeue(e)
        finally:
            self._deferred_cohort_requeue = None
        self._requeue_cohorts_bulk(deferred)
        for cq_name, skips in result.stats.preemption_skips.items():
            m = self.metrics.admission_cycle_preemption_skips
            m[cq_name] = m.get(cq_name, 0) + skips
            self.registry.counter("admission_cycle_preemption_skips").inc(
                (cq_name,), skips)
        # A hybrid cycle's host tail (count_cycle=False) must not
        # overwrite the bridge's phase record.
        if count_cycle:
            t_apply = self.wall_clock()
            phases = {"snapshot": t_snap - t0,
                      "decide": t_decide - t_snap,
                      "apply": t_apply - t_decide}
            self.last_cycle_phases = phases
            for phase, dur in phases.items():
                self.registry.histogram(
                    "scheduler_phase_duration_seconds").observe(
                    dur, (phase,))
            outcome = "success" if result.assumed else "inadmissible"
            self.registry.report_admission_attempt(
                outcome, self.wall_clock() - t0)
        for name, pcq in self.queues.cluster_queues.items():
            self.registry.report_pending(name, len(pcq.items),
                                         len(pcq.inadmissible))
            self.registry.gauge("admitted_active_workloads").set(
                (name,), self.cache.admitted_count(name))
        return result

    def sync_resource_metrics(self) -> None:
        """Refresh the per-CQ / per-LQ / cohort resource and share gauges
        from a fresh snapshot (the metrics.go:796-948 families; the
        reference's cache controllers update these on reconcile). All
        values are collected into fresh tables first and swapped into the
        registry at the end: an exception mid-collection leaves the
        previous aggregates intact, and stale series for deleted objects
        vanish on swap."""
        from collections import defaultdict

        from kueue_tpu_torch.cache.snapshot import dominant_resource_share

        snap = self.cache.snapshot()
        fams: dict[str, dict] = defaultdict(dict)
        # kube_features.go LocalQueueMetrics: skip the per-LQ aggregation
        # entirely when off (the family swap below still clears stale
        # series).
        lq_on = self._lq_metrics_on()

        lq_pending: dict = {}
        lq_reserving: dict = {}
        lq_admitted: dict = {}
        for name, cqs in snap.cluster_queues.items():
            fams["cluster_queue_info"][(name, cqs.spec.cohort or "")] = 1
            # Reservation = every quota-reserved workload's usage;
            # usage = admitted-only (metrics.go:796,814).
            admitted_usage: dict = {}
            reserving = 0
            admitted_n = 0
            lq_reservation: dict = {}
            lq_usage: dict = {}
            for key, info in cqs.workloads.items():
                wl = self.workloads.get(key)
                is_admitted = wl is not None and wl.is_admitted
                reserving += 1
                if lq_on:
                    lq = f"{info.obj.namespace}/{info.obj.queue_name}"
                    lq_reserving[lq] = lq_reserving.get(lq, 0) + 1
                    if is_admitted:
                        lq_admitted[lq] = lq_admitted.get(lq, 0) + 1
                if is_admitted:
                    admitted_n += 1
                for fr, v in info.usage().items():
                    if lq_on:
                        lq_reservation[(lq, fr)] = \
                            lq_reservation.get((lq, fr), 0) + v
                        if is_admitted:
                            lq_usage[(lq, fr)] = \
                                lq_usage.get((lq, fr), 0) + v
                    if is_admitted:
                        admitted_usage[fr] = admitted_usage.get(fr, 0) + v
            for fr, v in cqs.node.usage.items():
                fams["cluster_queue_resource_reservation"][
                    (name, fr.flavor, fr.resource)] = v
            for fr, v in admitted_usage.items():
                fams["cluster_queue_resource_usage"][
                    (name, fr.flavor, fr.resource)] = v
            for (lq, fr), v in lq_reservation.items():
                fams["local_queue_resource_reservation"][
                    (lq, fr.flavor, fr.resource)] = v
            for (lq, fr), v in lq_usage.items():
                fams["local_queue_resource_usage"][
                    (lq, fr.flavor, fr.resource)] = v
            fams["reserving_active_workloads"][(name,)] = reserving
            for fr, q in cqs.node.quotas.items():
                fams["cluster_queue_nominal_quota"][
                    (name, fr.flavor, fr.resource)] = q.nominal
                if q.borrowing_limit is not None:
                    fams["cluster_queue_borrowing_limit"][
                        (name, fr.flavor, fr.resource)] = q.borrowing_limit
                if q.lending_limit is not None:
                    fams["cluster_queue_lending_limit"][
                        (name, fr.flavor, fr.resource)] = q.lending_limit
            # Pending per resource + per LocalQueue (metrics.go:805,409).
            pcq = self.queues.cluster_queues.get(name)
            if pcq is not None:
                pending: dict = {}
                for status, table in (("active", pcq.items),
                                      ("inadmissible", pcq.inadmissible)):
                    for info in list(table.values()):
                        if lq_on:
                            lq = (f"{info.obj.namespace}/"
                                  f"{info.obj.queue_name}")
                            lq_pending[(lq, status)] = \
                                lq_pending.get((lq, status), 0) + 1
                        for psr in info.total_requests:
                            for res, v in psr.requests.items():
                                pending[res] = pending.get(res, 0) + v
                for res, v in pending.items():
                    fams["cluster_queue_resource_pending"][(name, res)] = v
            drs = dominant_resource_share(cqs, None)
            share = (drs.precise_weighted_share()
                     if cqs.fair_weight else drs.unweighted_ratio)
            fams["cluster_queue_weighted_share"][(name,)] = share

        for (lq, status), n in lq_pending.items():
            fams["local_queue_pending_workloads"][(lq, status)] = n
        for lq, n in lq_reserving.items():
            fams["local_queue_reserving_active_workloads"][(lq,)] = n
        for lq, n in lq_admitted.items():
            fams["local_queue_admitted_active_workloads"][(lq,)] = n
        if self.afs is not None and lq_on:
            for lq, entry in self.afs.usage.items():
                fams["local_queue_admission_fair_sharing_usage"][(lq,)] = \
                    self.afs.current_usage(lq)

        # kube_features.go MetricsForCohorts.
        from kueue_tpu_torch.config import features
        cohort_items = (snap.cohorts.items()
                        if features.enabled("MetricsForCohorts") else ())
        for name, cohort in cohort_items:
            fams["cohort_info"][
                (name, cohort.parent.name if cohort.parent else "")] = 1
            for fr, v in cohort.node.subtree_quota.items():
                fams["cohort_subtree_quota"][
                    (name, fr.flavor, fr.resource)] = v
            for fr, v in cohort.node.usage.items():
                fams["cohort_subtree_resource_reservations"][
                    (name, fr.flavor, fr.resource)] = v
            admitted = sum(
                1 for cqs in cohort.subtree_cluster_queues()
                for key in cqs.workloads
                if (w := self.workloads.get(key)) is not None
                and w.is_admitted)
            fams["cohort_subtree_admitted_active_workloads"][
                (name,)] = admitted
            drs = dominant_resource_share(cohort, None)
            share = (drs.precise_weighted_share()
                     if cohort.fair_weight else drs.unweighted_ratio)
            fams["cohort_weighted_share"][(name,)] = share

        # Atomic swap per family (empty tables drop stale series too).
        for fam in ("cluster_queue_info", "cluster_queue_resource_usage",
                    "cluster_queue_resource_reservation",
                    "cluster_queue_resource_pending",
                    "cluster_queue_nominal_quota",
                    "cluster_queue_borrowing_limit",
                    "cluster_queue_lending_limit",
                    "cluster_queue_weighted_share",
                    "local_queue_resource_usage",
                    "local_queue_resource_reservation",
                    "local_queue_pending_workloads",
                    "local_queue_reserving_active_workloads",
                    "local_queue_admitted_active_workloads",
                    "local_queue_admission_fair_sharing_usage",
                    "reserving_active_workloads", "cohort_info",
                    "cohort_subtree_quota",
                    "cohort_subtree_resource_reservations",
                    "cohort_subtree_admitted_active_workloads",
                    "cohort_weighted_share"):
            self.registry.gauge(fam).values = fams.get(fam, {})

    def run_until_quiescent(self, max_cycles: int = 10_000) -> int:
        """Drive cycles until no progress is possible (tests/bench)."""
        cycles = 0
        while cycles < max_cycles:
            result = self.schedule_once()
            cycles += 1
            if result is None:
                break
            if not result.assumed and not any(
                    e.status == EntryStatus.PREEMPTING
                    for e in result.entries):
                break
        return cycles

    # -- internals --

    def apply_serving_gc_posture(self) -> None:
        """Serving-daemon GC posture: freeze the long-lived world so
        generational collections stop scanning it mid-cycle; automatic
        collection is then disabled and replaced by a young-generation
        sweep + re-freeze after every serving cycle."""
        import gc

        gc.collect()
        gc.freeze()
        gc.disable()
        self._serving_gc = True

    def begin_bulk_admit(self) -> _BulkAdmitCtx:
        """Open the bulk-admission context of one serving cycle; its
        journal writes are applied once, by flush_bulk_admit."""
        return _BulkAdmitCtx(self.clock)

    def flush_bulk_admit(self, ctx: _BulkAdmitCtx) -> None:
        """The cycle's deferred metric and unadmitted-gauge writes, then
        one journal record per workload the cycle touched, in first
        touch order, in one batched write."""
        for name, fam in ctx.counts.items():
            values = self.registry.counter(name).values
            for labels, n in fam.items():
                values[labels] += n
        for name, fam in ctx.waits.items():
            hist = self.registry.histogram(name)
            for labels, values in fam.items():
                hist.observe_many(values, labels)
        if ctx.removed_unadmitted:
            self.unadmitted.remove_many(ctx.removed_unadmitted)
        if self.journal is None:
            return
        _pt = _perf.begin()
        wls = [wl for wl in (self.workloads.get(key)
                             for key in dict.fromkeys(ctx.journal_keys))
               if wl is not None]
        self.journal.apply_many("workload", wls, ts=self.clock)
        _perf.end("apply.journal_append", _pt)

    def bulk_assume_batch(self, entries, bulk: _BulkAdmitCtx) -> list:
        """In-cycle half of a device cycle's admitted batch: remove the
        workloads from the pending world and assume them in the cache
        (scheduler.go:920 assumeWorkload). Returns the (entry, admission)
        pairs for bulk_finalize_batch. Entries with reclaimable pods,
        preemption targets or configured admission checks take the exact
        per-entry _admit path.

        The batch is applied in columns by default (controllers/colapply);
        KUEUE_TPU_COLUMNAR=0 takes the per-entry loop,
        _assume_batch_serial. Both leave the same state."""
        from kueue_tpu_torch.controllers import colapply

        if colapply.columnar_enabled():
            return colapply.columnar_assume_batch(self, entries, bulk)
        return self._assume_batch_serial(entries, bulk)

    def _assume_batch_serial(self, entries, bulk: _BulkAdmitCtx) -> list:
        """The per-entry assume loop (the KUEUE_TPU_COLUMNAR=0 arm)."""
        if not entries:
            return []
        cache = self.cache
        queues = self.queues
        second_pass = queues.second_pass
        checks = self.admission_checks
        tas_names = cache._tas_flavor_names()
        workloads_reg = cache.workloads
        wl_usage = cache._wl_usage
        wl_tas = cache._wl_tas
        live_cqs = cache.cluster_queues
        # Persistent Admission flyweights: the stored assignment ref
        # keeps its id() from being recycled, so identity keys are safe.
        ver = cache.spec_version
        fly = getattr(self, "_admission_fly", None)
        if fly is None or fly[0] != ver:
            fly = (ver, {})
            self._admission_fly = fly
        fly = fly[1]
        if len(fly) > 65536:
            fly.clear()
        pairs: list = []
        slow: list = []
        for entry in entries:
            info = entry.info
            wl = info.obj
            if (wl.status.reclaimable_pods or entry.preemption_targets
                    or checks is not None
                    or wl.status.admission_check_states):
                slow.append(entry)
                continue
            key = wl.key
            cq_name = info.cluster_queue
            assignment = entry.assignment
            akey = (cq_name, id(assignment))
            ent = fly.get(akey)
            if ent is None or ent[0] is not assignment:
                admission = admission_from_assignment(
                    cq_name, assignment.pod_sets)
                fly[akey] = (assignment, admission)
            else:
                admission = ent[1]
            # status.admission is part of the assume state: the cache
            # accounting below reads it (tas_domains).
            wl.status.admission = admission
            trs = info.total_requests
            psas = admission.pod_set_assignments
            if len(trs) == len(psas):
                for psr, psa in zip(trs, psas):
                    psr.flavors = dict(psa.flavors)
            else:
                info.apply_admission(admission)
            # Pending world exit (the bridge resolved the CQ already).
            pcq = queues.cluster_queues.get(cq_name)
            if pcq is not None and (
                    key in pcq.items or key in pcq.inadmissible
                    or pcq.in_flight == key):
                pcq.delete_lazy(key)  # releases the tensor row too
            else:
                queues.delete_workload(wl)
            second_pass.delete(key)
            # Cache assume (add_or_update_workload inlined; the usage
            # dict is the assignment flyweight's, never mutated).
            if cq_name in live_cqs:
                if key in wl_usage:
                    cache._unaccount(key)
                workloads_reg[key] = info
                usage = assignment.usage
                cqu = cache.cq_usage.get(cq_name)
                if cqu is None:
                    cqu = cache.cq_usage[cq_name] = {}
                for fr, v in usage.items():
                    cqu[fr] = cqu.get(fr, 0) + v
                cqw = cache.cq_workloads.get(cq_name)
                if cqw is None:
                    cqw = cache.cq_workloads[cq_name] = {}
                cqw[key] = info
                wl_usage[key] = (cq_name, usage)
                cache.mark_admitted_dirty(key)
                if tas_names:
                    tas = info.tas_domains(tas_names)
                    if tas:
                        wl_tas[key] = tas
                        cache._account_tas(tas)
            pairs.append((entry, admission))
        if pairs:
            cache.admitted_version += 1
        for entry in slow:
            self.queues.delete_workload(entry.info.obj)
            self._admit(entry, bulk=bulk)
        return pairs

    def bulk_finalize_batch(self, pairs, bulk: _BulkAdmitCtx) -> None:
        """Status finalization of a device cycle's admitted batch
        (scheduler.go:870, the reference's async status PATCH): status
        conditions, events, the admission metrics and unadmitted gauges
        (deferred to flush_bulk_admit or written once per series) and
        the journal keys."""
        if not pairs:
            return
        now = self.clock
        qr_cond = bulk.qr_cond
        adm_cond = bulk.adm_cond
        reset_conds = bulk.reset_conds
        lq_on = self._lq_metrics_on()
        events = self.events
        # Snapshot: SSE handler threads append/remove listeners while
        # cycles iterate (client-go informers snapshot the same way).
        listeners = tuple(self.event_listeners)
        on_admit = self.on_admit
        journal_on = self.journal is not None
        QR = WorkloadConditionType.QUOTA_RESERVED
        ADM = WorkloadConditionType.ADMITTED
        # (cq, lq) -> [count, [wait values], [nonzero checks waits]]
        agg: dict[tuple, list] = {}
        removed_unadmitted = bulk.removed_unadmitted
        journal_keys = bulk.journal_keys
        n_admitted = 0
        _pt = _perf.begin()
        for entry, admission in pairs:
            info = entry.info
            wl = info.obj
            key = wl.key
            cq_name = info.cluster_queue
            conds = wl.status.conditions
            prev = conds.get(QR)
            if prev is None or not prev.status:
                conds[QR] = qr_cond
                checks_wait = 0.0
            else:
                # A live reservation keeps its transition time; the
                # admission-checks wait spans from it.
                checks_wait = now - prev.last_transition_time
                if checks_wait < 0.0:
                    checks_wait = 0.0
            for ctype, cond in reset_conds:
                # Reset only currently-True conditions.
                pc = conds.get(ctype)
                if pc is not None and pc.status:
                    conds[ctype] = cond
            ev_qr = EngineEvent(now, "QuotaReserved", key, cq_name)
            events.append(ev_qr)
            if journal_on:
                journal_keys.append(key)
            adm_cond_prev = conds.get(ADM)
            if adm_cond_prev is not None and adm_cond_prev.status:
                # Already admitted: QuotaReserved bookkeeping only.
                bulk.count("quota_reserved_workloads_total", (cq_name,))
                bulk.wait("quota_reserved_wait_time_seconds", (cq_name,),
                          max(0.0, now - wl.creation_time))
                if lq_on:
                    lq_l = (f"{wl.namespace}/{wl.queue_name}",)
                    bulk.count(
                        "local_queue_quota_reserved_workloads_total", lq_l)
                    bulk.wait(
                        "local_queue_quota_reserved_wait_time_seconds",
                        lq_l, max(0.0, now - wl.creation_time))
                for fn in listeners:
                    _call_listener(fn, ev_qr)
                continue
            conds[ADM] = adm_cond
            n_admitted += 1
            wait = now - wl.creation_time
            if wait < 0.0:
                wait = 0.0
            lq = f"{wl.namespace}/{wl.queue_name}"
            a = agg.get((cq_name, lq))
            if a is None:
                a = agg[(cq_name, lq)] = [1, [wait], []]
            else:
                a[0] += 1
                a[1].append(wait)
            if checks_wait > 0.0:
                a[2].append(checks_wait)
            removed_unadmitted.append(key)
            ev_adm = EngineEvent(now, "Admitted", key, cq_name)
            events.append(ev_adm)
            for fn in listeners:
                _call_listener(fn, ev_qr)
            for fn in listeners:
                _call_listener(fn, ev_adm)
            if on_admit is not None:
                on_admit(wl, admission)
        self.metrics.admissions_total += n_admitted
        self._flush_admission_metrics(agg, lq_on)
        _perf.end("apply.listener_fanout", _pt)

    def _flush_admission_metrics(self, agg: dict, lq_on: bool) -> None:
        """Direct registry writes for a batch's admission metric series:
        the families are fetched once and their label maps updated in
        place (one layer, no per-write tuple/registry churn)."""
        import bisect as _bisect

        reg = self.registry
        qr_total = reg.counter("quota_reserved_workloads_total").values
        adm_total = reg.counter("admitted_workloads_total").values
        hists = [
            reg.histogram("quota_reserved_wait_time_seconds"),
            reg.histogram("admission_wait_time_seconds"),
        ]
        checks_h = reg.histogram("admission_checks_wait_time_seconds")
        if lq_on:
            lq_qr_total = reg.counter(
                "local_queue_quota_reserved_workloads_total").values
            lq_adm_total = reg.counter(
                "local_queue_admitted_workloads_total").values
            lq_hists = [
                reg.histogram("local_queue_quota_reserved_wait_time_seconds"),
                reg.histogram("local_queue_admission_wait_time_seconds"),
            ]
        for (cq_name, lq), (n, waits, checks_waits) in agg.items():
            cq_l = (cq_name,)
            qr_total[cq_l] += n
            adm_total[cq_l + self._custom_cq_labels(cq_name)] += n
            for h in hists:
                counts = h.counts.get(cq_l)
                if counts is None:
                    counts = h.counts[cq_l] = [0] * (len(h.buckets) + 1)
                s = 0.0
                for v in waits:
                    counts[_bisect.bisect_left(h.buckets, v)] += 1
                    s += v
                h.sums[cq_l] += s
                h.totals[cq_l] += n
            # admission-checks wait: 0.0 for immediate admissions,
            # the real reservation-to-now span for second-pass ones.
            ccounts = checks_h.counts.get(cq_l)
            if ccounts is None:
                ccounts = checks_h.counts[cq_l] = \
                    [0] * (len(checks_h.buckets) + 1)
            ccounts[0] += n - len(checks_waits)
            if checks_waits:
                s = 0.0
                for v in checks_waits:
                    ccounts[_bisect.bisect_left(checks_h.buckets, v)] += 1
                    s += v
                checks_h.sums[cq_l] += s
            checks_h.totals[cq_l] += n
            if lq_on:
                lq_l = (lq,)
                lq_qr_total[lq_l] += n
                lq_adm_total[lq_l] += n
                for h in lq_hists:
                    counts = h.counts.get(lq_l)
                    if counts is None:
                        counts = h.counts[lq_l] = [0] * (len(h.buckets) + 1)
                    s = 0.0
                    for v in waits:
                        counts[_bisect.bisect_left(h.buckets, v)] += 1
                        s += v
                    h.sums[lq_l] += s
                    h.totals[lq_l] += n

    def _admit(self, entry, bulk: Optional[_BulkAdmitCtx] = None) -> None:
        """scheduler.go:856 (admit): reserve quota, assume in cache; the
        Admitted condition follows only when all AdmissionChecks are Ready
        (prepareWorkload :912)."""
        wl = entry.obj
        _pt = _perf.begin()
        if bulk is not None:
            akey = (entry.info.cluster_queue, id(entry.assignment))
            admission = bulk.admissions.get(akey)
            if admission is None:
                admission = admission_from_assignment(
                    entry.info.cluster_queue, entry.assignment.pod_sets)
                bulk.admissions[akey] = admission
        else:
            admission = admission_from_assignment(
                entry.info.cluster_queue, entry.assignment.pod_sets)
        wl.status.admission = admission
        if bulk is not None:
            prev = wl.status.conditions.get(
                WorkloadConditionType.QUOTA_RESERVED)
            if prev is None or not prev.status:
                wl.status.conditions[
                    WorkloadConditionType.QUOTA_RESERVED] = bulk.qr_cond
            for ctype, cond in bulk.reset_conds:
                if wl.has_condition(ctype):
                    wl.status.conditions[ctype] = cond
        else:
            wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, True,
                             reason="QuotaReserved", now=self.clock)
            # Reservation resets the active Evicted / Preempted / blocked-
            # on-gates conditions (workload.go:852-862).
            for ctype in (WorkloadConditionType.EVICTED,
                          WorkloadConditionType.PREEMPTED,
                          WorkloadConditionType.BLOCKED_ON_PREEMPTION_GATES):
                if wl.has_condition(ctype):
                    wl.set_condition(ctype, False, reason="QuotaReserved",
                                     now=self.clock)
        entry.info.apply_admission(admission)
        _perf.end("apply.diff_build", _pt)
        _pt = _perf.begin()
        self.cache.add_or_update_workload(wl, info=entry.info)
        # The workload left the pending world: free its tensor row.
        self.queues.rows.on_remove(wl.key)
        _perf.end("apply.rowcache_writeback", _pt)
        cq_name = entry.info.cluster_queue
        wait = max(0.0, self.clock - wl.creation_time)
        lq = self._lq_key(wl)
        if bulk is not None:
            self._event("QuotaReserved", wl.key, cluster_queue=cq_name,
                        defer_journal=bulk)
            bulk.count("quota_reserved_workloads_total", (cq_name,))
            bulk.wait("quota_reserved_wait_time_seconds", (cq_name,), wait)
            if self._lq_metrics_on():
                bulk.count("local_queue_quota_reserved_workloads_total", lq)
                bulk.wait("local_queue_quota_reserved_wait_time_seconds",
                          lq, wait)
        else:
            self._event("QuotaReserved", wl.key, cluster_queue=cq_name)
            self.registry.counter("quota_reserved_workloads_total").inc(
                (cq_name,))
            self.registry.histogram(
                "quota_reserved_wait_time_seconds").observe(wait, (cq_name,))
            if self._lq_metrics_on():
                self.registry.counter(
                    "local_queue_quota_reserved_workloads_total").inc(lq)
                self.registry.histogram(
                    "local_queue_quota_reserved_wait_time_seconds").observe(
                    wait, lq)
        if self.admission_checks is not None:
            # The UnsatisfiedChecks window exists only when checks can
            # defer the Admitted condition.
            self._track_unadmitted(wl, cq_name, "UnsatisfiedChecks")
            self.admission_checks.sync_states(wl, cq_name)
        self._sync_admitted(wl, cq_name, bulk=bulk)
        # Replace-old-slice after successful admission
        # (scheduler.go:558 replaceOldWorkloadSlice).
        for target in entry.preemption_targets:
            if target.reason == "WorkloadSliceReplaced":
                self.finish(target.workload.key)

    def _sync_admitted(self, wl: Workload, cq_name: str,
                       bulk: Optional[_BulkAdmitCtx] = None) -> None:
        """workload.SyncAdmittedCondition."""
        if wl.is_admitted:
            return
        # EVERY check state present in status must be Ready — including
        # states injected by external controllers for checks the CQ
        # doesn't configure (workload/admissionchecks.go:130
        # HasAllChecksReady iterates status, not the CQ's list).
        from kueue_tpu_torch.controllers.admissionchecks import CheckState
        if any(s != CheckState.READY
               for s in wl.status.admission_check_states.values()):
            return
        if (self.admission_checks is not None
                and not self.admission_checks.all_ready(wl, cq_name)):
            return
        self.metrics.admissions_total += 1
        wait = max(0.0, self.clock - wl.creation_time)
        lq = self._lq_key(wl)
        reserved = wl.condition(WorkloadConditionType.QUOTA_RESERVED)
        if bulk is not None:
            wl.status.conditions[WorkloadConditionType.ADMITTED] = \
                bulk.adm_cond
            bulk.count("admitted_workloads_total",
                       (cq_name,) + self._custom_cq_labels(cq_name))
            bulk.wait("admission_wait_time_seconds", (cq_name,), wait)
            if self._lq_metrics_on():
                bulk.count("local_queue_admitted_workloads_total", lq)
                bulk.wait("local_queue_admission_wait_time_seconds", lq,
                          wait)
            if reserved is not None:
                bulk.wait(
                    "admission_checks_wait_time_seconds", (cq_name,),
                    max(0.0, self.clock - reserved.last_transition_time))
            bulk.removed_unadmitted.append(wl.key)
            self._event("Admitted", wl.key, cluster_queue=cq_name,
                        defer_journal=bulk)
        else:
            wl.set_condition(WorkloadConditionType.ADMITTED, True,
                             reason="Admitted", now=self.clock)
            self.registry.counter("admitted_workloads_total").inc(
                (cq_name,) + self._custom_cq_labels(cq_name))
            self.registry.histogram("admission_wait_time_seconds").observe(
                wait, (cq_name,))
            if self._lq_metrics_on():
                self.registry.counter(
                    "local_queue_admitted_workloads_total").inc(lq)
                self.registry.histogram(
                    "local_queue_admission_wait_time_seconds").observe(
                    wait, lq)
            if reserved is not None:
                self.registry.histogram(
                    "admission_checks_wait_time_seconds").observe(
                    max(0.0, self.clock - reserved.last_transition_time),
                    (cq_name,))
            self.unadmitted.remove(wl.key)
            self._event("Admitted", wl.key, cluster_queue=cq_name)
        if self.on_admit is not None:
            self.on_admit(wl, wl.status.admission)

    def reconcile_workload(self, wl: Workload) -> None:
        """The workload-controller pass (core/workload_controller.go:257):
        check-based eviction (:901) and admitted-condition sync."""
        if wl.is_finished or wl.status.admission is None:
            return
        cq_name = wl.status.admission.cluster_queue
        from kueue_tpu_torch.controllers.admissionchecks import CheckState
        states = wl.status.admission_check_states
        required = (self.admission_checks.required_for(cq_name, wl)
                    if self.admission_checks else ())
        if any(states.get(c) == CheckState.REJECTED for c in required):
            wl.active = False
            self.evict(wl, "AdmissionCheckRejected", requeue=False)
            return
        if any(states.get(c) == CheckState.RETRY for c in required):
            # Honor the check's requeue backoff
            # (UpdateAdmissionCheckRequeueState, provisioning
            # controller.go:576): the next attempt waits out the delay.
            backoff = wl.status.check_retry_after_seconds
            wl.status.check_retry_after_seconds = 0.0
            self.evict(wl, "AdmissionCheckRetry", backoff_seconds=backoff)
            for c in required:
                if states.get(c) == CheckState.RETRY:
                    states[c] = CheckState.PENDING
            return
        self._sync_admitted(wl, cq_name)

    def evict(self, wl: Workload, reason: str, requeue: bool = True,
              backoff_seconds: float = 0.0, bulk=None) -> None:
        """Shared eviction path (pkg/workload/evict). The
        cohort-inadmissible requeue is deferred per cycle when a cycle
        is active."""
        cq_name = (wl.status.admission.cluster_queue
                   if wl.status.admission else "")
        _adm = wl.condition(WorkloadConditionType.ADMITTED)
        admitted_at = (_adm.last_transition_time
                       if _adm is not None and _adm.status else None)
        wl.status.eviction_counts[reason] = \
            wl.status.eviction_counts.get(reason, 0) + 1
        if admitted_at is not None:
            wl.status.accumulated_past_execution_time_seconds += \
                max(0.0, self.clock - admitted_at)
        wl.set_condition(WorkloadConditionType.EVICTED, True,
                         reason=reason, now=self.clock)
        wl.set_condition(WorkloadConditionType.ADMITTED, False,
                         reason=reason, now=self.clock)
        wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, False,
                         reason=reason, now=self.clock)
        wl.status.admission = None
        wl.status.admission_check_states = {}
        wl.status.admission_check_updates = {}
        self.cache.delete_workload(wl.key)
        if bulk is not None:
            bulk.count("evicted_workloads_total",
                       (cq_name, reason) + self._custom_cq_labels(cq_name))
            if self._lq_metrics_on():
                bulk.count("local_queue_evicted_workloads_total",
                           self._lq_key(wl) + (reason,))
        else:
            self.registry.counter("evicted_workloads_total").inc(
                (cq_name, reason) + self._custom_cq_labels(cq_name))
            if self._lq_metrics_on():
                self.registry.counter(
                    "local_queue_evicted_workloads_total").inc(
                    self._lq_key(wl) + (reason,))
        if wl.uid not in self._evicted_once:
            # Keyed by UID: a re-created workload under the same name is
            # a new object with its own first eviction (metrics.go:666).
            self._evicted_once.add(wl.uid)
            if bulk is not None:
                bulk.count("evicted_workloads_once_total",
                           (cq_name, reason))
            else:
                self.registry.counter("evicted_workloads_once_total").inc(
                    (cq_name, reason))
        if admitted_at is not None:
            if bulk is not None:
                bulk.wait("workload_eviction_latency_seconds",
                          (cq_name, reason),
                          max(0.0, self.clock - admitted_at))
            else:
                self.registry.histogram(
                    "workload_eviction_latency_seconds").observe(
                    max(0.0, self.clock - admitted_at), (cq_name, reason))
        self._event("Evicted", wl.key, cluster_queue=cq_name, detail=reason,
                    defer_journal=bulk)
        if requeue and wl.active:
            wl.status.requeue_count += 1
            if backoff_seconds:
                wl.status.requeue_at = self.clock + backoff_seconds
            self.queues.add_or_update_workload(wl)
            self._track_unadmitted(wl, cq_name, "Evicted", cause=reason)
            # The requeue bookkeeping changed status after the Evicted
            # record: persist the final state.
            if bulk is not None:
                bulk.journal_keys.append(wl.key)
            else:
                self._journal_obj("workload", wl)
        else:
            self.unadmitted.remove(wl.key)
        if self._deferred_cohort_requeue is not None:
            self._deferred_cohort_requeue.add(cq_name)
        else:
            self._requeue_cohort_inadmissible(cq_name)

    def _issue_preemptions(self, entry, bulk=None) -> None:
        """preemption.go:194 (IssuePreemptions) + the workload controller's
        requeue-after-evict. Evictions are observed synchronously, so no
        issued preemption is ever awaiting observation."""
        for target in entry.preemption_targets:
            if target.reason == "WorkloadSliceReplaced":
                # The old slice keeps running until the replacement admits.
                continue
            twl = self.workloads.get(target.workload.key)
            if twl is None or twl.is_finished:
                continue
            if twl.has_condition(WorkloadConditionType.EVICTED):
                continue  # preemption ongoing (preemption.go:209)
            twl.set_condition(WorkloadConditionType.PREEMPTED, True,
                              reason=target.reason, now=self.clock)
            self.evict(twl, "Preempted", bulk=bulk)
            self.metrics.preemptions_total += 1
            self._event("Preempted", twl.key,
                        cluster_queue=target.workload.cluster_queue,
                        detail=target.reason, defer_journal=bulk)

    def _requeue(self, entry) -> None:
        """scheduler.go:1016 (requeueAndUpdate)."""
        wl = entry.obj
        if wl.is_finished:
            return
        reason = entry.requeue_reason
        if (entry.status not in (EntryStatus.NOT_NOMINATED,
                                 EntryStatus.INADMISSIBLE)
                and reason == RequeueReason.GENERIC):
            reason = RequeueReason.FAILED_AFTER_NOMINATION
        if reason == RequeueReason.PREEMPTION_GATED:
            # scheduler.go:1046: surface the orchestrated-preemption
            # signal so a coordinator can open a gate.
            wl.set_condition(
                WorkloadConditionType.BLOCKED_ON_PREEMPTION_GATES, True,
                reason="PreemptionGated",
                message=entry.inadmissible_msg, now=self.clock)
        self.queues.requeue_workload(entry.info, reason)
        self._track_unadmitted(wl, entry.info.cluster_queue, reason.value)
        self._event("Requeued", wl.key,
                    cluster_queue=entry.info.cluster_queue,
                    detail=f"{reason.value}: {entry.inadmissible_msg}")

    def _cohort_root_of(self, cohort_name: str) -> str:
        """Root cohort of a (possibly implicit) cohort, from the live
        registries."""
        seen = set()
        name = cohort_name
        while name not in seen:
            seen.add(name)
            co = self.cache.cohorts.get(name)
            if co is None or not co.parent:
                return name
            name = co.parent
        return name  # defensive: cycle (webhooks reject these)

    def _requeue_cohorts_bulk(self, cq_names: set) -> None:
        """One inadmissible-requeue pass over the union of the evicting
        CQs' cohort subtrees (deduped across a whole cycle's victims)."""
        if not cq_names:
            return
        all_names: set = set()
        for cq_name in cq_names:
            cq = self.cache.cluster_queues.get(cq_name)
            if cq is None:
                continue
            if not cq.cohort:
                all_names.add(cq_name)
                continue
            root = self._cohort_root_of(cq.cohort)
            all_names.update(
                name for name, c in self.cache.cluster_queues.items()
                if c.cohort and self._cohort_root_of(c.cohort) == root)
            all_names.add(cq_name)
        if all_names:
            self.queues.queue_inadmissible_workloads(all_names)

    def _requeue_cohort_inadmissible(self, cq_name: str) -> None:
        """Capacity freed: re-activate inadmissible workloads of the cohort
        (manager.go QueueAssociatedInadmissibleWorkloadsAfter)."""
        cq = self.cache.cluster_queues.get(cq_name)
        if cq is None:
            return
        if not cq.cohort:  # None or "" — no cohort membership
            self.queues.queue_inadmissible_workloads({cq_name})
            return
        root = self._cohort_root_of(cq.cohort)
        names = {name for name, c in self.cache.cluster_queues.items()
                 if c.cohort and self._cohort_root_of(c.cohort) == root}
        names.add(cq_name)
        self.queues.queue_inadmissible_workloads(names)

    def _event(self, kind: str, workload: str, cluster_queue: str = "",
               detail: str = "", defer_journal=None) -> None:
        ev = EngineEvent(self.clock, kind, workload, cluster_queue, detail)
        self._record(ev)
        # Every workload transition flows through here: persist the
        # post-transition state. Bulk cycles defer the write to one
        # record per workload at flush time.
        if defer_journal is not None:
            defer_journal.journal_keys.append(workload)
        elif self.journal is not None and workload in self.workloads:
            _pt = _perf.begin()
            self.journal.apply("workload", self.workloads[workload],
                               ts=self.clock)
            _perf.end("apply.journal_append", _pt)
        _pt = _perf.begin()
        for fn in tuple(self.event_listeners):
            _call_listener(fn, ev)
        _perf.end("apply.listener_fanout", _pt)

    def _record(self, ev: EngineEvent) -> None:
        self.events.append(ev)
