"""MultiKueue: multi-cluster workload dispatch, modeled as an
AdmissionCheck on the manager cluster.

The port of ``kueue_tpu/controllers/multikueue.py``, decision for
decision: the worker clusters are the port's engines, each running its
own device cycles (the heads kernel once per dispatched call), and the
controller walks the manager's workloads in insertion order, as the JAX
one does. A remote copy keeps the manager workload's uid
(``copy.deepcopy``), so its candidate order on the worker ties on the
same uid rank in both packages.

Reference: pkg/controller/admissionchecks/multikueue (workload.go:185
wlReconciler, multikueuecluster.go remote clients) and
pkg/controller/workloaddispatcher (AllAtOnce / Incremental strategies,
incrementaldispatcher.go:50).

Semantics:
  * a manager-side Workload that reserves quota and carries the MultiKueue
    check is mirrored to the nominated worker clusters;
  * the first worker to ADMIT the copy wins; the other copies are removed
    (wlGroup.RemoveRemoteObjects :159) and the manager check flips Ready
    with clusterName recorded;
  * remote finish/failure is synced back to the manager workload;
  * losing a worker cluster evicts the manager workloads placed there and
    requeues them (worker-lost timeout, multikueuecluster.go:98).

Worker "clusters" are Engine instances — the same way the reference tests
multi-cluster with two envtest apiservers (SURVEY.md §4).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import Workload, WorkloadConditionType
from kueue_tpu_torch.controllers.admissionchecks import CheckState


# multikueue_types.go:177 (MultiKueueConfigQuotaManagementMode).
QUOTA_MANAGEMENT_MANUAL = "Manual"
QUOTA_MANAGEMENT_AUTOMATED = "Automated"

# The CQ condition type (multikueue/clusterqueue.go).
QUOTA_AUTOMATION_CONDITION = "MultiKueueManagerQuotaAutomation"


@dataclass
class MultiKueueConfig:
    """multikueue_types.go:124 (MultiKueueConfig): ordered cluster list +
    quotaManagement mode (:166)."""

    clusters: list[str] = field(default_factory=list)
    quota_management: str = QUOTA_MANAGEMENT_MANUAL


MULTIKUEUE_PREEMPTION_GATE = "kueue.x-k8s.io/multikueue-preemption"

# workload.go:67: after opening one cluster's gate, wait this long before
# opening another (one cluster preempts at a time).
SINGLE_CLUSTER_PREEMPTION_TIMEOUT = 300.0


@dataclass
class _RemoteState:
    nominated: list[str] = field(default_factory=list)
    created: dict[str, str] = field(default_factory=dict)  # cluster -> key
    cluster_name: Optional[str] = None
    last_round_time: float = 0.0


class Dispatcher:
    """pkg/controller/workloaddispatcher strategies."""

    ALL_AT_ONCE = "AllAtOnce"
    INCREMENTAL = "Incremental"


class MultiKueueController:
    def __init__(self, manager_engine, check_name: str,
                 config: MultiKueueConfig,
                 dispatcher: str = Dispatcher.ALL_AT_ONCE,
                 increment: int = 1, round_seconds: float = 300.0,
                 orchestrated_preemption: bool = False):
        self.engine = manager_engine
        self.check_name = check_name
        self.config = config
        self.dispatcher = dispatcher
        self.increment = increment
        self.round_seconds = round_seconds
        self.clusters: dict[str, object] = {}  # name -> worker Engine
        # RemoteClient-managed clusters (multikueue_cluster.py):
        # connect/reconnect/hot-reload lifecycles live here; plain
        # connect_cluster() workers bypass it.
        self.remote_clients: dict[str, object] = {}
        # ClusterProfile objects (cluster-inventory-api) for
        # profile-sourced RemoteClients (MultiKueueClusterProfile gate).
        from kueue_tpu_torch.controllers.multikueue_cluster import (
            ClusterProfileRegistry,
        )
        self.cluster_profiles = ClusterProfileRegistry()
        self.states: dict[str, _RemoteState] = {}
        # MultiKueueOrchestratedPreemption: remote copies carry a closed
        # preemption gate; the manager opens one cluster's gate at a time
        # (workload.go:1186 workloadToOpenPreemptionGate).
        self.orchestrated_preemption = orchestrated_preemption
        # Job-object mirroring (jobframework MultiKueueAdapter): manager
        # JobReconciler + per-cluster worker reconcilers + adapter table.
        self.manager_jobs = None
        self.worker_jobs: dict[str, object] = {}
        self.adapters: dict[str, object] = {}
        self.origin = "multikueue"
        # Manager-side quota automation (multikueue/clusterqueue.go
        # cqReconciler): per-CQ MultiKueueManagerQuotaAutomation condition
        # as (status, reason, message); absent = condition removed.
        self.cq_conditions: dict[str, tuple[bool, str, str]] = {}

    def attach_job_framework(self, manager_reconciler,
                             worker_reconcilers: dict,
                             adapters: Optional[dict] = None,
                             origin: str = "multikueue") -> None:
        """Enable per-framework job mirroring: for workloads owned by a
        job, SyncJob creates the remote job object on the winning cluster
        (bound to the mirrored Workload via prebuilt reference) and copies
        remote job status back on every reconcile."""
        from kueue_tpu_torch.controllers.multikueue_adapters import DEFAULT_ADAPTERS

        self.manager_jobs = manager_reconciler
        self.worker_jobs = dict(worker_reconcilers)
        self.adapters = adapters if adapters is not None \
            else dict(DEFAULT_ADAPTERS)
        self.origin = origin

    def connect_cluster(self, name: str, engine) -> None:
        self.clusters[name] = engine

    def add_remote_cluster(self, name: str, kubeconfig_path: str = None,
                           connect=None, retry_increment: float = 1.0,
                           cluster_profile: str = None) -> None:
        """Register a worker reached through a RemoteClient
        (multikueuecluster.go): reconcile_clusters() drives connect /
        exponential reconnect / source hot-reload. ClusterSource is
        exactly one of ``kubeconfig_path`` (file-backed, fswatch) or
        ``cluster_profile`` (a name in ``self.cluster_profiles``, gated
        by MultiKueueClusterProfile)."""
        from kueue_tpu_torch.controllers.multikueue_cluster import RemoteClient

        self.remote_clients[name] = RemoteClient(
            name, kubeconfig_path, connect,
            clock=lambda: self.engine.clock,
            retry_increment=retry_increment,
            cluster_profile=cluster_profile,
            profiles=self.cluster_profiles)

    def cluster_connection_lost(self, name: str, reason: str) -> None:
        """Watch-ended / transport-failure event for a managed cluster:
        tear down placements there (the workers-lost eviction,
        multikueuecluster.go) and schedule a backed-off reconnect."""
        rc = self.remote_clients.get(name)
        if rc is not None:
            rc.mark_lost(reason)
        self.disconnect_cluster(name)

    def reconcile_clusters(self) -> None:
        """Drive every RemoteClient's lifecycle; newly (re)connected
        workers plug back into the dispatch set."""
        for name, rc in self.remote_clients.items():
            event = rc.tick()
            if event in ("reconfigured", "disconnected"):
                # The old client (and its credentials) is gone:
                # placements made through it tear down like a
                # disconnect — stale state.created entries must not
                # block re-dispatch to the rebuilt cluster.
                self.disconnect_cluster(name)
            if event in ("connected", "reconfigured"):
                self.connect_cluster(name, rc.worker)

    def cluster_active(self, name: str):
        """The MultiKueueCluster Active condition for a managed
        cluster (None when the cluster is not RemoteClient-managed)."""
        rc = self.remote_clients.get(name)
        return None if rc is None else rc.active

    @staticmethod
    def _clear_placement_status(wl: Workload) -> None:
        """Reset clusterName/nominatedClusterNames when a placement is
        torn down — a later re-nomination must not coexist with a stale
        placement (the workload_types.go:613 mutual-exclusion rule)."""
        wl.status.cluster_name = None
        wl.status.nominated_cluster_names = ()

    def disconnect_cluster(self, name: str) -> None:
        """Worker lost: evict manager workloads placed there."""
        self.clusters.pop(name, None)
        for wl_key, state in list(self.states.items()):
            if state.cluster_name == name:
                wl = self.engine.workloads.get(wl_key)
                del self.states[wl_key]
                if wl is not None and not wl.is_finished:
                    self._clear_placement_status(wl)
                    self.engine.evict(wl, "MultiKueueClusterLost")
            else:
                state.created.pop(name, None)

    # -- the reconcile pass (workload.go:185) --

    def reconcile(self) -> None:
        self.reconcile_clusters()
        self.reconcile_cluster_queues()
        # The reference runs runGC on a timer per connected cluster
        # (multikueuecluster.go:608); the engine's tick IS the timer
        # here, so every reconcile sweeps origin-labeled orphans.
        self.run_gc()
        acm = self.engine.admission_checks
        for wl in list(self.engine.workloads.values()):
            if wl.is_finished:
                self._gc(wl)
                continue
            if not wl.has_quota_reservation:
                if wl.key in self.states:
                    self._remove_remotes(wl.key, except_cluster=None)
                    del self.states[wl.key]
                    self._clear_placement_status(wl)
                continue
            cq = wl.status.admission.cluster_queue
            if self.check_name not in acm.required_for(cq, wl):
                continue
            state = self.states.setdefault(wl.key, _RemoteState())
            if state.cluster_name is None:
                self._nominate(wl, state)
                self._sync_remotes(wl, state)
                self._check_remote_admission(wl, state, acm)
                if (state.cluster_name is None
                        and self.orchestrated_preemption):
                    self._maybe_open_preemption_gate(state)
            else:
                self._sync_back(wl, state)

    # -- manager quota automation (multikueue/clusterqueue.go) --

    def _cq_has_mk_check(self, cq) -> bool:
        """getMultiKueueAdmissionCheck: the CQ references this controller's
        check directly or through its admissionChecksStrategy."""
        if self.check_name in (cq.admission_checks or ()):
            return True
        strategy = getattr(cq, "admission_checks_strategy", None) or {}
        return self.check_name in strategy

    def reconcile_cluster_queues(self) -> None:
        """cqReconciler.Reconcile for every manager ClusterQueue: with
        quotaManagement=Automated (and the MultiKueueManagerQuotaAutomation
        gate), the single flavor's nominal quotas are overwritten with the
        sum of the connected workers' quotas reachable through same-named
        LocalQueues (aggregateWorkerQuotas)."""
        from dataclasses import replace

        from kueue_tpu_torch.api.types import FlavorQuotas, ResourceQuota
        from kueue_tpu_torch.config import features

        # Deleted CQs shed their condition (removeQuotaAutomationCondition
        # fires on the delete event in the reference).
        for stale in set(self.cq_conditions) \
                - set(self.engine.cache.cluster_queues):
            del self.cq_conditions[stale]
        for name, cq in list(self.engine.cache.cluster_queues.items()):
            if not self._cq_has_mk_check(cq):
                self.cq_conditions.pop(name, None)
                continue
            if (self.config.quota_management != QUOTA_MANAGEMENT_AUTOMATED
                    or not features.enabled(
                        "MultiKueueManagerQuotaAutomation")):
                self.cq_conditions[name] = (
                    False, "NotRequested",
                    "MultiKueue manager quota automation has not been "
                    "requested.")
                continue
            if len(cq.resource_groups) != 1 \
                    or len(cq.resource_groups[0].flavors) != 1:
                self.cq_conditions[name] = (
                    False, "UnsupportedConfiguration",
                    "Quota automation requires that the manager-side "
                    "ClusterQueue has exactly one ResourceFlavor")
                continue
            rg = cq.resource_groups[0]
            aggregated = self._aggregate_worker_quotas(name)
            missing = set(aggregated) - set(rg.covered_resources)
            if missing:
                self.cq_conditions[name] = (
                    False, "UnsupportedConfiguration",
                    "manager-side coveredResources is missing resources "
                    f"configured on workers: {sorted(missing)}")
                continue
            flavor = rg.flavors[0]
            # Only the nominal quota is automated; operator-set
            # borrowing/lending limits survive. (Deliberate deviation:
            # clusterqueue.go:136-142 rebuilds ResourceQuota{nominal}
            # outright, which would silently reset borrowingLimit=None =
            # unlimited — dangerous in a cohort.)
            new_resources = {
                res: (replace(flavor.resources[res],
                              nominal=aggregated.get(res, 0))
                      if res in flavor.resources
                      else ResourceQuota(nominal=aggregated.get(res, 0)))
                for res in rg.covered_resources}
            if {r: q.nominal for r, q in flavor.resources.items()} != \
                    {r: q.nominal for r, q in new_resources.items()}:
                new_cq = replace(cq, resource_groups=(replace(
                    rg, flavors=(FlavorQuotas(
                        flavor.name, new_resources),)),))
                # Propagates to cache + queues; the queue manager's
                # update path keeps the pending heap and retries
                # inadmissible workloads (manager.go:402
                # UpdateClusterQueue), so a quota increase unparks
                # waiting workloads.
                self.engine.create_cluster_queue(new_cq)
            self.cq_conditions[name] = (
                True, "QuotaAutomated",
                "ClusterQueue quota is automatically managed based on "
                "MultiKueue workers.")

    def _aggregate_worker_quotas(self, cq_name: str) -> dict[str, int]:
        """aggregateWorkerQuotas (clusterqueue.go:176): manager LocalQueues
        feeding this CQ name remote CQs through same-namespace/name worker
        LocalQueues; sum those CQs' nominal quotas per resource."""
        lq_keys = {lq.key for lq in
                   self.engine.queues.local_queues.values()
                   if lq.cluster_queue == cq_name}
        total: dict[str, int] = {}
        for cluster in self.config.clusters:
            worker = self.clusters.get(cluster)
            if worker is None:
                continue  # not connected: skipped in aggregation
            remote_cq_names = {
                rlq.cluster_queue
                for rlq in worker.queues.local_queues.values()
                if rlq.key in lq_keys}
            for rcq_name in remote_cq_names:
                rcq = worker.cache.cluster_queues.get(rcq_name)
                if rcq is None:
                    continue
                for rg in rcq.resource_groups:
                    for fq in rg.flavors:
                        for res, quota in fq.resources.items():
                            total[res] = total.get(res, 0) + quota.nominal
        return total

    # -- internals --

    def _nominate(self, wl: Workload, state: _RemoteState) -> None:
        from kueue_tpu_torch.config import features

        available = [c for c in self.config.clusters if c in self.clusters]
        # Incremental rounds are gated (kube_features.go
        # MultiKueueIncrementalDispatcherConfig); off = AllAtOnce.
        if (self.dispatcher == Dispatcher.ALL_AT_ONCE
                or not features.enabled(
                    "MultiKueueIncrementalDispatcherConfig")):
            state.nominated = available
            wl.status.nominated_cluster_names = tuple(state.nominated)
            return
        # Incremental: +increment clusters every round_seconds
        # (incrementaldispatcher.go:50).
        if not state.nominated:
            state.nominated = available[:self.increment]
            state.last_round_time = self.engine.clock
        elif (self.engine.clock - state.last_round_time
              >= self.round_seconds
              and len(state.nominated) < len(available)):
            n = len(state.nominated) + self.increment
            state.nominated = available[:n]
            state.last_round_time = self.engine.clock
        wl.status.nominated_cluster_names = tuple(state.nominated)

    def _sync_remotes(self, wl: Workload, state: _RemoteState) -> None:
        from kueue_tpu_torch.controllers.multikueue_cluster import ORIGIN_LABEL

        for cluster in state.nominated:
            if cluster in state.created:
                continue
            worker = self.clusters.get(cluster)
            if worker is None:
                continue
            existing = worker.workloads.get(wl.key)
            if (existing is not None
                    and existing.labels.get(ORIGIN_LABEL) == self.origin):
                # Reconnect after a connection loss: the remote copy is
                # ADOPTED, not recreated — the reference's wlReconciler
                # only creates missing remote objects (workload.go:609).
                state.created[cluster] = existing.key
                if existing.is_finished:
                    # It finished during the outage: propagate the
                    # result instead of running the job a second time.
                    state.cluster_name = cluster
                    cond = existing.condition(
                        WorkloadConditionType.FINISHED)
                    wl.set_condition(
                        WorkloadConditionType.FINISHED, True,
                        reason=cond.reason if cond else "Finished",
                        now=self.engine.clock)
                    self.engine.finish(wl.key)
                    return
                continue
            copy_wl = copy.deepcopy(wl)
            copy_wl.status = type(copy_wl.status)()
            # Origin mark (kueue.MultiKueueOriginLabel): run_gc only
            # collects this manager's own orphans.
            copy_wl.labels[ORIGIN_LABEL] = self.origin
            if self.orchestrated_preemption:
                # cloneForCreate (workload.go:1254): remotes manage gates
                # independently — drop the manager's, add the MK gate
                # Closed so remotes can't preempt until ungated.
                copy_wl.preemption_gates = ()
                copy_wl.ensure_preemption_gate(MULTIKUEUE_PREEMPTION_GATE)
            if worker.submit(copy_wl):
                state.created[cluster] = copy_wl.key
                self.engine.registry.counter(
                    "workloads_dispatched_total").inc(
                    (self.dispatcher, cluster))

    def _maybe_open_preemption_gate(self, state: _RemoteState) -> None:
        """workload.go:1186 workloadToOpenPreemptionGate: among remotes
        blocked on the gate, open the one whose blocked signal is oldest
        — but only one cluster per SINGLE_CLUSTER_PREEMPTION_TIMEOUT."""
        now = self.engine.clock
        best: Optional[tuple[float, Workload]] = None
        previous_open: Optional[float] = None
        for cluster in state.nominated:
            key = state.created.get(cluster)
            worker = self.clusters.get(cluster)
            if key is None or worker is None:
                continue
            remote = worker.workloads.get(key)
            if remote is None:
                continue
            opened = remote.status.open_preemption_gates.get(
                MULTIKUEUE_PREEMPTION_GATE)
            if opened is not None:
                if previous_open is None or opened > previous_open:
                    previous_open = opened
                continue
            cond = remote.condition(
                WorkloadConditionType.BLOCKED_ON_PREEMPTION_GATES)
            if cond is None or not cond.status:
                continue
            if best is None or cond.last_transition_time < best[0]:
                best = (cond.last_transition_time, remote)
        if best is None:
            return
        if (previous_open is not None and now - previous_open
                < SINGLE_CLUSTER_PREEMPTION_TIMEOUT):
            return  # an earlier cluster's preemption attempt still runs
        # Once the timeout lapses the next gate opens WITHOUT closing the
        # previous one — the reference presumes the stale attempt stuck
        # and lets both race (workload.go:1227-1242 never re-closes).
        best[1].open_preemption_gate(MULTIKUEUE_PREEMPTION_GATE, now)

    def _check_remote_admission(self, wl: Workload, state: _RemoteState,
                                acm) -> None:
        for cluster in state.nominated:
            key = state.created.get(cluster)
            worker = self.clusters.get(cluster)
            if key is None or worker is None:
                continue
            remote = worker.workloads.get(key)
            if remote is not None and remote.is_admitted:
                state.cluster_name = cluster
                # clusterName and nominatedClusterNames are mutually
                # exclusive once placed (workload_types.go:613 CEL rule).
                wl.status.cluster_name = cluster
                wl.status.nominated_cluster_names = ()
                self._remove_remotes(wl.key, except_cluster=cluster)
                self._sync_remote_job(wl, state)
                acm.set_state(wl.key, self.check_name, CheckState.READY)
                return

    def _adapter_and_job(self, wl: Workload):
        """Resolve (local job, adapter, winning worker reconciler) for a
        job-owned workload, or (None, None, None)."""
        if self.manager_jobs is None:
            return None, None, None
        job_key = self.manager_jobs.workload_to_job.get(wl.key)
        job = self.manager_jobs.jobs.get(job_key) if job_key else None
        if job is None:
            return None, None, None
        from kueue_tpu_torch.controllers.multikueue_adapters import adapter_for

        adapter = adapter_for(job, self.adapters,
                              self.manager_jobs.integrations)
        return job, adapter, None

    def _sync_remote_job(self, wl: Workload, state: _RemoteState) -> None:
        """SyncJob on the winning cluster (workload.go:609): create the
        remote job object bound to the mirrored Workload, or copy its
        status back to the manager's job."""
        job, adapter, _ = self._adapter_and_job(wl)
        worker_rec = self.worker_jobs.get(state.cluster_name)
        if job is None or adapter is None or worker_rec is None:
            return
        managed, _reason = adapter.is_job_managed_by_kueue(job)
        if not managed:
            return
        remote_key = state.created.get(state.cluster_name)
        remote_name = remote_key.split("/", 1)[1] if remote_key else wl.name
        adapter.sync_job(job, worker_rec, remote_name, self.origin)

    def _sync_back(self, wl: Workload, state: _RemoteState) -> None:
        worker = self.clusters.get(state.cluster_name)
        key = state.created.get(state.cluster_name)
        if worker is None or key is None:
            return
        remote = worker.workloads.get(key)
        if remote is None:
            # Remote object lost: evict & retry.
            del self.states[wl.key]
            self._clear_placement_status(wl)
            self.engine.evict(wl, "MultiKueueRemoteLost")
            return
        # Keep the remote job object in sync (create if the win happened
        # before the job existed; copy status back otherwise).
        self._sync_remote_job(wl, state)
        if remote.is_finished:
            cond = remote.condition(WorkloadConditionType.FINISHED)
            wl.set_condition(WorkloadConditionType.FINISHED, True,
                             reason=cond.reason if cond else "Finished",
                             now=self.engine.clock)
            self.engine.finish(wl.key)

    def _delete_remote(self, cluster: str, key: str) -> None:
        """Delete one remote workload copy and its mirrored job object
        (wlGroup.RemoveRemoteObjects / DeleteRemoteObject). Shared by
        the per-workload teardown and the orphan GC."""
        worker = self.clusters.get(cluster)
        if worker is not None:
            remote = worker.workloads.pop(key, None)
            if remote is not None:
                worker.cache.delete_workload(key)
                worker.queues.delete_workload(remote)
        worker_rec = self.worker_jobs.get(cluster)
        if worker_rec is not None:
            wl = self.engine.workloads.get(key)
            job, adapter, _ = (self._adapter_and_job(wl)
                               if wl is not None else (None, None, None))
            if job is None and adapter is None:
                # Manager workload gone (orphan GC): resolve the remote
                # job through the worker's own registry.
                job_key = getattr(worker_rec, "workload_to_job",
                                  {}).get(key)
                if job_key is not None and job_key in worker_rec.jobs:
                    from kueue_tpu_torch.controllers.multikueue_adapters import (
                        adapter_for,
                    )
                    job = worker_rec.jobs[job_key]
                    adapter = adapter_for(job, self.adapters,
                                          worker_rec.integrations)
            if job is not None and adapter is not None \
                    and job.key in worker_rec.jobs:
                adapter.delete_remote_object(worker_rec, job.key)

    def _remove_remotes(self, wl_key: str,
                        except_cluster: Optional[str]) -> None:
        state = self.states.get(wl_key)
        if state is None:
            return
        for cluster, key in list(state.created.items()):
            if cluster == except_cluster:
                continue
            self._delete_remote(cluster, key)
            del state.created[cluster]

    def _gc(self, wl: Workload) -> None:
        """Orphan GC of remote objects for finished workloads."""
        if wl.key in self.states:
            self._remove_remotes(wl.key, except_cluster=None)
            del self.states[wl.key]

    def run_gc(self) -> None:
        """multikueuecluster.go:608 (runGC): on every connected worker,
        remote workloads carrying THIS manager's origin label whose
        local counterpart is gone (deleted manager workload, or a
        manager that crashed between remote-create and journaling) are
        deleted, along with their mirrored job objects."""
        from kueue_tpu_torch.controllers.multikueue_cluster import ORIGIN_LABEL

        for cluster, worker in self.clusters.items():
            for key, remote in list(worker.workloads.items()):
                if remote.labels.get(ORIGIN_LABEL) != self.origin:
                    continue
                local = self.engine.workloads.get(key)
                if local is not None and not local.is_finished:
                    continue
                self._delete_remote(cluster, key)
                state = self.states.get(key)
                if state is not None and \
                        state.created.get(cluster) == key:
                    del state.created[cluster]
