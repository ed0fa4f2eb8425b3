"""Job integration framework: the job <-> Workload contract.

The port of ``kueue_tpu/controllers/jobframework.py``, unchanged.

Reference: pkg/controller/jobframework — the GenericJob plugin interface
(interface.go:36), the generic reconciler (reconciler.go:286
ReconcileGenericJob) and the integration registry
(integrationmanager.go). Any job-like object type plugs in by
implementing GenericJob; the reconciler owns the Workload lifecycle:

  * ensure exactly one Workload per job (reconciler.go:399
    ensureOneWorkload), built from the job's pod sets;
  * when the Workload is admitted, start the job with the admission's
    per-PodSet node selectors / counts (RunWithPodSetsInfo);
  * when the Workload is evicted/preempted, stop the job and restore pod
    set info; when the job finishes, mark the Workload Finished.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

from kueue_tpu_torch.api.types import (
    PodSet,
    Workload,
    WorkloadConditionType,
)


@dataclass
class PodSetInfo:
    """Injected per-PodSet scheduling directives (podset.PodSetInfo):
    node selectors from the assigned flavor + count from admission, plus
    labels/annotations/tolerations merged from admission-check
    PodSetUpdates (podset.FromUpdate + Merge, pkg/podset/podset.go)."""

    name: str
    count: int
    node_selector: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    tolerations: tuple = ()

    def merge_update(self, update) -> None:
        """podset.Merge: additive only — an already-present key with a
        different value is a conflict (the reference fails admission)."""
        for attr, pairs in (("node_selector", update.node_selector),
                            ("labels", update.labels),
                            ("annotations", update.annotations)):
            dst = getattr(self, attr)
            for k, v in pairs:
                if k in dst and dst[k] != v:
                    raise ValueError(
                        f"conflict for {attr} key {k} in pod set "
                        f"{self.name}")
                dst[k] = v
        self.tolerations = self.tolerations + tuple(update.tolerations)


@runtime_checkable
class GenericJob(Protocol):
    """interface.go:36 (GenericJob)."""

    name: str
    namespace: str
    queue_name: str

    def is_suspended(self) -> bool: ...

    def suspend(self) -> None: ...

    def run_with_pod_sets_info(self, infos: list[PodSetInfo]) -> None: ...

    def restore_pod_sets_info(self, infos: list[PodSetInfo]) -> None: ...

    def pod_sets(self) -> list[PodSet]: ...

    def is_active(self) -> bool: ...

    def finished(self) -> tuple[bool, bool]:
        """Returns (finished, success)."""
        ...

    @property
    def key(self) -> str: ...


@dataclass
class BatchJob:
    """The batch/v1 Job adapter (pkg/controller/jobs/job/)."""

    name: str
    namespace: str = "default"
    queue_name: str = ""
    parallelism: int = 1
    completions: Optional[int] = None
    requests: dict[str, int] = field(default_factory=dict)  # per pod
    priority: int = 0
    min_parallelism: Optional[int] = None  # partial admission
    node_selector: dict[str, str] = field(default_factory=dict)
    suspended: bool = True
    active_pods: int = 0
    succeeded: int = 0
    failed: int = 0
    injected_info: Optional[list[PodSetInfo]] = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_suspended(self) -> bool:
        return self.suspended

    def suspend(self) -> None:
        self.suspended = True
        self.active_pods = 0

    def run_with_pod_sets_info(self, infos: list[PodSetInfo]) -> None:
        self.injected_info = infos
        self.suspended = False
        self.active_pods = infos[0].count if infos else self.parallelism

    def restore_pod_sets_info(self, infos: list[PodSetInfo]) -> None:
        self.injected_info = None

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(
            name="main", count=self.parallelism,
            requests=dict(self.requests),
            min_count=self.min_parallelism,
            node_selector=dict(self.node_selector))]

    def is_active(self) -> bool:
        return self.active_pods > 0

    def reclaimable_pods(self) -> dict[str, int]:
        """JobWithReclaimablePods (jobs/job/job_controller.go:213):
        reclaim only the parallelism the job can no longer use — while
        remaining completions >= parallelism every finished pod is
        replaced, so nothing is reclaimable."""
        if self.parallelism == 1 or self.succeeded == 0:
            return {}
        target = self.completions if self.completions is not None \
            else self.parallelism
        remaining = target - self.succeeded
        if remaining >= self.parallelism:
            return {}
        return {"main": self.parallelism - remaining}

    def finished(self) -> tuple[bool, bool]:
        target = self.completions if self.completions is not None \
            else self.parallelism
        if self.succeeded >= target:
            return True, True
        if self.failed > 0:
            return True, False
        return False, False


@dataclass
class JobSetJob:
    """A JobSet-style multi-pod-set gang job
    (pkg/controller/jobs/jobset/)."""

    name: str
    namespace: str = "default"
    queue_name: str = ""
    # replicated jobs: list of (name, replicas, per-pod requests, topology)
    replicated_jobs: list = field(default_factory=list)
    priority: int = 0
    suspended: bool = True
    active: bool = False
    done: bool = False
    success: bool = False
    injected_info: Optional[list[PodSetInfo]] = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_suspended(self) -> bool:
        return self.suspended

    def suspend(self) -> None:
        self.suspended = True
        self.active = False

    def run_with_pod_sets_info(self, infos: list[PodSetInfo]) -> None:
        self.injected_info = infos
        self.suspended = False
        self.active = True

    def restore_pod_sets_info(self, infos) -> None:
        self.injected_info = None

    def pod_sets(self) -> list[PodSet]:
        out = []
        for rj in self.replicated_jobs:
            name, replicas, requests = rj[0], rj[1], rj[2]
            topology = rj[3] if len(rj) > 3 else None
            out.append(PodSet(name=name, count=replicas,
                              requests=dict(requests),
                              topology_request=topology))
        return out

    def is_active(self) -> bool:
        return self.active

    def finished(self) -> tuple[bool, bool]:
        return self.done, self.success


class IntegrationManager:
    """integrationmanager.go: the registry of enabled integrations."""

    def __init__(self) -> None:
        self._types: dict[str, type] = {}

    def register(self, kind: str, job_type: type) -> None:
        self._types[kind] = job_type

    def kind_of(self, job) -> Optional[str]:
        for kind, t in self._types.items():
            if isinstance(job, t):
                return kind
        return None

    def kinds(self) -> list[str]:
        return sorted(self._types)


DEFAULT_INTEGRATIONS = IntegrationManager()
DEFAULT_INTEGRATIONS.register("batch/job", BatchJob)
DEFAULT_INTEGRATIONS.register("jobset.x-k8s.io/jobset", JobSetJob)

_wl_suffix = itertools.count(1)


class JobReconciler:
    """reconciler.go:286 (ReconcileGenericJob), driven by the engine."""

    def __init__(self, engine, integrations: IntegrationManager = None,
                 manage_jobs_without_queue_name: bool = False,
                 webhooks=None, managed_namespace_selector=None):
        """``webhooks``: an optional webhooks.jobwebhooks.JobWebhookRegistry
        — when set, create_job/update_job run the per-framework
        defaulting + validation layer first (the admission webhook in
        front of the reconciler). ``managed_namespace_selector``: an
        optional namespace -> bool predicate
        (managedJobsNamespaceSelector, reconciler.go:323)."""
        self.engine = engine
        self.integrations = integrations or DEFAULT_INTEGRATIONS
        self.manage_all = manage_jobs_without_queue_name
        self.managed_namespace_selector = managed_namespace_selector
        self.webhooks = webhooks
        self.jobs: dict[str, GenericJob] = {}
        self.job_to_workload: dict[str, str] = {}
        self.workload_to_job: dict[str, str] = {}
        engine.on_admit = self._chain(engine.on_admit, self._on_admit)

    @staticmethod
    def _chain(prev, new):
        if prev is None:
            return new

        def both(*a, **k):
            prev(*a, **k)
            new(*a, **k)
        return both

    # -- the job-side reconcile loop --

    def create_job(self, job: GenericJob) -> list[str]:
        """Returns webhook validation errors; on any, the job is
        rejected (not registered), like an admission-webhook denial."""
        from kueue_tpu_torch.config import features
        if (type(job).__name__ == "SparkApplicationJob"
                and not features.enabled("SparkApplicationIntegration")):
            # kube_features.go SparkApplicationIntegration: the Spark
            # adapter is gated off -> the job is not managed.
            self.engine._event(
                "JobRejected", job.key,
                detail="SparkApplicationIntegration gate disabled")
            return ["SparkApplicationIntegration feature gate disabled"]
        if self.webhooks is not None:
            errs = self.webhooks.admit_create(job)
            if errs:
                self.engine._event("JobRejected", job.key,
                                   detail="; ".join(errs))
                return errs
        self.jobs[job.key] = job
        self.reconcile(job)
        return []

    def update_job(self, job: GenericJob) -> list[str]:
        """Webhook-validated replacement of a registered job object."""
        old = self.jobs.get(job.key)
        if old is None:
            return self.create_job(job)
        if self.webhooks is not None:
            errs = self.webhooks.admit_update(old, job)
            if errs:
                self.engine._event("JobUpdateRejected", job.key,
                                   detail="; ".join(errs))
                return errs
        self.jobs[job.key] = job
        # A (suspended-only, webhook-enforced) queue move must follow
        # through to the pending Workload (reconciler.go queue-name
        # update handling), or the job and its workload diverge.
        wl_key = self.job_to_workload.get(job.key)
        if wl_key and old.queue_name != job.queue_name:
            wl = self.engine.workloads.get(wl_key)
            if wl is not None and not wl.is_finished:
                if wl.has_quota_reservation:
                    # A reserved/admitted workload must release its old
                    # CQ's quota before re-queueing elsewhere — pushing
                    # it pending while still assumed would double-admit.
                    self.engine.evict(wl, "QueueChanged", requeue=False)
                self.engine.queues.delete_workload(wl)
                wl.queue_name = job.queue_name
                self.engine.queues.add_or_update_workload(wl)
        self.reconcile(job)
        return []

    def delete_job(self, job_key: str) -> None:
        job = self.jobs.pop(job_key, None)
        wl_key = self.job_to_workload.pop(job_key, None)
        if wl_key:
            self.workload_to_job.pop(wl_key, None)
            wl = self.engine.workloads.get(wl_key)
            if wl is not None and not wl.is_finished:
                self.engine.finish(wl_key)
        if job is not None and getattr(job, "finalize", None) is not None:
            job.finalize()  # strip per-pod finalizers (:577)

    def reconcile(self, job: GenericJob) -> None:
        """One ReconcileGenericJob pass."""
        if not job.queue_name and not self.manage_all:
            return  # queue-name management gating (reconciler.go:313-377)
        if (self.managed_namespace_selector is not None
                and not self.managed_namespace_selector(job.namespace)):
            # With ManagedJobsNamespaceSelectorAlwaysRespected (default)
            # the selector gates even jobs that name a queue; with the
            # gate off, an explicit queue-name opts the job in anyway.
            from kueue_tpu_torch.config import features
            if (features.enabled(
                    "ManagedJobsNamespaceSelectorAlwaysRespected")
                    or not job.queue_name):
                return
        if (getattr(job, "complete", None) is not None
                and not job.complete()
                and self.job_to_workload.get(job.key) is None):
            # ComposableJob: wait for the whole group to exist before
            # CREATING the Workload; an existing group keeps reconciling
            # through member failures (replacement-pod flow).
            return
        if getattr(job, "hold_at_zero", False):
            # Serving jobs (StatefulSet): scale-to-zero releases the
            # reservation with reason OnHold instead of finishing or
            # requeueing (statefulset_reconciler.go:223-264); scaling
            # back up clears the hold below.
            total = sum(ps.count for ps in job.pod_sets())
            wl_key = self.job_to_workload.get(job.key)
            if total == 0:
                if wl_key is not None:
                    self.engine.hold_workload(
                        wl_key, "scaled to zero; workload on hold")
                return
            if wl_key is not None:
                wl_held = self.engine.workloads.get(wl_key)
                if wl_held is not None and \
                        self.engine.is_on_hold(wl_held):
                    self.engine.clear_hold(wl_key)
        wl = self._ensure_one_workload(job)
        if wl is None:
            return
        # Pod-group housekeeping (pod_controller.go): trim excess
        # members and surface the replacement-pods signal.
        if getattr(job, "sync_excess", None) is not None:
            for pod in job.sync_excess():
                self.engine._event("ExcessPodRemoved", wl.key,
                                   detail=pod.key)
        if getattr(job, "custom_workload_conditions", None) is not None:
            for ctype, status, reason in job.custom_workload_conditions(
                    self.engine.clock):
                prev = wl.condition(ctype)
                if prev is None and not status:
                    continue  # never set a fresh False condition
                if prev is None or prev.status != status:
                    wl.set_condition(ctype, status, reason=reason,
                                     now=self.engine.clock)
        finished, success = job.finished()
        if finished and not wl.is_finished:
            # workloadfinish.Finish (reconciler.go:453-465).
            wl.set_condition(
                WorkloadConditionType.FINISHED, True,
                reason="Succeeded" if success else "Failed",
                now=self.engine.clock)
            self.engine.finish(wl.key)
            if getattr(job, "finalize", None) is not None:
                job.finalize()  # strip per-pod finalizers (:577)
            return
        if wl.is_admitted and job.is_suspended():
            self._start_job(job, wl)
        elif not wl.is_admitted and not job.is_suspended():
            old_slice = wl.replaced_workload_slice
            old_wl = (self.engine.workloads.get(old_slice)
                      if old_slice is not None else None)
            if old_wl is not None and old_wl.is_admitted:
                # Elastic slice replacement pending: the OLD slice still
                # holds the quota and the pods keep running
                # (workloadslicing.go — scale never stops the job).
                pass
            else:
                # stopJob on eviction (reconciler.go:379-394).
                job.suspend()
                job.restore_pod_sets_info([])
        self._sync_reclaimable(job, wl)

    def _sync_reclaimable(self, job: GenericJob, wl: Workload) -> None:
        """JobWithReclaimablePods (interface.go): pods the job no longer
        needs release their quota share while the workload runs."""
        getter = getattr(job, "reclaimable_pods", None)
        if getter is None:
            return
        reclaimable = {k: v for k, v in getter().items() if v > 0}
        if reclaimable == wl.status.reclaimable_pods:
            return
        wl.status.reclaimable_pods = reclaimable
        if wl.status.admission is not None:
            self.engine.cache.add_or_update_workload(wl)
            self.engine._requeue_cohort_inadmissible(
                wl.status.admission.cluster_queue)

    def reconcile_all(self) -> None:
        for job in list(self.jobs.values()):
            self.reconcile(job)

    # -- internals --

    def _ensure_one_workload(self, job: GenericJob) -> Optional[Workload]:
        """reconciler.go:399 (ensureOneWorkload): the Workload must match
        the job's pod sets; replaced if the shape changed. A job carrying
        a prebuilt-workload reference (reconciler.go:915, the
        MultiKueue-remote path) adopts that Workload instead of creating
        one."""
        prebuilt = getattr(job, "prebuilt_workload_name", None)
        if prebuilt:
            key = f"{job.namespace}/{prebuilt}"
            wl = self.engine.workloads.get(key)
            if wl is None:
                return None  # ErrPrebuiltWorkloadNotFound: wait
            self.job_to_workload[job.key] = key
            self.workload_to_job[key] = job.key
            return wl
        wl_key = self.job_to_workload.get(job.key)
        pod_sets = job.pod_sets()
        replaced_slice = None
        if wl_key is not None:
            wl = self.engine.workloads.get(wl_key)
            if wl is not None and _pod_sets_match(wl, pod_sets):
                return wl
            if wl is not None:
                from kueue_tpu_torch.config import features
                if (getattr(job, "elastic", False)
                        and features.enabled(
                            "ElasticJobsViaWorkloadSlices")
                        and wl.is_admitted and not wl.is_finished):
                    # Elastic scale of a RUNNING job: the replacement
                    # workload SLICE preempt-replaces the old one
                    # without stopping its pods (workloadslicing.go:46;
                    # the scheduler finishes the old slice when the
                    # replacement admits, scheduler.go:558).
                    replaced_slice = wl_key
                else:
                    # A re-scale before a pending slice admitted must
                    # keep pointing at the still-admitted predecessor:
                    # dropping the chain would leak its quota forever
                    # and suspend the running pods.
                    old_key = wl.replaced_workload_slice
                    if old_key is not None:
                        old = self.engine.workloads.get(old_key)
                        if old is not None and old.is_admitted \
                                and not old.is_finished:
                            replaced_slice = old_key
                    self.engine.finish(wl_key)
                    self.workload_to_job.pop(wl_key, None)
        wl = Workload(
            name=f"{job.name}-wl-{next(_wl_suffix)}",
            namespace=job.namespace,
            queue_name=job.queue_name,
            priority=getattr(job, "priority", 0),
            pod_sets=tuple(pod_sets),
            replaced_workload_slice=replaced_slice,
        )
        if not self.engine.submit(wl):
            return None
        self.job_to_workload[job.key] = wl.key
        self.workload_to_job[wl.key] = job.key
        return wl

    def _start_job(self, job: GenericJob, wl: Workload) -> None:
        """startJob -> RunWithPodSetsInfo (reconciler.go admitted path):
        inject node selectors of the assigned flavors + admitted counts,
        then merge each admission check's PodSetUpdates
        (reconciler.go:1606-1615). A conflicting update fails the start
        and evicts the workload, as the reference's admission error does."""
        infos = []
        flavors = self.engine.cache.resource_flavors
        for psa in wl.status.admission.pod_set_assignments:
            selector: dict[str, str] = {}
            for flavor_name in psa.flavors.values():
                rf = flavors.get(flavor_name)
                if rf is not None:
                    selector.update(rf.node_labels)
            infos.append(PodSetInfo(name=psa.name, count=psa.count,
                                    node_selector=selector))
        try:
            for check_name, updates in sorted(
                    wl.status.admission_check_updates.items()):
                for update in updates:
                    for info in infos:
                        if info.name == update.name:
                            info.merge_update(update)
                            break
        except ValueError as exc:
            self.engine._event("PodSetUpdateConflict", wl.key,
                               detail=str(exc))
            self.engine.evict(wl, "PodSetUpdateConflict", requeue=False)
            return
        job.run_with_pod_sets_info(infos)

    def _on_admit(self, wl: Workload, admission) -> None:
        job_key = self.workload_to_job.get(wl.key)
        if job_key and job_key in self.jobs:
            self.reconcile(self.jobs[job_key])


def _pod_sets_match(wl: Workload, pod_sets: list[PodSet]) -> bool:
    if len(wl.pod_sets) != len(pod_sets):
        return False
    for a, b in zip(wl.pod_sets, pod_sets):
        if (a.name, a.count, a.requests) != (b.name, b.count, b.requests):
            return False
    return True
