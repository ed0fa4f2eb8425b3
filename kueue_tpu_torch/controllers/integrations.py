"""Additional job integrations on the GenericJob contract.

The port of ``kueue_tpu/controllers/integrations.py``, unchanged.

Reference: pkg/controller/jobs/* — 15 adapters. Beyond BatchJob and
JobSetJob (jobframework.py), these cover:
  * TrainingJob — Kubeflow TFJob/PyTorchJob/XGBoost/Paddle/JAXJob style
    (named replica specs, a master/chief plus workers);
  * TrainJobV2 — Kubeflow TrainJob (trainer + optional initializer);
  * MPIJob — launcher + workers;
  * RayClusterJob / RayJob / RayServiceJob — head + worker groups, with
    the job/serving lifecycles on top;
  * AppWrapperJob — a wrapper over heterogeneous components;
  * LeaderWorkerSetJob — replicated leader+workers groups, co-placed via
    the TAS pod-set group (the leader rides with its workers);
  * PodJob / PodGroup — plain pods with scheduling-gate semantics;
    PodGroup composes N pods into one gang Workload (ComposableJob);
  * StatefulSetJob / DeploymentJob — serving shapes (never finish);
  * SparkApplicationJob — driver + executors.
Each is a thin shape over pod sets; the jobframework reconciler owns the
Workload lifecycle for all of them identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import PodSet, PodSetTopologyRequest
from kueue_tpu_torch.controllers.jobframework import (
    DEFAULT_INTEGRATIONS,
    PodSetInfo,
)


@dataclass
class _BaseJob:
    name: str
    namespace: str = "default"
    queue_name: str = ""
    priority: int = 0
    suspended: bool = True
    active: bool = False
    done: bool = False
    success: bool = False
    injected_info: Optional[list[PodSetInfo]] = None
    # Object annotations seen by the admission webhooks (the elastic
    # workload-slice opt-in, admission-gated-by, ...).
    annotations: dict = field(default_factory=dict)

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

    def is_active(self) -> bool:
        return self.active

    def finished(self) -> tuple[bool, bool]:
        return self.done, self.success


@dataclass
class TrainingJob(_BaseJob):
    """Kubeflow-style job: replica specs {name: (replicas, requests)}.
    (pkg/controller/jobs/kubeflow/*)."""

    framework: str = "pytorch"  # tf | pytorch | xgboost | paddle | jax
    replica_specs: dict = field(default_factory=dict)
    topology_request: Optional[PodSetTopologyRequest] = None

    def pod_sets(self) -> list[PodSet]:
        out = []
        for rname in sorted(self.replica_specs):
            replicas, requests = self.replica_specs[rname]
            out.append(PodSet(name=rname, count=replicas,
                              requests=dict(requests),
                              topology_request=self.topology_request))
        return out


@dataclass
class RayClusterJob(_BaseJob):
    """Ray cluster: head + worker groups (pkg/controller/jobs/raycluster,
    common.go head/worker pod sets). The in-tree autoscaler
    (enableInTreeAutoscaling) is only admissible for elastic jobs under
    ElasticJobsViaWorkloadSlices (raycluster_webhook.go:141) — the
    autoscaler's replica changes then flow through workload slices;
    scale_group() is the RayCluster workerGroup replicas update."""

    head_requests: dict = field(default_factory=dict)
    # (name, n, requests[, pod_template_annotations]) per worker group.
    worker_groups: list = field(default_factory=list)
    enable_in_tree_autoscaling: bool = False
    elastic: bool = False
    head_annotations: dict = field(default_factory=dict)

    def pod_sets(self) -> list[PodSet]:
        out = [PodSet(name="head", count=1,
                      requests=dict(self.head_requests))]
        for gname, replicas, requests, *_ann in self.worker_groups:
            out.append(PodSet(name=gname, count=replicas,
                              requests=dict(requests)))
        return out

    def scale_group(self, group: str, replicas: int) -> None:
        self.worker_groups = [
            (g[0], replicas if g[0] == group else g[1], *g[2:])
            for g in self.worker_groups]


@dataclass
class MPIJob(_BaseJob):
    """MPI launcher + workers (pkg/controller/jobs/mpijob)."""

    launcher_requests: dict = field(default_factory=dict)
    worker_replicas: int = 1
    worker_requests: dict = field(default_factory=dict)
    run_launcher_as_worker: bool = False
    # slotsPerWorker scales each worker's share of the MPI world; the
    # webhook rejects non-positive values (mpijob_webhook.go).
    slots_per_worker: int = 1
    topology_request: Optional[PodSetTopologyRequest] = None

    def pod_sets(self) -> list[PodSet]:
        out = []
        if not self.run_launcher_as_worker:
            out.append(PodSet(name="launcher", count=1,
                              requests=dict(self.launcher_requests)))
        out.append(PodSet(name="worker", count=self.worker_replicas,
                          requests=dict(self.worker_requests),
                          topology_request=self.topology_request))
        return out


@dataclass
class TrainJobV2(_BaseJob):
    """Kubeflow TrainJob v2 (pkg/controller/jobs/trainjob): trainer nodes
    plus an optional dataset/model initializer."""

    num_nodes: int = 1
    trainer_requests: dict = field(default_factory=dict)
    initializer_requests: Optional[dict] = None
    topology_request: Optional[PodSetTopologyRequest] = None

    def pod_sets(self) -> list[PodSet]:
        out = []
        if self.initializer_requests is not None:
            out.append(PodSet(name="initializer", count=1,
                              requests=dict(self.initializer_requests)))
        out.append(PodSet(name="node", count=self.num_nodes,
                          requests=dict(self.trainer_requests),
                          topology_request=self.topology_request))
        return out


@dataclass
class RayJob(_BaseJob):
    """RayJob: a batch job over an ephemeral Ray cluster
    (pkg/controller/jobs/rayjob): optional submitter pod + head +
    worker groups; finishes when the job completes."""

    submitter_requests: Optional[dict] = None
    head_requests: dict = field(default_factory=dict)
    worker_groups: list = field(default_factory=list)  # (name, n, requests)

    def pod_sets(self) -> list[PodSet]:
        out = []
        if self.submitter_requests is not None:
            out.append(PodSet(name="submitter", count=1,
                              requests=dict(self.submitter_requests)))
        out.append(PodSet(name="head", count=1,
                          requests=dict(self.head_requests)))
        for gname, replicas, requests, *_ann in self.worker_groups:
            out.append(PodSet(name=gname, count=replicas,
                              requests=dict(requests)))
        return out


@dataclass
class RayServiceJob(_BaseJob):
    """RayService: a serving Ray cluster
    (pkg/controller/jobs/rayservice) — admission-managed, never
    finishes."""

    head_requests: dict = field(default_factory=dict)
    worker_groups: list = field(default_factory=list)

    def pod_sets(self) -> list[PodSet]:
        out = [PodSet(name="head", count=1,
                      requests=dict(self.head_requests))]
        for gname, replicas, requests, *_ann in self.worker_groups:
            out.append(PodSet(name=gname, count=replicas,
                              requests=dict(requests)))
        return out

    def finished(self) -> tuple[bool, bool]:
        return False, False


@dataclass
class AppWrapperJob(_BaseJob):
    """AppWrapper (pkg/controller/jobs/appwrapper): wraps heterogeneous
    components, each contributing its pod sets."""

    # components: list of (name, replicas, per-pod requests)
    components: list = field(default_factory=list)

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(name=cname, count=replicas, requests=dict(requests))
                for cname, replicas, requests in self.components]


@dataclass
class LeaderWorkerSetJob(_BaseJob):
    """LeaderWorkerSet (pkg/controller/jobs/leaderworkerset): N replicated
    groups of 1 leader + (size-1) workers. Leader and workers of a group
    are co-placed via the TAS pod-set group
    (findLeaderAndWorkers, tas_flavor_snapshot.go:729)."""

    replicas: int = 1  # number of groups
    size: int = 2  # pods per group incl. leader
    leader_requests: dict = field(default_factory=dict)
    worker_requests: dict = field(default_factory=dict)
    topology_request: Optional[PodSetTopologyRequest] = None
    leader_annotations: dict = field(default_factory=dict)
    worker_annotations: dict = field(default_factory=dict)

    def pod_sets(self) -> list[PodSet]:
        from dataclasses import replace as _replace
        out = []
        for g in range(self.replicas):
            tr = self.topology_request or PodSetTopologyRequest()
            tr = _replace(tr, pod_set_group_name=f"group-{g}")
            out.append(PodSet(name=f"leader-{g}", count=1,
                              requests=dict(self.leader_requests),
                              topology_request=tr))
            if self.size > 1:
                out.append(PodSet(name=f"workers-{g}",
                                  count=self.size - 1,
                                  requests=dict(self.worker_requests),
                                  topology_request=tr))
        return out

    def finished(self) -> tuple[bool, bool]:
        return False, False  # serving semantics


@dataclass
class LWSGroupJob(_BaseJob):
    """ONE replica group of a LeaderWorkerSet as its own GenericJob —
    the reference creates one Workload PER GROUP
    (pkg/controller/jobs/leaderworkerset: workloads named
    <lws>-<group-index>), so groups admit, evict, and recover
    independently while leader+workers stay co-placed via the TAS
    pod-set group."""

    group_index: int = 0
    size: int = 2
    leader_requests: dict = field(default_factory=dict)
    worker_requests: dict = field(default_factory=dict)
    topology_request: Optional[PodSetTopologyRequest] = None
    leader_annotations: dict = field(default_factory=dict)
    worker_annotations: dict = field(default_factory=dict)

    def pod_sets(self) -> list[PodSet]:
        from dataclasses import replace as _replace
        tr = self.topology_request or PodSetTopologyRequest(mode=None)
        tr = _replace(tr, pod_set_group_name=f"group-{self.group_index}")
        out = [PodSet(name="leader", count=1,
                      requests=dict(self.leader_requests),
                      topology_request=tr)]
        if self.size > 1:
            out.append(PodSet(name="workers", count=self.size - 1,
                              requests=dict(self.worker_requests),
                              topology_request=tr))
        return out

    def finished(self) -> tuple[bool, bool]:
        return False, False  # serving semantics


def lws_group_jobs(lws: "LeaderWorkerSetJob") -> list[LWSGroupJob]:
    """Split a LeaderWorkerSet into its per-group jobs (the reference's
    per-group Workload construction)."""
    return [LWSGroupJob(
        name=f"{lws.name}-{g}", namespace=lws.namespace,
        queue_name=lws.queue_name, priority=lws.priority,
        group_index=g, size=lws.size,
        leader_requests=dict(lws.leader_requests),
        worker_requests=dict(lws.worker_requests),
        topology_request=lws.topology_request)
        for g in range(lws.replicas)]


@dataclass
class PodJob(_BaseJob):
    """A plain pod (pkg/controller/jobs/pod): starts behind a scheduling
    gate; admission ungates it. Carries the kueue finalizer the way real
    group pods do (pod_controller.go:577 Finalize strips them)."""

    requests: dict = field(default_factory=dict)
    pod_group: Optional[str] = None
    group_total_count: int = 1
    gated: bool = True
    failed: bool = False
    # RetriableInGroupAnnotation (pod_controller.go:225): "false" means a
    # single pod failure fails the whole group.
    retriable: bool = True
    finalizers: list = field(default_factory=list)

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(name=self.pod_group or "main",
                       count=self.group_total_count,
                       requests=dict(self.requests))]

    def run_with_pod_sets_info(self, infos) -> None:
        super().run_with_pod_sets_info(infos)
        self.gated = False  # gate removed on admission

    def suspend(self) -> None:
        super().suspend()
        self.gated = True


POD_FINALIZER = "kueue.x-k8s.io/managed"


class PodGroup:
    """Pod groups (pkg/controller/jobs/pod pod-group mode, ComposableJob):
    pods sharing a group name compose into ONE gang Workload with one pod
    set per distinct shape (constructGroupPodSets). Reference edge
    semantics carried over from pod_controller.go:

      * gate-based assembly — the Workload exists only once all
        ``total_count`` pods are created, unless ``fast_admission``
        (GroupFastAdmissionAnnotation :717) builds it from the first pod
        with the full count;
      * replacement pods — a Failed pod makes the group report
        WaitingForReplacementPods (:1394) while the Workload stays
        admitted; a newly created pod replaces it and is ungated
        immediately; an unretriable group (RetriableInGroup=false, :225)
        fails the whole Workload instead;
      * excess pods — pods beyond ``total_count`` are finalized and
        removed, gated pods first, newest first (removeExcessPods :984);
      * per-pod finalizers — every member carries the kueue finalizer
        until the group finishes or is deleted (Finalize :577);
      * reclaimable pods — Succeeded members release their quota share
        (ReclaimablePods :1350) for non-serving groups.
    """

    def __init__(self, name: str, namespace: str = "default",
                 queue_name: str = "", total_count: int = 1,
                 fast_admission: bool = False, serving: bool = False):
        self.name = name
        self.namespace = namespace
        self.queue_name = queue_name
        self.total_count = total_count
        self.fast_admission = fast_admission
        self.serving = serving
        self.pods: list[PodJob] = []
        self.removed_excess: list[PodJob] = []
        self.suspended = True
        self.active = False
        self.injected_info = None
        self.priority = 0
        # The gang's pod sets are FROZEN at Workload construction: pod
        # failures awaiting replacement must not change the declared
        # shapes/counts (the Workload keeps its pod sets; only
        # reclaimablePods adjust, pod_controller.go:1308
        # equivalentToWorkload ignores absent pods).
        self._frozen_pod_sets: Optional[list[PodSet]] = None
        self._shape_names: dict[tuple, str] = {}

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    # -- membership --

    def add_pod(self, pod: PodJob) -> None:
        if POD_FINALIZER not in pod.finalizers:
            pod.finalizers.append(POD_FINALIZER)
        needed = self.active and self.absent_count() > 0
        self.pods.append(pod)
        if needed:
            # Replacement for a failed member of a running group: ungate
            # immediately (the group's admission already covers it). A
            # pod added to a FULL group stays gated so it never runs
            # outside the admitted quota and sync_excess trims it as a
            # never-started pod (pod_controller.go removeExcessPods).
            pod.gated = False

    def live_pods(self) -> list[PodJob]:
        return [p for p in self.pods if not p.failed]

    def absent_count(self) -> int:
        """How many replacement pods the group is waiting for."""
        return max(0, self.total_count - len(self.live_pods()))

    def sync_excess(self) -> list[PodJob]:
        """Drop pods beyond total_count: gated (never-started) pods
        first, newest first; their finalizers are stripped
        (removeExcessPods + finalizePods)."""
        removed: list[PodJob] = []
        live = self.live_pods()
        excess = len(live) - self.total_count
        if excess <= 0:
            return removed
        for pod in sorted(
                live, key=lambda p: (not p.gated,
                                     -self.pods.index(p)))[:excess]:
            self.pods.remove(pod)
            if POD_FINALIZER in pod.finalizers:
                pod.finalizers.remove(POD_FINALIZER)
            removed.append(pod)
        self.removed_excess.extend(removed)
        return removed

    def is_unretriable(self) -> bool:
        """pod_controller.go:231 isUnretriableGroup."""
        return any(not p.retriable for p in self.pods)

    def finalize(self) -> None:
        """Strip the kueue finalizer from every member (Finalize :577).
        The frozen gang shape unfreezes with it — a re-created group
        re-declares its pod sets."""
        for pod in self.pods:
            if POD_FINALIZER in pod.finalizers:
                pod.finalizers.remove(POD_FINALIZER)
        self._frozen_pod_sets = None
        self._shape_names = {}

    # -- GenericJob contract --

    def complete(self) -> bool:
        if self.fast_admission:
            return bool(self.pods)
        return len(self.live_pods()) >= self.total_count

    def pod_sets(self) -> list[PodSet]:
        # One pod set per distinct resource shape (pod/pod_controller.go
        # constructGroupPodSets), FROZEN once the Workload exists —
        # a failed member awaiting replacement must not reshape the
        # admitted gang. Under fast admission the absent pods are
        # assumed to share the first pod's shape so the gang reserves
        # its full quota up front.
        if self._frozen_pod_sets is not None:
            return self._frozen_pod_sets
        shapes: dict[tuple, int] = {}
        for pod in self.live_pods():
            shape = tuple(sorted(pod.requests.items()))
            shapes[shape] = shapes.get(shape, 0) + 1
        missing = self.total_count - sum(shapes.values())
        if missing > 0 and self.pods:
            # ANY member's shape anchors the backfill (the sole
            # fast-admission pod may itself be Failed).
            first = tuple(sorted(self.pods[0].requests.items()))
            shapes[first] = shapes.get(first, 0) + missing
        out = [PodSet(name=f"shape-{i}", count=n, requests=dict(shape))
               for i, (shape, n) in enumerate(sorted(shapes.items()))]
        if self.complete() and out:
            self._frozen_pod_sets = out
            self._shape_names = {shape: f"shape-{i}" for i, (shape, _n)
                                 in enumerate(sorted(shapes.items()))}
        return out

    def reclaimable_pods(self) -> dict[str, int]:
        """JobWithReclaimablePods: Succeeded members release their share
        (serving groups never reclaim, :1342-1350)."""
        if self.serving:
            return {}
        out: dict[str, int] = {}
        for pod in self.live_pods():
            if not (pod.done and pod.success):
                continue
            shape = tuple(sorted(pod.requests.items()))
            # Keyed by the FROZEN shape->pod-set-name mapping so a
            # reclaim never lands on the wrong pod set even when whole
            # shapes have failed out of the live set.
            name = self._shape_names.get(shape)
            if name is None:
                continue
            out[name] = out.get(name, 0) + 1
        return out

    def custom_workload_conditions(self, now: float) -> list[tuple]:
        """CustomWorkloadConditions (:1380): the
        WaitingForReplacementPods signal, as (type, status, reason) the
        reconciler applies to the group's Workload."""
        absent = self.absent_count()
        if absent > 0:
            return [("WaitingForReplacementPods", True,
                     "PodsFailed")]
        return [("WaitingForReplacementPods", False, "PodsReady")]

    def is_suspended(self) -> bool:
        return self.suspended

    def suspend(self) -> None:
        self.suspended = True
        self.active = False
        for pod in self.pods:
            pod.gated = True

    def run_with_pod_sets_info(self, infos) -> None:
        self.injected_info = infos
        self.suspended = False
        self.active = True
        for pod in self.pods:
            if not pod.failed:
                pod.gated = False

    def restore_pod_sets_info(self, infos) -> None:
        self.injected_info = None

    def is_active(self) -> bool:
        return self.active

    def finished(self) -> tuple[bool, bool]:
        # An unretriable group fails outright on the first pod failure
        # (:231); a retriable group keeps its admission and waits for
        # replacements.
        if self.is_unretriable() and any(p.failed for p in self.pods):
            return True, False
        live = self.live_pods()
        if (len(live) >= self.total_count
                and all(p.done for p in live)):
            return True, all(p.success for p in live)
        return False, False


@dataclass
class StatefulSetJob(_BaseJob):
    """StatefulSet (pkg/controller/jobs/statefulset): a serving job with
    a prebuilt-workload lifecycle. Scale semantics
    (statefulset_reconciler.go:187):
      * scale to ZERO releases the reservation with reason OnHold and
        parks the Workload (:295 releaseScaleDownReservation) — pods
        gone, quota freed, Workload kept;
      * scale back up clears the hold (:274 clearOnHold) and requeues;
      * replica changes on a RUNNING set flow through elastic workload
        slices when the job is elastic (ElasticJobsViaWorkloadSlices),
        otherwise re-create the Workload (stop-and-requeue).
    """

    replicas: int = 1
    requests: dict = field(default_factory=dict)
    # statefulset jobs are scale-to-zero serving objects.
    hold_at_zero: bool = True
    # ElasticJobsViaWorkloadSlices opt-in (the elastic-job annotation).
    elastic: bool = False
    # status.readyReplicas: the webhook freezes queue/priority labels
    # once any replica is ready (statefulset_webhook.go).
    ready_replicas: int = 0

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(name="pods", count=self.replicas,
                       requests=dict(self.requests))]

    def scale(self, replicas: int) -> None:
        """The Scale-subresource update; the reconciler turns it into
        hold/clear-hold or a slice/recreate on the next pass."""
        self.replicas = replicas

    def finished(self) -> tuple[bool, bool]:
        return False, False


@dataclass
class DeploymentJob(_BaseJob):
    """Deployment (pkg/controller/jobs/deployment): each replica is
    admitted independently in the reference; modeled as one pod set with
    per-replica pods. Serving semantics like StatefulSet: scale-to-zero
    releases the reservation with an engine hold
    (deployment_reconciler.go scale handling), scale while running
    replaces the workload (elastic: via a workload slice)."""

    replicas: int = 1
    requests: dict = field(default_factory=dict)
    hold_at_zero: bool = True

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(name="pods", count=self.replicas,
                       requests=dict(self.requests))]

    def scale(self, replicas: int) -> None:
        self.replicas = replicas

    def finished(self) -> tuple[bool, bool]:
        return False, False


@dataclass
class SparkApplicationJob(_BaseJob):
    """SparkApplication (pkg/controller/jobs/sparkapplication): one
    driver pod set + one executor pod set sized by spec.executor
    .instances (sparkapplication_podset.go). dynamicAllocation is only
    admissible for elastic jobs under ElasticJobsViaWorkloadSlices
    (sparkapplication_webhook.go:125) — the operator's executor-count
    changes then flow through workload slices via scale_executors()."""

    driver_requests: dict = field(default_factory=dict)
    executor_instances: int = 1
    executor_requests: dict = field(default_factory=dict)
    dynamic_allocation: bool = False
    elastic: bool = False
    driver_annotations: dict = field(default_factory=dict)
    executor_annotations: dict = field(default_factory=dict)

    def pod_sets(self) -> list[PodSet]:
        return [
            PodSet(name="driver", count=1,
                   requests=dict(self.driver_requests)),
            PodSet(name="executor", count=self.executor_instances,
                   requests=dict(self.executor_requests)),
        ]

    def scale_executors(self, instances: int) -> None:
        self.executor_instances = instances


@dataclass
class ServingJob(_BaseJob):
    """Deployment/StatefulSet-style serving workload: admission-managed,
    never 'finishes' (pkg/controller/jobs/{deployment,statefulset})."""

    replicas: int = 1
    requests: dict = field(default_factory=dict)
    ready_replicas: int = 0

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(name="pods", count=self.replicas,
                       requests=dict(self.requests))]

    def finished(self) -> tuple[bool, bool]:
        return False, False


DEFAULT_INTEGRATIONS.register("kubeflow.org/trainingjob", TrainingJob)
DEFAULT_INTEGRATIONS.register("kubeflow.org/trainjob", TrainJobV2)
DEFAULT_INTEGRATIONS.register("kubeflow.org/mpijob", MPIJob)
DEFAULT_INTEGRATIONS.register("ray.io/raycluster", RayClusterJob)
DEFAULT_INTEGRATIONS.register("ray.io/rayjob", RayJob)
DEFAULT_INTEGRATIONS.register("ray.io/rayservice", RayServiceJob)
DEFAULT_INTEGRATIONS.register("workload.codeflare.dev/appwrapper",
                              AppWrapperJob)
DEFAULT_INTEGRATIONS.register("leaderworkerset.x-k8s.io/leaderworkerset",
                              LeaderWorkerSetJob)
DEFAULT_INTEGRATIONS.register("core/pod", PodJob)
DEFAULT_INTEGRATIONS.register("core/podgroup", PodGroup)
DEFAULT_INTEGRATIONS.register("apps/statefulset", StatefulSetJob)
DEFAULT_INTEGRATIONS.register("apps/deployment", DeploymentJob)
DEFAULT_INTEGRATIONS.register("sparkoperator.k8s.io/sparkapplication",
                              SparkApplicationJob)
DEFAULT_INTEGRATIONS.register("apps/serving", ServingJob)
