"""Per-integration job webhooks: defaulting + validation.

The port of ``kueue_tpu/webhooks/jobwebhooks.py``, unchanged.

Reference: each job framework ships a ``<kind>_webhook.go``
(pkg/controller/jobs/*/) layered over the shared helpers in
pkg/controller/jobframework/{defaults,validation}.go. The behaviors
mirrored here:

Defaulting (defaults.go):
  * default LocalQueue: a job with no queue name in a namespace that has
    a LocalQueue literally named "default" joins it
    (ApplyDefaultLocalQueue);
  * suspend-on-create: any queue-managed job is created suspended so
    kueue owns its start (ApplyDefaultForSuspend).

Validation (validation.go):
  * queue name must be a DNS-1123 label (ValidateQueueName);
  * maximum execution time must be > 0 (validateCreateForMaxExecTime);
  * queue name is immutable while the job is unsuspended
    (validateUpdateForQueueName);
  * prebuilt workload reference is immutable (validateUpdateForPrebuilt);
  * priority is immutable while quota is held (suspended jobs may
    change it — validateJobUpdateForWorkloadPriorityClassName);
  * per-framework rules, e.g. batch/job partial admission:
    0 < minParallelism < parallelism (job_webhook.go
    validatePartialAdmissionCreate).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def _valid_queue_name(name: str) -> bool:
    return bool(_DNS1123.match(name)) and len(name) <= 63


# -- shared defaulting (jobframework/defaults.go) --


def apply_default_local_queue(job, default_lq_exists: Callable[[str], bool],
                              enabled: bool = True) -> None:
    """ApplyDefaultLocalQueue: adopt the namespace's LocalQueue named
    "default" when the job names none. Gated: kube_features.go
    LocalQueueDefaulting."""
    from kueue_tpu_torch.config import features
    if not features.enabled("LocalQueueDefaulting"):
        return
    if enabled and not job.queue_name \
            and default_lq_exists(getattr(job, "namespace", "default")):
        job.queue_name = "default"


def apply_default_for_suspend(job, manage_jobs_without_queue_name: bool
                              ) -> None:
    """ApplyDefaultForSuspend: queue-managed jobs start suspended."""
    managed = bool(job.queue_name) or manage_jobs_without_queue_name
    if managed and not job.is_suspended():
        job.suspend()


# -- shared validation (jobframework/validation.go) --

QUEUE_NAME_LABEL_PATH = "metadata.labels[kueue.x-k8s.io/queue-name]"
PRIORITY_CLASS_LABEL_PATH = \
    "metadata.labels[kueue.x-k8s.io/priority-class]"
ADMISSION_GATED_BY_ANNOTATION = "kueue.x-k8s.io/admission-gated-by"
ADMISSION_GATED_BY_PATH = \
    f"metadata.annotations[{ADMISSION_GATED_BY_ANNOTATION}]"
ELASTIC_JOB_ANNOTATION = "kueue.x-k8s.io/elastic-job"
# workload_types.go topology annotations (jobframework/tas_validation.go
# validateTASPodSetRequest: at most one per pod template).
TOPOLOGY_ANNOTATIONS = (
    "kueue.x-k8s.io/podset-required-topology",
    "kueue.x-k8s.io/podset-preferred-topology",
    "kueue.x-k8s.io/podset-unconstrained-topology",
)
# util/webhook/validation_admissiongatedby.go:32 (the spec.managedBy
# constraint for Jobs).
MAX_GATE_NAME_LENGTH = 63

_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")
_PATH_SEGMENT = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")


def _csv_parse(value: str) -> list[str]:
    """pkg/util/csv Parse: comma split with per-entry whitespace trim."""
    return [p.strip() for p in value.split(",")]


def _validate_gate_format(value: str) -> list[str]:
    """validateAdmissionGatedByAnnotationFormat
    (util/webhook/validation_admissiongatedby.go:92): domain-prefixed
    paths, no duplicates, bounded length."""
    errs: list[str] = []
    if not value:
        return errs
    seen = set()
    for gate in _csv_parse(value):
        if gate == "":
            errs.append(f"{ADMISSION_GATED_BY_PATH}: Invalid value: "
                        f"{value!r}: cannot contain empty gate names")
            continue
        if gate in seen:
            errs.append(f"{ADMISSION_GATED_BY_PATH}: Invalid value: "
                        f"{value!r}: duplicate gate name: {gate}")
            continue
        seen.add(gate)
        # validation.IsDomainPrefixedPath (the spec.managedBy test).
        domain, slash, path = gate.partition("/")
        if not slash or not path or not domain:
            errs.append(
                f"{ADMISSION_GATED_BY_PATH}: Invalid value: {gate!r}: "
                'must be a domain-prefixed path (such as "acme.io/foo")')
            continue
        if not _SUBDOMAIN.match(domain):
            errs.append(
                f"{ADMISSION_GATED_BY_PATH}: Invalid value: {domain!r}: "
                "a lowercase RFC 1123 subdomain must consist of lower "
                "case alphanumeric characters, '-' or '.', and must "
                "start and end with an alphanumeric character")
            continue
        if any(not _PATH_SEGMENT.match(part)
               for part in path.split("/")):
            errs.append(
                f"{ADMISSION_GATED_BY_PATH}: Invalid value: {path!r}: "
                "name part must consist of alphanumeric characters, "
                "'-', '_' or '.', and must start and end with an "
                "alphanumeric character")
            continue
        if len(gate) > MAX_GATE_NAME_LENGTH:
            errs.append(f"{ADMISSION_GATED_BY_PATH}: Too long: may not "
                        f"be more than {MAX_GATE_NAME_LENGTH} bytes")
    return errs


def validate_admission_gated_by_on_create(job) -> list[str]:
    """ValidateAdmissionGatedByAnnotationOnCreate :36 (gated on
    kube_features.go AdmissionGatedBy)."""
    from kueue_tpu_torch.config import features
    if not features.enabled("AdmissionGatedBy"):
        return []
    anns = getattr(job, "annotations", None) or {}
    return _validate_gate_format(anns.get(ADMISSION_GATED_BY_ANNOTATION,
                                          ""))


def validate_admission_gated_by_on_update(old, new) -> list[str]:
    """ValidateAdmissionGatedByAnnotationOnUpdate :45: gates may only be
    removed after creation, never added."""
    from kueue_tpu_torch.config import features
    if not features.enabled("AdmissionGatedBy"):
        return []
    old_anns = getattr(old, "annotations", None) or {}
    new_anns = getattr(new, "annotations", None) or {}
    old_val = old_anns.get(ADMISSION_GATED_BY_ANNOTATION, "")
    new_val = new_anns.get(ADMISSION_GATED_BY_ANNOTATION, "")
    errs: list[str] = []
    if not old_val and new_val:
        errs.append(f"{ADMISSION_GATED_BY_PATH}: Forbidden: cannot add "
                    "admission gate after creation")
    if old_val and new_val:
        old_gates = _csv_parse(old_val)
        if any(g not in old_gates for g in _csv_parse(new_val)):
            errs.append(f"{ADMISSION_GATED_BY_PATH}: Forbidden: can "
                        "only remove gates, not add new ones")
    errs.extend(_validate_gate_format(new_val))
    return errs


def reject_elastic_annotation(job, gvk: str) -> list[str]:
    """statefulset_webhook.go / sparkapplication_webhook.go: kinds with
    their own scale semantics forbid the workload-slice opt-in
    annotation (gate ElasticJobsViaWorkloadSlices)."""
    from kueue_tpu_torch.config import features
    if not features.enabled("ElasticJobsViaWorkloadSlices"):
        return []
    anns = getattr(job, "annotations", None) or {}
    if anns.get(ELASTIC_JOB_ANNOTATION) == "true":
        return [f"metadata.annotations[{ELASTIC_JOB_ANNOTATION}]: "
                f"Forbidden: elastic job is not supported for {gvk!r}"]
    return []


def validate_topology_annotations(path: str, annotations: dict
                                  ) -> list[str]:
    """tas_validation.go: a pod template names at most one of the
    topology mode annotations."""
    present = [a for a in TOPOLOGY_ANNOTATIONS if a in (annotations or {})]
    if len(present) > 1:
        names = ", ".join(f'"{a}"' for a in TOPOLOGY_ANNOTATIONS)
        return [f"{path}.annotations: Invalid value: must not contain "
                f"more than one topology annotation: [{names}]"]
    return []


def validate_job_on_create(job) -> list[str]:
    errs = []
    if job.queue_name and not _valid_queue_name(job.queue_name):
        errs.append(f"{QUEUE_NAME_LABEL_PATH}: Invalid value: "
                    f"{job.queue_name!r}: queue name is not a DNS-1123 "
                    f"label")
    max_exec = getattr(job, "maximum_execution_time_seconds", None)
    if max_exec is not None and max_exec <= 0:
        errs.append("maximum execution time should be greater than 0")
    errs.extend(validate_admission_gated_by_on_create(job))
    return errs


def validate_job_on_update(old, new) -> list[str]:
    errs = []
    if old.queue_name != new.queue_name and not old.is_suspended():
        errs.append(f"{QUEUE_NAME_LABEL_PATH}: Invalid value: queue "
                    "name is immutable while the job is unsuspended")
    if getattr(old, "prebuilt_workload_name", None) != \
            getattr(new, "prebuilt_workload_name", None):
        errs.append("prebuilt workload is immutable")
    if getattr(old, "priority", 0) != getattr(new, "priority", 0) \
            and not old.is_suspended():
        errs.append("priority is immutable while the job holds quota")
    errs.extend(validate_admission_gated_by_on_update(old, new))
    return errs


# -- per-framework webhooks (pkg/controller/jobs/*/*_webhook.go) --


@dataclass
class JobWebhook:
    """The generic webhook; framework-specific subclasses refine
    extra_create_rules."""

    kind: str = ""

    def default(self, job, registry) -> None:
        apply_default_local_queue(job, registry.default_lq_exists)
        apply_default_for_suspend(job,
                                  registry.manage_jobs_without_queue_name)

    def validate_create(self, job) -> list[str]:
        return validate_job_on_create(job) + self.extra_create_rules(job)

    def validate_update(self, old, new) -> list[str]:
        return validate_job_on_update(old, new)

    def extra_create_rules(self, job) -> list[str]:
        return []


@dataclass
class BatchJobWebhook(JobWebhook):
    """jobs/job/job_webhook.go."""

    kind: str = "batch/job"

    def extra_create_rules(self, job) -> list[str]:
        errs = []
        # validatePartialAdmissionCreate: 0 < minParallelism < parallelism
        min_p = getattr(job, "min_parallelism", None)
        if min_p is not None:
            if min_p <= 0:
                errs.append("minimum parallelism must be positive")
            elif min_p >= job.parallelism:
                errs.append("minimum parallelism must be lower than "
                            "parallelism")
        # validateSyncCompletionCreate: completions must cover
        # parallelism when partial admission syncs completions.
        completions = getattr(job, "completions", None)
        if min_p is not None and completions is not None \
                and completions < job.parallelism:
            errs.append("completions should be equal to parallelism when "
                        "partial admission is used")
        return errs


@dataclass
class JobSetWebhook(JobWebhook):
    """jobs/jobset/jobset_webhook.go."""

    kind: str = "jobset.x-k8s.io/jobset"

    def extra_create_rules(self, job) -> list[str]:
        if not getattr(job, "replicated_jobs", None):
            return ["a JobSet needs at least one replicated job"]
        names = [rj[0] for rj in job.replicated_jobs]
        if len(set(names)) != len(names):
            return ["replicated job names must be unique"]
        return []


def _elastic_job_allowed(job) -> bool:
    """The shared elastic gate: a kueue-managed job may use an external
    autoscaling mechanism only when ElasticJobsViaWorkloadSlices is on
    AND the job is elastic (raycluster_webhook.go:148,
    sparkapplication_webhook.go:129)."""
    from kueue_tpu_torch.config import features
    return (features.enabled("ElasticJobsViaWorkloadSlices")
            and getattr(job, "elastic", False))


MAX_POD_SETS = 18  # jobframework/constants.go:21
RAY_HEAD_GROUP = "head"  # raycluster_controller.go:44


@dataclass
class RayClusterWebhook(JobWebhook):
    """jobs/raycluster/raycluster_webhook.go."""

    kind: str = "ray.io/raycluster"

    def extra_create_rules(self, job) -> list[str]:
        errs = []
        if getattr(job, "enable_in_tree_autoscaling", False) \
                and not _elastic_job_allowed(job):
            errs.append(
                "spec.enableInTreeAutoscaling: Invalid value: a kueue "
                "managed job can use autoscaling only when the "
                "ElasticJobsViaWorkloadSlices feature gate is on and "
                "the job is an elastic job")
        groups = list(getattr(job, "worker_groups", ()))
        # MaxPodSets cap: head + worker groups (raycluster_webhook.go
        # validateCreate; field.TooMany over spec.workerGroupSpecs).
        if len(groups) + 1 > MAX_POD_SETS:
            errs.append(f"spec.workerGroupSpecs: Too many: "
                        f"{len(groups) + 1}: must have at most "
                        f"{MAX_POD_SETS} items")
        names = [g[0] for g in groups]
        for i, name in enumerate(names):
            if name == RAY_HEAD_GROUP:
                errs.append(
                    f"spec.workerGroupSpecs[{i}].groupName: Forbidden: "
                    f'"{RAY_HEAD_GROUP}" is reserved for the head group')
        if len(set(names)) != len(names):
            errs.append("worker group names must be unique")
        errs.extend(validate_topology_annotations(
            "spec.headGroupSpec.template.metadata",
            getattr(job, "head_annotations", None)))
        for i, g in enumerate(groups):
            # (name, replicas, requests[, annotations]) tuples.
            if len(g) > 3:
                errs.extend(validate_topology_annotations(
                    f"spec.workerGroupSpecs[{i}].template.metadata",
                    g[3]))
        return errs


@dataclass
class SparkApplicationWebhook(JobWebhook):
    """jobs/sparkapplication/sparkapplication_webhook.go."""

    kind: str = "sparkoperator.k8s.io/sparkapplication"
    gvk: str = "sparkoperator.k8s.io/v1beta2, Kind=SparkApplication"

    def extra_create_rules(self, job) -> list[str]:
        errs = []
        if getattr(job, "dynamic_allocation", False) \
                and not _elastic_job_allowed(job):
            errs.append(
                "spec.dynamicAllocation.enabled: Invalid value: true: "
                "a kueue managed job can use dynamicAllocation only "
                "when the ElasticJobsViaWorkloadSlices feature gate is "
                "on and the job is an elastic job")
        # Even WITH the gate on, the kind itself rejects the slice
        # opt-in annotation (sparkapplication_webhook_test.go
        # "dynamicAllocation with elastic job feature").
        errs.extend(reject_elastic_annotation(job, self.gvk))
        if getattr(job, "executor_instances", 1) < 0:
            errs.append("executor instances must be non-negative")
        errs.extend(validate_topology_annotations(
            "spec.driver", getattr(job, "driver_annotations", None)))
        errs.extend(validate_topology_annotations(
            "spec.executor", getattr(job, "executor_annotations", None)))
        return errs


@dataclass
class ServingScaleWebhook(JobWebhook):
    """Shared rules for serving-scale kinds (StatefulSet/Deployment):
    replicas bounds on create; scale is the ONLY mutable shape field
    while running — the per-kind webhooks reject pod-template mutation
    of a managed set, and the queue/priority labels freeze once any
    replica is READY (statefulset_webhook.go TestValidateUpdate keys
    immutability on status.readyReplicas, not on suspension — a
    scaled-to-zero set may re-queue)."""

    display: str = "workload"
    gvk: str = ""

    def extra_create_rules(self, job) -> list[str]:
        errs = []
        if getattr(job, "replicas", 1) < 0:
            errs.append("replicas must be non-negative")
        errs.extend(reject_elastic_annotation(job, self.gvk))
        return errs

    def validate_update(self, old, new) -> list[str]:
        errs = []
        ready = getattr(old, "ready_replicas", 0) > 0
        if old.queue_name and not new.queue_name:
            # Deleting the queue label orphans the managed set's
            # Workload: forbidden even at zero ready replicas
            # (statefulset_webhook_test.go "delete queue name").
            errs.append(f"{QUEUE_NAME_LABEL_PATH}: Invalid value: "
                        "queue name cannot be removed from a managed "
                        f"{self.display}")
        elif old.queue_name != new.queue_name and ready:
            errs.append(f"{QUEUE_NAME_LABEL_PATH}: Invalid value: "
                        "queue name is immutable while the "
                        f"{self.display} has ready replicas")
        if getattr(old, "priority", 0) != getattr(new, "priority", 0) \
                and ready:
            errs.append(f"{PRIORITY_CLASS_LABEL_PATH}: Invalid value: "
                        "priority is immutable while the "
                        f"{self.display} has ready replicas")
        if getattr(old, "prebuilt_workload_name", None) != \
                getattr(new, "prebuilt_workload_name", None):
            errs.append("prebuilt workload is immutable")
        if (getattr(old, "requests", None) != getattr(new, "requests",
                                                      None)
                and not old.is_suspended()):
            errs.append(f"pod template resources are immutable while "
                        f"the {self.display} is managed and running")
        errs.extend(validate_admission_gated_by_on_update(old, new))
        return errs


@dataclass
class StatefulSetWebhook(ServingScaleWebhook):
    """jobs/statefulset/statefulset_webhook.go."""

    kind: str = "apps/statefulset"
    display: str = "StatefulSet"
    gvk: str = "apps/v1, Kind=StatefulSet"


@dataclass
class DeploymentWebhook(ServingScaleWebhook):
    """jobs/deployment/deployment_webhook.go."""

    kind: str = "apps/deployment"
    display: str = "Deployment"
    gvk: str = "apps/v1, Kind=Deployment"


@dataclass
class LeaderWorkerSetWebhook(JobWebhook):
    """jobs/leaderworkerset/leaderworkerset_webhook.go: group shape
    bounds + topology-annotation exclusivity for the leader and worker
    templates."""

    kind: str = "leaderworkerset.x-k8s.io/leaderworkerset"

    def extra_create_rules(self, job) -> list[str]:
        errs = []
        if getattr(job, "replicas", 1) < 0:
            errs.append("spec.replicas: Invalid value: must be "
                        "non-negative")
        if getattr(job, "size", 1) <= 0:
            errs.append("spec.leaderWorkerTemplate.size: Invalid value: "
                        "must be positive")
        errs.extend(validate_topology_annotations(
            "spec.leaderWorkerTemplate.leaderTemplate.metadata",
            getattr(job, "leader_annotations", None)))
        errs.extend(validate_topology_annotations(
            "spec.leaderWorkerTemplate.workerTemplate.metadata",
            getattr(job, "worker_annotations", None)))
        return errs


@dataclass
class MPIJobWebhook(JobWebhook):
    """jobs/mpijob/mpijob_webhook.go."""

    kind: str = "kubeflow.org/mpijob"

    def extra_create_rules(self, job) -> list[str]:
        errs = []
        if getattr(job, "worker_replicas", 1) < 0:
            errs.append("worker replicas must be non-negative")
        if getattr(job, "slots_per_worker", 1) <= 0:
            errs.append("slotsPerWorker must be positive")
        if getattr(job, "run_launcher_as_worker", False) \
                and getattr(job, "worker_replicas", 1) == 0:
            errs.append("runLauncherAsWorker needs at least one worker")
        return errs


class JobWebhookRegistry:
    """Dispatches per-kind webhooks, the admission-webhook layer in front
    of JobReconciler.create_job."""

    def __init__(self, engine, integrations=None,
                 manage_jobs_without_queue_name: bool = False,
                 local_queue_defaulting: bool = True):
        from kueue_tpu_torch.controllers.jobframework import (
            DEFAULT_INTEGRATIONS,
        )

        self.engine = engine
        self.integrations = integrations or DEFAULT_INTEGRATIONS
        self.manage_jobs_without_queue_name = manage_jobs_without_queue_name
        self.local_queue_defaulting = local_queue_defaulting
        self.webhooks: dict[str, JobWebhook] = {
            "batch/job": BatchJobWebhook(),
            "jobset.x-k8s.io/jobset": JobSetWebhook(),
            "ray.io/raycluster": RayClusterWebhook(),
            "sparkoperator.k8s.io/sparkapplication":
                SparkApplicationWebhook(),
            "apps/statefulset": StatefulSetWebhook(),
            "apps/deployment": DeploymentWebhook(),
            "kubeflow.org/mpijob": MPIJobWebhook(),
            "leaderworkerset.x-k8s.io/leaderworkerset":
                LeaderWorkerSetWebhook(),
        }
        self._generic = JobWebhook()

    def register(self, kind: str, webhook: JobWebhook) -> None:
        self.webhooks[kind] = webhook

    def default_lq_exists(self, namespace: str) -> bool:
        if not self.local_queue_defaulting:
            return False
        return f"{namespace}/default" in self.engine.queues.local_queues

    def webhook_for(self, job) -> JobWebhook:
        kind = self.integrations.kind_of(job)
        return self.webhooks.get(kind, self._generic)

    def admit_create(self, job) -> list[str]:
        """Default + ValidateCreate; returns validation errors (empty =
        admitted)."""
        hook = self.webhook_for(job)
        hook.default(job, self)
        return hook.validate_create(job)

    def admit_update(self, old, new) -> list[str]:
        return self.webhook_for(new).validate_update(old, new)
