"""MultiKueue per-framework job adapters.

The port of ``kueue_tpu/controllers/multikueue_adapters.py``, over the
port's ``controllers/jobframework.py`` and ``integrations.py``.

Reference: pkg/controller/jobframework/multikueue.go (MultiKueueAdapter —
SyncJob / DeleteRemoteObject / IsJobManagedByKueue / GVK) and the
per-integration implementations (e.g.
pkg/controller/jobs/job/job_multikueue_adapter.go). The manager mirrors
the *job object* (not just the Workload) to the winning worker cluster:
the remote job carries a prebuilt-workload reference so the worker's
jobframework adopts the mirrored Workload instead of creating its own,
and the remote job's status is copied back to the manager's job on every
sync.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Protocol

MULTIKUEUE_ORIGIN_LABEL = "kueue.x-k8s.io/multikueue-origin"


class MultiKueueAdapter(Protocol):
    """multikueue.go:31 (MultiKueueAdapter)."""

    def gvk(self) -> str: ...

    def is_job_managed_by_kueue(self, job) -> tuple[bool, str]: ...

    def sync_job(self, local_job, worker_reconciler, workload_name: str,
                 origin: str): ...

    def delete_remote_object(self, worker_reconciler, job_key: str) -> None: ...


@dataclass
class GenericJobAdapter:
    """A shape-generic adapter: works for any GenericJob whose dataclass
    can be deep-copied. Per-framework adapters subclass to refine the
    status sync (job_multikueue_adapter.go copies .Status verbatim
    guarded by start-suspension rules)."""

    kind: str = "batch/job"
    # Status fields copied remote -> local on sync.
    status_fields: tuple[str, ...] = ("active_pods", "succeeded", "failed")

    def gvk(self) -> str:
        return self.kind

    def is_job_managed_by_kueue(self, job) -> tuple[bool, str]:
        """job_multikueue_adapter.go IsJobManagedByKueue: the job must be
        queue-managed (or carry a prebuilt workload)."""
        if getattr(job, "queue_name", "") or getattr(
                job, "prebuilt_workload_name", None):
            return True, ""
        return False, "no queue name"

    def sync_job(self, local_job, worker_reconciler, workload_name: str,
                 origin: str):
        """SyncJob: create the remote job if absent (labeled with the
        origin + bound to the prebuilt mirrored Workload), else copy the
        remote status back onto the local job. Returns the remote job."""
        remote = worker_reconciler.jobs.get(local_job.key)
        if remote is None:
            remote = copy.deepcopy(local_job)
            remote.prebuilt_workload_name = workload_name
            remote.origin = origin
            # Remote jobs start unsuspended only via their own admission.
            if hasattr(remote, "suspended"):
                remote.suspended = True
            for f in self.status_fields:
                if hasattr(remote, f):
                    setattr(remote, f, 0 if isinstance(
                        getattr(remote, f), int) else None)
            worker_reconciler.create_job(remote)
            return remote
        # Status sync-back: the reference defers while the local job is
        # suspended (suspend-validation); here local status mirrors are
        # plain fields, safe to copy when running or finished.
        for f in self.status_fields:
            if hasattr(remote, f) and hasattr(local_job, f):
                setattr(local_job, f, getattr(remote, f))
        for flag in ("done", "success"):
            if hasattr(remote, flag) and hasattr(local_job, flag):
                setattr(local_job, flag, getattr(remote, flag))
        return remote

    def delete_remote_object(self, worker_reconciler, job_key: str) -> None:
        worker_reconciler.delete_job(job_key)


@dataclass
class BatchJobAdapter(GenericJobAdapter):
    """pkg/controller/jobs/job/job_multikueue_adapter.go."""

    kind: str = "batch/job"
    status_fields: tuple[str, ...] = ("active_pods", "succeeded", "failed")


@dataclass
class JobSetAdapter(GenericJobAdapter):
    """pkg/controller/jobs/jobset/jobset_multikueue_adapter.go."""

    kind: str = "jobset.x-k8s.io/jobset"
    status_fields: tuple[str, ...] = ("active",)


DEFAULT_ADAPTERS: dict[str, MultiKueueAdapter] = {
    "batch/job": BatchJobAdapter(),
    "jobset.x-k8s.io/jobset": JobSetAdapter(),
}

# Every other integration's jobs share the _BaseJob status shape
# (active/done/success), so the generic adapter with those fields covers
# them — the analog of the reference's per-framework
# <kind>_multikueue_adapter.go files, which differ only in the status
# stanza they copy.
for _kind in ("kubeflow.org/trainingjob", "kubeflow.org/trainjob",
              "kubeflow.org/mpijob", "ray.io/raycluster", "ray.io/rayjob",
              "ray.io/rayservice", "workload.codeflare.dev/appwrapper",
              "leaderworkerset.x-k8s.io/leaderworkerset", "core/pod",
              "core/podgroup", "apps/statefulset", "apps/deployment",
              "sparkoperator.k8s.io/sparkapplication", "apps/serving"):
    DEFAULT_ADAPTERS[_kind] = GenericJobAdapter(
        kind=_kind, status_fields=("active",))


def adapter_for(job, adapters: Optional[dict] = None,
                integrations=None) -> Optional[MultiKueueAdapter]:
    """Resolve the adapter for a job via the integration registry
    (multikueue.go GVK dispatch)."""
    table = adapters if adapters is not None else DEFAULT_ADAPTERS
    if integrations is None:
        return None
    kind = integrations.kind_of(job)
    return table.get(kind) if kind is not None else None
