"""Apply-configuration analog: typed patch builders + server-side apply.

Reference: client-go/applyconfiguration/kueue/v1beta2 — generated
builders (``WithName``, ``WithSpec``...) whose product is applied with a
field manager; the apiserver merges the declared fields into the live
object, records per-field ownership, and rejects conflicting managers
unless forced. The engine has no apiserver, so ``ApplyEngine``
implements the merge + ownership bookkeeping over engine objects: a
manager owns exactly the fields it declared last apply; a second
manager applying a different value to an owned field gets an
``ApplyConflict`` naming the field and the current owner (the SSA
conflict message shape), or takes ownership with ``force=True``.

Ported from ``kueue_tpu/client/applyconfigurations.py``. A re-key
(priority or queue) of a pending workload goes through the queue
manager (delete, write, push), so the row cache re-reads the priority
at push and the next device cycle sees the new key, as the host heap
does. A stop-policy apply goes through this package's ``Kueuectl``.
None of these writes is an engine input a flight recorder sees (in
either package): a trace that must replay starts after them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

__all__ = ["ApplyConflict", "ApplyEngine", "WorkloadApply",
           "ClusterQueueApply", "LocalQueueApply"]


class ApplyConflict(Exception):
    def __init__(self, field_path: str, owner: str):
        super().__init__(
            f"Apply failed with 1 conflict: conflict with {owner!r}: "
            f"field {field_path!r}")
        self.field_path = field_path
        self.owner = owner


class _Builder:
    """Fluent ``with_*`` builder collecting declared fields."""

    def __init__(self):
        self._fields: dict[str, Any] = {}

    def declared(self) -> dict[str, Any]:
        return dict(self._fields)

    def _with(self, key: str, value):
        self._fields[key] = value
        return self


class WorkloadApply(_Builder):
    def __init__(self, namespace: str, name: str):
        super().__init__()
        self.namespace = namespace
        self.name = name

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def with_priority(self, priority: int) -> "WorkloadApply":
        return self._with("priority", priority)

    def with_queue_name(self, queue_name: str) -> "WorkloadApply":
        return self._with("queue_name", queue_name)

    def with_label(self, key: str, value: str) -> "WorkloadApply":
        return self._with(f"labels.{key}", value)

    def with_active(self, active: bool) -> "WorkloadApply":
        return self._with("active", active)


class ClusterQueueApply(_Builder):
    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def with_cohort(self, cohort: str) -> "ClusterQueueApply":
        return self._with("cohort", cohort)

    def with_namespace_selector(self, selector: dict
                                ) -> "ClusterQueueApply":
        return self._with("namespace_selector", dict(selector))


class LocalQueueApply(_Builder):
    def __init__(self, namespace: str, name: str):
        super().__init__()
        self.namespace = namespace
        self.name = name

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def with_stop_policy(self, policy: str) -> "LocalQueueApply":
        return self._with("stop_policy", policy)


@dataclass
class _Ownership:
    # field path -> manager name
    owners: dict[str, str] = field(default_factory=dict)


class ApplyEngine:
    """Server-side apply against a running engine."""

    def __init__(self, engine):
        self._engine = engine
        self._ownership: dict[str, _Ownership] = {}

    # -- merge core --

    def _check_and_own(self, obj_key: str, declared: dict,
                       manager: str, force: bool,
                       current_of) -> None:
        own = self._ownership.setdefault(obj_key, _Ownership())
        for path, value in declared.items():
            owner = own.owners.get(path)
            if owner is not None and owner != manager \
                    and current_of(path) != value:
                if not force:
                    raise ApplyConflict(path, owner)
        for path in declared:
            own.owners[path] = manager

    @staticmethod
    def _get_path(obj, path: str):
        if path.startswith("labels."):
            return (getattr(obj, "labels", None) or {}).get(
                path.split(".", 1)[1])
        return getattr(obj, path, None)

    @staticmethod
    def _set_path(obj, path: str, value) -> None:
        if path.startswith("labels."):
            labels = getattr(obj, "labels", None)
            if labels is None:
                labels = {}
                obj.labels = labels
            labels[path.split(".", 1)[1]] = value
        else:
            setattr(obj, path, value)

    # -- typed apply verbs --

    def apply_workload(self, cfg: WorkloadApply, field_manager: str,
                       force: bool = False):
        wl = self._engine.workloads.get(cfg.key)
        if wl is None:
            raise KeyError(f"workload {cfg.key} not found")
        declared = cfg.declared()
        rekey = any(path in ("queue_name", "priority")
                    and self._get_path(wl, path) != value
                    for path, value in declared.items())
        # Validate BEFORE ownership is recorded: a failed apply must not
        # grant the manager the field (SSA records managedFields only on
        # success). The target-queue check applies only to actual queue
        # MOVES — a priority-only rekey must keep working even when the
        # workload's current LocalQueue has been deleted.
        if rekey and not wl.is_admitted and "queue_name" in declared:
            new_q = declared["queue_name"]
            if self._engine.queues.local_queues.get(
                    f"{wl.namespace}/{new_q}") is None:
                raise KeyError(
                    f"LocalQueue {wl.namespace}/{new_q} not found")
        self._check_and_own(
            f"workload/{cfg.key}", declared, field_manager, force,
            lambda p: self._get_path(wl, p))
        if rekey and not wl.is_admitted:
            # Queue moves AND priority changes re-route the pending
            # entry through the manager (queue_controller's
            # UpdateWorkload path) so the heap key and tensor row are
            # recomputed; mutating in place would leave the workload
            # competing at its old key.
            self._engine.queues.delete_workload(wl)
        for path, value in declared.items():
            self._set_path(wl, path, value)
        if rekey and not wl.is_admitted:
            if self._engine.queues.add_or_update_workload(wl) is None:
                # Gated out (held queue / inactive): surface it — the
                # submit path would have evented; silence strands.
                self._engine._event(
                    "WorkloadHeld", wl.key,
                    detail=f"queue {wl.queue_name} is not accepting "
                           f"workloads")
        return wl

    def apply_cluster_queue(self, cfg: ClusterQueueApply,
                            field_manager: str, force: bool = False):
        cq = self._engine.cache.cluster_queues.get(cfg.name)
        if cq is None:
            raise KeyError(f"clusterqueue {cfg.name} not found")
        declared = cfg.declared()
        self._check_and_own(
            f"clusterqueue/{cfg.name}", declared, field_manager, force,
            lambda p: self._get_path(cq, p))
        updated = replace(cq, **declared)
        # create_cluster_queue is an upsert (Cache
        # add_or_update_cluster_queue bumps spec_version, requeues).
        self._engine.create_cluster_queue(updated)
        return self._engine.cache.cluster_queues.get(cfg.name)

    def apply_local_queue(self, cfg: LocalQueueApply,
                          field_manager: str, force: bool = False):
        lq = self._engine.queues.local_queues.get(cfg.key)
        if lq is None:
            raise KeyError(f"localqueue {cfg.key} not found")
        declared = cfg.declared()
        self._check_and_own(
            f"localqueue/{cfg.key}", declared, field_manager, force,
            lambda p: self._get_path(lq, p))
        new_policy = declared.pop("stop_policy", None)
        for path, value in declared.items():
            self._set_path(lq, path, value)
        if new_policy is not None and new_policy != lq.stop_policy:
            # Stop-policy transitions go through the kueuectl machinery
            # (stop/stop_localqueue.go): Hold retracts the LQ's pending
            # workloads, HoldAndDrain also evicts reserved ones, None
            # re-queues — a bare field write would only gate future
            # submissions. Unknown values are rejected like the CRD
            # enum would, NOT treated as a resume.
            from kueue_tpu_torch.api.types import StopPolicy
            from kueue_tpu_torch.cli.kueuectl import Kueuectl

            ctl = Kueuectl(self._engine)
            if new_policy == StopPolicy.HOLD:
                ctl.stop_local_queue(cfg.key, drain=False)
            elif new_policy == StopPolicy.HOLD_AND_DRAIN:
                ctl.stop_local_queue(cfg.key, drain=True)
            elif new_policy == StopPolicy.NONE:
                ctl.resume_local_queue(cfg.key)
            else:
                raise ValueError(
                    f"invalid stopPolicy {new_policy!r}: must be one "
                    f"of None, Hold, HoldAndDrain")
        return lq

    def field_owners(self, kind: str, key: str) -> dict[str, str]:
        """managedFields view: field path -> manager."""
        own = self._ownership.get(f"{kind}/{key}")
        return dict(own.owners) if own else {}
