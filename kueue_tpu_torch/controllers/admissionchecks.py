"""Two-phase admission: AdmissionChecks.

Reference: apis/kueue AdmissionCheck CRD + pkg/controller/core
(reconcileSyncAdmissionChecks / reconcileCheckBasedEviction,
workload_controller.go:901-951) + the ProvisioningRequest check controller
(pkg/controller/admissionchecks/provisioning/controller.go:123).

Flow (SURVEY.md §3.4): the scheduler reserves quota (QuotaReserved);
check controllers then flip their AdmissionCheckState to Ready /
Retry / Rejected; the workload controller admits when ALL required
checks are Ready, and evicts + requeues (Retry) or deactivates
(Rejected) otherwise.

A copy of ``kueue_tpu/controllers/admissionchecks.py``. A ClusterQueue
with checks reserves quota on the device path as any other; only the
apply differs (``Engine.bulk_assume_batch`` sends every entry through the
per-entry ``_admit`` once a manager is attached).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from kueue_tpu_torch.api.types import Workload


class CheckState(str, Enum):
    PENDING = "Pending"
    READY = "Ready"
    RETRY = "Retry"
    REJECTED = "Rejected"


@dataclass
class AdmissionCheck:
    """Reference: admissioncheck_types.go:48."""

    name: str
    controller_name: str = ""
    retry_delay_seconds: int = 60


@dataclass(frozen=True)
class PodSetUpdate:
    """Additive per-PodSet modifications an admission check suggests
    (workload_types.go:845 PodSetUpdate): merged into the job's pod sets
    when it starts; conflicting keys across checks fail admission."""

    name: str
    labels: tuple = ()  # ((key, value), ...) — hashable
    annotations: tuple = ()
    node_selector: tuple = ()
    tolerations: tuple = ()

    @classmethod
    def make(cls, name, labels=None, annotations=None, node_selector=None,
             tolerations=()) -> "PodSetUpdate":
        return cls(name=name,
                   labels=tuple(sorted((labels or {}).items())),
                   annotations=tuple(sorted((annotations or {}).items())),
                   node_selector=tuple(sorted((node_selector or {}).items())),
                   tolerations=tuple(tolerations))


@dataclass
class ProvisioningRequestRetryStrategy:
    """provisioningrequestconfig_types.go:127: retry backoff is
    min(base * 2^(attempt-1), max), capped at backoff_limit_count
    attempts before the check rejects."""

    backoff_limit_count: int = 3
    backoff_base_seconds: int = 60
    backoff_max_seconds: int = 1800

    def delay(self, attempt: int) -> float:
        return min(self.backoff_base_seconds * (2 ** max(attempt - 1, 0)),
                   self.backoff_max_seconds)


@dataclass
class ProvisioningRequestConfig:
    """provisioningrequestconfig_types.go:35: how the check controller
    shapes ProvisioningRequests and what it injects back.
    ``pod_set_update_node_selectors`` maps a node-selector key to the
    ProvisioningClassDetails detail it reads the value from
    (controller.go:652 podSetUpdates)."""

    name: str = "default"
    provisioning_class_name: str = "queued-provisioning.gke.io"
    pod_set_update_node_selectors: dict[str, str] = field(
        default_factory=dict)
    retry_strategy: ProvisioningRequestRetryStrategy = field(
        default_factory=ProvisioningRequestRetryStrategy)


class AdmissionCheckManager:
    """Holds check definitions and per-workload states; drives the
    admit-when-all-ready rule for the engine."""

    def __init__(self, engine):
        self.engine = engine
        self.checks: dict[str, AdmissionCheck] = {}
        engine.admission_checks = self
        # CQs referencing undefined checks are inactive
        # (inactiveReason AdmissionCheckNotFound).
        engine.cache.admission_check_names = lambda: set(self.checks)

    def _requeue_after_registry_change(self) -> None:
        self.engine.queues.queue_inadmissible_workloads()

    def create_admission_check(self, check: AdmissionCheck) -> None:
        self.checks[check.name] = check
        self._requeue_after_registry_change()

    def delete_admission_check(self, name: str) -> None:
        self.checks.pop(name, None)
        self._requeue_after_registry_change()

    def required_for(self, cq_name: str,
                     wl: Optional[Workload] = None) -> tuple[str, ...]:
        """The CQ's checks plus the admissionChecksStrategy checks whose
        flavor scope matches the workload's assigned flavors
        (clusterqueue_types.go:166-189, workload.AdmissionChecksForWorkload)."""
        cq = self.engine.cache.cluster_queues.get(cq_name)
        if cq is None:
            return ()
        out = list(cq.admission_checks)
        strategy = getattr(cq, "admission_checks_strategy", None) or {}
        if strategy:
            assigned: set[str] = set()
            if wl is not None and wl.status.admission is not None:
                for psa in wl.status.admission.pod_set_assignments:
                    assigned |= set(psa.flavors.values())
            for check, flavors in strategy.items():
                if not flavors or (assigned & set(flavors)):
                    if check not in out:
                        out.append(check)
        return tuple(out)

    def sync_states(self, wl: Workload, cq_name: str) -> None:
        """reconcileSyncAdmissionChecks: seed Pending states for the CQ's
        checks (workload_controller.go:934)."""
        for name in self.required_for(cq_name, wl):
            wl.status.admission_check_states.setdefault(
                name, CheckState.PENDING)

    def all_ready(self, wl: Workload, cq_name: str) -> bool:
        """workload.HasAllRequiredChecks (scheduler.go:914)."""
        return all(
            wl.status.admission_check_states.get(name) == CheckState.READY
            for name in self.required_for(cq_name, wl))

    def set_state(self, wl_key: str, check: str, state: CheckState) -> None:
        """A check controller reporting its verdict; triggers the workload
        controller pass."""
        wl = self.engine.workloads.get(wl_key)
        if wl is None:
            return
        wl.status.admission_check_states[check] = state
        self.engine.reconcile_workload(wl)


@dataclass
class ProvisioningRequest:
    """The external provisioning object the check controller creates
    (provisioning/controller.go:248 syncOwnedProvisionRequest)."""

    name: str
    workload_key: str
    check_name: str
    provisioned: bool = False
    failed: bool = False
    attempts: int = 1
    # What the autoscaler reports about the provisioned capacity
    # (autoscaling ProvisioningRequest.Status.ProvisioningClassDetails),
    # the source of injected node-selector values.
    provisioning_class_details: dict[str, str] = field(default_factory=dict)


class ProvisioningController:
    """admissionchecks/provisioning: creates a ProvisioningRequest per
    quota-reserved workload carrying this check, then mirrors the
    request's outcome into the check state; on success it attaches
    PodSetUpdates (provisioning annotations + node selectors resolved
    from the request's ProvisioningClassDetails, controller.go:652)."""

    def __init__(self, engine, check_name: str, max_retries: int = None,
                 config: ProvisioningRequestConfig = None):
        import copy as _copy

        self.engine = engine
        self.check_name = check_name
        # Deep-copy so a max_retries override can't mutate a config
        # object shared with other controllers.
        self.config = _copy.deepcopy(config) if config is not None \
            else ProvisioningRequestConfig()
        if max_retries is not None:
            self.config.retry_strategy.backoff_limit_count = max_retries
        self.requests: dict[str, ProvisioningRequest] = {}

    def _pod_set_updates(self, wl: Workload,
                         req: ProvisioningRequest) -> tuple:
        """controller.go:652 podSetUpdates: every PodSet gets the
        provisioning-request annotations; node selectors are looked up in
        the request's ProvisioningClassDetails (missing details are
        skipped, not errors)."""
        annotations = {
            "autoscaling.x-k8s.io/provisioning-request": req.name,
            "autoscaling.x-k8s.io/provisioning-class":
                self.config.provisioning_class_name,
        }
        selector = {}
        for key, detail in self.config.pod_set_update_node_selectors.items():
            value = req.provisioning_class_details.get(detail)
            if value is not None:
                selector[key] = value
        return tuple(
            PodSetUpdate.make(ps.name, annotations=annotations,
                              node_selector=selector)
            for ps in wl.pod_sets)

    def reconcile(self) -> None:
        """provisioning/controller.go:123 (Reconcile over workloads)."""
        acm = self.engine.admission_checks
        retry = self.config.retry_strategy
        for wl in list(self.engine.workloads.values()):
            if wl.is_finished or not wl.has_quota_reservation:
                continue
            cq = (wl.status.admission.cluster_queue
                  if wl.status.admission else "")
            if self.check_name not in acm.required_for(cq, wl):
                continue
            state = wl.status.admission_check_states.get(self.check_name)
            if state in (CheckState.READY, CheckState.REJECTED):
                continue
            req = self.requests.get(wl.key)
            if req is None:
                req = ProvisioningRequest(
                    name=f"prov-{wl.name}", workload_key=wl.key,
                    check_name=self.check_name)
                self.requests[wl.key] = req
            if req.provisioned:
                wl.status.admission_check_updates[self.check_name] = \
                    self._pod_set_updates(wl, req)
                acm.set_state(wl.key, self.check_name, CheckState.READY)
            elif req.failed:
                if req.attempts > retry.backoff_limit_count:
                    acm.set_state(wl.key, self.check_name,
                                  CheckState.REJECTED)
                else:
                    # UpdateAdmissionCheckRequeueState
                    # (controller.go:576): exponential backoff before the
                    # next attempt. Concurrent Retry verdicts from other
                    # checks keep the longest backoff.
                    wl.status.check_retry_after_seconds = max(
                        wl.status.check_retry_after_seconds,
                        retry.delay(req.attempts))
                    req.attempts += 1
                    req.failed = False
                    acm.set_state(wl.key, self.check_name, CheckState.RETRY)

    # -- the "cluster autoscaler" side, driven by tests/mimics --

    def mark_provisioned(self, wl_key: str, details=None) -> None:
        req = self.requests.get(wl_key)
        if req is not None:
            req.provisioned = True
            if details:
                req.provisioning_class_details.update(details)
        self.reconcile()

    def mark_failed(self, wl_key: str) -> None:
        req = self.requests.get(wl_key)
        if req is not None:
            req.failed = True
        self.reconcile()
