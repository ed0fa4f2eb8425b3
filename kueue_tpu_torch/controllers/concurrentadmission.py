"""Concurrent admission (KEP 8691): evaluate a workload on several
ResourceFlavors at once via per-flavor Workload variants; migration
policy decides whether a later, more-preferred admission replaces an
earlier, less-preferred one.

The port of ``kueue_tpu/controllers/concurrentadmission.py``. The
engine's plumbing carries the variants: ``allowed_resource_flavor`` pins
a variant's flavor in the flavor assigner and in the row cache's key,
and the preemption gates hold a variant's preemption until the gate
rotation opens it. Reference:
pkg/controller/concurrentadmission/controller.go: variants are clones
of the parent pinned to one flavor (WorkloadAllowedResourceFlavor
annotation, :356 generateVariant), carry a closed ConcurrentAdmission
preemption gate (ungated one at a time with a 5-minute timeout), and
are activated/deactivated per the CQ's migration mode (:485-610):

  * RetainFirstAdmission — the first admitted variant wins; every other
    variant is deactivated.
  * TryPreferredFlavors — variants on more-preferred flavors keep
    running even after a less-preferred variant admits; when one of
    them admits, the less-preferred admitted variant is evicted and
    deactivated (the migration), optionally bounded below by
    lastAcceptableFlavorName.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import Workload, WorkloadConditionType

CONCURRENT_ADMISSION_GATE = "kueue.x-k8s.io/concurrent-admission"
PREEMPTION_TIMEOUT = 300.0  # controller.go:68 preemptionTimeout

RETAIN_FIRST_ADMISSION = "RetainFirstAdmission"
TRY_PREFERRED_FLAVORS = "TryPreferredFlavors"


@dataclass
class ConcurrentAdmissionPolicy:
    """clusterqueue_types.go ConcurrentAdmissionPolicy (migration)."""

    mode: str = RETAIN_FIRST_ADMISSION
    last_acceptable_flavor: Optional[str] = None


@dataclass
class _VariantGroup:
    parent: Workload
    cluster_queue: str
    policy: ConcurrentAdmissionPolicy
    flavor_order: list[str]  # preference order (CQ resource-group order)
    variants: dict[str, str] = field(default_factory=dict)  # flavor -> key
    done: bool = False


class ConcurrentAdmissionController:
    def __init__(self, engine):
        self.engine = engine
        self.groups: dict[str, _VariantGroup] = {}

    # -- fan-out (controller.go:307 createVariants) --

    def submit_concurrent(self, wl: Workload, queue_name: str,
                          policy: ConcurrentAdmissionPolicy = None
                          ) -> list[Workload]:
        """Create one preemption-gated variant per CQ flavor, pinned to
        that flavor. The parent itself is never queued — it tracks the
        family (ConcurrentAdmissionParentLabelKey relationship)."""
        eng = self.engine
        if wl.key in self.groups:
            # Idempotent re-submit: the existing fan-out keeps tracking
            # its (possibly admitted) variants.
            group = self.groups[wl.key]
            return [eng.workloads[k] for k in group.variants.values()
                    if k in eng.workloads]
        lq = eng.queues.local_queues.get(f"{wl.namespace}/{queue_name}")
        cq = (eng.cache.cluster_queues.get(lq.cluster_queue)
              if lq is not None else None)
        if cq is None:
            return []
        flavor_order: list[str] = []
        for rg in cq.resource_groups:
            for fq in rg.flavors:
                if fq.name not in flavor_order:
                    flavor_order.append(fq.name)
        group = _VariantGroup(
            parent=wl, cluster_queue=cq.name,
            policy=policy or ConcurrentAdmissionPolicy(),
            flavor_order=flavor_order)
        created = []
        for flavor in flavor_order:
            variant = copy.deepcopy(wl)
            variant.name = f"{wl.name}-{flavor}"
            variant.queue_name = queue_name
            variant.allowed_resource_flavor = flavor
            variant.preemption_gates = ()
            variant.ensure_preemption_gate(CONCURRENT_ADMISSION_GATE)
            variant.uid = ""
            variant.__post_init__()
            if eng.submit(variant):
                group.variants[flavor] = variant.key
                created.append(variant)
                eng._event("CreatedVariant", variant.key,
                           cluster_queue=cq.name, detail=flavor)
        self.groups[wl.key] = group
        return created

    # -- the reconcile pass (controller.go:188) --

    def reconcile(self) -> None:
        for group in self.groups.values():
            if group.done:
                continue
            self._sync_group(group)

    def _order(self, group: _VariantGroup, flavor: str) -> int:
        try:
            return group.flavor_order.index(flavor)
        except ValueError:
            return len(group.flavor_order)

    def _admitted_variant(self, group: _VariantGroup
                          ) -> Optional[tuple[str, Workload]]:
        """The most-preferred admitted variant (getAdmittedVariant over
        the sorted family)."""
        best = None
        for flavor, key in group.variants.items():
            wl = self.engine.workloads.get(key)
            if wl is not None and wl.is_admitted:
                if best is None or self._order(group, flavor) \
                        < self._order(group, best[0]):
                    best = (flavor, wl)
        return best

    def _sync_group(self, group: _VariantGroup) -> None:
        eng = self.engine
        if not group.parent.active:
            self._deactivate(group, lambda f, wl: True,
                             "parent not active")
            group.done = True
            return
        admitted = self._admitted_variant(group)
        if admitted is None:
            self._maybe_ungate(group)
            return
        adm_flavor, adm_wl = admitted
        mode = group.policy.mode
        if mode == RETAIN_FIRST_ADMISSION:
            self._deactivate(
                group, lambda f, wl: wl.key != adm_wl.key,
                f"RetainFirstAdmission: variant {adm_wl.name} admitted")
            group.done = True
            return
        # TryPreferredFlavors (controller.go:519-553): kill variants less
        # preferred than the admitted one (and anything below the
        # lastAcceptableFlavor); keep more-preferred ones racing. The
        # admitted variant itself is MIGRATED AWAY FROM when a
        # more-preferred variant admits — it matches the "less preferred
        # than admitted" predicate of that later pass.
        last = group.policy.last_acceptable_flavor
        if last is not None:
            self._deactivate(
                group,
                lambda f, wl: (wl.key != adm_wl.key and self._order(
                    group, f) > self._order(group, last)),
                f"below lastAcceptableFlavor {last}")
        self._deactivate(
            group,
            lambda f, wl: self._order(group, f) > self._order(
                group, adm_flavor) and wl.key != adm_wl.key,
            f"lower preference than admitted variant {adm_wl.name}")
        if self._order(group, adm_flavor) == 0:
            group.done = True  # best possible flavor admitted
            return
        self._maybe_ungate(group)

    # -- gate rotation (ReasonPreemptionUngatedVariant) --

    def _maybe_ungate(self, group: _VariantGroup) -> None:
        """Open one variant's preemption gate at a time, most preferred
        flavor first, rotating on PREEMPTION_TIMEOUT like MultiKueue's
        orchestrated preemption."""
        now = self.engine.clock
        previous_open = None
        stale: list[Workload] = []
        candidate = None
        for flavor in group.flavor_order:
            key = group.variants.get(flavor)
            wl = self.engine.workloads.get(key) if key else None
            if wl is None or not wl.active or wl.is_finished:
                continue
            opened = wl.status.open_preemption_gates.get(
                CONCURRENT_ADMISSION_GATE)
            if opened is not None:
                stale.append(wl)
                if previous_open is None or opened > previous_open:
                    previous_open = opened
                continue
            cond = wl.condition(
                WorkloadConditionType.BLOCKED_ON_PREEMPTION_GATES)
            if cond is None or not cond.status:
                continue
            if candidate is None:
                candidate = wl
        if candidate is None:
            return
        if previous_open is not None \
                and now - previous_open < PREEMPTION_TIMEOUT:
            return
        # Rotation RE-CLOSES the stalled gate so only one variant holds
        # preemption rights at a time (unlike MultiKueue's cross-cluster
        # gates, these are same-engine and safely closable).
        for wl in stale:
            wl.status.open_preemption_gates.pop(
                CONCURRENT_ADMISSION_GATE, None)
        candidate.open_preemption_gate(CONCURRENT_ADMISSION_GATE, now)
        self.engine._event("PreemptionUngatedVariant", candidate.key)
        self.engine.queues.queue_inadmissible_workloads()

    # -- helpers --

    def _deactivate(self, group: _VariantGroup, predicate,
                    message: str) -> None:
        """deactivateMatchingVariants (controller.go:469): deactivate +
        evict matching variants."""
        eng = self.engine
        for flavor, key in group.variants.items():
            wl = eng.workloads.get(key)
            if wl is None or not wl.active or wl.is_finished:
                continue
            if not predicate(flavor, wl):
                continue
            wl.active = False
            if wl.has_quota_reservation:
                eng.evict(wl, "ConcurrentAdmissionLost", requeue=False)
            eng.queues.delete_workload(wl)
            eng._event("DeactivatedVariant", wl.key, detail=message)

    def winner_of(self, parent_key: str) -> Optional[Workload]:
        group = self.groups.get(parent_key)
        if group is None:
            return None
        best = self._admitted_variant(group)
        return best[1] if best is not None else None
