"""Admission checks (kueue_tpu_torch/controllers/admissionchecks.py and
the engine's check gate, ``reconcile_workload`` and Retry backoff)
against the JAX package's engine on the same calls.

The engine-only cases of tests/test_admission_checks.py run through
``MirroredEngine`` (tests/test_torch_engine.py), with
``MirroredCheckManager`` and ``MirroredProvisioningController`` patched
in: every cycle's decisions, every workload's check states, evictions,
requeue backoff and conditions, and the event streams must equal the JAX
engine's, on the host cycle and with the oracle attached (quota is then
reserved on the device path and the checked admit runs per entry).
Exact throughout. The module's two cases that start jobs through
``jobframework`` are not ported."""

import pytest

import test_admission_checks
from kueue_tpu.api.types import (
    ClusterQueue,
    Cohort,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_tpu.controllers.admissionchecks import AdmissionCheck, CheckState
from test_torch_engine import (  # noqa: F401  (mirrored is a fixture)
    MirroredCheckManager,
    MirroredEngine,
    MirroredProvisioningController,
    OracleMirroredEngine,
    mirrored,
)

ENGINE_CASES = [
    "test_quota_reserved_but_not_admitted_until_check_ready",
    "test_quota_held_while_check_pending",
    "test_check_retry_evicts_and_requeues",
    "test_check_reject_deactivates",
    "test_provisioning_controller_flow",
    "test_provisioning_failure_retries_then_rejects",
    "test_multiple_checks_all_required",
    "test_requeue_backoff_delays_retry",
    "test_maximum_execution_time",
    "test_provisioning_retry_backoff_curve",
]


@pytest.mark.parametrize("engine", [MirroredEngine, OracleMirroredEngine],
                         ids=["sequential", "device"])
@pytest.mark.parametrize("name", ENGINE_CASES)
def test_admission_check_cases(mirrored, monkeypatch, engine, name):
    monkeypatch.setattr(test_admission_checks, "Engine", engine)
    monkeypatch.setattr(test_admission_checks, "AdmissionCheckManager",
                        MirroredCheckManager)
    monkeypatch.setattr(test_admission_checks, "ProvisioningController",
                        MirroredProvisioningController)
    getattr(test_admission_checks, name)()


def test_cases_cover_the_engine_only_tests():
    """Every test of the reference module is mirrored here but the two
    that start jobs through jobframework."""
    names = {n for n in dir(test_admission_checks) if n.startswith("test_")}
    assert names - set(ENGINE_CASES) == {
        "test_provisioning_pod_set_updates_flow_into_started_job",
        "test_pod_set_update_conflict_fails_start"}


@pytest.mark.parametrize("engine", [MirroredEngine, OracleMirroredEngine],
                         ids=["sequential", "device"])
def test_undefined_check_makes_the_queue_inactive(mirrored, engine):
    """A ClusterQueue naming a check no manager defines is inactive
    (AdmissionCheckNotFound): the host cycle reserves nothing on it until
    the check is defined. The JAX bridge does not consult the inactive
    set, and its device cycle reserves quota all the same; the port's
    does as the JAX one does."""
    eng = engine()
    acm = MirroredCheckManager(eng)
    eng.create_resource_flavor(ResourceFlavor("default"))
    eng.create_cluster_queue(ClusterQueue(
        name="cq", admission_checks=("later",),
        resource_groups=(ResourceGroup(("cpu",), (FlavorQuotas(
            "default", {"cpu": ResourceQuota(4000)}),)),)))
    eng.create_local_queue(LocalQueue("lq", "default", "cq"))
    eng.clock += 1
    wl = Workload(name="w", queue_name="lq",
                  pod_sets=(PodSet("main", 1, {"cpu": 1000}),))
    eng.submit(wl)
    assert eng.port.cache.inactive_cluster_queues() == {"cq"}
    eng.schedule_once()
    assert wl.has_quota_reservation == (engine is OracleMirroredEngine)
    acm.create_admission_check(AdmissionCheck("later"))
    assert eng.port.cache.inactive_cluster_queues() == set()
    eng.schedule_once()
    assert wl.has_quota_reservation and not wl.is_admitted
    acm.set_state(wl.key, "later", CheckState.READY)
    assert wl.is_admitted


@pytest.mark.parametrize("seed", range(3))
def test_checked_cohort_churn_on_device(mirrored, seed):
    """Checked and unchecked ClusterQueues in two cohorts, a provisioning
    controller failing every third request: reservations on the device
    path, Retry evictions with backoff, rejections, admissions once
    Ready, finishes, all as in the JAX engine."""
    import random

    rng = random.Random(seed)
    eng = OracleMirroredEngine()
    acm = MirroredCheckManager(eng)
    acm.create_admission_check(AdmissionCheck("prov"))
    prov = MirroredProvisioningController(eng, "prov", max_retries=2)
    eng.create_resource_flavor(ResourceFlavor("default"))
    for c in range(2):
        eng.create_cohort(Cohort(f"co{c}"))
    for i in range(4):
        eng.create_cluster_queue(ClusterQueue(
            name=f"cq{i}", cohort=f"co{i % 2}",
            admission_checks=("prov",) if i % 2 else (),
            resource_groups=(ResourceGroup(("cpu",), (FlavorQuotas(
                "default", {"cpu": ResourceQuota(2000)}),)),)))
        eng.create_local_queue(LocalQueue(f"lq{i}", "default", f"cq{i}"))
    n = 0
    for step in range(25):
        for _ in range(rng.randrange(3)):
            eng.clock += 0.01
            eng.submit(Workload(
                name=f"w{n}", queue_name=f"lq{rng.randrange(4)}",
                priority=rng.choice([0, 5]),
                pod_sets=(PodSet("main", 1, {"cpu": rng.choice(
                    [400, 900])}),)))
            n += 1
        eng.schedule_once()
        prov.reconcile()
        reserved = [k for k, w in eng.workloads.items()
                    if w.has_quota_reservation and not w.is_admitted]
        for i, k in enumerate(reserved):
            if (step + i) % 3 == 0:
                prov.mark_failed(k)
            else:
                prov.mark_provisioned(k)
        eng.tick(rng.choice([1.0, 30.0, 90.0]))
        done = [k for k, w in eng.workloads.items()
                if w.is_admitted and not w.is_finished]
        for k in done[:rng.randrange(3)]:
            eng.finish(k)
    assert eng.oracle.cycles_on_device > 0
    assert any(w.status.eviction_counts.get("AdmissionCheckRetry")
               for w in eng.workloads.values())
