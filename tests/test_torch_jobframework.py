"""The port's job path (controllers/jobframework.py, controllers/
integrations.py, webhooks/jobwebhooks.py, webhooks/validators.py and
the engine's holds) against the JAX package's.

Every case of tests/test_jobframework.py (6), tests/
test_integrations_parity.py (8) and tests/test_job_webhooks.py (9), and
the two cases of tests/test_admission_checks.py that start jobs
(``:160``, ``:224``), runs twice, as ``test_torch_resources`` runs its
cases: on the JAX package, and on the port with the module's globals and
in-body imports pointed at the port's, both from one uid and one
workload-name counter value (ROADMAP trap (a)). The port run passes the
case's own assertions (its jobs suspended, started, injected and
rejected as the case expects), and every engine the two runs build ends
in the same world: workloads, outcomes, per-pod requests and event
streams (``JobRejected``, ``PodSetUpdateConflict``, ``OnHold`` and the
rest) equal. Beside them, jobs and webhooks held directly against the
JAX package's on the same inputs, the carry of jobs, and the job path's
gates at their JAX defaults. Exact throughout."""

import pytest

import test_admission_checks
import test_integrations_parity
import test_job_webhooks
import test_jobframework
from kueue_tpu.config import features as jfeatures
from kueue_tpu.controllers import integrations as jint
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu.webhooks import jobwebhooks as jwh
from kueue_tpu.webhooks import validators as jval
from kueue_tpu_torch import carry
from kueue_tpu_torch.api.serde import to_jsonable
from kueue_tpu_torch.config import features as pfeatures
from kueue_tpu_torch.controllers import integrations as pint
from kueue_tpu_torch.controllers import jobframework as pjf
from kueue_tpu_torch.webhooks import jobwebhooks as pwh
from kueue_tpu_torch.webhooks import validators as pval
from test_torch_resources import cases_of, run_case

MODULES = {"jobframework": test_jobframework,
           "integrations_parity": test_integrations_parity,
           "job_webhooks": test_job_webhooks,
           "admission_checks": test_admission_checks}
JOB_CHECK_CASES = ["test_provisioning_pod_set_updates_flow_into_started_job",
                   "test_pod_set_update_conflict_fails_start"]
CASES = [(m, c) for m, mod in MODULES.items() if m != "admission_checks"
         for c in cases_of(mod)] + [("admission_checks", c)
                                    for c in JOB_CHECK_CASES]


@pytest.fixture(scope="module")
def jax_runs():
    return {(m, c): run_case(MODULES[m], c, "jax") for m, c in CASES}


def test_every_reference_case_is_held():
    assert [len(cases_of(MODULES[m])) for m in (
        "jobframework", "integrations_parity", "job_webhooks")] == [6, 8, 9]
    assert len(CASES) == 25


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(jax_runs, module, case):
    got = run_case(MODULES[module], case, "port")
    want = jax_runs[module, case]
    assert got == want


@pytest.fixture
def gates():
    yield
    jfeatures.reset()
    pfeatures.reset()


JOB_GATES = ("AdmissionGatedBy", "HierarchicalCohorts",
             "LocalQueueDefaulting", "PartialAdmission",
             "SparkApplicationIntegration",
             "ManagedJobsNamespaceSelectorAlwaysRespected")


def test_job_gates_default_on_in_both_packages():
    for name in JOB_GATES:
        assert jfeatures.enabled(name) and pfeatures.enabled(name), name
        assert jfeatures.all_gates()[name] == pfeatures.all_gates()[name]


def _state(job) -> str:
    """A job's whole state, encoded (the port's codec reads either
    package's dataclasses by field; a PodGroup by its attributes)."""
    job = carry.api_object(job)
    if type(job).__name__ == "PodGroup":
        job = vars(job)
    return repr(to_jsonable(job))


def test_integrations_build_the_same_pod_sets():
    """Every adapter of both packages, built from the same fields, gives
    the same pod sets, finish state and reclaimable pods, and the
    registries name the same kinds."""
    from kueue_tpu.api.types import PodSetTopologyRequest, TopologyMode

    tr = PodSetTopologyRequest(mode=TopologyMode.REQUIRED, level="rack")
    jobs = [
        jjf.BatchJob("b", queue_name="lq", parallelism=4, completions=6,
                     requests={"cpu": 100}, min_parallelism=2,
                     succeeded=3),
        jjf.JobSetJob("js", replicated_jobs=[("d", 1, {"cpu": 1}),
                                             ("w", 3, {"cpu": 2}, tr)]),
        jint.TrainingJob("t", replica_specs={"worker": (3, {"cpu": 5}),
                                             "master": (1, {"cpu": 2})},
                         topology_request=tr),
        jint.RayClusterJob("rc", head_requests={"cpu": 1},
                           worker_groups=[("g", 2, {"cpu": 3})]),
        jint.MPIJob("m", launcher_requests={"cpu": 1}, worker_replicas=4,
                    worker_requests={"cpu": 2}),
        jint.TrainJobV2("tj", num_nodes=2, trainer_requests={"cpu": 4},
                        initializer_requests={"cpu": 1}),
        jint.RayJob("rj", submitter_requests={"cpu": 1},
                    head_requests={"cpu": 2},
                    worker_groups=[("g", 1, {"cpu": 1})]),
        jint.RayServiceJob("rs", head_requests={"cpu": 2}),
        jint.AppWrapperJob("aw", components=[("a", 2, {"cpu": 1})]),
        jint.LeaderWorkerSetJob("lws", replicas=2, size=3,
                                leader_requests={"cpu": 1},
                                worker_requests={"cpu": 2},
                                topology_request=tr),
        jint.PodJob("p", requests={"cpu": 1}, pod_group="g",
                    group_total_count=2),
        jint.StatefulSetJob("ss", replicas=0, requests={"cpu": 1}),
        jint.DeploymentJob("d", replicas=2, requests={"cpu": 1}),
        jint.SparkApplicationJob("sa", driver_requests={"cpu": 1},
                                 executor_instances=3,
                                 executor_requests={"cpu": 2}),
        jint.ServingJob("sv", replicas=2, requests={"cpu": 1}),
    ] + jint.lws_group_jobs(jint.LeaderWorkerSetJob(
        "lg", replicas=2, size=2, leader_requests={"cpu": 1}))
    group = jint.PodGroup("pg", total_count=3)
    for i in range(3):
        group.add_pod(jint.PodJob(f"pg-{i}", requests={"cpu": 1 + i % 2}))
    group.pods[0].done = group.pods[0].success = True
    jobs.append(group)
    for job in jobs:
        port = carry.api_object(job)
        assert carry.api_object(job.pod_sets()) == port.pod_sets(), job.name
        assert port.finished() == job.finished(), job.name
        if hasattr(job, "reclaimable_pods"):
            assert port.reclaimable_pods() == job.reclaimable_pods()
        assert _state(port) == _state(job), job.name
        assert pjf.DEFAULT_INTEGRATIONS.kind_of(port) == \
            jjf.DEFAULT_INTEGRATIONS.kind_of(job), job.name
    assert pjf.DEFAULT_INTEGRATIONS.kinds() == jjf.DEFAULT_INTEGRATIONS.kinds()


def test_webhooks_admit_and_refuse_as_the_jax_package(gates):
    """Each kind's webhook of both packages on jobs that pass and jobs
    that break each rule, with the gates on and off: the same defaulting
    and the same errors, on create and on update."""
    ann = jwh.ADMISSION_GATED_BY_ANNOTATION
    elastic = jwh.ELASTIC_JOB_ANNOTATION
    topo = jwh.TOPOLOGY_ANNOTATIONS
    creates = [
        jjf.BatchJob("ok", queue_name="lq", parallelism=2),
        jjf.BatchJob("bad", queue_name="Bad_Queue"),
        jjf.BatchJob("mp", queue_name="lq", parallelism=2,
                     min_parallelism=2),
        jjf.BatchJob("mc", queue_name="lq", parallelism=3,
                     min_parallelism=1, completions=2),
        jjf.BatchJob("nq", parallelism=1, suspended=False),
        jjf.JobSetJob("js", queue_name="lq"),
        jjf.JobSetJob("jd", queue_name="lq",
                      replicated_jobs=[("a", 1, {}), ("a", 2, {})]),
        jint.RayClusterJob("rc", queue_name="lq",
                           enable_in_tree_autoscaling=True,
                           worker_groups=[("head", 1, {}),
                                          ("g", 1, {}, {topo[0]: "r",
                                                        topo[1]: "r"})]),
        jint.SparkApplicationJob("sa", queue_name="lq",
                                 dynamic_allocation=True,
                                 annotations={elastic: "true"},
                                 driver_annotations={topo[0]: "r",
                                                     topo[2]: "r"}),
        jint.StatefulSetJob("ss", queue_name="lq", replicas=-1),
        jint.DeploymentJob("dp", queue_name="lq",
                           annotations={ann: "acme.io/x,acme.io/x"}),
        jint.MPIJob("mpi", queue_name="lq", worker_replicas=0,
                    slots_per_worker=0, run_launcher_as_worker=True),
        jint.LeaderWorkerSetJob("lws", queue_name="lq", size=0,
                                leader_annotations={topo[0]: "a",
                                                    topo[1]: "b"}),
        jint.TrainingJob("tr", queue_name="lq",
                         annotations={ann: "nodomain, x.io/" + "y" * 70}),
    ]
    updates = [
        (jjf.BatchJob("u", queue_name="lq", suspended=False),
         jjf.BatchJob("u", queue_name="lq2", priority=3)),
        (jint.StatefulSetJob("s", queue_name="lq", ready_replicas=1,
                             suspended=False, requests={"cpu": 1}),
         jint.StatefulSetJob("s", queue_name="", priority=1,
                             requests={"cpu": 2})),
        (jint.DeploymentJob("d", queue_name="lq", suspended=False),
         jint.DeploymentJob("d", queue_name="lq2", requests={"cpu": 1})),
        (jint.TrainingJob("t", annotations={ann: "a.io/x"}),
         jint.TrainingJob("t", annotations={ann: "a.io/x,b.io/y"})),
        (jint.TrainingJob("t2"), jint.TrainingJob(
            "t2", annotations={ann: "a.io/x"})),
    ]

    class _Eng:
        def __init__(self, lqs):
            self.queues = type("Q", (), {"local_queues": lqs})()

    def outcomes():
        for pkg_wh, conv in ((jwh, lambda j: j),
                             (pwh, carry.api_object)):
            reg = pkg_wh.JobWebhookRegistry(_Eng({"default/default": 1}))
            out = []
            for job in creates:
                job = conv(job)
                out.append((reg.admit_create(job), _state(job)))
            for old, new in updates:
                out.append(reg.admit_update(conv(old), conv(new)))
            yield out

    for on in (True, False):
        for name in ("AdmissionGatedBy", "ElasticJobsViaWorkloadSlices",
                     "LocalQueueDefaulting"):
            jfeatures.set_feature(name, on)
            pfeatures.set_feature(name, on)
        jax, port = outcomes()
        assert port == jax
        assert any(errs for errs, _ in jax[:len(creates)])


def test_validators_as_the_jax_package(gates):
    """The standalone validators and the workload defaulting of both
    packages on valid and invalid objects."""
    from kueue_tpu.api import types as t

    cq = t.ClusterQueue(name="Bad!", resource_groups=(t.ResourceGroup(
        ("cpu", "cpu"), (t.FlavorQuotas("f", {"gpu": t.ResourceQuota(
            -1, borrowing_limit=-1, lending_limit=2)}),)),),
        preemption=t.ClusterQueuePreemption(
            borrow_within_cohort=t.BorrowWithinCohort(
                policy=t.BorrowWithinCohortPolicy.LOWER_PRIORITY)))
    cohorts = [t.Cohort("a", parent="b"), t.Cohort("b", parent="a"),
               t.Cohort("c", parent="c")]
    wl = t.Workload(name="w", pod_sets=(
        t.PodSet("", 0, {"cpu": -1}, min_count=3),
        t.PodSet("", 9, {"cpu": 1}, topology_request=t.PodSetTopologyRequest(
            mode=t.TopologyMode.REQUIRED, level="r", slice_size=4))))
    old = t.Workload(name="w", pod_sets=(t.PodSet("main", 1, {"cpu": 1}),))
    old.set_condition(t.WorkloadConditionType.QUOTA_RESERVED, True,
                      reason="QuotaReserved", now=0.0)
    for on in (True, False):
        jfeatures.set_feature("HierarchicalCohorts", on)
        pfeatures.set_feature("HierarchicalCohorts", on)
        jfeatures.set_feature("PartialAdmission", on)
        pfeatures.set_feature("PartialAdmission", on)
        assert pval.validate_cluster_queue(carry.api_object(cq)) == \
            jval.validate_cluster_queue(cq)
        for c in cohorts:
            assert pval.validate_cohort(carry.api_object(c)) == \
                jval.validate_cohort(c)
        assert pval.find_cohort_cycle(carry.api_object(cohorts)) == \
            jval.find_cohort_cycle(cohorts)
        assert pval.validate_resource_flavor(carry.api_object(
            t.ResourceFlavor("f", node_labels={"": "x"}))) == \
            jval.validate_resource_flavor(
                t.ResourceFlavor("f", node_labels={"": "x"}))
        jw, pw = carry.api_object(wl), carry.api_object(wl)
        jval.default_workload(jw)
        pval.default_workload(pw)
        assert carry.api_object(jw) == pw
        assert pval.validate_workload(pw) == jval.validate_workload(jw)
        assert pval.validate_workload_update(carry.api_object(old), pw) \
            == jval.validate_workload_update(old, jw)
        assert pval.validate_workload(pw)


def test_carried_jobs_are_copies():
    """``carry.api_object`` of a job is a new object of the port's
    class, the PodGroup and its pods too (ROADMAP trap (d))."""
    job = jjf.BatchJob("b", requests={"cpu": 1})
    port = carry.api_object(job)
    assert type(port) is pjf.BatchJob and port == carry.api_object(job)
    port.requests["cpu"] = 2
    assert job.requests == {"cpu": 1}
    group = jint.PodGroup("g", total_count=1)
    group.add_pod(jint.PodJob("p", requests={"cpu": 1}))
    pg = carry.api_object(group)
    assert type(pg) is pint.PodGroup and type(pg.pods[0]) is pint.PodJob
    assert pg.pods[0] is not group.pods[0]
    assert pg.pods[0].finalizers == group.pods[0].finalizers
