"""The rest of the port's controllers/ against the JAX package:
WaitForPodsReady (controllers/podsready.py), the CQ/LQ status controller
and retention sweep (status.py), the priority booster (booster.py),
concurrent admission (concurrentadmission.py), the importer
(importer.py), the populator (populator.py) and failure recovery
(failurerecovery.py), with the configuration they read (config/api.py,
config/features.py), the workload ordering of the queues and the cycle,
and the status routes of the serving endpoint.

The reference cases listed in ``CASES`` run twice, as
tests/test_torch_resources.py runs its own: as they are, on the JAX
package, and on the port (``port_globals``, with the names a case imports
inside its body patched on the JAX modules it imports them from), the
uid and workload-name counters started at one value in both. The port
run passes the case's own assertions, and every engine the two runs
build ends in the same world. Beyond them: the one-pass status build
against the JAX controller's per-queue scans (the routes dump the
statuses with ``json.dumps``, so the JSON is compared byte for byte), the
Creation requeuing timestamp, failure recovery on the SMALL
``tas_lifecycle`` world under both actions, the fair-sharing config
switch on ``hier_fair``'s SMALL world, and the status routes served by
both packages' endpoints on one engine state. Exact throughout."""

import importlib
import json
import urllib.request

import pytest

import test_elastic_importer
import test_extended_controllers
import test_feature_gates
import test_lifecycle_features
import test_serving_and_booster
import test_status_retention
import test_torch_resources as tr
from kueue_tpu.api import types as jtypes
from kueue_tpu.config import api as japi
from kueue_tpu.config import features as jfeatures
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu_torch import carry
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.config import api as papi
from kueue_tpu_torch.config import features as pfeatures
from kueue_tpu_torch.controllers import jobframework as pjf
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.bench import engine_worlds as ew

# Names the cases below import inside their bodies, by the JAX module
# they import them from.
IN_BODY = {
    "kueue_tpu.api.types": ("ClusterQueuePreemption", "PreemptionPolicy"),
    "kueue_tpu.config.api": ("WaitForPodsReady", "from_dict"),
    "kueue_tpu.controllers.booster": ("PriorityBooster",
                                      "TimeSharingPolicy"),
    "kueue_tpu.controllers.concurrentadmission": (
        "CONCURRENT_ADMISSION_GATE", "ConcurrentAdmissionPolicy",
        "RETAIN_FIRST_ADMISSION", "TRY_PREFERRED_FLAVORS"),
    "kueue_tpu.controllers.failurerecovery": ("FailureRecoveryController",
                                              "FailureRecoveryPolicy"),
    "kueue_tpu.controllers.importer": (
        "MappingRule", "MappingRules", "PodToImport", "import_workloads",
        "pods_to_workloads"),
    "kueue_tpu.controllers.podsready": ("PodsReadyManager",),
    "kueue_tpu.controllers.populator": ("NAME_MODE_AS_CLUSTER_QUEUE",
                                        "PopulatorController"),
}

MODULES = {"lifecycle_features": test_lifecycle_features,
           "status_retention": test_status_retention,
           "elastic_importer": test_elastic_importer,
           "extended_controllers": test_extended_controllers,
           "serving_and_booster": test_serving_and_booster,
           "feature_gates": test_feature_gates}
CASES = [
    ("lifecycle_features", "test_block_admission_until_pods_ready"),
    ("lifecycle_features", "test_pods_ready_timeout_evicts_with_backoff"),
    ("lifecycle_features", "test_pods_ready_deactivation_after_limit"),
] + [("status_retention", c) for c in tr.cases_of(test_status_retention)] + [
    ("elastic_importer", "test_importer_check_and_import"),
    ("elastic_importer", "test_importer_rejects_unmapped_queue"),
    ("elastic_importer", "test_importer_mapping_rules_and_pod_import"),
    ("extended_controllers",
     "test_failure_recovery_evicts_workloads_on_failed_node"),
    ("extended_controllers", "test_concurrent_admission_variants_per_flavor"),
    ("extended_controllers",
     "test_concurrent_admission_retain_first_admission"),
    ("extended_controllers",
     "test_concurrent_admission_migrates_to_preferred_flavor"),
    ("extended_controllers", "test_concurrent_admission_gated_variants_rotate"),
    ("extended_controllers", "test_populator_creates_local_queues"),
    ("extended_controllers", "test_booster_time_sharing_negative_boost"),
    ("extended_controllers",
     "test_failure_recovery_replace_action_and_fail_fast"),
    ("serving_and_booster", "test_priority_booster_unstarves"),
    ("feature_gates", "test_disable_wait_for_pods_ready_gate"),
    ("feature_gates", "test_failure_recovery_policy_gate"),
]


def run_case(module, case: str, pkg: str) -> list:
    """tr.run_case, with this file's in-body names patched too, and the
    feature gates of both packages reset after."""
    built: list = []
    try:
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "port":
                tr.port_globals(mp, module, built)
                for jname, names in IN_BODY.items():
                    jmod = importlib.import_module(jname)
                    pmod = importlib.import_module(tr.port_name(jname))
                    for name in names:
                        mp.setattr(jmod, name, getattr(pmod, name))
                counters = tr.aligned_counters(ptypes, pjf)
            else:
                mp.setattr(module, "Engine", tr._jax_engine(built))
                counters = tr.aligned_counters(jtypes, jjf)
            with counters:
                tr.call(module, case)
    finally:
        jfeatures.reset()
        pfeatures.reset()
    return [tr.world(e) for e in built]


@pytest.fixture(scope="module")
def jax_runs():
    return {(m, c): run_case(MODULES[m], c, "jax") for m, c in CASES}


def test_every_reference_case_is_held():
    assert len(CASES) == 23
    assert len(tr.cases_of(test_status_retention)) == 6


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(jax_runs, module, case):
    got = run_case(MODULES[module], case, "port")
    want = jax_runs[module, case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def _status_world(pkg: str):
    """An engine of ``pkg`` ("jax" or "port") with two resources over
    three flavors (one missing, so its ClusterQueue is inactive),
    fair-sharing ClusterQueues in two cohorts, a stopped LocalQueue, one
    naming a missing ClusterQueue, LocalQueues in two namespaces, and
    workloads admitted, pending and parked over them."""
    t = jtypes if pkg == "jax" else ptypes
    eng = (JEngine(enable_fair_sharing=True) if pkg == "jax"
           else PEngine(enable_fair_sharing=True, device="cpu"))
    for rf in ("on-demand", "spot"):
        eng.create_resource_flavor(t.ResourceFlavor(rf))
    for co in ("a", "b"):
        eng.create_cohort(t.Cohort(co))

    def quotas(flavor, cpu, mem):
        return t.FlavorQuotas(flavor, {"cpu": t.ResourceQuota(cpu),
                                       "memory": t.ResourceQuota(mem)})

    for i in range(6):
        flavors = (quotas("on-demand", 4000 + 1000 * i, 8000),
                   quotas("spot", 2000, 4000 + 500 * i))
        if i == 5:
            flavors = (quotas("ghost", 3000, 3000),)
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort="ab"[i % 2],
            fair_sharing=t.FairSharing(weight=1.0 + i % 3)
            if i % 3 else None,
            resource_groups=(t.ResourceGroup(("cpu", "memory"), flavors),)))
        for ns in ("default", "team"):
            eng.create_local_queue(t.LocalQueue(f"lq-{i}", ns, f"cq-{i}"))
    eng.create_local_queue(t.LocalQueue("orphan", "default", "cq-none"))
    eng.queues.local_queues["team/lq-2"].stop_policy = t.StopPolicy.HOLD
    for k in range(90):
        eng.clock += 0.5
        eng.submit(t.Workload(
            name=f"w-{k}", namespace="default" if k % 3 else "team",
            queue_name=f"lq-{k % 6}", priority=k % 4,
            pod_sets=(t.PodSet("main", 1 + k % 3, {
                "cpu": 500 + 250 * (k % 5), "memory": 700 + 300 * (k % 7)}),)))
        if k % 10 == 9:
            eng.schedule_once()
    for _ in range(4):
        eng.schedule_once()
    return eng


def test_one_pass_status_equals_per_queue_scans():
    """The port's one-pass ``reconcile_all`` (trap (cj)) gives the JAX
    controller's statuses, gauges and JSON (dict insertion orders
    included) byte for byte, as do ``cq_status`` and ``lq_status`` one
    queue at a time."""
    from kueue_tpu.controllers import status as jstatus
    from kueue_tpu_torch.controllers import status as pstatus

    with tr.aligned_counters(jtypes, jjf):
        jeng = _status_world("jax")
    with tr.aligned_counters(ptypes, pjf):
        peng = _status_world("port")
    assert tr.world(peng) == tr.world(jeng)
    jsc = jstatus.StatusController(jeng)
    psc = pstatus.StatusController(peng)
    jsc.reconcile_all()
    psc.reconcile_all()

    def dumped(statuses):
        return json.dumps({k: vars(v) for k, v in statuses.items()})

    assert dumped(psc.cq_statuses) == dumped(jsc.cq_statuses)
    assert dumped(psc.lq_statuses) == dumped(jsc.lq_statuses)
    for fam in ("cluster_queue_status", "local_queue_status"):
        assert peng.registry.gauge(fam).values == \
            jeng.registry.gauge(fam).values
    st = psc.cq_statuses
    assert not st["cq-5"].active and st["cq-5"].active_reason == \
        "FlavorNotFound"
    assert any(s.weighted_share is not None for s in st.values())
    assert any(len(s.flavors_usage) == 2 for s in st.values())
    lq = psc.lq_statuses
    assert lq["team/lq-2"].active_reason == "Stopped"
    assert lq["default/orphan"].active_reason == "ClusterQueueDoesNotExist"
    assert lq["team/lq-5"].active_reason == "ClusterQueueIsInactive"
    for name in list(jeng.cache.cluster_queues) + ["cq-none"]:
        assert json.dumps(vars(psc.cq_status(name)) if name != "cq-none"
                          else psc.cq_status(name)) == \
            json.dumps(vars(jsc.cq_status(name)) if name != "cq-none"
                       else jsc.cq_status(name))
    for key in list(jeng.queues.local_queues) + ["default/none"]:
        got, want = psc.lq_status(key), jsc.lq_status(key)
        assert json.dumps(got and vars(got)) == json.dumps(want and vars(want))


def _ordering_run(pkg: str, timestamp: str, oracle: bool) -> tuple:
    """Two ClusterQueues in a cohort, each with room for two workloads;
    workloads that never become ready, evicted by the pods-ready timeout
    and requeued under ``timestamp``, while later ones wait. Returns the
    decision stream of every cycle and the final world."""
    from kueue_tpu.controllers import podsready as jpr
    from kueue_tpu_torch.controllers import podsready as ppr

    t, api, pr_mod = ((jtypes, japi, jpr) if pkg == "jax"
                      else (ptypes, papi, ppr))
    cfg = api.from_dict({"waitForPodsReady": {
        "enable": True, "timeout": 30,
        "requeuingStrategy": {"backoffBaseSeconds": 1}}})
    assert cfg.wait_for_pods_ready.requeuing_timestamp == "Eviction"
    cfg.wait_for_pods_ready.requeuing_timestamp = timestamp
    eng = (JEngine(config=cfg) if pkg == "jax"
           else PEngine(config=cfg, device="cpu"))
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    for i in range(2):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort="co", resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas("default", {
                    "cpu": t.ResourceQuota(2000)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq-{i}", "default",
                                            f"cq-{i}"))
    if oracle:
        if pkg == "jax":
            eng.attach_oracle()
        else:
            eng.attach_oracle(device="cpu")
    pr = pr_mod.PodsReadyManager(eng, cfg.wait_for_pods_ready)
    for k in range(12):
        eng.clock += 1.0
        eng.submit(t.Workload(name=f"w-{k}", queue_name=f"lq-{k % 2}",
                              priority=k % 3 // 2,
                              pod_sets=(t.PodSet("main", 1,
                                                 {"cpu": 1000}),)))
    stream = []
    for c in range(14):
        r = eng.schedule_once()
        stream.append(ew.decision_stream(r))
        for e in (r.entries if r is not None else ()):
            if e.status.value == "assumed" and int(e.obj.name[2:]) % 4:
                pr.mark_pods_ready(e.obj.key)
        eng.tick(11.0)
        pr.reconcile()
    return stream, tr.world(eng)


@pytest.mark.parametrize("oracle", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("timestamp", ["Creation", "Eviction"])
def test_requeuing_timestamp_orders_both_engines_alike(timestamp, oracle):
    """waitForPodsReady.requeuingTimestamp orders the pending heaps and
    the cycle of both engines alike, on the host path and through the
    oracle, where both packages' row caches keep the default ordering
    (trap (ck)); the two timestamps give different runs."""
    with tr.aligned_counters(jtypes, jjf):
        want = _ordering_run("jax", timestamp, oracle)
    with tr.aligned_counters(ptypes, pjf):
        got = _ordering_run("port", timestamp, oracle)
    assert got == want
    other = "Eviction" if timestamp == "Creation" else "Creation"
    with tr.aligned_counters(ptypes, pjf):
        assert _ordering_run("port", other, oracle)[0] != got[0]
    assert any(e[1] == "Evicted" and e[4] == "PodsReadyTimeout"
               for e in got[1][3])


def _routes(endpoint_cls, eng, paths) -> dict:
    srv = endpoint_cls(eng)
    srv.start()
    try:
        out = {}
        for path in paths:
            url = f"http://127.0.0.1:{srv.port}{path}"
            with urllib.request.urlopen(url, timeout=10) as r:
                out[path] = (r.status, r.read())
        return out
    finally:
        srv.stop()


def test_status_routes_answer_as_the_jax_endpoint():
    """GET /clusterqueues/<cq>/status and /localqueues/<ns>/<lq>/status
    from the port's endpoint and the JAX package's ServingEndpoint on one
    engine state: the same codes and bodies byte for byte (``null`` for
    a queue that does not exist), and an inactive ClusterQueue reads
    inactive, as the dashboard shows it."""
    from kueue_tpu.visibility.http_server import ServingEndpoint as JSE
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint as PSE

    with tr.aligned_counters(jtypes, jjf):
        jeng = _status_world("jax")
    with tr.aligned_counters(ptypes, pjf):
        peng = _status_world("port")
    paths = [f"/clusterqueues/cq-{i}/status" for i in range(6)] + [
        "/clusterqueues/cq-none/status", "/localqueues/default/orphan/status",
        "/localqueues/team/lq-2/status", "/localqueues/team/nope/status"] + [
        f"/localqueues/default/lq-{i}/status" for i in range(6)]
    want = _routes(JSE, jeng, paths)
    got = _routes(PSE, peng, paths)
    assert got == want
    assert got["/clusterqueues/cq-none/status"] == (200, b"null")
    cq5 = json.loads(got["/clusterqueues/cq-5/status"][1])
    assert cq5["active"] is False and cq5["active_reason"] == \
        "FlavorNotFound"
    assert json.loads(got["/clusterqueues/cq-0/status"][1])["active"]


def _fair_run(pkg: str, raw: dict) -> tuple:
    from kueue_tpu.bench.scenario import hierarchical_fair as jhier
    from kueue_tpu_torch.bench.scenario import hierarchical_fair as phier

    scen = (jhier if pkg == "jax" else phier)(n_roots=4, n_workloads=500)
    if pkg == "jax":
        eng = JEngine(config=japi.from_dict(raw))
    else:
        eng = PEngine(config=papi.from_dict(raw), device="cpu")
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts:
        eng.create_cohort(co)
    for cq in scen.cluster_queues:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues:
        eng.create_local_queue(lq)
    for wl in scen.workloads:
        eng.clock += 0.001
        eng.submit(wl)
    if pkg == "jax":
        eng.attach_oracle()
    else:
        eng.attach_oracle(device="cpu")
    stream = []
    for _ in range(40):
        r = eng.schedule_once()
        if r is None:
            break
        stream.append(ew.decision_stream(r))
    return eng.cycle.enable_fair_sharing, stream, tr.world(eng)


def test_fair_sharing_config_gives_a_fair_engine_in_both_packages():
    """``from_dict({"fairSharing": {"enable": True}})`` turns fair
    sharing on in both engines (the config gap this slice repairs), and
    on hier_fair's small world they decide alike; without it both run
    the classical cycle, which decides otherwise."""
    raw = {"fairSharing": {"enable": True}, "namespace": "kueue-system"}
    with tr.aligned_counters(jtypes, jjf):
        want = _fair_run("jax", raw)
    with tr.aligned_counters(ptypes, pjf):
        got = _fair_run("port", raw)
    assert want[0] is True and got[0] is True
    assert got == want
    with tr.aligned_counters(ptypes, pjf):
        classical = _fair_run("port", {})
    assert classical[0] is False and classical[1] != got[1]
    assert carry.configuration(japi.from_dict(raw)) == papi.from_dict(raw)


def _recovery_run(pkg: str, action: str) -> tuple:
    """QUARTER tas_lifecycle on the host TAS path and the default loop:
    its fill cycles, then six failures, each of the first hostname of
    the admitted workload with the smallest key, each followed by a
    cycle, under ``action`` with ``max_failures=1``."""
    from kueue_tpu.controllers import failurerecovery as jfr
    from kueue_tpu.tas import non_tas_usage as jnon
    from kueue_tpu.tas import snapshot as jsnapshot
    from kueue_tpu_torch.bench import tas_engine_worlds as tw
    from kueue_tpu_torch.bench import tas_world
    from kueue_tpu_torch.controllers import failurerecovery as pfr

    if pkg == "jax":
        kit = ew.Kit(jtypes, None, lambda fair=False: JEngine(),
                     lambda eng: eng.attach_oracle(), jsnapshot,
                     non_tas_usage=jnon)
        fr = jfr
    else:
        kit, fr = ew.port_kit("cpu"), pfr
    config = tw.QUARTER["tas_lifecycle"]
    trace = []
    with tas_world.pinned("host", "1"), ew.loop_arm("full"):
        eng = tw.build(config, kit)
        for _ in range(config["fill_cycles"]):
            eng.schedule_once()
        frc = fr.FailureRecoveryController(eng, fr.FailureRecoveryPolicy(
            action=action, max_failures=1))
        for _ in range(6):
            key = min(k for k in eng.cache.workloads
                      if eng.workloads[k].is_admitted)
            ta = eng.workloads[key].status.admission.pod_set_assignments[
                0].topology_assignment
            node = sorted(d.values[-1] for d in ta.domains)[0]
            trace.append((key, node, frc.node_failed(node)))
            eng.clock += 1.0
            r = eng.schedule_once()
            trace.append(ew.decision_stream(r))
    return (trace, dict(frc.failure_counts), sorted(frc.unhealthy_nodes),
            tr.world(eng))


@pytest.mark.parametrize("action", ["Replace", "Requeue"])
def test_failure_recovery_on_the_tas_lifecycle_world(monkeypatch, tmp_path,
                                                     action):
    """Failure recovery on the small tas_lifecycle world (a 5,120-node
    forest) under both actions with ``max_failures=1``: the same
    affected workloads, cycles, failure counts and final world in both
    packages, and a workload failed twice is deactivated
    (NodeFailureLimitExceeded)."""
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION", str(tmp_path / "j"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION", str(tmp_path / "p"))
    with tr.aligned_counters(jtypes, jjf):
        want = _recovery_run("jax", action)
    with tr.aligned_counters(ptypes, pjf):
        got = _recovery_run("port", action)
    assert got == want
    events = got[3][3]
    assert any(e[1] == "Evicted" and e[4] == "NodeFailureLimitExceeded"
               for e in events)
    if action == "Requeue":
        assert any(e[1] == "Evicted" and e[4] == "NodeFailure"
                   for e in events)
    else:
        assert any(e[1] == "NodeReplaced" for e in events)


def _queues_state(eng) -> dict:
    q = eng.queues
    return {name: (sorted(p.items), sorted(p.inadmissible), p.in_flight,
                   sorted(p._id_of))
            for name, p in q.cluster_queues.items()} | {
        "rows": sorted(q.rows._row_of)}


def _retarget_run(pkg: str) -> tuple:
    """Workloads pending, parked and admitted on one ClusterQueue; the
    LocalQueue retargeted to another, so their mapping is stale; then
    each deleted, finished ones by the retention sweep."""
    from kueue_tpu.controllers import status as jstatus
    from kueue_tpu_torch.controllers import status as pstatus

    t, st = (jtypes, jstatus) if pkg == "jax" else (ptypes, pstatus)
    eng = JEngine() if pkg == "jax" else PEngine(device="cpu")
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    for i in range(3):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", resource_groups=(t.ResourceGroup(("cpu",), (
                t.FlavorQuotas("default", {"cpu": t.ResourceQuota(3000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq-0"))
    if pkg == "jax":
        eng.attach_oracle()
    else:
        eng.attach_oracle(device="cpu")
    st.StatusController(eng, retention=st.WorkloadRetentionPolicy(
        after_finished=1.0))
    wls = []
    for k in range(6):
        eng.clock += 0.5
        wl = t.Workload(name=f"w-{k}", queue_name="lq", pod_sets=(
            t.PodSet("main", 1, {"cpu": 1000 if k < 4 else 5000}),))
        eng.submit(wl)
        wls.append(wl)
    eng.schedule_once()
    eng.schedule_once()
    states = [_queues_state(eng)]
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq-1"))
    for wl in wls[:2]:
        eng.finish(wl.key)
    eng.queues.delete_workload(wls[5])
    eng.queues.delete_workload(wls[3])
    states.append(_queues_state(eng))
    eng.tick(2.0)
    states.append(_queues_state(eng))
    return states, tr.world(eng)


def test_stale_mapping_delete_as_the_jax_package():
    """A delete whose LocalQueue mapping is stale finds the key on every
    ClusterQueue's queue that holds it (items, parked, the heap's lazily
    left ids), as the JAX package's sweep over all of them does (trap
    (cl)); the retention sweep's deletes of finished workloads too."""
    with tr.aligned_counters(jtypes, jjf):
        want = _retarget_run("jax")
    with tr.aligned_counters(ptypes, pjf):
        got = _retarget_run("port")
    assert got == want
    assert any(e[1] == "Deleted" for e in got[1][3])


@pytest.mark.parametrize("gate", ["DisableWaitForPodsReady",
                                  "FailureRecoveryPolicy"])
def test_controller_gates_default_as_the_jax_package(gate):
    """The two gates these controllers read, at the JAX defaults (trap
    (ch): a gate the port does not list reads as off)."""
    assert gate in pfeatures.all_gates()
    assert pfeatures.enabled(gate) == jfeatures.enabled(gate)


def test_config_reads_the_jax_keys_and_no_more():
    """``from_dict``, ``validate``, ``load`` and ``_duration_seconds`` as
    the JAX package's: the same Configuration from one mapping (the
    sections this slice adds, and ``requeuingTimestamp`` left unread),
    the same validation errors and durations."""
    raw = {"namespace": "ns", "manageJobsWithoutQueueName": True,
           "waitForPodsReady": {"enable": True, "timeout": 0,
                                "blockAdmission": True,
                                "requeuingStrategy": {
                                    "timestamp": "Creation",
                                    "backoffBaseSeconds": 0,
                                    "backoffLimitCount": 3,
                                    "backoffMaxSeconds": 90}},
           "fairSharing": {"enable": True,
                           "preemptionStrategies": ["Nope"]},
           "objectRetentionPolicies": {"workloads": {
               "afterFinished": "1h30m", "afterDeactivatedByKueue": "5x"}},
           "featureGates": {"PriorityBoost": True}}
    j, p = japi.from_dict(raw), papi.from_dict(raw)
    assert carry.configuration(j) == p
    assert p.wait_for_pods_ready.requeuing_timestamp == "Eviction"
    assert p.retention_after_finished_seconds == 5400.0
    assert p.retention_after_deactivated_seconds is None
    assert p.validate() == j.validate() and len(p.validate()) == 3
    for v in (None, 3, 2.5, "300s", "5m", "1h30m", "250ms", "1d", ""):
        assert papi._duration_seconds(v) == japi._duration_seconds(v), v


def test_config_load_as_the_jax_package(tmp_path):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"fairSharing": {"enable": True},
                                "waitForPodsReady": {"enable": True}}))
    assert carry.configuration(japi.load(str(good))) == \
        papi.load(str(good))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"waitForPodsReady": {"timeout": -1}}))
    for api in (japi, papi):
        with pytest.raises(ValueError, match="timeout must be > 0"):
            api.load(str(bad))
