"""TAS through node failures and foreign pods in the port
(kueue_tpu_torch/tas/non_tas_usage.py, tas/ungater.py, tas/balanced.py,
controllers/tas_nodes.py, the replacement and elastic paths of
tas/snapshot.py, the second-pass queue and the engine's node lifecycle)
against the JAX package, on the CPU.

The reference's own tests run mirrored: tests/test_non_tas_usage.py
(its cache and filter through ``MirroredUsageCache`` and
``mirrored_belongs``, its engine worlds through the mirrored engines of
tests/test_torch_engine.py and tests/test_torch_pipeline.py), the
node-replacement, node-health, ungater, elastic and balanced tests of
tests/test_tas_extended.py and the TAS gate tests of
tests/test_feature_gates.py, with every gate a test sets set in both
packages (``MirroredFeatures``). Engine worlds run under both TAS path
pins, on the sequential host cycle and on the bridge's default loop
(``pipeline_stats`` compared every cycle); snapshot worlds compare every
placement call (``MirroredSnapshot``, tests/test_torch_tas_host.py).
Then the speculation probe (a speculation encoded before a pod or node
event is used after it in both packages alike, and the TAS commit
re-check decides), and a journal written across a node failure, rebuilt
by each package with the second pass re-armed. Exact throughout."""

import itertools
import shutil
import sys
import types

import pytest

import test_feature_gates as tfg
import test_non_tas_usage as tnu
import test_tas_extended as tte
import test_torch_engine as te
from kueue_tpu.api import types as jtypes
from kueue_tpu.config import features as jfeatures
from kueue_tpu.controllers import engine as jengine
from kueue_tpu.controllers import tas_nodes as jtas_nodes
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.store import journal as jjournal
from kueue_tpu.tas import non_tas_usage as jnon
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu.tas import ungater as jungater
from kueue_tpu_torch import carry
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.config import features as pfeatures
from kueue_tpu_torch.controllers import tas_nodes as ptas_nodes
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.store import journal as pjournal
from kueue_tpu_torch.tas import non_tas_usage as pnon
from kueue_tpu_torch.tas import snapshot as psnapshot
from kueue_tpu_torch.tas import ungater as pungater
from test_torch_pipeline import PipelineMirroredEngine
from test_torch_tas_device import plain
from test_torch_tas_host import MirroredSnapshot

JSnapshot = jsnapshot.TASFlavorSnapshot
PATHS = {"host": "1000000", "device": "0"}

MirroredFeatures = types.SimpleNamespace(
    enabled=jfeatures.enabled,
    set_feature=lambda name, value: (jfeatures.set_feature(name, value),
                                     pfeatures.set_feature(name, value)),
    apply=lambda gates: (jfeatures.apply(gates), pfeatures.apply(gates)),
    reset=lambda: (jfeatures.reset(), pfeatures.reset()))


@pytest.fixture(autouse=True)
def gates_and_records(monkeypatch, tmp_path):
    """Both packages' gates at their defaults after each test; both
    crossover records pointed at an empty directory; the reference test
    modules set gates through ``MirroredFeatures``."""
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    for mod in (tte, tfg):
        monkeypatch.setattr(mod, "features", MirroredFeatures)
    MirroredFeatures.reset()
    yield
    MirroredFeatures.reset()


def test_gates_match_the_jax_defaults():
    """Every gate the port reads has the JAX package's default, and an
    override set through both packages reads alike."""
    for name, value in pfeatures.all_gates().items():
        assert jfeatures.enabled(name) == value, name
    for name in ("TASFailedNodeReplacement", "ElasticJobsViaWorkloadSlices",
                 "TASReplaceNodeOnNodeTaints"):
        MirroredFeatures.set_feature(name, not jfeatures.enabled(name))
        assert pfeatures.enabled(name) == jfeatures.enabled(name)
    assert pfeatures.all_gates() == {
        k: v for k, v in jfeatures.all_gates().items()
        if k in pfeatures.all_gates()}
    assert pungater.TOPOLOGY_GATE == jungater.TOPOLOGY_GATE


# -- tests/test_non_tas_usage.py: the cache and the filter --

class MirroredUsageCache(jnon.NonTASUsageCache):
    """The JAX package's NonTASUsageCache with the port's beside it:
    every update and delete a test makes is made on both, and the node
    totals, entry counts and versions must agree after each."""

    def __init__(self):
        super().__init__()
        self.port = pnon.NonTASUsageCache()
        self._inside = False

    def _check(self):
        assert self.port.nodes() == self.nodes()
        assert len(self.port) == len(self)
        assert self.port.version == self.version

    def update(self, pod):
        self._inside = True
        try:
            super().update(pod)
        finally:
            self._inside = False
        self.port.update(carry.api_object(pod))
        self._check()

    def delete(self, key):
        super().delete(key)
        if not self._inside:
            self.port.delete(key)
            self._check()

    def node_usage(self, node):
        want = super().node_usage(node)
        assert self.port.node_usage(node) == want
        return want


def mirrored_belongs(pod):
    want = jnon.belongs_to_cache(pod)
    assert pnon.belongs_to_cache(carry.api_object(pod)) == want
    return want


@pytest.mark.parametrize("cls,name", [
    (cls, name) for cls in ("TestCache", "TestFiltering")
    for name in dir(getattr(tnu, cls)) if name.startswith("test_")]
    + [("TestIdempotentResync", "test_unchanged_pod_resync_keeps_version")])
def test_non_tas_cache_cases_match(monkeypatch, cls, name):
    monkeypatch.setattr(tnu, "NonTASUsageCache", MirroredUsageCache)
    monkeypatch.setattr(tnu, "belongs_to_cache", mirrored_belongs)
    getattr(getattr(tnu, cls)(), name)()


# -- the engine worlds, on the host cycle and on the default loop --

class OraclePipelineEngine(PipelineMirroredEngine):
    """A PipelineMirroredEngine with the oracle attached from the start
    (the reference tests build sequential engines)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.attach_oracle()


LOOPS = {"host-cycle": te.MirroredEngine, "default-loop": OraclePipelineEngine}


@pytest.fixture(params=[(path, loop) for path in PATHS for loop in LOOPS],
                ids=lambda p: "-".join(p))
def mirrored(request, monkeypatch):
    """A mirrored engine class patched in as the reference modules'
    ``Engine`` (and the JAX package's, for tests that import it inside
    their body), both packages pinned to one TAS path and on the default
    loop; every mirrored world held to the JAX engine's at the end."""
    path, loop = request.param
    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    monkeypatch.delenv("KUEUE_TPU_COLUMNAR", raising=False)
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", PATHS[path])
    for mod in (tnu, tte, tfg, jengine):
        monkeypatch.setattr(mod, "Engine", LOOPS[loop])
    te._ENGINES.clear()
    yield request.param
    assert te._ENGINES, "no mirrored engine was built"
    for eng in te._ENGINES:
        eng.assert_same_world()
    te._ENGINES.clear()


class MirroredNodeHealthController(jtas_nodes.NodeHealthController):
    """The JAX package's node-health controller with its port twin on the
    port engine: each call a test makes runs both (the failures each
    reports go to its own engine)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.port = ptas_nodes.NodeHealthController(engine.port)

    def node_ready(self, name):
        super().node_ready(name)
        self.port.node_ready(name)

    def node_not_ready(self, name, now):
        super().node_not_ready(name, now)
        self.port.node_not_ready(name, now)

    def node_tainted(self, name):
        super().node_tainted(name)
        self.port.node_tainted(name)

    def node_deleted(self, name):
        super().node_deleted(name)
        self.port.node_deleted(name)

    def pod_terminated(self, node_name):
        super().pod_terminated(node_name)
        self.port.pod_terminated(node_name)

    def tick(self, now):
        super().tick(now)
        self.port.tick(now)


@pytest.mark.parametrize("case", [
    "tnu.TestEndToEnd.test_non_tas_pod_shrinks_placement_capacity",
    "tnu.TestEndToEnd.test_pod_deletion_frees_capacity",
    "tnu.TestEndToEnd.test_tas_pod_does_not_double_count",
    "tnu.TestIdempotentResync.test_resync_does_not_invalidate_prototypes",
    "tte.test_node_replacement_keeps_healthy_domains",
    "tte.test_two_node_failures_replaced_together",
    "tte.test_node_replacement_fail_fast_evicts",
    "tte.test_node_health_controller_not_ready_window",
    "tte.test_elastic_slice_through_scheduler_keeps_placement",
    "tfg.test_tas_failed_node_replacement_parent_gate"])
def test_engine_cases_match(mirrored, monkeypatch, case):
    monkeypatch.setattr(tte, "NodeHealthController",
                        MirroredNodeHealthController)
    mod, *path = case.split(".")
    obj = globals()[mod]
    for part in path:
        obj = getattr(obj, part)
        if isinstance(obj, type):
            obj = obj()
    obj()
    if case.startswith("tfg."):
        # Replacement off: the node stays, not ready, in both engines.
        eng = te._ENGINES[-1]
        assert not eng.port.cache.nodes["n1"].ready
        assert not eng.cache.nodes["n1"].ready


def test_replacement_reaches_the_device_program(monkeypatch):
    """Under the device pin the second pass's replacement of a REQUIRED
    rack gang goes to the device program with the rack as its required
    replacement domain (the leaf mask of tas/device.try_find) in the
    port, with the JAX engine's result."""
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "0")
    monkeypatch.setattr(tte, "Engine", te.MirroredEngine)
    calls = []
    find = psnapshot.TASFlavorSnapshot.find_topology_assignments

    def spy(self, *a, **kw):
        before = self.device_placements
        out = find(self, *a, **kw)
        calls.append((kw.get("required_replacement_domain"),
                      self.device_placements - before))
        return out

    monkeypatch.setattr(psnapshot.TASFlavorSnapshot,
                        "find_topology_assignments", spy)
    te._ENGINES.clear()
    eng = tte.make_engine()
    t = jtypes
    for h in (2, 3):
        name = f"b0-r0-h{h}"
        eng.create_node(jsnapshot.Node(name, labels={
            "pool": "tas", "block": "b0", "rack": "b0r0",
            jsnapshot.HOSTNAME_LABEL: name},
            capacity={"cpu": 4000, "pods": 100}))
    # Nine pods fit only the four-host rack, with room to re-place the
    # pods of any one of its hosts in the other three.
    w = t.Workload(name="gang", queue_name="lq", pod_sets=(t.PodSet(
        "main", 9, {"cpu": 1000}, topology_request=t.PodSetTopologyRequest(
            mode=t.TopologyMode.REQUIRED, level="rack")),))
    eng.submit(w)
    eng.schedule_once()
    failed = min(tte.admitted_nodes(w))
    eng.mark_node_unhealthy(failed, reason="NodeDeleted")
    eng.schedule_once()
    assert w.status.unhealthy_nodes == () and w.is_admitted
    assert failed not in tte.admitted_nodes(w)
    eng.assert_same_world()
    assert [c for c in calls if c[0]] == [(("b0", "b0r0"), 1)]
    te._ENGINES.clear()


# -- tests/test_tas_extended.py and tests/test_feature_gates.py:
# snapshot worlds --

class HostMirroredSnapshot(MirroredSnapshot):
    """A MirroredSnapshot that also compares the host descent when a
    test calls it directly."""

    def find_topology_assignments_host(self, workers, leader=None,
                                       simulate_empty=False,
                                       assumed_usage=None,
                                       required_replacement_domain=()):
        want = super().find_topology_assignments_host(
            workers, leader, simulate_empty, assumed_usage,
            required_replacement_domain)
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if not caller.startswith("kueue_tpu."):
            got = self.port.find_topology_assignments_host(
                carry.api_object(workers), carry.api_object(leader),
                simulate_empty, assumed_usage, required_replacement_domain)
            assert plain(got) == plain(want)
            MirroredSnapshot.calls += 1
        return want


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", [
    "tte.test_balanced_placement_spreads_evenly",
    "tte.test_balanced_placement_falls_back_when_impossible",
    "tte.test_elastic_scale_up_keeps_previous_pods_fixed",
    "tte.test_elastic_scale_down_truncates",
    "tte.test_elastic_stale_previous_falls_back_to_fresh_placement",
    "tfg.test_elastic_tas_sub_gate_and_multilayer_gate",
    "tfg.test_elastic_tas_sub_gate"])
def test_snapshot_cases_match(monkeypatch, path, case):
    """Each placement call of the case runs in both packages; the port's
    elastic handler runs exactly when the JAX package's does."""
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", PATHS[path])
    monkeypatch.setattr(tte, "TASFlavorSnapshot", HostMirroredSnapshot)
    monkeypatch.setattr(jsnapshot, "TASFlavorSnapshot", HostMirroredSnapshot)
    handled = {"jax": 0, "port": 0}
    for pkg, cls in (("jax", JSnapshot),
                     ("port", psnapshot.TASFlavorSnapshot)):
        orig = cls._handle_elastic_workload

        def counted(self, *a, _orig=orig, _pkg=pkg, **kw):
            handled[_pkg] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "_handle_elastic_workload", counted)
    MirroredSnapshot.calls = 0
    mod, name = case.split(".")
    getattr(globals()[mod], name)()
    assert MirroredSnapshot.calls > 0
    assert handled["port"] == handled["jax"]


def test_replacement_assignment_matches(monkeypatch):
    """find_replacement_assignment directly on both packages' snapshots
    of one forest, the lost node removed: the same re-placed pods inside
    the same required rack, on both paths."""
    def replace_in(mod, t, **kw):
        snap = mod.TASFlavorSnapshot(
            tte.TOPOLOGY if mod is jsnapshot
            else carry.api_object(tte.TOPOLOGY), **kw)
        for b in range(2):
            for r in range(2):
                for h in range(3):
                    name = f"b{b}-r{r}-h{h}"
                    snap.add_node(mod.Node(
                        name, labels={"block": f"b{b}", "rack": f"b{b}{r}",
                                      mod.HOSTNAME_LABEL: name},
                        capacity={"cpu": 4000, "pods": 100}))
        lost = ("b0", "b00", "b0-r0-h0")
        snap.remove_node(mod.Node(lost[-1], labels=dict(zip(
            ("block", "rack", mod.HOSTNAME_LABEL), lost))))
        existing = mod.TopologyAssignment(tuple(snap.level_keys), (
            mod.TopologyDomainAssignment(lost, 4),
            mod.TopologyDomainAssignment(("b0", "b00", "b0-r0-h1"), 2)))
        ps = t.PodSet("main", 6, {"cpu": 1000},
                      topology_request=t.PodSetTopologyRequest(
                          mode=t.TopologyMode.REQUIRED, level="rack"))
        new, repl, reason = snap.find_replacement_assignment(
            mod.TASPodSetRequest(ps, {"cpu": 1000}, 6), existing,
            (lost[-1],), {})
        return plain(({"new": new, "replacement": repl}, reason))

    for path in PATHS.values():
        monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", path)
        want = replace_in(jsnapshot, jtypes)
        assert replace_in(psnapshot, ptypes, device="cpu") == want
        assert want[1] == ""
        assert {v[1] for v, _ in want[0]["replacement"][1]} == {"b00"}


# -- tests/test_tas_extended.py: the ungater --

def mirrored_assign(assignment, pods, pod_index_label=None, offset=0):
    want = jungater.assign_pods_to_domains(assignment, pods,
                                           pod_index_label, offset)
    ppods = [pungater.PodStub(p.name, dict(p.labels), p.gated,
                              p.domain_values) for p in pods]
    got = pungater.assign_pods_to_domains(carry.api_object(assignment),
                                          ppods, pod_index_label, offset)
    assert [(p.name, d) for p, d in got] == [(p.name, d) for p, d in want]
    return want


@pytest.mark.parametrize("name", [
    "test_ungater_by_rank", "test_ungater_greedy_accounts_running_pods",
    "test_ungater_bad_ranks_falls_back_to_greedy"])
def test_ungater_cases_match(monkeypatch, name):
    monkeypatch.setattr(tte, "assign_pods_to_domains", mirrored_assign)
    getattr(tte, name)()


# -- the speculation across pod and node events (ROADMAP trap) --

def _probe_world(monkeypatch, event):
    """Two nodes of one rack, two ClusterQueues, six one-pod REQUIRED
    rack workloads on the default loop, the host TAS path; cycle 1
    admits and encodes the speculation of cycle 2; then ``event`` runs
    and cycle 2 follows."""
    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    monkeypatch.delenv("KUEUE_TPU_COLUMNAR", raising=False)
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", PATHS["host"])
    te._ENGINES.clear()
    t = jtypes
    eng = PipelineMirroredEngine()
    eng.create_topology(t.Topology("topo", (
        t.TopologyLevel("rack"), t.TopologyLevel(jsnapshot.HOSTNAME_LABEL))))
    eng.create_resource_flavor(t.ResourceFlavor("tas", topology_name="topo"))
    for h in range(2):
        eng.create_node(jsnapshot.Node(
            f"n{h}", labels={"rack": "r0", jsnapshot.HOSTNAME_LABEL: f"n{h}"},
            capacity={"cpu": 4000, "pods": 10}))
    for i in range(2):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas(
                    "tas", {"cpu": t.ResourceQuota(8000)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq{i}", "default", f"cq{i}"))
    eng.attach_oracle()
    if event == "observe_pod_deleted":
        for h in range(2):
            eng.observe_pod(jnon.PodUsage("kube-system", f"ds-n{h}",
                                          node_name=f"n{h}",
                                          requests={"cpu": 2000}))
    for i in range(6):
        eng.clock += 0.001
        eng.submit(t.Workload(
            name=f"w{i}", queue_name=f"lq{i % 2}", pod_sets=(t.PodSet(
                "main", 1, {"cpu": 1000},
                topology_request=t.PodSetTopologyRequest(
                    mode=t.TopologyMode.REQUIRED, level="rack")),)))
    first = eng.schedule_once()
    assert first is not None and first.stats.admitted == 2
    assert eng.oracle._spec is not None
    if event == "observe_pod":
        for h in range(2):
            eng.observe_pod(jnon.PodUsage("kube-system", f"ds-n{h}",
                                          node_name=f"n{h}",
                                          requests={"cpu": 4000}))
    elif event == "observe_pod_deleted":
        for h in range(2):
            eng.observe_pod_deleted("kube-system", f"ds-n{h}")
    else:
        for h in range(2):
            eng.mark_node_unhealthy(f"n{h}", reason="NodeDeleted")
    return eng, eng.schedule_once()


@pytest.mark.parametrize("event", ["observe_pod", "observe_pod_deleted",
                                   "mark_node_unhealthy"])
def test_speculation_across_pod_and_node_events(monkeypatch, event):
    """None of the three events moves the speculation token unless it
    re-queues rows or writes the journal: the speculation encoded at the
    end of cycle 1 is used in cycle 2 in both packages alike, and the TAS
    commit re-check keeps the stale placements out (pipeline_stats and
    decisions compared every cycle by PipelineMirroredEngine)."""
    eng, second = _probe_world(monkeypatch, event)
    stats = eng.oracle.pipeline_stats
    assert eng.port.oracle.pipeline_stats == stats
    if event == "observe_pod_deleted":
        # The freed capacity re-queues nothing that the speculation read:
        # the speculated heads place in the freed room.
        assert second is not None and second.stats.admitted == 2
    else:
        assert (stats["used"], stats["discarded"]) == (1, 0)
        assert second is None or second.stats.admitted == 0
    eng.assert_same_world()
    te._ENGINES.clear()


# -- a journal across a node failure (ROADMAP trap (ak)) --

def _journal_world(pkg, path):
    """One rack of two 4-cpu hosts and a spare rack; a 6-pod REQUIRED
    rack workload fills r0 (4 + 2), a node failure on its 4-pod host
    leaves room for 2, so the replacement fails and the second pass is
    armed for a retry when the journal closes."""
    t = jtypes if pkg == "jax" else ptypes
    snap = jsnapshot if pkg == "jax" else psnapshot
    jmod = jjournal if pkg == "jax" else pjournal
    eng = JEngine() if pkg == "jax" else PEngine(device="cpu")
    eng.create_topology(t.Topology("topo", (
        t.TopologyLevel("rack"), t.TopologyLevel(snap.HOSTNAME_LABEL))))
    eng.create_resource_flavor(t.ResourceFlavor("tas", topology_name="topo"))
    for r in range(2):
        for h in range(2):
            name = f"r{r}-h{h}"
            eng.create_node(snap.Node(name, labels={
                "rack": f"r{r}", snap.HOSTNAME_LABEL: name},
                capacity={"cpu": 4000, "pods": 10}))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "tas", {"cpu": t.ResourceQuota(16000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
    jmod.attach_new_journal(eng, path)
    for name, count in (("big", 6), ("small", 3)):
        eng.clock += 0.001
        eng.submit(t.Workload(name=name, queue_name="lq", pod_sets=(
            t.PodSet("main", count, {"cpu": 1000},
                     topology_request=t.PodSetTopologyRequest(
                         mode=t.TopologyMode.REQUIRED, level="rack")),)))
    eng.schedule_once()
    eng.schedule_once()
    big = eng.workloads["default/big"]
    ta = big.status.admission.pod_set_assignments[0].topology_assignment
    failed = max(ta.domains, key=lambda d: d.count).values[-1]
    eng.mark_node_unhealthy(failed, reason="NodeDeleted")
    eng.schedule_once()
    assert big.status.unhealthy_nodes == (failed,)
    assert eng._second_pass_attempts == {"default/big": 1}
    eng.journal.close()
    return eng, failed


@pytest.fixture
def aligned_uids():
    old = (jtypes._uid_counter, ptypes._uid_counter)
    jtypes._uid_counter = itertools.count(70_000_001)
    ptypes._uid_counter = itertools.count(70_000_001)
    yield
    jtypes._uid_counter, ptypes._uid_counter = old


def test_journal_across_a_node_failure(tmp_path, monkeypatch, aligned_uids):
    """Both packages write the same journal across the failure, and each
    package rebuilds each journal with the second pass re-armed: a node
    added to the rack then takes the replacement, with the same
    placement and events in all four rebuilds."""
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", PATHS["host"])
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        _, failed = _journal_world(pkg, paths[pkg])
        jtypes._uid_counter = itertools.count(70_000_001)
        ptypes._uid_counter = itertools.count(70_000_001)
    data = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert data["port"] == data["jax"]
    assert b"unhealthy_nodes" in data["port"]
    outcomes = []
    for src in ("jax", "port"):
        for pkg in ("jax", "port"):
            copy = str(tmp_path / f"{src}-{pkg}.jsonl")
            shutil.copy(paths[src], copy)
            if pkg == "jax":
                eng = jjournal.rebuild_engine(copy)
                t, snap = jtypes, jsnapshot
            else:
                eng = pjournal.rebuild_engine(copy, device="cpu")
                t, snap = ptypes, psnapshot
            assert failed not in eng.cache.nodes
            big = eng.workloads["default/big"]
            assert big.status.unhealthy_nodes == (failed,)
            assert list(eng.queues.second_pass._ready_at) == ["default/big"]
            rack = failed.split("-")[0]
            eng.create_node(snap.Node(f"{rack}-h2", labels={
                "rack": rack, snap.HOSTNAME_LABEL: f"{rack}-h2"},
                capacity={"cpu": 4000, "pods": 10}))
            eng.schedule_once()
            assert big.status.unhealthy_nodes == ()
            ta = big.status.admission.pod_set_assignments[0] \
                .topology_assignment
            outcomes.append((
                tuple((tuple(d.values), d.count) for d in ta.domains),
                [(e.kind, e.workload, e.detail) for e in eng.events
                 if e.kind.startswith("Node")]))
            eng.journal.close()
    assert all(o == outcomes[0] for o in outcomes)
    assert outcomes[0][1] == [("NodeReplaced", "default/big", failed)]
    rack = failed.split("-")[0]
    assert (rack, f"{rack}-h2") in {d[0] for d in outcomes[0][0]}


def test_eviction_keeps_unhealthy_nodes(monkeypatch):
    """Reference-side behaviour the port keeps (ROADMAP Queue 3):
    a workload evicted while its replacement is pending keeps
    ``status.unhealthy_nodes``, and its re-admission through the cycle
    places it afresh without clearing them, in both engines alike."""
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", PATHS["host"])
    te._ENGINES.clear()
    t = jtypes
    eng = te.MirroredEngine()
    eng.create_topology(t.Topology("topo", (
        t.TopologyLevel("rack"), t.TopologyLevel(jsnapshot.HOSTNAME_LABEL))))
    eng.create_resource_flavor(t.ResourceFlavor("tas", topology_name="topo"))
    for h in range(3):
        eng.create_node(jsnapshot.Node(
            f"h{h}", labels={"rack": "r0", jsnapshot.HOSTNAME_LABEL: f"h{h}"},
            capacity={"cpu": 4000, "pods": 10}))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "tas", {"cpu": t.ResourceQuota(12000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
    w = t.Workload(name="w", queue_name="lq", pod_sets=(t.PodSet(
        "main", 6, {"cpu": 1000}, topology_request=t.PodSetTopologyRequest(
            mode=t.TopologyMode.REQUIRED, level="rack")),))
    eng.submit(w)
    eng.schedule_once()
    failed = min(tte.admitted_nodes(w))
    eng.mark_node_unhealthy(failed, reason="NodeDeleted")
    eng.evict(w, "Preempted")
    eng.clock += 1.0
    eng.schedule_once()
    assert w.is_admitted and failed not in tte.admitted_nodes(w)
    assert w.status.unhealthy_nodes == (failed,)
    assert not [e for e in eng.events if e.kind == "NodeReplaced"]
    eng.assert_same_world()
    te._ENGINES.clear()
