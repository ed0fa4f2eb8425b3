"""The port's serving engine (kueue_tpu_torch/controllers/engine.py, with
its OracleBridge over a TorchExecutor on the CPU) against the JAX
package's engine, cycle by cycle.

``MirroredEngine`` is the JAX engine with a port engine beside it: every
create_*, delete_node, submit, finish, tick, attach_oracle, observe_pod,
observe_pod_deleted, mark_node_unhealthy and clock change a test makes
is made on both (API objects carried across with their uid), and every
schedule_once runs both and asserts, in order,
equal decision streams (admitted entries with their flavors and
topology placements, preempted keys, stats), the same path (device,
hybrid or sequential) and equal bridge counters, reasons and TAS
planner stats. Patched in as the reference tests' ``Engine``, it runs
their own worlds and call sequences; when the test ends, every workload's
outcome (check states, backoff and unhealthy nodes included), the event
streams, the second-pass queues and the admission-fair-sharing usage
must be equal too. Exact throughout.

``MirroredAfsManager``, ``MirroredCheckManager`` and
``MirroredProvisioningController`` do the same for the managers that
attach themselves to an engine: each builds its port twin on the port
engine and repeats every call a test makes on it (usage seeded into
``usage``, check definitions, check verdicts, provisioning outcomes).
Calls the JAX package makes internally are not repeated: the port twin
makes its own."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import test_fair_device
import test_hybrid_cycles
import test_multiflavor_preempt_device as tmf
import test_oracle_engine
import test_preempt_churn
from kueue_tpu.api.types import WorkloadConditionType as JWCT
from kueue_tpu.controllers import admissionchecks as jchecks
from kueue_tpu.controllers import afs as jafs
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.ops import assign as jassign
from kueue_tpu_torch import carry
from kueue_tpu_torch.bench.engine_worlds import decision_stream
from kueue_tpu_torch.bench.tas_engine_worlds import placement_stream
from kueue_tpu_torch.config.api import AdmissionFairSharingConfig
from kueue_tpu_torch.controllers import admissionchecks as pchecks
from kueue_tpu_torch.controllers import afs as pafs
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.ops import assign as tassign

_ENGINES: list = []


_TAS_STATS = ("plan_cycles", "heads_planned", "placed_device",
              "placed_host", "memo_hits", "commit_drops")


def _bridge_state(eng):
    b = eng.oracle
    if b is None:
        return None
    return (b.cycles_on_device, b.cycles_hybrid, b.cycles_fallback,
            dict(b.fallback_reasons), dict(b.host_root_reasons),
            {k: b.tas_stats[k] for k in _TAS_STATS},
            dict(b.tas_heads_per_launch))


def _topology(psa):
    ta = psa.topology_assignment
    if ta is None:
        return None
    return tuple(ta.levels), tuple((tuple(d.values), d.count)
                                   for d in ta.domains)


def outcome(wl):
    adm = wl.status.admission
    return (wl.is_admitted, wl.is_finished, wl.is_evicted, wl.active,
            wl.priority, wl.status.requeue_count, wl.status.requeue_at,
            dict(wl.status.eviction_counts),
            sorted(wl.status.admission_check_states.items()),
            wl.status.check_retry_after_seconds,
            None if adm is None else (adm.cluster_queue, tuple(
                (psa.name, psa.count, tuple(sorted(psa.flavors.items())),
                 _topology(psa))
                for psa in adm.pod_set_assignments)),
            tuple(sorted((c.value, cond.status, cond.reason)
                         for c, cond in wl.status.conditions.items())),
            tuple(wl.status.unhealthy_nodes))


class MirroredEngine(JEngine):
    """The JAX engine driving a port engine through the same calls."""

    def __init__(self, enable_fair_sharing=False, **kw):
        self.port = PEngine(enable_fair_sharing=enable_fair_sharing,
                            device="cpu")
        self.cycles = 0
        super().__init__(enable_fair_sharing=enable_fair_sharing, **kw)
        _ENGINES.append(self)

    @property
    def clock(self):
        return self.__dict__["_clock"]

    @clock.setter
    def clock(self, value):
        self.__dict__["_clock"] = value
        self.port.clock = value

    def create_resource_flavor(self, rf):
        super().create_resource_flavor(rf)
        self.port.create_resource_flavor(carry.api_object(rf))

    def create_cohort(self, cohort):
        super().create_cohort(cohort)
        self.port.create_cohort(carry.api_object(cohort))

    def create_cluster_queue(self, cq):
        super().create_cluster_queue(cq)
        self.port.create_cluster_queue(carry.api_object(cq))

    def create_local_queue(self, lq):
        super().create_local_queue(lq)
        self.port.create_local_queue(carry.api_object(lq))

    def create_topology(self, topology):
        super().create_topology(topology)
        self.port.create_topology(carry.api_object(topology))

    def create_node(self, node):
        super().create_node(node)
        self.port.create_node(carry.api_object(node))

    def delete_node(self, name):
        super().delete_node(name)
        self.port.delete_node(name)

    def create_workload_priority_class(self, name, value):
        super().create_workload_priority_class(name, value)
        self.port.create_workload_priority_class(name, value)

    def _same_non_tas_usage(self, call, *args):
        """Make a non-TAS pod usage call on both engines: the same node
        totals and version after it, and the TAS prototypes dropped in
        both or in neither."""
        jprotos, pprotos = self.cache._tas_protos, self.port.cache._tas_protos
        getattr(super(), call)(*args)
        getattr(self.port, call)(*(carry.api_object(a) for a in args))
        jusage = self.cache.non_tas_usage
        pusage = self.port.cache.non_tas_usage
        assert pusage.nodes() == jusage.nodes()
        assert pusage.version == jusage.version
        assert (self.port.cache._tas_protos is pprotos) == \
            (self.cache._tas_protos is jprotos)

    def observe_pod(self, pod):
        self._same_non_tas_usage("observe_pod", pod)

    def observe_pod_deleted(self, namespace, name):
        self._same_non_tas_usage("observe_pod_deleted", namespace, name)

    def mark_node_unhealthy(self, name, reason=""):
        """A test's own node failure is made on both engines; those the
        JAX package's node-health controller makes are its own (its port
        twin makes the port's)."""
        super().mark_node_unhealthy(name, reason=reason)
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if not caller.startswith("kueue_tpu."):
            self.port.mark_node_unhealthy(name, reason=reason)

    def evict(self, wl, reason, requeue=True, backoff_seconds=0.0,
              bulk=None):
        """A test's own eviction is made on both engines; the JAX
        engine's evictions from inside its package are its own."""
        super().evict(wl, reason, requeue=requeue,
                      backoff_seconds=backoff_seconds, bulk=bulk)
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if not caller.startswith("kueue_tpu."):
            self.port.evict(self.port.workloads[wl.key], reason,
                            requeue=requeue,
                            backoff_seconds=backoff_seconds)

    def submit(self, wl):
        pw = carry.api_object(wl)
        assert pw.uid == wl.uid
        got = self.port.submit(pw)
        assert super().submit(wl) == got
        return got

    def finish(self, key):
        """A test's own finish is made on both engines; the JAX engine's
        finishes from inside its package (a replaced workload slice) are
        its own."""
        super().finish(key)
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if not caller.startswith("kueue_tpu."):
            self.port.finish(key)

    def tick(self, dt):
        before = self.clock
        super().tick(dt)
        self.port.clock = before
        self.port.tick(dt)
        assert self.port.clock == self.clock

    def attach_oracle(self, max_depth=4, remote_address=None):
        super().attach_oracle(max_depth=max_depth)
        self.port.attach_oracle(max_depth=max_depth, device="cpu")

    def schedule_once(self):
        want = super().schedule_once()
        got = self.port.schedule_once()
        self.cycles += 1
        where = f"cycle {self.cycles}"
        assert decision_stream(got) == decision_stream(want), where
        assert placement_stream(got) == placement_stream(want), where
        assert ([[t.workload.key for t in e.preemption_targets]
                 for e in (got.entries if got else ())]
                == [[t.workload.key for t in e.preemption_targets]
                    for e in (want.entries if want else ())]), where
        assert self.port.last_cycle_mode == self.last_cycle_mode, where
        assert _bridge_state(self.port) == _bridge_state(self), where
        return want

    def assert_same_world(self):
        assert self.port.clock == self.clock
        assert sorted(self.port.workloads) == sorted(self.workloads)
        for key, wl in self.workloads.items():
            assert outcome(self.port.workloads[key]) == outcome(wl), key
        assert [(e.time, e.kind, e.workload, e.cluster_queue, e.detail)
                for e in self.port.events] == [
            (e.time, e.kind, e.workload, e.cluster_queue, e.detail)
            for e in self.events]
        jsp, psp = self.queues.second_pass, self.port.queues.second_pass
        assert (psp._prequeued, list(psp._queued),
                list(psp._ready_at.items())) == \
            (jsp._prequeued, list(jsp._queued), list(jsp._ready_at.items()))
        assert self.port._second_pass_attempts == self._second_pass_attempts
        if self.afs is not None:
            assert {k: (u.value, u.last_update)
                    for k, u in self.port.afs.usage.items()} == {
                k: (u.value, u.last_update)
                for k, u in self.afs.usage.items()}


class OracleMirroredEngine(MirroredEngine):
    """A MirroredEngine with the oracle attached from the start, for the
    reference tests that build a sequential engine."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.attach_oracle()


def _port_copy(obj, cls):
    """The port dataclass ``cls`` with the field values of ``obj`` (a
    JAX-package config dataclass; nested ones converted by name)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _port_copy(v, getattr(pchecks, type(v).__name__))
        elif isinstance(v, dict):
            v = dict(v)
        kw[f.name] = v
    return cls(**kw)


class _MirroredUsage(dict):
    """The JAX AfsManager's usage map: an entry a test sets is set on the
    port twin too (the managers' own updates are their own)."""

    def __init__(self, port_usage):
        super().__init__()
        self.port_usage = port_usage

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.port_usage[key] = pafs._LqUsage(value=value.value,
                                             last_update=value.last_update)


class MirroredAfsManager(jafs.AfsManager):
    def __init__(self, engine, config=None):
        super().__init__(engine, config)
        self.port = pafs.AfsManager(engine.port, _port_copy(
            self.config, AdmissionFairSharingConfig))
        self.usage = _MirroredUsage(self.port.usage)


class MirroredCheckManager(jchecks.AdmissionCheckManager):
    def __init__(self, engine):
        super().__init__(engine)
        self.port = pchecks.AdmissionCheckManager(engine.port)
        self.quiet = 0  # >0 while a mirrored controller runs

    def create_admission_check(self, check):
        super().create_admission_check(check)
        self.port.create_admission_check(_port_copy(
            check, pchecks.AdmissionCheck))

    def delete_admission_check(self, name):
        super().delete_admission_check(name)
        self.port.delete_admission_check(name)

    def set_state(self, wl_key, check, state):
        super().set_state(wl_key, check, state)
        if not self.quiet:
            self.port.set_state(wl_key, check,
                                pchecks.CheckState(state.value))


class MirroredProvisioningController(jchecks.ProvisioningController):
    """Each call runs the JAX controller (its verdicts not repeated on
    the port engine), then the port twin's same call."""

    def __init__(self, engine, check_name, max_retries=None, config=None):
        super().__init__(engine, check_name, max_retries=max_retries,
                         config=config)
        self.port = pchecks.ProvisioningController(
            engine.port, check_name, max_retries=max_retries,
            config=None if config is None else _port_copy(
                config, pchecks.ProvisioningRequestConfig))
        self._nested = False

    def _jax(self, fn, *a):
        acm = self.engine.admission_checks
        acm.quiet += 1
        nested, self._nested = self._nested, True
        try:
            fn(*a)
        finally:
            acm.quiet -= 1
            self._nested = nested

    def reconcile(self):
        self._jax(super().reconcile)
        if not self._nested:
            self.port.reconcile()

    def mark_provisioned(self, wl_key, details=None):
        self._jax(super().mark_provisioned, wl_key, details)
        self.port.mark_provisioned(wl_key, details)

    def mark_failed(self, wl_key):
        self._jax(super().mark_failed, wl_key)
        self.port.mark_failed(wl_key)


@pytest.fixture
def mirrored(monkeypatch):
    """Patch MirroredEngine into the reference test modules; after the
    test, hold every mirrored engine's world to the JAX engine's. The JAX
    bridge runs its serial loop (KUEUE_TPU_PIPELINE=0), as the port's
    does: a speculative encode syncs the admitted rows a cycle early,
    which renumbers them and so reorders a slot's victim list (and the
    evictions) without changing the decisions."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    for mod in (test_oracle_engine, test_hybrid_cycles, tmf,
                test_preempt_churn, test_fair_device):
        monkeypatch.setattr(mod, "Engine", MirroredEngine)
    _ENGINES.clear()
    yield
    assert _ENGINES, "no mirrored engine was built"
    for eng in _ENGINES:
        eng.assert_same_world()
    _ENGINES.clear()


@pytest.mark.parametrize("name", [
    "test_oracle_engine_matches_sequential_outcomes",
    "test_oracle_engine_continues_after_finish",
    "test_oracle_handles_within_cq_preemption_on_device",
    "test_oracle_falls_back_for_cross_cq_reclaim"])
def test_oracle_engine_worlds(mirrored, name):
    getattr(test_oracle_engine, name)()


@pytest.mark.parametrize("name", [
    "test_mixed_world_stays_on_device",
    "test_mixed_preemption_scopes_hybrid",
    "test_cross_cq_reclaim_on_device",
    "test_multi_podset_heads_stay_on_device"])
def test_hybrid_cycle_worlds(mirrored, name):
    getattr(test_hybrid_cycles, name)()


def test_requeue_backoff_on_device(mirrored):
    """tests/test_hybrid_cycles.py's backoff world, with the test's
    direct status write made on both engines' objects."""
    from kueue_tpu.api.types import PodSet, Workload

    eng = test_hybrid_cycles.make_engine(
        oracle=True, n_cohorts=1, cqs_per_cohort=1, nominal=1000)
    eng.clock = 1.0
    w1 = Workload(name="held", queue_name="lq0",
                  pod_sets=(PodSet("main", 1, {"cpu": 500}),))
    eng.submit(w1)
    w1.status.requeue_at = 100.0  # backoff until t=100
    eng.port.workloads[w1.key].status.requeue_at = 100.0
    eng.clock = 2.0
    w2 = Workload(name="ready", queue_name="lq0",
                  pod_sets=(PodSet("main", 1, {"cpu": 500}),))
    eng.submit(w2)
    eng.schedule_once()
    assert w2.is_admitted and not w1.is_admitted
    eng.clock = 101.0
    eng.schedule_once()
    assert w1.is_admitted


def test_gated_head_on_host(mirrored):
    """tests/test_hybrid_cycles.py's closed-preemption-gate world: the
    gated head demotes to the host cycle, then the gate opens (on both
    engines' objects and queues)."""
    from kueue_tpu.api.types import (
        ClusterQueuePreemption,
        PodSet,
        PreemptionPolicy,
        Workload,
    )

    eng = test_hybrid_cycles.make_engine(
        oracle=True, n_cohorts=1, cqs_per_cohort=1, nominal=1000,
        preemption_of=lambda i: ClusterQueuePreemption(
            within_cluster_queue=PreemptionPolicy.LOWER_PRIORITY))
    filler = Workload(name="filler", queue_name="lq0",
                      pod_sets=(PodSet("main", 1, {"cpu": 1000}),))
    eng.submit(filler)
    eng.schedule_once()
    eng.clock += 1
    hi = Workload(name="hi", queue_name="lq0", priority=5,
                  pod_sets=(PodSet("main", 1, {"cpu": 1000}),))
    hi.ensure_preemption_gate("mk-gate")
    eng.submit(hi)
    eng.schedule_once()
    assert hi.has_condition(JWCT.BLOCKED_ON_PREEMPTION_GATES)
    assert eng.oracle.host_root_reasons.get("preemption-gated", 0) >= 1
    for w, q in ((hi, eng.queues), (eng.port.workloads[hi.key],
                                    eng.port.queues)):
        w.open_preemption_gate("mk-gate", eng.clock)
        q.queue_inadmissible_workloads()
    test_hybrid_cycles.drain(eng)
    assert filler.is_evicted and hi.is_admitted


_GRID_CALLS: list = []


@pytest.fixture
def grid_recorder(monkeypatch):
    """Record every flavor_grid call of the JAX bridge (inputs and
    outputs as numpy)."""
    real = jassign.flavor_grid

    def recording(*args, **kw):
        out = real(*args, **kw)
        _GRID_CALLS.append((
            [{k: np.asarray(v) for k, v in a.items()}
             if isinstance(a, dict) else np.asarray(a) for a in args],
            dict(kw), [np.asarray(o) for o in out]))
        return out

    _GRID_CALLS.clear()
    monkeypatch.setattr(jassign, "flavor_grid", recording)
    yield _GRID_CALLS
    _GRID_CALLS.clear()


def _assert_grid_calls_match(calls):
    assert calls, "the sim nomination never ran"
    for args, kw, want in calls:
        t_args = [{k: torch.as_tensor(np.array(v)) for k, v in a.items()}
                  if isinstance(a, dict) else torch.as_tensor(np.array(a))
                  for a in args]
        got = tassign.flavor_grid(*t_args, **kw)
        for i, (g, x) in enumerate(zip(got, want)):
            assert g.numpy().dtype == x.dtype, f"output {i}"
            np.testing.assert_array_equal(g.numpy(), x,
                                          err_msg=f"output {i}")


@pytest.mark.parametrize("seed", range(8))
def test_multiflavor_preempt_worlds(mirrored, grid_recorder, seed):
    """Sim nomination with all three slot overrides; flavor_grid equal
    to the JAX one on the bridge's own inputs."""
    tmf.test_multiflavor_preempt_matches_sequential(seed)
    _assert_grid_calls_match(grid_recorder)


@pytest.mark.parametrize("seed", range(4))
def test_multiflavor_try_next_worlds(mirrored, grid_recorder, seed):
    tmf.test_multiflavor_try_next_matches_sequential(seed)
    _assert_grid_calls_match(grid_recorder)


def test_stops_at_preempt_capable_flavor(mirrored):
    tmf.test_stops_at_preempt_capable_flavor()


@pytest.mark.parametrize("seed", range(4))
def test_preempt_churn_worlds(mirrored, seed):
    test_preempt_churn.test_churn_outcomes_match_sequential(seed)


@pytest.mark.parametrize("seed", range(3))
def test_fair_nested_worlds(mirrored, seed):
    test_fair_device.test_fair_device_hierarchical_matches_sequential(seed)


def node_selector_world(oracle: bool, seed: int, engine_cls=JEngine):
    """Two cohorts of ClusterQueues over an "ssd" and an "hdd" flavor
    (node labels disk=ssd / disk=hdd) without preemption: workloads that
    select disk=ssd get a per-workload flavor mask on the device path."""
    from kueue_tpu.api.types import (
        ClusterQueue,
        Cohort,
        FlavorQuotas,
        LocalQueue,
        ResourceFlavor,
        ResourceGroup,
        ResourceQuota,
    )

    rng = np.random.default_rng(seed)
    eng = engine_cls()
    eng.create_resource_flavor(ResourceFlavor(
        "hdd", node_labels={"disk": "hdd"}))
    eng.create_resource_flavor(ResourceFlavor(
        "ssd", node_labels={"disk": "ssd"}))
    for c in range(2):
        eng.create_cohort(Cohort(f"co{c}"))
    for i in range(4):
        order = ("hdd", "ssd") if i % 2 else ("ssd", "hdd")
        eng.create_cluster_queue(ClusterQueue(
            name=f"cq{i}", cohort=f"co{i % 2}",
            resource_groups=(ResourceGroup(("cpu",), tuple(
                FlavorQuotas(f, {"cpu": ResourceQuota(
                    int(rng.choice([1000, 2000])))})
                for f in order)),)))
        eng.create_local_queue(LocalQueue(f"lq{i}", "default", f"cq{i}"))
    if oracle:
        eng.attach_oracle()
    return eng


def node_selector_traffic(eng, seed: int, n=40):
    """Submissions (a third select disk=ssd), cycles and finishes."""
    from kueue_tpu.api.types import PodSet, Workload

    rng = np.random.default_rng(seed + 1)
    for i in range(n):
        eng.clock += 0.25
        sel = {"disk": "ssd"} if rng.random() < 0.35 else {}
        eng.submit(Workload(
            name=f"w{i}", queue_name=f"lq{int(rng.integers(4))}",
            priority=int(rng.choice([0, 5])),
            pod_sets=(PodSet("main", 1, {"cpu": int(rng.choice(
                [300, 700, 1200]))}, node_selector=sel),)))
        if rng.random() < 0.5:
            eng.schedule_once()
        if rng.random() < 0.25:
            admitted = sorted(k for k, x in eng.workloads.items()
                              if x.is_admitted)
            if admitted:
                eng.finish(admitted[int(rng.integers(len(admitted)))])
    for _ in range(60):
        r = eng.schedule_once()
        if r is None or not r.assumed:
            break


@pytest.mark.parametrize("seed", range(3))
def test_node_selector_worlds(mirrored, seed):
    """Per-workload flavor masks on the device path, against the JAX
    engine."""
    eng = node_selector_world(True, seed, engine_cls=MirroredEngine)
    node_selector_traffic(eng, seed)
    assert eng.oracle.cycles_on_device > 0


def test_attach_oracle_defaults_to_cuda():
    eng = PEngine()
    if torch.cuda.is_available():
        eng.attach_oracle()
        assert eng.oracle.executor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            eng.attach_oracle()
    eng.attach_oracle(device="cpu")
    assert eng.oracle.executor.device.type == "cpu"


def test_executor_error_propagates():
    """A failing executor is not turned into a host fallback: the error
    leaves schedule_once and nothing is counted as a fallback. (The
    bridge's supervisor counts the failure; only a RemoteOracleError
    becomes a host cycle.)"""
    from kueue_tpu_torch.bench.engine_worlds import build_cycle_engine, \
        port_kit
    from kueue_tpu_torch.bench.scenario import baseline_like

    eng = build_cycle_engine(
        baseline_like(n_cohorts=2, cqs_per_cohort=2, n_workloads=40),
        kit=port_kit("cpu"))

    def fail(tensors, statics):
        raise RuntimeError("device failure")

    eng.oracle.executor.cycle_step = fail
    with pytest.raises(RuntimeError, match="device failure"):
        eng.schedule_once()
    assert eng.oracle.cycles_fallback == 0
    assert eng.oracle.fallback_reasons == {}


def _same_template_submits(port_eng, jax_eng):
    """Submit templated workloads to both engines (the JAX engine a JAX
    package object, the port its carried copy): one the pipeline adjusts
    (a LimitRange-free default, limits promoted, an init container, a
    RuntimeClass overhead) and one it refuses (requests above limits).
    The same verdicts, per-pod requests, registration, activity and last
    event."""
    from kueue_tpu.api import types as jt
    from kueue_tpu.utils.podtemplate import ContainerSpec, PodTemplate

    for eng in (port_eng, jax_eng):
        eng.create_runtime_class("kata", {"cpu": 5})
    for name, tpl in (
            ("adjusted", PodTemplate(
                containers=[ContainerSpec("a", {"cpu": 2}),
                            ContainerSpec("b", limits={"cpu": 3})],
                init_containers=[ContainerSpec("i", {"cpu": 9})],
                runtime_class_name="kata")),
            ("refused", PodTemplate(containers=[ContainerSpec(
                "a", {"cpu": 9}, limits={"cpu": 1})]))):
        wl = jt.Workload(name=name, pod_sets=(
            jt.PodSet("main", 1, template=tpl),))
        pw = carry.api_object(wl)
        assert port_eng.submit(pw) == jax_eng.submit(wl)
        assert pw.pod_sets[0].requests == wl.pod_sets[0].requests
        assert pw.pod_sets[0].template == carry.api_object(
            wl.pod_sets[0].template)
        assert (pw.key in port_eng.workloads, pw.active) == \
            (wl.key in jax_eng.workloads, wl.active)
        assert [(e.kind, e.workload, e.detail)
                for e in port_eng.events[-1:]] == \
            [(e.kind, e.workload, e.detail) for e in jax_eng.events[-1:]]
    assert port_eng.workloads["default/adjusted"].pod_sets[0].requests \
        == {"cpu": 14}
    assert not port_eng.workloads["default/refused"].active


def test_topologies_are_refused():
    """Topologies, TAS flavors, nodes and topology requests are taken, and
    since the TAS node lifecycle was ported so are non-TAS pod usage,
    node failures and elastic slices (tests/test_torch_tas_lifecycle.py
    holds them against the JAX engine); since the effective-requests
    pipeline was ported a pod template is taken too, adjusted and
    validated as the JAX engine does (tests/test_torch_resources.py holds
    the pipeline against it)."""
    from kueue_tpu_torch.api.types import (
        PodSet,
        PodSetTopologyRequest,
        ResourceFlavor,
        Topology,
        TopologyLevel,
        Workload,
    )
    from kueue_tpu_torch.tas.non_tas_usage import PodUsage
    from kueue_tpu_torch.tas.snapshot import (
        HOSTNAME_LABEL,
        Node,
        TASFlavorSnapshot,
        TASPodSetRequest,
        TopologyAssignment,
    )

    eng = PEngine(device="cpu")
    eng.create_topology(Topology("topo", (TopologyLevel(HOSTNAME_LABEL),)))
    eng.create_resource_flavor(ResourceFlavor("tas", topology_name="topo"))
    eng.create_node(Node("n0", labels={HOSTNAME_LABEL: "n0"},
                         capacity={"cpu": 4}))
    eng.submit(Workload(name="t", pod_sets=(PodSet(
        "main", 1, {"cpu": 1},
        topology_request=PodSetTopologyRequest()),)))
    assert "default/t" in eng.workloads
    eng.delete_node("n0")
    assert "n0" not in eng.cache.nodes
    eng.observe_pod(PodUsage("kube-system", "ds", node_name="n0",
                             requests={"cpu": 1}))
    assert eng.cache.non_tas_usage.node_usage("n0") == {"cpu": 1, "pods": 1}
    eng.observe_pod_deleted("kube-system", "ds")
    assert len(eng.cache.non_tas_usage) == 0
    eng.mark_node_unhealthy("n0")
    assert not eng.queues.second_pass._queued  # nothing was placed there
    snap = TASFlavorSnapshot(Topology("topo", (
        TopologyLevel(HOSTNAME_LABEL),)), device="cpu")
    elastic = TASPodSetRequest(
        PodSet("main", 1, {"cpu": 1}), {"cpu": 1}, 1,
        previous_assignment=TopologyAssignment((HOSTNAME_LABEL,), ()))
    results, reason = snap.find_topology_assignments_for_flavor([elastic])
    assert reason and not results  # an empty forest places nothing
    _same_template_submits(eng, JEngine())


def test_admission_fair_sharing_is_refused():
    """Admission fair sharing is taken now (tests/test_torch_afs.py holds
    it against the JAX engine), and so is a pod template, registered
    (inactive when the pipeline refuses it) as the JAX engine registers
    it."""
    from kueue_tpu.api.types import ClusterQueue as JClusterQueue
    from kueue_tpu_torch.api.types import ClusterQueue

    eng = PEngine(device="cpu")
    eng.create_cluster_queue(ClusterQueue(
        name="cq", admission_scope="UsageBasedAdmissionFairSharing"))
    assert "cq" in eng.queues.cluster_queues
    jeng = JEngine()
    jeng.create_cluster_queue(JClusterQueue(
        name="cq", admission_scope="UsageBasedAdmissionFairSharing"))
    _same_template_submits(eng, jeng)
    assert "default/adjusted" in eng.workloads


def test_mirrored_worlds_carry_uids():
    """The uid is carried across as it is (candidate order breaks ties
    on it)."""
    from kueue_tpu.api.types import PodSet, Workload

    w = Workload(name="a", pod_sets=(PodSet("main", 2, {"cpu": 3}),))
    p = carry.api_object(w)
    assert p.uid == w.uid and type(p).__module__.startswith(
        "kueue_tpu_torch")
    assert p.pod_sets[0].requests == {"cpu": 3}


def test_execution_budget_given_after_submit():
    """``tests/test_lifecycle_features.py``'s budget across admissions in
    each package, the budget given to the submitted object (the port's
    tick skips its scan only while no workload in the process was ever
    given one): both evict at the same tick with the same counts."""
    from kueue_tpu.api import types as jt
    from kueue_tpu_torch.api import types as pt

    out = []
    for t, engine in ((jt, JEngine), (pt, lambda: PEngine(device="cpu"))):
        eng = engine()
        eng.create_resource_flavor(t.ResourceFlavor("default"))
        eng.create_cluster_queue(t.ClusterQueue(
            name="cq", resource_groups=(t.ResourceGroup(("cpu",), (
                t.FlavorQuotas("default", {"cpu": t.ResourceQuota(
                    1000)}),)),)))
        eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
        wl = t.Workload(name="w", queue_name="lq", pod_sets=(
            t.PodSet("main", 1, {"cpu": 400}),))
        eng.submit(wl)
        wl.maximum_execution_time_seconds = 100
        assert t is jt or pt.budgets_given() > 0
        eng.schedule_once()
        eng.tick(60.0)
        eng.evict(wl, "Preempted")
        eng.schedule_once()
        seen = [(wl.is_admitted, wl.active)]
        eng.tick(50.0)
        seen.append((wl.is_admitted, wl.active,
                     wl.status.accumulated_past_execution_time_seconds,
                     dict(wl.status.eviction_counts)))
        out.append(seen)
    assert out[1] == out[0]
    assert out[0][-1][1] is False
