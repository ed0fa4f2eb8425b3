"""The port's speculation pipeline (``OracleBridge._maybe_speculate`` /
``_take_speculation``, kueue_tpu_torch/oracle/engine_bridge.py) against
the JAX package's, at the defaults (KUEUE_TPU_PIPELINE and
KUEUE_TPU_COLUMNAR unset: both on).

``PipelineMirroredEngine`` is a ``MirroredEngine``
(tests/test_torch_engine.py), which holds every cycle's decision stream,
path and bridge counters equal, that also holds equal, cycle by cycle,
the bridges' ``pipeline_stats`` (speculated, used, discarded, skipped),
the supervisors' state and the keys of ``last_cycle_phases`` (the port's
carry ``sim`` beside the JAX package's). It runs the reference's oracle,
hybrid, preemption-churn, multi-flavor, fair and node-selector worlds;
the bench worlds (engine, mixed, TAS under both path pins, afs_serving)
run at reduced size through both packages' kits, each schedule_once's
``pipeline_stats`` compared. A fault in a speculative dispatch must move
the supervisor through the JAX package's sequence, and the sidecar's
``RemoteExecutorError`` must still leave ``schedule_once``, one cycle
after the speculation that met it."""

import pytest

import test_fair_device
import test_hybrid_cycles
import test_multiflavor_preempt_device as tmf
import test_oracle_engine
import test_preempt_churn
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers import admissionchecks as jchecks
from kueue_tpu.controllers import afs as jafs
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.oracle import service as jservice
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import mixed_worlds as mw
from kueue_tpu_torch.bench import tas_engine_worlds as tw
from kueue_tpu_torch.oracle import engine_bridge as pbridge
from kueue_tpu_torch.oracle import service as pservice
from test_torch_engine import (
    _ENGINES,
    MirroredEngine,
    node_selector_traffic,
    node_selector_world,
)


def _phase_keys(eng, port: bool) -> set:
    keys = set(eng.last_cycle_phases)
    if port and eng.last_cycle_mode in ("device", "hybrid"):
        assert "sim" in keys
        keys.discard("sim")
    return keys


class PipelineMirroredEngine(MirroredEngine):
    def schedule_once(self):
        want = super().schedule_once()
        where = f"cycle {self.cycles}"
        if self.oracle is not None:
            jb, pb = self.oracle, self.port.oracle
            assert pb.pipeline_stats == jb.pipeline_stats, where
            assert pb.supervisor.status() == jb.supervisor.status(), where
            assert (pb._spec is None) == (jb._spec is None), where
        if self.last_cycle_phases:
            assert _phase_keys(self.port, True) == \
                _phase_keys(self, False), where
        return want


@pytest.fixture
def pipelined(monkeypatch):
    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    monkeypatch.delenv("KUEUE_TPU_COLUMNAR", raising=False)
    for mod in (test_oracle_engine, test_hybrid_cycles, tmf,
                test_preempt_churn, test_fair_device):
        monkeypatch.setattr(mod, "Engine", PipelineMirroredEngine)
    _ENGINES.clear()
    yield
    assert _ENGINES, "no mirrored engine was built"
    assert any(e.oracle is not None
               and e.oracle.pipeline_stats["speculated"]
               for e in _ENGINES), "nothing was speculated"
    for eng in _ENGINES:
        eng.assert_same_world()
    _ENGINES.clear()


@pytest.mark.parametrize("case", [
    "test_oracle_engine.test_oracle_engine_matches_sequential_outcomes",
    "test_oracle_engine.test_oracle_engine_continues_after_finish",
    "test_oracle_engine.test_oracle_handles_within_cq_preemption_on_device",
    "test_hybrid_cycles.test_mixed_world_stays_on_device",
    "test_hybrid_cycles.test_mixed_preemption_scopes_hybrid",
    "test_hybrid_cycles.test_cross_cq_reclaim_on_device",
    "test_preempt_churn.test_churn_outcomes_match_sequential:0",
    "test_preempt_churn.test_churn_outcomes_match_sequential:1",
    "test_fair_device.test_fair_device_hierarchical_matches_sequential:0"])
def test_reference_worlds(pipelined, case):
    """The reference's engine worlds with the pipeline on: the preempting
    worlds' speculative encodes sync the admitted rows a cycle early
    (renumbering a slot's victims) in both packages alike."""
    name, _, arg = case.partition(":")
    mod, fn = name.split(".")
    args = (int(arg),) if arg else ()
    getattr(globals()[mod], fn)(*args)


def test_node_selector_world(pipelined):
    eng = node_selector_world(True, 0, engine_cls=PipelineMirroredEngine)
    node_selector_traffic(eng, 0)
    assert eng.oracle.cycles_on_device > 0


@pytest.fixture
def jax_kit(monkeypatch, tmp_path):
    """The JAX package's kit at the defaults; both crossover records
    pointed at an empty directory."""
    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    monkeypatch.delenv("KUEUE_TPU_COLUMNAR", raising=False)
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle(), jsnapshot, jafs, jchecks)


def _same_runs(want, got, pinned):
    assert {k: got[k] for k in pinned} == {k: want[k] for k in pinned}
    assert got["pipeline"] == want["pipeline"]
    assert got["pipeline_stats"] == want["pipeline_stats"]
    assert want["pipeline_stats"]["speculated"] > 0


# Reduced worlds on the default loop: fewer workloads, ClusterQueues
# and cycles than the QUARTER twins, the same shapes.
_ENGINE_RUNS = {
    "cycle_latency": dict(ew.QUARTER["cycle_latency"],
                          kw=dict(n_cohorts=10, cqs_per_cohort=5,
                                  n_workloads=2_500), cycles=3, arm="full"),
    "preempt_churn": dict(ew.QUARTER["preempt_churn"], arm="full"),
}
_MIXED_RUNS = {
    "mixed_world": dict(mw.QUARTER["mixed_world"], n_workloads=600,
                        n_roots=8, max_cycles=6, arm="full"),
    "afs_serving": dict(mw.QUARTER["afs_serving"],
                        kw=dict(n_cohorts=10, cqs_per_cohort=5,
                                n_workloads=2_500), cycles=3, arm="full"),
}


@pytest.mark.parametrize("name", list(_ENGINE_RUNS))
def test_engine_worlds(jax_kit, name):
    want = ew.run(_ENGINE_RUNS[name], kit=jax_kit)
    got = ew.run(_ENGINE_RUNS[name], kit=ew.port_kit("cpu"))
    _same_runs(want, got, ew.PINNED)


@pytest.mark.parametrize("name", list(_MIXED_RUNS))
def test_mixed_worlds(jax_kit, name):
    want = mw.run(_MIXED_RUNS[name], kit=jax_kit)
    got = mw.run(_MIXED_RUNS[name], kit=ew.port_kit("cpu"))
    _same_runs(want, got, mw.PINNED)


@pytest.mark.parametrize("path", ["host", "device"])
def test_tas_churn_world(jax_kit, path):
    config = dict(tw.QUARTER["tas_churn"], fill_cycles=8, churn_cycles=4,
                  arm="full")
    want = tw.run(config, path, kit=jax_kit)
    got = tw.run(config, path, kit=ew.port_kit("cpu"))
    assert tw.pinned_numbers(got) == tw.pinned_numbers(want)
    assert got["pipeline"] == want["pipeline"]
    assert got["pipeline_stats"] == want["pipeline_stats"]
    assert want["pipeline_stats"]["speculated"] > 0


def test_pipeline_enabled_reads_the_environment(monkeypatch):
    from kueue_tpu.oracle import engine_bridge as jbridge

    for env, want in (({}, True), ({"KUEUE_TPU_PIPELINE": "0"}, False),
                      ({"KUEUE_TPU_PIPELINE_DEPTH": "0"}, False),
                      ({"KUEUE_TPU_PIPELINE_DEPTH": "x"}, True),
                      ({"KUEUE_TPU_PIPELINE_DEPTH": "3"}, True)):
        monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
        monkeypatch.delenv("KUEUE_TPU_PIPELINE_DEPTH", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert pbridge.pipeline_enabled() is want
        assert jbridge.pipeline_enabled() is want


def _faulty(executor, error, at):
    """Make the executor's cycle_step calls numbered in ``at`` (from 1)
    raise ``error()``."""
    inner = executor.cycle_step
    calls = [0]

    def cycle_step(*a, **kw):
        calls[0] += 1
        if calls[0] in at:
            raise error()
        return inner(*a, **kw)

    executor.cycle_step = cycle_step
    return calls


def test_speculative_fault_supervisor_sequence(pipelined, monkeypatch):
    """Transport failures in speculative dispatches (the second and third
    cycle_step calls are speculations): each surfaces at the next
    try_cycle as a ``remote-error`` host cycle, the retries and the
    breaker move one cycle earlier than on the serial loop, and both
    packages' supervisors, counters and decisions agree cycle by cycle."""
    from kueue_tpu.api.types import PodSet, Workload

    monkeypatch.setenv("KUEUE_TPU_ORACLE_RETRIES", "1")
    monkeypatch.setenv("KUEUE_TPU_ORACLE_BREAKER_N", "2")
    monkeypatch.setenv("KUEUE_TPU_ORACLE_BREAKER_COOLDOWN", "2")
    eng = test_hybrid_cycles.make_engine(
        oracle=True, n_cohorts=2, cqs_per_cohort=2, nominal=4000)
    assert isinstance(eng, PipelineMirroredEngine)
    for ex, err in ((eng.oracle.executor, jservice.RemoteOracleError),
                    (eng.port.oracle.executor, pservice.RemoteOracleError)):
        _faulty(ex, err, at={2, 3})
    for k in range(14):
        # A backlog beyond one admission per ClusterQueue a cycle, so
        # every device cycle speculates the next.
        for i in range(8 if k < 6 else 0):
            eng.clock += 0.01
            eng.submit(Workload(
                name=f"w{k}-{i}", queue_name=f"lq{i % 4}",
                pod_sets=(PodSet("main", 1, {"cpu": 300}),)))
        eng.schedule_once()
    b = eng.oracle
    assert b.fallback_reasons["remote-error"] == 2
    assert b.fallback_reasons["breaker-open"] >= 1
    assert b.supervisor.total_failures == 2
    assert b.supervisor.repromotions == 1
    assert b.pipeline_stats["speculated"] > 0


def test_speculative_remote_executor_error_leaves_schedule_once(
        monkeypatch):
    """An ``error`` reply from the sidecar to a speculative dispatch
    (``RemoteExecutorError``) is not a host cycle: it leaves the next
    schedule_once, and the supervisor counted the failure when it
    happened."""
    from kueue_tpu_torch.bench.scenario import baseline_like

    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    eng = ew.build_cycle_engine(
        baseline_like(n_cohorts=2, cqs_per_cohort=2, n_workloads=200),
        kit=ew.port_kit("cpu"))
    calls = _faulty(eng.oracle.executor,
                    lambda: pservice.RemoteExecutorError("device failure"),
                    at={2})
    r = eng.schedule_once()  # call 1, then the speculation (call 2)
    assert r is not None and r.stats.admitted
    assert calls[0] == 2 and eng.oracle._spec[0] == "error"
    assert eng.oracle.supervisor.total_failures == 1
    with pytest.raises(pservice.RemoteExecutorError, match="device failure"):
        eng.schedule_once()
    assert eng.oracle.fallback_reasons == {}
    assert eng.oracle.cycles_fallback == 0
    assert eng.oracle.pipeline_stats["speculated"] == 0
