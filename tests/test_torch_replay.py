"""The port's flight recorder and replayer (kueue_tpu_torch/replay:
trace, recorder, replayer) against the JAX package's.

``tests/test_replay.py``'s 16 cases run on the port: that file's module
globals (its API types, ``Engine``, ``FlightRecorder``, ``replay_trace``,
``TraceReader``, ``TraceCorruption``) are pointed at the port's, with
the engines and replays on ``device="cpu"``, so its own code records,
tampers with, tears and replays port traces, host against device
included. Across the packages, on that file's world and churn, on the
preemption-churn world at QUARTER and on a small TAS world, each
recorded from an empty engine on the host path with the workload uid
counters aligned: the two recorders write equal frames once ``phases``
(wall timings) and ``crc`` (which chains over them) are masked; each
JAX trace replays byte-identical through the port's replayer in the
host and the device mode, and each port trace through the JAX replayer
in the host mode; the port's recording through its oracle writes the
inputs and decisions of the JAX host recording, with no nested call
recorded twice. A trace holding a frame of a method the port's engine
does not have yet raises, naming ROADMAP item 8. Exact throughout."""

import functools
import json

import pytest

import test_replay as ref
from kueue_tpu import replay as jreplay
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.replay import recorder as jrecorder
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch import replay as preplay
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import scenario as pscenario
from kueue_tpu_torch.bench import replay_world as rw
from kueue_tpu_torch.bench import tas_engine_worlds as tw
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.replay import recorder as precorder
from kueue_tpu_torch.tas import snapshot as psnapshot
from test_torch_journal import aligned_uids


def port_globals(mp) -> None:
    """Point ``test_replay``'s module globals at the port (``mp`` a
    MonkeyPatch): the API types it imported, the Engine on the CPU, the
    recorder, the replayer on the CPU, the reader, and the JAX
    ``apply_input`` that one case imports inside its body."""
    for name, obj in list(vars(ref).items()):
        if getattr(obj, "__module__", None) == "kueue_tpu.api.types":
            mp.setattr(ref, name, getattr(ptypes, name))
    mp.setattr(ref, "Engine", lambda: PEngine(device="cpu"))
    mp.setattr(ref, "FlightRecorder", preplay.FlightRecorder)
    mp.setattr(ref, "replay_trace",
               functools.partial(preplay.replay_trace, device="cpu"))
    mp.setattr(ref, "TraceReader", preplay.TraceReader)
    mp.setattr(ref, "TraceCorruption", preplay.TraceCorruption)
    mp.setattr(jrecorder, "apply_input", precorder.apply_input)


@pytest.fixture
def on_port(monkeypatch):
    port_globals(monkeypatch)


REFERENCE_CASES = [
    (None, "test_record_replay_byte_identical"),
    (None, "test_replay_twice_identical_digests"),
    (None, "test_replayed_world_matches_recording_engine"),
    (None, "test_phase_timings_captured"),
    (None, "test_tamper_raises_trace_corruption"),
    (None, "test_dropped_frame_raises_trace_corruption"),
    (None, "test_torn_tail_tolerated"),
    (None, "test_evict_recorded_by_key"),
    (None, "test_recorder_close_detaches"),
    (None, "test_internal_calls_not_double_recorded"),
    (None, "test_idle_cycles_coalesced"),
    (None, "test_bootstrap_from_populated_world"),
    (None, "test_trace_frames_are_canonical_json"),
    (None, "test_replay_rejects_unknown_mode"),
    ("TestDifferentialReplay", "test_host_vs_device_differential"),
    ("TestDifferentialReplay", "test_device_replay_of_device_recording"),
]


@pytest.mark.parametrize("cls,name", REFERENCE_CASES,
                         ids=[f"{c}.{n}" if c else n
                              for c, n in REFERENCE_CASES])
def test_reference_case_on_the_port(on_port, cls, name, tmp_path):
    fn = getattr(getattr(ref, cls)(), name) if cls else getattr(ref, name)
    fn(tmp_path)


# -- the same worlds recorded by both packages --

class Pkg:
    """One package's types, scenarios, engine (on the host path),
    recorder package and TAS snapshot module."""

    def __init__(self, name, t, scenario, engine, replay, tas):
        self.name, self.t, self.scenario = name, t, scenario
        self.engine, self.replay, self.tas = engine, replay, tas

    def kit(self, recorded_into=None) -> ew.Kit:
        """An engine_worlds Kit on the host path (``attach`` does
        nothing), its engines recorded into ``recorded_into[0]`` from
        creation on when given (the recorder in ``recorded_into[1]``)."""
        def engine(fair=False):
            eng = self.engine()
            if recorded_into is not None:
                recorded_into.append(self.replay.FlightRecorder(
                    eng, recorded_into[0], label="world"))
            return eng
        return ew.Kit(self.t, self.scenario, engine, lambda eng: None,
                      tas=self.tas, replay=self.replay)


JAX = Pkg("jax", jtypes, jscenario, JEngine, jreplay, jsnapshot)
PORT = Pkg("port", ptypes, pscenario, lambda: PEngine(device="cpu"),
           preplay, psnapshot)
PKGS = (JAX, PORT)


def _test_replay_world(pkg, path):
    """test_replay's _world and _churn, recorded from an empty engine."""
    with pytest.MonkeyPatch.context() as mp:
        if pkg is PORT:
            port_globals(mp)
        eng = ref.Engine()
        rec = pkg.replay.FlightRecorder(eng, path, label="world")
        ref._world(eng)
        ref._churn(eng)
        rec.close()


def _preempt_churn_world(pkg, path):
    """engine_worlds' preemption churn at QUARTER (10 ClusterQueues, the
    low-priority fill drained, then 100 high-priority arrivals drained),
    recorded from the engine's creation."""
    box = [path]
    cfg = ew.QUARTER["preempt_churn"]
    eng = ew.preempt_churn_engine(cfg["n_pending"],
                                  n_cohorts=cfg["n_cohorts"],
                                  kit=pkg.kit(box))
    ew._drain_engine(eng)
    box[1].close()


TAS_WORLD = dict(tw.FULL["tas"], dims=(2, 2, 4), n_cqs=2, n_wl=24)


def _tas_world(pkg, path):
    """A small TAS world (16 nodes, 24 gang workloads over the three
    topology modes) built and drained, recorded from the engine's
    creation."""
    box = [path]
    eng = tw.build(TAS_WORLD, kit=pkg.kit(box))
    for _ in range(40):
        if eng.schedule_once() is None:
            break
    box[1].close()


WORLDS = {"test_replay": _test_replay_world,
          "preempt_churn": _preempt_churn_world, "tas": _tas_world}


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{(world, package): trace path}: every world recorded by both
    packages under aligned uids."""
    d = tmp_path_factory.mktemp("traces")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # TAS placements on the host descent in both packages (no
        # crossover record read).
        mp.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "1000000")
        for world, build in WORLDS.items():
            for pkg in PKGS:
                path = str(d / f"{world}-{pkg.name}.jsonl")
                with aligned_uids():
                    build(pkg, path)
                out[world, pkg.name] = path
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_recorders_write_equal_frames(traces, world):
    want = rw.masked_frames(traces[world, "jax"])
    got = rw.masked_frames(traces[world, "port"])
    assert len(got) == len(want)
    assert got == want
    kinds = {f["f"] for f in got}
    assert {"header", "input", "cycle", "end"} <= kinds
    assert any(f["f"] == "cycle" and f["decisions"] for f in got)
    assert rw.masked_checksum(traces[world, "port"]) == \
        rw.masked_checksum(traces[world, "jax"])


# The JAX replayer's device-mode replay of the JAX host recording of a
# world, where it does not reproduce the recording: the preemption churn
# picks other victims on the device path from cycle 8 on (a reference
# behaviour, ROADMAP Queue 3). The port's must diverge at the same
# cycles to the same replayed digest; the slow test recomputes these
# from the JAX package.
JAX_DEVICE_DIVERGES = {
    "preempt_churn": dict(seqs=list(range(8, 18)),
                          replayed_digest="89993fd5"),
}


def divergence(report) -> dict:
    assert {m.kind for m in report.mismatches} == {"decisions"}
    return dict(seqs=[m.seq for m in report.mismatches],
                replayed_digest=report.replayed_digest)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("mode", ["host", "device"])
def test_jax_traces_replay_through_the_port(traces, world, mode):
    engines = []

    def engine():
        engines.append(PEngine(device="cpu"))
        return engines[-1]

    report = preplay.replay_trace(traces[world, "jax"], mode,
                                  engine_factory=engine)
    assert report.cycles > 0 and not report.truncated
    if mode == "device":
        b = engines[0].oracle
        assert b.cycles_on_device + b.cycles_hybrid > 0
        if world in JAX_DEVICE_DIVERGES:
            assert divergence(report) == JAX_DEVICE_DIVERGES[world]
            return
    assert report.ok, report.render()


@pytest.mark.slow
def test_jax_device_divergence_constants(traces):
    for world, want in JAX_DEVICE_DIVERGES.items():
        report = jreplay.replay_trace(traces[world, "jax"], "device")
        assert divergence(report) == want


@pytest.mark.parametrize("world", list(WORLDS))
def test_port_traces_replay_through_jax(traces, world):
    report = jreplay.replay_trace(traces[world, "port"], "host")
    assert report.ok, report.render()
    assert report.cycles > 0 and not report.truncated


def test_device_recording_replays_on_the_device(tmp_path):
    """The preemption churn recorded through the port's oracle on the
    default loop (the columnar apply's evictions and bulk_assume_batch
    run inside the cycle) holds no evict frame, and replays
    byte-identical on the device path: no nested call was recorded, so
    none is applied twice."""
    path = str(tmp_path / "device.jsonl")
    box = [path]
    kit = PORT.kit(box)
    kit.attach = lambda eng: eng.attach_oracle()
    cfg = ew.QUARTER["preempt_churn"]
    with ew.loop_arm("full"):
        eng = ew.preempt_churn_engine(cfg["n_pending"],
                                      n_cohorts=cfg["n_cohorts"], kit=kit)
        ew._drain_engine(eng)
        box[1].close()
        frames = rw.masked_frames(path)
        assert eng.metrics.preemptions_total > 0
        assert {f["mode"] for f in frames if f["f"] == "cycle"} & \
            {"device", "hybrid"}
        assert not [f for f in frames if f["f"] == "input"
                    and f["method"] in ("evict", "finish")]
        report = preplay.replay_trace(path, "device", device="cpu")
    assert report.ok, report.render()
    assert report.preempting > 0


def test_item8_frame_raises(tmp_path):
    """A trace with a LimitRange frame (the JAX recorder writes one for
    ``create_limit_range``) raises in the port's replay, naming ROADMAP
    item 8, and is never skipped."""
    path = str(tmp_path / "t.jsonl")
    w = preplay.TraceWriter(path)
    w.input(0.0, "create_resource_flavor",
            [{"__t__": "ResourceFlavor", "name": "default"}], {})
    w.input(0.0, "create_limit_range", [{"namespace": "default"}], {})
    w.close()
    with pytest.raises(NotImplementedError, match="item 8"):
        preplay.replay_trace(path, device="cpu")
    for name in precorder.NOT_PORTED_METHODS:
        assert name in precorder.RECORDED_METHODS
        assert not hasattr(PEngine, name)
    assert json.dumps(precorder.RECORDED_METHODS) == \
        json.dumps(jrecorder.RECORDED_METHODS)
