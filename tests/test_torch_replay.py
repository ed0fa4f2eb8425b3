"""The port's flight recorder and replayer (kueue_tpu_torch/replay:
trace, recorder, replayer) against the JAX package's.

``tests/test_replay.py``'s 16 cases run on the port: that file's module
globals (its API types, ``Engine``, ``FlightRecorder``, ``replay_trace``,
``TraceReader``, ``TraceCorruption``) are pointed at the port's, with
the engines and replays on ``device="cpu"``, so its own code records,
tampers with, tears and replays port traces, host against device
included. Across the packages, on that file's world and churn, on the
preemption-churn world at QUARTER, on a small TAS world and on a small
world of templated workloads under a LimitRange and a RuntimeClass with
a hold and its clearing, each recorded from an empty engine on the host
path with the workload uid counters aligned: the two recorders write
equal frames once ``phases`` (wall timings) and ``crc`` (which chains
over them) are masked; each JAX trace replays byte-identical through the
port's replayer in the host and the device mode, and each port trace
through the JAX replayer in the host mode; the port's recording through
its oracle writes the inputs and decisions of the JAX host recording,
with no nested call recorded twice. The recorders wrap every method of
the JAX recorder's list, ``create_limit_range``,
``create_runtime_class``, ``hold_workload`` and ``clear_hold`` included.
Exact throughout."""

import functools
import json

import pytest

import test_replay as ref
from kueue_tpu import replay as jreplay
from kueue_tpu.api import serde as jserde
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.replay import recorder as jrecorder
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu.utils import limitrange as jlimitrange
from kueue_tpu.utils import podtemplate as jpodtemplate
from kueue_tpu_torch import replay as preplay
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import scenario as pscenario
from kueue_tpu_torch.bench import replay_world as rw
from kueue_tpu_torch.bench import tas_engine_worlds as tw
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.replay import recorder as precorder
from kueue_tpu_torch.tas import snapshot as psnapshot
from kueue_tpu_torch.utils import limitrange as plimitrange
from kueue_tpu_torch.utils import podtemplate as ppodtemplate
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
    recorder package, TAS snapshot module, and pod template and
    LimitRange modules."""

    def __init__(self, name, t, scenario, engine, replay, tas, pt, lr):
        self.name, self.t, self.scenario = name, t, scenario
        self.engine, self.replay, self.tas = engine, replay, tas
        self.pt, self.lr = pt, lr

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


JAX = Pkg("jax", jtypes, jscenario, JEngine, jreplay, jsnapshot,
          jpodtemplate, jlimitrange)
PORT = Pkg("port", ptypes, pscenario, lambda: PEngine(device="cpu"),
           preplay, psnapshot, ppodtemplate, plimitrange)
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


def _jobs_world(pkg, path):
    """Templated workloads under a LimitRange and a RuntimeClass (one of
    them above the LimitRange's maximum, so inadmissible), a workload
    held and its hold cleared, and a finish, recorded from an empty
    engine."""
    t, pt, lr = pkg.t, pkg.pt, pkg.lr
    eng = pkg.engine()
    rec = pkg.replay.FlightRecorder(eng, path, label="jobs")
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=(t.ResourceGroup(("cpu",), (
            t.FlavorQuotas("default", {"cpu": t.ResourceQuota(4000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
    eng.create_limit_range(lr.LimitRange("d", limits=(lr.LimitRangeItem(
        lr.LIMIT_TYPE_CONTAINER, max={"cpu": 3000},
        default_request={"cpu": 100}),)))
    eng.create_runtime_class("kata", {"cpu": 50})
    for i, cpu in enumerate((400, 800, 1200, 3500, 1600, 2000)):
        eng.clock += 1
        eng.submit(t.Workload(name=f"w{i}", queue_name="lq", pod_sets=(
            t.PodSet("main", 1, template=pt.PodTemplate(
                containers=[pt.ContainerSpec("a", {"cpu": cpu}),
                            pt.ContainerSpec("b")],
                runtime_class_name="kata" if i % 2 else None)),)))
    eng.schedule_once()
    eng.clock += 1
    eng.hold_workload("default/w0", "scaled to zero")
    eng.schedule_once()
    eng.clock += 1
    eng.clear_hold("default/w0")
    eng.finish("default/w1")
    for _ in range(6):
        eng.clock += 1
        if eng.schedule_once() is None:
            break
    rec.close()


WORLDS = {"test_replay": _test_replay_world,
          "preempt_churn": _preempt_churn_world, "tas": _tas_world,
          "jobs": _jobs_world}


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


@pytest.fixture
def jax_reads_limit_ranges(monkeypatch):
    """The JAX package's codec does not register LimitRange (its journal
    never writes one), so its replayer cannot decode a recorded
    ``create_limit_range``: the two types are put in its registry for
    the test."""
    if not jserde._REGISTRY:
        jserde._auto_register()
    for cls in (jlimitrange.LimitRange, jlimitrange.LimitRangeItem):
        monkeypatch.setitem(jserde._REGISTRY, cls.__name__, cls)


@pytest.mark.parametrize("world", list(WORLDS))
def test_port_traces_replay_through_jax(traces, world,
                                        jax_reads_limit_ranges):
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


def test_item8_frame_raises(traces, jax_reads_limit_ranges):
    """The four methods the port's engine took last (ROADMAP item 8:
    ``create_limit_range``, ``create_runtime_class``, ``hold_workload``,
    ``clear_hold``) are recorded by both packages' recorders and
    replayed, not raised on: the jobs world's traces hold a frame of
    each, and each package's trace replays through both replayers in
    the host mode to one digest, with the hold's and the LimitRange's
    effects (OnHold, HoldCleared, Inadmissible) in the replayed
    engine."""
    four = ("create_limit_range", "create_runtime_class", "hold_workload",
            "clear_hold")
    assert json.dumps(precorder.RECORDED_METHODS) == \
        json.dumps(jrecorder.RECORDED_METHODS)
    for name in four:
        assert name in precorder.RECORDED_METHODS
        assert callable(getattr(PEngine, name))
    digests = set()
    for pkg in PKGS:
        path = traces["jobs", pkg.name]
        methods = {f["method"] for f in rw.masked_frames(path)
                   if f["f"] == "input"}
        assert set(four) <= methods
        engines = []

        def engine():
            engines.append(PEngine(device="cpu"))
            return engines[-1]

        port = preplay.replay_trace(path, "host", engine_factory=engine)
        jax = jreplay.replay_trace(path, "host")
        assert port.ok and jax.ok, port.render() + jax.render()
        digests |= {port.replayed_digest, jax.replayed_digest}
        kinds = {e.kind for e in engines[0].events}
        assert {"OnHold", "HoldCleared", "Inadmissible"} <= kinds
    assert len(digests) == 1
