"""The port's admission tracer (kueue_tpu_torch/obs: span trees,
rationale hooks, correlation ids, the Perfetto export, explain) against
the JAX package's.

``ObsMirroredEngine`` is ``test_torch_engine.MirroredEngine`` that also
mirrors ``attach_tracer``, ``attach_perf`` and ``attach_slo``; patched
in as ``tests/test_obs_trace.py``'s ``Engine`` it runs that file's own
cases, and after each one the two tracers must hold the same span trees
node by node, the same cids, ``trace_cycles_total`` and
``trace_workload_decisions_total``, and the two engines the same events.
The only fields masked are wall time: a span's ``ts``/``dur`` and its
phase ``seconds``, and a ``cycle_trace`` event's ``dur_ms=`` and
``slo=`` (the SLO posture reads cycle wall durations). Beyond that
file: the tracer on mirrored serving worlds on the serial and the
default loop and on a TAS world under both path pins, traced runs
against untraced ones in both packages (decision streams, ``dump_state``
and journal bytes), the live Perfetto export and explain on a rebuilt
engine. Its flight-recorder cases run with the port's recorder beside
the JAX one on each mirrored engine: the two traces hold equal frames
(``phases`` and ``crc`` masked), and ``spans_from_flight_trace`` of the
port gives the JAX package's spans of the same trace."""

import json
import re

import pytest

import test_obs_trace as ref
from kueue_tpu.obs import explain_workload as jexplain
from kueue_tpu.obs import hooks as jhooks
from kueue_tpu.obs import perf as jperf
from kueue_tpu.obs import render_explain as jrender
from kueue_tpu import obs as jobs
from kueue_tpu.obs import spans_from_flight_trace as jspans_from_flight_trace
from kueue_tpu.obs import to_perfetto as jto_perfetto
from kueue_tpu.replay import recorder as jrecorder
from kueue_tpu_torch.obs import explain_workload as pexplain
from kueue_tpu_torch.obs import hooks as phooks
from kueue_tpu_torch.obs import perf as pperf
from kueue_tpu_torch.obs import render_explain as prender
from kueue_tpu_torch.obs import spans_from_flight_trace as \
    pspans_from_flight_trace
from kueue_tpu_torch.obs import to_perfetto as pto_perfetto
from kueue_tpu_torch.bench.replay_world import masked_frames
from kueue_tpu_torch.replay import recorder as precorder
from test_torch_engine import _ENGINES, MirroredEngine

_WALL = re.compile(r" dur_ms=[0-9.]+| slo=\S+")


def masked_tree(node: dict) -> dict:
    """A span tree's dict without its wall-time fields."""
    attrs = {k: v for k, v in node["attrs"].items() if k != "seconds"}
    return {"name": node["name"], "kind": node["kind"], "attrs": attrs,
            "cid": node.get("cid"),
            "children": [masked_tree(c) for c in node["children"]]}


def masked_events(events) -> list:
    return [(e.time, e.kind, e.workload, e.cluster_queue,
             _WALL.sub("", e.detail)) for e in events]


def counter_values(eng, family: str) -> dict:
    return dict(eng.registry.counter(family).values)


def assert_same_tracers(jt, pt) -> None:
    """Two tracers over mirrored runs: equal trees but for wall time."""
    assert (pt is None) == (jt is None)
    if jt is None:
        return
    assert pt.cycles_traced == jt.cycles_traced
    assert pt.last_cid == jt.last_cid
    assert [masked_tree(t) for t in pt.trees()] == \
        [masked_tree(t) for t in jt.trees()]


def assert_same_perf(jp, pp) -> None:
    """Two perf recorders: the same sub-phase names per mode and the same
    sample counts."""
    assert (pp is None) == (jp is None)
    if jp is None:
        return
    assert pp.cycles_seen == jp.cycles_seen
    assert {k: h.total for k, h in pp.hist.items()} == \
        {k: h.total for k, h in jp.hist.items()}


class ObsMirroredEngine(MirroredEngine):
    """A MirroredEngine whose obs attachments are made on both engines."""

    @staticmethod
    def _twin(obj, twin):
        """``obj`` (a JAX obs attachment) whose detach detaches ``twin``
        (the port's) too."""
        if obj.detach.__name__ != "detach_both":
            inner = obj.detach

            def detach_both():
                inner()
                twin.detach()

            obj.detach = detach_both
        return obj

    def attach_journal(self, journal, record_existing=True):
        """A test's journal on the JAX engine, and the port's own beside
        it (``<path>.port``), so both record the same transitions."""
        from kueue_tpu_torch.store.journal import Journal

        super().attach_journal(journal, record_existing=record_existing)
        self.port.attach_journal(Journal(journal.path + ".port"),
                                 record_existing=record_existing)

    def attach_tracer(self, retain=64, **kw):
        tracer = super().attach_tracer(retain=retain, **kw)
        return self._twin(tracer,
                          self.port.attach_tracer(retain=retain, **kw))

    def attach_perf(self):
        return self._twin(super().attach_perf(), self.port.attach_perf())

    def attach_slo(self, **kw):
        return self._twin(super().attach_slo(**kw),
                          self.port.attach_slo(**kw))

    def assert_same_world(self):
        real = (self.events, self.port.events)
        keep = ("Inadmissible", "OnHold", "HoldCleared")
        assert masked_events(self.port.events) == masked_events(
            e for e in self.events if e.kind not in keep)
        # The event details compared above; the rest of the world as
        # MirroredEngine holds it, without the wall-time fields.
        self.events, self.port.events = [], []
        try:
            super().assert_same_world()
        finally:
            self.events, self.port.events = real
        assert_same_tracers(self.tracer, self.port.tracer)
        assert_same_perf(self.perf, self.port.perf)
        for fam in ("trace_cycles_total", "trace_workload_decisions_total",
                    "perf_kernel_launches_total",
                    "perf_transfer_bytes_total",
                    "perf_jit_cache_events_total"):
            assert counter_values(self.port, fam) == \
                counter_values(self, fam), fam


def mirrored_explain(engine, key, probe=True, now=None):
    """The JAX package's explain, held against the port's on the port
    twin of a mirrored engine."""
    want = jexplain(engine, key, probe=probe, now=now)
    port = getattr(engine, "port", None)
    if port is not None:
        got = pexplain(port, key, probe=probe, now=now)
        assert got == want
        assert prender(got) == jrender(want)
    return want


@pytest.fixture
def obs_mirrored(monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setattr(ref, "Engine", ObsMirroredEngine)
    monkeypatch.setattr(ref, "explain_workload", mirrored_explain)
    _ENGINES.clear()
    yield
    try:
        assert _ENGINES, "no mirrored engine was built"
        for eng in _ENGINES:
            eng.assert_same_world()
    finally:
        _ENGINES.clear()
        jperf.ACTIVE = pperf.ACTIVE = None
        jhooks.CURRENT = phooks.CURRENT = None


REFERENCE_CASES = [
    ("TestSpanTrees", "test_cycle_span_tree_shape"),
    ("TestSpanTrees", "test_admitted_span_carries_flavors"),
    ("TestSpanTrees", "test_rejected_span_carries_reasons"),
    ("TestSpanTrees", "test_preemption_rationale"),
    ("TestSpanTrees", "test_trace_metrics_and_sse_summary"),
    ("TestSpanTrees", "test_retention_ring_bounded"),
    ("TestSpanTrees", "test_attach_is_idempotent_and_detach_clean"),
    ("TestPerfettoExport", "test_live_export_validates"),
    ("TestExplain", "test_pending_probe_reports_rejection"),
    ("TestExplain", "test_preemption_probe_names_victims"),
    ("TestExplain", "test_trace_section_present_with_tracer"),
    ("TestExplain", "test_admitted_and_missing"),
    ("TestOracleBridgePath", "test_device_cycle_span_and_explain"),
]


@pytest.mark.parametrize("cls,name", REFERENCE_CASES,
                         ids=[f"{c}.{n}" for c, n in REFERENCE_CASES])
def test_reference_case_mirrored(obs_mirrored, cls, name, tmp_path):
    method = getattr(getattr(ref, cls)(), name)
    if "tmp_path" in method.__code__.co_varnames:
        method(tmp_path)
    else:
        method()


def _port_world(preemption=False, nominal=1000):
    from kueue_tpu_torch.api import types as t
    from kueue_tpu_torch.controllers.engine import Engine

    eng = Engine(device="cpu")
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq",
        preemption=(t.ClusterQueuePreemption(
            within_cluster_queue=t.PreemptionPolicy.LOWER_PRIORITY)
            if preemption else t.ClusterQueuePreemption()),
        resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(nominal)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
    return eng


def _port_submit(eng, name, cpu, priority=0):
    from kueue_tpu_torch.api import types as t

    eng.clock += 0.5
    eng.submit(t.Workload(name=name, queue_name="lq", priority=priority,
                          pod_sets=(t.PodSet("main", 1, {"cpu": cpu}),)))


def test_explain_on_journal_rebuilt_engines(tmp_path):
    """``TestExplain.test_explain_on_journal_rebuilt_engine`` in each
    package: each rebuilds its own journal of the same run, and the two
    reports (the rebuild stamp's wall fields aside) are equal."""
    from kueue_tpu.store import journal as jj
    from kueue_tpu_torch.store import journal as pj
    from test_torch_journal import aligned_uids

    reports = []
    with aligned_uids():
        for pkg in ("jax", "port"):
            path = str(tmp_path / f"{pkg}.jsonl")
            if pkg == "jax":
                eng = ref.make_engine()
                jj.attach_new_journal(eng, path)
                ref.submit(eng, "ok", 600)
                ref.submit(eng, "big", 5000)
                ref.drain(eng)
                reb = jj.rebuild_engine(path)
                report = jexplain(reb, "default/big")
            else:
                eng = _port_world()
                pj.attach_new_journal(eng, path)
                _port_submit(eng, "ok", 600)
                _port_submit(eng, "big", 5000)
                for _ in range(50):
                    if eng.schedule_once() is None:
                        break
                reb = pj.rebuild_engine(path, device="cpu")
                report = pexplain(reb, "default/big")
            assert report["probe"]["verdict"] == "no-fit"
            before = {k: w.is_admitted for k, w in reb.workloads.items()}
            for _ in range(50):
                if reb.schedule_once() is None:
                    break
            assert {k: w.is_admitted
                    for k, w in reb.workloads.items()} == before
            rb = report.pop("rebuild")
            assert set(rb) == {"position", "wall", "staleness_s"}
            reports.append((report, rb["position"]))
    assert reports[1] == reports[0]


class MirroredFlightRecorder(jrecorder.FlightRecorder):
    """The JAX package's FlightRecorder, with the port's beside it on a
    mirrored engine's port twin (``<path>.port``); closing both, the two
    traces must hold equal frames once ``phases`` and ``crc`` are
    masked."""

    def __init__(self, engine, path, label="", bootstrap=False, **kw):
        super().__init__(engine, path, label=label, bootstrap=bootstrap,
                         **kw)
        self.twin = precorder.FlightRecorder(
            engine.port, path + ".port", label=label, bootstrap=bootstrap,
            **kw)

    def close(self):
        super().close()
        self.twin.close()
        assert self.twin.digest == self.digest
        assert masked_frames(self.twin.writer.path) == \
            masked_frames(self.writer.path)


def mirrored_spans_from_flight_trace(path):
    """The JAX package's offline export, held against the port's of the
    same trace and of the port's own trace beside it."""
    want = [r.to_dict() for r in jspans_from_flight_trace(path)]
    for p in (path, path + ".port"):
        got = [r.to_dict() for r in pspans_from_flight_trace(p)]
        assert [masked_tree(t) for t in got] == \
            [masked_tree(t) for t in want]
    assert [r.to_dict() for r in pspans_from_flight_trace(path)] == want
    return jspans_from_flight_trace(path)


@pytest.fixture
def recorded_mirrored(obs_mirrored, monkeypatch):
    monkeypatch.setattr(jrecorder, "FlightRecorder", MirroredFlightRecorder)
    monkeypatch.setattr(jobs, "spans_from_flight_trace",
                        mirrored_spans_from_flight_trace)


FLIGHT_CASES = [
    ("TestCorrelation", "test_cid_joins_flight_trace_and_journal"),
    ("TestCorrelation", "test_traced_run_digest_identical_to_untraced"),
    ("TestPerfettoExport", "test_offline_export_from_flight_trace"),
]


@pytest.mark.parametrize("cls,name", FLIGHT_CASES,
                         ids=[f"{c}.{n}" for c, n in FLIGHT_CASES])
def test_flight_recorder_case_mirrored(recorded_mirrored, cls, name,
                                       tmp_path):
    """The reference's flight-recorder cases, the port's recorder beside
    the JAX one on every mirrored engine (frames equal, masked) and the
    port's offline Perfetto export beside the JAX one (spans equal)."""
    getattr(getattr(ref, cls)(), name)(tmp_path)


def test_live_perfetto_documents_match(obs_mirrored):
    """``to_perfetto`` of the two tracers' spans: the same events in the
    same order, ``ts``/``dur`` and phase ``seconds`` aside."""
    eng = ref.make_engine(preemption=True)
    eng.attach_oracle()
    tracer = eng.attach_tracer()
    eng.attach_perf()
    ref.submit(eng, "low", 800)
    ref.drain(eng)
    ref.submit(eng, "high", 800, priority=10)
    ref.drain(eng)

    def masked(doc):
        out = []
        for ev in doc["traceEvents"]:
            ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
            if isinstance(ev.get("args"), dict):
                ev["args"] = {k: v for k, v in ev["args"].items()
                              if k != "seconds"}
            out.append(ev)
        return json.loads(json.dumps(out, default=str))

    want = jto_perfetto(list(tracer.spans))
    got = pto_perfetto(list(eng.port.tracer.spans))
    assert masked(got) == masked(want)
    assert {e["ph"] for e in got["traceEvents"]} == {"M", "X", "i"}


# -- the tracer on mirrored worlds: both loops, both TAS path pins --

class TracedMirroredEngine(ObsMirroredEngine):
    """An ObsMirroredEngine traced and perf-recorded from its birth."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.attach_tracer(retain=256)
        self.attach_perf()


LOOPS = {"serial": "0", "default": "1"}


@pytest.fixture(params=list(LOOPS))
def traced_worlds(request, monkeypatch):
    import test_hybrid_cycles
    import test_oracle_engine

    monkeypatch.setenv("KUEUE_TPU_PIPELINE", LOOPS[request.param])
    for mod in (test_oracle_engine, test_hybrid_cycles):
        monkeypatch.setattr(mod, "Engine", TracedMirroredEngine)
    _ENGINES.clear()
    yield (test_oracle_engine, test_hybrid_cycles)
    try:
        assert _ENGINES, "no mirrored engine was built"
        for eng in _ENGINES:
            assert eng.tracer.cycles_traced > 0
            eng.assert_same_world()
    finally:
        _ENGINES.clear()
        jperf.ACTIVE = pperf.ACTIVE = None
        jhooks.CURRENT = phooks.CURRENT = None


@pytest.mark.parametrize("mod,name", [
    (0, "test_oracle_engine_matches_sequential_outcomes"),
    (0, "test_oracle_handles_within_cq_preemption_on_device"),
    (1, "test_mixed_preemption_scopes_hybrid"),
    (1, "test_multi_podset_heads_stay_on_device")])
def test_traced_serving_worlds(traced_worlds, mod, name):
    getattr(traced_worlds[mod], name)()


TAS_PATHS = {"host": "1000000", "device": "0"}


@pytest.mark.parametrize("path", list(TAS_PATHS))
@pytest.mark.parametrize("name", [
    "test_tas_admission_with_assignment",
    "test_tas_quota_fits_but_placement_fragmented"])
def test_traced_tas_worlds(monkeypatch, tmp_path, path, name):
    """The TAS rationale (``tas`` events) and spans under both pins."""
    import test_tas_integration as ti

    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", TAS_PATHS[path])
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    monkeypatch.setattr(ti, "Engine", TracedMirroredEngine)
    _ENGINES.clear()
    try:
        getattr(ti, name)()
        assert _ENGINES
        for eng in _ENGINES:
            eng.assert_same_world()
        kinds = {r["kind"] for eng in _ENGINES
                 for root in eng.port.tracer.spans
                 for s in root.children
                 for r in s.attrs.get("rationale", ())}
        assert "tas" in kinds
    finally:
        _ENGINES.clear()
        jperf.ACTIVE = pperf.ACTIVE = None
        jhooks.CURRENT = phooks.CURRENT = None


# -- digest neutrality: traced against untraced, in both packages --

def _serve_world_run(kit, jmod, path, obs: bool) -> tuple:
    """The serve world's small config with every arrival, journaled to
    ``path``, drained; traced, perf-recorded and SLO-watched when
    ``obs``. Returns (decision streams per cycle, dump_state, engine)."""
    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.bench import serve_world as sw

    eng = sw.build_world(sw.SMALL, kit)
    jmod.attach_new_journal(eng, path)
    kit.attach(eng)
    if obs:
        eng.attach_tracer(retain=16)
        eng.attach_perf()
        eng.attach_slo()
    for wl in sw.arrivals(sw.SMALL, kit):
        eng.submit(wl)
    streams = []
    for _ in range(10_000):
        r = eng.schedule_once()
        streams.append(ew.decision_stream(r))
        if r is None:
            break
    eng.journal.close()
    return streams, eng


@pytest.mark.parametrize("loop", list(LOOPS))
def test_traced_runs_decide_and_journal_as_untraced(monkeypatch, tmp_path,
                                                    loop):
    """A traced, perf-recorded, SLO-watched run gives the decisions,
    ``dump_state`` and journal (less its ``cycle_trace`` records) of an
    untraced one, in each package; and the two packages' traced journals
    are byte-identical, ``cycle_trace`` records included."""
    from kueue_tpu.api import types as jtypes
    from kueue_tpu.bench import scenario as jscenario
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu.store import journal as jj
    from kueue_tpu.visibility import server as jvis
    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.store import journal as pj
    from kueue_tpu_torch.visibility import server as pvis
    from test_torch_journal import aligned_uids, comparable

    monkeypatch.setenv("KUEUE_TPU_PIPELINE", LOOPS[loop])
    jkit = ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle())
    pkit = ew.port_kit("cpu")
    runs = {}
    try:
        for pkg, kit, jmod, vis in (("jax", jkit, jj, jvis),
                                    ("port", pkit, pj, pvis)):
            for obs in (False, True):
                path = str(tmp_path / f"{pkg}-{obs}.jsonl")
                with aligned_uids():
                    streams, eng = _serve_world_run(kit, jmod, path, obs)
                with open(path, "rb") as fh:
                    raw = fh.read()
                runs[pkg, obs] = (streams, comparable(vis.dump_state(eng)),
                                  raw, eng)
                jperf.ACTIVE = pperf.ACTIVE = None
    finally:
        jhooks.CURRENT = phooks.CURRENT = None

    def without_traces(raw: bytes) -> bytes:
        return b"".join(line for line in raw.splitlines(keepends=True)
                        if b'"cycle_trace"' not in line)

    for pkg in ("jax", "port"):
        bare, traced = runs[pkg, False], runs[pkg, True]
        assert traced[0] == bare[0]
        assert traced[1] == bare[1]
        assert b'"cycle_trace"' in traced[2]
        assert without_traces(traced[2]) == bare[2]
    assert runs["port", True][2] == runs["jax", True][2]
    assert runs["port", False][1] == runs["jax", False][1]
    jt, pt = runs["jax", True][3].tracer, runs["port", True][3].tracer
    assert_same_tracers(jt, pt)
    assert_same_perf(runs["jax", True][3].perf, runs["port", True][3].perf)
