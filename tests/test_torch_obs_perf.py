"""The port's perf telemetry (kueue_tpu_torch/obs/perf.py) and SLO engine
(obs/slo.py) against the JAX package's.

``tests/test_obs_perf.py``'s own cases run on ``ObsMirroredEngine``
(``test_torch_obs_trace``): the histogram cases against the port's
``PhaseHistogram``, the attribution, digest-neutrality, device-path,
Perfetto, SLO, debug-body and ``kueuectl slo`` cases on mirrored
engines whose tracers, perf recorders and SLO engines must then agree
(the same sub-phase names per mode and sample counts, the same device
counters; an SLO engine fed the same synthetic observations evaluates to
the same burn rates, and one fed real cycles to the same statuses and
fallback burn). ``kueuectl slo`` renders the JAX engine with the JAX
CLI and its twin with the port's: the same objectives, kinds, targets,
windows and cycles observed (burn rates read each engine's wall
durations). The ``tools/bench_sentinel`` cases are left out: the
sentinel is not part of the program.

Beyond that file: on a quarter-size ``cycle_latency`` world, on the
serial and the default loop, the port's committed launches, host-to-
device and device-to-host bytes and shape-signature hit/miss sequence
equal the JAX package's cycle by cycle (signatures themselves differ:
``str(torch.int64)`` is not ``str(int64)``), and ``heads.launches``
counts every dispatched call, speculations that were thrown away
included (ROADMAP trap (ar))."""

import json
import sys

import pytest

import test_obs_perf as ref
from kueue_tpu.cli.kueuectl import run as jrun
from kueue_tpu.obs import hooks as jhooks
from kueue_tpu.obs import perf as jperf
from kueue_tpu.visibility import server as jserver
from kueue_tpu_torch.cli.kueuectl import run as prun
from kueue_tpu_torch.metrics.registry import PERF_BUCKETS as P_BUCKETS
from kueue_tpu_torch.obs import hooks as phooks
from kueue_tpu_torch.obs import perf as pperf
from kueue_tpu_torch.obs.perf import PhaseHistogram as PHist
from kueue_tpu_torch.visibility import server as pserver
from test_torch_engine import _ENGINES
from test_torch_obs_trace import ObsMirroredEngine, masked_tree


class PerfMirroredEngine(ObsMirroredEngine):
    """ObsMirroredEngine whose SLO engines see the same synthetic
    observations, and are compared on detach of the test."""

    def attach_slo(self, **kw):
        slo = super().attach_slo(**kw)
        twin = self.port.slo
        if not getattr(slo, "_mirrored", False):
            inner = slo.observe_cycle

            def observe_both(duration_s, admitted, is_fallback):
                inner(duration_s, admitted, is_fallback)
                # A test's own observation goes to both; the JAX
                # engine's cycle listener feeds only its own.
                caller = sys._getframe(1).f_globals.get("__name__", "")
                if not caller.startswith("kueue_tpu."):
                    twin.observe_cycle(duration_s, admitted, is_fallback)

            slo.observe_cycle = observe_both
            slo._mirrored = True
        return slo

    def assert_same_world(self):
        super().assert_same_world()
        jslo, pslo = self.slo, self.port.slo
        assert (pslo is None) == (jslo is None)
        if jslo is None:
            return
        assert pslo.cycles_observed == jslo.cycles_observed
        want, got = jslo.evaluate(), pslo.evaluate()
        real = self.cycle_seq > 0
        for name, ev in want.items():
            if real and ev["kind"] != "fallback_ratio":
                # Fed real cycles: the burn reads each engine's own wall
                # durations, the statuses must agree.
                assert got[name]["statusName"] == ev["statusName"], name
            else:
                assert got[name] == ev, name


def mirrored_view(name):
    jfn, pfn = getattr(jserver, name), getattr(pserver, name)

    def view(engine):
        want = jfn(engine)
        port = getattr(engine, "port", None)
        if port is not None:
            got = pfn(port)
            if name == "trace_summary":
                got = dict(got, cycles=[masked_tree(c)
                                        for c in got["cycles"]])
                want_m = dict(want, cycles=[masked_tree(c)
                                            for c in want["cycles"]])
                assert got == want_m
            elif name == "perf_summary":
                assert set(got) == set(want)
                assert got.get("cyclesSeen") == want.get("cyclesSeen")
                assert {k: v["total"] for k, v in
                        got.get("subphases", {}).items()} == \
                    {k: v["total"] for k, v in
                     want.get("subphases", {}).items()}
            else:
                assert set(got) == set(want)
                if "objectives" in want:
                    assert {k: v["statusName"] for k, v in
                            got["objectives"].items()} == \
                        {k: v["statusName"] for k, v in
                         want["objectives"].items()}
        return want

    return view


def _slo_declared(text: str, as_json: bool):
    """What two ``kueuectl slo`` renderings of mirrored engines share:
    the objectives with their kinds and targets, the windows and the
    cycles observed (not the wall-clock burn rates)."""
    if as_json:
        doc = json.loads(text)
        return (doc["cyclesObserved"], doc["windows"],
                {k: (v["kind"], v["target"])
                 for k, v in doc["objectives"].items()})
    lines = text.splitlines()
    return lines[:3], [ln.split()[:3] for ln in lines[3:]]


def mirrored_kueuectl_run(engine, argv):
    """The JAX ``kueuectl run`` on ``engine``, held against the port's
    on its twin (``slo`` renderings compare by ``_slo_declared``)."""
    want = jrun(engine, argv)
    port = getattr(engine, "port", None)
    if port is not None:
        got = prun(port, argv)
        if argv[0] == "slo":
            as_json = "--json" in argv
            assert _slo_declared(got, as_json) == \
                _slo_declared(want, as_json)
        else:
            assert got == want
    return want


@pytest.fixture
def perf_mirrored(monkeypatch):
    import kueue_tpu.cli.kueuectl as jkueuectl

    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setattr(ref, "Engine", PerfMirroredEngine)
    monkeypatch.setattr(jkueuectl, "run", mirrored_kueuectl_run)
    for name in ("trace_summary", "perf_summary", "slo_summary"):
        monkeypatch.setattr(jserver, name, mirrored_view(name))
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


HISTOGRAM_CASES = ["test_fixed_log_spaced_edges",
                   "test_observation_order_does_not_matter",
                   "test_merge_equals_union_observation",
                   "test_quantile_bounds", "test_dict_roundtrip"]


@pytest.mark.parametrize("name", HISTOGRAM_CASES)
def test_reference_histogram_case_on_the_port(monkeypatch, name):
    monkeypatch.setattr(ref, "PhaseHistogram", PHist)
    monkeypatch.setattr(ref, "PERF_BUCKETS", P_BUCKETS)
    getattr(ref.TestPhaseHistogram(), name)()


def test_histograms_equal_the_jax_package_bit_for_bit():
    import random

    rng = random.Random(7)
    vals = [10.0 ** rng.uniform(-7, 1.5) for _ in range(500)]
    assert P_BUCKETS == ref.PERF_BUCKETS
    j, p = ref.PhaseHistogram(), PHist()
    for v in vals:
        j.observe(v)
        p.observe(v)
    assert p.to_dict() == j.to_dict()
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert p.quantile(q) == j.quantile(q)


REFERENCE_CASES = [
    ("TestApplyAttribution", "test_sequential_subphases"),
    ("TestApplyAttribution", "test_registry_histogram_renders"),
    ("TestApplyAttribution", "test_attach_is_idempotent_and_detach_clears"),
    ("TestDigestNeutrality", "test_instrumented_run_decides_identically"),
    ("TestDevicePath", "test_device_subphases_and_counters"),
    ("TestDevicePath", "test_jit_signature_cache_hits_on_stable_shapes"),
    ("TestPerfettoExport", "test_phase_and_subphase_spans_export"),
    ("TestPerfettoExport", "test_trace_schema_clean"),
    ("TestSLOBurnRates", "test_ok_warn_breach_progression"),
    ("TestSLOBurnRates", "test_single_slow_cycle_cannot_page"),
    ("TestSLOBurnRates", "test_rate_floor_burn"),
    ("TestSLOBurnRates", "test_fallback_ratio_burn"),
    ("TestSLOBurnRates", "test_gauges_exported"),
    ("TestSLOBurnRates", "test_engine_loop_feeds_observations"),
    ("TestQuerySurfaces", "test_trace_summary_rows_carry_cid"),
    ("TestQuerySurfaces", "test_perf_and_slo_debug_bodies"),
    ("TestQuerySurfaces", "test_sse_cycle_trace_carries_slo_posture"),
    ("TestQuerySurfaces", "test_fallback_reason_counters_surface"),
    ("TestQuerySurfaces", "test_kueuectl_slo_command"),
    ("TestQuerySurfaces", "test_kueuectl_slo_attaches_on_demand"),
]


@pytest.mark.parametrize("cls,name", REFERENCE_CASES,
                         ids=[f"{c}.{n}" for c, n in REFERENCE_CASES])
def test_reference_case_mirrored(perf_mirrored, cls, name, tmp_path):
    method = getattr(getattr(ref, cls)(), name)
    if "tmp_path" in method.__code__.co_varnames:
        method(tmp_path)
    else:
        method()


def test_port_sequential_subphases_carry_the_journal(tmp_path):
    """``test_sequential_subphases`` on the port alone, its journal the
    port's: with a journal the whole apply vocabulary reports."""
    from kueue_tpu_torch.obs.perf import APPLY_SUBPHASES
    from kueue_tpu_torch.store.journal import attach_new_journal
    from test_torch_obs_trace import _port_submit, _port_world

    eng = _port_world(nominal=5000)
    attach_new_journal(eng, str(tmp_path / "j.jsonl"))
    try:
        perf = eng.attach_perf()
        for i in range(6):
            _port_submit(eng, f"w{i}", 700)
        for _ in range(50):
            if eng.schedule_once() is None:
                break
        subs = perf.subphases(mode="sequential")
        assert {n for n in subs if n.startswith("apply.")} == \
            set(APPLY_SUBPHASES)
        assert APPLY_SUBPHASES == ref.APPLY_SUBPHASES
    finally:
        pperf.ACTIVE = None


# -- device counters on a quarter-size cycle_latency world --

LOOPS = {"serial": "serial", "default": "full"}


def _counter_run(kit, arm: str) -> dict:
    """The quarter cycle_latency world with perf recorded: per cycle the
    committed launches, h2d and d2h bytes, and (hits, misses) of the
    shape-signature cache; the sub-phase names per mode; the bridge's
    pipeline_stats."""
    from kueue_tpu_torch.bench import engine_worlds as ew

    cfg = ew.QUARTER["cycle_latency"]
    with ew.loop_arm(arm):
        scen = getattr(kit.scenario, cfg["scenario"])(**cfg["kw"])
        eng = ew.build_cycle_engine(scen, fair=cfg["fair"], kit=kit)
        perf = eng.attach_perf()
        seq, prev = [], {}
        for _ in range(cfg["cycles"] + 1):
            r = eng.schedule_once()
            now = {}
            for fam in ("perf_kernel_launches_total",
                        "perf_transfer_bytes_total",
                        "perf_jit_cache_events_total"):
                now.update({(fam,) + k: v for k, v in
                            eng.registry.counter(fam).values.items()})
            seq.append({k: v - prev.get(k, 0) for k, v in now.items()
                        if v != prev.get(k, 0)})
            prev = now
            if r is None or not r.stats.admitted:
                break
    out = {"per_cycle": seq,
           "subphases": sorted(perf.hist),
           "pipeline_stats": dict(eng.oracle.pipeline_stats),
           "on_device": eng.oracle.cycles_on_device}
    perf.detach()
    return out


@pytest.mark.parametrize("loop", list(LOOPS))
def test_device_counters_match_jax_on_quarter_cycle_latency(loop):
    from kueue_tpu.api import types as jtypes
    from kueue_tpu.bench import scenario as jscenario
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.ops import heads

    jkit = ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle())
    want = _counter_run(jkit, LOOPS[loop])
    before = heads.launches
    got = _counter_run(ew.port_kit("cpu"), LOOPS[loop])
    assert heads.launches == before  # the plain version runs on the CPU
    assert got == want
    launches = sum(v for c in got["per_cycle"] for k, v in c.items()
                   if k[0] == "perf_kernel_launches_total")
    ps = got["pipeline_stats"]
    # Committed calls: fresh device cycles plus used speculations; the
    # heads kernel on the card launches on every dispatched one, the
    # discarded speculations too (chip_smoke.dispatched).
    assert launches == got["on_device"]
    dispatched = got["on_device"] - ps["used"] + ps["speculated"]
    assert dispatched - launches == ps["speculated"] - ps["used"]
    assert launches > 0
