"""The port's metrics registry (kueue_tpu_torch/metrics/registry.py), its
unadmitted-workload gauges (kueue_tpu_torch/cache/unadmitted.py) and the
engine's writes to them, against the JAX package's.

The registry's unit cases of tests/test_metrics_endpoint.py run on the
port's ``MetricsRegistry``, ``_esc`` and ``_fmt``. The engine cases of
tests/test_observability.py and the oracle worlds of
tests/test_oracle_engine.py run through ``MetricsMirroredEngine``: a
``MirroredEngine`` (tests/test_torch_engine.py) whose two engines read
one fixed-step wall clock each, and whose registries must render the
same exposition, byte for byte, after every cycle and at the end (after
``sync_resource_metrics`` on both). The one exception is the
``scheduler_phase_duration_seconds`` family once a bridge is attached:
the bridge times its phases on ``time.perf_counter`` in both packages,
so there only the ``_count`` lines are compared."""

import numpy as np
import pytest

import test_metrics_endpoint as tme
import test_observability as tob
import test_oracle_engine
from kueue_tpu.metrics import registry as jreg
from kueue_tpu_torch import carry
from kueue_tpu_torch.cache import unadmitted as punadmitted
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.metrics import registry as preg
from test_torch_engine import _ENGINES, MirroredEngine

_PHASES = "kueue_tpu_scheduler_phase_duration_seconds"


def step_clock(step=0.00125):
    """A wall clock that moves ``step`` seconds at every read."""
    t = [0.0]

    def read():
        t[0] += step
        return t[0]

    return read


def comparable(text: str, timed_phases: bool) -> list:
    lines = text.split("\n")
    if timed_phases:
        lines = [ln for ln in lines
                 if not ln.startswith((_PHASES + "_bucket",
                                       _PHASES + "_sum"))]
    return lines


class MetricsMirroredEngine(MirroredEngine):
    """A MirroredEngine whose registries must render alike."""

    def __init__(self, enable_fair_sharing=False, config=None, **kw):
        super().__init__(enable_fair_sharing=enable_fair_sharing,
                         config=config, **kw)
        if config is not None:
            self.port = PEngine(enable_fair_sharing=enable_fair_sharing,
                                device="cpu",
                                config=carry.configuration(config))
        self.wall_clock = step_clock()
        self.port.wall_clock = step_clock()

    def assert_same_metrics(self, where=""):
        timed = self.oracle is not None
        assert comparable(self.port.registry.render(), timed) == \
            comparable(self.registry.render(), timed), where
        assert self.port.unadmitted.per_cq == self.unadmitted.per_cq
        assert self.port.unadmitted.per_lq == self.unadmitted.per_lq

    def schedule_once(self):
        r = super().schedule_once()
        self.assert_same_metrics(f"cycle {self.cycles}")
        return r

    def sync_resource_metrics(self):
        super().sync_resource_metrics()
        self.port.sync_resource_metrics()

    def assert_same_world(self):
        super().assert_same_world()
        self.sync_resource_metrics()
        self.assert_same_metrics("end")


@pytest.fixture
def metrics_mirrored(monkeypatch):
    for mod in (tob, tme, test_oracle_engine):
        monkeypatch.setattr(mod, "Engine", MetricsMirroredEngine)
    _ENGINES.clear()
    yield
    assert _ENGINES, "no mirrored engine was built"
    for eng in _ENGINES:
        eng.assert_same_world()
    _ENGINES.clear()


@pytest.fixture
def port_registry(monkeypatch):
    """The registry unit cases of tests/test_metrics_endpoint.py on the
    port's registry."""
    for name in ("MetricsRegistry", "_esc", "_fmt"):
        monkeypatch.setattr(tme, name, getattr(preg, name))


@pytest.mark.parametrize("case", [
    "TestLabelEscaping.test_render_escapes_hostile_label_values",
    "TestLabelEscaping.test_esc_and_fmt_units",
    "TestLabelEscaping.test_named_pair_labels_escaped_too",
    "TestHistogram.test_quantile_zero_total_returns_zero",
    "TestHistogram.test_quantile_after_observations",
    "TestHistogram.test_reset_one_series_and_all",
    "TestHistogram.test_inf_bucket_rendered_and_equals_count"])
def test_registry_unit_cases(port_registry, case):
    cls, meth = case.split(".")
    getattr(getattr(tme, cls)(), meth)()


def test_empty_registries_render_alike():
    """Every family the JAX package registers, with its help, type and
    buckets, under the ``kueue_tpu_`` prefix."""
    assert preg.MetricsRegistry().render() == jreg.MetricsRegistry().render()
    assert preg.DEFAULT_BUCKETS == jreg.DEFAULT_BUCKETS
    assert preg.PERF_BUCKETS == jreg.PERF_BUCKETS


def test_registry_writes_render_alike():
    """The same writes (counters, gauges, histograms one by one and in
    bulk, both sides of observe_many's 64-sample threshold, custom label
    pairs, hostile values) give the same exposition, float sums
    included."""
    rng = np.random.default_rng(5)
    regs = [jreg.MetricsRegistry(), preg.MetricsRegistry()]
    vals = rng.exponential(0.3, 200).tolist()
    for reg in regs:
        reg.counter("admitted_workloads_total").inc(
            ("cq", ("custom_team", 'm"l')), 3)
        reg.gauge("pending_workloads").set(("cq\n", "active"), 7)
        reg.report_admission_attempt("success", 0.0123)
        reg.report_pending("cq", 4, 2)
        h = reg.histogram("admission_wait_time_seconds")
        for v in vals[:10]:
            h.observe(v, ("cq",))
        h.observe_many(vals[10:40], ("cq",))
        h.observe_many(vals[40:], ("cq2",))
        reg.histogram("apply_subphase_duration_seconds").observe(
            1e-5, ("x", "y"))
    assert regs[1].render() == regs[0].render()
    h = [r.histogram("admission_wait_time_seconds") for r in regs]
    for q in (0.0, 0.5, 0.95, 1.0):
        assert h[1].quantile(q, ("cq2",)) == h[0].quantile(q, ("cq2",))


def test_custom_labels_extract():
    entries = [("team", "", ""), ("tier", "", "example.com/tier"),
               ("env", "environment", "")]
    j = jreg.CustomMetricLabels([jreg.CustomLabelEntry(*e)
                                 for e in entries])
    p = preg.CustomMetricLabels([preg.CustomLabelEntry(*e)
                                 for e in entries])
    for labels, ann in (({"team": "ml", "environment": "prod"},
                         {"example.com/tier": "gold"}), ({}, {})):
        assert p.extract(labels, ann) == j.extract(labels, ann)
    assert p.for_object(None) == j.for_object(None)
    assert preg.CustomMetricLabels([]).for_object(object()) == ()


def test_unadmitted_bookkeeping_alike():
    """Updates, reason changes, removals one by one and in bulk: the
    same aggregates and gauges."""
    from kueue_tpu.cache import unadmitted as junadmitted

    regs = [jreg.MetricsRegistry(), preg.MetricsRegistry()]
    books = [junadmitted.UnadmittedWorkloads(regs[0]),
             punadmitted.UnadmittedWorkloads(regs[1])]
    mods = (junadmitted, punadmitted)
    rng = np.random.default_rng(11)
    for step in range(300):
        key = f"ns/w{int(rng.integers(40))}"
        op = rng.random()
        for mod, book in zip(mods, books):
            if op < 0.6:
                book.update(key, mod.UnadmittedStatus(
                    cluster_queue=f"cq{step % 3}", local_queue="lq",
                    namespace="ns",
                    reason=("NoFit", "Pending", "Evicted")[step % 3],
                    cause="Preempted" if step % 3 == 2 else ""))
            elif op < 0.8:
                book.remove(key)
            else:
                book.remove_many([key, f"ns/w{step % 40}", key])
    assert books[1].statuses == {k: punadmitted.UnadmittedStatus(
        **vars(v)) for k, v in books[0].statuses.items()}
    assert books[1].per_cq == books[0].per_cq
    assert books[1].per_lq == books[0].per_lq
    assert books[1].count_for_cq("cq1") == books[0].count_for_cq("cq1")
    assert books[1].count_for_cq("cq1", "Pending") == \
        books[0].count_for_cq("cq1", "Pending")
    assert regs[1].render() == regs[0].render()


@pytest.mark.parametrize("name", [
    "test_metrics_counters_and_render",
    "test_debugger_dump",
    "test_unadmitted_per_reason_bookkeeping",
    "test_lifecycle_metric_families_populated",
    "test_phase_timing_recorded",
    "test_resource_and_cohort_gauges",
    "test_resource_gauges_clear_when_sources_vanish",
    "test_custom_metric_labels_from_cq_metadata"])
def test_observability_engines(metrics_mirrored, name):
    """tests/test_observability.py's engine cases on mirrored engines:
    the registries render alike after every cycle and at the end."""
    getattr(tob, name)()


def test_dump_state_unadmitted_by_reason(metrics_mirrored):
    from kueue_tpu.visibility.server import dump_state as jdump
    from kueue_tpu_torch.visibility.server import dump_state as pdump

    eng = tob.make_engine()
    tob.submit(eng, "ok", 500)
    tob.submit(eng, "big", 5000)
    eng.schedule_once()
    eng.schedule_once()
    want = jdump(eng)["unadmittedByReason"]
    assert want == {"cq/NoFit/": 1}
    assert pdump(eng.port)["unadmittedByReason"] == want


@pytest.mark.parametrize("name", [
    "test_oracle_engine_matches_sequential_outcomes",
    "test_oracle_engine_continues_after_finish",
    "test_oracle_handles_within_cq_preemption_on_device",
    "test_oracle_falls_back_for_cross_cq_reclaim"])
def test_oracle_engine_registries(metrics_mirrored, name):
    """Device, hybrid and fallback cycles at the defaults (the
    speculation pipeline and the columnar apply on): the bridge's
    ``oracle_*`` counters, the breaker state, the bulk path's deferred
    counters and ``observe_many`` sums, and the eviction families
    render alike; the bridge's phase series by count."""
    getattr(test_oracle_engine, name)()


def test_preempting_world_evictions(metrics_mirrored):
    """The eviction families and /evictions on a preempting device
    world (tests/test_preempt_churn.py's churn, seed 3)."""
    import test_preempt_churn
    from kueue_tpu.visibility.server import eviction_summary as jevict
    from kueue_tpu_torch.visibility.server import eviction_summary as pevict

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_preempt_churn, "Engine", MetricsMirroredEngine)
        test_preempt_churn.test_churn_outcomes_match_sequential(3)
    engines = list(_ENGINES)
    assert any(e.oracle is not None for e in engines)
    for eng in engines:
        want = jevict(eng)
        assert pevict(eng.port) == want
    assert any(jevict(e) for e in engines), "no eviction to compare"
