"""``kueue_tpu_torch/bench/obs_worlds.py``: a serving-engine run traced
and perf-recorded, probed cycle by cycle, in each package.

On the quarter-size ``cycle_latency`` world, on the default and the
serial loop, the port's run decides as the JAX engine's and its obs
numbers (cycles traced, the cid chain, committed device calls, bytes
each way, the shape-signature cache's hits and misses per cycle) equal
the JAX package's, and equal its own untraced run's decisions. The slow
test recomputes ``chip_smoke.py``'s phase 27 constants (``TRACED_EXPECT``
and the run's pinned numbers) from the JAX package at full width; phase
28 pins ``SERVE_BREAKER_EXPECT``, which
``tests/test_torch_serve.py::test_breaker_world_constants`` recomputes.
"""

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.obs import hooks as jhooks
from kueue_tpu.obs import perf as jperf
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import obs_worlds as ow
from kueue_tpu_torch.obs import hooks as phooks
from kueue_tpu_torch.obs import perf as pperf


@pytest.fixture
def jkit():
    yield ew.Kit(jtypes, jscenario,
                 lambda fair=False: JEngine(enable_fair_sharing=fair),
                 lambda eng: eng.attach_oracle())
    jperf.ACTIVE = pperf.ACTIVE = None
    jhooks.CURRENT = phooks.CURRENT = None


@pytest.mark.parametrize("arm", ["full", "serial"])
def test_quarter_traced_runs_match_jax(jkit, arm):
    cfg = dict(ew.QUARTER["cycle_latency"], arm=arm)
    jr, jp = ow.run(cfg, kit=jkit)
    pr, pp = ow.run(cfg, kit=ew.port_kit("cpu"))
    bare = ew.run(cfg, kit=ew.port_kit("cpu"))
    assert ew.arm_pinned(pr) == ew.arm_pinned(jr) == ew.arm_pinned(bare)
    got, want = ow.obs_numbers(pp), ow.obs_numbers(jp)
    assert got == want
    assert got["cycles_traced"] == pr["cycles"] == len(got["cids"])
    assert got["launches"] == pr["on_device"]
    assert {n for n, _ in pp.perf.hist} == {n for n, _ in jp.perf.hist}
    assert set(ow.subphase_seconds(pp)) == set(ow.subphase_seconds(jp))


def test_probe_detaches_cleanly(jkit):
    r, probe = ow.run(dict(ew.QUARTER["cycle_latency"], arm="full",
                           cycles=1), kit=ew.port_kit("cpu"))
    eng = r["engines"][0]
    assert eng.tracer is None and eng.perf is None
    assert probe._post not in eng.cycle_listeners
    assert pperf.ACTIVE is None and phooks.CURRENT is None


def test_obs_hook_is_for_cycle_runs():
    with pytest.raises(ValueError):
        ew.run(ew.QUARTER["preempt_churn"], obs=lambda eng: None)


@pytest.mark.slow
def test_traced_constants_match_chip_smoke(jkit):
    r, probe = ow.run(ew.DEFAULT_ARM["cycle_latency"], kit=jkit)
    assert ew.arm_pinned(r) == chip_smoke.DEFAULT_ARM_EXPECT["cycle_latency"]
    want = dict(chip_smoke.TRACED_EXPECT,
                jit=[tuple(j) for j in chip_smoke.TRACED_EXPECT["jit"]])
    assert ow.obs_numbers(probe) == want


def test_overhead_arms_decide_alike(monkeypatch):
    """``bench/obs_overhead.py``'s four arms on the quarter world, on the
    CPU: each decides as the bare run (its own gate) and reports its
    cycle times."""
    from kueue_tpu_torch.bench import obs_overhead as oo

    monkeypatch.setattr(ew, "DEFAULT_ARM", {"cycle_latency": dict(
        ew.QUARTER["cycle_latency"], arm="full")})
    port = ew.port_kit
    monkeypatch.setattr(ew, "port_kit", lambda device=None: port("cpu"))
    try:
        want = None
        for arm in oo.ARMS:
            row, pinned = oo.run_arm(arm, want)
            want = want or pinned
            assert row["arm"] == arm and row["p95"] >= row["p50"] > 0
    finally:
        pperf.ACTIVE = None
        phooks.CURRENT = None


def test_attached_captures_the_window(tmp_path):
    """``obs_worlds.attached``, as ``chip_smoke.py`` phase 27 attaches it,
    on the quarter world on the CPU: the subscriber sees every engine
    event of the window in order, the watchdog stays closed, the cycles
    leave a Chrome trace, and the run decides as the bare run."""
    import json
    from contextlib import contextmanager

    box = {}

    @contextmanager
    def extra(eng):
        with ow.attached(eng, hub=True, watchdog=(30.0, 120.0),
                         profile_dir=str(tmp_path)) as got:
            box["got"] = got
            yield
        box["eng"] = eng

    cfg = dict(ew.QUARTER["cycle_latency"], arm="full")
    try:
        r, _probe = ow.run(cfg, kit=ew.port_kit("cpu"), extra=extra)
    finally:
        pperf.ACTIVE = None
        phooks.CURRENT = None
    bare = ew.run(cfg, kit=ew.port_kit("cpu"))
    assert ew.arm_pinned(r) == ew.arm_pinned(bare)
    got, eng = box["got"], box["eng"]
    want = [(e.kind, e.workload, e.cluster_queue, e.detail, e.time)
            for e in got["events"]]
    seen = [(k, d["workload"], d["clusterQueue"], d["detail"], d["time"])
            for k, d in ((k, json.loads(data)) for k, data in got["seen"])]
    assert seen == want and len(seen) > r["admitted"]
    assert got["hub"]["published"] == len(seen) and not got["hub"]["dropped"]
    assert got["watchdog"]["state"] == "closed"
    assert eng.watchdog is None and eng.slo is None and not eng.fanout
    assert len(list(tmp_path.glob("*.json"))) == 1
