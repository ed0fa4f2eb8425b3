"""Topology-aware scheduling in the port's serving engine against the JAX
engine, on the CPU: tests/test_tas_integration.py's worlds (the
sequential host cycle) and tests/test_tas_feasibility.py's churn world
(hybrid cycles and the feasibility pre-pass, on and off), run through
``MirroredEngine`` (tests/test_torch_engine.py), which compares every
cycle's decisions, placements, bridge counters and TAS stats. Both
packages run pinned to the host path and to the device path. A failed
feasibility launch or tas_place_batch launch raises out of
schedule_once. Exact throughout."""

import random

import pytest

import test_tas_batched as tb
import test_tas_feasibility as tf
import test_tas_integration as ti
import test_torch_engine as te
from kueue_tpu_torch.tas import assigner as passigner
from kueue_tpu_torch.tas import feasibility as pfeasibility

PATHS = {"host": "1000000", "device": "0"}


@pytest.fixture(params=list(PATHS))
def mirrored(request, monkeypatch, tmp_path):
    """MirroredEngine patched into the reference test modules, both
    packages pinned to one TAS path, both crossover records pointed at
    an empty directory; every mirrored world held to the JAX engine's
    when the test ends."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", PATHS[request.param])
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    for mod in (ti, tf, tb):
        monkeypatch.setattr(mod, "Engine", te.MirroredEngine)
    te._ENGINES.clear()
    yield request.param
    assert te._ENGINES, "no mirrored engine was built"
    for eng in te._ENGINES:
        eng.assert_same_world()
    te._ENGINES.clear()


@pytest.mark.parametrize("name", [
    "test_tas_admission_with_assignment",
    "test_tas_capacity_tracked_across_workloads",
    "test_tas_freed_on_finish",
    "test_tas_quota_fits_but_placement_fragmented",
    "test_tas_preferred_spreads"])
def test_tas_integration_worlds(mirrored, name):
    getattr(ti, name)()


def test_feasibility_changes_no_observable(mirrored, monkeypatch):
    tf.TestCycleParity().test_feasibility_changes_no_observable(monkeypatch)


def test_verdicts_actually_reject(mirrored, monkeypatch):
    """The pre-pass short-circuits placements in the churn regime in the
    port too, with the JAX package's verdicts."""
    rejected = []
    orig = passigner._precomputed_failure

    def spy(*a, **k):
        r = orig(*a, **k)
        if r is not None:
            rejected.append(r)
        return r

    monkeypatch.setattr(passigner, "_precomputed_failure", spy)
    tf.TestCycleParity().test_verdicts_actually_reject(monkeypatch)
    assert rejected
    assert "topology" in rejected[0][1]


def _port_world(monkeypatch, batch):
    """tests/test_tas_batched.py's seed-95 world on the port alone."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setenv("KUEUE_TPU_TAS_BATCH", batch)
    monkeypatch.setattr(tb, "Engine", te.MirroredEngine)
    eng = tb._build_world(random.Random(95), 3, 2, 4).port
    te._ENGINES.clear()
    return eng


def test_failed_feasibility_launch_raises(monkeypatch):
    """The host cycle's feasibility launch failing leaves schedule_once
    with the error: nothing falls back to the per-entry descent."""
    monkeypatch.setenv("KUEUE_TPU_TAS_FEAS_MIN", "1")
    monkeypatch.setenv("KUEUE_TPU_TAS_FEAS_MIN_LEAVES", "1")
    eng = _port_world(monkeypatch, "0")

    def fail(*a, **k):
        raise RuntimeError("feasibility launch failed")

    monkeypatch.setattr(pfeasibility, "_launch", fail)
    with pytest.raises(RuntimeError, match="feasibility launch failed"):
        eng.schedule_once()


def test_failed_batch_launch_raises(monkeypatch):
    """The planner's tas_place_batch launch failing leaves schedule_once
    with the error; the bridge counts no fallback."""
    from kueue_tpu_torch.ops import tas as ptas

    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "0")
    eng = _port_world(monkeypatch, "1")

    def fail(*a, **k):
        raise RuntimeError("tas_place_batch failed")

    monkeypatch.setattr(ptas, "tas_place_batch", fail)
    with pytest.raises(RuntimeError, match="tas_place_batch failed"):
        eng.schedule_once()
    assert eng.oracle.cycles_fallback == 0
    assert eng.oracle.fallback_reasons == {}
