"""The TAS engine runs of chip_smoke.py phases 14-16
(kueue_tpu_torch/bench/tas_engine_worlds.py) recomputed on the CPU: the
JAX engine, with its serial cycle loop, on the same worlds, calls and
pins as the port's engine. At QUARTER size both engines must give the
numbers pinned here, in every arm (the TAS path pinned to the host and
to the device; the churn also with the feasibility batch off); at full
size the JAX engine alone must give the numbers chip_smoke.py pins
(slow). This file runs the ``tas`` world;
tests/test_torch_tas_churn_worlds.py the pod-slice-scale ones. Exact
throughout."""

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import tas_engine_worlds as tw

QUARTER_EXPECT = {
    "tas": dict(
        cycles=114, admitted=200, checksum=0x69e55876,
        placements=0xcf1c4e6e, on_device=114, hybrid=0, fallback=0,
        host_root_reasons={}, placed=676, memo_hits=0, commit_drops=685,
        batch_calls=452),
    "tas_large": dict(
        cycles=26, admitted=30, checksum=0xf772ff2d,
        placements=0x4e634043, on_device=26, hybrid=0, fallback=0,
        host_root_reasons={}, placed=112, memo_hits=0, commit_drops=122,
        batch_calls=91),
    "tas_churn": dict(
        cycles=14, admitted=66, checksum=0x9387bc30,
        placements=0x0c13b03d, on_device=5, hybrid=3, fallback=10,
        host_root_reasons={"tas-commit-conflict": 3, "tas-no-fit": 9},
        placed=42, memo_hits=0, commit_drops=0, batch_calls=22),
}


@pytest.fixture
def jax_kit(monkeypatch, tmp_path):
    """The JAX package's types, engine and TAS snapshot module, its
    bridge on the serial cycle loop the port runs; both crossover
    records pointed at an empty directory."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle(), jsnapshot)


def check_quarter(jax_kit, name, path, feas):
    want = tw.pinned_numbers(tw.run(tw.QUARTER[name], path, feas,
                                    kit=jax_kit))
    assert want == tw.arm_expect(QUARTER_EXPECT[name], path)
    got = tw.pinned_numbers(tw.run(tw.QUARTER[name], path, feas,
                                   kit=ew.port_kit("cpu")))
    assert got == want


@pytest.mark.parametrize("path,feas", tw.ARMS["tas"])
def test_quarter_tas_matches_jax(jax_kit, path, feas):
    check_quarter(jax_kit, "tas", path, feas)


@pytest.mark.slow
@pytest.mark.parametrize("name,path,feas", [
    (name, path, feas) for name in tw.FULL
    for path, feas in tw.ARMS[name]])
def test_full_runs_match_chip_smoke(jax_kit, name, path, feas):
    got = tw.pinned_numbers(tw.run(tw.FULL[name], path, feas, kit=jax_kit))
    assert got == tw.arm_expect(chip_smoke.TAS_ENGINE_EXPECT[name], path)


def test_runs_drive_every_path():
    """The pinned runs exercise what they are for: device cycles and
    batch launches in every world, hybrid cycles and both kinds of
    host-root demotion in the churn, commit drops in the drains."""
    for expect in (chip_smoke.TAS_ENGINE_EXPECT, QUARTER_EXPECT):
        for name, e in expect.items():
            assert e["on_device"] > 0 and e["batch_calls"] > 0, name
            assert e["placed"] > 0, name
        churn = expect["tas_churn"]
        assert churn["hybrid"] > 0
        assert set(churn["host_root_reasons"]) == {
            "tas-commit-conflict", "tas-no-fit"}
        assert expect["tas"]["commit_drops"] > 0
