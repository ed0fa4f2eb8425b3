"""The serving-engine runs of chip_smoke.py phases 10-13
(kueue_tpu_torch/bench/engine_worlds.py) recomputed on the CPU: the JAX
engine, with its serial cycle loop, on the same worlds and calls as the
port's engine. At full size (FULL) the JAX engine alone must give the
numbers chip_smoke.py pins (slow: several minutes of XLA compiles and a
50,000-workload engine), on the loop each run pins (the serial loop for
phases 10-13, the default loop for DEFAULT_ARM, phases 22 and 23, the
serial loop and the pipeline for OTHER_ARMS, phases 24 and 25); at
QUARTER size both engines must give the numbers pinned here. Exact
throughout."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import tas_engine_worlds as tw

QUARTER_EXPECT = {
    "cycle_latency": dict(
        cycles=5, admitted=1250, preempting=0, preemptions=0,
        checksum=0xd6d61fb0, on_device=5, hybrid=0, fallback=0,
        overridden=0),
    "fair_cycle_latency": dict(
        cycles=4, admitted=520, preempting=0, preemptions=0,
        checksum=0x46c37bcf, on_device=4, hybrid=0, fallback=0,
        overridden=0),
    "preempt_churn": dict(
        cycles=18, admitted=53, preempting=16, preemptions=20,
        checksum=0x03e76e62, on_device=18, hybrid=0, fallback=0,
        overridden=0),
    "multiflavor": dict(
        cycles=18, admitted=27, preempting=3, preemptions=3,
        checksum=0xf5611885, on_device=18, hybrid=0, fallback=0,
        overridden=18),
}


@pytest.fixture
def jax_kit(monkeypatch):
    """The JAX package's types, scenarios and engine, its bridge on the
    serial cycle loop the port runs."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle())


def pinned(run):
    return {k: run[k] for k in ew.PINNED}


@pytest.mark.parametrize("name", list(ew.QUARTER))
def test_quarter_runs_match_jax(jax_kit, name):
    want = pinned(ew.run(ew.QUARTER[name], kit=jax_kit))
    assert want == QUARTER_EXPECT[name]
    got = pinned(ew.run(ew.QUARTER[name], kit=ew.port_kit("cpu")))
    assert got == want


_PORT_RUNS = """
import json
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import tas_engine_worlds as tw
out = {n: {k: ew.run(ew.QUARTER[n], kit=ew.port_kit("cpu"))[k]
           for k in ew.PINNED}
       for n in ("preempt_churn", "multiflavor")}
out["tas_churn"] = tw.pinned_numbers(tw.run(
    tw.QUARTER["tas_churn"], "device", kit=ew.port_kit("cpu")))
print(json.dumps(out))
"""


@pytest.mark.parametrize("hash_seed", ["0", "1", "4242"])
def test_port_runs_ignore_hash_seed(hash_seed, tmp_path):
    """The admitted rows that order victims are numbered in the
    iteration order of a set of strings, which follows the process's
    hash seed, and TAS requests are keyed by signatures holding
    frozensets: the preempting runs and the quarter-size TAS churn (its
    feasibility launches, planner batches and hybrid cycles) give the
    pinned numbers in a process of any seed."""
    from test_torch_tas_engine_worlds import QUARTER_EXPECT as TAS_EXPECT

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONHASHSEED=hash_seed, PYTHONPATH=str(root),
               KUEUE_TPU_TORCH_TAS_CALIBRATION=str(tmp_path / "port.json"))
    out = subprocess.run([sys.executable, "-c", _PORT_RUNS], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {**{n: QUARTER_EXPECT[n]
                      for n in ("preempt_churn", "multiflavor")},
                   "tas_churn": tw.arm_expect(TAS_EXPECT["tas_churn"],
                                              "device")}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(ew.FULL))
def test_full_runs_match_chip_smoke(jax_kit, name):
    assert pinned(ew.run(ew.FULL[name], kit=jax_kit)) == \
        chip_smoke.ENGINE_EXPECT[name]


ARM_RUNS = {**ew.DEFAULT_ARM, **ew.OTHER_ARMS}
ARM_EXPECT = {**chip_smoke.DEFAULT_ARM_EXPECT, **chip_smoke.OTHER_ARMS_EXPECT}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(ARM_RUNS))
def test_default_arm_runs_match_chip_smoke(jax_kit, name):
    """chip_smoke.py phases 22 to 25: the JAX engine on the loop arm each
    run names (the run pins it, whatever the caller's environment): the
    default loop, and preempt_churn with the per-entry assume on the
    serial loop and on the pipeline; speculations and evictions pinned
    too."""
    got = ew.arm_pinned(ew.run(ARM_RUNS[name], kit=jax_kit))
    print(f"{name}: {got}")
    assert got == ARM_EXPECT[name]


def test_runs_drive_every_path():
    """The pinned runs exercise what they are for: device cycles in
    every run, preemptions in the churn, slot overrides in the
    multi-flavor worlds."""
    q = QUARTER_EXPECT
    assert all(v["on_device"] > 0 for v in q.values() if v)
    for expect in (chip_smoke.ENGINE_EXPECT, q):
        if expect["preempt_churn"]:
            assert expect["preempt_churn"]["preemptions"] > 0
        if expect["multiflavor"]:
            assert expect["multiflavor"]["overridden"] > 0
