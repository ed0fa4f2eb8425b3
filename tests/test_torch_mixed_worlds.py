"""The runs of chip_smoke.py phases 17 and 18
(kueue_tpu_torch/bench/mixed_worlds.py) recomputed on the CPU: the JAX
engine, with its serial cycle loop, on the same worlds and calls as the
port's engine. At QUARTER size both engines must give the numbers
pinned here; at full size (FULL) the JAX engine alone must give the
numbers chip_smoke.py pins (slow: minutes of XLA compiles and a
50,000-workload engine). Exact throughout."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers import admissionchecks as jchecks
from kueue_tpu.controllers import afs as jafs
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import mixed_worlds as mw

QUARTER_EXPECT = {
    "mixed_world": dict(
        cycles=31, admitted=1788, preempting=0, evicted=0, finished=0,
        checksum=0xf0c73b29, placements=0x04d3aa4a, on_device=30,
        hybrid=30, fallback=1, overridden=29,
        host_root_reasons={"sim-multi-podset": 15, "tas-forest-shared": 1,
                           "tas-preemption": 212},
        fallback_reasons={"all-host": 1}, afs_usage=0),
    "afs_serving": dict(
        cycles=5, admitted=1250, preempting=0, evicted=48, finished=952,
        checksum=0xcf7d26ef, placements=0xf91abbd7, on_device=5, hybrid=0,
        fallback=0, overridden=0, host_root_reasons={},
        fallback_reasons={}, afs_usage=0x83a0095f),
}


@pytest.fixture
def jax_kit(monkeypatch, tmp_path):
    """The JAX package's types, scenarios, engine, TAS snapshot module
    and managers, its bridge on the serial cycle loop the port runs;
    both crossover records pointed at an empty directory."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle(), jsnapshot, jafs, jchecks)


def pinned(run):
    return {k: run[k] for k in mw.PINNED}


@pytest.mark.parametrize("name", list(mw.QUARTER))
def test_quarter_runs_match_jax(jax_kit, name):
    want = pinned(mw.run(mw.QUARTER[name], kit=jax_kit))
    assert want == QUARTER_EXPECT[name]
    got = pinned(mw.run(mw.QUARTER[name], kit=ew.port_kit("cpu")))
    assert got == want


_PORT_RUNS = """
import json
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import mixed_worlds as mw
print(json.dumps({n: {k: mw.run(mw.QUARTER[n], kit=ew.port_kit("cpu"))[k]
                      for k in mw.PINNED} for n in mw.QUARTER}))
"""


@pytest.mark.parametrize("hash_seed", ["3"])
def test_port_runs_ignore_hash_seed(hash_seed, tmp_path):
    """Both quarter runs give the pinned numbers in a process of any
    string hash seed (the TAS signatures of the mixed world hold
    frozensets; the admission order under AFS follows dicts of
    LocalQueue keys)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONHASHSEED=hash_seed, PYTHONPATH=str(root),
               KUEUE_TPU_TORCH_TAS_CALIBRATION=str(tmp_path / "port.json"))
    out = subprocess.run([sys.executable, "-c", _PORT_RUNS], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == QUARTER_EXPECT


@pytest.mark.slow
@pytest.mark.parametrize("name", list(mw.FULL))
def test_full_runs_match_chip_smoke(jax_kit, name):
    assert pinned(mw.run(mw.FULL[name], kit=jax_kit)) == \
        chip_smoke.MIXED_EXPECT[name]


def test_runs_drive_every_path():
    """The pinned runs exercise what they are for: device and hybrid
    cycles with slot overrides and TAS and multi-podset roots on the
    host in the mixed world; device cycles, Retry evictions, finishes
    and a moving usage in afs_serving."""
    for expect in (chip_smoke.MIXED_EXPECT, QUARTER_EXPECT):
        mixed, afs = expect["mixed_world"], expect["afs_serving"]
        assert mixed["on_device"] and mixed["hybrid"] and mixed["overridden"]
        assert mixed["host_root_reasons"]["tas-preemption"]
        assert mixed["host_root_reasons"]["sim-multi-podset"]
        assert afs["on_device"] == afs["cycles"]
        assert afs["evicted"] and afs["finished"] and afs["afs_usage"]
