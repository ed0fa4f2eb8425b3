"""The tas_lifecycle world of chip_smoke.py phase 26
(kueue_tpu_torch/bench/tas_engine_worlds.py: the 5,120-node churn world
through DaemonSet pods, node failures and the second pass) recomputed on
the CPU: the JAX engine and the port's engine on the same world, calls
and pins. At QUARTER size both engines must give the numbers pinned
here, under both TAS path pins, on the default loop and on the serial
one, with the same ``pipeline_stats`` after every schedule_once and the
same pending queues at the end; at full size the JAX engine alone must
give the numbers chip_smoke.py pins (slow). Exact throughout."""

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.tas import non_tas_usage as jnon
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import tas_engine_worlds as tw

# The JAX engine's numbers at QUARTER size, per loop arm: the default
# loop's speculations move the planner's memo hits and batch calls, not
# the decisions.
_QUARTER_COMMON = dict(
    cycles=14, admitted=66, checksum=0x846c31a5, placements=0x321d9cf5,
    on_device=5, hybrid=2, fallback=10,
    host_root_reasons={"tas-commit-conflict": 2, "tas-no-fit": 9},
    commit_drops=0, node_unhealthy=11, node_replaced=8, retries=3,
    replace_calls=11, events_crc=0x23c9b83a, final_crc=0x33ab7ea9)
QUARTER_EXPECT = {
    "full": dict(_QUARTER_COMMON, placed=36, memo_hits=4, batch_calls=18),
    "serial": dict(_QUARTER_COMMON, placed=40, memo_hits=0, batch_calls=20),
}


@pytest.fixture
def jax_kit(monkeypatch, tmp_path):
    """The JAX package's kit, its non-TAS pod usage module included; both
    crossover records pointed at an empty directory (the loop arm is the
    run's own)."""
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle(), jsnapshot,
                  non_tas_usage=jnon)


@pytest.mark.parametrize("arm", list(QUARTER_EXPECT))
@pytest.mark.parametrize("path,feas", tw.ARMS["tas_lifecycle"])
def test_quarter_runs_match_jax(jax_kit, arm, path, feas):
    config = dict(tw.QUARTER["tas_lifecycle"], arm=arm)
    want = tw.run(config, path, feas, kit=jax_kit)
    assert tw.pinned_numbers(want) == tw.arm_expect(QUARTER_EXPECT[arm],
                                                    path)
    got = tw.run(config, path, feas, kit=ew.port_kit("cpu"))
    assert tw.pinned_numbers(got) == tw.pinned_numbers(want)
    assert got["pipeline"] == want["pipeline"]
    assert got["queues"] == want["queues"]
    assert got["replace_host"] == want["replace_host"]
    # The port's own count of replacement placements on the device
    # program agrees with the calls that did not take the host descent.
    assert got["replace_device_placements"] == got["replace_device"]
    assert len(got["second_pass_s"]) == config["churn_cycles"]
    if arm == "full":
        assert want["pipeline_stats"]["speculated"] > 0


def test_world_calls():
    """The world makes the calls it is described by: 160 DaemonSet hosts
    in blocks b0 and b1, one in eight, and its failures inside the churn
    at both sizes."""
    for sizes in (tw.FULL, tw.QUARTER):
        config = sizes["tas_lifecycle"]
        ds = tw.daemonset_nodes(config)
        assert len(ds) == 160 and ds == sorted(ds)
        assert {n.split("-")[0] for n in ds} == {"b0", "b1"}
        assert all(int(n.rsplit("h", 1)[1]) % 8 == 0 for n in ds)
        assert max(config["failures"]) < config["churn_cycles"]
        assert config["arm"] == "full"
    assert tw.FULL["tas_lifecycle"]["failures"] == (0, 4, 8, 12, 16)
    assert tw.QUARTER["tas_lifecycle"]["failures"] == (0, 4)


def test_runs_drive_every_path():
    """The pinned runs exercise what they are for: failures that mark
    several workloads, replacements, retries, hybrid cycles and device
    cycles, at both sizes."""
    for e in (chip_smoke.LIFECYCLE_EXPECT, QUARTER_EXPECT["full"]):
        assert e["node_unhealthy"] > e["node_replaced"] > 0
        assert e["retries"] > 0 and e["replace_calls"] > e["node_replaced"]
        assert e["on_device"] > 0 and e["hybrid"] > 0
        assert e["batch_calls"] > 0 and e["placed"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("path,feas", tw.ARMS["tas_lifecycle"])
def test_full_runs_match_chip_smoke(jax_kit, path, feas):
    r = tw.run(tw.FULL["tas_lifecycle"], path, feas, kit=jax_kit)
    assert tw.pinned_numbers(r) == tw.arm_expect(
        chip_smoke.LIFECYCLE_EXPECT, path)
    assert r["pipeline_stats"] == chip_smoke.LIFECYCLE_PIPELINE
