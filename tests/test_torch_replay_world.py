"""``kueue_tpu_torch/bench/replay_world.py``: the flight recorder on
``engine_worlds``' cycle_latency cell on the default loop, in each
package.

At QUARTER, the port's recorded run decides as the JAX engine's, and its
trace holds the JAX recorder's frames once ``phases`` and ``crc`` are
masked (so the same decision digest, masked checksum, frames and
bootstrap frames); its replay in ``both`` mode (a host engine and a
device engine on the CPU) has no mismatch of either kind; its replay in
``device`` mode under a fault plan decides byte-identical and fires the
same faults with the same injected errors, delayed calls, device,
hybrid and fallback cycles, fallback reasons and ``pipeline_stats`` as
the JAX replayer's of the JAX trace; each replay's executor calls equal
its bridge's dispatched calls (what the heads kernel counts on the
card); the record leaves the uid counter where it was. The slow test
recomputes ``chip_smoke.py``'s phase 29 constants (``REPLAY_EXPECT``)
from the JAX package at full width."""

import pytest

import chip_smoke
from kueue_tpu import replay as jreplay
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import replay_world as rw

QUARTER = dict(ew.QUARTER["cycle_latency"], arm="full")
# The quarter cell has cycles 0 to 4; every fault lands on one of them.
QUARTER_FAULTS = ("oracle-crash@cycle:1,delay-verdict@cycle:3:50,"
                  "oracle-crash-storm@cycle:4:1")
FAULT_KEYS = ("on_device", "hybrid", "fallback", "fallback_reasons",
              "pipeline_stats")


def jax_kit():
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle(), replay=jreplay)


def dispatched(info) -> int:
    ps = info["pipeline_stats"]
    return info["on_device"] - ps["used"] + ps["speculated"]


def fault_numbers(finfo) -> dict:
    return dict(fired=finfo["fired"],
                injected_errors=finfo["injected_errors"],
                delayed_calls=finfo["delayed_calls"],
                **{k: finfo["device"][k] for k in FAULT_KEYS})


def runs(config, kit, path, faults, both=False) -> dict:
    """The record of ``config`` into ``path`` with ``kit``, the replay
    of its trace in device mode under ``faults`` and, with ``both``, in
    both mode."""
    r, info = rw.record(config, path, kit=kit)
    out = dict(path=path, pinned=ew.arm_pinned(r), info=info,
               trace=dict(digest=info["digest"],
                          masked=rw.masked_checksum(path),
                          frames=info["frames"],
                          bootstrap_frames=info["bootstrap_frames"],
                          cycles=info["cycles"]))
    del r
    report, finfo = rw.replay(config, path, "device", kit=kit, faults=faults)
    out.update(faults_report=report, faults=fault_numbers(finfo),
               faults_dispatched=(finfo["device"]["dispatched"],
                                  dispatched(finfo["device"])))
    if both:
        report, binfo = rw.replay(config, path, "both", kit=kit)
        out.update(both_report=report, both_device=binfo["device"],
                   both_rebuild_s=binfo["rebuild_s"])
    return out


@pytest.fixture(scope="module")
def quarter(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay_world")
    return {"jax": runs(QUARTER, jax_kit(), str(d / "jax.jsonl"),
                        QUARTER_FAULTS),
            "port": runs(QUARTER, ew.port_kit("cpu"), str(d / "port.jsonl"),
                         QUARTER_FAULTS, both=True)}


def test_recorded_run_decides_as_jax(quarter):
    got, want = quarter["port"], quarter["jax"]
    assert got["pinned"] == want["pinned"]
    assert got["pinned"]["cycles"] == 5 and got["pinned"]["on_device"] == 5
    assert got["info"]["dispatched"] == want["info"]["dispatched"] == 6


def test_trace_frames_equal_jax(quarter):
    got, want = quarter["port"], quarter["jax"]
    assert got["trace"] == want["trace"]
    assert rw.masked_frames(got["path"]) == rw.masked_frames(want["path"])
    # The header, 50 cohorts, a flavor, 250 ClusterQueues and as many
    # LocalQueues, and 12,500 pending workloads.
    assert got["info"]["bootstrap_frames"] == 1 + 50 + 1 + 250 + 250 + \
        12_500


def test_both_replay_has_no_mismatch(quarter):
    got = quarter["port"]
    report = got["both_report"]
    assert report.ok and not report.mismatches, report.render()
    assert report.replayed_digest == got["trace"]["digest"]
    assert report.cycles == 5 and report.admitted == 1250
    assert got["both_device"]["dispatched"] == dispatched(got["both_device"])
    assert {p.split(":")[0] for p in report.phases_replayed} >= {
        "device", "decide", "apply"}
    assert "MISMATCH" not in report.render()


def test_faulted_replay_matches_jax(quarter):
    got, want = quarter["port"], quarter["jax"]
    for pkg in (got, want):
        report = pkg["faults_report"]
        assert report.ok, report.render()
        assert report.replayed_digest == pkg["trace"]["digest"]
    assert got["faults"] == want["faults"]
    assert len(got["faults"]["fired"]) == 3
    assert got["faults"]["fallback"] > 0 and got["faults"]["delayed_calls"]
    a, b = got["faults_dispatched"]
    assert a == b


def test_record_restores_the_uid_counter(tmp_path):
    before = next(ptypes._uid_counter)
    rw.record(dict(QUARTER, kw=dict(n_cohorts=2, cqs_per_cohort=2,
                                    n_workloads=40), cycles=1),
              str(tmp_path / "t.jsonl"), kit=ew.port_kit("cpu"))
    assert next(ptypes._uid_counter) == before + 1


@pytest.mark.slow
def test_replay_expect_constants(tmp_path):
    """chip_smoke.py's REPLAY_EXPECT from the JAX package at full width:
    its recorder's trace of DEFAULT_ARM cycle_latency and its replayer's
    device-mode replay of that trace under replay_world.FAULTS."""
    got = runs(ew.DEFAULT_ARM["cycle_latency"], jax_kit(),
               str(tmp_path / "full.jsonl"), rw.FAULTS)
    assert got["pinned"] == chip_smoke.DEFAULT_ARM_EXPECT["cycle_latency"]
    assert got["faults_report"].ok
    want = dict(chip_smoke.REPLAY_EXPECT)
    assert dict(got["trace"], faults=got["faults"]) == want
