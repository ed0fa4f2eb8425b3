"""The client world of chip_smoke.py phase 35 (kueue_tpu_torch/bench/
client_worlds.py) recomputed on the CPU.

At SMALL size (2,500 entries over 50 ClusterQueues, 9 cycles on the
default loop) both packages build and drive the world through their
own client layer, endpoint and ``kueuectl``: the pinned numbers (cycles,
admissions, the decision checksum, device / hybrid / fallback cycles,
evictions by reason, pipeline_stats, the apply engine's re-keys, moves
and conflicts, the WorkloadHeld events, the deletes, the crc32 of both
informers' stores, of the remote client's fan-out and listings and of
every ``kueuectl`` rendering, the SLO's objectives and cycles, the trace
export's events and the replay's verdict) equal the ones pinned here;
the event streams, ``pipeline_stats`` after every cycle and the final
workloads equal; the journals are byte-identical (the uid counters start
at one value in both); the late informer's store equals the early one's;
and the replay engine's executor calls equal its dispatched device
calls. At full size (FULL) the JAX engine alone must give the numbers
chip_smoke.py pins (slow). Exact throughout."""

import pytest

import chip_smoke
from kueue_tpu import client as jclient
from kueue_tpu import replay as jreplay
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.cli import kueuectl as jkueuectl
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.store import journal as jjournal
from kueue_tpu.visibility import http_server as jhttp
from kueue_tpu_torch.bench import client_worlds as cw
from kueue_tpu_torch.bench import engine_worlds as ew
from test_torch_controller_world import events
from test_torch_engine import outcome

SMALL_EXPECT = dict(
    cycles=9, admitted=383, preempting=0, preemptions=0,
    checksum=0x80a18819, on_device=9, hybrid=0, fallback=0, overridden=0,
    evicted={"ClusterQueueStopped": 10, "LocalQueueStopped": 15},
    pipeline_stats=dict(speculated=6, used=1, discarded=4, skipped=3),
    rekeys=50, moves=50, conflicts=10, held_events=0, cohort_moves=10,
    moved_new=200, deleted=100, cqs_fanned=102, journal_records=3196,
    slo=dict(objectives=["admission_rate_floor", "cycle_latency_p95",
                         "fallback_cycle_ratio"], cyclesObserved=9),
    trace_events=175, trace_trees=3,
    replay=dict(rc=0, recorded="6ae2eb4b", replayed="6ae2eb4b", cycles=3,
                on_device=3, hybrid=0, fallback=0,
                pipeline_stats=dict(speculated=3, used=2, discarded=0,
                                    skipped=0)),
    informer_crc=0x92f854f4, fanout_crc=0x26cb2d4c,
    remote_workloads_crc=0x902f3cba, remote_cqs_crc=0x757bd073,
    list_workloads_crc=0x0e66e658, list_localqueues_crc=0xfa2ffa59,
    describe_crc=0xb70a06c2, pods_crc=0x53d3eb4d, get_crc=0x9d1a9266,
    explain_crc=0xc938df13, status_crc=0x9a102339)


def jax_kit():
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False, **kw: JEngine(
                      enable_fair_sharing=fair, **kw),
                  lambda eng: eng.attach_oracle(), replay=jreplay,
                  client=jclient, kueuectl=jkueuectl, http_server=jhttp,
                  journal=jjournal)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for pkg, kit, device in (("jax", jax_kit(), None),
                             ("port", ew.port_kit("cpu"), "cpu")):
        work = tmp_path_factory.mktemp(f"client_{pkg}")
        out[pkg] = (cw.run(cw.SMALL["client_world"], kit=kit,
                           work=str(work), device=device), work)
    return out


def test_small_world_pinned(runs):
    assert cw.pinned(runs["jax"][0]) == SMALL_EXPECT
    assert cw.pinned(runs["port"][0]) == SMALL_EXPECT


def test_small_world_events_and_workloads(runs):
    (j, _), (p, _) = runs["jax"], runs["port"]
    assert p["pipeline"] == j["pipeline"]
    jeng, peng = j["engines"][0], p["engines"][0]
    assert events(peng) == events(jeng)
    assert list(peng.workloads) == list(jeng.workloads)
    for key, wl in jeng.workloads.items():
        pw = peng.workloads[key]
        assert outcome(pw) == outcome(wl), key
        assert (pw.priority, pw.queue_name) == (wl.priority,
                                                wl.queue_name), key
    assert {k: lq.stop_policy.value for k, lq in
            peng.queues.local_queues.items()} == \
        {k: lq.stop_policy.value for k, lq in
         jeng.queues.local_queues.items()}
    assert {n: cq.cohort for n, cq in peng.cache.cluster_queues.items()} \
        == {n: cq.cohort for n, cq in jeng.cache.cluster_queues.items()}


def test_small_world_journals_and_traces(runs):
    (j, jwork), (p, pwork) = runs["jax"], runs["port"]
    jdata = (jwork / "journal.jsonl").read_bytes()
    pdata = (pwork / "journal.jsonl").read_bytes()
    assert b'"delete"' in pdata and b'"cq-new"' in pdata
    assert pdata == jdata
    from kueue_tpu_torch.bench import replay_world as rw
    assert rw.masked_frames(str(pwork / "client_world.trace.jsonl")) == \
        rw.masked_frames(str(jwork / "client_world.trace.jsonl"))


def test_informers_and_replay_engine(runs):
    for r, _ in runs.values():
        assert r["informer_late_crc"] == r["informer_crc"]
        rep = r["replay"]
        ps = rep["pipeline_stats"]
        assert r["replay_dispatched"] == \
            rep["on_device"] - ps["used"] + ps["speculated"] > 0
        assert r["remote_rows"] == [2500, 2400]
        assert r["explained"] == ["fits"] * cw.EXPLAINED


def test_world_drives_every_path():
    """The pinned runs exercise what the world is for: device cycles
    after the re-keys and moves, conflicts, both stop evictions,
    deletes, the fan-out over every ClusterQueue and a byte-identical
    replay of a trace on the device path."""
    for want in (SMALL_EXPECT, chip_smoke.CLIENT_EXPECT):
        assert want["on_device"] == want["cycles"] > 0
        assert want["conflicts"] == cw.CONFLICTS
        assert want["evicted"]["ClusterQueueStopped"] > 0
        assert want["evicted"]["LocalQueueStopped"] > 0
        assert want["replay"]["rc"] == 0
        assert want["replay"]["recorded"] == want["replay"]["replayed"]
        assert want["replay"]["on_device"] == want["replay"]["cycles"] > 0
        for k in ("rekeys", "moves", "moved_new", "deleted", "cqs_fanned",
                  "journal_records", "trace_events"):
            assert want[k] > 0, k


@pytest.mark.slow
def test_full_run_matches_chip_smoke(tmp_path):
    got = cw.pinned(cw.run(cw.FULL["client_world"], kit=jax_kit(),
                           work=str(tmp_path)))
    print(f"client_world: {got}")
    assert got == chip_smoke.CLIENT_EXPECT
