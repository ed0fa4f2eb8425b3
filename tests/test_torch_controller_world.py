"""The controllers world of chip_smoke.py phase 32 (kueue_tpu_torch/
bench/controller_worlds.py) recomputed on the CPU.

At SMALL size (2,500 entries over 50 ClusterQueues, 10 of them with a
spot flavor, 1,340 imported workloads, 9 cycles on the default loop)
both packages build and drive the world, each with a journal attached
once it is built: the pinned numbers (cycles, admissions, the decision
checksum, device / hybrid / fallback cycles, evictions by reason,
pipeline_stats, the controllers' counts and the status checksums) equal
the ones pinned here, the event streams, ``pipeline_stats`` after every
cycle and the final workloads equal, and the journals are
byte-identical (the uid counters start at one value in both, ROADMAP
trap (a)). At full size (FULL) the JAX engine alone must give the
numbers chip_smoke.py pins (slow). Exact throughout."""

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.config import api as japi
from kueue_tpu.controllers import booster as jbooster
from kueue_tpu.controllers import concurrentadmission as jconcurrent
from kueue_tpu.controllers import importer as jimporter
from kueue_tpu.controllers import podsready as jpodsready
from kueue_tpu.controllers import populator as jpopulator
from kueue_tpu.controllers import status as jstatus
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch.bench import controller_worlds as cw
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.store import journal as pjournal
from test_torch_engine import outcome

SMALL_EXPECT = dict(
    cycles=9, admitted=445, preempting=0, preemptions=0,
    checksum=0xa846e053, on_device=9, hybrid=3, fallback=0, overridden=0,
    evicted={"ConcurrentAdmissionLost": 4, "PodsReadyTimeout": 167,
             "RequeuingLimitExceeded": 38},
    pipeline_stats=dict(speculated=5, used=0, discarded=5, skipped=4),
    pods_ready_timeout=167, requeuing_limit=38, deleted=102,
    boost_set=1384, boosted=8810, created_variant=48,
    deactivated_variant=6, migrations=4, imported=1340, skipped=10,
    populated=50, status_crc=0x01223882, reconcile_crc=0xc3761757)


def jax_kit():
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False, **kw: JEngine(
                      enable_fair_sharing=fair, **kw),
                  lambda eng: eng.attach_oracle(),
                  config_api=japi, podsready=jpodsready, status=jstatus,
                  booster=jbooster, concurrentadmission=jconcurrent,
                  importer=jimporter, populator=jpopulator)


def _run(kit, jmod, path):
    pipeline = []
    r = cw.run(cw.SMALL["controllers_world"], kit=kit,
               on_built=lambda eng: jmod.attach_new_journal(eng, path),
               on_cycle=lambda k, eng: pipeline.append(
                   dict(eng.oracle.pipeline_stats)))
    r["engines"][0].journal.close()
    r["after_cycle"] = pipeline
    return r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("controllers")
    out = {}
    for pkg, kit, jmod in (("jax", jax_kit(), jjournal),
                           ("port", ew.port_kit("cpu"), pjournal)):
        path = str(d / f"{pkg}.jsonl")
        out[pkg] = (_run(kit, jmod, path), path)
    return out


def events(eng):
    return [(e.time, e.kind, e.workload, e.cluster_queue, e.detail)
            for e in eng.events]


def test_small_world_pinned(runs):
    assert cw.pinned(runs["jax"][0]) == SMALL_EXPECT
    assert cw.pinned(runs["port"][0]) == SMALL_EXPECT


def test_small_world_events_and_workloads(runs):
    (j, _), (p, _) = runs["jax"], runs["port"]
    assert p["after_cycle"] == j["after_cycle"]
    assert p["pipeline"] == j["pipeline"]
    jeng, peng = j["engines"][0], p["engines"][0]
    assert events(peng) == events(jeng)
    assert list(peng.workloads) == list(jeng.workloads)
    for key, wl in jeng.workloads.items():
        pw = peng.workloads[key]
        assert outcome(pw) == outcome(wl), key
        assert (pw.priority_boost, pw.annotations) == \
            (wl.priority_boost, wl.annotations), key
    assert sorted(peng.queues.local_queues) == \
        sorted(jeng.queues.local_queues)
    for fam in ("cluster_queue_status", "local_queue_status",
                "ready_wait_time_seconds_total"):
        pf = getattr(peng.registry, "gauge" if "status" in fam
                     else "counter")(fam)
        jf = getattr(jeng.registry, "gauge" if "status" in fam
                     else "counter")(fam)
        assert pf.values == jf.values, fam


def test_small_world_journals_byte_identical(runs):
    jdata = open(runs["jax"][1], "rb").read()
    pdata = open(runs["port"][1], "rb").read()
    assert b'"kueue.x-k8s.io/priority-boost"' in pdata
    assert b'"delete"' in pdata
    assert pdata == jdata


def test_world_drives_every_path():
    """The pinned runs exercise what the world is for: device cycles,
    both pods-ready evictions, retention deletes, boosts, variants, their
    deactivation and a migration, imported and skipped pods and the
    populator's LocalQueues."""
    for want in (SMALL_EXPECT, chip_smoke.CONTROLLERS_EXPECT):
        assert want["on_device"] == want["cycles"] > 0
        for k in ("pods_ready_timeout", "requeuing_limit", "deleted",
                  "boost_set", "boosted", "created_variant",
                  "deactivated_variant", "migrations", "imported",
                  "skipped", "populated"):
            assert want[k] > 0, k


@pytest.mark.slow
def test_full_run_matches_chip_smoke():
    got = cw.pinned(cw.run(cw.FULL["controllers_world"], kit=jax_kit()))
    print(f"controllers_world: {got}")
    assert got == chip_smoke.CONTROLLERS_EXPECT
