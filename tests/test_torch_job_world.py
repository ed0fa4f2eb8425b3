"""The job world of chip_smoke.py phase 31 (kueue_tpu_torch/bench/
job_worlds.py) recomputed on the CPU.

At SMALL size (2,500 entries over 50 ClusterQueues, 10 StatefulSets, 3
cycles on the default loop) both packages build and drive the world,
each with a journal attached once it is built: the pinned numbers
(cycles, admissions, the decision checksum, device / hybrid / fallback
cycles, evictions, pipeline_stats and the Inadmissible, JobRejected,
OnHold and HoldCleared events, the started and succeeded jobs) equal
the ones pinned here, the event streams and ``pipeline_stats`` after
every cycle equal, and the journals are byte-identical (the uid and
workload-name counters start at one value in both, ROADMAP trap (a)).
The templated and held workloads of those journals come back from a
rebuild, through a sealed checkpoint and through an HA promotion, in
each package alike. At full size (FULL) the JAX engine alone must give
the numbers chip_smoke.py pins (slow). Exact throughout."""

import shutil

import pytest

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers import integrations as jint
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.ha import replica as jreplica
from kueue_tpu.store import checkpoint as jcheckpoint
from kueue_tpu.store import journal as jjournal
from kueue_tpu.utils import limitrange as jlr
from kueue_tpu.utils import podtemplate as jpt
from kueue_tpu.webhooks import jobwebhooks as jwh
from kueue_tpu_torch import carry
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import job_worlds as jw
from kueue_tpu_torch.ha import replica as preplica
from kueue_tpu_torch.store import checkpoint as pcheckpoint
from kueue_tpu_torch.store import journal as pjournal
from test_torch_engine import outcome

SMALL_EXPECT = dict(
    cycles=3, admitted=150, preempting=0, preemptions=0,
    checksum=0x5850406f, on_device=3, hybrid=0, fallback=0, overridden=0,
    evicted=0, pipeline_stats=dict(speculated=2, used=0, discarded=2,
                                   skipped=1),
    inadmissible=5, job_rejected=7, on_hold=10, hold_cleared=10,
    started=85, succeeded=19)


def jax_kit():
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle(), jobframework=jjf,
                  integrations=jint, webhooks=jwh, podtemplate=jpt,
                  limitrange=jlr)


def _run(kit, jmod, path):
    pipeline = []
    r = jw.run(jw.SMALL["jobs_world"], kit=kit,
               on_built=lambda eng: jmod.attach_new_journal(eng, path),
               on_cycle=lambda k, eng: pipeline.append(
                   dict(eng.oracle.pipeline_stats)))
    r["engines"][0].journal.close()
    r["after_cycle"] = pipeline
    return r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jobs")
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
    assert jw.pinned(runs["jax"][0]) == SMALL_EXPECT
    assert jw.pinned(runs["port"][0]) == SMALL_EXPECT


def test_small_world_events_and_pipeline(runs):
    (j, _), (p, _) = runs["jax"], runs["port"]
    assert p["after_cycle"] == j["after_cycle"]
    assert p["pipeline"] == j["pipeline"]
    assert events(p["engines"][0]) == events(j["engines"][0])
    jeng, peng = j["engines"][0], p["engines"][0]
    assert sorted(peng.workloads) == sorted(jeng.workloads)
    for key, wl in jeng.workloads.items():
        pw = peng.workloads[key]
        assert outcome(pw) == outcome(wl), key
        assert pw.pod_sets[0].requests == wl.pod_sets[0].requests, key


def test_small_world_journals_byte_identical(runs):
    jdata = open(runs["jax"][1], "rb").read()
    pdata = open(runs["port"][1], "rb").read()
    assert b'"PodTemplate"' in pdata and b'"OnHold"' in pdata
    assert pdata == jdata


def test_world_drives_every_path():
    """The pinned runs exercise what the world is for: device cycles,
    refused templates and jobs, holds and their clearing, started and
    succeeded jobs, and discarded speculations after the finishes."""
    for want in (SMALL_EXPECT, chip_smoke.JOBS_EXPECT):
        assert want["on_device"] == want["cycles"] > 0
        for k in ("inadmissible", "job_rejected", "on_hold",
                  "hold_cleared", "started", "succeeded"):
            assert want[k] > 0, k
        assert want["pipeline_stats"]["discarded"] > 0


def _restored(eng) -> dict:
    """The templated workloads and StatefulSet workloads of an engine:
    their templates, per-pod requests, activity, admission and hold."""
    out = {}
    for key, wl in eng.workloads.items():
        ps = wl.pod_sets[0]
        if ps.template is None and not key.startswith("default/serve-"):
            continue
        out[key] = (carry.api_object(ps.template), dict(ps.requests),
                    wl.active, wl.is_admitted, eng.is_on_hold(wl))
    return out


def test_templates_and_holds_restored(runs, tmp_path):
    """The journals rebuild in each package to the same templated,
    inactive and held workloads; a sealed checkpoint of the rebuilt
    engine restores them again (the rebuild comes through it); and an
    HA replica promoted on a copy of the journal holds them too."""
    got = {}
    for pkg, jmod, ckpt, rep, kw in (
            ("jax", jjournal, jcheckpoint, jreplica, {}),
            ("port", pjournal, pcheckpoint, preplica, {"device": "cpu"})):
        path = runs[pkg][1]
        copy = str(tmp_path / f"{pkg}.jsonl")
        shutil.copy(path, copy)
        eng = jmod.rebuild_engine(copy, **kw)
        restored = _restored(eng)
        assert any(v[0] is not None for v in restored.values())
        assert any(not v[2] for v in restored.values())
        ckpt.CheckpointStore.for_journal(copy).write(eng)
        eng.journal.close()
        again = jmod.rebuild_engine(copy, **kw)
        assert getattr(again, "rebuild_source", "checkpoint") == \
            "checkpoint"  # the port's rebuild says where it came from
        assert _restored(again) == restored
        again.journal.close()
        ha = str(tmp_path / f"{pkg}-ha.jsonl")
        shutil.copy(path, ha)
        replica = rep.HAReplica(ha, ha + ".lease", "b", lease_duration=3.0,
                                renew_in_background=False,
                                **({"engine_kwargs": kw} if kw else {}))
        assert replica.step(0.0) == "leader"
        assert _restored(replica.engine) == restored
        got[pkg] = restored
    assert got["port"] == got["jax"]


@pytest.mark.slow
def test_full_run_matches_chip_smoke():
    got = jw.pinned(jw.run(jw.FULL["jobs_world"], kit=jax_kit()))
    print(f"jobs_world: {got}")
    assert got == chip_smoke.JOBS_EXPECT
