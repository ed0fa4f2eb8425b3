"""The port's journal (kueue_tpu_torch/store/journal.py, api/serde.py,
api/conversion.py) and its engine's journaling, against the JAX
package's: mirrored engines write byte-identical journals, each package
rebuilds the other's journal to the same state (``dump_state`` on both
sides), ``apply_many`` writes what repeated ``apply`` writes, torn tails
are repaired as the JAX package repairs them, ``JournalConflict`` fires
as there, and a child process SIGKILLed mid-drain leaves a journal whose
rebuild and drain give the same state in both packages. Exact
throughout."""

import contextlib
import itertools
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time

import pytest

from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.cli import kueuectl as jkueuectl
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.store import journal as jjournal
from kueue_tpu.visibility import server as jvis
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.cli import kueuectl as pkueuectl
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.store import journal as pjournal
from kueue_tpu_torch.visibility import server as pvis


@pytest.fixture(scope="module")
def kits():
    """(JAX kit, port kit on the CPU); the JAX bridge on the serial
    cycle loop the port runs (ROADMAP trap (u))."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUEUE_TPU_PIPELINE", "0")
        yield (ew.Kit(jtypes, jscenario,
                      lambda fair=False: JEngine(enable_fair_sharing=fair),
                      lambda eng: eng.attach_oracle()),
               ew.port_kit("cpu"))


@contextlib.contextmanager
def aligned_uids():
    """Both packages draw workload uids from a module counter; mirrored
    worlds start both at one value (and the counters are restored)."""
    old = (jtypes._uid_counter, ptypes._uid_counter)
    jtypes._uid_counter = itertools.count(90_000_001)
    ptypes._uid_counter = itertools.count(90_000_001)
    try:
        yield
    finally:
        jtypes._uid_counter, ptypes._uid_counter = old


def comparable(dump: dict) -> dict:
    """dump_state without its wall-clock phases and the JAX package's
    unadmitted gauges (the port has no tracker)."""
    return {k: v for k, v in dump.items()
            if k not in ("lastCyclePhases", "unadmittedByReason")}


# -- mirrored worlds: each built, journaled and driven by one package --

def _serve_small(kit, jmod, path):
    eng = sw.build_world(sw.SMALL, kit)
    jmod.attach_new_journal(eng, path)
    kit.attach(eng)
    for wl in sw.arrivals(sw.SMALL, kit):
        eng.submit(wl)
    sw.drain_in_process(eng)
    return eng


def _preempt_churn(kit, jmod, path):
    eng = ew.preempt_churn_engine(
        60, n_cohorts=2, kit=kit,
        on_attach=lambda e: jmod.attach_new_journal(e, path))
    ew._drain_engine(eng)
    for key in sorted(k for k, w in eng.workloads.items()
                      if w.is_admitted)[:7]:
        eng.finish(key)
    eng.tick(1.0)
    ew._drain_engine(eng)
    return eng


def _multiflavor(kit, jmod, path):
    eng = ew.multiflavor_engine(random.Random(1000), kit=kit)
    jmod.attach_new_journal(eng, path)
    ew.multiflavor_churn(eng, random.Random(0), kit=kit)
    return eng


WORLDS = {"serve_small": _serve_small, "preempt_churn": _preempt_churn,
          "multiflavor": _multiflavor}


@pytest.fixture(scope="module")
def mirrored(kits, tmp_path_factory):
    """Each world run once per package: {world: {pkg: (engine, path)}}."""
    jkit, pkit = kits
    d = tmp_path_factory.mktemp("mirrored")
    out = {}
    for name, build in WORLDS.items():
        out[name] = {}
        for pkg, kit, jmod in (("jax", jkit, jjournal),
                               ("port", pkit, pjournal)):
            path = str(d / f"{name}-{pkg}.jsonl")
            with aligned_uids():
                eng = build(kit, jmod, path)
            eng.journal.close()
            out[name][pkg] = (eng, path)
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_mirrored_journals_byte_identical(mirrored, world):
    (_, jpath), (_, ppath) = (mirrored[world]["jax"],
                              mirrored[world]["port"])
    jdata, pdata = open(jpath, "rb").read(), open(ppath, "rb").read()
    assert len(pdata.splitlines()) > 50
    assert pdata == jdata


def test_mirrored_worlds_write_every_transition(mirrored):
    """The worlds exercise what they are for: admissions in every world,
    evictions, preemptions and finishes in the churn, finishes in the
    multi-flavor world."""
    def reasons(path):
        seen = set()
        for line in open(path):
            rec = json.loads(line)
            if rec["kind"] == "workload":
                for c in rec["obj"]["status"]["conditions"].values():
                    if c["status"]:
                        seen.add(c["type"]["v"])
        return seen
    assert {"Admitted", "QuotaReserved"} <= reasons(
        mirrored["serve_small"]["port"][1])
    assert {"Evicted", "Preempted", "Finished"} <= reasons(
        mirrored["preempt_churn"]["port"][1])
    assert "Finished" in reasons(mirrored["multiflavor"]["port"][1])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_cross_rebuild(mirrored, tmp_path, world, direction):
    """Each package rebuilds the other's journal to the live engine's
    state, compared by dump_state on both sides."""
    src_pkg = "jax" if direction == "jax-to-port" else "port"
    live, path = mirrored[world][src_pkg]
    copy = str(tmp_path / "copy.jsonl")
    shutil.copy(path, copy)
    if direction == "jax-to-port":
        eng = pjournal.rebuild_engine(copy, device="cpu")
        got, want = pvis.dump_state(eng), jvis.dump_state(live)
    else:
        eng = jjournal.rebuild_engine(copy)
        got, want = jvis.dump_state(eng), pvis.dump_state(live)
    eng.journal.close()
    got, want = comparable(got), comparable(want)
    assert got["admitted"] == want["admitted"]
    # A rebuild re-activates parked workloads (restore_workload), so the
    # pending sets compare as active + inadmissible per queue.
    assert {q: sorted(v["active"] + v["inadmissible"])
            for q, v in got["queues"].items()} == \
        {q: sorted(v["active"] + v["inadmissible"])
         for q, v in want["queues"].items()}
    assert sw.checksum(*sw.engine_views(
        eng, jvis.dump_state if src_pkg == "port" else pvis.dump_state,
        jkueuectl if src_pkg == "port" else pkueuectl)) == \
        sw.checksum(*sw.engine_views(
            live, pvis.dump_state if src_pkg == "port" else jvis.dump_state,
            pkueuectl if src_pkg == "port" else jkueuectl))


def test_rebuilds_agree_with_each_other(mirrored, tmp_path):
    """Both packages rebuild the same (port) journal to equal dumps,
    queues included."""
    _, path = mirrored["preempt_churn"]["port"]
    dumps = []
    for i, mod in enumerate((jjournal, pjournal)):
        copy = str(tmp_path / f"c{i}.jsonl")
        shutil.copy(path, copy)
        kw = {"device": "cpu"} if mod is pjournal else {}
        eng = mod.rebuild_engine(copy, **kw)
        vis = pvis if mod is pjournal else jvis
        dumps.append(comparable(vis.dump_state(eng)))
        eng.journal.close()
    assert dumps[0] == dumps[1]


# -- the journal itself --

def _objs(t):
    wls = [t.Workload(name=f"w{i}", queue_name="lq", uid=f"u{i}",
                      pod_sets=(t.PodSet("main", 1, {"cpu": 100 * i}),))
           for i in range(4)]
    return [wls[0], wls[1], wls[0], wls[2], wls[3], wls[1], wls[0]]


def test_apply_many_equals_repeated_apply(tmp_path):
    gens = {}
    data = {}
    for name, mod, t in (("port-many", pjournal, ptypes),
                         ("port-one", pjournal, ptypes),
                         ("jax-many", jjournal, jtypes)):
        path = str(tmp_path / f"{name}.jsonl")
        j = mod.Journal(path)
        j.apply("cohort", t.Cohort("co"), ts=1.0)
        if name.endswith("many"):
            gens[name] = j.apply_many("workload", _objs(t), ts=2.5)
        else:
            gens[name] = [j.apply("workload", o, ts=2.5) for o in _objs(t)]
        j.close()
        data[name] = open(path, "rb").read()
    assert gens["port-many"] == gens["port-one"] == gens["jax-many"] == \
        [1, 1, 2, 1, 1, 2, 3]
    assert data["port-many"] == data["port-one"] == data["jax-many"]
    assert pjournal.Journal(str(tmp_path / "port-many.jsonl")) \
        .apply_many("workload", []) == []


TORN = {
    "fragment": b'{"op": "apply", "kind": "workl',
    "corrupt line": b'{"op": "apply", "kind": \n',
    "record missing its newline": None,  # filled in by the test
}


@pytest.mark.parametrize("case", list(TORN))
def test_torn_tail_repair_matches_jax(tmp_path, case):
    base = str(tmp_path / "base.jsonl")
    j = pjournal.Journal(base)
    for i in range(3):
        j.apply("cohort", ptypes.Cohort(f"co{i}"), ts=float(i))
    j.close()
    good = open(base, "rb").read()
    tail = TORN[case]
    if tail is None:
        tail = good.splitlines(keepends=True)[-1].rstrip(b"\n")
        good = b"".join(good.splitlines(keepends=True)[:-1])
    files = {}
    for name, mod in (("port", pjournal), ("jax", jjournal)):
        path = str(tmp_path / f"{name}.jsonl")
        with open(path, "wb") as fh:
            fh.write(good + tail)
        if name == "port":
            # Replay, before any repair, reads the three complete
            # records and skips a torn line.
            assert sum(1 for _ in pjournal.read_records(path)) == 3
        j = mod.Journal(path)  # opening repairs under flock
        j.apply("cohort", ptypes.Cohort("after")
                if name == "port" else jtypes.Cohort("after"), ts=9.0)
        j.close()
        files[name] = open(path, "rb").read()
        recs = list(mod.Journal(path).replay())
        assert len(recs) == 4
        assert [r["obj"]["name"] for r in recs][-1] == "after"
        assert all(line.strip() for line in
                   files[name].decode().splitlines())
    assert files["port"] == files["jax"]


def test_corruption_before_the_tail_raises(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = pjournal.Journal(path)
    j.apply("cohort", ptypes.Cohort("a"))
    j.close()
    with open(path, "ab") as fh:
        fh.write(b"not json\n")
    data = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(data + b'{"op": "delete", "kind": "cohort", "key": "a"}\n')
    with pytest.raises(pjournal.JournalCorruption):
        list(pjournal.Journal(path).replay())
    with pytest.raises(jjournal.JournalCorruption):
        list(jjournal.Journal(path).replay())


def test_journal_conflict(tmp_path):
    """Two handles on one file: each append refreshes from the file, so
    a stale expected generation raises, as in the JAX package."""
    path = str(tmp_path / "j.jsonl")
    a, b = pjournal.Journal(path), pjournal.Journal(path)
    cq = ptypes.ClusterQueue(name="cq")
    assert a.apply("cluster_queue", cq, expected_generation=0) == 1
    seen = b.generation_of("cluster_queue", "cq")
    assert seen == 1
    assert b.apply("cluster_queue", cq, expected_generation=seen) == 2
    with pytest.raises(pjournal.JournalConflict) as e:
        a.apply("cluster_queue", cq, expected_generation=1)
    assert (e.value.kind, e.value.key, e.value.expected, e.value.found) == \
        ("cluster_queue", "cq", 1, 2)
    assert a.apply("cluster_queue", cq, expected_generation=2) == 3
    assert b.delete("cluster_queue", "cq", expected_generation=3) == 4
    # The JAX package's handle reads the same generations.
    assert jjournal.Journal(path).generation_of("cluster_queue", "cq") == 4
    for h in (a, b):
        h.close()


_CHILD = r"""
import sys
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.store.journal import rebuild_engine
eng = rebuild_engine(sys.argv[1], device="cpu")
eng.attach_oracle(device="cpu")
for wl in sw.arrivals(sw.SMALL):
    eng.submit(wl)
print("draining", flush=True)
sw.drain_in_process(eng)
print("done", flush=True)
"""


def test_sigkill_mid_drain_rebuilds_alike(kits, tmp_path):
    """A child process drains the journaled small world and is SIGKILLed
    once the journal has grown; a torn fragment is appended; both
    packages rebuild the same file, repair it, and drain to the same
    final state."""
    jkit, _ = kits
    path = str(tmp_path / "j.jsonl")
    seeded = sw.seed_journal(path, sw.SMALL)
    env = dict(os.environ, PYTHONPATH=str(sw.REPO))
    child = subprocess.Popen([sys.executable, "-c", _CHILD, path],
                             cwd=sw.REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    while os.path.getsize(path) < seeded["bytes"] + 150_000:
        assert child.poll() is None, child.communicate()
        assert time.monotonic() < deadline
        time.sleep(0.005)
    child.send_signal(signal.SIGKILL)
    child.wait()
    with open(path, "ab") as fh:
        fh.write(b'{"op": "apply", "kind": "workload", "ts": 1')
    before = sw.journal_state(path)
    states = {}
    for name, mod, vis, ctl in (("port", pjournal, pvis, pkueuectl),
                                ("jax", jjournal, jvis, jkueuectl)):
        copy = str(tmp_path / f"{name}.jsonl")
        shutil.copy(path, copy)
        if name == "port":
            eng = mod.rebuild_engine(copy, device="cpu")
            eng.attach_oracle(device="cpu")
        else:
            eng = mod.rebuild_engine(copy)
            eng.attach_oracle()
        for wl in sw.arrivals(sw.SMALL, ew.port_kit("cpu") if name == "port"
                              else jkit):
            if wl.key not in eng.workloads:
                eng.submit(wl)
        sw.drain_in_process(eng)
        eng.journal.close()
        assert not sw.torn_tail(copy)
        views = sw.engine_views(eng, vis.dump_state, ctl)
        states[name] = (sw.final_state(*views),
                        comparable(vis.dump_state(eng)))
        after = sw.journal_state(copy)
        assert before["admitted"] <= after["admitted"]
        assert max(after["transitions"].values()) == 1
    assert states["port"] == states["jax"]
    assert 0 < len(before["admitted"]) < states["port"][0]["admitted"]


# -- the cycle boundary, compaction and restarts under load, in both
#    packages (tests/test_durability.py, tests/test_restart_under_load.py)

PKGS = {"jax": (jtypes, JEngine, jjournal, {}),
        "port": (ptypes, lambda: PEngine(device="cpu"), pjournal,
                 {"device": "cpu"})}


def _three_queues(eng, t, preemption=False):
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    for c in range(3 if preemption else 1):
        eng.create_cohort(t.Cohort(f"co{c}" if preemption else "co"))
    for i in range(9 if preemption else 3):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", cohort=f"co{i % 3}" if preemption else "co",
            preemption=t.ClusterQueuePreemption(
                within_cluster_queue=t.PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=t.PreemptionPolicy.LOWER_PRIORITY)
            if preemption else t.ClusterQueuePreemption(),
            resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas(
                    "default", {"cpu": t.ResourceQuota(
                        4000 if preemption else 2000)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq{i}", "default", f"cq{i}"))


def fingerprint(eng) -> dict:
    wls = {key: (wl.is_admitted, wl.is_evicted, wl.is_finished,
                 wl.status.requeue_count, wl.status.requeue_at,
                 None if wl.status.admission is None else
                 [(psa.name, sorted(psa.flavors.items()), psa.count)
                  for psa in wl.status.admission.pod_set_assignments])
           for key, wl in sorted(eng.workloads.items())}
    usage = {name: sorted((str(fr), v) for fr, v in u.items() if v)
             for name, u in sorted(eng.cache.cq_usage.items()) if u}
    return json.loads(json.dumps({"workloads": wls, "usage": usage}))


def test_sync_on_cycle_boundary(tmp_path):
    """A non-idle cycle syncs (flush + fsync) what it appended; an idle
    cycle leaves the journal alone: the same dirty flags in both."""
    logs = {}
    for name, (t, engine, jmod, _kw) in PKGS.items():
        eng = engine()
        _three_queues(eng, t)
        journal = jmod.attach_new_journal(eng, str(tmp_path / name))
        journal.sync()
        with aligned_uids():
            eng.submit(t.Workload(name="w", queue_name="lq0",
                                  pod_sets=(t.PodSet("main", 1,
                                                     {"cpu": 500}),)))
        log = [journal._dirty]
        log.append(eng.schedule_once() is not None)
        log.append(journal._dirty)
        log.append(eng.schedule_once() is None)
        log.append(journal._dirty)
        journal.close()
        logs[name] = log
    assert logs["port"] == logs["jax"] == [True, True, False, True, False]
    assert open(tmp_path / "port", "rb").read() == \
        open(tmp_path / "jax", "rb").read()


def test_compact_preserves_rebuild(tmp_path):
    """compact() keeps the last record per key in first-seen order under
    a new lineage: the compacted files are byte-identical, shorter, and
    rebuild (in either package) to the state before compaction."""
    got = {}
    for name, (t, engine, jmod, _kw) in PKGS.items():
        eng = engine()
        _three_queues(eng, t)
        path = str(tmp_path / f"{name}.jsonl")
        journal = jmod.attach_new_journal(eng, path)
        with aligned_uids():
            for i in range(6):
                eng.clock += 1
                eng.submit(t.Workload(
                    name=f"w{i}", queue_name=f"lq{i % 3}",
                    pod_sets=(t.PodSet("main", 1, {"cpu": 600}),)))
                eng.schedule_once()
        eng.finish("default/w0")
        n_before = sum(1 for _ in journal.replay())
        journal.compact()
        n_after = sum(1 for _ in journal.replay())
        assert n_after < n_before
        journal.close()
        got[name] = (fingerprint(eng), n_before, n_after, journal.lineage)
    assert got["port"] == got["jax"]
    data = {n: open(tmp_path / f"{n}.jsonl", "rb").read() for n in PKGS}
    assert data["port"] == data["jax"]
    assert data["port"].startswith(b'{"op": "meta"')
    for name, (_t, _engine, jmod, kw) in PKGS.items():
        for src in PKGS:
            copy = str(tmp_path / f"{name}-of-{src}.jsonl")
            shutil.copy(tmp_path / f"{src}.jsonl", copy)
            reb = jmod.rebuild_engine(copy, **kw)
            assert fingerprint(reb) == got["jax"][0]
            reb.journal.close()


def _churn_engine(t, engine, jmod, path=None):
    """tests/test_restart_under_load.py's world, stopped mid-churn:
    preemptions issued, victims evicted, replacements pending."""
    rng = random.Random(3)
    eng = engine()
    _three_queues(eng, t, preemption=True)
    if path:
        jmod.attach_new_journal(eng, path)
    for i in range(24):
        eng.clock += 0.01
        eng.submit(t.Workload(
            name=f"low{i}", queue_name=f"lq{rng.randrange(9)}", priority=0,
            pod_sets=(t.PodSet("main", 1, {"cpu": 1000}),)))
    for _ in range(6):
        eng.schedule_once()
    for i in range(18):
        eng.clock += 0.01
        eng.submit(t.Workload(
            name=f"high{i}", queue_name=f"lq{rng.randrange(9)}",
            priority=10, pod_sets=(t.PodSet("main", 1, {"cpu": 2000}),)))
    for _ in range(2):
        eng.schedule_once()
        eng.tick(0.0)
    return eng


def _drain_churn(eng, cycles=60):
    for _ in range(cycles):
        r = eng.schedule_once()
        if r is None:
            break
        if r.stats.preempting:
            eng.tick(0.0)
        elif not r.stats.admitted:
            break


def test_restart_mid_churn_preserves_state_and_progress(tmp_path):
    """A crash mid-churn with a torn record: each package's rebuild holds
    the live state, and its drain admits more of the high-priority wave,
    to the same state in both."""
    got = {}
    for name, (t, engine, jmod, kw) in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        with aligned_uids():
            live = _churn_engine(t, engine, jmod, path)
        live.journal.close()
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"op": "apply", "kind": "workload", "ts": 9.9, "obj"')
        rebuilt = jmod.rebuild_engine(path, **kw)
        assert fingerprint(rebuilt) == fingerprint(live)
        before = sum(1 for wl in rebuilt.workloads.values()
                     if wl.priority == 10 and wl.is_admitted)
        _drain_churn(rebuilt)
        after = sum(1 for wl in rebuilt.workloads.values()
                    if wl.priority == 10 and wl.is_admitted)
        assert after > before
        rebuilt.journal.close()
        got[name] = (fingerprint(live), fingerprint(rebuilt), before, after)
    assert got["port"] == got["jax"]
    assert open(tmp_path / "port.jsonl", "rb").read() == \
        open(tmp_path / "jax.jsonl", "rb").read()


def test_restart_matches_uncrashed_continuation(tmp_path):
    """Crash, rebuild and drain land where the never-crashed engine's
    drain lands, in both packages alike."""
    got = {}
    for name, (t, engine, jmod, kw) in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        with aligned_uids():
            crashed = _churn_engine(t, engine, jmod, path)
        crashed.journal.close()
        with aligned_uids():
            reference = _churn_engine(t, engine, jmod)
        rebuilt = jmod.rebuild_engine(path, **kw)
        _drain_churn(rebuilt)
        _drain_churn(reference)
        assert fingerprint(rebuilt) == fingerprint(reference)
        rebuilt.journal.close()
        got[name] = fingerprint(rebuilt)
    assert got["port"] == got["jax"]


def test_capture_points_fire_in_the_jax_order(tmp_path):
    """pre_cycle_hooks, then the cycle, then (after a non-idle cycle)
    pre_sync_hooks before the journal's sync, then cycle_listeners with
    None for an idle cycle; a raising hook or listener becomes a warning
    and the next one still runs."""
    logs = {}
    for name, (t, engine, jmod, _kw) in PKGS.items():
        eng = engine()
        _three_queues(eng, t)
        journal = jmod.attach_new_journal(eng, str(tmp_path / name))
        log = []
        real_sync = journal.sync
        journal.sync = lambda: (log.append("sync"), real_sync())

        def boom(seq, result):
            raise RuntimeError("observer")

        eng.pre_cycle_hooks.append(
            lambda seq, e: log.append(("pre", seq, e is eng)))
        eng.pre_sync_hooks.extend([boom, lambda seq, r: log.append(
            ("pre_sync", seq, r is not None))])
        eng.cycle_listeners.extend([boom, lambda seq, r: log.append(
            ("listener", seq, r is None))])
        with aligned_uids():
            eng.submit(t.Workload(name="w", queue_name="lq0",
                                  pod_sets=(t.PodSet("main", 1,
                                                     {"cpu": 500}),)))
        with pytest.warns(UserWarning) as caught:
            eng.schedule_once()
            eng.schedule_once()
        log.append(sorted({str(w.message).split(" ")[0] for w in caught}))
        log.append((eng.cycle_seq, eng.checkpointer))
        journal.close()
        logs[name] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"][:4] == [("pre", 0, True), ("pre_sync", 0, True),
                                "sync", ("listener", 0, False)]


def test_meta_lines_are_skipped(tmp_path):
    """A rotated active file starts with a meta line: read_records and
    engine_from_records skip it, as the JAX replay does."""
    path = str(tmp_path / "j.jsonl")
    eng = PEngine(device="cpu")
    pjournal.attach_new_journal(eng, path, rotate_records=3)
    _three_queues(eng, ptypes)
    with aligned_uids():
        eng.submit(ptypes.Workload(name="w", queue_name="lq0",
                                   pod_sets=(ptypes.PodSet(
                                       "main", 1, {"cpu": 500}),)))
        eng.schedule_once()
        eng.submit(ptypes.Workload(name="v", queue_name="lq1",
                                   pod_sets=(ptypes.PodSet(
                                       "main", 1, {"cpu": 500}),)))
    eng.journal.close()
    assert open(path, "rb").readline().startswith(b'{"op": "meta"')
    recs = list(pjournal.read_records(path))
    assert recs and all(r["op"] != "meta" for r in recs)
    assert recs == list(jjournal.Journal(path).replay())[-len(recs):]
    raw = [json.loads(line) for line in open(path)]
    assert raw[0]["op"] == "meta"
    rebuilt = pjournal.engine_from_records(raw, device="cpu")
    assert set(rebuilt.workloads) == {"default/v"}


def test_fsync_per_append_as_jax(tmp_path):
    """``Journal(fsync=True)`` fsyncs each append, so nothing is left for
    the cycle boundary's sync; the files are the same bytes."""
    got = {}
    for name, (t, _engine, jmod, _kw) in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        j = jmod.Journal(path, fsync=True)
        j.apply("cohort", t.Cohort("a"), ts=1.0)
        j.apply_many("cohort", [t.Cohort("b"), t.Cohort("a")], ts=2.0)
        got[name] = (j._dirty, j.writes_seq, j.writable())
        j.close()
        got[name] += (open(path, "rb").read(),)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (False, 3, True)
