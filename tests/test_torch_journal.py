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
