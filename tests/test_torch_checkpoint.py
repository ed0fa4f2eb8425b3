"""The port's sealed checkpoints and journal segments
(kueue_tpu_torch/store/checkpoint.py, store/journal.py) against the JAX
package's: every case of tests/test_checkpoint.py run on the same world
by both packages, with the journal files, segments and checkpoint files
they leave byte-identical and their recovery reports equal; mirrored
serving engines with a Checkpointer on each side (the speculation
pipeline on) writing byte-identical journal sets with equal
``pipeline_stats`` after every cycle, and the same without a
Checkpointer; and each package's recovery of the other's files. Exact
throughout."""

import contextlib
import errno
import itertools
import json
import os
import shutil
from dataclasses import dataclass

import pytest

from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.ha.digest import admitted_state_digest as jdigest
from kueue_tpu.store import checkpoint as jckpt
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.ha.digest import admitted_state_digest as pdigest
from kueue_tpu_torch.store import checkpoint as pckpt
from kueue_tpu_torch.store import journal as pjournal


@dataclass(frozen=True)
class Pkg:
    name: str
    t: object
    engine: object
    journal: object
    ckpt: object
    digest: object
    kw: dict


JAX = Pkg("jax", jtypes, JEngine, jjournal, jckpt, jdigest, {})
PORT = Pkg("port", ptypes, lambda: PEngine(device="cpu"), pjournal, pckpt,
           pdigest, {"device": "cpu"})
PKGS = (JAX, PORT)


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


def build_world(eng, t):
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq0", cohort="co",
        resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(1_000_000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq0", "default", "cq0"))


def submit_wave(eng, t, n, start=0):
    for i in range(start, start + n):
        eng.clock += 0.01
        eng.submit(t.Workload(name=f"w{i}", queue_name="lq0",
                              pod_sets=(t.PodSet("main", 1, {"cpu": 100}),)))


def drain(eng):
    while eng.schedule_once() is not None:
        eng.clock += 0.01


def journaled_world(pkg, path, n=6, **journal_kwargs):
    eng = pkg.engine()
    pkg.journal.attach_new_journal(eng, path, **journal_kwargs)
    build_world(eng, pkg.t)
    submit_wave(eng, pkg.t, n)
    drain(eng)
    return eng


def files(d) -> dict:
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _dirs, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def both(tmp_path, case):
    """Run ``case(pkg, path)`` once per package, each in a directory of
    its own under aligned uids; the directories must end up holding
    byte-identical files. Returns {pkg name: case's result}, with the
    directory in any string of the result replaced by ``D``."""
    out = {}
    dirs = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        d.mkdir()
        dirs[pkg.name] = d
        with aligned_uids():
            got = case(pkg, str(d / "j.jsonl"))
        out[pkg.name] = json.loads(json.dumps(got).replace(str(d), "D"))
    jf, pf = files(dirs["jax"]), files(dirs["port"])
    assert sorted(pf) == sorted(jf)
    for name in jf:
        assert pf[name] == jf[name], name
    return out


# -- write / recover round trip --

def test_checkpoint_recovery_matches_genesis(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        meta = store.write(eng, seq=eng.cycle_seq)
        assert meta.records > 0
        assert meta.state == pkg.digest(eng)
        submit_wave(eng, pkg.t, 2, start=6)
        drain(eng)
        eng.journal.close()
        rec, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw,
                                              prove_genesis=True)
        assert report["source"] == "checkpoint"
        assert report["suffix_records"] > 0
        assert report["identical"]
        assert pkg.digest(rec) == pkg.digest(eng)
        return [meta.records, meta.state, report]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_no_checkpoint_degrades_to_genesis(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        eng.journal.close()
        rec, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw)
        assert report["source"] == "genesis"
        assert pkg.digest(rec) == pkg.digest(eng)
        return report

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


# -- torn / corrupt detection --

def test_torn_checkpoint_falls_back_to_previous(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        first = store.write(eng)
        submit_wave(eng, pkg.t, 2, start=6)
        drain(eng)
        second = store.write(eng)
        size = os.path.getsize(second.path)
        with open(second.path, "r+b") as fh:
            fh.truncate(int(size * 0.6))
        eng.journal.close()
        _base, suffix, meta = pkg.ckpt.recover_records(
            pkg.journal.Journal(path))
        assert meta is not None and meta.path == first.path
        assert [m.path for m in store.live_metas()] == [first.path]
        _rec, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw,
                                               prove_genesis=True)
        assert report["checkpoint"]["path"] == first.path
        assert report["identical"]
        return [len(suffix), report]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_all_checkpoints_corrupt_degrades_to_genesis(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        store.write(eng)
        store.write(eng)
        for _index, p in store._indexed():
            with open(p, "r+b") as fh:
                fh.truncate(10)
        eng.journal.close()
        assert store.live_metas() == []
        rec, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw)
        assert report["source"] == "genesis"
        assert pkg.digest(rec) == pkg.digest(eng)
        return report

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_crc_and_count_mismatches_are_rejected(tmp_path):
    """A flipped payload byte fails the CRC, and a header whose count
    disagrees with the payload fails the count, in both packages (the
    port's header-only ``live_metas`` included)."""
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        good = store.write(eng)
        flipped = store.write(eng)
        recount = store.write(eng)
        eng.journal.close()
        data = bytearray(open(flipped.path, "rb").read())
        data[-5] ^= 0x01
        open(flipped.path, "wb").write(bytes(data))
        head, _, payload = open(recount.path, "rb").read().partition(b"\n")
        hdr = json.loads(head)
        hdr["records"] += 1
        open(recount.path, "wb").write(
            json.dumps(hdr).encode() + b"\n" + payload)
        loads = [store.load(i, p) is not None for i, p in store._indexed()]
        return [loads, [m.path for m in store.live_metas()], good.path]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [True, False, False]


def test_leftover_tmp_file_is_never_read(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        store.write(eng)
        with open(os.path.join(store.directory,
                               "ckpt-000099.json.tmp"), "w") as fh:
            fh.write("{garbage")
        assert len(store.live_metas()) == 1
        eng.journal.close()
        _, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw)
        assert report["source"] == "checkpoint"
        return report

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_write_fault_aborts_and_keeps_previous(tmp_path):
    """The fault writes half a payload, then raises ENOSPC."""
    def die(fh):
        fh.write(b'{"op": "apply", "kind": "workl')
        raise OSError(errno.ENOSPC, "injected")

    def case(pkg, path):
        eng = journaled_world(pkg, path)
        ck = pkg.ckpt.Checkpointer(eng, interval=1000)
        first = ck.checkpoint()
        assert first is not None
        pkg.ckpt.WRITE_FAULT = die
        try:
            assert ck.checkpoint() is None
        finally:
            pkg.ckpt.WRITE_FAULT = None
        assert ck.failures == 1 and ck.written == 1
        assert [m.path for m in ck.store.live_metas()] == [first.path]
        assert not [n for n in os.listdir(ck.store.directory)
                    if n.endswith(".tmp")]
        assert ck.checkpoint() is not None
        eng.journal.close()
        failures = eng.registry.counter("checkpoint_failures_total")
        return [ck.status(), sorted(failures.values.items())]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


# -- retention --

def test_retention_counts_files_newest_first(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        metas = [store.write(eng) for _ in range(4)]
        assert store.retain(keep=2) == 2
        kept = [p for _i, p in store._indexed()]
        assert kept == [metas[2].path, metas[3].path]
        eng.journal.close()
        return kept

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_checkpointer_interval_skips_idle(tmp_path):
    def case(pkg, path):
        eng = pkg.engine()
        pkg.journal.attach_new_journal(eng, path)
        build_world(eng, pkg.t)
        ck = pkg.ckpt.Checkpointer(eng, interval=2)
        for _ in range(10):
            eng.schedule_once()
        assert ck.written == 0
        submit_wave(eng, pkg.t, 4)
        drain(eng)
        assert ck.written >= 1
        assert eng.checkpointer is ck
        ck.detach()
        assert eng.checkpointer is None
        assert ck._hook not in eng.cycle_listeners
        eng.journal.close()
        return [ck.written, eng.cycle_seq, ck.last_meta.seq,
                sorted(eng.registry.gauge("checkpoint_last_seq")
                       .values.items())]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


# -- lineage invalidation --

def test_compaction_invalidates_checkpoints(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path)
        store = pkg.ckpt.CheckpointStore.for_journal(path)
        store.write(eng)
        eng.journal.compact()
        eng.journal.close()
        _base, _suffix, meta = pkg.ckpt.recover_records(
            pkg.journal.Journal(path))
        assert meta is None
        rec, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw)
        assert report["source"] == "genesis"
        assert pkg.digest(rec) == pkg.digest(eng)
        return report

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


# -- segment rotation --

def test_rotation_seals_segments_and_replays_in_order(tmp_path):
    def case(pkg, path):
        flat = path.replace("j.jsonl", "flat.jsonl")
        eng = journaled_world(pkg, path, n=12, rotate_records=10)
        control = journaled_world(pkg, flat, n=12)
        segs = eng.journal.sealed_segments()
        assert len(segs) >= 1
        rebuilt = pkg.journal.rebuild_engine(path, **pkg.kw)
        assert pkg.digest(rebuilt) == pkg.digest(control)
        kinds = [r["kind"] for r in eng.journal.replay()]
        assert kinds == [r["kind"] for r in control.journal.replay()]
        for e in (eng, control, rebuilt):
            e.journal.close()
        return [[os.path.basename(p) for _o, p in segs],
                eng.journal.position(), pkg.digest(rebuilt)]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_replay_from_checkpoint_position_is_suffix_only(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path, n=12, rotate_records=10)
        position = eng.journal.position()
        submit_wave(eng, pkg.t, 3, start=12)
        drain(eng)
        suffix = list(eng.journal.replay_from(position))
        total = list(eng.journal.replay())
        assert 0 < len(suffix) < len(total)
        assert suffix == total[-len(suffix):]
        with pytest.raises(ValueError):
            list(eng.journal.replay_from(dict(position, lineage=99)))
        eng.journal.close()
        return [position, suffix]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("rotate", [0, 7])
def test_replay_from_resumes_exactly_at_the_position(tmp_path, rotate):
    """The position's offset is a line count, the meta line included:
    the first suffix record is the first record written after it, here
    a cohort created once (no re-apply that would hide an off-by-one),
    with and without rotations between the position and the end."""
    def case(pkg, path):
        eng = journaled_world(pkg, path, n=9, rotate_records=rotate)
        eng.journal.sync()
        position = eng.journal.position()
        eng.create_cohort(pkg.t.Cohort("late"))
        submit_wave(eng, pkg.t, 12, start=9)
        drain(eng)
        suffix = list(eng.journal.replay_from(position))
        assert suffix[0]["kind"] == "cohort"
        assert suffix[0]["obj"]["name"] == "late"
        total = list(eng.journal.replay())
        assert suffix == total[-len(suffix):]
        eng.journal.close()
        return [position, len(suffix),
                [os.path.basename(p) for _o, p in
                 eng.journal.sealed_segments()]]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]
    if rotate:
        assert got["port"][2]


def test_retain_segments_bounds_history_but_recovers(tmp_path):
    def case(pkg, path):
        eng = pkg.engine()
        pkg.journal.attach_new_journal(eng, path, rotate_records=8)
        build_world(eng, pkg.t)
        ck = pkg.ckpt.Checkpointer(eng, interval=2, keep=1,
                                   retain_segments=True)
        for start in range(0, 24, 4):
            submit_wave(eng, pkg.t, 4, start=start)
            drain(eng)
        assert ck.written >= 2
        live = ck.store.live_metas()
        assert all(o >= min(m.segment for m in live)
                   for o, _p in eng.journal.sealed_segments())
        assert not os.path.exists(path + ".seg000000")
        digest = pkg.digest(eng)
        eng.journal.close()
        rec, report = pkg.ckpt.recover_engine(path, engine_kwargs=pkg.kw)
        assert report["source"] == "checkpoint"
        assert pkg.digest(rec) == digest
        rebuilt = pkg.journal.rebuild_engine(path, **pkg.kw)
        assert pkg.digest(rebuilt) == digest
        rebuilt.journal.close()
        return [ck.written, report]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


# -- readers racing concurrent maintenance --

def test_reader_refresh_survives_rotation_swap(tmp_path):
    def case(pkg, path):
        eng = pkg.engine()
        pkg.journal.attach_new_journal(eng, path, rotate_records=6)
        build_world(eng, pkg.t)
        reader = pkg.journal.Journal(path)
        reader.refresh()
        before = reader.position()
        submit_wave(eng, pkg.t, 12)
        drain(eng)
        assert len(eng.journal.sealed_segments()) >= 1
        reader.refresh()
        after = reader.position()
        assert after["segment"] >= before["segment"]
        assert reader.position() == eng.journal.position()
        assert reader._generations == eng.journal._generations
        reader.close()
        eng.journal.close()
        return [before, after]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


def test_reader_refresh_survives_compaction_shrink(tmp_path):
    def case(pkg, path):
        eng = journaled_world(pkg, path, n=10)
        reader = pkg.journal.Journal(path)
        reader.refresh()
        assert reader.position()["offset"] > 0
        eng.journal.compact()
        reader.refresh()
        assert reader.position() == eng.journal.position()
        assert reader.lineage == eng.journal.lineage
        kinds = [r["kind"] for r in reader.replay()]
        assert kinds == [r["kind"] for r in eng.journal.replay()]
        reader.close()
        eng.journal.close()
        return [reader.position(), kinds]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("pkg", PKGS, ids=[p.name for p in PKGS])
def test_path_reads_leave_a_torn_tail_and_match_the_journal(tmp_path, pkg):
    """The port's reads of a journal set by its path (store/journal.py's
    read_* and checkpoint.recover_records_at), as a reader beside a
    killed writer makes them: the torn tail stays as it was, and they
    give what each package's Journal gives on a copy of the set."""
    d = tmp_path / "set"
    d.mkdir()
    path = str(d / "j.jsonl")
    with aligned_uids():
        eng = journaled_world(PORT, path, n=9, rotate_records=7)
        pckpt.CheckpointStore.for_journal(path).write(eng)
        submit_wave(eng, PORT.t, 6, start=9)
        drain(eng)
        eng.journal.close()
    with open(path, "ab") as fh:
        fh.write(b'{"op": "apply", "kind": "work')
    before = files(d)
    base, suffix, meta = pckpt.recover_records_at(path)
    got = [pjournal.read_lineage(path), pjournal.read_active_ordinal(path),
           [os.path.basename(p) for _o, p in pjournal.read_segments(path)],
           list(pjournal.read_chain(path)),
           list(pjournal.read_suffix(path, meta.position)),
           base, suffix, meta.position]
    assert files(d) == before
    assert got[2] and got[6]
    shutil.copytree(d, tmp_path / "copy")
    cpath = str(tmp_path / "copy" / "j.jsonl")
    journal = pkg.journal.Journal(cpath)
    jbase, jsuffix, jmeta = pkg.ckpt.recover_records(journal)
    want = [journal.lineage, journal.active_ordinal(),
            [os.path.basename(p) for _o, p in journal.sealed_segments()],
            list(journal.replay()), list(journal.replay_from(meta.position)),
            jbase, jsuffix, jmeta.position]
    journal.close()
    assert got == want


def test_maintenance_crash_leaves_replayable_journal(tmp_path):
    def case(pkg, path):
        eng = pkg.engine()
        pkg.journal.attach_new_journal(eng, path, rotate_records=6)
        build_world(eng, pkg.t)
        events = []
        pkg.journal.MAINTENANCE_CRASH_HOOK = events.append
        try:
            submit_wave(eng, pkg.t, 10)
            drain(eng)
        finally:
            pkg.journal.MAINTENANCE_CRASH_HOOK = None
        assert "rotate" in events
        digest = pkg.digest(eng)
        rec = pkg.journal.rebuild_engine(path, **pkg.kw)
        assert pkg.digest(rec) == digest
        return [events, digest]

    got = both(tmp_path, case)
    assert got["port"] == got["jax"]


# -- the serving loop with a Checkpointer on each side --

# Segments are kept (retain_segments=False) so that each package's
# genesis replay of the other's files can prove the checkpoint path;
# retention runs in test_retain_segments_bounds_history_but_recovers
# and at full width in chip_smoke.py's phase 20.
CKPT_SERVE = dict(interval=3, keep=2, rotate_records=400)


def _serve_run(kit, jmod, cmod, path, checkpoints=True):
    """serve_world.SMALL with its arrivals drained on the batched
    oracle's default loop (speculation on); with ``checkpoints``, the
    journal rotates and a Checkpointer writes. Returns the engine and,
    per cycle, (idle, cycle_seq, pipeline_stats)."""
    eng = sw.build_world(sw.SMALL, kit)
    kwargs = {"rotate_records": CKPT_SERVE["rotate_records"]} \
        if checkpoints else {}
    jmod.attach_new_journal(eng, path, **kwargs)
    if checkpoints:
        cmod.Checkpointer(eng, interval=CKPT_SERVE["interval"],
                          keep=CKPT_SERVE["keep"], retain_segments=False)
    kit.attach(eng)
    for wl in sw.arrivals(sw.SMALL, kit):
        eng.submit(wl)
    cycles = []
    while True:
        r = eng.schedule_once()
        cycles.append((r is None, eng.cycle_seq,
                       dict(eng.oracle.pipeline_stats)))
        if r is None:
            break
    eng.journal.close()
    return eng, cycles


@pytest.fixture(scope="module")
def served(tmp_path_factory, monkeypatch_module):
    """The serving run once per package with checkpoints, and the
    port's once without: {name: (engine, cycles, directory)}."""
    monkeypatch_module.delenv("KUEUE_TPU_PIPELINE", raising=False)
    jkit = ew.Kit(jtypes, jscenario,
                  lambda fair=False: JEngine(enable_fair_sharing=fair),
                  lambda eng: eng.attach_oracle())
    pkit = ew.port_kit("cpu")
    out = {}
    for name, kit, jmod, cmod, ck in (
            ("jax", jkit, jjournal, jckpt, True),
            ("port", pkit, pjournal, pckpt, True),
            ("port-plain", pkit, pjournal, pckpt, False)):
        d = tmp_path_factory.mktemp(name)
        with aligned_uids():
            eng, cycles = _serve_run(kit, jmod, cmod, str(d / "j.jsonl"),
                                     checkpoints=ck)
        out[name] = (eng, cycles, d)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_mirrored_checkpointers_write_identical_journal_sets(served):
    (jeng, _, jd), (peng, _, pd) = served["jax"], served["port"]
    jf, pf = files(jd), files(pd)
    assert sorted(pf) == sorted(jf)
    for name in jf:
        assert pf[name] == jf[name], name
    assert any(".ckpt/ckpt-" in n for n in pf)
    assert any(".seg" in n for n in pf)
    assert peng.checkpointer.written == jeng.checkpointer.written >= 3
    assert peng.checkpointer.failures == jeng.checkpointer.failures == 0


def test_checkpointer_leaves_the_speculation_alone(served):
    """pipeline_stats after every cycle: equal in both packages, and
    the same with and without a Checkpointer (a rotation's meta line and
    a checkpoint write no journaled record)."""
    jc, pc, plain = (served[n][1] for n in ("jax", "port", "port-plain"))
    assert pc == jc
    assert pc == plain
    assert pc[-1][2]["speculated"] > 0
    assert served["port"][0].journal.writes_seq == \
        served["port-plain"][0].journal.writes_seq


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_cross_recovery(served, tmp_path, direction):
    """Each package's recover_engine on the other's journal set: through
    a checkpoint, to the live engine's admitted-state digest, identical
    to its own genesis replay of what retention left."""
    src, dst = ("jax", PORT) if direction == "jax-to-port" else \
        ("port", JAX)
    live, _, d = served[src]
    copy = tmp_path / "copy"
    shutil.copytree(d, copy)
    rec, report = dst.ckpt.recover_engine(str(copy / "j.jsonl"),
                                          engine_kwargs=dst.kw,
                                          prove_genesis=True)
    want = (jdigest if src == "jax" else pdigest)(live)
    assert report["source"] == "checkpoint"
    assert report["state"] == dst.digest(rec) == want
    assert report["identical"] is True
    rebuilt = dst.journal.rebuild_engine(str(copy / "j.jsonl"), **dst.kw)
    if dst is PORT:
        assert rebuilt.rebuild_source == "checkpoint"
    assert dst.digest(rebuilt) == want
    rebuilt.journal.close()
