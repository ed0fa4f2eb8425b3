"""The port's disk budget (kueue_tpu_torch/store/diskguard.py) and the
journal's read-only mode against the JAX package's: one
``FREE_BYTES_PROBE`` walk down and back up gives both packages' budgets
the same answers, states and counters; mirrored engines with a
Checkpointer park the same cycles, raise JournalDegraded at the same
submits and leave byte-identical journals; JournalFenced and
JournalDegraded fire at the same calls; an ENOSPC from the kernel
degrades as there; and a checkpoint refused by its preflight is counted
as there. Exact throughout."""

import contextlib
import errno
import itertools
import os

import pytest

from kueue_tpu.api import types as jtypes
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.metrics.registry import MetricsRegistry as JRegistry
from kueue_tpu.store import checkpoint as jckpt
from kueue_tpu.store import diskguard as jguard
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.metrics.registry import MetricsRegistry as PRegistry
from kueue_tpu_torch.store import checkpoint as pckpt
from kueue_tpu_torch.store import diskguard as pguard
from kueue_tpu_torch.store import journal as pjournal

PKGS = {
    "jax": dict(t=jtypes, engine=JEngine, journal=jjournal, ckpt=jckpt,
                guard=jguard, registry=JRegistry),
    "port": dict(t=ptypes, engine=lambda: PEngine(device="cpu"),
                 journal=pjournal, ckpt=pckpt, guard=pguard,
                 registry=PRegistry),
}

MIN_FREE = 1_000_000
# Free bytes a walk steps through: room, a filling disk, and room again.
WALK = ([10 ** 9] * 3 + [MIN_FREE + 300] + [MIN_FREE - 1] * 20
        + [10 ** 9] * 6)


@contextlib.contextmanager
def probed(pkg, free):
    """``pkg``'s FREE_BYTES_PROBE reads ``free[0]`` (set it to move the
    disk)."""
    pkg["guard"].FREE_BYTES_PROBE = lambda _path: free[0]
    try:
        yield
    finally:
        pkg["guard"].FREE_BYTES_PROBE = None


@contextlib.contextmanager
def aligned_uids():
    old = (jtypes._uid_counter, ptypes._uid_counter)
    jtypes._uid_counter = itertools.count(90_000_001)
    ptypes._uid_counter = itertools.count(90_000_001)
    try:
        yield
    finally:
        jtypes._uid_counter, ptypes._uid_counter = old


def budget_lines(registry) -> list:
    return sorted(ln for ln in registry.render().split("\n")
                  if ln.startswith("kueue_tpu_disk_budget"))


def test_budget_walk_matches_jax(tmp_path):
    """preflight, rearm_probe and note_enospc along the walk, with the
    probe rate limit of 3: the same answers, status and metrics."""
    logs = {}
    for name, pkg in PKGS.items():
        free = [0]
        reg = pkg["registry"]()
        budget = pkg["guard"].DiskBudget(str(tmp_path / "j"), MIN_FREE,
                                         probe_every=3, metrics=reg)
        log = []
        with probed(pkg, free):
            for i, f in enumerate(WALK):
                free[0] = f
                log.append(("preflight", budget.preflight(200),
                            budget.status()))
                if i % 4 == 3:
                    log.append(("rearm", budget.rearm_probe(),
                                budget.status()))
                if i == 1:
                    budget.note_enospc(OSError(errno.ENOSPC, "full"))
                    log.append(("enospc", budget.degraded,
                                budget.status()))
        log.append(budget_lines(reg))
        logs[name] = log
    assert logs["port"] == logs["jax"]
    states = {s["state"] for _op, _ok, s in logs["port"][:-1]}
    assert states == {"armed", "degraded"}
    assert logs["port"][-2][2]["rearms"] >= 2


def test_guard_off_and_statvfs(tmp_path):
    """min_free_bytes 0 never checks; free_bytes without the seam is the
    filesystem's f_bavail * f_frsize."""
    b = pguard.DiskBudget(str(tmp_path / "j"), 0)
    assert not b.enabled and b.preflight(10 ** 18) and b.checks == 0
    st = os.statvfs(str(tmp_path))
    want = st.f_bavail * st.f_frsize
    got = pguard.free_bytes(str(tmp_path / "j"))
    assert abs(got - want) <= 1 << 24
    assert abs(got - jguard.free_bytes(str(tmp_path / "j"))) <= 1 << 24


def _engine_walk(pkg, path):
    """A journaled world with a Checkpointer: one workload submitted and
    one cycle run per step of the walk. Returns per step (submit raised
    JournalDegraded, cycle parked, cycle_seq, journal degraded,
    checkpoints written, writes_seq)."""
    t = pkg["t"]
    eng = pkg["engine"]()
    pkg["journal"].attach_new_journal(eng, path, min_free_bytes=MIN_FREE,
                                      metrics=eng.registry)
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq0", cohort="co", resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(10 ** 9)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq0", "default", "cq0"))
    ck = pkg["ckpt"].Checkpointer(eng, interval=2,
                                  min_free_bytes=MIN_FREE)
    parked = []
    eng.cycle_listeners.append(lambda seq, r: parked.append(r is None))
    steps = []
    free = [10 ** 9]
    with probed(pkg, free):
        for i, f in enumerate(WALK):
            free[0] = f
            eng.clock += 1.0
            try:
                eng.submit(t.Workload(
                    name=f"w{i}", queue_name="lq0",
                    pod_sets=(t.PodSet("main", 1, {"cpu": 10}),)))
                refused = False
            except pkg["journal"].JournalDegraded:
                refused = True
            eng.schedule_once()
            steps.append((refused, parked[-1], eng.cycle_seq,
                          eng.journal.degraded, ck.written, ck.failures,
                          eng.journal.writes_seq))
    eng.journal.close()
    return steps, eng.journal.budget.status(), budget_lines(eng.registry)


def test_engine_parks_the_same_cycles(tmp_path):
    got = {}
    data = {}
    for name, pkg in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        with aligned_uids():
            got[name] = _engine_walk(pkg, path)
        data[name] = open(path, "rb").read()
    assert got["port"] == got["jax"]
    assert data["port"] == data["jax"]
    steps = got["port"][0]
    assert any(s[0] for s in steps) and any(s[1] for s in steps)
    assert not steps[-1][3]  # re-armed once space came back
    # The checkpoint store's own budget degraded on the filling disk and
    # re-arms only every 16th preflight: failures go on being counted.
    assert steps[-1][4] >= 1 and steps[-1][5] >= 2


def test_degraded_and_fenced_raise_at_the_same_calls(tmp_path):
    """The fence is checked before the disk, both inside the lock, for
    apply, apply_many and delete; a refused write leaves the generation
    table and the file as they were."""
    logs = {}
    for name, pkg in PKGS.items():
        t = pkg["t"]
        path = str(tmp_path / f"{name}.jsonl")
        j = pkg["journal"].Journal(path, min_free_bytes=MIN_FREE)
        free = [10 ** 9]
        fenced = [False]
        j.fence = lambda: not fenced[0]
        calls = [
            lambda: j.apply("cohort", t.Cohort("a")),
            lambda: j.apply_many("cohort", [t.Cohort("b"), t.Cohort("a")]),
            lambda: j.delete("cohort", "b"),
        ]
        log = []
        with probed(pkg, free):
            for step, (fence, f) in enumerate(
                    [(False, 10 ** 9), (True, 10 ** 9), (True, 10),
                     (False, 10), (False, 10 ** 9)] * 2):
                fenced[0], free[0] = fence, f
                j.rearm_probe()
                for call in calls:
                    try:
                        log.append(call())
                    except (pkg["journal"].JournalFenced,
                            pkg["journal"].JournalDegraded) as e:
                        log.append(type(e).__name__)
                log.append((step, j.degraded, j.writable(),
                            dict(j._generations), j.writes_seq))
        j.close()
        logs[name] = [x if not isinstance(x, tuple) else
                      (x[0], x[1], x[2], sorted(x[3].items()), x[4])
                      for x in log]
        logs[name].append(open(path, "rb").read())
    assert logs["port"] == logs["jax"]
    flat = [x for x in logs["port"] if isinstance(x, str)]
    assert "JournalFenced" in flat and "JournalDegraded" in flat


class _FullDisk:
    """A file object whose writes fail with ENOSPC."""

    def __init__(self, fh):
        self._fh = fh

    def write(self, _data):
        raise OSError(errno.ENOSPC, "No space left on device")

    def __getattr__(self, name):
        return getattr(self._fh, name)


def test_enospc_from_the_kernel_degrades(tmp_path, monkeypatch):
    """ENOSPC on an append raises JournalDegraded with the generations
    untouched; ENOSPC on the cycle boundary's fsync degrades and keeps
    the appends pending for the next sync."""
    logs = {}
    for name, pkg in PKGS.items():
        t = pkg["t"]
        j = pkg["journal"].Journal(str(tmp_path / f"{name}.jsonl"),
                                   min_free_bytes=1)
        j.apply("cohort", t.Cohort("a"))
        real = j._fh
        j._fh = _FullDisk(real)
        with pytest.raises(pkg["journal"].JournalDegraded):
            j.apply("cohort", t.Cohort("b"))
        j._fh = real
        log = [j.degraded, dict(j._generations), j.writes_seq]
        assert j.rearm_probe()
        j.apply("cohort", t.Cohort("c"))
        real_fsync = os.fsync

        def full(_fd):
            raise OSError(errno.ENOSPC, "No space left on device")

        monkeypatch.setattr(os, "fsync", full)
        j.sync()
        log += [j.degraded, j._dirty]
        monkeypatch.setattr(os, "fsync", real_fsync)
        assert j.rearm_probe()
        j.sync()
        log += [j.degraded, j._dirty, j.budget.status()]
        j.close()
        logs[name] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"][3:5] == [True, True]


def test_checkpoint_preflight_refusal_is_counted(tmp_path):
    """A checkpoint needs its payload's size above the floor: refused,
    it leaves no file, counts an ENOSPC failure and re-arms on a later
    preflight once space returns, in both packages."""
    logs = {}
    for name, pkg in PKGS.items():
        t = pkg["t"]
        eng = pkg["engine"]()
        path = str(tmp_path / f"{name}.jsonl")
        pkg["journal"].attach_new_journal(eng, path)
        eng.create_cohort(t.Cohort("co"))
        ck = pkg["ckpt"].Checkpointer(eng, interval=1000,
                                      min_free_bytes=MIN_FREE)
        free = [MIN_FREE + 10]
        log = []
        with probed(pkg, free):
            for i in range(20):
                if i == 12:
                    free[0] = 10 ** 9
                meta = ck.checkpoint()
                log.append((meta is not None, ck.written, ck.failures,
                            ck.store.budget.state,
                            sorted(os.listdir(ck.store.directory))))
        log.append(sorted(eng.registry.counter(
            "checkpoint_failures_total").values.items()))
        eng.journal.close()
        logs[name] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"][0][0] is False and logs["port"][-2][0] is True
