"""The port's seeded chaos schedule and recovery faults
(kueue_tpu_torch/replay/faults.py) against the JAX package's.

``tests/test_chaos.py``'s cases run on the port, that file's module
globals (its API types, ``Engine``, ``ChaosSchedule``, ``FaultPlan``,
``_ExecutorFaultProxy``, ``arm_faults``, the checkpoint module and
``Checkpointer``, ``attach_new_journal``) pointed at the port's, its
engines on the CPU. Across the packages: the same seed expands into the
same stages; ENOSPC on checkpoint writes, a torn checkpoint, a clock
skew and a crash storm leave the same counts, the same surviving
checkpoints and the same crashed cycles in both. The faults' process-
wide seams (``WRITE_FAULT``, ``FREE_BYTES_PROBE``,
``MAINTENANCE_CRASH_HOOK``) are each package's own: the port's injector
never sets the JAX package's, and every test leaves both unset."""

from types import SimpleNamespace

import pytest

import test_chaos as ref
from kueue_tpu.replay import faults as jfaults
from kueue_tpu.store import checkpoint as jckpt
from kueue_tpu.store import diskguard as jdg
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.replay import faults as pfaults
from kueue_tpu_torch.store import checkpoint as pckpt
from kueue_tpu_torch.store import diskguard as pdg
from kueue_tpu_torch.store import journal as pjournal

SEAMS = ((jckpt, "WRITE_FAULT"), (pckpt, "WRITE_FAULT"),
         (jdg, "FREE_BYTES_PROBE"), (pdg, "FREE_BYTES_PROBE"),
         (jjournal, "MAINTENANCE_CRASH_HOOK"),
         (pjournal, "MAINTENANCE_CRASH_HOOK"))


@pytest.fixture(autouse=True)
def seams_unset():
    """No test leaves a fault seam set for the next one on its worker."""
    assert all(getattr(m, name) is None for m, name in SEAMS)
    yield
    left = [f"{m.__name__}.{name}" for m, name in SEAMS
            if getattr(m, name) is not None]
    for m, name in SEAMS:
        setattr(m, name, None)
    assert not left, left


def port_globals(mp) -> None:
    for name, obj in list(vars(ref).items()):
        if getattr(obj, "__module__", None) == "kueue_tpu.api.types":
            mp.setattr(ref, name, getattr(ptypes, name))
    mp.setattr(ref, "Engine", lambda: PEngine(device="cpu"))
    for name in ("ChaosSchedule", "FaultPlan", "_ExecutorFaultProxy",
                 "arm_faults"):
        mp.setattr(ref, name, getattr(pfaults, name))
    mp.setattr(ref, "ckpt_mod", pckpt)
    mp.setattr(ref, "Checkpointer", pckpt.Checkpointer)
    mp.setattr(ref, "attach_new_journal", pjournal.attach_new_journal)


def _cases():
    out = []
    for name, fn in vars(ref).items():
        if not name.startswith("test_"):
            continue
        marks = getattr(fn, "pytestmark", [])
        params = [m.args[1] for m in marks if m.name == "parametrize"]
        if params:
            out += [(name, p) for p in params[0]]
        else:
            out.append((name, None))
    return out


REFERENCE_CASES = _cases()


@pytest.mark.parametrize("name,arg", REFERENCE_CASES,
                         ids=[n + (f"[{a}]" if a else "")
                              for n, a in REFERENCE_CASES])
def test_reference_case_on_the_port(monkeypatch, tmp_path, name, arg):
    port_globals(monkeypatch)
    fn = getattr(ref, name)
    args = []
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        args.append(tmp_path)
    if arg is not None:
        args.append(arg)
    fn(*args)


def stages(faults_mod, seed, **kw):
    return [(s.spec, s.cycles, s.lethal, s.needs_oracle)
            for s in faults_mod.ChaosSchedule(seed, **kw).stages()]


@pytest.mark.parametrize("kw", [{}, {"oracle": False},
                                {"stages": 5, "cycles_per_stage": 40}],
                         ids=["default", "no-oracle", "5x40"])
def test_schedules_match_jax(kw):
    for seed in range(1, 17):
        assert stages(pfaults, seed, **kw) == stages(jfaults, seed, **kw)


def _in_each_package(mp, tmp_path, run):
    """``run()`` on test_chaos's globals as they are (the JAX package)
    and pointed at the port's, each in a directory of its own."""
    out = {}
    for pkg in ("jax", "port"):
        with mp.context() as m:
            if pkg == "port":
                port_globals(m)
            d = tmp_path / pkg
            d.mkdir(parents=True)
            out[pkg] = run(str(d / "j.jsonl"))
    return out


def test_recovery_faults_leave_the_jax_counts(monkeypatch, tmp_path):
    def enospc(path):
        eng = ref._world(path)
        ck = ref.Checkpointer(eng, interval=1)
        inj = ref.arm_faults(eng, "enospc@cycle:3")
        ref._submit(eng, 6)
        while eng.schedule_once() is not None:
            eng.clock += 0.01
        eng.journal.close()
        return (inj.fired, ck.failures, ck.written,
                [m.path.rsplit("/", 1)[1] for m in ck.store.live_metas()])

    def torn(path):
        eng = ref._world(path)
        ck = ref.Checkpointer(eng, interval=1, keep=4)
        ref._submit(eng, 4)
        while eng.schedule_once() is not None:
            eng.clock += 0.01
        inj = ref.arm_faults(eng, f"torn-checkpoint@cycle:{eng.cycle_seq}"
                             f",clock-skew@cycle:{eng.cycle_seq}:5000")
        clock = eng.clock
        eng.schedule_once()
        eng.journal.close()
        return (inj.fired, eng.clock - clock,
                [m.path.rsplit("/", 1)[1] for m in ck.store.live_metas()])

    def storm(path):
        eng = ref._world(path)
        eng.oracle = SimpleNamespace(executor=object(),
                                     try_cycle=lambda: None,
                                     cycles_fallback=0)
        ref._submit(eng, 8)
        inj = ref.arm_faults(eng, "oracle-crash-storm@cycle:2:3")
        crashed = []
        eng.pre_cycle_hooks.append(
            lambda seq, _e: crashed.append(inj.proxy.crashed))
        for _ in range(8):
            eng.clock += 0.01
            eng.schedule_once()
        eng.journal.close()
        return inj.fired, crashed, eng.oracle.cycles_fallback

    for run in (enospc, torn, storm):
        got = _in_each_package(monkeypatch, tmp_path / run.__name__, run)
        assert got["port"] == got["jax"], run.__name__


def test_port_injector_sets_only_the_ports_seams(tmp_path):
    eng = PEngine(device="cpu")
    pjournal.attach_new_journal(eng, str(tmp_path / "j.jsonl"))
    pfaults.arm_faults(eng, "enospc@cycle:0,disk-pressure-ramp@cycle:0:2,"
                            "sigkill@compaction:99")
    eng.schedule_once()
    assert pckpt.WRITE_FAULT is not None
    assert pdg.FREE_BYTES_PROBE is not None
    assert pjournal.MAINTENANCE_CRASH_HOOK is not None
    assert (jckpt.WRITE_FAULT, jdg.FREE_BYTES_PROBE,
            jjournal.MAINTENANCE_CRASH_HOOK) == (None, None, None)
    for _ in range(2):
        eng.schedule_once()
    assert pckpt.WRITE_FAULT is None and pdg.FREE_BYTES_PROBE is None
    eng.journal.close()
    # The maintenance hook stays armed for the process's life, in both
    # packages: the test that armed it unsets it.
    pjournal.MAINTENANCE_CRASH_HOOK = None
