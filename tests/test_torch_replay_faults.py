"""The port's fault matrix (kueue_tpu_torch/replay/faults.py) against
the JAX package's.

``tests/test_replay_faults.py``'s cases run on the port: its parse cases
and its in-process oracle faults with that file's module globals
(``FaultPlan``, ``_ExecutorFaultProxy``, ``arm_faults``, its
``_device_world``) pointed at the port's, the world built on the port's
engine on the CPU. Across the packages: every spec of both reference
files' grammars, and a bad one of each kind's checks, parses to the same
faults with the same ``lethal`` and ``needs_oracle``, or fails with the
JAX package's message; on that file's device world, each oracle fault
plan fires the same faults, with the same injected errors and delayed
calls, the same cycle modes, device and fallback cycles, fallback
reasons and ``pipeline_stats``, and the same admitted set. The two
SIGKILL cases (a port child killed by the fault layer mid-admission, or
after planting a torn journal tail) stay ``slow``, as in the reference:
rebuilt from its journal and drained, the child's world equals the JAX
package's unkilled control."""

import os
import signal
import time

import pytest

import test_replay_faults as ref
from kueue_tpu.api import types as jtypes
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.replay import faults as jfaults
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.replay import faults as pfaults
from test_torch_process_kill_restart import (
    control_fingerprint,
    redrive_and_drain,
    spawn_child,
)


def device_world(t, engine):
    """test_replay_faults' _device_world with the types ``t`` on
    ``engine()``: 3 ClusterQueues in a cohort, 9 pending workloads,
    oracle attached."""
    eng = engine()
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    for i in range(3):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", cohort="co",
            resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas(
                    "default", {"cpu": t.ResourceQuota(4000)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq{i}", "default", f"cq{i}"))
    for i in range(9):
        eng.clock += 0.01
        eng.submit(t.Workload(
            name=f"w{i}", queue_name=f"lq{i % 3}",
            pod_sets=(t.PodSet("main", 1, {"cpu": 1000}),)))
    eng.attach_oracle()
    return eng


def port_device_world():
    return device_world(ptypes, lambda: PEngine(device="cpu"))


@pytest.fixture
def on_port(monkeypatch):
    monkeypatch.setattr(ref, "FaultPlan", pfaults.FaultPlan)
    monkeypatch.setattr(ref, "_ExecutorFaultProxy",
                        pfaults._ExecutorFaultProxy)
    monkeypatch.setattr(ref, "arm_faults", pfaults.arm_faults)
    monkeypatch.setattr(ref, "_device_world", port_device_world)


REFERENCE_CASES = [
    ("TestFaultPlanParse", "test_all_kinds", None),
    ("TestFaultPlanParse", "test_empty_spec_is_empty_plan", None),
] + [("TestFaultPlanParse", "test_rejects_bad_specs", spec)
     for spec in ref.TestFaultPlanParse.test_rejects_bad_specs
     .pytestmark[0].args[1]] + [
    ("TestOracleFaults", "test_oracle_crash_falls_back_then_recovers", None),
    ("TestOracleFaults", "test_delayed_verdict_leaves_decisions_unchanged",
     None),
    ("TestOracleFaults",
     "test_executor_proxy_passthrough_when_armed_clean", None),
]


@pytest.mark.parametrize(
    "cls,name,arg", REFERENCE_CASES,
    ids=[f"{c}.{n}" + (f"[{a}]" if a else "")
         for c, n, a in REFERENCE_CASES])
def test_reference_case_on_the_port(on_port, cls, name, arg):
    method = getattr(getattr(ref, cls)(), name)
    if arg is None:
        method()
    else:
        method(arg)


def test_oracle_fault_requires_attached_oracle():
    with pytest.raises(RuntimeError) as want:
        jfaults.arm_faults(JEngine(), "oracle-crash@cycle:1")
    with pytest.raises(RuntimeError) as got:
        pfaults.arm_faults(PEngine(device="cpu"), "oracle-crash@cycle:1")
    assert str(got.value) == str(want.value)


# Both reference files' specs, every kind, and one bad spec for each of
# the parser's checks.
SPECS = [
    "sigkill@cycle:3, sigkill@admission:40,torn-tail@cycle:2,"
    "oracle-crash@cycle:1,delay-verdict@cycle:5:250",
    "enospc@cycle:3,torn-checkpoint@cycle:4,clock-skew@cycle:5:250,"
    "oracle-crash-storm@cycle:6:4,sigkill@compaction:2",
    "lease-stall@cycle:2,hang@cycle:3:40,arrival-storm@cycle:4:16,"
    "slow-consumer-flood@cycle:5:8,disk-pressure-ramp@cycle:6:3",
    "", "delay-verdict@cycle:0", "clock-skew@cycle:2:-1.5",
    "sigkill", "sigkill@cycle", "sigkill@cycle:x", "meteor@cycle:1",
    "sigkill@verdict:1", "torn-tail@admission:1", "enospc@admission:1",
    "torn-checkpoint@compaction:1", "clock-skew@cycle:5",
    "oracle-crash-storm@cycle:3", "oracle-crash-storm@cycle:3:0",
    "oracle-crash-storm@cycle:3:2.5", "delay-verdict@cycle:1:-5",
    "enospc@cycle:notanint", "hang@cycle:1", "hang@cycle:1:0",
    "arrival-storm@cycle:1", "slow-consumer-flood@cycle:1:1.5",
    "disk-pressure-ramp@cycle:1:0", "lease-stall@admission:1",
]


def parsed(faults_mod, spec):
    try:
        plan = faults_mod.FaultPlan.parse(spec)
    except ValueError as e:
        return ("error", str(e))
    return ([(f.kind, f.at, f.n, f.arg) for f in plan.faults],
            plan.lethal, plan.needs_oracle)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    assert parsed(pfaults, spec) == parsed(jfaults, spec)


def test_every_kind_parses():
    assert pfaults.KINDS == jfaults.KINDS and len(pfaults.KINDS) == 13
    assert pfaults.POINTS == jfaults.POINTS
    kinds = {k for spec in SPECS[:3] for k, *_ in parsed(pfaults, spec)[0]}
    assert kinds == set(pfaults.KINDS)


# Oracle fault plans on the device world, each drained.
PLANS = ["oracle-crash@cycle:0", "delay-verdict@cycle:0:30",
         "oracle-crash@cycle:9999", "oracle-crash-storm@cycle:1:2",
         "oracle-crash@cycle:1,delay-verdict@cycle:2:20,"
         "oracle-crash-storm@cycle:3:2"]


def run_plan(world, faults_mod, spec) -> dict:
    eng = world()
    inj = faults_mod.arm_faults(eng, spec, sleep=lambda s: None)
    modes = []
    for _ in range(50):
        r = eng.schedule_once()
        modes.append(eng.last_cycle_mode if r is not None else None)
        if r is None:
            break
    b = eng.oracle
    return dict(
        fired=inj.fired, injected_errors=inj.proxy.injected_errors,
        delayed_calls=inj.proxy.delayed_calls,
        crashed=inj.proxy.crashed, delay_ms=inj.proxy.delay_ms,
        modes=modes, on_device=b.cycles_on_device, hybrid=b.cycles_hybrid,
        fallback=b.cycles_fallback,
        fallback_reasons=dict(b.fallback_reasons),
        pipeline_stats=dict(b.pipeline_stats),
        admitted=ref._admitted(eng))


@pytest.fixture(scope="module")
def jax_plans():
    """Every plan run by the JAX package (its device world compiles
    once)."""
    return {spec: run_plan(lambda: device_world(jtypes, JEngine), jfaults,
                           spec)
            for spec in PLANS}


@pytest.mark.parametrize("spec", PLANS)
def test_fault_plans_fire_as_in_jax(jax_plans, spec):
    got = run_plan(port_device_world, pfaults, spec)
    assert got == jax_plans[spec]
    assert len(got["fired"]) == spec.count("@") - ("9999" in spec)


def test_delay_sleeps_on_the_wall_clock():
    eng = port_device_world()
    inj = pfaults.arm_faults(eng, "delay-verdict@cycle:0:60")
    t0 = time.perf_counter()
    eng.schedule_once()
    assert time.perf_counter() - t0 >= 0.06
    assert inj.proxy.delayed_calls >= 1


def _killed_by_the_fault_layer(tmp_path, spec):
    path = str(tmp_path / "j.jsonl")
    child = spawn_child(path, spec)
    deadline = time.monotonic() + 180
    while child.poll() is None and time.monotonic() < deadline:
        time.sleep(0.2)
    assert child.poll() is not None, "child never died; fault unarmed?"
    out = child.stdout.read()
    assert child.returncode == -signal.SIGKILL, (
        f"exit={child.returncode} out={out[-400:]} "
        f"err={child.stderr.read()[-800:]}")
    assert "done" not in out, "child finished churn: the kill never fired"
    return path


def _recover(path):
    from kueue_tpu_torch.store.journal import rebuild_engine

    rebuilt = rebuild_engine(path, device="cpu")
    assert rebuilt.workloads, "journal rebuilt an empty world"
    return redrive_and_drain(rebuilt)


@pytest.mark.slow
def test_sigkill_mid_admission_recovers_to_jax_control(tmp_path):
    path = _killed_by_the_fault_layer(tmp_path, "sigkill@admission:12")
    assert _recover(path) == control_fingerprint()


@pytest.mark.slow
def test_torn_tail_fault_recovers_to_jax_control(tmp_path):
    path = _killed_by_the_fault_layer(tmp_path, "torn-tail@cycle:4")
    with open(path, "rb") as fh:
        assert not fh.read().endswith(b"\n"), "fault did not tear the tail"
    assert os.path.getsize(path) > 0
    assert _recover(path) == control_fingerprint()
