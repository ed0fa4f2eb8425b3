"""A port child process SIGKILLed mid-churn, against the JAX package:
``tests/test_process_kill_restart.py``'s case on the port. The child
runs that file's preemption churn world on the port's engine (its
``build_world`` and ``run_churn`` with the port's types) with a journal
attached, and is SIGKILLed after six cycles, no cleanup. The port's
``rebuild_engine`` of the crashed journal is internally consistent
(cache usage equals the sum of the admitted workloads'), and after the
inputs the child never got to and a drain, its final world equals the
JAX package's unkilled control run of the same scenario. ``build_world``
and ``run_churn`` here are also the child of
``tests/test_torch_replay_faults.py``'s fault-layer kills."""

import os
import signal
import subprocess
import sys
import time

import test_process_kill_restart as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

# The port child: the churn under an optional fault plan (argv[2]), a
# flushed marker line after every cycle for the parent to pace a kill.
CHILD = r"""
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
from test_torch_process_kill_restart import build_world, run_churn

path = sys.argv[1]
eng = build_world(path)
if len(sys.argv) > 2:
    from kueue_tpu_torch.replay.faults import arm_faults
    arm_faults(eng, sys.argv[2])
for k in run_churn(eng):
    print(f"cycle {k}", flush=True)
print("done", flush=True)
"""


def spawn_child(journal_path, *spec):
    code = CHILD.replace("{repo!r}", repr(REPO)).replace(
        "{tests!r}", repr(TESTS))
    return subprocess.Popen(
        [sys.executable, "-c", code, journal_path, *spec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def build_world(journal_path=None):
    """The reference's build_world on the port (its engine on the CPU)."""
    from kueue_tpu_torch.api.types import (
        ClusterQueue,
        ClusterQueuePreemption,
        Cohort,
        FlavorQuotas,
        LocalQueue,
        PodSet,
        PreemptionPolicy,
        ResourceFlavor,
        ResourceGroup,
        ResourceQuota,
        Workload,
    )
    from kueue_tpu_torch.controllers.engine import Engine
    from kueue_tpu_torch.store.journal import attach_new_journal

    eng = Engine(device="cpu")
    eng.create_resource_flavor(ResourceFlavor("default"))
    for c in range(3):
        eng.create_cohort(Cohort(f"co{c}"))
    for i in range(9):
        eng.create_cluster_queue(ClusterQueue(
            name=f"cq{i}", cohort=f"co{i % 3}",
            preemption=ClusterQueuePreemption(
                within_cluster_queue=PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=PreemptionPolicy.LOWER_PRIORITY),
            resource_groups=(ResourceGroup(
                ("cpu",), (FlavorQuotas("default",
                                        {"cpu": ResourceQuota(4000)}),)),)))
        eng.create_local_queue(LocalQueue(f"lq{i}", "default", f"cq{i}"))
    if journal_path:
        attach_new_journal(eng, journal_path, fsync=False)
    for i in range(27):
        eng.clock += 0.01
        eng.submit(Workload(
            name=f"low{i}", queue_name=f"lq{i % 9}", priority=0,
            pod_sets=(PodSet("main", 1, {"cpu": 1000}),)))
    return eng


def run_churn(eng):
    """The reference's run_churn with the port's types."""
    from kueue_tpu_torch.api.types import PodSet, Workload

    for k in range(24):
        if k < 18:
            eng.clock += 0.01
            eng.submit(Workload(
                name=f"high{k}", queue_name=f"lq{k % 9}", priority=10,
                pod_sets=(PodSet("main", 1, {"cpu": 2000}),)))
        r = eng.schedule_once()
        if r is not None and r.stats.preempting:
            eng.tick(0.0)
        yield k


def control_fingerprint():
    """The JAX package's unkilled run of the scenario, drained."""
    control = ref.build_world(None)
    for _ in ref.run_churn(control):
        pass
    ref.drain(control)
    return ref.fingerprint(control)


def redrive_and_drain(rebuilt):
    """Submit the high-priority workloads the child never got to, then
    drain (the reference's continuation)."""
    from kueue_tpu_torch.api.types import PodSet, Workload

    for k in range(18):
        if f"default/high{k}" not in rebuilt.workloads:
            rebuilt.clock += 0.01
            rebuilt.submit(Workload(
                name=f"high{k}", queue_name=f"lq{k % 9}", priority=10,
                pod_sets=(PodSet("main", 1, {"cpu": 2000}),)))
    ref.drain(rebuilt)
    return ref.fingerprint(rebuilt)


def test_sigkill_mid_churn_then_restart_matches_jax_control(tmp_path):
    from kueue_tpu_torch.store.journal import rebuild_engine

    path = str(tmp_path / "j.jsonl")
    child = spawn_child(path)
    seen = 0
    deadline = time.monotonic() + 120
    while seen < 6:
        line = child.stdout.readline()
        assert line, f"child exited early: {child.stderr.read()[-800:]}"
        if line.startswith("cycle"):
            seen += 1
        assert time.monotonic() < deadline
    os.kill(child.pid, signal.SIGKILL)
    child.wait(timeout=30)
    assert child.returncode == -signal.SIGKILL

    rebuilt = rebuild_engine(path, device="cpu")
    wl_state, usage = ref.fingerprint(rebuilt)
    assert wl_state, "journal rebuilt an empty world"
    expect_usage: dict = {}
    for info in rebuilt.cache.workloads.values():
        cqu = expect_usage.setdefault(info.cluster_queue, {})
        for fr, v in info.usage().items():
            k = (fr.flavor, fr.resource)
            cqu[k] = cqu.get(k, 0) + v
    assert usage == {n: u for n, u in expect_usage.items() if u}

    assert redrive_and_drain(rebuilt) == control_fingerprint(), (
        "the port's restart from its journal diverged from the JAX "
        "package's unkilled control")
