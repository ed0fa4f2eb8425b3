"""The MultiKueue world of chip_smoke.py phase 33 (kueue_tpu_torch/bench/
multikueue_worlds.py) recomputed on the CPU.

At SMALL size (800 entries over 20 ClusterQueues, a manager and three
workers, 9 cycles on the default loop) the port drives the world and
its pinned numbers (per engine: cycles, admissions, decision-stream
crc32, device / hybrid / fallback cycles, evictions by reason and
pipeline_stats; the dispatches by mode and cluster and the controllers'
counts) equal the JAX package's, pinned here; every path the world is
for runs in it and in chip_smoke.py's full-width constant. The JAX
engines' runs are slow on the CPU (each compiles the preemption program
of worker1's shapes), so they are marked slow: at SMALL both packages
drive the world and every engine's event stream, final workloads and
dispatch series are equal, and at FULL the JAX engines alone give the
numbers chip_smoke.py pins. Exact throughout."""

import pytest
import torch

import chip_smoke
from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.config import features as jfeatures
from kueue_tpu.controllers import admissionchecks as jac
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu.controllers import multikueue as jmk
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import multikueue_worlds as mw
from kueue_tpu_torch.config import features as pfeatures
from test_torch_engine import outcome

_PS5 = dict(speculated=5, used=0, discarded=5, skipped=4)
_PS3 = dict(speculated=3, used=0, discarded=3, skipped=2)
_PS0 = dict(speculated=0, used=0, discarded=0, skipped=0)
SMALL_EXPECT = {
    "manager": dict(cycles=9, admitted=180, preempting=0, preemptions=0,
                    checksum=0x584eb7e1, on_device=9, hybrid=0, fallback=0,
                    overridden=0, evicted={"MultiKueueClusterLost": 8},
                    pipeline_stats=_PS5),
    "worker1": dict(cycles=9, admitted=75, preempting=2, preemptions=2,
                    checksum=0xbd038028, on_device=9, hybrid=9, fallback=0,
                    overridden=0, evicted={"Preempted": 2},
                    pipeline_stats=_PS3),
    "worker2": dict(cycles=9, admitted=158, preempting=0, preemptions=0,
                    checksum=0xec1757cd, on_device=9, hybrid=4, fallback=0,
                    overridden=0, evicted={}, pipeline_stats=_PS0),
    "worker3": dict(cycles=9, admitted=154, preempting=0, preemptions=0,
                    checksum=0xb7b4d969, on_device=9, hybrid=0, fallback=0,
                    overridden=0, evicted={}, pipeline_stats=_PS0),
    "dispatched_by": {"AllAtOnce/worker1": 162, "AllAtOnce/worker2": 155,
                      "AllAtOnce/worker3": 154, "Incremental/worker1": 18,
                      "Incremental/worker2": 4},
    "evicted": 10, "dispatched": 493, "remote_deletes": 358,
    "gc_collected": 37, "gates_opened": 3, "remote_finishes": 35,
    "finishes_synced": 35, "outage_finishes": 4, "outage_propagated": 4,
    "adopted": 1, "connect_failures": 3, "deleted": 2, "quota_automated": 2,
    "jobs_mirrored": 5, "jobs_started": 5, "fell_through": 87,
    "rounds_grown": 4}


def jax_kit():
    return ew.Kit(jtypes, jscenario,
                  lambda fair=False, **kw: JEngine(
                      enable_fair_sharing=fair, **kw),
                  lambda eng: eng.attach_oracle(), admissionchecks=jac,
                  jobframework=jjf, multikueue=jmk, features=jfeatures)


@pytest.fixture
def one_thread():
    """The port's CPU cycles on one thread: four engines' small tensor
    programs gain nothing from more and the box is shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def events(eng):
    return [(e.time, e.kind, e.workload, e.cluster_queue, e.detail)
            for e in eng.events]


def test_small_world_pinned_on_the_port(one_thread):
    got = mw.pinned(mw.run(mw.SMALL["multikueue_world"],
                           kit=ew.port_kit("cpu")))
    assert got == SMALL_EXPECT
    # The world restores the gates it turns on.
    for name in mw.GATES:
        assert not pfeatures.enabled(name)


def test_world_drives_every_path():
    """The pinned runs drive what the world is for, at both sizes: every
    listed path of chip_smoke.py's phase 33 is above 0, device cycles in
    every engine, preemption on worker1 only."""
    for want in (SMALL_EXPECT, chip_smoke.MULTIKUEUE_EXPECT):
        for k in chip_smoke.MULTIKUEUE_PATHS:
            assert want[k] > 0, k
        for name in mw.ENGINES:
            assert want[name]["on_device"] == want[name]["cycles"] > 0
        assert want["worker1"]["preemptions"] > 0
        assert set(want["dispatched_by"]) == {
            "AllAtOnce/worker1", "AllAtOnce/worker2", "AllAtOnce/worker3",
            "Incremental/worker1", "Incremental/worker2"}


@pytest.mark.slow
def test_small_world_equal_in_both_packages(one_thread):
    """Both packages drive SMALL: the same pinned numbers, and every
    engine's events, final workloads and metrics series equal."""
    j = mw.run(mw.SMALL["multikueue_world"], kit=jax_kit())
    p = mw.run(mw.SMALL["multikueue_world"], kit=ew.port_kit("cpu"))
    assert mw.pinned(j) == mw.pinned(p) == SMALL_EXPECT
    for je, pe in zip(j["engines"], p["engines"]):
        assert events(pe) == events(je)
        assert list(pe.workloads) == list(je.workloads)
        for key, wl in je.workloads.items():
            assert outcome(pe.workloads[key]) == outcome(wl), key
        for fam in ("workloads_dispatched_total", "evicted_workloads_total",
                    "admitted_workloads_total"):
            assert pe.registry.counter(fam).values == \
                je.registry.counter(fam).values, fam
    for jc, pc in zip(j["controllers"], p["controllers"]):
        assert {k: (s.nominated, s.created, s.cluster_name)
                for k, s in pc.states.items()} == \
            {k: (s.nominated, s.created, s.cluster_name)
             for k, s in jc.states.items()}
        assert pc.cq_conditions == jc.cq_conditions


@pytest.mark.slow
def test_full_run_matches_chip_smoke():
    got = mw.pinned(mw.run(mw.FULL["multikueue_world"], kit=jax_kit()))
    print(f"multikueue_world: {got}")
    assert got == chip_smoke.MULTIKUEUE_EXPECT
