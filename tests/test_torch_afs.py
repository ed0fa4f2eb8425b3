"""Admission fair sharing (kueue_tpu_torch/controllers/afs.py, the
four-part heap key of cache/queues.py and the row cache's ``key_afs``
rank) and WorkloadPriorityClasses in the port's engine, against the JAX
package's engine on the same calls.

The reference tests run through ``MirroredEngine`` (tests/test_torch_engine.py)
with ``MirroredAfsManager`` patched in for the JAX ``AfsManager``: every
cycle's decisions, the admission order (the Admitted events), each
LocalQueue's decayed usage bit for bit and every workload's outcome must
equal the JAX engine's, on the sequential path and on the device path.
Exact throughout."""

import random

import numpy as np
import pytest

import test_hybrid_cycles
import test_lifecycle_features
import test_rowcache
from kueue_tpu.api.types import (
    ClusterQueue,
    Cohort,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_tpu.config.api import AdmissionFairSharingConfig as JAfsConfig
from kueue_tpu.controllers import admissionchecks as jchecks
from kueue_tpu.controllers import afs as jafs
from test_torch_engine import (  # noqa: F401  (mirrored is a fixture)
    MirroredAfsManager,
    MirroredCheckManager,
    MirroredEngine,
    OracleMirroredEngine,
    mirrored,
)

from kueue_tpu_torch.config.api import AdmissionFairSharingConfig
from kueue_tpu_torch.controllers import afs as pafs

AFS = "UsageBasedAdmissionFairSharing"


@pytest.fixture
def mirrored_afs(mirrored, monkeypatch):
    """``mirrored``, and the managers a reference test attaches built
    with their port twins."""
    monkeypatch.setattr(jafs, "AfsManager", MirroredAfsManager)
    monkeypatch.setattr(jchecks, "AdmissionCheckManager",
                        MirroredCheckManager)
    monkeypatch.setattr(test_lifecycle_features, "AfsManager",
                        MirroredAfsManager)
    yield


@pytest.mark.parametrize("name", [
    "test_afs_world_runs_on_device_with_matching_order",
    "test_afs_stale_heap_keys_device_parity"])
def test_hybrid_afs_worlds(mirrored_afs, name):
    """tests/test_hybrid_cycles.py's AFS worlds (seeded LocalQueue usage,
    a wrapped on_admit recording the order, keys frozen at push), each
    built sequential and with the oracle."""
    getattr(test_hybrid_cycles, name)()


@pytest.mark.parametrize("engine", [MirroredEngine, OracleMirroredEngine],
                         ids=["sequential", "device"])
@pytest.mark.parametrize("name", [
    "test_afs_orders_by_local_queue_usage",
    "test_workload_priority_class_resolution",
    "test_admission_checks_strategy_scopes_by_flavor"])
def test_lifecycle_worlds(mirrored_afs, monkeypatch, engine, name):
    """tests/test_lifecycle_features.py's AFS, WorkloadPriorityClass and
    flavor-scoped admission-check cases, on the host cycle and through
    the oracle."""
    monkeypatch.setattr(test_lifecycle_features, "Engine", engine)
    getattr(test_lifecycle_features, name)()


def test_decay_matches_jax_bitwise():
    """Reading usage decays it in place: the same reads and penalties at
    the same clocks, and the same decay steps, leave the same bits."""
    class Clock:
        clock = 0.0
        on_admit = None

        class queues:
            lq_usage_fn = None

    cfg = dict(usage_half_life_seconds=600,
               resource_weights={"cpu": 0.5})
    jm = jafs.AfsManager(Clock(), JAfsConfig(**cfg))
    pm = pafs.AfsManager(Clock(), AdmissionFairSharingConfig(**cfg))
    wl = Workload(name="w", queue_name="lq",
                  pod_sets=(PodSet("main", 3, {"cpu": 1234, "mem": 7}),))
    from kueue_tpu_torch import carry

    pwl = carry.api_object(wl)
    rng = random.Random(5)
    for step in range(40):
        t = step * 37.5 + rng.random()
        jm.engine.clock = pm.engine.clock = t
        if rng.random() < 0.5:
            jm._on_admit(wl, None)
            pm._on_admit(pwl, None)
        assert pm.current_usage("default/lq") == jm.current_usage(
            "default/lq")
    for steps in ((333.0,), (111.0, 333.0), (50.0, 51.0, 333.0)):
        p = pafs._LqUsage(value=1000.0, last_update=0.0)
        j = jafs._LqUsage(value=1000.0, last_update=0.0)
        for t in steps:
            pm._decay(p, t)
            jm._decay(j, t)
        assert (p.value, p.last_update) == (j.value, j.last_update)


def _afs_world(seed: int, oracle: bool, n_cqs=3, n_lqs=4):
    """AFS-scoped ClusterQueues (the last one plain) of ``n_lqs``
    LocalQueues each, tenant usage seeded unevenly, three
    WorkloadPriorityClasses."""
    rng = random.Random(seed)
    eng = MirroredEngine()
    eng.create_resource_flavor(ResourceFlavor("default"))
    eng.create_cohort(Cohort("co"))
    for i in range(n_cqs):
        eng.create_cluster_queue(ClusterQueue(
            name=f"cq{i}", cohort="co",
            admission_scope=AFS if i < n_cqs - 1 else None,
            resource_groups=(ResourceGroup(("cpu",), (FlavorQuotas(
                "default", {"cpu": ResourceQuota(3000)}),)),)))
        for t in range(n_lqs):
            eng.create_local_queue(LocalQueue(f"lq{i}-{t}", "default",
                                              f"cq{i}"))
    MirroredAfsManager(eng, JAfsConfig(usage_half_life_seconds=300))
    for i in range(n_cqs):
        for t in range(n_lqs):
            eng.afs.usage[f"default/lq{i}-{t}"] = jafs._LqUsage(
                value=rng.choice([0.0, 500.0, 2000.0, 9000.0]),
                last_update=0.0)
    for name, value in (("low", 0), ("mid", 100), ("high", 1000)):
        eng.create_workload_priority_class(name, value)
    if oracle:
        eng.attach_oracle()
    return eng, rng


def _submit(eng, rng, i, n_cqs=3, n_lqs=4):
    eng.clock += rng.choice([0.001, 0.5, 3.0])
    eng.submit(Workload(
        name=f"w{i}", queue_name=f"lq{rng.randrange(n_cqs)}-"
        f"{rng.randrange(n_lqs)}",
        priority_class_name=rng.choice(["low", "mid", "high", None]),
        priority=rng.choice([0, 7]),
        pod_sets=(PodSet("main", 1, {"cpu": rng.choice(
            [300, 700, 1500])}),)))


def _assert_rows_equal(eng):
    """The port's row cache ranks and keys every row as the JAX one."""
    j, p = eng.queues.rows, eng.port.queues.rows
    assert p.num_rows == j.num_rows
    n = j.num_rows
    for col in ("key_afs", "key_negpri", "key_ts", "active"):
        np.testing.assert_array_equal(getattr(p, col)[:n],
                                      getattr(j, col)[:n], err_msg=col)
    # Each package numbers its pushes on its own process-wide counter:
    # the sequence keys agree in order, not in value.
    np.testing.assert_array_equal(
        np.argsort(p.key_seq[:n], kind="stable"),
        np.argsort(j.key_seq[:n], kind="stable"))
    np.testing.assert_array_equal(p.head_ranks(), j.head_ranks())


@pytest.mark.parametrize("oracle", [False, True],
                         ids=["sequential", "device"])
@pytest.mark.parametrize("seed", range(3))
def test_afs_priority_class_churn(mirrored, seed, oracle):
    """Submissions across tenants and priority classes, cycles, finishes
    and evictions with backoff: decisions, admission order, usage and
    the row cache's keys and head ranks equal the JAX engine's after
    every step."""
    eng, rng = _afs_world(seed, oracle)
    for i in range(60):
        _submit(eng, rng, i)
        if rng.random() < 0.4:
            eng.schedule_once()
        if rng.random() < 0.2:
            adm = sorted(k for k, w in eng.workloads.items()
                         if w.is_admitted)
            if adm:
                k = adm[rng.randrange(len(adm))]
                if rng.random() < 0.5:
                    eng.finish(k)
                else:
                    eng.evict(eng.workloads[k], "Test",
                              backoff_seconds=rng.choice([0.0, 2.0]))
        _assert_rows_equal(eng)
    for _ in range(40):
        eng.clock += 1.0
        r = eng.schedule_once()
        _assert_rows_equal(eng)
        if r is None:
            break
    if oracle:
        assert eng.oracle.cycles_on_device > 0


def test_rowcache_afs_sort_keys_rank_like_heap(mirrored):
    """tests/test_rowcache.py's rank-versus-pop check with AFS on: the
    port's row ranks reproduce its heap's pop order, usage first, and
    equal the JAX row cache's."""
    eng = MirroredEngine()
    eng.create_resource_flavor(ResourceFlavor("default"))
    eng.create_cluster_queue(ClusterQueue(
        name="cq0", admission_scope=AFS,
        resource_groups=(ResourceGroup(("cpu",), (FlavorQuotas(
            "default", {"cpu": ResourceQuota(4000)}),)),)))
    for t in range(2):
        eng.create_local_queue(LocalQueue(f"lq{t}", "default", "cq0"))
    MirroredAfsManager(eng, JAfsConfig(usage_half_life_seconds=3600))
    eng.afs.usage["default/lq1"] = jafs._LqUsage(value=50.0)
    for i, (pri, t, lq) in enumerate([(0, 3.0, 0), (5, 2.0, 1),
                                      (5, 1.0, 0), (1, 0.5, 1)]):
        eng.clock = t
        eng.submit(Workload(name=f"w{i}", queue_name=f"lq{lq}",
                            priority=pri,
                            pod_sets=(PodSet("main", 1, {"cpu": 100}),)))
    _assert_rows_equal(eng)
    for e in (eng, eng.port):
        rows = e.queues.rows
        rank = rows.head_ranks()
        by_rank = sorted(
            (i for i, info in enumerate(rows.info_of) if info is not None),
            key=lambda i: rank[i])
        names = [rows.info_of[i].obj.name for i in by_rank]
        pcq = e.queues.cluster_queues["cq0"]
        pops = []
        while (head := pcq.pop(eng.clock)) is not None:
            pops.append(head.obj.name)
        assert names == pops == ["w2", "w0", "w1", "w3"]


def test_reference_rowcache_ranks(mirrored, monkeypatch):
    """The reference's own rank test on a mirrored engine; the port's
    rows rank like the JAX ones after its pushes."""
    monkeypatch.setattr(test_rowcache, "Engine", MirroredEngine)
    eng = test_rowcache.make_engine(n_cqs=1)
    for i, (pri, t) in enumerate([(0, 3.0), (5, 2.0), (5, 1.0), (1, 0.5)]):
        eng.clock = t
        eng.submit(Workload(name=f"w{i}", queue_name="lq0", priority=pri,
                            pod_sets=(PodSet("main", 1, {"cpu": 100}),)))
    _assert_rows_equal(eng)
    pcq = eng.port.queues.cluster_queues["cq0"]
    pops = []
    while (head := pcq.pop(eng.clock)) is not None:
        pops.append(head.obj.name)
    assert pops == ["w2", "w1", "w3", "w0"]
    for k in list(eng.workloads):  # leave both worlds alike
        eng.finish(k)


def test_priority_class_resolution_on_submit():
    """A named class sets the priority; an unknown name keeps it."""
    from kueue_tpu_torch.api.types import PodSet as PPodSet
    from kueue_tpu_torch.api.types import Workload as PWorkload
    from kueue_tpu_torch.controllers.engine import Engine

    eng = Engine(device="cpu")
    eng.create_workload_priority_class("high", 1000)
    hi = PWorkload(name="a", priority=3, priority_class_name="high",
                   pod_sets=(PPodSet("main", 1, {"cpu": 1}),))
    other = PWorkload(name="b", priority=3, priority_class_name="nope",
                      pod_sets=(PPodSet("main", 1, {"cpu": 1}),))
    eng.submit(hi)
    eng.submit(other)
    assert (hi.priority, other.priority) == (1000, 3)
