"""The PyTorch port's batched drain (kueue_tpu_torch/oracle/batched.py)
vs the JAX package's, on the CPU: one cycle at a time, whole drains,
the copied encoder and the carried-across encoded world.

The 512-workload problem is the one the multichip dry run reports:
18 cycles, 207 admitted, decision checksum 0x6a18f8b7 (the crc32 of the
int32 admit_cycle, admit_pos and wl_flavor arrays). chip_smoke.py holds
the port to the same numbers on the card. Exact throughout: decisions
are integers."""

import dataclasses
import enum
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_drain_parity
from kueue_tpu.api.types import ResourceFlavor as JResourceFlavor
from kueue_tpu.bench.scenario import baseline_like as j_baseline_like
from kueue_tpu.cache.snapshot import build_snapshot as j_build_snapshot
from kueue_tpu.oracle import batched as jb
from kueue_tpu.workload_info import WorkloadInfo as JWorkloadInfo
from kueue_tpu_torch import carry
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench.scenario import baseline_like
from kueue_tpu_torch.cache.snapshot import build_snapshot
from kueue_tpu_torch.oracle import batched as tb
from kueue_tpu_torch.oracle import engine_bridge as eb
from kueue_tpu_torch.tensor.schema import (
    AdmittedTensors,
    WorkloadTensors,
    WorldTensors,
)
from kueue_tpu_torch.workload_info import WorkloadInfo

SMALL = dict(n_cohorts=4, cqs_per_cohort=4, n_workloads=512,
             nominal_per_cq=40000, sized_to_fit=False)
SMALL_EXPECT = (18, 207, 0x6a18f8b7)


def checksum(stats) -> int:
    return zlib.crc32(stats["admit_cycle"].tobytes()
                      + stats["admit_pos"].tobytes()
                      + stats["wl_flavor"].tobytes())


def to_port(obj):
    """The port's API object with the same field values as a JAX
    package API object (recursively; fields the port lacks are
    dropped)."""
    if isinstance(obj, enum.Enum):
        return getattr(ptypes, type(obj).__name__)(obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(ptypes, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    return obj


def decision_rows(decisions):
    return [(d.key, d.cluster_queue, d.cycle, d.position, d.flavors,
             d.podset_flavors) for d in decisions]


def assert_same_fields(port_obj, jax_obj):
    for f in dataclasses.fields(port_obj):
        got, want = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name


def assert_same_drain(port_solver, jax_solver):
    assert_same_fields(port_solver.world, jax_solver.world)
    assert_same_fields(port_solver.wls, jax_solver.wls)
    jd, jst = jax_solver.solve()
    td, tst = port_solver.solve()
    for key in ("cycles", "needs_oracle", "admitted"):
        assert tst[key] == jst[key], key
    for key in ("admit_cycle", "admit_pos", "wl_flavor", "final_usage"):
        assert tst[key].dtype == jst[key].dtype, key
        np.testing.assert_array_equal(tst[key], jst[key], err_msg=key)
    assert decision_rows(td) == decision_rows(jd)
    return tst


@pytest.fixture(scope="module")
def small_jax():
    scen = j_baseline_like(**SMALL)
    solver = jb.BatchedDrainSolver(
        j_build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                         []), scen.pending_infos())
    return solver, solver.solve()[1]


def small_port():
    scen = baseline_like(**SMALL)
    return tb.BatchedDrainSolver(
        build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                       []), scen.pending_infos(), device="cpu")


def test_small_drain_checksum(small_jax):
    jax_solver, jst = small_jax
    assert (jst["cycles"], jst["admitted"], checksum(jst)) == SMALL_EXPECT
    tst = assert_same_drain(small_port(), jax_solver)
    assert (tst["cycles"], tst["admitted"], checksum(tst)) == SMALL_EXPECT


def test_cycle_step_matches_jax(small_jax):
    """Three chained cycles, each side on its own state: all 14 outputs
    element-wise equal."""
    jax_solver, _ = small_jax
    port = small_port()
    host = port._host_args()
    w = port.world
    statics = port._statics()
    j_state = (np.asarray(port.wls.eligible & (port.wls.cq >= 0)),
               np.zeros(port.wls.num_workloads, bool), w.usage)
    t_state = tuple(torch.as_tensor(np.array(a)) for a in j_state)
    j_args = {k: jnp.asarray(v) for k, v in jax_solver._host_args().items()}
    t_args = port._to_device(host)
    for _ in range(3):
        want = jb.cycle_step(*map(jnp.asarray, j_state), **j_args,
                             **statics)
        got = tb.cycle_step(*t_state, **t_args, **statics)
        assert len(got) == len(want) == 14
        for i, (g, x) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                          err_msg=f"output {i}")
        j_state = tuple(np.asarray(x) for x in want[:3])
        t_state = got[:3]
    assert got[3].any()


def test_solve_one_cycle_matches_jax(small_jax):
    jax_solver, _ = small_jax
    want_ids, want_usage = jax_solver.solve_one_cycle()
    got_ids, got_usage = small_port().solve_one_cycle()
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_usage, want_usage)


@pytest.mark.parametrize("seed", range(6))
def test_drain_matches_jax_on_engine_parity_worlds(seed):
    rng = random.Random(seed + 7)
    cqs, cohorts = test_drain_parity.build_world(rng)
    workloads = test_drain_parity.build_workloads(rng, len(cqs))
    flavors = [JResourceFlavor(f) for f in test_drain_parity.FLAVORS]
    lq_to_cq = {f"lq{i}": f"cq{i}" for i in range(len(cqs))}
    jax_solver = jb.BatchedDrainSolver(
        j_build_snapshot(cqs, cohorts, flavors, []),
        [JWorkloadInfo.from_workload(w, lq_to_cq[w.queue_name])
         for w in workloads])
    p_cqs, p_cohorts, p_flavors, p_workloads = to_port(
        (cqs, cohorts, flavors, workloads))
    port_solver = tb.BatchedDrainSolver(
        build_snapshot(p_cqs, p_cohorts, p_flavors, []),
        [WorkloadInfo.from_workload(w, lq_to_cq[w.queue_name])
         for w in p_workloads], device="cpu")
    tst = assert_same_drain(port_solver, jax_solver)
    assert tst["admitted"] > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_encoder_matches_jax_on_baseline_scenario(seed):
    kw = dict(SMALL, seed=seed)
    jscen, pscen = j_baseline_like(**kw), baseline_like(**kw)
    jax_solver = jb.BatchedDrainSolver(
        j_build_snapshot(jscen.cluster_queues, jscen.cohorts,
                         jscen.flavors, []), jscen.pending_infos())
    port_solver = tb.BatchedDrainSolver(
        build_snapshot(pscen.cluster_queues, pscen.cohorts, pscen.flavors,
                       []), pscen.pending_infos(), device="cpu")
    assert_same_fields(port_solver.world, jax_solver.world)
    assert_same_fields(port_solver.wls, jax_solver.wls)
    np.testing.assert_array_equal(port_solver.head_ranks(),
                                  jax_solver.head_ranks())
    np.testing.assert_array_equal(port_solver.commit_ranks(),
                                  jax_solver.commit_ranks())


def test_carry_round_trip(small_jax):
    jax_solver, jst = small_jax
    world = carry.world_tensors(vars(jax_solver.world))
    wls = carry.workload_tensors(vars(jax_solver.wls))
    assert isinstance(world, WorldTensors)
    assert isinstance(wls, WorkloadTensors)
    assert_same_fields(world, jax_solver.world)
    assert_same_fields(wls, jax_solver.wls)
    on_cpu = carry.to_device(world, "cpu")
    for f in dataclasses.fields(world):
        value = getattr(world, f.name)
        if isinstance(value, np.ndarray):
            moved = getattr(on_cpu, f.name)
            assert isinstance(moved, torch.Tensor)
            np.testing.assert_array_equal(moved.numpy(), value)
    solver = tb.BatchedDrainSolver.from_tensors(
        vars(jax_solver.world), vars(jax_solver.wls), device="cpu")
    tst = solver.solve()[1]
    assert (tst["cycles"], tst["admitted"], checksum(tst)) == SMALL_EXPECT
    with pytest.raises(ValueError):
        carry.world_tensors({"num_cqs": 1})


def _ported_extras(port, case):
    """Arguments of a path the port now runs: the fair cycle, the fused
    preemption (an empty admitted set, padded as the bridge pads it),
    host-provided victim lists (inert without a preempting entry), and
    the fair cycle given an admitted set it must ignore."""
    w = port.world
    C = w.num_cqs
    adm = AdmittedTensors(
        num_admitted=0, keys=[], cq=np.zeros(0, np.int32),
        priority=np.zeros(0, np.int64), timestamp=np.zeros(0),
        qr_time=np.zeros(0), uid_rank=np.zeros(0, np.int64),
        evicted=np.zeros(0, bool), usage=np.zeros((0, 1), np.int64))
    ap = eb.adm_padded(adm, w)
    pcfg = eb.cq_policy_cfg(w, {q: ptypes.ClusterQueue(q, cohort="c")
                                for q in w.cq_names})
    fused = dict(
        adm_cq=ap["adm_cq"], adm_pri=ap["adm_pri"], adm_ts=ap["adm_ts"],
        adm_qrt=ap["adm_qrt"], adm_uid=ap["adm_uid"],
        adm_evicted=ap["adm_ev"], adm_usage=ap["adm_usage"],
        adm_rank=ap["adm_rank"], adm_by_root=ap["adm_by_root"],
        root_of_cq=w.root_of_cq, slot_maybe=np.ones(C, bool),
        **{f"pc_{k}": v for k, v in pcfg.items()})
    victims = dict(slot_victim_row=np.full((C, 4), -1, np.int32),
                   slot_victim_vals=np.zeros((C, 4, 1), np.int64),
                   slot_victim_ids=np.full((C, 4), -1, np.int32),
                   claimed0=np.zeros(8, bool))
    return {"fair_mode": ({}, True), "adm_cq": (fused, False),
            "victims": (victims, False), "fair_mode_adm": (fused, True)}[case]


@pytest.mark.parametrize("case", ["fair_mode", "adm_cq", "victims",
                                  "fair_mode_adm"])
def test_ported_paths_run(small_jax, case):
    """Two chained cycles of each path: all 14 outputs equal to the JAX
    cycle's."""
    jax_solver, _ = small_jax
    port = small_port()
    extra, fair = _ported_extras(port, case)
    statics = dict(port._statics(), fair_mode=fair)
    j_args = {k: jnp.asarray(v) for k, v in
              dict(jax_solver._host_args(), **extra).items()}
    t_args = port._to_device(dict(port._host_args(), **extra))
    j_state = (np.asarray(port.wls.eligible & (port.wls.cq >= 0)),
               np.zeros(port.wls.num_workloads, bool), port.world.usage)
    t_state = tuple(torch.as_tensor(np.array(a)) for a in j_state)
    for _ in range(2):
        want = jb.cycle_step(*map(jnp.asarray, j_state), **j_args, **statics)
        got = tb.cycle_step(*t_state, **t_args, **statics)
        assert len(got) == len(want) == 14
        for i, (g, x) in enumerate(zip(got, want)):
            assert g.numpy().dtype == np.asarray(x).dtype, f"output {i}"
            np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                          err_msg=f"output {i}")
        j_state = tuple(np.asarray(x) for x in want[:3])
        t_state = got[:3]
    assert got[3].any()


@pytest.mark.parametrize("unported", [
    dict(slot_kind_override=torch.zeros(16, dtype=torch.int32)),
    dict(slot_borrows_override=torch.zeros(16, dtype=torch.int32)),
    dict(slot_flavor_override=torch.zeros((16, 1), dtype=torch.int32)),
    dict(wl_flavor_ok=torch.ones((512, 1), dtype=torch.bool)),
], ids=["kind_override", "borrows_override", "flavor_override",
        "flavor_ok"])
def test_unported_paths_raise(unported):
    port = small_port()
    args = port._to_device(port._host_args())
    state = (torch.ones(512, dtype=torch.bool),
             torch.zeros(512, dtype=torch.bool),
             torch.as_tensor(port.world.usage))
    statics = dict(port._statics(), **unported)
    with pytest.raises(NotImplementedError):
        tb.cycle_step(*state, **args, **statics)
    with pytest.raises(TypeError):
        tb.cycle_step(*state, **args, **port._statics(), no_such_arg=1)


def test_solver_defaults_to_cuda():
    scen = baseline_like(n_cohorts=1, cqs_per_cohort=1, n_workloads=4)
    snap = build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                          [])
    if torch.cuda.is_available():
        solver = tb.BatchedDrainSolver(snap, scen.pending_infos())
        assert solver.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tb.BatchedDrainSolver(snap, scen.pending_infos())
