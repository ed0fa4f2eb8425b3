"""The fused classical-preemption cycle of the port vs the JAX package's,
on the CPU: every output of cycle_step on every cycle of the preemption
world (kueue_tpu_torch/bench/preempt_world.py) at 4 cohorts x 5
ClusterQueues, the bridge's argument helpers (adm_padded,
cq_policy_cfg, slot_maybe) and encode_admitted against the JAX
package's on the same engine worlds, every cycle the JAX package's own
engine sends on the churn worlds of tests/test_preempt_churn.py and the
fair worlds of tests/test_fair_device.py, and the constants
chip_smoke.py pins for the full-width world, recomputed from the JAX
package."""

import dataclasses
import enum
import random

import numpy as np
import pytest

import chip_smoke
import test_classical_preempt_device as tcp
from kueue_tpu.api.types import WorkloadConditionType
from kueue_tpu.oracle.service import LocalExecutor
from kueue_tpu.tensor.schema import encode_admitted as j_encode_admitted
from kueue_tpu_torch import carry
from kueue_tpu_torch.bench import preempt_world
from kueue_tpu_torch.oracle import engine_bridge as eb
from kueue_tpu_torch.oracle.service import TorchExecutor
from kueue_tpu_torch.tensor.schema import encode_admitted
from kueue_tpu_torch.workload_info import PodSetResources, WorkloadInfo
from test_torch_drain import to_port

PREEMPT_KEYS = ("cycles", "admitted", "preempting", "victims", "overflow",
                "checksum")


def assert_outputs_equal(got, want, label=""):
    assert len(got) == len(want) == 14
    for i, (g, x) in enumerate(zip(got, want)):
        x = np.asarray(x)
        assert g.dtype == x.dtype and g.shape == x.shape, (label, i)
        np.testing.assert_array_equal(g, x, err_msg=f"{label} output {i}")


def test_fused_cycle_matches_jax_on_the_small_world():
    """Each cycle runs through both executors on the same arguments;
    the loop carries the port's outputs on."""
    world = preempt_world.build(**preempt_world.SMALL, device="cpu")
    jx, tx = LocalExecutor(), TorchExecutor("cpu")
    seen = dict(preempting=0, victims=0, cycles=0)

    def both(tensors, statics):
        got = tx.cycle_step(tensors, statics)
        assert_outputs_equal(got, jx.cycle_step(tensors, statics),
                             f"cycle {seen['cycles']}")
        seen["cycles"] += 1
        seen["preempting"] += int(got[9].sum())
        seen["victims"] += int(got[12].sum())
        return got

    stats = preempt_world.run(world, both)
    assert stats["cycles"] == seen["cycles"] > 3
    assert seen["preempting"] > 0 and seen["victims"] > 0
    assert stats["admitted"] > 0


def bridge_world(seed):
    rng = random.Random(31 * seed + 5)
    eng, _ = tcp.build_engine(rng)
    eng.attach_oracle()
    bridge = eng.oracle
    w = bridge._world_tensors()
    _, adm = bridge._encode_admitted(w)
    specs = {n: to_port(eng.cache.cluster_queues[n]) for n in w.cq_names}
    return (bridge, w, adm, carry.world_tensors(vars(w)),
            carry.admitted_tensors(vars(adm)), specs)


@pytest.mark.parametrize("seed", range(6))
def test_bridge_argument_helpers_match_jax(seed):
    bridge, w, adm, tw, tadm, specs = bridge_world(seed)
    want_cfg = bridge._cq_policy_cfg(w)
    got_cfg = eb.cq_policy_cfg(tw, specs)
    assert set(got_cfg) == set(want_cfg) - {"j"}
    for k, v in got_cfg.items():
        assert v.dtype == want_cfg[k].dtype, k
        np.testing.assert_array_equal(v, want_cfg[k], err_msg=k)
    want_ap = bridge._adm_padded(adm, w)
    got_ap = eb.adm_padded(tadm, tw)
    assert set(got_ap) == set(want_ap)
    for k, v in got_ap.items():
        x = np.asarray(want_ap[k])
        assert v.dtype == x.dtype, k
        np.testing.assert_array_equal(v, x, err_msg=k)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        head_pri = rng.integers(0, 10, w.num_cqs).astype(np.int64)
        bridge._maybe_memo = None
        np.testing.assert_array_equal(
            eb.slot_maybe(tw, got_cfg, tadm, head_pri),
            bridge._slot_maybe(w, want_cfg, adm, head_pri))


def port_info(info):
    return WorkloadInfo(
        obj=to_port(info.obj), cluster_queue=info.cluster_queue,
        total_requests=[PodSetResources(p.name, p.count, dict(p.requests),
                                        dict(p.flavors))
                        for p in info.total_requests])


@pytest.mark.parametrize("seed", range(4))
def test_encode_admitted_matches_jax(seed):
    rng = random.Random(31 * seed + 5)
    eng, _ = tcp.build_engine(rng)
    from kueue_tpu.tensor.schema import encode_snapshot
    world = encode_snapshot(eng.cache.snapshot(), max_depth=4)
    infos = [info for cqs in eng.cache.snapshot().cluster_queues.values()
             for info in cqs.workloads.values()]
    assert infos
    # A later clock, and one admitted workload flagged evicted.
    now = eng.clock + 3.5
    infos[0].obj.set_condition(WorkloadConditionType.EVICTED, True,
                               now=now)
    want = j_encode_admitted(world, infos, now=now)
    got = encode_admitted(carry.world_tensors(vars(world)),
                          [port_info(i) for i in infos], now=now)
    assert got.evicted.any()
    for f in dataclasses.fields(got):
        g, x = getattr(got, f.name), getattr(want, f.name)
        if isinstance(x, np.ndarray):
            assert g.dtype == x.dtype, f.name
            np.testing.assert_array_equal(g, x, err_msg=f.name)
        else:
            assert g == x, f.name


def test_full_preemption_world_constants_are_the_jax_packages():
    """chip_smoke.py phase 9 pins the JAX package's outcome on the
    1,000-ClusterQueue world; recompute it through the JAX executor, and
    run the port's CPU path to the same numbers. The JAX package's own
    classical drain admits the same fill."""
    world = preempt_world.build(**preempt_world.FULL, device="cpu")
    from kueue_tpu.cache.snapshot import build_snapshot as j_snapshot
    from kueue_tpu.oracle import batched as jb
    jfill = to_jax_fill(world)
    _, jst = jb.BatchedDrainSolver(j_snapshot(*jfill[:3], []),
                                   jfill[3]).solve()
    np.testing.assert_array_equal(jst["admit_cycle"] >= 0,
                                  world.fill_admitted)
    want = preempt_world.run(world, LocalExecutor().cycle_step)
    assert {k: want[k] for k in PREEMPT_KEYS} == chip_smoke.PREEMPT_EXPECT
    got = preempt_world.run(world, TorchExecutor("cpu").cycle_step)
    assert {k: got[k] for k in PREEMPT_KEYS} == chip_smoke.PREEMPT_EXPECT


def to_jax_fill(world):
    """The fill's ClusterQueues, cohorts, flavors and WorkloadInfos as
    the JAX package's objects, field for field."""
    from kueue_tpu.api import types as jt
    from kueue_tpu.workload_info import WorkloadInfo as JInfo

    def to_jax(obj):
        if isinstance(obj, enum.Enum):
            return getattr(jt, type(obj).__name__)(obj.value)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            cls = getattr(jt, type(obj).__name__)
            return cls(**{f.name: to_jax(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)
                          if f.name != "status"})
        if isinstance(obj, (tuple, list)):
            return type(obj)(to_jax(x) for x in obj)
        if isinstance(obj, dict):
            return {to_jax(k): to_jax(v) for k, v in obj.items()}
        return obj

    infos = [JInfo.from_workload(to_jax(i.obj), i.cluster_queue)
             for i in world.infos[:world.n_fill]]
    return (to_jax(world.cluster_queues), to_jax(world.cohorts),
            to_jax(world.flavors), infos)


class ComparingExecutor(LocalExecutor):
    """The JAX executor, with every cycle_step and classical_targets call
    also run by the port's executor on the same arrays and compared. A
    mismatch, or an exception the port raised, is recorded, not raised:
    the JAX engine would take an exception as a reason to fall back for
    the cycle, and the test would not see it."""

    def __init__(self):
        self.torch = TorchExecutor("cpu")
        self.calls = {"cycle_step": 0, "classical_targets": 0}
        self.fused = 0
        self.masked = 0  # cycles with a non-trivial wl_flavor_ok
        self.overridden = 0  # cycles with the sim nomination's overrides
        self.mismatches = []

    def _compare(self, op, want, port_call):
        self.calls[op] += 1
        try:
            got = port_call()
        except Exception as e:
            self.mismatches.append((op, self.calls[op], repr(e)))
            return
        for i, (g, x) in enumerate(zip(got, want)):
            x = np.asarray(x)
            if g.dtype != x.dtype or not np.array_equal(g, x):
                self.mismatches.append((op, self.calls[op], i))

    def cycle_step(self, tensors, statics):
        want = super().cycle_step(tensors, statics)
        arrays = {k: np.array(v) for k, v in tensors.items()}
        ok = arrays.get("wl_flavor_ok")
        if ok is not None and not ok.all():
            self.masked += 1
        if "slot_kind_override" in arrays:
            self.overridden += 1
        if "adm_cq" in arrays and not statics.get("fair_mode"):
            self.fused += 1
        self._compare("cycle_step", want,
                      lambda: self.torch.cycle_step(arrays, statics))
        return want

    def classical_targets(self, tensors, statics, derived=None):
        want = super().classical_targets(tensors, statics, derived)
        arrays = {k: np.array(v) for k, v in tensors.items()}
        self._compare("classical_targets", want,
                      lambda: self.torch.classical_targets(arrays, statics))
        return want


@pytest.mark.parametrize("seed", range(4))
def test_engine_churn_cycles_match_jax(seed):
    """tests/test_preempt_churn.py's hierarchical worlds under submit /
    finish / preempt churn, driven by the JAX package's engine: every
    cycle the bridge sends (fused preemption with borrowWithinCohort,
    nested cohorts and the admitted set padded by the bridge) gives the
    same 14 outputs in the port."""
    import test_preempt_churn as tpc

    eng, n_cqs = tpc.build_engine(True, seed)
    ex = ComparingExecutor()
    eng.oracle.executor = ex
    tpc.churn(eng, n_cqs, seed)
    assert not ex.mismatches, ex.mismatches[:5]
    assert ex.calls["cycle_step"] > 0 and ex.fused > 0


@pytest.mark.parametrize("seed", range(3))
def test_engine_fair_cycles_match_jax(seed):
    """tests/test_fair_device.py's nested fair-sharing worlds driven by
    the JAX package's engine: every fair cycle the bridge sends gives the
    same 14 outputs in the port."""
    import test_fair_device as tfd

    eng, n_cqs = tfd.make_nested_engine(True, random.Random(seed),
                                        deep=seed % 2 == 1)
    ex = ComparingExecutor()
    eng.oracle.executor = ex
    tfd.populate(eng, n_cqs, n=24, seed=seed * 11 + 1)
    tfd.drain(eng)
    assert not ex.mismatches, ex.mismatches[:5]
    assert ex.calls["cycle_step"] > 0


@pytest.mark.parametrize("seed", range(2))
def test_engine_multiflavor_cycles_match_jax(seed):
    """tests/test_multiflavor_preempt_device.py's worlds driven by the JAX
    package's engine: every cycle the bridge sends, the sim nomination's
    slot overrides and victim lists included, gives the same 14 outputs
    in the port, and the port raises on none."""
    import test_multiflavor_preempt_device as tmf

    eng = tmf.build_engine(True, random.Random(1000 + seed))
    ex = ComparingExecutor()
    eng.oracle.executor = ex
    tmf.churn(eng, random.Random(seed))
    assert not ex.mismatches, ex.mismatches[:5]
    assert ex.overridden > 0 and ex.calls["classical_targets"] > 0


def test_engine_flavor_mask_cycles_match_jax():
    """A world whose workloads select nodes (per-workload flavor masks),
    driven by the JAX package's engine: every cycle with a non-trivial
    wl_flavor_ok mask gives the same 14 outputs in the port."""
    import test_torch_engine as tte

    eng = tte.node_selector_world(oracle=True, seed=3)
    ex = ComparingExecutor()
    eng.oracle.executor = ex
    tte.node_selector_traffic(eng, seed=3)
    assert not ex.mismatches, ex.mismatches[:5]
    assert ex.masked > 0


def test_executor_and_fair_solver_default_to_cuda():
    import torch

    from kueue_tpu_torch.bench.scenario import hierarchical_fair
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    scen = hierarchical_fair(n_roots=1, n_workloads=8)
    snap = build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                          [])
    if torch.cuda.is_available():
        assert TorchExecutor().device.type == "cuda"
        assert BatchedDrainSolver(snap, scen.pending_infos(),
                                  fair=True).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchExecutor()
        with pytest.raises(RuntimeError):
            BatchedDrainSolver(snap, scen.pending_infos(), fair=True)
    assert TorchExecutor("cpu").device.type == "cpu"
