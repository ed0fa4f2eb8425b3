"""The port's fair-sharing commit (kueue_tpu_torch/ops/commit.py
commit_grouped_fair) vs the JAX package's, on the CPU, on the flat and
nested cohort worlds of tests/test_fair_device.py with seeded entries, a
zero-weight borrower, and the fair drain on a small hierarchical_fair
scenario. The worlds are encoded by the JAX package and carried across
with carry.py. Exact: admissions, rounds and usage are integers, and the
float64 DRS keys pick the same winners only if they are bitwise equal."""

import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_fair_device as tfd
from kueue_tpu.bench.scenario import hierarchical_fair as j_hier_fair
from kueue_tpu.cache.snapshot import build_snapshot as j_build_snapshot
from kueue_tpu.ops import commit as jc
from kueue_tpu.ops import quota as jq
from kueue_tpu.oracle import batched as jb
from kueue_tpu.tensor.schema import encode_snapshot
from kueue_tpu_torch import carry
from kueue_tpu_torch.bench.scenario import hierarchical_fair
from kueue_tpu_torch.cache.snapshot import build_snapshot
from kueue_tpu_torch.ops import commit as tc
from kueue_tpu_torch.ops import quota as tq
from kueue_tpu_torch.oracle import batched as tb


def _t(a):
    return torch.as_tensor(np.array(a))


def fair_both(w, entries, usage):
    """commit_grouped_fair on both sides over the carried world ``w``
    with ``entries`` (numpy, by slot) and CQ-row ``usage``."""
    D = w.depth
    args = (w.nominal, w.lend_limit, w.borrow_limit, usage, w.parent)
    jd = jq.derive_world(*map(jnp.asarray, args), depth=D)
    td = tq.derive_world(*map(_t, args), depth=D)
    head = tuple(entries[k] for k in (
        "valid", "fr", "req", "kind", "borrows", "priority", "ts"))
    tail = (w.fair_weight, w.parent, w.root_members, w.root_nodes,
            w.local_chain, w.child_rank, w.local_depth,
            w.root_parent_local)
    world = (w.lend_limit, w.borrow_limit, w.nominal, w.ancestors)
    want = jc.commit_grouped_fair(
        *map(jnp.asarray, head), jd["usage"], jd["subtree_quota"],
        *map(jnp.asarray, world), jd["potential"],
        *map(jnp.asarray, tail), depth=D, num_flavors=max(w.num_flavors, 1))
    got = tc.commit_grouped_fair(
        *map(_t, head), td["usage"], td["subtree_quota"], *map(_t, world),
        td["potential"], *map(_t, tail), depth=D,
        num_flavors=max(w.num_flavors, 1))
    for i, (g, x) in enumerate(zip(got, want)):
        x = np.asarray(x)
        assert g.numpy().dtype == x.dtype, i
        np.testing.assert_array_equal(g.numpy(), x, err_msg=f"output {i}")
    return [np.asarray(x) for x in want]


def seeded_entries(w, rng):
    """One head per ClusterQueue slot, dense per-flavor-resource columns
    as the cycle passes them."""
    C = w.num_cqs
    R = w.nominal.shape[1]
    req = rng.choice([0, 300, 900, 1800, 2500], (C, R)).astype(np.int64)
    return dict(
        valid=rng.random(C) < 0.85,
        fr=np.where(req > 0, np.arange(R, dtype=np.int32)[None, :], -1)
        .astype(np.int32),
        req=req,
        kind=rng.choice([jc.ENTRY_SKIP, jc.ENTRY_FIT, jc.ENTRY_FIT,
                         jc.ENTRY_RESERVE], C).astype(np.int32),
        borrows=rng.integers(0, 3, C).astype(np.int32),
        priority=rng.choice([0, 0, 5], C).astype(np.int64),
        ts=np.round(rng.random(C) * 8, 2))


def world_of(eng):
    return carry.world_tensors(vars(encode_snapshot(eng.cache.snapshot(),
                                                    max_depth=4)))


def usage_of(w, rng, scale):
    usage = np.zeros((w.num_nodes, w.nominal.shape[1]), np.int64)
    usage[:w.num_cqs] = rng.integers(0, scale, usage[:w.num_cqs].shape)
    return usage


@pytest.mark.parametrize("seed,weights", [
    (1, (1.0, 1.0, 1.0, 1.0)),
    (2, (2.0, 1.0, 0.5, 1.0)),
    (3, (1.0, 3.0, 1.0, 0.25)),
])
def test_fair_commit_flat_worlds(seed, weights):
    eng = tfd.make_engine(False, weights)
    tfd.populate(eng, len(weights), seed=seed)
    tfd.drain(eng)
    w = world_of(eng)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        fair_both(w, seeded_entries(w, rng), usage_of(w, rng, 3000))


@pytest.mark.parametrize("seed", range(8))
def test_fair_commit_nested_worlds(seed):
    eng, n_cqs = tfd.make_nested_engine(False, random.Random(seed),
                                        deep=seed % 2 == 1)
    tfd.populate(eng, n_cqs, n=24, seed=seed * 11 + 1)
    tfd.drain(eng)
    w = world_of(eng)
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        fair_both(w, seeded_entries(w, rng), usage_of(w, rng, 2500))


def test_fair_commit_zero_weight_borrower():
    """Both ClusterQueues would borrow 500 of the cohort's 2000; the
    zero-weight one competes after the weighted one."""
    eng = tfd.make_engine(False, (0.0, 1.0), nominal=1000)
    w = world_of(eng)
    entries = dict(
        valid=np.ones(2, bool), fr=np.zeros((2, 1), np.int32),
        req=np.full((2, 1), 1500, np.int64),
        kind=np.full(2, jc.ENTRY_FIT, np.int32),
        borrows=np.ones(2, np.int32), priority=np.zeros(2, np.int64),
        ts=np.array([1.0, 2.0]))
    admitted, rounds, _ = fair_both(
        w, entries, np.zeros((w.num_nodes, 1), np.int64))
    assert admitted.tolist() == [False, True]
    assert rounds.tolist() == [-1, 0]


SMALL_FAIR = dict(n_roots=4, n_workloads=500)


def test_small_hierarchical_fair_drain():
    jscen, tscen = j_hier_fair(**SMALL_FAIR), hierarchical_fair(**SMALL_FAIR)
    jst = jb.BatchedDrainSolver(
        j_build_snapshot(jscen.cluster_queues, jscen.cohorts, jscen.flavors,
                         []), jscen.pending_infos(), fair=True).solve()[1]
    tst = tb.BatchedDrainSolver(
        build_snapshot(tscen.cluster_queues, tscen.cohorts, tscen.flavors,
                       []), tscen.pending_infos(), fair=True,
        device="cpu").solve()[1]
    for key in ("cycles", "admitted", "needs_oracle"):
        assert tst[key] == jst[key], key
    for key in ("admit_cycle", "admit_pos", "wl_flavor", "final_usage"):
        assert tst[key].dtype == jst[key].dtype, key
        np.testing.assert_array_equal(tst[key], jst[key], err_msg=key)
    assert tst["admitted"] > 0


def decisions(stats):
    return (stats["cycles"], stats["admitted"],
            zlib.crc32(stats["admit_cycle"].tobytes()
                       + stats["admit_pos"].tobytes()
                       + stats["wl_flavor"].tobytes()))


def test_full_hierarchical_fair_constants_are_the_jax_packages():
    """chip_smoke.py phase 8 pins the JAX package's fair drain of the
    500-ClusterQueue, 40,000-workload scenario; recompute it, and run the
    port's CPU path to the same numbers."""
    jscen, tscen = (j_hier_fair(n_workloads=40_000),
                    hierarchical_fair(n_workloads=40_000))
    jst = jb.BatchedDrainSolver(
        j_build_snapshot(jscen.cluster_queues, jscen.cohorts, jscen.flavors,
                         []), jscen.pending_infos(), fair=True).solve()[1]
    assert decisions(jst) == chip_smoke.HIER_FAIR_EXPECT
    tst = tb.BatchedDrainSolver(
        build_snapshot(tscen.cluster_queues, tscen.cohorts, tscen.flavors,
                       []), tscen.pending_infos(), fair=True,
        device="cpu").solve()[1]
    assert decisions(tst) == chip_smoke.HIER_FAIR_EXPECT
