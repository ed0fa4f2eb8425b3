"""The commit in the PyTorch port (kueue_tpu_torch/ops/commit.py) vs the
JAX package's commit_grouped and make_commit_order_key, on the CPU, on
the random forests of tests/test_commit_grouped.py. Exact: admitted
sets, final usage and keys are integer or boolean."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_commit_grouped
from kueue_tpu.ops import commit as jc
from kueue_tpu.ops.quota import compute_level, compute_subtree_quota
from kueue_tpu_torch.ops import commit as tc


def _t(a):
    return torch.as_tensor(np.array(a))


def _entries(rng, C, S):
    entry_fr = np.tile(np.arange(S, dtype=np.int32), (C, 1))
    entry_fr[rng.random((C, S)) < 0.2] = -1
    return dict(
        entry_key=rng.permutation(C).astype(np.int64),
        entry_valid=rng.random(C) < 0.85,
        entry_fr=entry_fr,
        entry_req=rng.integers(0, 40, (C, S)).astype(np.int64),
        entry_kind=rng.choice([jc.ENTRY_SKIP, jc.ENTRY_FIT,
                               jc.ENTRY_RESERVE, jc.ENTRY_FORCE],
                              C).astype(np.int32),
        entry_borrows=rng.integers(0, 3, C).astype(np.int32))


def _commit_both(w, entries):
    D = w["D"]
    sq = np.asarray(compute_subtree_quota(
        jnp.asarray(w["nominal"]), jnp.asarray(w["lend_limit"]),
        jnp.asarray(w["parent"]),
        compute_level(jnp.asarray(w["parent"]), D), depth=D))
    world = (w["usage0"], sq, w["lend_limit"], w["borrow_limit"],
             w["nominal"], w["ancestors"], w["root_members"],
             w["root_nodes"], w["local_chain"])
    args = tuple(entries.values()) + world
    want = jc.commit_grouped(*map(jnp.asarray, args), depth=D)
    got = tc.commit_grouped(*map(_t, args), depth=D)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got


@pytest.mark.parametrize("seed", range(6))
def test_commit_grouped_matches_jax(seed):
    rng = np.random.default_rng(seed)
    R = int(rng.integers(1, 4))
    w = test_commit_grouped.random_world(
        rng, n_roots=int(rng.integers(2, 5)),
        cqs_per_root=int(rng.integers(1, 5)),
        depth_extra=int(rng.integers(0, 2)), R=R)
    _commit_both(w, _entries(rng, w["C"], R))


def test_invalid_slots_never_commit():
    rng = np.random.default_rng(42)
    w = test_commit_grouped.random_world(rng, n_roots=2, cqs_per_root=2,
                                         depth_extra=0, R=1)
    C = w["C"]
    entries = dict(
        entry_key=np.arange(C, dtype=np.int64),
        entry_valid=np.zeros(C, bool),
        entry_fr=np.zeros((C, 1), np.int32),
        entry_req=np.ones((C, 1), np.int64),
        entry_kind=np.full(C, jc.ENTRY_FORCE, np.int32),
        entry_borrows=np.zeros(C, np.int32))
    admitted, usage = _commit_both(w, entries)
    assert not admitted.any()
    np.testing.assert_array_equal(usage.numpy(), w["usage0"])


def test_commit_order_key_matches_jax():
    rng = np.random.default_rng(5)
    n = 500
    args = (rng.random(n) < 0.5,
            rng.integers(-2, 40, n).astype(np.int32),
            rng.integers(-1000, 1000, n).astype(np.int64),
            rng.integers(-5, (1 << 24) + 5, n).astype(np.int64))
    np.testing.assert_array_equal(
        tc.make_commit_order_key(*map(_t, args)).numpy(),
        np.asarray(jc.make_commit_order_key(*map(jnp.asarray, args))))
