"""Quota derivation in the PyTorch port (kueue_tpu_torch/ops/quota.py)
vs the JAX package's ops/quota.py, on the CPU, on the random worlds of
tests/test_quota_parity.py and tests/test_assign_parity.py. Exact:
every derived quantity is int64 with saturating INF arithmetic."""

import random

import jax
import numpy as np
import pytest
import torch

import test_assign_parity
import test_quota_parity
from kueue_tpu.api.types import INF
from kueue_tpu.ops import quota as jq
from kueue_tpu.tensor.schema import encode_snapshot
from kueue_tpu_torch.ops import quota as tq

BUILDERS = {"quota": test_quota_parity.random_world,
            "assign": test_assign_parity.random_world}


def _world(builder, seed):
    return encode_snapshot(BUILDERS[builder](random.Random(seed)))


def _t(a):
    return torch.as_tensor(np.array(a))


def derive_both(world):
    want = jax.tree.map(np.asarray, jq.derive_world(
        world.nominal, world.lend_limit, world.borrow_limit, world.usage,
        world.parent, depth=world.depth))
    got = tq.derive_world(_t(world.nominal), _t(world.lend_limit),
                          _t(world.borrow_limit), _t(world.usage),
                          _t(world.parent), depth=world.depth)
    return want, got


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("seed", range(8))
def test_derive_world_matches_jax(builder, seed):
    world = _world(builder, seed)
    want, got = derive_both(world)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)


@pytest.mark.parametrize("seed", range(8))
def test_borrow_height_matches_jax(seed):
    world = _world("quota", seed + 100)
    want_d, got_d = derive_both(world)
    C, R = world.num_cqs, world.nominal.shape[1]
    cq, fr, val = np.meshgrid(np.arange(C), np.arange(R),
                              np.array([0, 100, 1000, 10_000]),
                              indexing="ij")
    cq, fr = cq.ravel().astype(np.int32), fr.ravel().astype(np.int32)
    val = val.ravel().astype(np.int64)
    h, may = jq.borrow_height(cq, fr, val, want_d, world.ancestors,
                              world.height, world.nominal,
                              depth=world.depth)
    th, tmay = tq.borrow_height(_t(cq), _t(fr), _t(val), got_d,
                                _t(world.ancestors), _t(world.height),
                                _t(world.nominal), depth=world.depth)
    np.testing.assert_array_equal(th.numpy(), np.asarray(h))
    np.testing.assert_array_equal(tmay.numpy(), np.asarray(may))


def test_saturating_arithmetic_matches_jax():
    edge = np.array([-INF, -INF + 1, -5, 0, 7, INF - 3, INF - 1, INF],
                    np.int64)
    a, b = np.meshgrid(edge, edge, indexing="ij")
    for jf, tf in ((jq.sat_add, tq.sat_add), (jq.sat_sub, tq.sat_sub)):
        np.testing.assert_array_equal(tf(_t(a), _t(b)).numpy(),
                                      np.asarray(jf(a, b)))
    lq = np.array([[0, 5, INF, 3]], np.int64)
    ll = np.array([[INF, 2, 7, 9]], np.int64)
    np.testing.assert_array_equal(tq.local_quota(_t(lq), _t(ll)).numpy(),
                                  np.asarray(jq.local_quota(lq, ll)))
