"""Flavor assignment in the PyTorch port (kueue_tpu_torch/ops/assign.py)
vs the JAX package's assign_flavors, on the CPU, on the random worlds
and pending workloads of tests/test_assign_parity.py (single and
multi-podset). Both sides get the same encoded arrays and the same
derived quota state. Exact: all outputs are integer or boolean."""

import random

import jax
import numpy as np
import pytest
import torch

import test_assign_parity
from kueue_tpu.ops import assign as ja
from kueue_tpu.ops import quota as jq
from kueue_tpu.tensor.schema import encode_snapshot, encode_workloads
from kueue_tpu_torch.ops import assign as ta


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("multi_podset", [False, True],
                         ids=["single", "multi"])
@pytest.mark.parametrize("seed", range(10))
def test_assign_flavors_matches_jax(seed, multi_podset):
    rng = random.Random(seed + (1000 if multi_podset else 0))
    snap = test_assign_parity.random_world(rng)
    pend = test_assign_parity.pending_workloads(rng, snap,
                                                multi_podset=multi_podset)
    world = encode_snapshot(snap)
    wls = encode_workloads(world, pend)
    derived = jax.tree.map(np.asarray, jq.derive_world(
        world.nominal, world.lend_limit, world.borrow_limit, world.usage,
        world.parent, depth=world.depth))
    policy = (world.height, world.group_of_res, world.group_flavors,
              world.no_preemption, world.can_preempt_while_borrowing,
              world.fung_borrow_try_next, world.fung_pref_preempt_first)
    want = ja.assign_flavors(
        wls.cq, wls.requests, derived, world.nominal, world.ancestors,
        *policy, depth=world.depth, num_resources=world.num_resources)
    got = ta.assign_flavors(
        _t(wls.cq), _t(wls.requests),
        {k: _t(v) for k, v in derived.items()}, _t(world.nominal),
        _t(world.ancestors), *map(_t, policy), depth=world.depth,
        num_resources=world.num_resources)
    names = ("flavor_of_res", "pmode", "borrows", "needs_oracle",
             "usage_fr")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_mode_key_matches_jax():
    pmode = np.array([0, 1, 4, 0, 1, 4, 4, 1], np.int32)
    borrow = np.array([0, 2, 3, 1, 0, 0, 1, 4], np.int32)
    for pref in (False, True):
        pref_arr = np.full(8, pref)
        np.testing.assert_array_equal(
            ta._mode_key(_t(pmode), _t(borrow), _t(pref_arr)).numpy(),
            np.asarray(ja._mode_key(pmode, borrow, pref_arr)))
