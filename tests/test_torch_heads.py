"""Heads selection in the PyTorch port (kueue_tpu_torch/ops/heads.py) vs
the JAX package's select_heads, on the CPU.

The JAX side runs both of its paths: the Pallas kernel in interpret mode
(KUEUE_TPU_PALLAS=1) and jax.ops.segment_min (=0). The port's CPU path
is the plain version that chip_smoke.py holds the CUDA kernel against on
the card. Exact: integer outputs, compared under the "< BIG_RANK"
contract (empty bins are BIG_RANK in the port, the int64 maximum on
JAX's segment_min path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kueue_tpu.ops import pallas_kernels as pk
from kueue_tpu_torch.bench import profile_kernels
from kueue_tpu_torch.ops import heads

BIG = 1 << 40
GRID = [(1, 1), (37, 3), (256, 7), (1000, 130), (5000, 1000)]
# The shapes chip_smoke.py adds on the card: the drain's and one per
# branch of the CUDA kernel (one cluster with up to 227 KB of bins,
# several clusters, bins beyond shared memory).
BRANCH_SHAPES = [s for s in chip_smoke.HEADS_SHAPES if s not in GRID]


@pytest.fixture(params=["1", "0"], ids=["pallas", "segment_min"])
def jax_path(request, monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_PALLAS", request.param)
    return request.param


def _both(eff, cq, c):
    want = pk.select_heads(jnp.asarray(eff), jnp.asarray(cq), c, BIG)
    got = heads.select_heads(torch.as_tensor(eff), torch.as_tensor(cq), c,
                             BIG)
    assert got.dtype == torch.int64 and got.shape == (c,)
    np.testing.assert_array_equal(np.minimum(got.numpy(), BIG),
                                  np.minimum(np.asarray(want), BIG))
    return got.numpy()


@pytest.mark.parametrize("w,c", GRID)
def test_select_heads_matches_jax(jax_path, w, c):
    rng = np.random.default_rng(w * 1000 + c)
    rank = rng.permutation(w).astype(np.int64)
    cq = rng.integers(0, c, w).astype(np.int32)
    active = rng.random(w) > 0.3
    _both(np.where(active, rank, BIG), cq, c)


@pytest.mark.parametrize("w,c", BRANCH_SHAPES)
def test_select_heads_branch_shapes_match_jax(jax_path, w, c):
    rng = np.random.default_rng(w * 1000 + c)
    rank = rng.permutation(w).astype(np.int64)
    cq = rng.integers(0, c, w).astype(np.int32)
    active = rng.random(w) > 0.3
    _both(np.where(active, rank, BIG), cq, c)


@pytest.fixture(scope="module")
def drain_first_cycle():
    """The full-width drain's own first-cycle inputs, captured from the
    port's solver as chip_smoke.py captures them on the card."""
    return profile_kernels.drain_first_cycle_heads(
        profile_kernels.full_drain_solver("cpu"))


def test_select_heads_drain_first_cycle_matches_jax(jax_path,
                                                    drain_first_cycle):
    eff, cq, c = drain_first_cycle
    assert eff.shape == (50000,) and c == 1000
    _both(eff.numpy(), cq.numpy(), c)


def test_plan_picks_the_branch_by_shape():
    rows, sms = heads.ROWS_PER_CLUSTER, 132
    assert heads.plan(50000, 1000, sms) == 1  # the drain: one launch
    assert heads.plan(0, 1000, sms) == 1
    assert heads.plan(rows, 1000, sms) == 1
    assert heads.plan(rows + 1, 1000, sms) == heads.MAX_CLUSTERS
    assert heads.plan(10**9, 1000, sms) == heads.MAX_CLUSTERS
    assert heads.plan(10**9, 1000, 16) == 2  # a card of 16 SMs
    assert heads.plan(10**9, 1000, 4) == 1
    assert heads.plan(50000, heads.MAX_SHARED_BINS, sms) == 1
    assert heads.plan(50000, heads.MAX_SHARED_BINS + 1, sms) == 0
    assert [heads.plan(w, c, sms) for w, c in BRANCH_SHAPES].count(0) == 1


def test_select_heads_all_inactive(jax_path):
    got = _both(np.full(64, BIG, np.int64), np.zeros(64, np.int32), 4)
    assert np.all(got == BIG)


def test_select_heads_rows_without_cq(jax_path):
    rng = np.random.default_rng(3)
    cq = rng.integers(0, 50, 3000).astype(np.int32)
    cq[rng.random(3000) < 0.3] = -1
    _both(rng.permutation(3000).astype(np.int64), cq, 50)


def test_select_heads_large_ranks_and_int64_cq(monkeypatch):
    """Ranks up to BIG_RANK - 1 (past the Pallas path's int32 range, so
    against segment_min only) and an int64 cq vector."""
    monkeypatch.setenv("KUEUE_TPU_PALLAS", "0")
    rng = np.random.default_rng(11)
    eff = BIG - 1 - rng.integers(0, 4000, 5000).astype(np.int64)
    eff[rng.random(5000) < 0.2] = BIG
    _both(eff, rng.integers(0, 700, 5000).astype(np.int64), 700)


def test_select_heads_rejects_bad_inputs():
    eff = torch.zeros(8, dtype=torch.int64)
    cq = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        heads.select_heads(eff.int(), cq, 2, BIG)
    with pytest.raises(TypeError):
        heads.select_heads(eff, cq.float(), 2, BIG)
    with pytest.raises(ValueError):
        heads.select_heads(eff, cq[:4], 2, BIG)
    with pytest.raises(ValueError):
        heads.select_heads(eff.to("meta"), cq.to("meta"), 2, BIG)


def test_plain_version_launches_nothing():
    before = heads.launches
    heads.select_heads(torch.zeros(8, dtype=torch.int64),
                       torch.zeros(8, dtype=torch.int32), 2, BIG)
    assert heads.launches == before
