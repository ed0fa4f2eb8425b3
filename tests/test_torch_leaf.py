"""TAS leaf fit counts in the PyTorch port (kueue_tpu_torch/ops/leaf.py)
vs the JAX package's int64 reference, on the CPU.

The reference is kueue_tpu/ops/tas.py:_leaf_states_jnp, the contract of
the Pallas kernel _leaf_pallas; the port's CPU path is the plain version
that chip_smoke.py holds the CUDA kernel against on the card. Exact:
int32 outputs, including counts of 2**31 and more, where both keep the
low 32 bits of the int64 count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kueue_tpu.ops import pallas_kernels as pk
from kueue_tpu.ops.tas import _leaf_states_jnp
from kueue_tpu_torch.ops import leaf
from kueue_tpu_torch.ops import tas as ttas

GRID = [(1, 1), (100, 3), (640, 2), (1000, 5)]
GIB = 2**30


def _both(free, used, assumed, per_pod, mask):
    want = np.asarray(_leaf_states_jnp(*map(jnp.asarray, (
        free, used, assumed, per_pod, mask))))
    got = leaf.leaf_fit_counts(*map(torch.as_tensor, (
        free, used, assumed, per_pod, mask)))
    assert got.dtype == torch.int32 and got.shape == (free.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("leaves,res", GRID)
def test_leaf_grid_matches_jax(leaves, res):
    rng = np.random.default_rng(leaves * 10 + res)
    _both(rng.integers(0, 1000, (leaves, res)).astype(np.int64),
          rng.integers(0, 500, (leaves, res)).astype(np.int64),
          rng.integers(0, 100, (leaves, res)).astype(np.int64),
          rng.integers(0, 8, res).astype(np.int64),
          rng.random(leaves) > 0.2)


@pytest.mark.parametrize("leaves,res", GRID)
def test_leaf_grid_matches_pallas_dispatcher(monkeypatch, leaves, res):
    """The JAX dispatcher with the Pallas kernel forced (interpret mode
    on the CPU) agrees too: these quantities are inside its int32
    range."""
    monkeypatch.setenv("KUEUE_TPU_PALLAS", "1")
    rng = np.random.default_rng(leaves * 10 + res)
    args = (rng.integers(0, 1000, (leaves, res)).astype(np.int64),
            rng.integers(0, 500, (leaves, res)).astype(np.int64),
            rng.integers(0, 100, (leaves, res)).astype(np.int64),
            rng.integers(0, 8, res).astype(np.int64),
            rng.random(leaves) > 0.2)
    want = np.asarray(pk.leaf_fit_counts(*map(jnp.asarray, args)))
    got = leaf.leaf_fit_counts(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_leaf_300_gib_is_exact():
    """The reference's big-value case: quantities past 2**31 are exact
    in int64, with no range gate."""
    got = _both(np.array([[300 * GIB]], np.int64),
                np.array([[200 * GIB]], np.int64),
                np.zeros((1, 1), np.int64),
                np.array([10 * GIB], np.int64), np.array([True]))
    assert got.tolist() == [10]


def test_leaf_counts_past_int32_keep_low_bits():
    """A count >= 2**31 (memory in bytes with a 1-byte request) keeps the
    low 32 bits of the int64 count, as .astype(jnp.int32) does."""
    free = np.array([[3 * 2**31, 9], [2**31, 9], [2**32 + 7, 9],
                     [2**31 - 1, 9]], np.int64)
    zero = np.zeros_like(free)
    got = _both(free, zero, zero, np.array([1, 0], np.int64),
                np.ones(4, bool))
    assert got.tolist() == [-2**31, -2**31, 7, 2**31 - 1]


def test_leaf_no_requested_column_and_masks():
    rng = np.random.default_rng(5)
    free = rng.integers(0, 10**6, (64, 3)).astype(np.int64)
    zero = np.zeros_like(free)
    got = _both(free, zero, zero, np.array([0, -5, 0], np.int64),
                np.ones(64, bool))
    assert not got.any()
    got = _both(free, zero, zero, np.array([3, 1, 7], np.int64),
                np.zeros(64, bool))
    assert not got.any()


def test_leaf_wrapping_int64_quantities():
    """free - tas - assumed wraps as two's-complement int64 on both
    sides, and negative remainders fit no pod."""
    rng = np.random.default_rng(65536)
    shape = (2048, 8)
    free = rng.integers(-2**62, 2**62, shape).astype(np.int64)
    free[::7] = np.iinfo(np.int64).min + rng.integers(0, 100, (1, 8))
    tas = rng.integers(-2**62, 2**62, shape).astype(np.int64)
    assumed = rng.integers(0, 2**40, shape).astype(np.int64)
    got = _both(free, tas, assumed,
                np.array([1, 0, 3, 2**33, -1, 7, 2**20, 5], np.int64),
                rng.random(2048) > 0.05)
    assert got.any()


@pytest.mark.parametrize("leaves,res", chip_smoke.LEAF_PATHS)
def test_leaf_load_paths_match_jax(leaves, res):
    """chip_smoke.py's cases for each load path of the CUDA kernel: odd S,
    S = 1, wide rows (odd and even), with quantities and per-pod requests
    past 2**32."""
    _both(*chip_smoke.leaf_mixed(np.random.default_rng(leaves + res),
                                 leaves, res))


def test_leaf_rows_off_16_byte_alignment_match_jax():
    free, tas, assumed, per_pod, mask = chip_smoke.leaf_mixed(
        np.random.default_rng(5122), 5120, 2)
    want = np.asarray(_leaf_states_jnp(*map(jnp.asarray, (
        free, tas, assumed, per_pod, mask))))
    off = [chip_smoke.off_by_one_element(torch.as_tensor(a))
           for a in (free, tas, assumed)]
    got = leaf.leaf_fit_counts(*off, torch.as_tensor(per_pod),
                               torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_leaf_states_dispatches_to_the_leaf_function():
    rng = np.random.default_rng(9)
    args = tuple(map(torch.as_tensor, (
        rng.integers(0, 1000, (50, 2)).astype(np.int64),
        rng.integers(0, 500, (50, 2)).astype(np.int64),
        np.zeros((50, 2), np.int64), np.array([100, 1], np.int64),
        rng.random(50) > 0.3)))
    assert torch.equal(ttas.leaf_states(*args),
                       leaf.leaf_fit_counts_plain(*args))


def test_leaf_empty_forest():
    got = leaf.leaf_fit_counts(torch.zeros((0, 2), dtype=torch.int64),
                               torch.zeros((0, 2), dtype=torch.int64),
                               torch.zeros((0, 2), dtype=torch.int64),
                               torch.ones(2, dtype=torch.int64),
                               torch.zeros(0, dtype=torch.bool))
    assert got.shape == (0,) and got.dtype == torch.int32


def test_leaf_rejects_bad_inputs():
    free = torch.zeros((8, 2), dtype=torch.int64)
    per_pod = torch.ones(2, dtype=torch.int64)
    mask = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        leaf.leaf_fit_counts(free.int(), free, free, per_pod, mask)
    with pytest.raises(TypeError):
        leaf.leaf_fit_counts(free, free, free, per_pod, mask.long())
    with pytest.raises(ValueError):
        leaf.leaf_fit_counts(free, free[:4], free, per_pod, mask)
    with pytest.raises(ValueError):
        leaf.leaf_fit_counts(free, free, free, per_pod[:1], mask)
    with pytest.raises(ValueError):
        leaf.leaf_fit_counts(free[:, :0], free[:, :0], free[:, :0],
                             per_pod[:0], mask)
    meta = [t.to("meta") for t in (free, free, free, per_pod, mask)]
    with pytest.raises(ValueError):
        leaf.leaf_fit_counts(*meta)


def test_plain_version_launches_nothing():
    before = leaf.launches
    leaf.leaf_fit_counts(torch.zeros((8, 2), dtype=torch.int64),
                         torch.zeros((8, 2), dtype=torch.int64),
                         torch.zeros((8, 2), dtype=torch.int64),
                         torch.ones(2, dtype=torch.int64),
                         torch.ones(8, dtype=torch.bool))
    assert leaf.launches == before
