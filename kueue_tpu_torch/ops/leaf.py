"""TAS leaf fit counts: pods of one request that fit on each leaf.

The port of ``kueue_tpu/ops/pallas_kernels.py:leaf_fit_counts`` (the
``_leaf_pallas`` kernel), whose contract is the int64 reference
``kueue_tpu/ops/tas.py:_leaf_states_jnp``. On a CUDA tensor
``leaf_fit_counts`` launches the hand-written kernel of ``csrc/leaf.cu``
(or raises); on a CPU tensor it runs the plain PyTorch version beside it,
which the tests and ``chip_smoke.py`` hold the kernel against.

Contract: ``out[i]`` is the least ``max(0, free - tas - assumed) //
per_pod`` over the columns with ``per_pod > 0``, 0 when no column is
requested or the leaf is masked out, as int32 keeping the low 32 bits.
Everything before the final conversion is int64, so there is no range
gate: quantities of any size (memory in bytes) are exact.
"""

from __future__ import annotations

import torch

from kueue_tpu_torch.ops import _build

INT_MAX = 1 << 62
MAX_COLS = 4096  # per_pod is staged in the kernel's 48 KB of shared memory

# Kernel launches made by leaf_fit_counts since the count was last reset.
launches = 0


def _check(free, tas, assumed, per_pod, leaf_mask) -> None:
    for name, t in (("free", free), ("tas", tas), ("assumed", assumed),
                    ("per_pod", per_pod)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if leaf_mask.dtype != torch.bool:
        raise TypeError(f"leaf_mask must be bool, got {leaf_mask.dtype}")
    if free.dim() != 2 or free.shape[1] < 1:
        raise ValueError(f"free must be [L, S] with S >= 1, got "
                         f"{tuple(free.shape)}")
    L, S = free.shape
    if tas.shape != free.shape or assumed.shape != free.shape:
        raise ValueError(f"free, tas and assumed must share a shape, got "
                         f"{tuple(free.shape)}, {tuple(tas.shape)}, "
                         f"{tuple(assumed.shape)}")
    if per_pod.shape != (S,) or leaf_mask.shape != (L,):
        raise ValueError(f"per_pod must be [{S}] and leaf_mask [{L}], got "
                         f"{tuple(per_pod.shape)} and "
                         f"{tuple(leaf_mask.shape)}")
    devices = {t.device for t in (free, tas, assumed, per_pod, leaf_mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def leaf_fit_counts_plain(free, tas, assumed, per_pod, leaf_mask):
    """The plain version: the reference's torch ops in its order."""
    _check(free, tas, assumed, per_pod, leaf_mask)
    rem = torch.clamp(free - tas - assumed, min=0)
    requested = per_pod > 0
    counts = torch.where(
        requested[None, :],
        torch.div(rem, torch.clamp(per_pod, min=1)[None, :],
                  rounding_mode="floor"),
        torch.full_like(rem, INT_MAX))
    state = counts.amin(dim=1)
    state = torch.where(requested.any(), state, torch.zeros_like(state))
    state = torch.where(leaf_mask, state, torch.zeros_like(state))
    return state.to(torch.int32)


def leaf_fit_counts(free, tas, assumed, per_pod, leaf_mask):
    """Pods that fit per leaf: int32[L]."""
    global launches
    dev = free.device
    if dev.type == "cpu":
        return leaf_fit_counts_plain(free, tas, assumed, per_pod, leaf_mask)
    _check(free, tas, assumed, per_pod, leaf_mask)
    if dev.type != "cuda":
        raise ValueError(f"leaf_fit_counts runs on cuda or cpu, got {dev}")
    if not all(t.is_contiguous()
               for t in (free, tas, assumed, per_pod, leaf_mask)):
        raise ValueError("leaf_fit_counts inputs must be contiguous")
    L, S = free.shape
    if S > MAX_COLS:
        raise ValueError(f"leaf_fit_counts takes at most {MAX_COLS} "
                         f"columns, got {S}")
    out = torch.empty((L,), dtype=torch.int32, device=dev)
    if L == 0:
        return out
    _build.launch("leaf", dev, free.data_ptr(), tas.data_ptr(),
                  assumed.data_ptr(), per_pod.data_ptr(),
                  leaf_mask.data_ptr(), L, S, out.data_ptr())
    launches += 1
    return out
