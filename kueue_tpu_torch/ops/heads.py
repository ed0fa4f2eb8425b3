"""Heads selection: the per-ClusterQueue minimum effective rank.

The port of ``kueue_tpu/ops/pallas_kernels.py:select_heads``. On a CUDA
tensor ``select_heads`` launches the hand-written kernel of
``csrc/heads.cu`` (or raises); on a CPU tensor it runs the plain PyTorch
version beside it, which the tests and ``chip_smoke.py`` hold the kernel
against.

Contract: ``out[c]`` is the least ``eff_rank[i]`` over rows with
``wl_cq[i] == c``, or ``big_rank`` when there is none. Rows whose cq is
outside [0, C) count for no bin; ranks >= big_rank mean "inactive".
Callers test ``< big_rank`` for "has a head".
"""

from __future__ import annotations

import torch

from kueue_tpu_torch.ops import _build

# Kernel launches made by select_heads since the count was last reset.
launches = 0


def _check(eff_rank, wl_cq, num_cqs: int) -> None:
    if eff_rank.dtype != torch.int64:
        raise TypeError(f"eff_rank must be int64, got {eff_rank.dtype}")
    if wl_cq.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"wl_cq must be int32 or int64, got {wl_cq.dtype}")
    if eff_rank.dim() != 1 or wl_cq.shape != eff_rank.shape:
        raise ValueError("eff_rank and wl_cq must be 1-D of one length, got "
                         f"{tuple(eff_rank.shape)} and {tuple(wl_cq.shape)}")
    if eff_rank.device != wl_cq.device:
        raise ValueError(f"eff_rank on {eff_rank.device}, wl_cq on "
                         f"{wl_cq.device}")
    if not (0 <= num_cqs < 2**31):
        raise ValueError(f"num_cqs out of range: {num_cqs}")


def select_heads_plain(eff_rank, wl_cq, num_cqs: int, big_rank):
    """The plain version: one scatter-min into ``big_rank``-filled bins,
    with a spare bin that takes rows whose cq is out of range."""
    _check(eff_rank, wl_cq, num_cqs)
    out = torch.full((num_cqs + 1,), int(big_rank), dtype=torch.int64,
                     device=eff_rank.device)
    idx = torch.where((wl_cq >= 0) & (wl_cq < num_cqs), wl_cq, num_cqs)
    out.scatter_reduce_(0, idx.long(), eff_rank, "amin", include_self=True)
    return out[:num_cqs]


def select_heads(eff_rank, wl_cq, num_cqs: int, big_rank):
    """Per-CQ minimum effective rank: int64[num_cqs]."""
    global launches
    if eff_rank.device.type == "cpu":
        return select_heads_plain(eff_rank, wl_cq, num_cqs, big_rank)
    _check(eff_rank, wl_cq, num_cqs)
    if eff_rank.device.type != "cuda":
        raise ValueError(f"select_heads runs on cuda or cpu, got "
                         f"{eff_rank.device}")
    if not (eff_rank.is_contiguous() and wl_cq.is_contiguous()):
        raise ValueError("eff_rank and wl_cq must be contiguous")
    out = torch.full((num_cqs,), int(big_rank), dtype=torch.int64,
                     device=eff_rank.device)
    n = eff_rank.shape[0]
    if n == 0 or num_cqs == 0:
        return out
    kernel = _build.load("heads")
    with torch.cuda.device(eff_rank.device):
        stream = torch.cuda.current_stream(eff_rank.device).cuda_stream
        err = kernel(eff_rank.data_ptr(), wl_cq.data_ptr(),
                     wl_cq.element_size(), n, num_cqs, int(big_rank),
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"heads kernel launch failed: cudaError {err}")
    launches += 1
    return out
