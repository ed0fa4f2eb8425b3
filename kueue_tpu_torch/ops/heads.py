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

import functools

import torch

from kueue_tpu_torch.ops import _build

# Kernel launches made by select_heads since the count was last reset.
launches = 0

CLUSTER_SIZE = 8  # CTAs of one thread-block cluster (csrc/heads.cu)
# Bins one CTA holds in shared memory: 227 KB of int64 on Hopper.
MAX_SHARED_BINS = 232448 // 8
# Rows one cluster takes; above this, MAX_CLUSTERS clusters and a fold
# launch. Eight clusters, not the sixteen that 132 SMs could hold: on the
# H100, sixteen clusters of eight CTAs took more device time than eight
# at every row count of `profile_kernels.py --sweep`, and one cluster took
# the least at the drain's 50,000 rows.
ROWS_PER_CLUSTER = 1 << 16
MAX_CLUSTERS = 8


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(n: int, num_cqs: int, sms: int) -> int:
    """The kernel's branch for ``n`` rows into ``num_cqs`` bins on a card
    of ``sms`` SMs: 0 for global atomics (the bins do not fit in shared
    memory), else the number of thread-block clusters: 1 up to
    ``ROWS_PER_CLUSTER`` rows, above that ``MAX_CLUSTERS`` or as many as
    the SMs hold."""
    if num_cqs > MAX_SHARED_BINS:
        return 0
    if n <= ROWS_PER_CLUSTER:
        return 1
    return max(1, min(MAX_CLUSTERS, sms // CLUSTER_SIZE))


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
    dev = eff_rank.device
    if dev.type == "cpu":
        return select_heads_plain(eff_rank, wl_cq, num_cqs, big_rank)
    _check(eff_rank, wl_cq, num_cqs)
    if dev.type != "cuda":
        raise ValueError(f"select_heads runs on cuda or cpu, got {dev}")
    if not (eff_rank.is_contiguous() and wl_cq.is_contiguous()):
        raise ValueError("eff_rank and wl_cq must be contiguous")
    # The kernel writes every bin: no fill.
    out = torch.empty((num_cqs,), dtype=torch.int64, device=dev)
    if num_cqs == 0:
        return out
    n = eff_rank.shape[0]
    clusters = plan(n, num_cqs, _sm_count(dev.index))
    scratch = (torch.empty((clusters, num_cqs), dtype=torch.int64,
                           device=dev) if clusters > 1 else None)
    _build.launch("heads", dev, eff_rank.data_ptr(), wl_cq.data_ptr(),
                  wl_cq.element_size(), n, num_cqs, int(big_rank), clusters,
                  None if scratch is None else scratch.data_ptr(),
                  out.data_ptr())
    launches += 1
    return out
