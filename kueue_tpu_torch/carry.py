"""Encoded worlds carried across from another encoder.

For the scheduler, the "weights" are the encoded world: the
``WorldTensors``, ``WorkloadTensors`` and ``AdmittedTensors`` arrays. These helpers take them
as plain mappings of field name to numpy array or scalar (for example
``vars()`` of the JAX package's encoder output) and build the port's
dataclasses, so the port can solve exactly the arrays another encoder
produced. Fields the port does not have are ignored; a missing field
raises. ``tas_structure`` does the same for a topology forest's device
encoding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kueue_tpu_torch.device import resolve_device
from kueue_tpu_torch.tensor.schema import (
    AdmittedTensors,
    WorkloadTensors,
    WorldTensors,
)


def _build(cls, mapping):
    missing = [f.name for f in dataclasses.fields(cls)
               if f.name not in mapping]
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {missing}")
    values = {}
    for f in dataclasses.fields(cls):
        v = mapping[f.name]
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (list, tuple)):
            v = list(v)
        elif isinstance(v, (int, np.integer)):
            v = int(v)
        elif v is not None:
            raise TypeError(f"{cls.__name__}.{f.name}: unsupported value "
                            f"of type {type(v).__name__}")
        values[f.name] = v
    return cls(**values)


def world_tensors(mapping) -> WorldTensors:
    return _build(WorldTensors, mapping)


def workload_tensors(mapping) -> WorkloadTensors:
    return _build(WorkloadTensors, mapping)


def admitted_tensors(mapping) -> AdmittedTensors:
    return _build(AdmittedTensors, mapping)


def to_device(tensors, device=None):
    """A copy of a WorldTensors / WorkloadTensors whose arrays are torch
    tensors on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return dataclasses.replace(tensors, **{
        f.name: torch.as_tensor(getattr(tensors, f.name), device=dev)
        for f in dataclasses.fields(tensors)
        if isinstance(getattr(tensors, f.name), np.ndarray)})


_TAS_ARRAYS = ("valid", "vrank", "parent", "has_pods_cap")
_TAS_MATRICES = ("free", "usage")


def tas_structure(mapping, device=None) -> dict:
    """A topology forest's device encoding carried across from another
    encoder: ``mapping`` holds the arrays ``valid`` bool[NL, M],
    ``vrank`` int64[NL, M], ``parent`` int64[NL, M], ``has_pods_cap``
    bool[M] and the ints ``m`` and ``nl`` (for example the JAX package's
    ``tas/device._structure(snap)``), and optionally the leaf matrices
    ``free`` and ``usage`` int64[M, S]. Returns those as torch tensors on
    ``device`` (CUDA unless the caller asks for the CPU), and ``m`` and
    ``nl`` as ints, ready for ``ops/tas.tas_place`` and
    ``tas_feasibility``."""
    dev = resolve_device(device)
    missing = [k for k in _TAS_ARRAYS + ("m", "nl") if k not in mapping]
    if missing:
        raise ValueError(f"tas_structure: missing fields {missing}")
    out = {"m": int(mapping["m"]), "nl": int(mapping["nl"])}
    for k in _TAS_ARRAYS + _TAS_MATRICES:
        if k in mapping:
            out[k] = torch.as_tensor(np.array(mapping[k]), device=dev)
    if out["valid"].shape != (out["nl"], out["m"]):
        raise ValueError(f"tas_structure: valid is "
                         f"{tuple(out['valid'].shape)}, want "
                         f"({out['nl']}, {out['m']})")
    return out
