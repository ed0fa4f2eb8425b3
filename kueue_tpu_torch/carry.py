"""Encoded worlds carried across from another encoder.

For the scheduler, the "weights" are the encoded world: the
``WorldTensors``, ``WorkloadTensors`` and ``AdmittedTensors`` arrays. These helpers take them
as plain mappings of field name to numpy array or scalar (for example
``vars()`` of the JAX package's encoder output) and build the port's
dataclasses, so the port can solve exactly the arrays another encoder
produced. Fields the port does not have are ignored; a missing field
raises. ``tas_structure`` does the same for a topology forest's device
encoding, ``api_object`` for an API object (flavors, queues,
workloads with their pod templates, topologies, TAS nodes and topology
assignments, LimitRanges) and for a job of the job integrations, and
``configuration`` for a manager Configuration.
"""

from __future__ import annotations

import dataclasses
import enum

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
            v = [api_object(x) for x in v]
        elif isinstance(v, (int, np.integer)):
            v = int(v)
        elif v is not None:
            raise TypeError(f"{cls.__name__}.{f.name}: unsupported value "
                            f"of type {type(v).__name__}")
        values[f.name] = v
    return cls(**values)


def api_object(obj):
    """The port's API object with the field values of ``obj``, an object
    of another package's API types (or TAS types: ``Node``,
    ``TopologyAssignment``, ``PodUsage``; pod templates and LimitRanges;
    the jobs and ``PodSetInfo`` of the job integrations) of the same
    class names (dataclasses, enums, and the tuples, lists and dicts
    holding them), converted field by field into new objects, so that
    adjusting a carried template leaves the original as it was. The
    ``uid`` is copied as it is: preemption candidates break ties on it.
    A ``PodGroup`` (no dataclass) is carried attribute by attribute."""
    from kueue_tpu_torch.api import types
    from kueue_tpu_torch.controllers import integrations, jobframework
    from kueue_tpu_torch.tas import non_tas_usage, snapshot
    from kueue_tpu_torch.utils import limitrange, podtemplate

    if isinstance(obj, enum.Enum):
        return getattr(types, type(obj).__name__)(obj.value)
    if type(obj).__name__ == "PodGroup":
        out = integrations.PodGroup.__new__(integrations.PodGroup)
        out.__dict__.update({k: api_object(v)
                             for k, v in vars(obj).items()})
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = next(getattr(m, name) for m in (
            types, snapshot, non_tas_usage, podtemplate, limitrange,
            jobframework, integrations) if hasattr(m, name))
        init, rest = {}, {}
        for f in dataclasses.fields(cls):
            (init if f.init else rest)[f.name] = api_object(
                getattr(obj, f.name))
        out = cls(**init)
        for k, v in rest.items():
            object.__setattr__(out, k, v)
        return out
    if isinstance(obj, (tuple, list)):
        return type(obj)(api_object(x) for x in obj)
    if isinstance(obj, dict):
        return {api_object(k): api_object(v) for k, v in obj.items()}
    return obj


def configuration(cfg):
    """The port's ``config.api.Configuration`` with the values of ``cfg``
    (another package's Configuration): the job integrations, the
    ``wait_for_pods_ready`` and ``fair_sharing`` sections, the resources
    section, the retention durations, the ``metrics_custom_labels`` as
    the port's ``CustomLabelEntry``s and the ``profile_dir``. Fields the
    port does not have are left out."""
    from kueue_tpu_torch.config import api
    from kueue_tpu_torch.metrics.registry import CustomLabelEntry

    out = api.Configuration()
    for f in dataclasses.fields(out):
        if not hasattr(cfg, f.name):
            continue
        v = getattr(cfg, f.name)
        if f.name == "metrics_custom_labels":
            v = [CustomLabelEntry(
                name=e.name, source_label_key=e.source_label_key,
                source_annotation_key=e.source_annotation_key) for e in v]
        elif f.name == "resources":
            v = api.ResourcesConfig(
                exclude_resource_prefixes=tuple(v.exclude_resource_prefixes),
                transformations=tuple(
                    api.ResourceTransformationSpec(
                        input=t.input, strategy=t.strategy,
                        outputs=dict(t.outputs), multiply_by=t.multiply_by)
                    for t in v.transformations))
        elif dataclasses.is_dataclass(v):
            cls = getattr(api, type(v).__name__)
            v = cls(**{g.name: getattr(v, g.name)
                       for g in dataclasses.fields(cls)})
        elif isinstance(v, (dict, list, tuple)):
            v = type(v)(v)
        setattr(out, f.name, v)
    return out


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
