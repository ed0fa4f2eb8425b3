"""JSON codec for the API types, the journal's record format: a copy of
``kueue_tpu/api/serde.py`` over the port's types, with the same
``__t__`` / ``__e__`` tags, so that each package reads the other's
records, pod templates (``PodTemplate``, ``ContainerSpec``) included.
The port also registers ``LimitRange`` and ``LimitRangeItem``, which the
JAX package's codec does not: a replayed ``create_limit_range`` frame
decodes in the port.

The reference persists all state as Kubernetes objects (the API server
is the durable store; workload status lands via SSA patches,
pkg/workload/patching). This codec is the standalone analog: any API
dataclass round-trips through plain JSON with ``__t__`` type tags (and
``__e__`` for enums), used by the journal (store/journal.py) and the
oracle serving boundary.

Sequences deserialize as tuples — the API types use tuples throughout
(pod_sets, levels, taints, ...), and status helpers rely on tuple
concatenation semantics.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

_REGISTRY: dict[str, type] = {}


def _auto_register() -> None:
    from kueue_tpu_torch.api import types as T

    for name in dir(T):
        obj = getattr(T, name)
        if isinstance(obj, type) and (
                dataclasses.is_dataclass(obj)
                or issubclass(obj, enum.Enum)):
            _REGISTRY[obj.__name__] = obj
    from kueue_tpu_torch.tas.snapshot import (
        Node,
        TopologyAssignment,
        TopologyDomainAssignment,
    )
    _REGISTRY["Node"] = Node
    _REGISTRY["TopologyAssignment"] = TopologyAssignment
    _REGISTRY["TopologyDomainAssignment"] = TopologyDomainAssignment
    # Workload-reachable types living outside api.types: admission check
    # states and updates (status.admission_check_*).
    from kueue_tpu_torch.controllers.admissionchecks import (
        CheckState,
        PodSetUpdate,
    )
    _REGISTRY["CheckState"] = CheckState
    _REGISTRY["PodSetUpdate"] = PodSetUpdate
    # Pod templates (PodSet.template) ride every workload record, and a
    # recorded create_limit_range carries a LimitRange.
    from kueue_tpu_torch.utils.limitrange import LimitRange, LimitRangeItem
    from kueue_tpu_torch.utils.podtemplate import ContainerSpec, PodTemplate
    _REGISTRY["ContainerSpec"] = ContainerSpec
    _REGISTRY["PodTemplate"] = PodTemplate
    _REGISTRY["LimitRange"] = LimitRange
    _REGISTRY["LimitRangeItem"] = LimitRangeItem


def register(cls: type) -> type:
    """Add an extension type to the codec registry."""
    _REGISTRY[cls.__name__] = cls
    return cls


# Types that encode as themselves, and each dataclass's field names:
# to_jsonable dispatches on the exact type (a checkpoint encodes every
# live object, 50,000 workloads at full width).
_PLAIN = frozenset({str, int, float, bool, type(None)})
_FIELDS: dict[type, tuple] = {}


def to_jsonable(obj: Any) -> Any:
    cls = type(obj)
    if cls in _PLAIN:
        return obj
    names = _FIELDS.get(cls)
    if names is None and dataclasses.is_dataclass(cls):
        names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
    if names is not None:
        out: dict[str, Any] = {"__t__": cls.__name__}
        for name in names:
            out[name] = to_jsonable(getattr(obj, name))
        return out
    if isinstance(obj, enum.Enum):
        return {"__e__": cls.__name__, "v": obj.value}
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    return obj


def from_jsonable(data: Any) -> Any:
    # Exact-type dispatch first, as in to_jsonable: a journal rebuild or
    # a trace replay decodes every live object (50,000 workloads at full
    # width), so leaves are passed through without a call. Subclasses of
    # dict and list take the isinstance path.
    cls = type(data)
    if cls in _PLAIN:
        return data
    if cls is list:
        return tuple([v if type(v) in _PLAIN else from_jsonable(v)
                      for v in data])
    if isinstance(data, dict):
        if "__t__" in data:
            from kueue_tpu_torch.api.conversion import convert_fields

            if not _REGISTRY:
                _auto_register()
            target = _REGISTRY[data["__t__"]]
            kwargs = {k: v if type(v) in _PLAIN else from_jsonable(v)
                      for k, v in data.items() if k != "__t__"}
            # Versioned read: renamed fields map, unknown fields drop,
            # missing fields default (api/conversion.py).
            return target(**convert_fields(target, kwargs))
        if "__e__" in data:
            from kueue_tpu_torch.api.conversion import convert_enum_value

            if not _REGISTRY:
                _auto_register()
            name = data["__e__"]
            return _REGISTRY[name](convert_enum_value(name, data["v"]))
        return {k: v if type(v) in _PLAIN else from_jsonable(v)
                for k, v in data.items()}
    if isinstance(data, list):
        return tuple(from_jsonable(v) for v in data)
    return data
