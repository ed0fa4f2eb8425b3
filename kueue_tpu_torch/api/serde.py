"""JSON codec for the API types, the journal's record format: a copy of
``kueue_tpu/api/serde.py`` over the port's types, with the same
``__t__`` / ``__e__`` tags, so that each package reads the other's
records. The port has no pod templates (its engine raises on them), so
``PodTemplate`` and ``ContainerSpec`` are not registered.

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


def register(cls: type) -> type:
    """Add an extension type to the codec registry."""
    _REGISTRY[cls.__name__] = cls
    return cls


def to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: dict[str, Any] = {"__t__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, enum.Enum):
        return {"__e__": type(obj).__name__, "v": obj.value}
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    return obj


def from_jsonable(data: Any) -> Any:
    if not _REGISTRY:
        _auto_register()
    if isinstance(data, dict):
        if "__t__" in data:
            from kueue_tpu_torch.api.conversion import convert_fields

            cls = _REGISTRY[data["__t__"]]
            kwargs = {k: from_jsonable(v) for k, v in data.items()
                      if k != "__t__"}
            # Versioned read: renamed fields map, unknown fields drop,
            # missing fields default (api/conversion.py).
            return cls(**convert_fields(cls, kwargs))
        if "__e__" in data:
            from kueue_tpu_torch.api.conversion import convert_enum_value

            name = data["__e__"]
            return _REGISTRY[name](convert_enum_value(name, data["v"]))
        return {k: from_jsonable(v) for k, v in data.items()}
    if isinstance(data, list):
        return tuple(from_jsonable(v) for v in data)
    return data
