"""API versioning and conversion: a copy of
``kueue_tpu/api/conversion.py`` (the port keeps its own, so that the
journal records of either package read back in the other).

Reference: apis/kueue/{v1beta1,v1beta2} + zz_generated.conversion.go —
objects persist at a storage version and convert on read; renamed or
retired fields are mapped, unknown fields from newer writers are
tolerated. The standalone analog versions the serde/journal schema:

  * every journal record carries ``v`` (SCHEMA_VERSION);
  * ``convert_fields`` applies per-type field renames and drops unknown
    keys, so a journal written by an older schema (missing new fields —
    dataclass defaults fill them) or a newer one (extra/renamed fields)
    still replays;
  * ``UPGRADERS`` holds whole-record migrations between schema
    versions, the Convert_v1beta1_*_To_v1beta2_* analog.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

SCHEMA_VERSION = 3

# type name -> {old field name: new field name}; retired fields map to
# None (dropped on read). The v3 entries mirror the reference's actual
# v1beta1 -> v1beta2 renames (zz_generated.conversion.go): cohort ->
# cohortName, parent -> parentName, priorityClass -> priorityClassRef —
# records written with either spelling read back into the same objects.
FIELD_RENAMES: dict[str, dict[str, str | None]] = {
    "ClusterQueue": {"cohort_name": "cohort"},
    "Cohort": {"parent_name": "parent"},
    "Workload": {"priority_class_ref": "priority_class_name"},
}

# enum type -> {alias value: canonical value}. The reference's v1beta2
# renamed FlavorFungibility's stop values (Borrow / Preempt) to
# MayStopSearch; every decision site only distinguishes TryNextFlavor
# from "stop", so one canonical stop value is lossless.
ENUM_VALUE_ALIASES: dict[str, dict[str, str]] = {
    "FungibilityPolicy": {"MayStopSearch": "Borrow"},
}


def convert_enum_value(enum_name: str, value):
    """Map a versioned enum spelling to its canonical value."""
    return ENUM_VALUE_ALIASES.get(enum_name, {}).get(value, value)


def register_rename(type_name: str, old: str, new: str | None) -> None:
    FIELD_RENAMES.setdefault(type_name, {})[old] = new


# Each dataclass's field names (None for a class that is not one): a
# journal rebuild converts every live object.
_KNOWN: dict[type, frozenset | None] = {}


def convert_fields(cls: type, kwargs: dict[str, Any]) -> dict[str, Any]:
    """Apply renames, then keep only fields the target dataclass
    declares (unknown-field tolerance)."""
    renames = FIELD_RENAMES.get(cls.__name__)
    if cls in _KNOWN:
        known = _KNOWN[cls]
    else:
        known = _KNOWN[cls] = (
            frozenset(f.name for f in dataclasses.fields(cls))
            if dataclasses.is_dataclass(cls) else None)
    out: dict[str, Any] = {}
    for key, value in kwargs.items():
        if renames and key in renames:
            key = renames[key]
            if key is None:
                continue
        if known is None or key in known:
            out[key] = value
    return out


# record migrations: from-version -> fn(record) -> record
UPGRADERS: dict[int, Callable[[dict], dict]] = {}


def register_upgrader(from_version: int,
                      fn: Callable[[dict], dict]) -> None:
    UPGRADERS[from_version] = fn


def upgrade_record(record: dict) -> dict:
    """Bring a journal record to SCHEMA_VERSION through the upgrader
    chain (conversion on read; storage stays at the written version
    until compaction, like etcd storage versions)."""
    version = record.get("v", 1)
    while version < SCHEMA_VERSION:
        fn = UPGRADERS.get(version)
        if fn is None:
            break  # rely on field-level tolerance
        record = fn(record)
        version = record.get("v", version + 1)
    return record


def _upgrade_v1(record: dict) -> dict:
    """v1 (round 1) -> v2: no structural changes — new workload fields
    (preemption gates, check updates, templates) default on read."""
    record = dict(record)
    record["v"] = 2
    return record


register_upgrader(1, _upgrade_v1)


def _upgrade_v2(record: dict) -> dict:
    """v2 (round 2) -> v3: the reference's v1beta1 -> v1beta2 rename
    wave. Structurally a no-op on write-side records — the renamed
    fields and enum spellings are handled on READ by FIELD_RENAMES and
    ENUM_VALUE_ALIASES, matching the reference's conversion-webhook
    model where old objects convert as they are served."""
    record = dict(record)
    record["v"] = 3
    return record


register_upgrader(2, _upgrade_v2)
