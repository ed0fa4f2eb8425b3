"""Measured host/device TAS crossover, persisted across runs.

The port of ``kueue_tpu/tas/calibration.py``, with a record of its own.
The crossover probe (``bench/tas_engine_worlds.crossover_measure``: one
host descent against one device launch on the live forest) persists its
measurement here, keyed by (backend, forest shape), and
``tas/device.worth_offloading`` consults the record:

  * no record, no ``KUEUE_TPU_DEVICE_TAS_MIN`` -> the host descent;
  * the record says the device launch beats the host descent at this
    forest shape -> per-placement offload and the batched placement
    (``tas/batched.py``) switch on;
  * ``KUEUE_TPU_DEVICE_TAS_MIN`` always wins when set (0 = always
    offload, large = never).

The record lives in ``$KUEUE_TPU_TORCH_TAS_CALIBRATION`` if set, else
``$XDG_CACHE_HOME/kueue_tpu_torch/tas_crossover.json``, else
``~/.cache/kueue_tpu_torch/tas_crossover.json``; the JAX package's
record is never read. The backend is the snapshot's torch device type
(``cuda`` or ``cpu``). Forest shapes are bucketed to the next power of
two of the leaf count.
"""

from __future__ import annotations

import json
import os
from typing import Optional

_cache: Optional[dict] = None
_cache_path: Optional[str] = None
# Bumped whenever the in-process record table may have changed;
# lets callers (tas/device.worth_offloading) memoize per generation.
generation = 0


def record_path() -> str:
    override = os.environ.get("KUEUE_TPU_TORCH_TAS_CALIBRATION")
    if override:
        return override
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "kueue_tpu_torch", "tas_crossover.json")


def leaf_bucket(leaves: int) -> int:
    """Next power of two — worlds of similar scale share a record."""
    if leaves <= 1:
        return 1
    return 1 << (leaves - 1).bit_length()


def _key(backend: str, num_levels: int, leaves: int) -> str:
    return f"{backend}:{num_levels}:{leaf_bucket(leaves)}"


def load(path: Optional[str] = None) -> dict:
    """The persisted record table ({key: {host_place_ms,
    device_place_ms, ...}}), cached per process per path."""
    global _cache, _cache_path
    path = path or record_path()
    if _cache is not None and _cache_path == path:
        return _cache
    table: dict = {}
    try:
        with open(path, encoding="utf-8") as f:
            loaded = json.load(f)
        if isinstance(loaded, dict):
            table = loaded
    except (OSError, ValueError):
        pass
    _cache = table
    _cache_path = path
    return table


def save(backend: str, num_levels: int, leaves: int,
         host_place_ms: float, device_place_ms: float,
         extra: Optional[dict] = None) -> Optional[str]:
    """Merge one measurement into the record and rewrite it atomically.
    Returns the path written, or None when the location is unwritable
    (the calibration is an optimization, never a requirement)."""
    global _cache, _cache_path, generation
    generation += 1
    path = record_path()
    table = dict(load(path))
    entry = {"host_place_ms": round(float(host_place_ms), 4),
             "device_place_ms": round(float(device_place_ms), 4),
             "leaves": int(leaves), "num_levels": int(num_levels),
             "backend": backend}
    if extra:
        entry.update(extra)
    table[_key(backend, num_levels, leaves)] = entry
    tmp = path + ".tmp"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    _cache = table
    _cache_path = path
    return path


def lookup(backend: str, num_levels: int, leaves: int) -> Optional[dict]:
    return load().get(_key(backend, num_levels, leaves))


def device_placement_wins(snap) -> bool:
    """True when the persisted measurement says a device tas_place
    launch beats the host descent for this forest's shape on the
    snapshot's backend (its torch device type). False with no
    record."""
    if not snap.level_keys:
        return False
    nl = len(snap.level_keys)
    leaves = len(snap.domains_per_level[nl - 1])
    entry = lookup(snap.device.type, nl, leaves)
    if entry is None:
        return False
    return entry["device_place_ms"] < entry["host_place_ms"]


def invalidate_cache() -> None:
    """Test hook: drop the per-process record cache."""
    global _cache, _cache_path, generation
    generation += 1
    _cache = None
    _cache_path = None
