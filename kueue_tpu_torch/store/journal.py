"""Durable state and restart: an append-only JSONL journal of applied
objects, the standalone analog of "the Kubernetes API is the durable
store".

The port of ``kueue_tpu/store/journal.py``, trimmed to the single-file
journal: every engine object creation and every workload status
transition appends an ``apply`` record (last write per key wins),
``rebuild_engine`` cold-starts an engine by replaying the file from its
first record, and the engine calls ``sync()`` (flush + fsync) at every
non-idle cycle boundary, so a crash between cycles never loses an
applied admission. Records carry the engine clock, never the wall
clock, and are written with the same JSON as the JAX package's: mirrored
engines write byte-identical files, and each package rebuilds the
other's.

Crash consistency: a truncated or corrupt final line (a crash
mid-write) is trimmed under ``flock`` when a journal is opened or
appended to, and skipped on replay; corruption anywhere else raises
JournalCorruption. Each record carries a per-key generation; an apply
with ``expected_generation`` raises JournalConflict when another writer
advanced the key.

Left out: segment rotation and sealed segments, checkpoints
(``store/checkpoint.py``) and ``replay_from``, compaction, the disk
budget (``writable``, JournalDegraded) and the HA fence.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from typing import Iterator, Optional

from kueue_tpu_torch.api.conversion import SCHEMA_VERSION, upgrade_record
from kueue_tpu_torch.api.serde import from_jsonable, to_jsonable


class JournalCorruption(Exception):
    """A record that is neither the torn final line nor parseable:
    replaying past it would silently drop every later record."""


class JournalConflict(Exception):
    """Optimistic-concurrency failure: the object was modified by another
    writer since the caller read it (the SSA patch-conflict analog,
    pkg/workload/patching/patching.go:53-59)."""

    def __init__(self, kind: str, key: str, expected: int, found: int):
        super().__init__(
            f"conflict on {kind}/{key}: expected generation {expected},"
            f" journal has {found}")
        self.kind = kind
        self.key = key
        self.expected = expected
        self.found = found


class Journal:
    """Append-only JSONL journal with per-key generation stamps.

    Every append first refreshes from the shared file (records appended
    by other writers are folded into the generation table) and then
    writes with generation last+1, all inside an exclusive ``flock``, so
    concurrent writers interleave at record granularity and
    ``expected_generation`` is checked atomically."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", encoding="utf-8")
        # Appends since the last sync(), and the wall seconds spent in
        # sync()'s flush and fsync.
        self._dirty = False
        self.sync_seconds = 0.0
        # Lines written through this handle: the bridge's speculation
        # token reads it, so any journaled write discards a speculation.
        self.writes_seq = 0
        self._locked_repair()
        # Per-(kind, key) generation table and how far the file is read.
        self._generations: dict[tuple, int] = {}
        self._read_offset = 0
        self.refresh()

    def refresh(self) -> int:
        """Fold records appended since the last read (by other writers,
        or ours) into the generation table. Returns how many were new."""
        try:
            with open(self.path, "rb") as fh:
                if os.fstat(fh.fileno()).st_size < self._read_offset:
                    # Shrunk (another handle repaired a torn tail).
                    self._read_offset = 0
                    self._generations.clear()
                fh.seek(self._read_offset)
                data = fh.read()
        except FileNotFoundError:
            return 0
        # Only complete lines advance the offset (another writer may be
        # mid-append).
        end = data.rfind(b"\n")
        if end < 0:
            return 0
        n = 0
        for line in data[:end].split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (rec.get("kind"), _key_of(rec))
            self._generations[key] = int(rec.get("gen", 0)) or \
                self._generations.get(key, 0) + 1
            n += 1
        self._read_offset += end + 1
        return n

    def generation_of(self, kind: str, key: str) -> int:
        """The last persisted generation of a key (0 = never written);
        read-modify-write callers pass it back as
        ``expected_generation``."""
        self.refresh()
        return self._generations.get((kind, key), 0)

    def _repair_torn_tail(self) -> None:
        """Trim a truncated or corrupt final line (a crash mid-write), so
        appends after a restart start on a clean line. Covers a
        newline-less fragment and a newline-terminated final line that
        does not parse; never removes more than that one record."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb+") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size == 0:
                return
            # Scan backwards in growing windows for the last newline (a
            # torn record can exceed any fixed window).
            window = 1 << 20
            while True:
                start = max(0, size - window)
                fh.seek(start)
                chunk = fh.read(size - start)
                nl = chunk.rfind(b"\n")
                if nl >= 0 or start == 0:
                    last_nl = start + nl if nl >= 0 else -1
                    tail = chunk[nl + 1:]
                    break
                window *= 4
            if not tail:
                # The file ends on a newline, but the last complete line
                # can still be a torn write: validate it.
                prev_nl = _find_prev_newline(fh, last_nl)
                fh.seek(prev_nl + 1)
                line = fh.read(last_nl - prev_nl - 1)
                if not line.strip():
                    return
                try:
                    json.loads(line.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    fh.truncate(prev_nl + 1)
                return
            try:
                json.loads(tail.decode("utf-8"))
                fh.seek(0, os.SEEK_END)
                fh.write(b"\n")  # a complete record missing its newline
            except (json.JSONDecodeError, UnicodeDecodeError):
                fh.truncate(size - len(tail))

    def _locked_repair(self) -> None:
        """Torn-tail repair under the shared flock: a reader must not
        truncate bytes a live writer just committed."""
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            self._repair_torn_tail()
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    def _tail_is_clean(self) -> bool:
        """True when the file is empty or ends with a newline."""
        try:
            with open(self.path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                if size == 0:
                    return True
                fh.seek(size - 1)
                return fh.read(1) == b"\n"
        except FileNotFoundError:
            return True

    def apply(self, kind: str, obj, ts: float = 0.0,
              expected_generation: Optional[int] = None) -> int:
        rec = {"op": "apply", "kind": kind, "ts": ts,
               "v": SCHEMA_VERSION, "obj": to_jsonable(obj)}
        return self._stamp_and_write(rec, kind, _key_of(rec),
                                     expected_generation)

    def apply_many(self, kind: str, objs, ts: float = 0.0) -> list:
        """Batched :meth:`apply`: the same lines and the same sequential
        generations as ``apply(kind, obj, ts)`` per object in order
        (repeated keys advance per occurrence), in one locked write.
        Returns the stamped generations in input order; on a failed
        write no generation is recorded in-process."""
        objs = list(objs)
        if not objs:
            return []
        recs = [{"op": "apply", "kind": kind, "ts": ts,
                 "v": SCHEMA_VERSION, "obj": to_jsonable(obj)}
                for obj in objs]
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            if not self._tail_is_clean():
                self._repair_torn_tail()
            self.refresh()
            pending: dict = {}
            gens: list = []
            lines: list = []
            for rec in recs:
                k = (kind, _key_of(rec))
                gen = pending.get(k, self._generations.get(k, 0)) + 1
                rec["gen"] = gen
                pending[k] = gen
                gens.append(gen)
                lines.append(json.dumps(rec) + "\n")
            self._write_lines(lines)
            self._generations.update(pending)
            return gens
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    def delete(self, kind: str, key: str, ts: float = 0.0,
               expected_generation: Optional[int] = None) -> int:
        return self._stamp_and_write(
            {"op": "delete", "kind": kind, "key": key, "ts": ts,
             "v": SCHEMA_VERSION}, kind, key, expected_generation)

    def _stamp_and_write(self, rec: dict, kind: str, key: str,
                         expected_generation: Optional[int]) -> int:
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            if not self._tail_is_clean():
                # Another writer crashed mid-append: trim its fragment or
                # this record would concatenate onto it.
                self._repair_torn_tail()
            self.refresh()
            k = (kind, key)
            current = self._generations.get(k, 0)
            if (expected_generation is not None
                    and current != expected_generation):
                raise JournalConflict(kind, key, expected_generation,
                                      current)
            gen = current + 1
            rec["gen"] = gen
            self._write_lines([json.dumps(rec) + "\n"])
            self._generations[k] = gen
            return gen
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    def _write_lines(self, lines: list) -> None:
        blob = "".join(lines)
        self._fh.write(blob)
        self._fh.flush()
        self._dirty = True
        # Our own lines are already in the generation table: skip them on
        # the next refresh().
        self._read_offset += len(blob.encode("utf-8"))
        self.writes_seq += len(lines)

    def sync(self) -> None:
        """Crash-safe cycle boundary: flush + fsync every append since
        the last sync. A no-op when nothing is pending, so an idle
        serving loop does not touch the disk."""
        if not self._dirty:
            return
        t0 = time.perf_counter()
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._dirty = False
        self.sync_seconds += time.perf_counter() - t0

    def close(self) -> None:
        if not self._fh.closed:
            self.sync()
        self._fh.close()

    def replay(self) -> Iterator[dict]:
        """The file's records in append order (``read_records``)."""
        return read_records(self.path)


def read_records(path: str) -> Iterator[dict]:
    """Yield a journal file's records in append order, without opening
    it for writing or repairing it. A truncated or corrupt final line is
    skipped; an unparseable line with records after it raises
    JournalCorruption."""
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().split("\n")
    except FileNotFoundError:
        return
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if not any(rest.strip() for rest in lines[i + 1:]):
                return  # torn tail (crash mid-write)
            raise JournalCorruption(
                f"{path}:{i + 1}: unparseable record "
                "with records after it") from None
        if rec.get("op") == "meta":
            continue  # a rotated journal's control record
        yield upgrade_record(rec)


def _find_prev_newline(fh, before: int) -> int:
    """Absolute offset of the last newline strictly before ``before``
    (-1 when the line is the file's first)."""
    window = 1 << 20
    while True:
        start = max(0, before - window)
        fh.seek(start)
        chunk = fh.read(before - start)
        nl = chunk.rfind(b"\n")
        if nl >= 0:
            return start + nl
        if start == 0:
            return -1
        window *= 4


def _key_of(rec: dict) -> str:
    if rec["op"] == "delete":
        return rec["key"]
    obj = rec["obj"]
    ns = obj.get("namespace")
    name = obj.get("name", "")
    return f"{ns}/{name}" if ns is not None else name


_CREATE = {
    "cohort": "create_cohort",
    "resource_flavor": "create_resource_flavor",
    "cluster_queue": "create_cluster_queue",
    "local_queue": "create_local_queue",
    "topology": "create_topology",
    "node": "create_node",
}

# Kinds the JAX package journals for analysis that carry no engine
# state: a rebuild skips them.
EPHEMERAL_KINDS = frozenset(
    {"cycle_trace", "ha_digest", "fed_route", "fed_cell"})


def engine_from_records(records, **engine_kwargs):
    """Apply a journal record sequence to a new
    ``Engine(**engine_kwargs)``: objects are
    re-created in order, then each workload's last persisted state is
    restored through ``Engine.restore_workload``; the clock is the
    largest record timestamp."""
    from kueue_tpu_torch.controllers.engine import Engine

    eng = Engine(**engine_kwargs)
    # Last op wins per (kind, key): a later delete tombstones earlier
    # applies.
    live: dict[tuple, bool] = {}
    for rec in records:
        live[(rec["kind"], _key_of(rec))] = rec["op"] != "delete"
    workloads: dict[str, dict] = {}
    wl_order: list[str] = []
    clock = 0.0
    for rec in records:
        clock = max(clock, rec.get("ts", 0.0))
        kind = rec["kind"]
        key = _key_of(rec)
        if rec["op"] == "delete" or not live[(kind, key)]:
            continue
        if kind in EPHEMERAL_KINDS:
            continue
        if kind == "workload":
            if key not in workloads:
                wl_order.append(key)
            workloads[key] = rec["obj"]
            continue
        if kind == "workload_priority_class":
            eng.create_workload_priority_class(rec["obj"]["name"],
                                               rec["obj"]["value"])
            continue
        method = _CREATE.get(kind)
        if method is not None:
            getattr(eng, method)(from_jsonable(rec["obj"]))
    eng.clock = clock
    for key in wl_order:
        eng.restore_workload(from_jsonable(workloads[key]))
    return eng


def rebuild_engine(path: str, **engine_kwargs):
    """Cold-start an engine from a journal (the restart path): replay
    every record from the first, then re-attach the journal for further
    writes. Returns the engine, its clock at the last persisted
    timestamp and ``rebuild_records`` the number of records replayed."""
    journal = Journal(path)
    records = list(journal.replay())
    eng = engine_from_records(records, **engine_kwargs)
    eng.rebuild_records = len(records)
    eng.attach_journal(journal, record_existing=False)
    return eng


def attach_new_journal(engine, path: str) -> Journal:
    """Start journaling a live engine, writing its current state first."""
    journal = Journal(path)
    engine.attach_journal(journal, record_existing=True)
    return journal
