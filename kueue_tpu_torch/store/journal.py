"""Durable state and restart: an append-only JSONL journal of applied
objects, the standalone analog of "the Kubernetes API is the durable
store".

The port of ``kueue_tpu/store/journal.py``: every engine object
creation and every workload status transition appends an ``apply``
record (last write per key wins), ``rebuild_engine`` cold-starts an
engine from the journal, and the engine calls ``sync()`` (flush +
fsync) at every non-idle cycle boundary, so a crash between cycles
never loses an applied admission. Records carry the engine clock, never
the wall clock, and are written with the same JSON as the JAX
package's: mirrored engines write byte-identical files (segments and
checkpoints included), and each package rebuilds the other's.

Crash consistency: a truncated or corrupt final line (a crash
mid-write) is trimmed under ``flock`` when a journal is opened or
appended to, and skipped on replay; corruption anywhere else raises
JournalCorruption. Each record carries a per-key generation; an apply
with ``expected_generation`` raises JournalConflict when another writer
advanced the key.

Segment rotation (bounded-time recovery): with ``rotate_bytes`` or
``rotate_records`` set, ``sync()`` seals the active file as
``<path>.seg<NNNNNN>`` once it crosses a threshold and opens a new
active file whose first line is a ``meta`` control record holding the
ordinal the new file takes when sealed and the journal's *lineage*.
The journal is the lineage's sealed segments in ordinal order, then the
active file; ``replay()`` walks exactly that. ``compact`` bumps the
lineage, which invalidates every older segment and checkpoint at once.
``retain_segments`` deletes sealed segments older than the oldest live
checkpoint (``store/checkpoint.py``), and ``replay_from`` yields only
the records past a checkpoint's (lineage, segment, offset) position.

The disk budget (``store/diskguard.py``, ``min_free_bytes``): every
append preflights the free space under the ``flock`` and raises
JournalDegraded instead of writing when the filesystem is below the
floor (a real ENOSPC degrades the same way); ``writable()`` is the
engine's cycle gate and re-arms the budget once space returns. The
``fence`` predicate (None, unfenced, by default) refuses a write with
JournalFenced (an HA leader's, ``ha/replica.py``). ``ha_digest`` records
(the HA decision chain, ``ha/digest.py``) carry no engine state: a
rebuild skips them.
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import json
import os
import time
from typing import Iterator, Optional

from kueue_tpu_torch.api.conversion import SCHEMA_VERSION, upgrade_record
from kueue_tpu_torch.api.serde import from_jsonable, to_jsonable
from kueue_tpu_torch.store.diskguard import DiskBudget

# Crash seam for tests: called with "rotate" or "compact" right after a
# maintenance pass renamed or replaced the active file, before it cleans
# up and reopens.
MAINTENANCE_CRASH_HOOK = None

_SEG_WIDTH = 6
_META_KIND = "__journal__"


def _segment_path(path: str, ordinal: int) -> str:
    return f"{path}.seg{ordinal:0{_SEG_WIDTH}d}"


def _sealed_segments(path: str) -> list:
    """Sorted [(ordinal, segment path)] of the sealed segment files."""
    base = os.path.basename(path) + ".seg"
    d = os.path.dirname(path) or "."
    out = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return out
    for name in names:
        if name.startswith(base) and name[len(base):].isdigit():
            out.append((int(name[len(base):]), os.path.join(d, name)))
    out.sort()
    return out


def _file_meta(path: str) -> Optional[dict]:
    """The ``meta`` record on a journal file's first line, or None (a
    file written before any rotation has none)."""
    try:
        with open(path, "rb") as fh:
            line = fh.readline(1 << 16)
    except FileNotFoundError:
        return None
    if not line.endswith(b"\n"):
        return None
    try:
        rec = json.loads(line)
    except json.JSONDecodeError:
        return None
    return rec if rec.get("op") == "meta" else None


# -- the read side, over a journal's path --
#
# Each reads the files as they stand and opens nothing for writing (no
# torn-tail repair, no lock): the Journal's read methods are these, and
# a reader beside a live or killed writer calls them directly.

def read_lineage(path: str) -> int:
    """The journal's compaction era: its active file's meta line, else
    its newest sealed segment's, else 0."""
    meta = _file_meta(path)
    if meta is not None:
        return int(meta.get("lineage", 0))
    segs = _sealed_segments(path)
    if segs:
        m = _file_meta(segs[-1][1])
        if m is not None:
            return int(m.get("lineage", 0))
    return 0


def read_active_ordinal(path: str) -> int:
    """The ordinal the journal's active file takes when sealed."""
    meta = _file_meta(path)
    if meta is not None and "seg" in meta:
        return int(meta["seg"])
    segs = _sealed_segments(path)
    return (segs[-1][0] + 1) if segs else 0


def read_segments(path: str) -> list:
    """Sorted [(ordinal, path)] of the sealed segments of the journal's
    current lineage."""
    lineage = read_lineage(path)
    out = []
    for ordinal, seg in _sealed_segments(path):
        meta = _file_meta(seg)
        if int((meta or {}).get("lineage", 0)) == lineage:
            out.append((ordinal, seg))
    return out


def read_chain(path: str) -> Iterator[dict]:
    """The journal's records in append order: the lineage's sealed
    segments, then the active file, whose torn final line is skipped."""
    for _ordinal, seg in read_segments(path):
        yield from _replay_file(seg, tolerate_torn=False)
    yield from _replay_file(path, tolerate_torn=True)


def read_suffix(path: str, position: dict) -> Iterator[dict]:
    """The journal's records past a checkpoint's position (see
    ``Journal.replay_from``)."""
    lineage = int(position.get("lineage", 0))
    segment = int(position.get("segment", 0))
    offset = int(position.get("offset", 0))
    current = read_lineage(path)
    if lineage != current:
        raise ValueError(
            f"stale position: lineage {lineage} != journal "
            f"lineage {current} (compacted since)")
    for ordinal, seg in read_segments(path):
        if ordinal < segment:
            continue
        yield from _replay_file(
            seg, tolerate_torn=False,
            skip_lines=offset if ordinal == segment else 0)
    active_ord = read_active_ordinal(path)
    if active_ord < segment:
        raise ValueError(
            f"stale position: segment {segment} is past the active "
            f"file (ordinal {active_ord})")
    yield from _replay_file(
        path, tolerate_torn=True,
        skip_lines=offset if active_ord == segment else 0)


class JournalCorruption(Exception):
    """A record that is neither the torn final line nor parseable:
    replaying past it would silently drop every later record."""


class JournalFenced(Exception):
    """A write refused by the journal's ``fence`` predicate: the holder
    is no longer the leader."""


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


class JournalDegraded(Exception):
    """A write refused by the disk budget: the filesystem is at or below
    ``min_free_bytes`` and the journal is read-only until the budget
    re-arms. The front door sheds and the loop parks on it."""


class Journal:
    """Append-only JSONL journal with per-key generation stamps.

    Every append first refreshes from the shared file (records appended
    by other writers are folded into the generation table) and then
    writes with generation last+1, all inside an exclusive ``flock`` on
    the active file (chasing a rotation's rename), so concurrent writers
    interleave at record granularity and ``expected_generation`` is
    checked atomically."""

    def __init__(self, path: str, fsync: bool = False,
                 rotate_bytes: Optional[int] = None,
                 rotate_records: Optional[int] = None,
                 min_free_bytes: int = 0, metrics=None):
        self.path = path
        self.fsync = fsync
        # Rotation thresholds (0 = off: the single-file journal).
        self.rotate_bytes = int(rotate_bytes or 0)
        self.rotate_records = int(rotate_records or 0)
        # Disk budget (0 = off), preflighted inside every append's flock.
        self.budget = DiskBudget(path, min_free_bytes, metrics=metrics)
        # Fence predicate, evaluated inside the append flock; False
        # raises JournalFenced. None = unfenced.
        self.fence = None
        self._fh = open(path, "a", encoding="utf-8")
        # Appends since the last sync(), and the wall seconds spent in
        # sync() (flush, fsync and any rotation).
        self._dirty = False
        self.sync_seconds = 0.0
        self._locked_repair()
        # Per-(kind, key) generation table, how far the active file is
        # read, its inode, and how many complete lines that covers (the
        # checkpoint position's offset).
        self._generations: dict[tuple, int] = {}
        self._read_offset = 0
        self._read_ino = os.fstat(self._fh.fileno()).st_ino
        self._active_lines = 0
        # Lines written through this handle: the bridge's speculation
        # token reads it, so any journaled write discards a speculation.
        self.writes_seq = 0
        # Generations recovered from a checkpoint (seed_generations): a
        # segment that retention deleted may hold a key's only write,
        # so they floor every rescan.
        self._seed_gens: dict[tuple, int] = {}
        self.refresh()

    # -- segment topology --

    def sealed_segments(self) -> list:
        """Sorted [(ordinal, path)] of the sealed segments of the current
        lineage (a crashed compaction's leftovers are excluded)."""
        return read_segments(self.path)

    @property
    def lineage(self) -> int:
        """Compaction era, bumped by compact(): segments and checkpoints
        of an older lineage are dead."""
        return read_lineage(self.path)

    def active_ordinal(self) -> int:
        """The ordinal the active file takes when sealed."""
        return read_active_ordinal(self.path)

    def position(self) -> dict:
        """Where the journal ends now: ``{"lineage", "segment",
        "offset"}``, the offset counting complete lines of the active
        file, its meta line included. A checkpoint stores this and
        ``replay_from`` resumes there."""
        self.refresh()
        return {"lineage": self.lineage,
                "segment": self.active_ordinal(),
                "offset": self._active_lines}

    # -- the disk gate --

    @property
    def degraded(self) -> bool:
        """True while the disk budget holds the journal read-only."""
        return self.budget.degraded

    def rearm_probe(self) -> bool:
        """Check free space and re-arm if it recovered; True when the
        journal is writable after the probe."""
        return self.budget.rearm_probe()

    def writable(self) -> bool:
        """The engine's cycle gate: True when appends may proceed. It
        probes: an armed budget over a full filesystem degrades here,
        before the cycle admits what it could not journal, and a
        degraded one re-arms as soon as space returns."""
        if not self.budget.enabled:
            return True
        if self.budget.degraded:
            return self.budget.rearm_probe()
        return self.budget.preflight(256)

    # -- the generation table --

    def seed_generations(self, gens: dict) -> None:
        """Floor the generation table with checkpoint-recovered stamps
        (``{(kind, key): gen}``), so a key whose last write sat in a
        deleted segment does not restart at generation 1."""
        for k, g in gens.items():
            g = int(g)
            self._seed_gens[k] = max(self._seed_gens.get(k, 0), g)
            if g > self._generations.get(k, 0):
                self._generations[k] = g

    def refresh(self) -> int:
        """Fold records appended since the last read (by other writers,
        or ours) into the generation table. Returns how many were new.
        An active file swapped by a rotation or a compaction, or shrunk
        by a torn-tail repair, is rescanned from the segment chain."""
        try:
            with open(self.path, "rb") as fh:
                st = os.fstat(fh.fileno())
                if (st.st_ino != self._read_ino
                        or st.st_size < self._read_offset):
                    self._rescan_base()
                    self._read_ino = st.st_ino
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
            self._active_lines += 1
            rec = _parsed(line)
            if rec is None or rec.get("op") == "meta":
                continue
            self._fold(rec)
            n += 1
        self._read_offset += end + 1
        return n

    def _fold(self, rec: dict) -> None:
        key = (rec.get("kind"), _key_of(rec))
        self._generations[key] = int(rec.get("gen", 0)) or \
            self._generations.get(key, 0) + 1

    def _rescan_base(self) -> None:
        """Reset the incremental read and fold every sealed segment's
        generations back in (the caller re-reads the active file);
        checkpoint-seeded floors survive."""
        self._read_offset = 0
        self._active_lines = 0
        self._generations.clear()
        for _ordinal, seg in self.sealed_segments():
            try:
                with open(seg, "rb") as fh:
                    data = fh.read()
            except FileNotFoundError:
                continue
            end = data.rfind(b"\n")
            for line in data[:end].split(b"\n") if end >= 0 else ():
                rec = _parsed(line)
                if rec is not None and rec.get("op") != "meta":
                    self._fold(rec)
        for k, g in self._seed_gens.items():
            if g > self._generations.get(k, 0):
                self._generations[k] = g

    def generation_of(self, kind: str, key: str) -> int:
        """The last persisted generation of a key (0 = never written);
        read-modify-write callers pass it back as
        ``expected_generation``."""
        self.refresh()
        return self._generations.get((kind, key), 0)

    # -- torn tails --

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

    # -- writes --

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
        write (fenced, degraded, ENOSPC) no generation is recorded
        in-process, and the next refresh folds in whatever full lines
        reached the disk."""
        objs = list(objs)
        if not objs:
            return []
        recs = [{"op": "apply", "kind": kind, "ts": ts,
                 "v": SCHEMA_VERSION, "obj": to_jsonable(obj)}
                for obj in objs]
        self._lock_active()
        try:
            self._admit_write(len(recs), f"batched write of {len(recs)} "
                                         f"{kind} record(s)")
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

    def _lock_active(self) -> None:
        """flock the active file, chasing a rotation's rename: a handle
        opened before a rotation points at a sealed segment, and writing
        there would put records behind those of the new active file.
        Reopens with O_APPEND and without O_CREAT, so it never races the
        rotating writer's own reopen."""
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        for _ in range(64):
            try:
                if (os.fstat(self._fh.fileno()).st_ino
                        == os.stat(self.path).st_ino):
                    break
                fd = os.open(self.path, os.O_WRONLY | os.O_APPEND)
            except FileNotFoundError:
                continue  # between the rename and the reopen
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            self._fh.close()
            self._fh = os.fdopen(fd, "a", encoding="utf-8")
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)

    def _admit_write(self, n: int, what: str) -> None:
        """Under the lock, before any write: trim another writer's torn
        fragment, then the fence, then the disk preflight (a fenced
        writer hears "fenced", not "disk full")."""
        if not self._tail_is_clean():
            self._repair_torn_tail()
        if self.fence is not None and not self.fence():
            raise JournalFenced(f"{what} refused: fence predicate failed "
                                f"(no longer leader)")
        if not self.budget.preflight(256 * n):
            raise JournalDegraded(f"{what} refused: journal degraded "
                                  f"read-only ({self.budget.reason})")

    def _stamp_and_write(self, rec: dict, kind: str, key: str,
                         expected_generation: Optional[int]) -> int:
        self._lock_active()
        try:
            self._admit_write(1, f"write of {kind}/{key}")
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
        try:
            self._fh.write(blob)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            else:
                self._dirty = True
        except OSError as e:
            if e.errno == errno.ENOSPC:
                # The preflight raced the filesystem: degrade. A partial
                # line is the torn tail the next locked repair trims.
                self.budget.note_enospc(e)
                raise JournalDegraded(f"append hit ENOSPC: {e}") from e
            raise
        # Our own lines are already in the generation table: skip them on
        # the next refresh().
        self._read_offset += len(blob.encode("utf-8"))
        self._active_lines += len(lines)
        self.writes_seq += len(lines)

    def sync(self) -> None:
        """Crash-safe cycle boundary: flush + fsync every append since
        the last sync, then seal the active file if it crossed a
        rotation threshold. A no-op when nothing is pending, so an idle
        serving loop does not touch the disk; an ENOSPC degrades the
        budget and leaves the appends pending for a later sync."""
        if not self._dirty:
            return
        t0 = time.perf_counter()
        try:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except OSError as e:
                if e.errno == errno.ENOSPC:
                    self.budget.note_enospc(e)
                    return
                raise
            self._dirty = False
            self.maybe_rotate()
        finally:
            self.sync_seconds += time.perf_counter() - t0

    # -- rotation and retention --

    def maybe_rotate(self) -> bool:
        """Seal the active file as ``<path>.seg<NNNNNN>`` and open a new
        one when a threshold is crossed. True when it rotated."""
        if not (self.rotate_bytes or self.rotate_records):
            return False
        try:
            size = os.path.getsize(self.path)
        except FileNotFoundError:
            return False
        if not ((self.rotate_bytes and size >= self.rotate_bytes)
                or (self.rotate_records
                    and self._active_lines >= self.rotate_records)):
            return False
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            try:
                if (os.fstat(self._fh.fileno()).st_ino
                        != os.stat(self.path).st_ino):
                    return False  # another writer rotated first
            except FileNotFoundError:
                return False
            if not self._tail_is_clean():
                self._repair_torn_tail()
            ordinal = self.active_ordinal()
            lineage = self.lineage
            os.rename(self.path, _segment_path(self.path, ordinal))
            if MAINTENANCE_CRASH_HOOK is not None:
                MAINTENANCE_CRASH_HOOK("rotate")
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            new_fh = os.fdopen(fd, "a", encoding="utf-8")
            # The meta line is no journaled write: writes_seq stays.
            line = json.dumps({"op": "meta", "kind": _META_KIND,
                               "seg": ordinal + 1,
                               "lineage": lineage}) + "\n"
            new_fh.write(line)
            new_fh.flush()
            os.fsync(fd)
            self._dir_sync()
            old = self._fh
            self._fh = new_fh
            self._read_ino = os.fstat(fd).st_ino
            self._read_offset = len(line.encode("utf-8"))
            self._active_lines = 1
            fcntl.flock(old.fileno(), fcntl.LOCK_UN)
            old.close()
            return True
        finally:
            with contextlib.suppress(ValueError, OSError):
                if not self._fh.closed:
                    fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    def _dir_sync(self) -> None:
        """fsync the parent directory, so a rename survives power loss."""
        _dir_sync(os.path.dirname(self.path) or ".")

    def retain_segments(self, min_ordinal: int) -> int:
        """Delete the sealed segments a checkpoint covers (ordinal below
        ``min_ordinal``) and any of another lineage. Returns how many
        files went."""
        lineage = self.lineage
        removed = 0
        for ordinal, seg in _sealed_segments(self.path):
            meta = _file_meta(seg)
            stale = int((meta or {}).get("lineage", 0)) != lineage
            if stale or ordinal < min_ordinal:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(seg)
                    removed += 1
        return removed

    def close(self) -> None:
        if not self._fh.closed:
            self.sync()
        self._fh.close()

    # -- reads --

    def replay(self) -> Iterator[dict]:
        """The records in append order across the segment chain. A torn
        final line of the active file is skipped; corruption anywhere
        else raises JournalCorruption."""
        return read_chain(self.path)

    def replay_from(self, position: dict) -> Iterator[dict]:
        """Only the records past a checkpoint's ``position()``: the
        recovery suffix. Raises ValueError when the position's lineage
        is not the journal's (compacted since) or its segment lies past
        the active file."""
        return read_suffix(self.path, position)

    def compact(self) -> None:
        """Rewrite the journal as the last record per (kind, key), in
        first-seen order, tombstoned keys dropped, as a new lineage: a
        crash anywhere in the cleanup after the replace leaves a journal
        that replays to the same state. Not for a journal under
        checkpoint retention (its deleted history is not in the fold)."""
        last: dict[tuple, dict] = {}
        order: list[tuple] = []
        for rec in self.replay():
            key = (rec["kind"], _key_of(rec))
            if key not in last:
                order.append(key)
            last[key] = rec
        lineage = self.lineage
        ordinal = self.active_ordinal()
        self._fh.close()
        tmp = self.path + ".compact"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps({"op": "meta", "kind": _META_KIND,
                                 "seg": ordinal + 1,
                                 "lineage": lineage + 1}) + "\n")
            for key in order:
                rec = last[key]
                if rec["op"] != "delete":
                    fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self._dir_sync()
        if MAINTENANCE_CRASH_HOOK is not None:
            MAINTENANCE_CRASH_HOOK("compact")
        # Segments of the old lineage are already dead: deleting them
        # only frees the space.
        for _ordinal, seg in _sealed_segments(self.path):
            with contextlib.suppress(FileNotFoundError):
                os.remove(seg)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._generations.clear()
        self._seed_gens.clear()
        self._read_offset = 0
        self._active_lines = 0
        self._read_ino = os.fstat(self._fh.fileno()).st_ino
        self.refresh()


def _parsed(line: bytes) -> Optional[dict]:
    """One journal line's record, or None for a blank or unparseable
    line."""
    if not line.strip():
        return None
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return None


def _dir_sync(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _replay_file(path: str, tolerate_torn: bool,
                 skip_lines: int = 0) -> Iterator[dict]:
    """One journal file's records from line ``skip_lines`` on, meta
    lines skipped. With ``tolerate_torn`` an unparseable final line is
    skipped; any other unparseable line raises JournalCorruption."""
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().split("\n")
    except FileNotFoundError:
        return
    for i, line in enumerate(lines):
        if i < skip_lines:
            continue
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if tolerate_torn and not any(
                    rest.strip() for rest in lines[i + 1:]):
                return  # torn tail (crash mid-write)
            raise JournalCorruption(
                f"{path}:{i + 1}: unparseable record "
                "with records after it") from None
        if rec.get("op") == "meta":
            continue  # a rotated file's control record
        yield upgrade_record(rec)


def read_records(path: str) -> Iterator[dict]:
    """Yield one journal file's records in append order (a rotated
    file's meta line skipped), without opening it for writing or
    repairing it. A truncated or corrupt final line is skipped; an
    unparseable line with records after it raises JournalCorruption."""
    return _replay_file(path, tolerate_torn=True)


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


def engine_from_records(records, workloads_from=None, clock=None,
                        **engine_kwargs):
    """Apply a journal record sequence to a new
    ``Engine(**engine_kwargs)``: objects are
    re-created in order, then each workload's last persisted state is
    restored through ``Engine.restore_workload``; the clock is the
    largest record timestamp. A rotated file's meta lines are skipped.
    ``workloads_from(key, obj)``, when given, returns the Workload of a
    workload's last record object, and ``clock`` the clock (a journal
    tailer replays what it folded of the records it read, and its read
    models share the workloads whose records did not change); by
    default each workload is decoded anew."""
    from kueue_tpu_torch.controllers.engine import Engine

    eng = Engine(**engine_kwargs)
    given_clock = clock
    records = [rec for rec in records if rec.get("op") != "meta"]
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
    eng.clock = clock if given_clock is None else given_clock
    for key in wl_order:
        eng.restore_workload(from_jsonable(workloads[key])
                             if workloads_from is None
                             else workloads_from(key, workloads[key]))
    return eng


def rebuild_engine(path: str, use_checkpoint: bool = True,
                   journal_kwargs=None, **engine_kwargs):
    """Cold-start an engine from a journal (the restart path), then
    re-attach the journal, configured by ``journal_kwargs`` (fsync,
    rotation thresholds, the disk budget), for further writes.

    When a sealed checkpoint of the journal's lineage loads clean
    (``store/checkpoint.recover_records``), the engine is its base plus
    the journal suffix past its position: the only complete path once
    retention deleted the segments it covers. Otherwise every record is
    replayed from the first. The engine's clock is the last persisted
    timestamp (or the checkpoint's clock, if later), and it carries
    ``rebuild_source`` ("checkpoint" or "genesis"),
    ``rebuild_base_records``, ``rebuild_suffix_records``,
    ``rebuild_records`` (their sum), ``rebuild_position`` and
    ``rebuild_wall``."""
    journal = Journal(path, **(journal_kwargs or {}))
    base: list = []
    meta = None
    if use_checkpoint:
        from kueue_tpu_torch.store.checkpoint import recover_records
        base, suffix, meta = recover_records(journal)
    if meta is None:
        records = suffix = list(journal.replay())
    else:
        records = base + suffix
    eng = engine_from_records(records, **engine_kwargs)
    if meta is not None:
        eng.clock = max(eng.clock, float(meta.clock))
        journal.seed_generations(
            {(r["kind"], _key_of(r)): int(r.get("gen", 0))
             for r in base if r.get("gen")})
    eng.rebuild_source = "genesis" if meta is None else "checkpoint"
    eng.rebuild_base_records = len(base)
    eng.rebuild_suffix_records = len(suffix)
    eng.rebuild_records = len(records)
    eng.rebuild_position = journal.position()
    eng.rebuild_wall = time.time()
    eng.attach_journal(journal, record_existing=False)
    return eng


def attach_new_journal(engine, path: str, fsync: bool = False,
                       **journal_kwargs) -> Journal:
    """Start journaling a live engine, writing its current state first.
    Extra keywords (rotation thresholds, ``min_free_bytes``) configure
    the journal."""
    journal = Journal(path, fsync=fsync, **journal_kwargs)
    engine.attach_journal(journal, record_existing=True)
    return journal
