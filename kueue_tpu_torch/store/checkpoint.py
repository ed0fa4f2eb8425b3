"""Sealed state checkpoints: bounded-time recovery for the journal.

The port of ``kueue_tpu/store/checkpoint.py``. A checkpoint is an
atomic snapshot of the engine's durable state, the records
``Journal.apply`` writes folded to one per live (kind, key), under a
sealed header that binds it to a journal position:

  line 1   header JSON: version, cycle seq, journal position (lineage,
           segment ordinal, line offset), engine clock, the HA decision
           chain's digest, seq and epoch (None, -1 and 0 without HA),
           the admitted-state digest (ha/digest.py), the payload's
           record count and its CRC-32
  line 2+  one apply record per live key, in ``attach_journal``'s order

A write goes to a temp file, is fsynced and renamed into place, and the
directory is fsynced: a crash mid-write leaves only a ``.tmp`` that
recovery never reads. A torn or corrupt checkpoint (short payload, CRC
or count mismatch) is skipped, and recovery falls back to the one
before it, and with none left to the genesis replay.

``recover_records`` gives base + suffix, which ``engine_from_records``
rebuilds to the state of the genesis stream (the fold keeps the last
record per key in first-seen order and drops tombstoned keys, as
``Journal.compact`` does), in O(live state + records since the
checkpoint). The ``Checkpointer`` writes one every ``interval``
non-idle cycles from the engine's ``cycle_listeners`` (after the
cycle's ``journal.sync()``), keeps ``keep`` of them and deletes the
sealed segments the oldest one covers. Mirrored engines of both
packages write byte-identical checkpoint files.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import time
import zlib
from dataclasses import dataclass
from typing import Optional

from kueue_tpu_torch.api.conversion import SCHEMA_VERSION, upgrade_record
from kueue_tpu_torch.api.serde import to_jsonable
from kueue_tpu_torch.ha.digest import admitted_state_digest
from kueue_tpu_torch.store.diskguard import DiskBudget
from kueue_tpu_torch.store.journal import (
    Journal,
    JournalCorruption,
    _dir_sync,
    _key_of,
    engine_from_records,
    read_lineage,
    read_suffix,
)

CKPT_VERSION = 1
_PREFIX = "ckpt-"
_SUFFIX = ".json"

# Fault seam for tests: called with the open temp file mid-write; it may
# write a partial payload and raise OSError (ENOSPC) to prove that the
# abort leaves the previous checkpoint untouched.
WRITE_FAULT = None


@dataclass
class CheckpointMeta:
    """A parsed checkpoint header and where it lives on disk."""

    path: str
    index: int              # file index (the newest is the highest)
    seq: int                # engine cycle seq at the snapshot
    lineage: int            # journal lineage of the position
    segment: int            # active-file ordinal at the snapshot
    offset: int             # complete lines of that file
    clock: float            # engine clock at the snapshot
    chain: Optional[str]    # HA decision-chain digest, or None
    chain_seq: int          # last seq folded into the chain (-1: none)
    epoch: int              # HA lease epoch (0 outside HA)
    state: str              # admitted-state digest at the snapshot
    records: int            # payload record count
    payload_crc: str        # CRC-32 (hex) of the payload bytes

    @property
    def position(self) -> dict:
        return {"lineage": self.lineage, "segment": self.segment,
                "offset": self.offset}


class CheckpointStore:
    """The checkpoint directory beside a journal:
    ``<journal>.ckpt/ckpt-<NNNNNN>.json``."""

    def __init__(self, directory: str, min_free_bytes: int = 0):
        self.directory = directory
        # A checkpoint is the largest single write: it preflights its
        # payload's size on top of the floor.
        self.budget = DiskBudget(directory, min_free_bytes)

    @classmethod
    def for_journal(cls, journal_path: str,
                    min_free_bytes: int = 0) -> "CheckpointStore":
        return cls(journal_path + ".ckpt", min_free_bytes=min_free_bytes)

    # -- enumeration --

    def _indexed(self) -> list:
        """Sorted [(index, path)] of the sealed checkpoint files."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            if (name.startswith(_PREFIX) and name.endswith(_SUFFIX)
                    and name[len(_PREFIX):-len(_SUFFIX)].isdigit()):
                out.append((int(name[len(_PREFIX):-len(_SUFFIX)]),
                            os.path.join(self.directory, name)))
        out.sort()
        return out

    def load(self, index: int, path: str):
        """(meta, payload records) of one checkpoint file, or None when
        it is torn or corrupt in any way."""
        sealed = _sealed(path)
        if sealed is None:
            return None
        hdr, payload = sealed
        records = []
        for line in payload.split(b"\n"):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                return None
        if len(records) != int(hdr.get("records", -1)):
            return None
        return (_meta(path, index, hdr, len(records)),
                [upgrade_record(r) for r in records])

    def iter_valid(self):
        """(meta, records) newest first, skipping every torn or corrupt
        file."""
        for index, path in reversed(self._indexed()):
            loaded = self.load(index, path)
            if loaded is not None:
                yield loaded

    def live_metas(self) -> list:
        """The headers of every valid checkpoint, newest first. A file
        counts as valid when its payload's CRC and line count match its
        header; its records are not parsed (retention reads only the
        headers, on every checkpoint of a 50,000-workload engine)."""
        out = []
        for index, path in reversed(self._indexed()):
            sealed = _sealed(path)
            if sealed is None:
                continue
            hdr, payload = sealed
            n = sum(1 for line in payload.split(b"\n") if line.strip())
            if n == int(hdr.get("records", -1)):
                out.append(_meta(path, index, hdr, n))
        return out

    # -- writing --

    def write(self, engine, seq: Optional[int] = None) -> CheckpointMeta:
        """Snapshot the engine behind its attached journal. Raises
        OSError (ENOSPC, EIO) after removing the temp file: the previous
        checkpoint stays the newest valid one."""
        journal = engine.journal
        if journal is None:
            raise ValueError("checkpoint needs an attached journal")
        position = journal.position()
        records = _snapshot_records(engine, journal)
        payload = b"".join(
            json.dumps(r).encode("utf-8") + b"\n" for r in records)
        hdr = {
            "v": CKPT_VERSION,
            "seq": int(seq if seq is not None else engine.cycle_seq),
            "lineage": position["lineage"],
            "segment": position["segment"],
            "offset": position["offset"],
            "clock": float(engine.clock),
            # The port has no HA decision chain: these are what a JAX
            # engine without HA writes.
            "chain": None,
            "chain_seq": -1,
            "epoch": 0,
            "state": admitted_state_digest(engine),
            "records": len(records),
            "payload_crc": f"{zlib.crc32(payload):08x}",
        }
        os.makedirs(self.directory, exist_ok=True)
        # The preflight comes before the temp file: a refused checkpoint
        # leaves no new byte behind, and the budget re-arms on a later
        # interval's preflight.
        if not self.budget.preflight(len(payload) + 4096):
            raise OSError(
                errno.ENOSPC,
                f"checkpoint preflight refused: {self.budget.reason}")
        indexed = self._indexed()
        index = (indexed[-1][0] + 1) if indexed else 1
        final = os.path.join(self.directory,
                             f"{_PREFIX}{index:06d}{_SUFFIX}")
        tmp = final + ".tmp"
        head = json.dumps(hdr).encode("utf-8") + b"\n"
        try:
            with open(tmp, "wb") as fh:
                fh.write(head)
                if WRITE_FAULT is not None:
                    WRITE_FAULT(fh)
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, final)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                self.budget.note_enospc(e)
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        _dir_sync(self.directory)
        # Read back right after the rename: a disk that lies is an EIO.
        try:
            with open(final, "rb") as fh:
                same = fh.read() == head + payload
        except OSError:
            same = False
        if not same:
            raise OSError(errno.EIO, f"checkpoint unreadable: {final}")
        return _meta(final, index, hdr, len(records))

    def retain(self, keep: int = 2) -> int:
        """Keep the newest ``keep`` checkpoint files, valid or not (a
        corrupt newest file must not evict the good one before it).
        Returns how many went."""
        removed = 0
        indexed = self._indexed()
        for _index, path in indexed[:-keep] if keep > 0 else indexed:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
                removed += 1
        return removed


def _sealed(path: str):
    """(header, payload bytes) of a checkpoint file whose version and
    payload CRC match its header, else None."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    head, _, payload = data.partition(b"\n")
    try:
        hdr = json.loads(head)
    except json.JSONDecodeError:
        return None
    if hdr.get("v") != CKPT_VERSION:
        return None
    if f"{zlib.crc32(payload):08x}" != hdr.get("payload_crc"):
        return None
    return hdr, payload


def _meta(path: str, index: int, hdr: dict, records: int) -> CheckpointMeta:
    return CheckpointMeta(
        path=path, index=index, seq=int(hdr.get("seq", 0)),
        lineage=int(hdr.get("lineage", 0)),
        segment=int(hdr.get("segment", 0)),
        offset=int(hdr.get("offset", 0)),
        clock=float(hdr.get("clock", 0.0)),
        chain=hdr.get("chain"),
        chain_seq=int(hdr.get("chain_seq", -1)),
        epoch=int(hdr.get("epoch", 0)),
        state=str(hdr.get("state", "")),
        records=records,
        payload_crc=str(hdr.get("payload_crc", "")))


def _snapshot_records(engine, journal) -> list:
    """The engine's durable state as apply records, in the order
    ``Engine.attach_journal(record_existing=True)`` writes them, each
    stamped with its key's journal generation."""
    journal.refresh()

    def rec(kind, obj):
        r = {"op": "apply", "kind": kind, "ts": engine.clock,
             "v": SCHEMA_VERSION, "obj": to_jsonable(obj)}
        r["gen"] = journal._generations.get((kind, _key_of(r)), 0)
        return r

    out = []
    for cohort in engine.cache.cohorts.values():
        out.append(rec("cohort", cohort))
    for rf in engine.cache.resource_flavors.values():
        out.append(rec("resource_flavor", rf))
    for cq in engine.cache.cluster_queues.values():
        out.append(rec("cluster_queue", cq))
    for lq in engine.queues.local_queues.values():
        out.append(rec("local_queue", lq))
    for topo in engine.cache.topologies.values():
        out.append(rec("topology", topo))
    for node in engine.cache.nodes.values():
        out.append(rec("node", node))
    for name, value in engine.workload_priority_classes.items():
        out.append(rec("workload_priority_class",
                       {"name": name, "value": value}))
    for wl in engine.workloads.values():
        out.append(rec("workload", wl))
    return out


def recover_records(journal: Journal):
    """The recovery read path: ``(base, suffix, meta)`` from the newest
    checkpoint that loads clean, matches the journal's lineage and has a
    readable suffix; ``meta`` None when there is none (the caller
    replays from genesis)."""
    return recover_records_at(journal.path)


def recover_records_at(path: str):
    """``recover_records`` over the journal at ``path``, read as its
    files stand: nothing is opened for writing, so a killed writer's
    torn tail stays as it was."""
    store = CheckpointStore.for_journal(path)
    lineage = read_lineage(path)
    for meta, base in store.iter_valid():
        if meta.lineage != lineage:
            continue
        try:
            suffix = list(read_suffix(path, meta.position))
        except (ValueError, JournalCorruption):
            continue
        return base, suffix, meta
    return [], [], None


def recover_engine(journal_path: str, engine_kwargs: Optional[dict] = None,
                   prove_genesis: bool = False):
    """An engine from checkpoint + suffix (genesis when there is no
    usable checkpoint), and a report of where it came from. With
    ``prove_genesis`` the genesis replay is built too and the two
    admitted-state digests compared (``identical``)."""
    journal = Journal(journal_path)
    base, suffix, meta = recover_records(journal)
    records = (base + suffix) if meta is not None \
        else list(journal.replay())
    eng = engine_from_records(records, **(engine_kwargs or {}))
    if meta is not None:
        eng.clock = max(eng.clock, meta.clock)
    eng.rebuild_position = journal.position()
    eng.rebuild_wall = time.time()
    report = {
        "source": "checkpoint" if meta is not None else "genesis",
        "position": eng.rebuild_position,
        "checkpoint": None if meta is None else {
            "path": meta.path, "seq": meta.seq,
            "segment": meta.segment, "offset": meta.offset,
            "state": meta.state},
        "base_records": len(base),
        "suffix_records": len(suffix) if meta is not None else len(records),
        "state": admitted_state_digest(eng),
    }
    if prove_genesis:
        genesis = engine_from_records(list(journal.replay()),
                                      **(engine_kwargs or {}))
        report["genesis_state"] = admitted_state_digest(genesis)
        report["identical"] = report["genesis_state"] == report["state"]
    return eng, report


class Checkpointer:
    """The periodic checkpoint writer, on ``engine.cycle_listeners``: it
    runs after the cycle's ``journal.sync()``, so every record its
    position covers is durable. It owns retention: checkpoints beyond
    ``keep`` are deleted and, with ``retain_segments``, the sealed
    segments that the oldest live checkpoint covers. ``interval_s``
    (seconds on ``clock``, ``time.monotonic`` by default) makes one due
    by time as well."""

    def __init__(self, engine, interval: int = 64, keep: int = 2,
                 retain_segments: bool = True,
                 store: Optional[CheckpointStore] = None,
                 min_free_bytes: int = 0,
                 interval_s: Optional[float] = None, clock=None):
        if engine.journal is None:
            raise ValueError("Checkpointer needs an attached journal")
        self.engine = engine
        self.interval = max(1, int(interval))
        self.keep = max(1, int(keep))
        self.retain_segments = retain_segments
        self.store = store or CheckpointStore.for_journal(
            engine.journal.path, min_free_bytes=min_free_bytes)
        self.interval_s = (None if interval_s is None
                           else max(1e-9, float(interval_s)))
        self._clock = clock if clock is not None else time.monotonic
        self._last_t = self._clock()
        self.written = 0
        self.failures = 0
        # Wall seconds of the successful writes (store.write and
        # retention), summed and at most, on time.perf_counter: no
        # decision reads them.
        self.write_s_total = 0.0
        self.write_s_max = 0.0
        self.last_meta: Optional[CheckpointMeta] = None
        self._since = 0
        self._hook = self._on_cycle
        engine.cycle_listeners.append(self._hook)
        engine.checkpointer = self

    def _on_cycle(self, seq: int, result) -> None:
        if result is None:
            return  # an idle or parked cycle covers nothing new
        self._since += 1
        due = self._since >= self.interval
        if not due and self.interval_s is not None:
            due = self._clock() - self._last_t >= self.interval_s
        if due:
            self.checkpoint(seq)

    def checkpoint(self, seq: Optional[int] = None):
        """Write one checkpoint now. A failure (ENOSPC, a torn disk) is
        counted and absorbed: the previous checkpoint stays the recovery
        base, and the next interval retries."""
        self._since = 0
        self._last_t = self._clock()
        t0 = time.perf_counter()
        try:
            meta = self.store.write(self.engine, seq)
        except OSError as e:
            self.failures += 1
            self._count("checkpoint_failures_total",
                        (errno.errorcode.get(e.errno, "OS"),))
            return None
        self.written += 1
        self.last_meta = meta
        self._count("checkpoints_written_total", ())
        self._gauge("checkpoint_last_seq", float(meta.seq))
        self.store.retain(self.keep)
        if self.retain_segments:
            live = [m for m in self.store.live_metas()
                    if m.lineage == self.engine.journal.lineage]
            if live:
                self.engine.journal.retain_segments(
                    min(m.segment for m in live))
        dt = time.perf_counter() - t0
        self.write_s_total += dt
        self.write_s_max = max(self.write_s_max, dt)
        return meta

    def detach(self) -> None:
        with contextlib.suppress(ValueError):
            self.engine.cycle_listeners.remove(self._hook)
        if getattr(self.engine, "checkpointer", None) is self:
            self.engine.checkpointer = None

    def _count(self, family: str, labels: tuple) -> None:
        with contextlib.suppress(KeyError):
            self.engine.registry.counter(family).inc(labels)

    def _gauge(self, family: str, value: float) -> None:
        with contextlib.suppress(KeyError):
            self.engine.registry.gauge(family).set((), value)

    def status(self) -> dict:
        return {
            "written": self.written,
            "failures": self.failures,
            "interval": self.interval,
            "keep": self.keep,
            "lastSeq": None if self.last_meta is None
            else self.last_meta.seq,
            "lastPath": None if self.last_meta is None
            else self.last_meta.path,
            "diskBudget": self.store.budget.status(),
        }
