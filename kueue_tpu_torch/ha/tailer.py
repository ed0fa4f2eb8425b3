"""Follower-side journal tailing.

The port of ``kueue_tpu/ha/tailer.py``.

A follower never runs admission cycles; its view of the world is the
leader's journal, consumed incrementally. The tailer reads complete
lines past its last offset (a trailing partial line — the torn-tail
case — is left in place and re-read once the leader's next fsync
completes it), folds them into counters, forwards synthesized events
to the SSE fanout hub, and refreshes a cold-rebuilt read-model engine
that the HTTP layer serves GETs from.

Segment rotation (store/journal.py): the tailer walks the sealed
segment chain in ordinal order and follows the active file across
rotations. A gap (retention deleted a segment the follower hadn't
consumed — it was asleep past the checkpoint horizon) or a lineage
change (compaction) forces a full resync through the checkpoint
recovery path, which is also what ``rebuild()`` uses: checkpoint base
+ journal suffix, O(delta) instead of O(history).

Rebuild throttling is jittered: after each throttled rebuild the next
one is pushed out by a FULL-JITTER exponential backoff
(uniform(0, min(cap, base·2^streak))), so N followers that all saw the
same failover burst don't rebuild — and hammer the shared journal
volume — in lockstep.

Replay lag is the tailer's headline number: records observed in the
file but not yet folded into the read model. ``/debug/ha`` and the
``ha_replay_lag_records`` gauge both report it, and promotion latency
is dominated by draining it to zero.
"""

from __future__ import annotations

import json
import random
import time
from typing import Optional


class JournalTailer:
    """Incremental reader of a live (possibly segmented) journal.

    ``poll()`` is cheap and safe to call every tick; the read-model
    rebuild (checkpoint + suffix replay) is throttled to at most once
    per ``rebuild_every`` new records, with full-jitter exponential
    backoff between consecutive throttled rebuilds.
    """

    def __init__(self, path: str, hub=None, metrics=None,
                 rebuild_every: int = 32,
                 engine_kwargs: Optional[dict] = None,
                 rebuild_backoff_base: float = 0.05,
                 rebuild_backoff_cap: float = 2.0,
                 rng: Optional[random.Random] = None,
                 clock=time.monotonic):
        self.path = path
        self.hub = hub
        self.metrics = metrics
        self.rebuild_every = max(1, int(rebuild_every))
        self.engine_kwargs = dict(engine_kwargs or {})
        self.engine = None          # the read model (None until 1st poll)
        self.records_seen = 0
        self.rebuilds = 0
        self.resyncs = 0
        self.last_checkpoint: Optional[dict] = None  # last ha_digest obj
        self._ordinal: Optional[int] = None  # file the offset refers to
        self._offset = 0
        self._lines = 0             # complete lines consumed of _ordinal
        self._lineage = 0
        self._pending = 0           # records seen since last rebuild
        # Staleness envelope inputs (readplane/): the journal
        # position the read model was rebuilt at, when that happened on
        # this process's clock, and the correlation id of the last
        # admission cycle whose trace record passed through the tail.
        self.applied_position: Optional[dict] = None
        self.applied_at: Optional[float] = None
        self.last_cycle_cid: Optional[str] = None
        self.last_record_ts: Optional[float] = None
        # Full-jitter rebuild backoff (anti-thundering-herd): streak
        # counts consecutive throttled rebuilds; one quiet poll resets.
        self.rebuild_backoff_base = float(rebuild_backoff_base)
        self.rebuild_backoff_cap = float(rebuild_backoff_cap)
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._streak = 0
        self._cooldown_until = 0.0
        # What the tail read since genesis, folded, while it read every
        # record (``_whole``): the records of every kind but workloads
        # (ephemeral kinds aside), in order; per workload key, in the
        # order of its first apply, its namespace and name, and its last
        # apply record's line (None once deleted); the largest record
        # timestamp. A rebuild replays exactly that (``_fold``).
        self._others: list = []
        self._workloads: dict = {}
        self._max_ts = 0.0
        self._whole = False
        # key -> (the line its Workload was decoded from, the Workload)
        # of the newest read model.
        self._decoded: dict = {}

    @property
    def replay_lag(self) -> int:
        """Records durable in the journal but not in the read model."""
        return self._pending

    def position(self) -> Optional[dict]:
        """The consumed tail position in ``Journal.position()``
        coordinates ({lineage, segment, offset} — offset in complete
        LINES of the file named by segment, meta line included), or
        None before the first poll."""
        if self._ordinal is None:
            return None
        return {"lineage": self._lineage, "segment": self._ordinal,
                "offset": self._lines}

    # -- segment chain helpers --

    def _segments(self) -> list:
        from kueue_tpu_torch.store.journal import (
            _file_meta,
            _sealed_segments,
        )

        lineage = self._journal_lineage()
        out = []
        for ordinal, seg in _sealed_segments(self.path):
            meta = _file_meta(seg)
            if int((meta or {}).get("lineage", 0)) == lineage:
                out.append((ordinal, seg))
        return out

    def _journal_lineage(self) -> int:
        from kueue_tpu_torch.store.journal import (
            _file_meta,
            _sealed_segments,
        )

        meta = _file_meta(self.path)
        if meta is not None:
            return int(meta.get("lineage", 0))
        segs = _sealed_segments(self.path)
        if segs:
            m = _file_meta(segs[-1][1])
            if m is not None:
                return int(m.get("lineage", 0))
        return 0

    def _active_ordinal(self, segs: list) -> int:
        from kueue_tpu_torch.store.journal import _file_meta

        meta = _file_meta(self.path)
        if meta is not None and "seg" in meta:
            return int(meta["seg"])
        return (segs[-1][0] + 1) if segs else 0

    def _walk(self) -> tuple:
        """Consume newly completed lines across the segment chain:
        (records, whether the walk had to resync)."""
        segs = self._segments()
        sealed = dict(segs)
        active_ord = self._active_ordinal(segs)
        lineage = self._journal_lineage()
        if self._ordinal is None:
            self._ordinal = segs[0][0] if segs else active_ord
            self._lineage = lineage
            self._whole = self._ordinal == 0
        elif lineage != self._lineage:
            # Compaction rewrote history: positions are meaningless.
            self._resync(active_ord, lineage)
            return 0, True
        new = 0
        while True:
            if self._ordinal in sealed:
                n, _complete = self._consume(sealed[self._ordinal])
                new += n
                # Sealed files never grow: move on regardless.
                self._ordinal += 1
                self._offset = 0
                self._lines = 0
                continue
            if self._ordinal != active_ord:
                # Gap: retention deleted unread segments (we slept past
                # the checkpoint horizon) — positions are unrecoverable.
                self._resync(active_ord, lineage)
                return new, True
            n, _complete = self._consume(self.path)
            new += n
            break
        return new, False

    def poll(self) -> int:
        """Consume newly completed journal lines across the segment
        chain. Returns how many new records were observed."""
        new, resynced = self._walk()
        if resynced:
            return new
        if new == 0:
            self._streak = 0
            if self._pending and self.engine is not None:
                # The tail went quiet with records still unfolded (a
                # dead leader stops the stream exactly here): fold now
                # — a quiet journal is the cheapest moment to rebuild,
                # and below-threshold lag would otherwise never clear,
                # pinning every replica answer behind the final writes.
                self.rebuild()
            elif self.engine is not None:
                # The read model holds every record the journal has: it
                # is current now. (The JAX tailer stamps only rebuilds,
                # so a quiet journal, such as an HA failover's window,
                # ages its answers though they miss nothing.)
                self.applied_at = self._clock()
            self._gauge()
            return 0
        self.records_seen += new
        self._pending += new
        if self.engine is None:
            self.rebuild()
        elif self._pending >= self.rebuild_every:
            now = self._clock()
            if now >= self._cooldown_until:
                self.rebuild()
                self._streak += 1
                delay = self._rng.uniform(0.0, min(
                    self.rebuild_backoff_cap,
                    self.rebuild_backoff_base * (2.0 ** self._streak)))
                self._cooldown_until = now + delay
        self._gauge()
        return new

    def _consume(self, path: str) -> tuple:
        """Ingest complete lines of ``path`` past the current offset.
        Returns (records_ingested, consumed_to_eof)."""
        try:
            with open(path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except FileNotFoundError:
            return 0, True
        if not chunk:
            return 0, True
        # Only complete lines: a torn tail stays unconsumed until the
        # leader's next write completes it (or repair truncates it).
        complete = chunk.rfind(b"\n") + 1
        if complete == 0:
            return 0, False
        # Line-position bookkeeping mirrors Journal._active_lines: every
        # complete line counts (meta lines included), so position() is
        # directly comparable with the leader journal's position().
        self._lines += chunk[:complete].count(b"\n")
        new = 0
        for line in chunk[:complete].splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # Corrupt interior line: repair's problem, and the
                # journal's own replay (which raises) decides a rebuild.
                self._drop_records()
                continue
            if rec.get("op") == "meta":
                continue
            new += 1
            if self._whole:
                self._note(rec, line)
            self._ingest(rec)
        self._offset += complete
        return new, complete == len(chunk)

    def _resync(self, active_ord: int, lineage: int) -> None:
        """Full re-read through the checkpoint recovery path, then
        fast-forward the tail position to the journal's current end."""
        self.resyncs += 1
        self._drop_records()
        self.rebuild()
        self._lineage = lineage
        self._ordinal = active_ord
        try:
            with open(self.path, "rb") as f:
                data = f.read()
            self._offset = data.rfind(b"\n") + 1
            self._lines = data[:self._offset].count(b"\n")
        except FileNotFoundError:
            self._offset = 0
            self._lines = 0
        self._gauge()

    def _ingest(self, rec: dict) -> None:
        kind = rec.get("kind")
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            self.last_record_ts = float(ts)
        if kind == "cycle_trace":
            obj = rec.get("obj")
            if isinstance(obj, dict) and obj.get("name"):
                self.last_cycle_cid = str(obj["name"])
        if kind == "ha_digest":
            self.last_checkpoint = rec.get("obj")
            if self.hub is not None:
                self.hub.publish("ha_checkpoint",
                                 json.dumps(self.last_checkpoint))
        elif self.hub is not None:
            # Synthesized watch event: followers can't replay the
            # leader's EngineEvents, but the journal record itself is
            # the authoritative change feed.
            obj = rec.get("obj")
            key = (obj.get("metadata", {}).get("name", "")
                   if isinstance(obj, dict) else "")
            self.hub.publish("journal", json.dumps({
                "kind": kind, "op": rec.get("op"), "key": key,
                "ts": rec.get("ts"),
            }))

    # -- the records read so far --

    def _note(self, rec: dict, line: bytes) -> None:
        from kueue_tpu_torch.store.journal import EPHEMERAL_KINDS, _key_of

        ts = rec.get("ts", 0.0)
        if ts > self._max_ts:
            self._max_ts = ts
        kind = rec["kind"]
        if kind == "workload":
            key = _key_of(rec)
            entry = self._workloads.get(key)
            if rec["op"] == "delete":
                if entry is not None:
                    entry[2] = None
            elif entry is None:
                self._workloads[key] = [rec["obj"].get("namespace"),
                                        rec["obj"].get("name", ""), line]
            else:
                entry[2] = line
        elif kind not in EPHEMERAL_KINDS:
            self._others.append(rec)

    def _drop_records(self) -> None:
        self._whole = False
        self._others = []
        self._workloads = {}

    @staticmethod
    def _no_checkpoint(path: str) -> bool:
        from kueue_tpu_torch.store.checkpoint import CheckpointStore

        return not CheckpointStore.for_journal(path)._indexed()

    def rebuild(self) -> None:
        """Refresh the read model: checkpoint base + journal suffix
        (genesis replay when no checkpoint exists), no journal attach
        (followers must never hold a writable journal handle).

        Where the JAX tailer opens and reads the journal again for each
        rebuild (two parses of every line), this one keeps what it read:
        while no sealed checkpoint exists and the tail read every record
        since genesis, a rebuild replays that (the first one reads the
        chain to its end first, as the first poll would) and stamps the
        tail's position, where the journal's own stands once the tail
        reached its end. Otherwise it takes the JAX package's path."""
        if self._no_checkpoint(self.path):
            if self._ordinal is None:
                new, resynced = self._walk()
                if resynced:
                    return  # the resync rebuilt
                self.records_seen += new
            if self._whole:
                self._fold_read()
                return
        from kueue_tpu_torch.store.checkpoint import recover_records
        from kueue_tpu_torch.store.journal import (
            Journal,
            engine_from_records,
        )

        journal = Journal(self.path)
        base, suffix, meta = recover_records(journal)
        records = (base + suffix) if meta is not None \
            else list(journal.replay())
        self._stamp(engine_from_records(records, **self.engine_kwargs),
                    meta, journal.position())
        journal.close()

    def _fold_read(self) -> None:
        """The genesis replay of what the tail read, through
        ``engine_from_records``: the records of the other kinds, then
        one apply per live workload in the order of its first apply,
        restored from its last record, at the largest timestamp. A
        workload whose last record is the one the previous read model
        was built from keeps its Workload object (read models are never
        scheduled, and nothing reads them but queries, so two can share
        it): a rebuild decodes only the workloads whose records
        changed."""
        from kueue_tpu_torch.api.serde import from_jsonable
        from kueue_tpu_torch.store.journal import engine_from_records

        records = list(self._others)
        lines = {}
        for key, (ns, name, line) in self._workloads.items():
            if line is not None:
                lines[key] = line
                records.append({"kind": "workload", "op": "apply",
                                "obj": {"namespace": ns, "name": name}})
        decoded = {}

        def workload(key, _obj):
            hit = self._decoded.get(key)
            if hit is None or hit[0] is not lines[key]:
                hit = (lines[key],
                       from_jsonable(json.loads(lines[key])["obj"]))
            decoded[key] = hit
            return hit[1]

        engine = engine_from_records(records, workloads_from=workload,
                                     clock=self._max_ts,
                                     **self.engine_kwargs)
        self._decoded = decoded
        self._stamp(engine, None, self.position())

    def _stamp(self, engine, meta, position: dict) -> None:
        self.engine = engine
        if meta is not None:
            self.engine.clock = max(self.engine.clock, meta.clock)
        # The rebuild folded everything durable at this instant: stamp
        # the position it answered from (the read plane's staleness
        # envelope, and explain's provenance stamp on rebuilt engines).
        self.applied_position = position
        self.applied_at = self._clock()
        self.engine.rebuild_position = self.applied_position
        self.engine.rebuild_wall = time.time()
        self.rebuilds += 1
        self._pending = 0

    def _gauge(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.gauge("ha_replay_lag_records").set(
                    (), float(self._pending))
            except KeyError:
                pass

    def status(self) -> dict:
        return {
            "recordsSeen": self.records_seen,
            "replayLag": self.replay_lag,
            "rebuilds": self.rebuilds,
            "resyncs": self.resyncs,
            "lastCheckpoint": self.last_checkpoint,
            "position": self.position(),
            "appliedPosition": self.applied_position,
            "lastCycleCid": self.last_cycle_cid,
        }
