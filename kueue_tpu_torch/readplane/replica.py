"""A stateless read replica: checkpoint boot + journal suffix tail.

The port of ``kueue_tpu/readplane/replica.py``.

The replica is the read half of the CQRS split. It never runs
admission cycles and never holds a writable journal handle; its whole
world is the leader's journal, consumed through the HA follower tailer
(checkpoint base + suffix rebuild, segment rotation, compaction
resync). On top of the tailer it adds the things a *query* tier needs
that a *failover* tier doesn't:

  * a staleness envelope on every answer — the journal position the
    read model was rebuilt at, the tail's record lag past it, the wall
    age of the rebuild point, and the correlation id of the last
    admission cycle whose trace record passed through the tail — so a
    caller can always tell what state answered them;
  * a stable identity across rebuilds: the tailer REPLACES its engine
    object every rebuild, so metrics, SLO windows and query counters
    live here (one registry per replica process, never reset by a
    rebuild);
  * read SLOs (obs/slo.py ReadSLOEngine): read p99 + staleness-bound
    burn rates, exported through the same slo_* gauge families the
    cycle side uses.

Watch streams ride the same tail: the tailer publishes synthesized
journal events into the replica's own FanoutHub, so SSE fanout happens
entirely on replicas — the leader's hub never sees a watcher.
"""

from __future__ import annotations

import time
from typing import Optional


class ReadReplica:
    def __init__(self, path: str, replica_id: str = "read-0",
                 hub=None, metrics=None,
                 engine_kwargs: Optional[dict] = None,
                 rebuild_every: int = 8,
                 clock=time.monotonic):
        from kueue_tpu_torch.ha.tailer import JournalTailer
        from kueue_tpu_torch.metrics.registry import MetricsRegistry
        from kueue_tpu_torch.obs.slo import ReadSLOEngine
        from kueue_tpu_torch.visibility.fanout import FanoutHub

        self.path = path
        self.replica_id = replica_id
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self.hub = hub if hub is not None \
            else FanoutHub(metrics=self.metrics)
        self._clock = clock
        self.tailer = JournalTailer(
            path, hub=self.hub, metrics=self.metrics,
            rebuild_every=rebuild_every, engine_kwargs=engine_kwargs,
            clock=clock)
        # Time the tailer's rebuilds without subclassing: the instance
        # attribute shadows the method at the tailer's own call sites.
        self._inner_rebuild = self.tailer.rebuild
        self.tailer.rebuild = self._timed_rebuild
        self.slo = ReadSLOEngine(registry=self.metrics)
        self.queries = 0
        self.started_at = clock()

    # -- tail lifecycle --

    def _timed_rebuild(self) -> None:
        t0 = self._clock()
        self._inner_rebuild()
        try:
            self.metrics.histogram("readplane_rebuild_seconds").observe(
                max(0.0, self._clock() - t0))
        except KeyError:
            pass

    def poll(self) -> int:
        """One tail step; refreshes the lag/age gauges. Cheap — call
        every tick."""
        n = self.tailer.poll()
        self._gauges()
        return n

    def _gauges(self) -> None:
        try:
            self.metrics.gauge("readplane_replay_lag_records").set(
                (), float(self.tailer.replay_lag))
            if self.tailer.applied_at is not None:
                self.metrics.gauge(
                    "readplane_last_applied_age_seconds").set(
                        (), max(0.0,
                                self._clock() - self.tailer.applied_at))
        except KeyError:
            pass

    # -- the staleness envelope --

    @property
    def engine(self):
        return self.tailer.engine

    def staleness(self) -> Optional[dict]:
        """What state answers right now: the rebuild position, the
        tail's consumed position past it, record lag, wall age of the
        rebuild point, and the last applied cycle's correlation id.
        None until the first rebuild (no read model → no answer)."""
        t = self.tailer
        if t.engine is None or t.applied_at is None:
            return None
        wall_age = max(0.0, self._clock() - t.applied_at)
        return {
            "position": t.applied_position,
            "tailPosition": t.position(),
            "lagRecords": t.replay_lag,
            "wallAgeSeconds": round(wall_age, 6),
            "cid": t.last_cycle_cid,
            "replica": self.replica_id,
        }

    def staleness_bound(self) -> Optional[float]:
        """The advertised scalar bound: seconds since the read model's
        rebuild point. Everything the answer is missing happened after
        that instant, so wall age upper-bounds the answer's staleness
        as long as the tail keeps polling (lagRecords says how much is
        already known to be pending)."""
        st = self.staleness()
        return None if st is None else st["wallAgeSeconds"]

    def stamp(self, payload: dict) -> dict:
        payload["staleness"] = self.staleness()
        return payload

    # -- queries --

    def query(self, kind: str, arg: str = None) -> dict:
        """Answer one read query from the local read model, stamped.
        Never raises for missing state: an empty read model answers
        503-shaped ({"error": ...}) so the front end can degrade."""
        from kueue_tpu_torch.readplane.queries import answer_query

        t0 = time.perf_counter()
        self.queries += 1
        eng = self.tailer.engine
        if eng is None:
            self._count(kind, "no_read_model")
            return {"kind": kind, "error": "no read model yet",
                    "staleness": None}
        try:
            answer = answer_query(eng, kind, arg)
            result = "ok"
        except ValueError as e:
            self._count(kind, "bad_kind")
            return {"kind": kind, "error": str(e), "staleness": None}
        except RuntimeError:
            # Mid-rebuild engine swap raced the dict walk: the caller
            # retries; the envelope says why.
            result = "retry"
            answer = None
        dur = time.perf_counter() - t0
        bound = self.staleness_bound()
        self._count(kind, result)
        try:
            self.metrics.histogram(
                "readplane_query_duration_seconds").observe(dur, (kind,))
            if bound is not None:
                self.metrics.histogram(
                    "readplane_staleness_seconds").observe(bound, (kind,))
        except KeyError:
            pass
        self.slo.observe_read(dur, bound)
        out = {"kind": kind, "answer": answer}
        if arg is not None:
            out["arg"] = arg
        return self.stamp(out)

    def _count(self, kind: str, result: str) -> None:
        try:
            self.metrics.counter("readplane_queries_total").inc(
                (kind, result))
        except KeyError:
            pass

    # -- introspection (/debug/readplane) --

    def status(self) -> dict:
        return {
            "enabled": True,
            "replica": self.replica_id,
            "journal": self.path,
            "queries": self.queries,
            "staleness": self.staleness(),
            "tailer": self.tailer.status(),
            "sse": self.hub.stats(),
            "readSlo": self.slo.summary(),
        }
