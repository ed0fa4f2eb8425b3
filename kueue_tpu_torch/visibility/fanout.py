"""Sharded SSE/watch fanout hub.

The original SSE path registered every connected client directly on
``engine.event_listeners``: each event cost O(clients) queue puts IN
THE SCHEDULING THREAD. Fine at ten clients, fatal at ten thousand —
the admission cycle would spend its budget feeding sockets.

The hub inverts that: the scheduling thread (or a follower's journal
tailer) does O(shards) bounded puts into shard inboxes and returns;
per-shard dispatcher threads fan each event out to their slice of
clients. Clients are the same per-connection bounded queues the HTTP
handlers always drained — the hub changes who fills them, not who
reads them.

Slow-consumer policy (as the JAX package's hub):
a client whose queue is full gets the event DROPPED (counted); after
``evict_after`` consecutive drops the client is evicted — removed from
its shard and handed the EVICTED sentinel so its handler thread closes
the stream. One stalled TCP window never stalls the cycle loop, the
dispatchers, or any other client.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Optional

# Handed to an evicted client's queue; the HTTP handler closes on it.
EVICTED = object()
_STOP = object()

# Event kinds suppressed when the hub drops to detail=False (the
# degradation ladder's "fanout" rung): per-cycle chatter that scales
# with cycle rate, not with state changes. Lifecycle events (admitted,
# evicted, preempted, leadership) keep flowing so watchers never lose
# track of WHAT happened — only the high-frequency commentary stops.
DETAIL_KINDS = frozenset({
    "cycle_trace", "admission_shed", "rationale", "heartbeat_detail",
})


class FanoutClient:
    __slots__ = ("id", "queue", "dropped", "consecutive_drops",
                 "evicted", "delivered")

    def __init__(self, cid: int, depth: int):
        self.id = cid
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self.dropped = 0
        self.consecutive_drops = 0
        self.evicted = False
        self.delivered = 0

    def get(self, timeout: Optional[float] = None):
        """Blocking read used by handler threads; raises queue.Empty on
        timeout (heartbeat opportunity)."""
        return self.queue.get(timeout=timeout)


class _Shard:
    def __init__(self, index: int, inbox_depth: int, evict_after: int,
                 hub):
        self.index = index
        self.inbox: queue.Queue = queue.Queue(maxsize=inbox_depth)
        self.evict_after = evict_after
        self.hub = hub
        self.clients: dict[int, FanoutClient] = {}
        self.lock = threading.Lock()
        self.inbox_dropped = 0
        self.thread = threading.Thread(
            target=self._run, name=f"fanout-shard-{index}", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.inbox.get()
            if item is _STOP:
                return
            with self.lock:
                targets = list(self.clients.values())
            for client in targets:
                try:
                    client.queue.put_nowait(item)
                    client.delivered += 1
                    client.consecutive_drops = 0
                except queue.Full:
                    client.dropped += 1
                    client.consecutive_drops += 1
                    self.hub._note_drop()
                    if client.consecutive_drops >= self.evict_after:
                        self._evict(client)

    def _evict(self, client: FanoutClient) -> None:
        with self.lock:
            self.clients.pop(client.id, None)
        client.evicted = True
        # Make room for the sentinel so the handler thread wakes up and
        # sees the eviction even if it never drains another event.
        try:
            client.queue.get_nowait()
        except queue.Empty:
            pass
        try:
            client.queue.put_nowait(EVICTED)
        except queue.Full:
            pass
        self.hub._note_evict()

    def publish(self, item) -> None:
        try:
            self.inbox.put_nowait(item)
        except queue.Full:
            # Dispatcher hopelessly behind: shed at the shard boundary
            # rather than block the scheduling thread.
            self.inbox_dropped += 1
            self.hub._note_drop()

    def stop(self) -> None:
        self.inbox.put(_STOP)


class FanoutHub:
    """Multiplexes (kind, data) events to all subscribed clients.

    Publish cost for the caller is O(shards) non-blocking puts; all
    per-client work happens on shard dispatcher threads.
    """

    def __init__(self, shards: int = 4, client_queue_depth: int = 256,
                 inbox_depth: int = 4096, evict_after: int = 64,
                 metrics=None):
        self.metrics = metrics
        self.client_queue_depth = max(1, int(client_queue_depth))
        self._ids = itertools.count(1)
        self.events_published = 0
        self.events_dropped = 0
        self.clients_evicted = 0
        # Degradation-ladder lever (ha/ladder.py rung "fanout"): False
        # suppresses DETAIL_KINDS at the publish boundary — the
        # scheduling thread stops paying even the O(shards) puts for
        # per-cycle chatter while lifecycle events keep flowing.
        self.detail = True
        self.detail_suppressed = 0
        self._engine_hook = None
        self._engine = None
        self.shards = [
            _Shard(i, inbox_depth, evict_after, self)
            for i in range(max(1, int(shards)))
        ]

    # -- producer side --

    def publish(self, kind: str, data: str) -> None:
        if not self.detail and kind in DETAIL_KINDS:
            self.detail_suppressed += 1
            if self.metrics is not None:
                try:
                    self.metrics.counter(
                        "sse_detail_suppressed_total").inc((kind,))
                except KeyError:
                    pass
            return
        self.events_published += 1
        item = (kind, data)
        for shard in self.shards:
            shard.publish(item)

    def attach_engine(self, engine) -> None:
        """Bridge EngineEvents into the hub with ONE listener (the
        scheduling thread's event cost stops scaling with clients)."""
        import json

        self.detach_engine()

        def _on_event(ev) -> None:
            self.publish(ev.kind, json.dumps({
                "kind": ev.kind, "workload": ev.workload,
                "clusterQueue": ev.cluster_queue, "detail": ev.detail,
                "time": ev.time,
            }))

        engine.event_listeners.append(_on_event)
        engine.fanout = self
        self._engine_hook = _on_event
        self._engine = engine

    def detach_engine(self) -> None:
        if self._engine is not None and self._engine_hook is not None:
            try:
                self._engine.event_listeners.remove(self._engine_hook)
            except ValueError:
                pass
            if getattr(self._engine, "fanout", None) is self:
                self._engine.fanout = None
        self._engine = None
        self._engine_hook = None

    # -- consumer side --

    def subscribe(self, depth: Optional[int] = None) -> FanoutClient:
        client = FanoutClient(next(self._ids),
                              depth or self._client_depth())
        shard = self.shards[client.id % len(self.shards)]
        with shard.lock:
            shard.clients[client.id] = client
        self._gauge_clients()
        return client

    def unsubscribe(self, client: FanoutClient) -> None:
        shard = self.shards[client.id % len(self.shards)]
        with shard.lock:
            shard.clients.pop(client.id, None)
        self._gauge_clients()

    def _client_depth(self) -> int:
        return self.client_queue_depth

    # -- accounting --

    def client_count(self) -> int:
        return sum(len(s.clients) for s in self.shards)

    def _note_drop(self) -> None:
        self.events_dropped += 1
        if self.metrics is not None:
            try:
                self.metrics.counter("sse_events_dropped_total").inc(())
            except KeyError:
                pass

    def _note_evict(self) -> None:
        self.clients_evicted += 1
        if self.metrics is not None:
            try:
                self.metrics.counter("sse_clients_evicted_total").inc(())
            except KeyError:
                pass
        self._gauge_clients()

    def _gauge_clients(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.gauge("sse_clients_connected").set(
                    (), float(self.client_count()))
            except KeyError:
                pass

    def stats(self) -> dict:
        return {
            "clients": self.client_count(),
            "shards": len(self.shards),
            "published": self.events_published,
            "dropped": self.events_dropped,
            "evicted": self.clients_evicted,
            "inboxDropped": sum(s.inbox_dropped for s in self.shards),
            "detail": self.detail,
            "detailSuppressed": self.detail_suppressed,
        }

    def close(self) -> None:
        self.detach_engine()
        for shard in self.shards:
            shard.stop()
        for shard in self.shards:
            shard.thread.join(timeout=2.0)
