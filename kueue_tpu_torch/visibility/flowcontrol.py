"""API Priority and Fairness for the visibility surface.

The port of ``kueue_tpu/visibility/flowcontrol.py``, unchanged: the
shuffle-shard hand comes from sha256 of the flow name, so it does not
depend on the process's hash seed.

Reference: config/components/visibility-apf/ ships a FlowSchema
(distinguisher ByUser, matchingPrecedence 9000, matching every verb on
the visibility API group for authenticated AND unauthenticated users)
bound to a PriorityLevelConfiguration (type Limited,
nominalConcurrencyShares 10, limitResponse Queue with queues=16,
handSize=4, queueLengthLimit=50). In the reference those objects
configure the kube-apiserver's APF machinery in front of the aggregated
visibility server; the standalone endpoint has no apiserver, so this
module implements the dispatch algorithm itself:

  * classify: first matching FlowSchema by ascending precedence; the
    flow distinguisher (user or namespace) names the flow;
  * seats: a level executes up to its concurrency limit directly;
  * queuing: over the limit, the request shuffle-shards into
    ``hand_size`` of ``queues`` candidate queues by flow hash and joins
    the shortest; a full queue (queue_length_limit) or an Exempt-less
    schema miss rejects with 429, the apiserver's overload answer;
  * release: finishing a request drains the longest-waiting queue FIFO.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_QUEUES = 16
DEFAULT_HAND_SIZE = 4
DEFAULT_QUEUE_LENGTH_LIMIT = 50


@dataclass
class FlowSchema:
    """flowcontrol.apiserver.k8s.io/v1 FlowSchema, reduced to the
    matching surface the visibility endpoint needs."""

    name: str
    priority_level: str
    matching_precedence: int = 9000
    distinguisher: str = "ByUser"  # ByUser | ByNamespace | ""
    # Path prefixes this schema covers; empty = every path.
    path_prefixes: tuple[str, ...] = ()
    # None = any subject (the shipped schema lists both authenticated
    # and unauthenticated groups, i.e. everyone).
    users: Optional[frozenset] = None

    def matches(self, user: str, path: str) -> bool:
        if self.users is not None and user not in self.users:
            return False
        if self.path_prefixes and not any(
                path.startswith(p) for p in self.path_prefixes):
            return False
        return True

    def flow_of(self, user: str, namespace: str) -> str:
        if self.distinguisher == "ByUser":
            return f"{self.name}/{user}"
        if self.distinguisher == "ByNamespace":
            return f"{self.name}/{namespace}"
        return self.name


@dataclass
class PriorityLevelConfiguration:
    """Limited priority level with queuing (the shipped `visibility`
    level), or exempt=True for never-queued traffic (/healthz)."""

    name: str
    nominal_concurrency: int = 10
    queues: int = DEFAULT_QUEUES
    hand_size: int = DEFAULT_HAND_SIZE
    queue_length_limit: int = DEFAULT_QUEUE_LENGTH_LIMIT
    exempt: bool = False


def default_config() -> tuple[list[FlowSchema],
                              dict[str, PriorityLevelConfiguration]]:
    """The visibility-apf component: one schema for everyone ByUser into
    one Limited level, plus an exempt level for health probes."""
    schemas = [
        FlowSchema(name="probes", priority_level="exempt",
                   matching_precedence=1000,
                   distinguisher="",
                   path_prefixes=("/healthz",)),
        FlowSchema(name="visibility", priority_level="visibility",
                   matching_precedence=9000, distinguisher="ByUser"),
    ]
    levels = {
        "exempt": PriorityLevelConfiguration(name="exempt", exempt=True),
        "visibility": PriorityLevelConfiguration(name="visibility"),
    }
    return schemas, levels


class RejectedError(Exception):
    """Request sheds: no seat, no queue room (HTTP 429)."""


class _Level:
    def __init__(self, plc: PriorityLevelConfiguration):
        self.plc = plc
        self.executing = 0
        self.queues: list[deque] = [deque()
                                    for _ in range(max(1, plc.queues))]
        self._arrivals = 0  # monotonic enqueue stamp for FIFO drain

    def queued(self) -> int:
        return sum(len(q) for q in self.queues)

    def oldest_head(self):
        heads = [q[0][0] for q in self.queues if q]
        return min(heads) if heads else None


class APFDispatcher:
    """Classify + admit/queue/reject. Usage::

        ticket = apf.admit(user, path)       # may raise RejectedError
        try: ...serve...
        finally: apf.release(ticket)

    ``admit`` blocks while queued (bounded by ``timeout``); the wait is
    the queued request's seat wait, matching the apiserver's behavior of
    holding the request rather than failing fast while a queue slot is
    available."""

    def __init__(self, schemas=None, levels=None):
        if schemas is None or levels is None:
            schemas, levels = default_config()
        self.schemas = sorted(schemas,
                              key=lambda s: (s.matching_precedence, s.name))
        self.levels = {name: _Level(plc) for name, plc in levels.items()}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.rejected_total = 0
        self.queued_total = 0

    def classify(self, user: str, path: str,
                 namespace: str = "") -> Optional[tuple[FlowSchema, str]]:
        for schema in self.schemas:
            if schema.matches(user, path):
                return schema, schema.flow_of(user, namespace)
        return None

    def _shuffle_shard(self, level: _Level, flow: str) -> list[int]:
        """Deterministic hand of hand_size candidate queues from the
        flow hash (the APF shuffle-sharding dealer)."""
        n = len(level.queues)
        hand = []
        digest = hashlib.sha256(flow.encode()).digest()
        value = int.from_bytes(digest[:16], "big")
        for _ in range(min(level.plc.hand_size, n)):
            idx = value % n
            value //= n
            while idx in hand:
                idx = (idx + 1) % n
            hand.append(idx)
        return hand

    def admit(self, user: str, path: str, namespace: str = "",
              timeout: float = 30.0) -> tuple:
        match = self.classify(user, path, namespace)
        if match is None:
            with self._lock:
                self.rejected_total += 1
            raise RejectedError("no matching FlowSchema")
        schema, flow = match
        level = self.levels[schema.priority_level]
        if level.plc.exempt:
            return (level, None)
        with self._cond:
            # A free seat goes to a NEW request only when nobody is
            # already queued at this level — otherwise arrivals under
            # sustained load would leapfrog queued waiters until they
            # time out (queued requests drain first, FIFO).
            if level.executing < level.plc.nominal_concurrency \
                    and level.queued() == 0:
                level.executing += 1
                return (level, None)
            hand = self._shuffle_shard(level, flow)
            queue = min((level.queues[i] for i in hand), key=len)
            if len(queue) >= level.plc.queue_length_limit:
                self.rejected_total += 1
                raise RejectedError(
                    f"queue full at priority level {level.plc.name}")
            level._arrivals += 1
            me = (level._arrivals, object())
            queue.append(me)
            self.queued_total += 1
            deadline = time.monotonic() + timeout
            while True:
                # A free seat goes to the OLDEST queued request across
                # the level's queues (release() wakes all waiters; the
                # arrival stamp arbitrates), so no queue's head can
                # leapfrog a longer-waiting head in another queue.
                if queue and queue[0] is me \
                        and level.executing < level.plc.nominal_concurrency \
                        and level.oldest_head() == me[0]:
                    queue.popleft()
                    level.executing += 1
                    self._cond.notify_all()
                    return (level, None)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    try:
                        queue.remove(me)
                    except ValueError:
                        pass
                    self.rejected_total += 1
                    self._cond.notify_all()
                    raise RejectedError("timed out waiting for a seat")
                self._cond.wait(remaining)

    def release(self, ticket: tuple) -> None:
        level, _ = ticket
        if level.plc.exempt:
            return
        with self._cond:
            level.executing = max(0, level.executing - 1)
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return {
                "rejected_total": self.rejected_total,
                "queued_total": self.queued_total,
                "levels": {
                    name: {"executing": lv.executing,
                           "queued": lv.queued(),
                           "exempt": lv.plc.exempt}
                    for name, lv in self.levels.items()},
            }
