"""The query front end: reads go to replicas, never to the leader.

The port of ``kueue_tpu/readplane/frontend.py``.

A tiny HTTP-level router over a fleet of read-replica endpoints. Every
read is routed to the *freshest live* replica — the one whose
/debug/readplane probe advertised the smallest staleness wall age —
and fails over to the next-freshest on connection errors, so a
replica dying (or the leader dying, which stalls every tail at the
same position) degrades read service to the freshest surviving view
instead of an outage. The leader is structurally unreachable from
here: the front end is constructed from replica endpoints only, and
``readplane_frontend_routes_total`` accounts for every routing
decision so the zero-leader-reads claim is provable from metrics on
both sides.
"""

from __future__ import annotations

import json
import time
from typing import Optional

QUERY_PATHS = {
    "position": "/read/position/{arg}",
    "quota": "/read/quota",
    "pending": "/read/pending",
    "explain": "/read/explain/{arg}",
}


def _http_get(url: str, timeout: float) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


class ReadFrontend:
    def __init__(self, replicas, metrics=None, timeout: float = 5.0,
                 probe_ttl: float = 0.25, clock=time.monotonic,
                 fetch=_http_get):
        """``replicas``: base URLs ("http://127.0.0.1:PORT") of
        read-replica endpoints. ``fetch`` is injectable for tests."""
        self.replicas = list(replicas)
        self.metrics = metrics
        self.timeout = float(timeout)
        self.probe_ttl = float(probe_ttl)
        self._clock = clock
        self._fetch = fetch
        self._probed_at = float("-inf")
        self._ranked: list = []
        self.routes = 0

    # -- liveness / freshness --

    def probe(self) -> list:
        """Probe every replica's /debug/readplane; returns the live
        ones ranked freshest-first as (wall_age, base_url) pairs. A
        replica without a read model yet (staleness None) ranks last
        but stays routable — a stale answer beats no answer."""
        ranked = []
        for base in self.replicas:
            try:
                st = self._fetch(base + "/debug/readplane",
                                 self.timeout)
            except Exception:  # noqa: BLE001 — dead replica: skip
                continue
            s = st.get("staleness") or {}
            age = s.get("wallAgeSeconds")
            ranked.append((float("inf") if age is None else float(age),
                           base))
        ranked.sort(key=lambda p: (p[0], p[1]))
        self._ranked = ranked
        self._probed_at = self._clock()
        return ranked

    def _candidates(self) -> list:
        if self._clock() - self._probed_at > self.probe_ttl:
            self.probe()
        return list(self._ranked)

    # -- routing --

    def query(self, kind: str, arg: str = None) -> dict:
        """Route one read to the freshest live replica, degrading down
        the freshness ranking on failure. Raises RuntimeError only
        when every replica is unreachable."""
        path = QUERY_PATHS[kind].format(arg=arg if arg is not None
                                        else "")
        candidates = self._candidates()
        if not candidates:
            candidates = self.probe()
        last_err: Optional[Exception] = None
        for i, (_, base) in enumerate(candidates):
            try:
                out = self._fetch(base + path, self.timeout)
            except Exception as e:  # noqa: BLE001 — degrade to next
                last_err = e
                self._count(base, "unreachable")
                continue
            self.routes += 1
            self._count(base, "primary" if i == 0 else "degraded")
            out["routedTo"] = base
            return out
        raise RuntimeError(
            f"readplane: no live replica for {kind!r} "
            f"({len(self.replicas)} configured): {last_err}")

    def _count(self, target: str, reason: str) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.counter("readplane_frontend_routes_total").inc(
                (target, reason))
        except KeyError:
            pass

    def status(self) -> dict:
        return {"replicas": list(self.replicas),
                "ranked": [{"base": b, "wallAgeSeconds":
                            None if a == float("inf") else a}
                           for a, b in self._ranked],
                "routes": self.routes}
