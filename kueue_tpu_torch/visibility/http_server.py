"""The serving endpoint: the write front door and the visibility and
debug views over stdlib HTTP.

The port of ``kueue_tpu/visibility/http_server.py``, trimmed to:

  * POST ``/workloads``: a serde-tagged workload body (api/serde.py);
    400 on a bad body, 200 ``deduplicated`` for a known key, 503 with a
    ``Retry-After`` while the journal's disk budget is degraded, 201
    when accepted;
  * POST ``/workloads`` through the engine's ``shedder`` when one is
    attached (``ha/shedder.AdmissionShedder``): 429 with a
    ``Retry-After`` when the token bucket sheds;
  * GET ``/healthz``, ``/metrics`` (``sync_resource_metrics`` then the
    registry's Prometheus text), ``/debug/dump``, ``/capacity``,
    ``/cohorts``, ``/oracle``, ``/evictions``, ``/clusterqueues``,
    ``/clusterqueues/<cq>/pendingworkloads`` and ``/workloads``;
  * GET ``/`` and ``/dashboard`` (the dashboard page), ``/debug/trace``,
    ``/debug/perf`` and ``/debug/slo`` (``visibility/server``'s
    summaries of the attached obs layer; ``{"enabled": false}`` without
    it);
  * GET ``/events``: the server-sent-events stream of the engine's
    events, from the engine's ``event_listeners`` or, with ``hub=``, from
    one ``visibility/fanout.FanoutHub`` client queue, with a keep-alive
    comment every ``heartbeat_seconds``;
  * the bearer token (``auth_token``; ``/healthz`` stays open).

The JAX package's other routes (the HA, flow-control, status, read-plane
and federation routes) answer 404 with a body that names them as not
ported; any other route answers 404 ``not found``. Also left out: API
priority and fairness, TLS, and the HA and federation front doors.

The endpoint's ``lock`` (a ``CycleLock``): every request that reads or
changes the engine holds it, and the serving loop holds it around each
scheduling cycle, so a submit or a view never runs inside a cycle. The
JAX package takes no lock there, and its serving loop can die of it:
``rows.flush`` iterates a set that a concurrent submit grows
(``RuntimeError: Set changed size during iteration``,
``kueue_tpu/tensor/rowcache.py:437``, reproduced with 200 POSTs a second
against its serve process). A submit lands between two cycles either
way, so the lock changes no decision. ``/metrics`` refreshes the
resource gauges under the lock too, so it needs no escape for a refresh
racing the loop (the JAX package serves the previous aggregates when its
refresh raises ``RuntimeError``).

``/events`` never takes the lock: the stream lives as long as its
client, and holding the lock would stop the loop for good. Its listener
runs on the scheduling thread inside the cycle and only puts into a
bounded queue (1,024 events, or the hub's client queue), so a slow
client drops events and never holds a cycle back; the handler thread
writes them out.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from kueue_tpu_torch.visibility.server import (
    VisibilityServer,
    capacity_summary,
    cohort_tree,
    dump_state,
    eviction_summary,
    oracle_stats,
    perf_summary,
    slo_summary,
    trace_summary,
)

# The JAX package's routes that the port does not serve.
NOT_PORTED_GET = ("/debug/flowcontrol", "/debug/ha", "/debug/readplane",
                  "/cells", "/debug/federation")
NOT_PORTED_PREFIXES = ("/read/", "/localqueues/")
NOT_PORTED_POST = ("/federation/revoke",)


def _not_ported(path: str, method: str) -> bool:
    if method == "POST":
        return path in NOT_PORTED_POST
    if path in NOT_PORTED_GET or path.startswith(NOT_PORTED_PREFIXES):
        return True
    parts = [p for p in path.split("/") if p]
    return (len(parts) == 3 and parts[0] == "clusterqueues"
            and parts[2] == "status")


class CycleLock:
    """The one lock of the serving loop and the request threads, handed
    to waiting requests first: a cycle starts only when no request is
    waiting, so requests are served between two cycles instead of
    queueing behind a loop that re-takes the lock at once."""

    def __init__(self):
        self._cv = threading.Condition()
        self._held = False
        self._waiting = 0

    @contextlib.contextmanager
    def request(self):
        with self._cv:
            self._waiting += 1
            while self._held:
                self._cv.wait()
            self._waiting -= 1
            self._held = True
        try:
            yield
        finally:
            self._release()

    @contextlib.contextmanager
    def cycle(self):
        with self._cv:
            while self._held or self._waiting:
                self._cv.wait()
            self._held = True
        try:
            yield
        finally:
            self._release()

    def _release(self) -> None:
        with self._cv:
            self._held = False
            self._cv.notify_all()


def make_handler(engine, lock: CycleLock, auth_token=None,
                 heartbeat_seconds: float = 15.0, hub=None):

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _authorized(self) -> bool:
            """Bearer-token auth; /healthz stays open for probes."""
            if auth_token is None:
                return True
            if urlparse(self.path).path.rstrip("/") == "/healthz":
                return True
            got = self.headers.get("Authorization", "")
            return hmac.compare_digest(got, f"Bearer {auth_token}")

        def _send(self, body: str, content_type="application/json",
                  code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _missing(self, path: str, method: str) -> None:
            if _not_ported(path, method):
                self._send(json.dumps({"error": "not ported",
                                       "route": path or "/"}), code=404)
            else:
                self._send('{"error":"not found"}', code=404)

        def do_POST(self):  # noqa: N802
            """POST /workloads submits a workload."""
            if not self._authorized():
                self._send('{"error":"unauthorized"}', code=401)
                return
            path = urlparse(self.path).path.rstrip("/")
            if path != "/workloads":
                self._missing(path, "POST")
                return
            from kueue_tpu_torch.api.serde import from_jsonable
            from kueue_tpu_torch.api.types import Workload
            try:
                length = int(self.headers.get("Content-Length", 0))
                wl = from_jsonable(json.loads(self.rfile.read(length)))
                if not isinstance(wl, Workload):
                    raise TypeError(f"not a Workload: {type(wl).__name__}")
            except Exception as e:  # noqa: BLE001 — client error
                self._send(json.dumps(
                    {"error": f"bad workload body: {e}"}), code=400)
                return
            with lock.request():
                if wl.key in engine.workloads:
                    self._send(json.dumps({
                        "accepted": True, "deduplicated": True,
                        "workload": wl.name}), code=200)
                    return
                journal = engine.journal
                if journal is not None and journal.degraded:
                    # The disk budget holds the journal read-only: an
                    # accepted submit could not be journaled.
                    self._degraded()
                    return
                shedder = engine.shedder
                if shedder is not None:
                    import time as _time

                    v = shedder.admit(_time.time())
                    if not v["accepted"]:
                        self._shed(v)
                        return
                engine.submit(wl)
            self._send(json.dumps({"accepted": True, "workload": wl.name}),
                       code=201)

        def _shed(self, verdict: dict) -> None:
            """429 with the JAX front door's body and Retry-After."""
            data = json.dumps({
                "accepted": False,
                "reason": "shed: admission rate limit",
                "factor": verdict["factor"]}).encode()
            self.send_response(429)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After",
                             str(max(1, int(verdict["retryAfter"]))))
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _degraded(self) -> None:
            """503 with the JAX front door's body and Retry-After: the
            shedder's hint when one is attached, else the clamp over a
            1 s base."""
            from kueue_tpu_torch.ha.shedder import clamped_retry_after

            shedder = engine.shedder
            hint = (shedder.retry_after_hint() if shedder is not None
                    else clamped_retry_after(1.0))
            data = json.dumps({
                "accepted": False,
                "reason": "journal degraded: disk budget exhausted",
                "retryAfter": hint}).encode()
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After", str(max(1, int(hint))))
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if not self._authorized():
                self._send('{"error":"unauthorized"}', code=401)
                return
            path = urlparse(self.path).path.rstrip("/")
            if path == "/healthz":
                self._send('{"status":"ok"}')
                return
            if path == "/events":
                self._serve_events()
                return
            if path in ("", "/dashboard"):
                from kueue_tpu_torch.visibility.dashboard import (
                    DASHBOARD_HTML,
                )
                self._send(DASHBOARD_HTML, content_type="text/html")
                return
            parts = [p for p in path.split("/") if p]
            with lock.request():
                view = self._view(path, parts)
            # Serialized outside the lock: a view holds only fresh
            # containers and immutable values, and the loop need not
            # wait for the JSON of a large dump.
            if view is None:
                self._missing(path, "GET")
            elif path == "/metrics":
                self._send(view, content_type="text/plain")
            elif path == "/debug/dump":
                self._send(json.dumps(view, indent=2))
            elif isinstance(view, tuple):
                self._send(json.dumps(view[0]), code=view[1])
            else:
                self._send(json.dumps(view))

        def _view(self, path: str, parts: list):
            """A GET view's JSON-able value, (value, code), or None for a
            route this endpoint does not serve."""
            if path == "/metrics":
                # The resource and cohort gauges refreshed, so a scrape
                # sees current usage (the reference updates them on
                # cache reconcile).
                engine.sync_resource_metrics()
                return engine.registry.render()
            if path == "/debug/dump":
                return dump_state(engine)
            if path == "/capacity":
                return capacity_summary(engine)
            if path == "/cohorts":
                return cohort_tree(engine)
            if path == "/oracle":
                return oracle_stats(engine)
            if path == "/evictions":
                return eviction_summary(engine)
            if path == "/debug/trace":
                return trace_summary(engine)
            if path == "/debug/perf":
                return perf_summary(engine)
            if path == "/debug/slo":
                return slo_summary(engine)
            if parts == ["clusterqueues"]:
                from kueue_tpu_torch.cli.kueuectl import Kueuectl
                return Kueuectl(engine).list_cluster_queues()
            if (len(parts) == 3 and parts[0] == "clusterqueues"
                    and parts[2] == "pendingworkloads"):
                from kueue_tpu_torch.config import features
                if not features.enabled("VisibilityOnDemand"):
                    return {"error": "VisibilityOnDemand disabled"}, 403
                s = VisibilityServer(engine).pending_workloads_for_cq(
                    parts[1])
                return {"clusterQueue": s.cluster_queue,
                        "items": [vars(i) for i in s.items]}
            if parts[:1] == ["workloads"]:
                from kueue_tpu_torch.cli.kueuectl import Kueuectl
                return Kueuectl(engine).list_workloads()
            return None

        def _serve_events(self):
            """Server-sent events of the engine's EngineEvents (the
            KueueViz backend's watch stream): ``: connected``, then one
            ``event: <kind>`` / ``data: <json>`` frame per event, and a
            ``: keep-alive`` comment after ``heartbeat_seconds`` without
            one. Never under the cycle lock (module docstring)."""
            import queue as _queue

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "keep-alive")
            self.end_headers()
            if hub is not None:
                self._serve_events_hub()
                return
            q: _queue.Queue = _queue.Queue(maxsize=1024)

            def listener(ev):
                try:
                    q.put_nowait(ev)
                except _queue.Full:
                    pass

            engine.event_listeners.append(listener)
            try:
                self.wfile.write(b": connected\n\n")
                self.wfile.flush()
                while True:
                    try:
                        ev = q.get(timeout=heartbeat_seconds)
                    except _queue.Empty:
                        self.wfile.write(b": keep-alive\n\n")
                        self.wfile.flush()
                        continue
                    body = {
                        "time": ev.time, "kind": ev.kind,
                        "workload": ev.workload,
                        "clusterQueue": ev.cluster_queue,
                        "detail": ev.detail}
                    if ev.detail.startswith("cid="):
                        # cycle_trace summaries lead with the
                        # correlation id: surfaced structured, as the
                        # join key against journal records and
                        # /debug/trace rows.
                        body["cid"] = ev.detail[4:].split(" ", 1)[0]
                    self.wfile.write(
                        f"event: {ev.kind}\ndata: {json.dumps(body)}\n\n"
                        .encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # client went away
            finally:
                try:
                    engine.event_listeners.remove(listener)
                except ValueError:
                    pass

        def _serve_events_hub(self):
            """Hub-backed SSE: this thread drains one bounded
            FanoutClient queue; an EVICTED sentinel (the client fell too
            far behind) closes the stream."""
            import queue as _queue

            from kueue_tpu_torch.visibility.fanout import EVICTED

            client = hub.subscribe()
            try:
                self.wfile.write(b": connected\n\n")
                self.wfile.flush()
                while True:
                    try:
                        item = client.get(timeout=heartbeat_seconds)
                    except _queue.Empty:
                        if client.evicted:
                            break
                        self.wfile.write(b": keep-alive\n\n")
                        self.wfile.flush()
                        continue
                    if item is EVICTED:
                        self.wfile.write(
                            b"event: evicted\n"
                            b"data: {\"reason\":\"slow consumer\"}\n\n")
                        self.wfile.flush()
                        break
                    kind, data = item
                    self.wfile.write(
                        f"event: {kind}\ndata: {data}\n\n".encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # client went away
            finally:
                hub.unsubscribe(client)

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # A burst of clients (job controllers re-creating workloads after a
    # restart) overflows the stdlib default listen backlog of 5.
    request_queue_size = 512


class ServingEndpoint:
    """The HTTP endpoint over one engine, served from a daemon thread.
    ``auth_token`` requires ``Authorization: Bearer <token>`` on every
    route but /healthz; the serving loop holds ``lock`` (see the module
    docstring) around each cycle. ``heartbeat_seconds`` is the /events
    keep-alive interval; ``hub`` (a ``visibility/fanout.FanoutHub``
    attached to the engine) serves /events from its client queues."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 auth_token: str = None, heartbeat_seconds: float = 15.0,
                 hub=None):
        self.lock = CycleLock()
        self.hub = hub
        self.httpd = _Server((host, port), make_handler(
            engine, self.lock, auth_token=auth_token,
            heartbeat_seconds=heartbeat_seconds, hub=hub))
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
