"""The serving endpoint: the write front door and the visibility and
debug views over stdlib HTTP.

The port of ``kueue_tpu/visibility/http_server.py``:

  * POST ``/workloads``: a serde-tagged workload body (api/serde.py);
    400 on a bad body, 200 ``deduplicated`` for a known key, 503 with a
    ``Retry-After`` while the journal's disk budget is degraded, 429
    with a ``Retry-After`` when the engine's ``shedder`` sheds, 201 when
    accepted. With an HA replica (``replica=``) the replica's ``submit``
    decides: 503 with the leader's name and a clamped ``Retry-After``
    off the leader, 200 for a retry it has seen, 201. A read replica
    (``readplane=``) refuses every write with 403;
  * GET ``/healthz``, ``/metrics`` (``sync_resource_metrics`` then the
    registry's Prometheus text), ``/debug/dump``, ``/capacity``,
    ``/cohorts``, ``/oracle``, ``/evictions``, ``/clusterqueues``,
    ``/clusterqueues/<cq>/pendingworkloads``, ``/workloads``, ``/`` and
    ``/dashboard``, ``/debug/trace``, ``/debug/perf`` and ``/debug/slo``
    (``{"enabled": false}`` without the obs layer), ``/debug/ha`` (the
    replica's status), ``/debug/flowcontrol`` (the APF dispatcher's
    counts), and on a read replica ``/read/{position,quota,pending,
    explain}`` (staleness-stamped answers) and ``/debug/readplane``;
  * GET ``/events``: the server-sent-events stream of the engine's
    events, from the engine's ``event_listeners`` or, with ``hub=``, from
    one ``visibility/fanout.FanoutHub`` client queue, with a keep-alive
    comment every ``heartbeat_seconds``;
  * API priority and fairness (``visibility/flowcontrol.py``) in front
    of every GET but ``/events``, on by default: 429 with a
    ``Retry-After`` when a flow finds no seat and no queue room;
  * ``visibility_queries_total`` per read route (``READ_PREFIXES``) on
    the serving registry: a leader behind read replicas keeps it at 0;
  * the bearer token (``auth_token``; ``/healthz`` stays open).

Federation (``/cells``, ``/debug/federation``, POST
``/federation/revoke``) and the status routes
(``/clusterqueues/<cq>/status``, ``/localqueues/<ns>/<lq>/status``)
answer 404 with a body that names them as not ported; any other route
answers 404 ``not found``. TLS is left out.

The endpoint's ``lock`` (a ``CycleLock``): every request that reads or
changes an engine holds it, and the serving loop holds it around each
scheduling cycle, so a submit or a view never runs inside a cycle. The
JAX package takes no lock there, and its serving loop can die of it:
``rows.flush`` iterates a set that a concurrent submit grows
(``RuntimeError: Set changed size during iteration``,
``kueue_tpu/tensor/rowcache.py:437``, reproduced with 200 POSTs a second
against its serve process). A submit lands between two cycles either
way, so the lock changes no decision. ``/metrics`` refreshes the
resource gauges under the lock too. A request resolves the engine once
it holds the lock: HA promotion swaps the engine, and the loop leaves
the lock free while it follows, so a request never keeps an engine
that was swapped out while it waited. The read model of a follower or
a read replica is replaced by each rebuild and never changed in place,
so ``/read/*`` queries take no lock. An APF seat is held while its
request waits for the lock (the JAX endpoint has no lock to wait for):
10 seats and 16 queues of 50 give polling clients room, and a queued
request waits up to 30 s before its 429.

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

# The JAX package's routes that the port does not serve: federation
# (ROADMAP Queue 1 item 7) and the status routes (item 8).
NOT_PORTED_GET = ("/cells", "/debug/federation")
NOT_PORTED_PREFIXES = ("/localqueues/",)
NOT_PORTED_POST = ("/federation/revoke",)

# Route classes whose GETs are read queries (engine-state reads a client
# asked for), counted in ``visibility_queries_total``. ``/metrics``,
# ``/healthz``, ``/debug/ha``, ``/debug/readplane`` and
# ``/debug/flowcontrol`` are infrastructure probes, not reads.
READ_PREFIXES = ("/read/", "/clusterqueues", "/localqueues", "/workloads",
                 "/capacity", "/cohorts", "/evictions", "/oracle",
                 "/debug/dump", "/debug/trace", "/debug/perf",
                 "/debug/slo")

READ_KINDS = ("position", "quota", "pending", "explain")


def _not_ported(path: str, method: str) -> bool:
    if method == "POST":
        return path in NOT_PORTED_POST
    if path in NOT_PORTED_GET or path.startswith(NOT_PORTED_PREFIXES):
        return True
    parts = [p for p in path.split("/") if p]
    return (len(parts) == 3 and parts[0] == "clusterqueues"
            and parts[2] == "status")


def read_route(path: str):
    """The ``visibility_queries_total`` label of a GET path, or None
    for a route that is not a read query."""
    route = next((p for p in READ_PREFIXES
                  if path == p.rstrip("/") or path.startswith(p)), None)
    return None if route is None else route.strip("/").replace("/", "_")


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


def make_handler(engine, lock: CycleLock, auth_token=None, apf=None,
                 heartbeat_seconds: float = 15.0, hub=None, replica=None,
                 readplane=None):
    # ``engine`` is the engine or a zero-argument callable returning it:
    # HA promotion swaps the engine (a follower's read model becomes a
    # leader's live engine), so a request resolves it once it holds the
    # lock, and a request that waited across the swap sees the new one.
    resolve = engine if callable(engine) else (lambda: engine)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _flow_user(self) -> str:
            """The APF flow identity: the bearer token's fingerprint (the
            ByUser distinguisher), or the anonymous group."""
            got = self.headers.get("Authorization", "")
            if got.startswith("Bearer "):
                import hashlib

                return hashlib.sha256(got.encode()).hexdigest()[:12]
            return "system:anonymous"

        def _authorized(self) -> bool:
            """Bearer-token auth; /healthz stays open for probes."""
            if auth_token is None:
                return True
            if urlparse(self.path).path.rstrip("/") == "/healthz":
                return True
            got = self.headers.get("Authorization", "")
            return hmac.compare_digest(got, f"Bearer {auth_token}")

        def _retry_after_hint(self) -> float:
            """The shedder's clamped, jittered hint when one is wired (the
            HA replica's, else the engine's), else the clamp over a 1 s
            base: APF 429s, shed 429s and failover 503s give one kind of
            backoff guidance."""
            from kueue_tpu_torch.ha.shedder import clamped_retry_after

            shedder = getattr(replica, "shedder", None)
            if shedder is None:
                eng = resolve()
                shedder = getattr(eng, "shedder", None)
            if shedder is not None:
                return shedder.retry_after_hint()
            return clamped_retry_after(1.0)

        def _send(self, body: str, content_type="application/json",
                  code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_retry(self, body: dict, code: int, retry_after) -> None:
            """``code`` with ``body`` and a ``Retry-After`` header of
            ``retry_after`` seconds (at least 1), when given."""
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            if retry_after:
                self.send_header("Retry-After",
                                 str(max(1, int(retry_after))))
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
            """POST /workloads submits a workload: through the HA
            replica's front door when there is one (503 with the leader's
            name off the leader, 429 when its shedder sheds), never on a
            read replica (403)."""
            if not self._authorized():
                self._send('{"error":"unauthorized"}', code=401)
                return
            if readplane is not None:
                # A read replica holds no writable journal: a submit
                # would change a read model the next rebuild discards.
                self._send('{"error":"read replica: writes not '
                           'accepted here"}', code=403)
                return
            path = urlparse(self.path).path.rstrip("/")
            if path != "/workloads":
                self._missing(path, "POST")
                return
            import time as _time

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
            if replica is not None:
                # (The federation's X-Route-Epoch is not read: item 7.)
                from kueue_tpu_torch.store.journal import JournalFenced
                with lock.request():
                    try:
                        verdict = replica.submit(wl, _time.time())
                    except JournalFenced as e:
                        # A standby took the lease: this replica fences
                        # and answers as a follower does.
                        replica._fence(f"journal fence tripped: {e}")
                        verdict = replica.submit(wl, _time.time())
                code = verdict.pop("code", 500)
                self._send_retry(verdict, code,
                                 verdict.get("retryAfter")
                                 if code in (429, 503) else None)
                return
            with lock.request():
                eng = resolve()
                if eng is None:
                    self._send('{"error":"no engine"}', code=503)
                    return
                if wl.key in eng.workloads:
                    self._send(json.dumps({
                        "accepted": True, "deduplicated": True,
                        "workload": wl.name}), code=200)
                    return
                journal = eng.journal
                if journal is not None and journal.degraded:
                    # The disk budget holds the journal read-only: an
                    # accepted submit could not be journaled.
                    hint = self._retry_after_hint()
                    self._send_retry({
                        "accepted": False,
                        "reason": "journal degraded: disk budget "
                                  "exhausted",
                        "retryAfter": hint}, 503, hint)
                    return
                shedder = eng.shedder
                if shedder is not None:
                    v = shedder.admit(_time.time())
                    if not v["accepted"]:
                        self._send_retry({
                            "accepted": False,
                            "reason": "shed: admission rate limit",
                            "factor": v["factor"]}, 429, v["retryAfter"])
                        return
                eng.submit(wl)
            self._send(json.dumps({"accepted": True, "workload": wl.name}),
                       code=201)

        def do_GET(self):  # noqa: N802
            # Authentication before flow classification (the apiserver
            # runs authn ahead of APF): a bad token never mints a flow.
            if not self._authorized():
                self._send('{"error":"unauthorized"}', code=401)
                return
            path = urlparse(self.path).path.rstrip("/")
            if path == "/events":
                # Long-lived: an APF seat held for its lifetime would
                # occupy a shuffle-shard slot for good.
                self._serve_events()
                return
            if apf is None:
                self._serve_get(path)
                return
            from kueue_tpu_torch.visibility.flowcontrol import RejectedError
            try:
                ticket = apf.admit(self._flow_user(),
                                   urlparse(self.path).path)
            except RejectedError as e:
                hint = self._retry_after_hint()
                self._send_retry({"error": "too many requests",
                                  "reason": str(e), "retryAfter": hint},
                                 429, hint)
                return
            try:
                self._serve_get(path)
            finally:
                apf.release(ticket)

        def _serve_get(self, path: str) -> None:
            if path == "/debug/readplane":
                self._send(json.dumps(readplane.status())
                           if readplane is not None
                           else '{"enabled": false}')
                return
            if path.startswith("/read/"):
                # The read model is replaced by each rebuild, never
                # changed in place: a query needs no lock.
                self._serve_read(path)
                return
            if readplane is not None and path == "/metrics":
                # The replica's own registry, which outlives every
                # rebuilt engine.
                readplane._gauges()
                self._send(readplane.metrics.render(),
                           content_type="text/plain")
                return
            if path in ("/healthz", "", "/dashboard"):
                # Probes and the static page wait for no cycle.
                if resolve() is None:
                    self._send('{"error":"no read model yet"}', code=503)
                elif path == "/healthz":
                    self._send('{"status":"ok"}')
                else:
                    from kueue_tpu_torch.visibility.dashboard import (
                        DASHBOARD_HTML,
                    )
                    self._send(DASHBOARD_HTML, content_type="text/html")
                return
            parts = [p for p in path.split("/") if p]
            with lock.request():
                eng = resolve()
                self._count_read(eng, path)
                if eng is None:
                    # A read replica that has not built its read model.
                    view = ({"error": "no read model yet"}, 503)
                elif path == "/debug/ha":
                    view = (replica.status() if replica is not None
                            else {"enabled": False, "sse": hub.stats()}
                            if hub is not None else {"enabled": False})
                elif path == "/debug/flowcontrol":
                    view = (apf.stats() if apf is not None
                            else {"enabled": False})
                else:
                    view = self._view(eng, path, parts)
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

        def _serve_read(self, path: str) -> None:
            """``/read/<kind>[/<arg>]`` on a read replica."""
            if readplane is None:
                with lock.request():
                    self._count_read(resolve(), path)
                self._send('{"error":"not a read replica"}', code=404)
                return
            self._count_read(None, path)
            parts = path.split("/", 3)  # ["", "read", kind, arg?]
            kind = parts[2] if len(parts) > 2 else ""
            arg = parts[3] if len(parts) > 3 else None
            if kind not in READ_KINDS:
                self._send('{"error":"unknown read kind"}', code=404)
                return
            out = readplane.query(kind, arg)
            self._send(json.dumps(out), code=503 if "error" in out else 200)

        def _count_read(self, eng, path: str) -> None:
            """``visibility_queries_total`` on the registry of whoever
            serves the read (the read replica's own, else the engine's):
            the proof, independent of the journal, of who served reads.
            A leader fronted by the read plane holds it at zero."""
            route = read_route(path)
            if route is None:
                return
            reg = (readplane.metrics if readplane is not None
                   else getattr(eng, "registry", None))
            if reg is not None:
                reg.counter("visibility_queries_total").inc((route,))

        def _view(self, eng, path: str, parts: list):
            """A GET view's value: text or JSON-able, (value, code), or
            None for a route this endpoint does not serve."""
            if path == "/metrics":
                # The resource and cohort gauges refreshed, so a scrape
                # sees current usage (the reference updates them on
                # cache reconcile).
                eng.sync_resource_metrics()
                return eng.registry.render()
            if path == "/debug/dump":
                return dump_state(eng)
            if path == "/capacity":
                return capacity_summary(eng)
            if path == "/cohorts":
                return cohort_tree(eng)
            if path == "/oracle":
                return oracle_stats(eng)
            if path == "/evictions":
                return eviction_summary(eng)
            if path == "/debug/trace":
                return trace_summary(eng)
            if path == "/debug/perf":
                return perf_summary(eng)
            if path == "/debug/slo":
                return slo_summary(eng)
            if parts == ["clusterqueues"]:
                from kueue_tpu_torch.cli.kueuectl import Kueuectl
                return Kueuectl(eng).list_cluster_queues()
            if (len(parts) == 3 and parts[0] == "clusterqueues"
                    and parts[2] == "pendingworkloads"):
                from kueue_tpu_torch.config import features
                if not features.enabled("VisibilityOnDemand"):
                    return {"error": "VisibilityOnDemand disabled"}, 403
                s = VisibilityServer(eng).pending_workloads_for_cq(
                    parts[1])
                return {"clusterQueue": s.cluster_queue,
                        "items": [vars(i) for i in s.items]}
            if parts[:1] == ["workloads"]:
                from kueue_tpu_torch.cli.kueuectl import Kueuectl
                return Kueuectl(eng).list_workloads()
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
            eng = resolve()
            if eng is None:
                return
            q: _queue.Queue = _queue.Queue(maxsize=1024)

            def listener(ev):
                try:
                    q.put_nowait(ev)
                except _queue.Full:
                    pass

            eng.event_listeners.append(listener)
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
                    eng.event_listeners.remove(listener)
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
    # restart, SSE watchers reconnecting after a failover) overflows the
    # stdlib default listen backlog of 5.
    request_queue_size = 512


class ServingEndpoint:
    """The HTTP endpoint, served from a daemon thread.

    ``engine`` is the engine or a zero-argument callable returning it
    (the HA replica's ``engine_ref``, the read replica's read model).
    ``auth_token`` requires ``Authorization: Bearer <token>`` on every
    route but /healthz; the serving loop holds ``lock`` around each
    scheduling cycle. ``flow_control`` puts API priority and fairness in
    front of every GET but /events, on by default as in the JAX package:
    True for the shipped schema and level (``flowcontrol.
    default_config``), an ``APFDispatcher`` for another, False for none.
    ``heartbeat_seconds`` is the /events keep-alive interval; ``hub``
    (a ``visibility/fanout.FanoutHub``) serves /events from its client
    queues. ``replica`` (an ``ha.HAReplica``) takes POST /workloads and
    answers /debug/ha; ``readplane`` (a ``readplane.ReadReplica``)
    answers /read/* and /debug/readplane and refuses every write."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 auth_token: str = None, heartbeat_seconds: float = 15.0,
                 hub=None, flow_control=True, replica=None,
                 readplane=None):
        from kueue_tpu_torch.visibility.flowcontrol import APFDispatcher

        self.lock = CycleLock()
        self.hub = hub
        self.replica = replica
        self.readplane = readplane
        self.apf = None
        if flow_control:
            self.apf = (flow_control
                        if isinstance(flow_control, APFDispatcher)
                        else APFDispatcher())
        self.httpd = _Server((host, port), make_handler(
            engine, self.lock, auth_token=auth_token, apf=self.apf,
            heartbeat_seconds=heartbeat_seconds, hub=hub, replica=replica,
            readplane=readplane))
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
