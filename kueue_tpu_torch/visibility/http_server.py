"""The serving endpoint: the write front door and the visibility and
debug views over stdlib HTTP.

The port of ``kueue_tpu/visibility/http_server.py``, trimmed to:

  * POST ``/workloads``: a serde-tagged workload body (api/serde.py);
    400 on a bad body, 200 ``deduplicated`` for a known key, 201 when
    accepted;
  * GET ``/healthz``, ``/metrics`` (``sync_resource_metrics`` then the
    registry's Prometheus text), ``/debug/dump``, ``/capacity``,
    ``/cohorts``, ``/oracle``, ``/evictions``, ``/clusterqueues``,
    ``/clusterqueues/<cq>/pendingworkloads`` and ``/workloads``;
  * the bearer token (``auth_token``; ``/healthz`` stays open).

The JAX package's other routes (the ``/events`` stream, the dashboard,
the trace, perf, SLO, HA, flow-control,
status, read-plane and federation routes) answer 404 with a body that
names them as not ported; any other route answers 404 ``not found``.
Also left out: API priority and fairness, TLS, HA and federation
front doors, and the shedder.

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
)

# The JAX package's routes that the port does not serve.
NOT_PORTED_GET = ("", "/dashboard", "/events",
                  "/debug/flowcontrol", "/debug/trace", "/debug/perf",
                  "/debug/slo", "/debug/ha", "/debug/readplane",
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


def make_handler(engine, lock: CycleLock, auth_token=None):

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
                engine.submit(wl)
            self._send(json.dumps({"accepted": True, "workload": wl.name}),
                       code=201)

        def do_GET(self):  # noqa: N802
            if not self._authorized():
                self._send('{"error":"unauthorized"}', code=401)
                return
            path = urlparse(self.path).path.rstrip("/")
            if path == "/healthz":
                self._send('{"status":"ok"}')
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
    docstring) around each cycle."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 auth_token: str = None):
        self.lock = CycleLock()
        self.httpd = _Server((host, port), make_handler(
            engine, self.lock, auth_token=auth_token))
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
