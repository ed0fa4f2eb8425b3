"""The port's profiler hook (``Engine.profiled``), structured logging,
SSE stream, dashboard and debug views against the JAX package's.

From ``tests/test_observability.py``: ``profiled`` writes a trace (a
``torch.profiler`` Chrome trace here, on the CPU) and is a no-op
without a directory; ``/events`` pushes an admission without polling and
sends keep-alive comments on an idle stream; the dashboard page wires
its EventSource (the page bytes equal the JAX package's). Beyond it: a
served ``/events``, ``/debug/trace``, ``/debug/perf``, ``/debug/slo``,
``/`` and ``/dashboard`` of a threaded ``ServingEndpoint`` of each
package over the same world give equal bodies once the wall-time fields
are masked (``ts``/``dur``/``seconds`` of spans, ``dur_ms=``/``slo=`` of
a ``cycle_trace`` detail, the sub-phase and SLO burn values); a POST and
the cycle loop go on while an SSE client stays connected (the stream
never takes the cycle lock, ROADMAP trap (aj)); the hub-backed stream;
and the structured logger's records equal the JAX package's."""

import http.client
import io
import json
import os
import re
import threading
import time

import pytest

from kueue_tpu.api import types as jt
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.visibility import http_server as jhttp
from kueue_tpu_torch.api import types as pt
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.obs import hooks as phooks
from kueue_tpu_torch.obs import perf as pperf
from kueue_tpu_torch.visibility import http_server as phttp
from test_torch_journal import aligned_uids
from test_torch_obs_trace import masked_tree


@pytest.fixture(autouse=True)
def _reset_obs():
    from kueue_tpu.obs import hooks as jhooks
    from kueue_tpu.obs import perf as jperf

    yield
    jperf.ACTIVE = pperf.ACTIVE = None
    jhooks.CURRENT = phooks.CURRENT = None


def _world(t, engine):
    eng = engine()
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(4000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
    return eng


def _port_world():
    return _world(pt, lambda: PEngine(device="cpu"))


def _wl(t, name, cpu=1000):
    return t.Workload(name=name, queue_name="lq",
                      pod_sets=(t.PodSet("main", 1, {"cpu": cpu}),))


def test_profiled_context_writes_trace(tmp_path):
    eng = _port_world()
    eng.submit(_wl(pt, "w", 100))
    trace_dir = str(tmp_path / "traces")
    with eng.profiled(trace_dir):
        eng.schedule_once()
    assert eng.workloads["default/w"].is_admitted
    found = [f for _, _, fs in os.walk(trace_dir) for f in fs]
    assert found, "profiler wrote no trace files"
    with open(os.path.join(trace_dir, found[0]), encoding="utf-8") as fh:
        doc = json.load(fh)
    assert doc["traceEvents"]


def test_profiled_directory_precedence(tmp_path, monkeypatch):
    """Explicit argument, then Configuration.profile_dir, then
    KUEUE_TPU_PROFILE, as in the JAX engine."""
    from kueue_tpu_torch.config.api import Configuration

    monkeypatch.setenv("KUEUE_TPU_PROFILE", str(tmp_path / "env"))
    eng = PEngine(device="cpu",
                  config=Configuration(profile_dir=str(tmp_path / "cfg")))
    with eng.profiled():
        pass
    with eng.profiled(str(tmp_path / "arg")):
        pass
    with PEngine(device="cpu").profiled():
        pass
    for d in ("cfg", "arg", "env"):
        assert os.listdir(tmp_path / d), d


def test_profiled_noop_without_dir(monkeypatch):
    monkeypatch.delenv("KUEUE_TPU_PROFILE", raising=False)
    eng = PEngine(device="cpu")
    with eng.profiled():
        pass


def test_profiled_trace_holds_the_bridge_phase_ranges(tmp_path):
    """With a tracer on, a device cycle inside ``profiled`` leaves the
    bridge's phase ranges in the Chrome trace."""
    eng = _port_world()
    eng.attach_oracle(device="cpu")
    eng.attach_tracer()
    eng.submit(_wl(pt, "w", 100))
    with eng.profiled(str(tmp_path)):
        eng.schedule_once()
    assert eng.last_cycle_mode == "device"
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name, encoding="utf-8") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    for phase in ("encode", "device", "apply", "finalize"):
        assert f"kueue_tpu_torch.oracle.{phase}" in names


def _sse_reader(port, out: list, stop_kind=None, stop_count=1,
                ready=None, comments=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/events")
    resp = conn.getresponse()
    out.append(("content-type", resp.headers.get("Content-Type")))
    if ready is not None:
        ready.set()
    event = None
    seen = 0
    while True:
        line = resp.fp.readline().decode()
        if not line:
            return
        if line.startswith(":") and comments is not None:
            comments.append(line.strip())
            if len(comments) >= 3 and stop_kind is None:
                return
        elif line.startswith("event:"):
            event = line.split(":", 1)[1].strip()
        elif line.startswith("data:"):
            out.append((event, json.loads(line.split(":", 1)[1])))
            if event == stop_kind:
                seen += 1
                if seen >= stop_count:
                    return


def test_sse_pushes_admission_without_polling():
    eng = _port_world()
    ep = phttp.ServingEndpoint(eng, port=0)
    ep.start()
    got: list = []
    ready = threading.Event()
    t = threading.Thread(target=_sse_reader, args=(ep.port, got),
                         kwargs=dict(stop_kind="Admitted", ready=ready),
                         daemon=True)
    t.start()
    assert ready.wait(10)
    time.sleep(0.1)  # listener registration races the first event
    eng.submit(_wl(pt, "w"))
    eng.schedule_once()
    t.join(timeout=20)
    ep.stop()
    assert not t.is_alive(), "no Admitted event arrived on the stream"
    assert got[0][1].startswith("text/event-stream")
    kind, body = got[-1]
    assert kind == "Admitted"
    assert body["workload"] == "default/w"
    assert body["clusterQueue"] == "cq"


def test_sse_heartbeat_comments_on_idle_stream():
    eng = _port_world()
    ep = phttp.ServingEndpoint(eng, port=0, heartbeat_seconds=0.1)
    ep.start()
    got, beats = [], []
    t = threading.Thread(target=_sse_reader, args=(ep.port, got),
                         kwargs=dict(comments=beats), daemon=True)
    t.start()
    t.join(timeout=10)
    ep.stop()
    assert not t.is_alive(), "heartbeat comments did not arrive"
    assert beats[0] == ": connected"
    assert beats[1:3] == [": keep-alive", ": keep-alive"]


def test_dashboard_page_equals_the_jax_package():
    from kueue_tpu.visibility.dashboard import DASHBOARD_HTML as J
    from kueue_tpu_torch.visibility.dashboard import DASHBOARD_HTML as P

    assert P == J
    assert "EventSource(\"/events\")" in P


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, resp.headers.get("Content-Type"), resp.read()


_WALL = re.compile(r" dur_ms=[0-9.]+| slo=\S+")


def _mask_body(path: str, body: dict) -> dict:
    if path == "/debug/trace":
        body = dict(body, cycles=[masked_tree(c) for c in body["cycles"]])
    elif path == "/debug/perf" and body.get("enabled"):
        body = dict(body, subphases={
            k: v["total"] for k, v in body["subphases"].items()})
    elif path == "/debug/slo" and body.get("enabled"):
        body = dict(body, objectives={
            k: {kk: vv for kk, vv in v.items()
                if kk not in ("burn", "status", "statusName")}
            for k, v in body["objectives"].items()})
    return body


def test_served_views_and_stream_match_the_jax_package():
    """The same world in each package, traced, perf-recorded and
    SLO-watched behind its own threaded endpoint with one SSE client:
    equal stream events and debug bodies (wall time masked), and both
    answer / and /dashboard with the page."""
    results = {}
    with aligned_uids():
        for pkg, t, make, http_mod in (
                ("jax", jt, JEngine, jhttp),
                ("port", pt, lambda: PEngine(device="cpu"), phttp)):
            eng = _world(t, make)
            eng.attach_tracer()
            eng.attach_perf()
            eng.attach_slo()
            ep = http_mod.ServingEndpoint(eng, port=0)
            ep.start()
            got: list = []
            ready = threading.Event()
            reader = threading.Thread(
                target=_sse_reader, args=(ep.port, got),
                kwargs=dict(stop_kind="cycle_trace", stop_count=3,
                            ready=ready), daemon=True)
            reader.start()
            assert ready.wait(10)
            time.sleep(0.2)
            for i in range(5):
                eng.clock += 0.5
                eng.submit(_wl(t, f"w{i}"))
            for _ in range(3):
                eng.schedule_once()
            reader.join(timeout=30)
            assert not reader.is_alive()
            views = {}
            for path in ("/debug/trace", "/debug/perf", "/debug/slo"):
                status, ctype, raw = _get(ep.port, path)
                assert status == 200, (pkg, path)
                views[path] = _mask_body(path, json.loads(raw))
            for path in ("/", "/dashboard"):
                status, ctype, raw = _get(ep.port, path)
                assert status == 200 and ctype == "text/html"
                views[path] = raw
            ep.stop()
            events = [(k, {kk: (_WALL.sub("", vv) if kk == "detail" else vv)
                           for kk, vv in b.items()})
                      for k, b in got[1:]]
            results[pkg] = (events, views)
    assert results["port"] == results["jax"]
    events = results["port"][0]
    assert [k for k, _ in events].count("cycle_trace") == 3
    assert all("cid" in b for k, b in events if k == "cycle_trace")


def test_post_and_cycles_go_on_while_a_client_streams():
    """An SSE client connected for the whole test: POSTs are answered,
    and a serve-style loop (cycles under ``lock.cycle()``) keeps
    cycling; the stream sees every admission."""
    from kueue_tpu_torch.api.serde import to_jsonable

    eng = _port_world()
    eng.attach_tracer()
    ep = phttp.ServingEndpoint(eng, port=0)
    ep.start()
    got: list = []
    ready = threading.Event()
    reader = threading.Thread(
        target=_sse_reader, args=(ep.port, got),
        kwargs=dict(stop_kind="Admitted", stop_count=3, ready=ready),
        daemon=True)
    reader.start()
    assert ready.wait(10)
    stop = threading.Event()
    cycles = [0]

    def loop():
        while not stop.is_set():
            with ep.lock.cycle():
                eng.schedule_once()
                cycles[0] += 1
            time.sleep(0.005)

    looper = threading.Thread(target=loop, daemon=True)
    looper.start()
    try:
        for i in range(3):
            body = json.dumps(to_jsonable(_wl(pt, f"p{i}"))).encode()
            conn = http.client.HTTPConnection("127.0.0.1", ep.port,
                                              timeout=10)
            t0 = time.monotonic()
            conn.request("POST", "/workloads", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 201
            assert time.monotonic() - t0 < 5.0
        reader.join(timeout=30)
        assert not reader.is_alive(), "the stream missed admissions"
    finally:
        stop.set()
        looper.join(timeout=10)
        ep.stop()
    assert cycles[0] > 3
    admitted = [b["workload"] for k, b in got[1:] if k == "Admitted"]
    assert admitted == [f"default/p{i}" for i in range(3)]


def test_hub_backed_stream():
    """``ServingEndpoint(hub=...)``: the engine's events reach the client
    through a FanoutHub attached to the engine."""
    from kueue_tpu_torch.visibility.fanout import FanoutHub

    eng = _port_world()
    hub = FanoutHub(shards=2)
    hub.attach_engine(eng)
    ep = phttp.ServingEndpoint(eng, port=0, hub=hub)
    ep.start()
    got: list = []
    ready = threading.Event()
    reader = threading.Thread(
        target=_sse_reader, args=(ep.port, got),
        kwargs=dict(stop_kind="Admitted", ready=ready), daemon=True)
    reader.start()
    assert ready.wait(10)
    time.sleep(0.2)
    eng.submit(_wl(pt, "h"))
    eng.schedule_once()
    reader.join(timeout=20)
    ep.stop()
    hub.close()
    assert not reader.is_alive()
    assert got[-1][0] == "Admitted"
    assert got[-1][1]["workload"] == "default/h"
    assert eng.fanout is None


def test_routes_leave_the_not_ported_list():
    """No route answers "not ported" any more (the federation's were the
    last): on a plain endpoint each of these routes answers as the JAX
    endpoint's does, /debug/federation and /cells with 404 ``not found``
    (they belong to a dispatcher's endpoint)."""
    import urllib.error
    import urllib.request

    from kueue_tpu_torch.controllers.engine import Engine as PE

    assert not hasattr(phttp, "_not_ported")
    ep = phttp.ServingEndpoint(PE(device="cpu"))
    ep.start()
    try:
        for path in ("", "/dashboard", "/debug/trace", "/debug/perf",
                     "/debug/slo", "/debug/ha", "/debug/flowcontrol",
                     "/debug/readplane", "/read/quota", "/debug/federation",
                     "/cells"):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{ep.port}{path}", timeout=30) as r:
                    code, body = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, body = e.code, e.read()
            assert b"not ported" not in body, path
            if path in ("/debug/federation", "/cells"):
                assert (code, json.loads(body)) == \
                    (404, {"error": "not found"}), path
    finally:
        ep.stop()


def test_structured_log_records_match():
    """``attach_engine_logging`` on the same world in both packages: the
    same JSON records (timestamps are the engine clock)."""
    from kueue_tpu.utils import structlog as jlog
    from kueue_tpu_torch.utils import structlog as plog

    out = {}
    with aligned_uids():
        for pkg, t, make, mod in (
                ("jax", jt, JEngine, jlog),
                ("port", pt, lambda: PEngine(device="cpu"), plog)):
            eng = _world(t, make)
            buf = io.StringIO()
            mod.attach_engine_logging(eng, stream=buf, level="info")
            for i in range(3):
                eng.clock += 0.5
                eng.submit(_wl(t, f"w{i}", 1500))
            for _ in range(4):
                eng.schedule_once()
            out[pkg] = buf.getvalue()
    assert out["port"] == out["jax"]
    assert out["port"].count('"msg": "Admitted"') == 2
