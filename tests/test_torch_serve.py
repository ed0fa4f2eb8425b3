"""The port's deployable process (python -m kueue_tpu_torch.serve) on
the CPU, against the JAX package: booted from a journal of
serve_world's small world plus workloads held back by a far requeue
time (so pending positions stay to compare), it answers /healthz, takes
the arrivals over POST /workloads (201, then 200 deduplicated for a
known key, 400 for a bad body) and drains them, and every view it
serves (/debug/dump but its wall-clock phases, /capacity, /cohorts,
/clusterqueues, the pending positions, /workloads, /evictions and the
ClusterQueue and LocalQueue status routes) equals the JAX package's view of a mirrored engine: the JAX engine
rebuilt from the same journal, given the same arrivals and drained
in-process, both on the default serving loop. /metrics answers 200 with
the JAX engine's admission, eviction and resource series. The
federation's routes answer 404 on a plain serve as the JAX endpoint's
do (POST /federation/revoke ``not federated``) and are served by a
dispatcher's endpoint; ``--federate`` and ``KUEUE_TPU_FEDERATE`` parse
as the JAX serve's, and a ``--federate`` process starts and serves
without CUDA. The bearer token guards every route but /healthz, and
SIGTERM exits 0. Tracing and
overload: with ``--trace 8 --watchdog-deadline 30 --watchdog-hang 120``
the process ends in the JAX serve process's final state with the same
flags, its traced cycles equal its journal's ``cycle_trace`` records, and
its debug views carry the tracer, the ladder and the watchdog;
``--shed-rate`` answers 429 past the rate. Bounded-time
recovery: each of the five recovery flags (and its environment
variable) reaches the journal or the Checkpointer, the process with all
five serves the JAX serve process's final state, a SIGKILL after
retention deleted segment 0 restarts through a checkpoint, and a
degraded journal answers POST with the JAX front door's 503. The slow
tests recompute chip_smoke.py's phase 19 and 21 constants from the JAX
package. Exact throughout."""

import http.client
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

import chip_smoke
from kueue_tpu.api import serde as jserde
from kueue_tpu.cli import kueuectl as jkueuectl
from kueue_tpu.controllers import status as jstatus
from kueue_tpu.store import journal as jjournal
from kueue_tpu.visibility import server as jvis
from kueue_tpu_torch import serve
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.store import journal as pjournal
from kueue_tpu_torch.visibility import http_server

HELD = [("cq-0", "lq-0", 5), ("cq-0", "lq-0-b", 50), ("cq-0", "lq-0", 50),
        ("cq-0", "lq-0-b", 0), ("cq-1", "lq-1", 100), ("cq-1", "lq-1", 0)]


def _seed(path) -> int:
    """serve_world.SMALL's journal, a second LocalQueue on cq-0 and the
    HELD workloads, requeued far in the future. Returns its records."""
    seeded = sw.seed_journal(path, sw.SMALL)
    j = pjournal.Journal(str(path))
    j.apply("local_queue", ptypes.LocalQueue("lq-0-b", "default", "cq-0"))
    for i, (_cq, lq, pri) in enumerate(HELD):
        wl = ptypes.Workload(
            name=f"held-{i}", queue_name=lq, priority=pri,
            uid=f"held-uid-{i}", creation_time=500.0 + i,
            pod_sets=(ptypes.PodSet("main", 1, {"cpu": 1000}),))
        wl.status.requeue_at = 1e12
        j.apply("workload", wl, ts=0.1)
    j.close()
    return seeded["records"] + 1 + len(HELD)


VIEWS = ["/debug/dump", "/capacity", "/cohorts", "/clusterqueues",
         "/clusterqueues/cq-0/pendingworkloads",
         "/clusterqueues/cq-1/pendingworkloads",
         "/clusterqueues/arrivals/pendingworkloads", "/workloads",
         "/evictions", "/clusterqueues/cq-0/status",
         "/localqueues/default/lq-0/status",
         "/localqueues/default/lq-0-b/status"]
# The /metrics families whose series do not depend on how many loop
# iterations (idle ones included) ran before the scrape: admission,
# eviction and finish counts, and the gauges sync_resource_metrics
# refreshes from the final state.
METRIC_FAMILIES = (
    "admitted_workloads_total", "quota_reserved_workloads_total",
    "evicted_workloads_total", "finished_workloads_total",
    "local_queue_admitted_workloads_total", "cluster_queue_info",
    "cluster_queue_resource_usage", "cluster_queue_resource_reservation",
    "cluster_queue_resource_pending", "cluster_queue_nominal_quota",
    "reserving_active_workloads", "local_queue_pending_workloads",
    "local_queue_resource_usage", "cohort_subtree_quota",
    "cohort_subtree_resource_reservations",
    "cohort_subtree_admitted_active_workloads", "oracle_breaker_state")


def _jax_views(eng) -> dict:
    vis = jvis.VisibilityServer(eng)

    def pending(cq):
        s = vis.pending_workloads_for_cq(cq)
        return {"clusterQueue": s.cluster_queue,
                "items": [vars(i) for i in s.items]}

    eng.sync_resource_metrics()
    out = {"/debug/dump": jvis.dump_state(eng),
           "/evictions": jvis.eviction_summary(eng),
           "/metrics": eng.registry.render(),
           "/capacity": jvis.capacity_summary(eng),
           "/cohorts": jvis.cohort_tree(eng),
           "/clusterqueues": jkueuectl.Kueuectl(eng).list_cluster_queues(),
           "/workloads": jkueuectl.Kueuectl(eng).list_workloads()}
    for cq in ("cq-0", "cq-1", "arrivals"):
        out[f"/clusterqueues/{cq}/pendingworkloads"] = pending(cq)
    sc = jstatus.StatusController(eng, attach=False)
    out["/clusterqueues/cq-0/status"] = vars(sc.cq_status("cq-0"))
    for lq in ("lq-0", "lq-0-b"):
        out[f"/localqueues/default/{lq}/status"] = vars(
            sc.lq_status(f"default/{lq}"))
    return json.loads(json.dumps(out))


def _comparable(path, view):
    if path == "/debug/dump":
        return {k: v for k, v in view.items() if k != "lastCyclePhases"}
    return view


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    path = d / "journal.jsonl"
    records = _seed(path)
    shutil.copy(path, d / "jax.jsonl")
    proc, url, boot = sw.start_serve(path, "local", "cpu", timeout=300)
    boot["seeded"] = records
    try:
        yield proc, url, boot, d
    finally:
        if proc.p.poll() is None:
            proc.stop(signal.SIGKILL)


@pytest.fixture(scope="module")
def drained(served):
    """The arrivals POSTed and drained; the served views and the JAX
    package's views of its mirrored engine."""
    proc, url, _boot, d = served
    bodies = sw.arrival_bodies(sw.SMALL)
    posted = sw.post_arrivals(url, bodies, rate=400.0)
    again = [sw.post(url, "/workloads", b) for b in bodies[:3]]
    idle = sw.wait_idle(url, 300, dump_every=0.3, settle=0.5,
                        held=len(HELD))
    got = {p: sw.get_json(url, p) for p in VIEWS}
    got["/metrics"] = sw.get_text(url, "/metrics")[0]

    eng = jjournal.rebuild_engine(str(d / "jax.jsonl"))
    eng.attach_oracle()
    for b in bodies:
        eng.submit(jserde.from_jsonable(json.loads(b)))
    sw.drain_in_process(eng)
    want = _jax_views(eng)
    return posted, again, idle, got, want


def test_boot_and_healthz(served):
    proc, url, boot, d = served
    assert boot["records"] == boot["seeded"]
    assert boot["bytes"] == os.path.getsize(d / "jax.jsonl")
    assert boot["rebuild_s"] > 0
    assert sw.get_json(url, "/healthz") == {"status": "ok"}


def test_post_codes(drained, served):
    posted, again, _idle, _got, _want = drained
    assert posted["codes"] == [201] * sw.SMALL["arrivals"]
    assert [c for c, _ in again] == [200] * 3
    assert all(b["deduplicated"] for _, b in again)
    url = served[1]
    for body in (b"{not json", b'{"__t__": "Cohort", "name": "x"}',
                 b'{"__t__": "NoSuchType"}'):
        code, resp = sw.post(url, "/workloads", body)
        assert code == 400 and "bad workload body" in resp["error"]


@pytest.mark.parametrize("path", VIEWS)
def test_views_equal_jax(drained, path):
    _posted, _again, _idle, got, want = drained
    assert _comparable(path, got[path]) == _comparable(path, want[path])


def test_metrics_series_equal_jax(drained):
    """/metrics: every family the JAX package registers, and its
    admission, eviction and resource series; the bridge's counters agree
    with the process's own /oracle view."""
    _posted, _again, idle, got, want = drained
    text = got["/metrics"]
    families = [ln.split()[2] for ln in text.split("\n")
                if ln.startswith("# TYPE ")]
    assert families == [ln.split()[2] for ln in want["/metrics"].split("\n")
                        if ln.startswith("# TYPE ")]
    for fam in METRIC_FAMILIES:
        assert sw.metric_lines(text, fam) == \
            sw.metric_lines(want["/metrics"], fam), fam
    assert sw.metric_values(text, "admitted_workloads_total")
    cycles = sw.metric_values(text, "oracle_cycles_total")
    assert cycles[("device",)] == idle["oracle"]["cyclesOnDevice"]
    fallback = sw.metric_values(text, "oracle_fallback_total")
    assert set(k[0] for k in fallback) <= {"all-host", "idle-inadmissible"}


def test_drain_admits_every_arrival(drained):
    _posted, _again, idle, got, want = drained
    st = sw.final_state(got["/workloads"], got["/debug/dump"])
    assert st == sw.final_state(want["/workloads"], want["/debug/dump"])
    assert st["arrivals_admitted"] == sw.SMALL["arrivals"]
    assert idle["oracle"]["cyclesOnDevice"] >= sw.SMALL["arrivals"]
    # Once drained, the held workloads leave every loop iteration a
    # host cycle with no head ("all-host"); nothing else falls back.
    assert set(idle["oracle"]["fallbackReasons"]) <= {"all-host",
                                                      "idle-inadmissible"}
    assert len(got["/clusterqueues/cq-0/pendingworkloads"]["items"]) == 4
    assert idle["phase_samples"]


def _fake_dispatcher(tmp_path):
    """A FederationDispatcher over two in-process cells (the fake
    transport of tests/test_federation.py, on the port's error), one
    workload routed."""
    import test_federation

    from kueue_tpu_torch.federation import (
        CellHandle,
        CellTransportError,
        FederationDispatcher,
    )
    from kueue_tpu_torch.metrics.registry import MetricsRegistry

    class Fake(test_federation.FakeCellTransport):
        def _gate(self):
            if not self.reachable:
                raise CellTransportError(f"{self.name} unreachable")

    reg = MetricsRegistry()
    disp = FederationDispatcher(
        str(tmp_path / "routes.jsonl"),
        [CellHandle(n, Fake(n), probe_interval_ticks=1) for n in "ab"],
        metrics=reg)
    disp.tick(0.0)
    disp.submit(ptypes.Workload(name="w0", queue_name="lq", pod_sets=(
        ptypes.PodSet("main", 1, {"cpu": 1}),)), now=0.0)
    disp.tick(0.0)
    return disp


@pytest.mark.parametrize("path", ["/cells", "/debug/federation"])
def test_unported_route_404(served, path, tmp_path):
    """A plain serve has no dispatcher: 404 ``not found``, as the JAX
    endpoint answers; a dispatcher's endpoint (no engine) serves its
    ``status()`` there, ``/healthz`` and its own ``/metrics``, and 404
    on an engine view."""
    c = sw._conn(served[1], 30)
    c.request("GET", path)
    r = c.getresponse()
    assert (r.status, json.loads(r.read())) == (404, {"error": "not found"})
    disp = _fake_dispatcher(tmp_path)
    ep = http_server.ServingEndpoint(None, federation=disp)
    ep.start()
    try:
        url = f"http://127.0.0.1:{ep.port}"
        got = sw.get_json(url, path)
        assert got == json.loads(json.dumps(disp.status()))
        assert got["routes"] == {"admitted": 1}
        assert sw.get_json(url, "/healthz") == {"status": "ok"}
        text, _s, _b = sw.get_text(url, "/metrics")
        assert sw.metric_values(text, "federation_routes")[("admitted",)] \
            == 1.0
        with pytest.raises(RuntimeError, match="404"):
            sw.get_json(url, "/clusterqueues")
    finally:
        ep.stop()
        disp.close()


# The HA, flow-control and read-plane routes of a plain serve process,
# as the JAX endpoint answers them without a replica or a read replica.
PORTED_ROUTES = {
    "/debug/ha": (200, {"enabled": False}),
    "/debug/readplane": (200, {"enabled": False}),
    "/read/pending/cq-0": (404, {"error": "not a read replica"}),
}


@pytest.mark.parametrize("path", sorted(PORTED_ROUTES) + [
    "/debug/flowcontrol"])
def test_ported_route_answers_as_jax(served, path):
    c = sw._conn(served[1], 30)
    c.request("GET", path)
    r = c.getresponse()
    body = json.loads(r.read())
    if path == "/debug/flowcontrol":
        # APF is on by default: this request holds one seat.
        assert r.status == 200
        assert body["levels"]["visibility"]["executing"] >= 1
        assert set(body) == {"rejected_total", "queued_total", "levels"}
    else:
        assert (r.status, body) == PORTED_ROUTES[path]


def test_wait_line_reads_the_last_line_before_exit(monkeypatch):
    """A child that prints its awaited line as its last act and exits,
    seen exited before the reader threads have read its pipes (they
    start late here, as on a loaded host): ``wait_line`` reads the pipes
    to their end before it decides, and ``stop`` returns that line as
    the last JSON one."""
    read = sw.Proc._read

    def late_read(self, stream, sink):
        time.sleep(0.5)
        read(self, stream, sink)

    monkeypatch.setattr(sw.Proc, "_read", late_read)
    proc = sw.Proc(["-c", "print('{\"done\": 1}')"])
    try:
        proc.p.wait(30)
        assert proc.wait_line('"done"', 30) == '{"done": 1}'
    finally:
        rc, last = proc.stop()
    assert rc == 0 and last == {"done": 1}


def test_start_helper_timeout_leaves_no_child(tmp_path):
    """A start helper whose wait times out kills its own child: an HA
    replica never prints the plain serve's ``rebuilt `` line."""
    before = {p for p, _ in sw.survivors()}
    registered = set(sw._LIVE)
    with pytest.raises(TimeoutError):
        sw.start_serve(tmp_path / "j.jsonl", "off", "cpu", timeout=0.5,
                       extra=("--ha",))
    assert {p for p, _ in sw.survivors()} == before
    assert set(sw._LIVE) == registered


def test_unknown_route_404(served):
    code, body = sw.post(served[1], "/federation/revoke", b"{}")
    assert (code, body) == (404, {"error": "not federated"})
    c = sw._conn(served[1], 30)
    c.request("GET", "/no/such/route")
    r = c.getresponse()
    assert r.status == 404 and json.loads(r.read()) == {"error": "not found"}


def test_sigterm_exits_0(served, drained):
    proc = served[0]
    rc, last = proc.stop(signal.SIGTERM)
    assert rc == 0
    assert last["cycles_on_device"] >= sw.SMALL["arrivals"]
    assert last["heads_launches"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("argv", [["--federate", "a=http://x"]])
def test_unported_flag_exits_2(argv, monkeypatch):
    """``--federate`` and ``KUEUE_TPU_FEDERATE`` parse as the JAX serve's
    (the flag over the variable), and the cell specs split into the JAX
    ``_main_federation``'s names, zones and URLs; a spec without a URL,
    or none, ends the process with a message."""
    from kueue_tpu_torch.metrics.registry import MetricsRegistry

    assert serve._parse(["--journal", "j", *argv]).federate == argv[1]
    monkeypatch.setenv("KUEUE_TPU_FEDERATE", "b@z2=http://y")
    assert serve._parse(["--journal", "j"]).federate == "b@z2=http://y"
    assert serve._parse(["--journal", "j", *argv]).federate == argv[1]
    monkeypatch.delenv("KUEUE_TPU_FEDERATE")
    assert serve._parse(["--journal", "j"]).federate is None
    cells = serve.federation_cells(
        " a@z1 = http://x/ , b=http://y:8080,", MetricsRegistry())
    assert [(c.name, c.zone, c.transport.base_url) for c in cells] == \
        [("a", "z1", "http://x"), ("b", "", "http://y:8080")]
    for bad in ("a", "a=", ","):
        with pytest.raises(SystemExit, match="--federate"):
            serve.federation_cells(bad, MetricsRegistry())


# The HA and read-replica flags, as the JAX serve parses them: (argv,
# environment, the parsed attribute, its value).
PORTED_FLAGS = [
    (["--ha"], {}, "ha", True),
    ([], {"KUEUE_TPU_HA": "1"}, "ha", True),
    (["--read-replica"], {}, "read_replica", True),
    (["--replica-id", "r1"], {}, "replica_id", "r1"),
    (["--lease", "l.json"], {}, "lease", "l.json"),
    (["--lease-duration", "3"], {}, "lease_duration", 3.0),
    ([], {}, "lease_duration", 5.0),
    (["--fanout-shards", "2"], {}, "fanout_shards", 2),
    ([], {"KUEUE_TPU_FANOUT_SHARDS": "8"}, "fanout_shards", 8),
]


@pytest.mark.parametrize("argv,env,attr,value", PORTED_FLAGS)
def test_ha_flag_parses_as_jax(argv, env, attr, value, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = serve._parse(["--journal", "unused.jsonl", *argv])
    assert getattr(args, attr) == value


def test_ha_without_cuda_raises(tmp_path):
    """``--ha`` and ``--read-replica`` default to CUDA and raise without
    it, as every entry point does."""
    for flag in ("--ha", "--read-replica"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--journal", str(tmp_path / "j.jsonl"), flag,
                        "--http", "127.0.0.1:0"])


def test_unported_flag_exits_2_as_a_process(tmp_path):
    """``KUEUE_TPU_FEDERATE`` starts a dispatcher process on a machine
    without CUDA (it resolves no device): it prints its serving and cell
    lines, serves /healthz and /cells with the cell down (no route, 503
    to a POST), and SIGTERM ends it with rc 0 and its JSON line."""
    from kueue_tpu_torch.api import serde as pserde

    env = sw.child_env(KUEUE_TPU_FEDERATE="a@z1=http://127.0.0.1:9")
    proc = sw.Proc(["-m", "kueue_tpu_torch.serve", "--journal",
                    str(tmp_path / "routes.jsonl"), "--http",
                    "127.0.0.1:0", "--tick", "0.05"], env)
    try:
        line = proc.wait_line("federation dispatcher serving on ", 120)
        assert "cells=1" in line
        assert proc.wait_line("federation: cell=", 30) == \
            "federation: cell=a zone=z1 url=http://127.0.0.1:9"
        url = sw._base_url(line)
        assert sw.get_json(url, "/healthz") == {"status": "ok"}
        cells = sw.get_json(url, "/cells")
        assert [c["name"] for c in cells["cells"]] == ["a"]
        assert cells["cells"][0]["up"] is False
        code, body = sw.post(url, "/workloads", json.dumps(
            pserde.to_jsonable(ptypes.Workload(name="w", queue_name="lq"))
        ).encode())
        assert code == 503 and body["reason"] == "no healthy cell"
    finally:
        rc, last = proc.stop(signal.SIGTERM)
    assert rc == 0 and last["role"] == "federation"
    assert last["routes"] == {} and last["handoffs"] == 0


def test_bearer_token(tmp_path):
    from kueue_tpu_torch.controllers.engine import Engine

    ep = http_server.ServingEndpoint(Engine(device="cpu"),
                                     auth_token="s3cret")
    ep.start()
    url = f"http://127.0.0.1:{ep.port}"
    try:
        assert sw.get_json(url, "/healthz") == {"status": "ok"}
        with pytest.raises(RuntimeError, match="401"):
            sw.get_json(url, "/workloads")
        c = sw._conn(url, 30)
        c.request("GET", "/workloads",
                  headers={"Authorization": "Bearer s3cret"})
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read()) == []
        code, _ = sw.post(url, "/workloads", b"{}")
        assert code == 401
    finally:
        ep.stop()


def _jax_serve_world(config, tmp_path, monkeypatch, arrivals=None):
    """The JAX engine on serve_world's ``config`` at the defaults: it
    builds the world and writes it with the JAX journal, rebuilds that
    journal and drains it with the arrivals (built with the JAX types;
    the first ``arrivals`` of them when given) submitted directly. The
    port's seeded journal and POST bodies, which the phases serve, equal
    the JAX package's byte for byte. Returns the engine and its final
    state."""
    from kueue_tpu.api import types as jtypes
    from kueue_tpu.bench import scenario as jscenario
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu_torch.bench import engine_worlds as ew

    jkit = ew.Kit(jtypes, jscenario, lambda fair=False: JEngine(
        enable_fair_sharing=fair), lambda eng: eng.attach_oracle())
    # Both packages' uid counters from one value, whatever ran before in
    # this process (journals are byte-identical only then, trap (ak)).
    monkeypatch.setattr(jtypes, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(ptypes, "_uid_counter", itertools.count(1))
    jpath = tmp_path / "jax.jsonl"
    sw.seed_journal(jpath, config, kit=jkit, journal_module=jjournal)
    ppath = tmp_path / "port.jsonl"
    sw.seed_journal(ppath, config)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert sw.arrival_bodies(config) == sw.arrival_bodies(
        config, jkit, jserde)
    eng = jjournal.rebuild_engine(str(jpath))
    eng.attach_oracle()
    for wl in sw.arrivals(config, jkit)[:arrivals]:
        eng.submit(wl)
    cycles = sw.drain_in_process(eng)
    got = sw.final_state(*sw.engine_views(eng, jvis.dump_state, jkueuectl))
    print(f"serve_world: cycles={cycles} {got} "
          f"checksum=0x{got['checksum']:08x}")
    return eng, got


@pytest.mark.slow
def test_full_serve_world_constants(tmp_path, monkeypatch):
    """chip_smoke.py phase 19's constants from the JAX package alone, on
    its default serving loop: the final state, and the /metrics series
    phase 19 pins."""
    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    monkeypatch.delenv("KUEUE_TPU_COLUMNAR", raising=False)
    eng, got = _jax_serve_world(sw.FULL, tmp_path, monkeypatch)
    eng.sync_resource_metrics()
    metrics = chip_smoke.serve_metrics(sw, eng.registry.render())
    print(f"metrics: {metrics}")
    assert got == chip_smoke.SERVE_EXPECT
    assert metrics == chip_smoke.SERVE_METRICS_EXPECT


@pytest.mark.slow
def test_breaker_world_constants(tmp_path, monkeypatch):
    """chip_smoke.py phase 21's final state (the full world with its
    first 250 arrivals) from the JAX package alone."""
    monkeypatch.delenv("KUEUE_TPU_PIPELINE", raising=False)
    monkeypatch.delenv("KUEUE_TPU_COLUMNAR", raising=False)
    _eng, got = _jax_serve_world(sw.FULL, tmp_path, monkeypatch,
                                 arrivals=chip_smoke.BREAKER_ARRIVALS)
    assert got == chip_smoke.SERVE_BREAKER_EXPECT


def test_cycle_lock_excludes_and_serves_requests_first():
    """CycleLock: requests and cycles never overlap (a read-modify-write
    under it loses no update with more threads than cores and a short
    switch interval), and a cycle waits while a request is waiting."""
    import threading
    import time

    lock = http_server.CycleLock()
    state = {"n": 0, "inside": 0, "overlap": False}

    def bump(ctx):
        with ctx():
            state["inside"] += 1
            if state["inside"] != 1:
                state["overlap"] = True
            n = state["n"]
            time.sleep(0)
            state["n"] = n + 1
            state["inside"] -= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = 2 * (os.cpu_count() or 2)
        threads = [threading.Thread(
            target=lambda k=k: [bump(lock.request if k % 2 else lock.cycle)
                                for _ in range(200)])
            for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert state == {"n": 200 * workers, "inside": 0, "overlap": False}

    order = []
    req_waiting = threading.Event()
    with lock.cycle():
        def request():
            req_waiting.set()
            with lock.request():
                order.append("request")

        def cycle():
            with lock.cycle():
                order.append("cycle")

        tr = threading.Thread(target=request)
        tr.start()
        req_waiting.wait(10)
        time.sleep(0.05)  # the request is blocked on the held lock
        tc = threading.Thread(target=cycle)
        tc.start()
        time.sleep(0.05)
    tr.join(10)
    tc.join(10)
    assert order == ["request", "cycle"]


# -- bounded-time recovery and the disk budget --

RECOVERY = {
    "--checkpoint-interval": ("KUEUE_TPU_CKPT_INTERVAL", "7",
                              lambda eng, ck: ck.interval),
    "--checkpoint-keep": ("KUEUE_TPU_CKPT_KEEP", "5",
                          lambda eng, ck: ck.keep),
    "--segment-records": ("KUEUE_TPU_SEGMENT_RECORDS", "100",
                          lambda eng, ck: eng.journal.rotate_records),
    "--segment-bytes": ("KUEUE_TPU_SEGMENT_BYTES", "4096",
                        lambda eng, ck: eng.journal.rotate_bytes),
    "--min-free-bytes": ("KUEUE_TPU_MIN_FREE_BYTES", "1",
                         lambda eng, ck: (eng.journal.budget.min_free_bytes,
                                          ck.store.budget.min_free_bytes)),
}


def _small_journal(path, arrivals=True) -> None:
    """serve_world.SMALL with its arrivals already submitted, journaled
    (no POSTs: the JAX serve process's loop takes no lock)."""
    eng = sw.build_world(sw.SMALL)
    if arrivals:
        for wl in sw.arrivals(sw.SMALL):
            eng.submit(wl)
    pjournal.attach_new_journal(eng, str(path)).close()


@pytest.mark.parametrize("how", ["flag", "env"])
@pytest.mark.parametrize("flag", list(RECOVERY))
def test_recovery_flag_reaches_the_journal_or_checkpointer(
        tmp_path, monkeypatch, flag, how):
    env, value, read = RECOVERY[flag]
    path = tmp_path / "j.jsonl"
    _small_journal(path, arrivals=False)
    argv = ["--journal", str(path), "--device", "cpu",
            "--checkpoint-interval", "3"]
    if how == "flag":
        argv += [flag, value]
    else:
        monkeypatch.setenv(env, value)
        if flag == "--checkpoint-interval":
            argv = argv[:-2]
    eng, ck = serve.boot(serve._parse(argv))
    want = int(value)
    assert read(eng, ck) == (want if flag != "--min-free-bytes"
                             else (want, want))
    assert eng.checkpointer is ck and ck._hook in eng.cycle_listeners
    assert eng.rebuild_source == "genesis"
    eng.journal.close()


def test_recovery_defaults_are_the_jax_defaults(tmp_path):
    """All off (keep 2): no Checkpointer, no rotation, no budget."""
    path = tmp_path / "j.jsonl"
    _small_journal(path, arrivals=False)
    args = serve._parse(["--journal", str(path), "--device", "cpu"])
    assert (args.checkpoint_interval, args.checkpoint_keep,
            args.segment_records, args.segment_bytes,
            args.min_free_bytes) == (0, 2, 0, 0, 0)
    eng, ck = serve.boot(args)
    assert ck is None and eng.checkpointer is None
    assert (eng.journal.rotate_records, eng.journal.rotate_bytes,
            eng.journal.budget.enabled) == (0, 0, False)
    eng.journal.close()


SERVE_RECOVERY_ARGS = ("--checkpoint-interval", "2", "--checkpoint-keep", "2",
                       "--segment-records", "300", "--segment-bytes",
                       "50000000", "--min-free-bytes", "1048576")


def _journal_set(path) -> dict:
    d = path.parent
    return {"segments": sorted(p.name for p in d.glob(path.name + ".seg*")),
            "checkpoints": sorted(p.name for p in (d / (path.name + ".ckpt"))
                                  .glob("ckpt-*.json"))}


def _idle_state(url, dropped_ok=False):
    """The final state of a serve process once its loop is idle. The JAX
    package's process reads its engine for a GET without a lock, so a
    view that races its loop can raise in the request thread, which then
    drops the connection: with ``dropped_ok`` such a GET is made again
    (at most twice). The port's views run under the cycle lock and get
    no second try."""
    for attempt in range(3 if dropped_ok else 1):
        try:
            sw.wait_idle(url, 300, dump_every=0.3, settle=0.5)
            return sw.final_state(sw.get_json(url, "/workloads"),
                                  sw.get_json(url, "/debug/dump"))
        except http.client.RemoteDisconnected:
            if attempt == (2 if dropped_ok else 0):
                raise


def test_recovery_flags_serve_as_the_jax_serve_process(tmp_path):
    """The SMALL world, its arrivals journaled pending, served with all
    five flags by the port's process and by the JAX package's (``--oracle
    local`` on the CPU): the same final state, and both journals rotated
    and checkpointed."""
    ppath, jpath = tmp_path / "port" / "j.jsonl", tmp_path / "jax" / "j.jsonl"
    for p in (ppath, jpath):
        p.parent.mkdir()
    _small_journal(ppath)
    shutil.copy(ppath, jpath)
    procs = []
    try:
        port, purl, boot = sw.start_serve(ppath, "local", "cpu",
                                          timeout=300,
                                          extra=SERVE_RECOVERY_ARGS)
        procs.append(port)
        jax = sw.Proc(["-m", "kueue_tpu.serve", "--journal", str(jpath),
                       "--oracle", "local", "--http", "127.0.0.1:0",
                       "--tick", "0.05", *SERVE_RECOVERY_ARGS],
                      env=sw.child_env(JAX_PLATFORMS="cpu"))
        procs.append(jax)
        line = jax.wait_line("serving on ", 300)
        jurl = "http://" + line.split("serving on ")[1].split()[0]
        states = {"port": _idle_state(purl),
                  "jax": _idle_state(jurl, dropped_ok=True)}
        rc, last = port.stop()
        jrc, _ = jax.stop()
    finally:
        for p in procs:
            if p.p.poll() is None:
                p.stop(signal.SIGKILL)
    assert states["port"] == states["jax"]
    assert states["port"]["arrivals_admitted"] == sw.SMALL["arrivals"]
    assert (rc, jrc) == (0, 0)
    assert boot["source"] == "genesis"
    assert last["checkpoints_written"] >= 2
    assert last["checkpoint_failures"] == 0
    assert last["disk_budget_checks"] > 0
    for p in (ppath, jpath):
        # Rotated (the active file starts with a meta line past segment
        # 0), checkpointed, and retention kept at most two checkpoints
        # and no segment they cover.
        meta = json.loads(p.open().readline())
        assert meta["op"] == "meta" and meta["seg"] >= 1
        got = _journal_set(p)
        assert 1 <= len(got["checkpoints"]) <= 2
        assert "j.jsonl.seg000000" not in got["segments"]


def test_kill_and_restart_boot_from_a_checkpoint(tmp_path):
    """SIGKILL once retention deleted segment 0 (the genesis records), and
    the restart on the same journal set can only come through a
    checkpoint: source ``checkpoint``, its base and suffix printed, and
    after the drain the JAX package's final state of the same world."""
    path = tmp_path / "j.jsonl"
    _small_journal(path)
    args = ("--checkpoint-interval", "2", "--checkpoint-keep", "1",
            "--segment-records", "300")
    seg0 = tmp_path / "j.jsonl.seg000000"
    procs = []
    try:
        first, url, boot = sw.start_serve(path, "local", "cpu", timeout=300,
                                          extra=args)
        procs.append(first)
        deadline = time.monotonic() + 300
        while seg0.exists() or not _journal_set(path)["checkpoints"]:
            assert time.monotonic() < deadline, first.tail()
            time.sleep(0.01)
        first.stop(signal.SIGKILL)
        assert not seg0.exists()
        second, url2, boot2 = sw.start_serve(path, "local", "cpu",
                                             timeout=300, extra=args)
        procs.append(second)
        sw.wait_idle(url2, 300, dump_every=0.3, settle=0.5)
        got = sw.final_state(sw.get_json(url2, "/workloads"),
                             sw.get_json(url2, "/debug/dump"))
        rc, last = second.stop()
    finally:
        for p in procs:
            if p.p.poll() is None:
                p.stop(signal.SIGKILL)
    assert boot["source"] == "genesis"
    assert boot2["source"] == "checkpoint" and boot2["base"] > 1000
    assert boot2["records"] == boot2["base"] + boot2["suffix"]
    assert rc == 0 and last["checkpoint_failures"] == 0
    assert got == _jax_small_final_state()


def _jax_small_final_state() -> dict:
    """The JAX engine's final state of SMALL with its arrivals."""
    from kueue_tpu.api import types as jtypes
    from kueue_tpu.bench import scenario as jscenario
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu_torch.bench import engine_worlds as ew

    jkit = ew.Kit(jtypes, jscenario, lambda fair=False: JEngine(
        enable_fair_sharing=fair), lambda eng: eng.attach_oracle())
    eng = sw.build_world(sw.SMALL, jkit)
    eng.attach_oracle()
    for wl in sw.arrivals(sw.SMALL, jkit):
        eng.submit(wl)
    sw.drain_in_process(eng)
    return sw.final_state(*sw.engine_views(eng, jvis.dump_state, jkueuectl))


def test_degraded_journal_answers_503(tmp_path):
    """POST /workloads while the disk budget holds the journal read-only:
    503 with the JAX front door's body and a Retry-After of 1 (the
    clamped 1 s hint, as a JAX engine without a shedder gives), a known
    key still answers 200 first, and once space returns 201."""
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu.store import diskguard as jguard
    from kueue_tpu.visibility import http_server as jhttp
    from kueue_tpu_torch.controllers.engine import Engine
    from kueue_tpu_torch.store import diskguard as pguard

    bodies = sw.arrival_bodies(sw.SMALL)
    got = {}
    for name, eng, jmod, guard, ep_mod in (
            ("port", Engine(device="cpu"), pjournal, pguard, http_server),
            ("jax", JEngine(), jjournal, jguard, jhttp)):
        jmod.attach_new_journal(eng, str(tmp_path / f"{name}.jsonl"),
                                min_free_bytes=1000)
        free = [10 ** 9]
        guard.FREE_BYTES_PROBE = lambda _p: free[0]
        ep = ep_mod.ServingEndpoint(eng)
        ep.start()
        url = f"http://127.0.0.1:{ep.port}"
        log = []
        try:
            log.append(sw.post(url, "/workloads", bodies[0])[0])
            free[0] = 10
            assert not eng.journal.writable()
            c = sw._conn(url, 30)
            c.request("POST", "/workloads", body=bodies[1],
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            body = json.loads(r.read())
            log.append((r.status, r.getheader("Retry-After"),
                        sorted(body), body["accepted"], body["reason"]))
            assert 0.5 <= body["retryAfter"] <= 1.5
            log.append(sw.post(url, "/workloads", bodies[0]))
            free[0] = 10 ** 9
            assert eng.journal.rearm_probe()
            log.append(sw.post(url, "/workloads", bodies[1])[0])
        finally:
            ep.stop()
            guard.FREE_BYTES_PROBE = None
            eng.journal.close()
        got[name] = log
    assert got["port"] == got["jax"]
    assert got["port"][0] == 201 and got["port"][1][:2] == (503, "1")
    assert got["port"][2][0] == 200 and got["port"][3] == 201


TRACE_ARGS = ("--trace", "8", "--watchdog-deadline", "30",
              "--watchdog-hang", "120")


def test_traced_serve_matches_the_jax_serve_process(tmp_path):
    """The SMALL world, its arrivals journaled pending, served with
    ``--trace 8 --watchdog-deadline 30 --watchdog-hang 120`` by the
    port's process and the JAX package's: the same final state. The
    port's ``/debug/trace`` counts as many traced cycles as its journal
    holds ``cycle_trace`` records, with the ring of 8; ``/debug/perf``
    answers ``{"enabled": false}`` as the JAX serve's does; ``/debug/slo``
    carries the ladder at rung 0 and the watchdog closed; ``/`` serves the
    dashboard; SIGTERM's line has the same counts."""
    ppath, jpath = tmp_path / "port" / "j.jsonl", tmp_path / "jax" / "j.jsonl"
    for p in (ppath, jpath):
        p.parent.mkdir()
    _small_journal(ppath)
    shutil.copy(ppath, jpath)
    procs = []
    try:
        port, purl, _boot = sw.start_serve(ppath, "local", "cpu",
                                           timeout=300, extra=TRACE_ARGS)
        procs.append(port)
        jax = sw.Proc(["-m", "kueue_tpu.serve", "--journal", str(jpath),
                       "--oracle", "local", "--http", "127.0.0.1:0",
                       "--tick", "0.05", *TRACE_ARGS],
                      env=sw.child_env(JAX_PLATFORMS="cpu"))
        procs.append(jax)
        line = jax.wait_line("serving on ", 300)
        jurl = "http://" + line.split("serving on ")[1].split()[0]
        states = {"port": _idle_state(purl),
                  "jax": _idle_state(jurl, dropped_ok=True)}
        trace = sw.get_json(purl, "/debug/trace")
        perf = sw.get_json(purl, "/debug/perf")
        slo = sw.get_json(purl, "/debug/slo")
        page = sw.get_text(purl, "/")
        rc, last = port.stop()
        jrc, _ = jax.stop()
    finally:
        for p in procs:
            if p.p.poll() is None:
                p.stop(signal.SIGKILL)
    assert states["port"] == states["jax"]
    assert (rc, jrc) == (0, 0)
    recs = [r for r in jjournal.Journal(str(ppath)).replay()
            if r["kind"] == "cycle_trace"]
    assert trace["enabled"] and trace["retain"] == 8
    assert trace["cyclesTraced"] == len(recs) == last["cycles_traced"] > 0
    assert len(trace["cycles"]) == min(8, len(recs))
    assert trace["lastCid"] == recs[-1]["obj"]["name"]
    assert perf == {"enabled": False}
    assert slo["enabled"] is False
    assert slo["ladder"]["rung"] == 0 and slo["ladder"]["transitions"] == 0
    assert slo["watchdog"]["state"] == "closed"
    assert slo["watchdog"]["deadlineSeconds"] == 30.0
    assert slo["watchdog"]["hangAfterSeconds"] == 120.0
    assert last["watchdog"]["state"] == "closed"
    assert last["ladder"] == {"rung": 0, "transitions": 0}
    assert page[0].startswith("<!DOCTYPE html>")


def test_shed_rate_answers_429_past_the_rate(tmp_path):
    """``--shed-rate 1``: a burst of POSTs past the bucket answers 429
    with the JAX front door's body and a Retry-After, and /debug/slo
    shows the SLO engine and the shedder."""
    path = tmp_path / "j.jsonl"
    _small_journal(path, arrivals=False)
    proc, url, _boot = sw.start_serve(path, "off", "cpu", timeout=300,
                                      extra=("--shed-rate", "1"))
    try:
        codes = []
        for b in sw.arrival_bodies(sw.SMALL)[:6]:
            code, body = sw.post(url, "/workloads", b)
            codes.append(code)
            if code == 429:
                assert body["reason"] == "shed: admission rate limit"
        slo = sw.get_json(url, "/debug/slo")
    finally:
        rc, _ = proc.stop()
    assert rc == 0
    assert codes[0] == 201 and 429 in codes
    assert slo["enabled"] and slo["shedder"]["shed"] >= 1


def _tiny_journal(path) -> None:
    """Two ClusterQueues of 4 CPUs in a cohort and 12 pending one-CPU
    workloads (8 fit), journaled by the port."""
    from kueue_tpu_torch.controllers.engine import Engine

    t = ptypes
    eng = Engine(device="cpu")
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    for i in range(2):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", cohort="co",
            resource_groups=(t.ResourceGroup(("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(4000)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq{i}", "default", f"cq{i}"))
    for i in range(12):
        eng.clock += 0.01
        eng.submit(t.Workload(name=f"w{i}", queue_name=f"lq{i % 2}",
                              pod_sets=(t.PodSet("main", 1,
                                                 {"cpu": 1000}),)))
    pjournal.attach_new_journal(eng, str(path)).close()


def test_record_with_a_sigkill_fault_then_restart(tmp_path):
    """``--record`` with ``--fault sigkill@admission:5`` on a tiny
    journal: the process dies by SIGKILL mid-apply (two admissions a
    cycle, so in its third cycle); restarted without the fault it drains
    to the JAX engine's final state of the same journal; the torn trace
    (no end frame) replays through both packages' replayers up to its
    last whole cycle."""
    from kueue_tpu import replay as jreplay
    from kueue_tpu_torch import replay as preplay

    path, seed, trace = (tmp_path / "j.jsonl", tmp_path / "seed.jsonl",
                         tmp_path / "t.jsonl")
    _tiny_journal(path)
    shutil.copy(path, seed)
    procs = []
    try:
        first, _, _ = sw.start_serve(
            path, "local", "cpu", timeout=120,
            extra=("--record", str(trace), "--fault",
                   "sigkill@admission:5"))
        procs.append(first)
        assert first.p.wait(120) == -signal.SIGKILL, first.tail()
        second, url, boot = sw.start_serve(path, "local", "cpu",
                                           timeout=120)
        procs.append(second)
        sw.wait_idle(url, 120, dump_every=0.3, settle=0.5)
        got = sw.final_state(sw.get_json(url, "/workloads"),
                             sw.get_json(url, "/debug/dump"))
        rc, last = second.stop()
    finally:
        for p in procs:
            if p.p.poll() is None:
                p.stop(signal.SIGKILL)
    jeng = jjournal.rebuild_engine(str(seed))
    sw.drain_in_process(jeng)
    assert got == sw.final_state(*sw.engine_views(jeng, jvis.dump_state,
                                                  jkueuectl))
    assert got["admitted"] == 8
    assert rc == 0 and last["cycle_seq"] > 0

    frames = list(preplay.TraceReader(str(trace)))
    assert frames[0]["method"] == "create_cohort"
    assert sum(1 for f in frames if f["f"] == "input"
               and f["method"] == "restore_workload") == 12
    cycles = [f for f in frames if f["f"] == "cycle"]
    assert len(cycles) == 2 and all(len(f["decisions"][0]) == 2
                                    for f in cycles)
    for report in (preplay.replay_trace(str(trace), "host", device="cpu"),
                   preplay.replay_trace(str(trace), "device", device="cpu"),
                   jreplay.replay_trace(str(trace), "host")):
        assert report.truncated and report.cycles == 2
        assert report.ok, report.render()
