"""The port's deployable process (python -m kueue_tpu_torch.serve) on
the CPU, against the JAX package: booted from a journal of
serve_world's small world plus workloads held back by a far requeue
time (so pending positions stay to compare), it answers /healthz, takes
the arrivals over POST /workloads (201, then 200 deduplicated for a
known key, 400 for a bad body) and drains them, and every view it
serves (/debug/dump but its wall-clock phases, /capacity, /cohorts,
/clusterqueues, the pending positions and /workloads) equals the JAX
package's view of a mirrored engine: the JAX engine rebuilt from the
same journal, given the same arrivals and drained in-process. An
unported route answers 404 naming itself, an unported flag exits 2, the
bearer token guards every route but /healthz, and SIGTERM exits 0.
The slow test recomputes chip_smoke.py's phase 19 constants from the
JAX package. Exact throughout."""

import json
import os
import shutil
import signal
import subprocess
import sys

import pytest

import chip_smoke
from kueue_tpu.api import serde as jserde
from kueue_tpu.cli import kueuectl as jkueuectl
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
         "/clusterqueues/arrivals/pendingworkloads", "/workloads"]


def _jax_views(eng) -> dict:
    vis = jvis.VisibilityServer(eng)

    def pending(cq):
        s = vis.pending_workloads_for_cq(cq)
        return {"clusterQueue": s.cluster_queue,
                "items": [vars(i) for i in s.items]}

    out = {"/debug/dump": jvis.dump_state(eng),
           "/capacity": jvis.capacity_summary(eng),
           "/cohorts": jvis.cohort_tree(eng),
           "/clusterqueues": jkueuectl.Kueuectl(eng).list_cluster_queues(),
           "/workloads": jkueuectl.Kueuectl(eng).list_workloads()}
    for cq in ("cq-0", "cq-1", "arrivals"):
        out[f"/clusterqueues/{cq}/pendingworkloads"] = pending(cq)
    return json.loads(json.dumps(out))


def _comparable(path, view):
    if path == "/debug/dump":
        return {k: v for k, v in view.items()
                if k not in ("lastCyclePhases", "unadmittedByReason")}
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

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUEUE_TPU_PIPELINE", "0")
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


@pytest.mark.parametrize("path", ["/metrics", "/events", "/evictions",
                                  "/debug/trace", "/clusterqueues/cq-0/status",
                                  "/read/pending/cq-0", "/dashboard"])
def test_unported_route_404(served, path):
    url = served[1]
    with pytest.raises(RuntimeError, match="404"):
        sw.get_json(url, path)
    c = sw._conn(url, 30)
    c.request("GET", path)
    r = c.getresponse()
    body = json.loads(r.read())
    assert r.status == 404 and body["error"] == "not ported"


def test_unknown_route_404(served):
    code, body = sw.post(served[1], "/federation/revoke", b"{}")
    assert code == 404 and body["error"] == "not ported"
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


@pytest.mark.parametrize("argv", [
    ["--ha"], ["--federate", "a=http://x"], ["--read-replica"],
    ["--record", "t.jsonl"], ["--fault", "sigkill@admission:4"],
    ["--trace"], ["--checkpoint-interval", "5"],
    ["--segment-records", "100"], ["--min-free-bytes", "1"],
    ["--watchdog-deadline", "1"], ["--shed-rate", "5"]])
def test_unported_flag_exits_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--journal", "unused.jsonl", *argv])
    assert e.value.code == 2
    assert argv[0] in capsys.readouterr().err


def test_unported_flag_exits_2_as_a_process(tmp_path):
    env = sw.child_env(KUEUE_TPU_HA="1")
    out = subprocess.run([sys.executable, "-m", "kueue_tpu_torch.serve",
                          "--journal", str(tmp_path / "j.jsonl")],
                         cwd=sw.REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2
    assert "KUEUE_TPU_HA" in out.stderr and "not ported" in out.stderr


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


@pytest.mark.slow
def test_full_serve_world_constants(tmp_path, monkeypatch):
    """chip_smoke.py phase 19's constants from the JAX package alone:
    the JAX engine builds the full-width world and writes it with the
    JAX journal, rebuilds that journal and drains it with the 1,000
    arrivals (built with the JAX types) submitted directly. The port's
    seeded journal and POST bodies, which phase 19 serves, equal the
    JAX package's byte for byte."""
    from kueue_tpu.api import types as jtypes
    from kueue_tpu.bench import scenario as jscenario
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu_torch.bench import engine_worlds as ew

    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    jkit = ew.Kit(jtypes, jscenario, lambda fair=False: JEngine(
        enable_fair_sharing=fair), lambda eng: eng.attach_oracle())
    jpath = tmp_path / "jax.jsonl"
    sw.seed_journal(jpath, sw.FULL, kit=jkit, journal_module=jjournal)
    ppath = tmp_path / "port.jsonl"
    sw.seed_journal(ppath, sw.FULL)
    assert ppath.read_bytes() == jpath.read_bytes()
    assert sw.arrival_bodies(sw.FULL) == sw.arrival_bodies(
        sw.FULL, jkit, jserde)
    eng = jjournal.rebuild_engine(str(jpath))
    eng.attach_oracle()
    for wl in sw.arrivals(sw.FULL, jkit):
        eng.submit(wl)
    cycles = sw.drain_in_process(eng)
    got = sw.final_state(*sw.engine_views(eng, jvis.dump_state, jkueuectl))
    print(f"serve_world FULL: cycles={cycles} {got} "
          f"checksum=0x{got['checksum']:08x}")
    assert got == chip_smoke.SERVE_EXPECT


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
