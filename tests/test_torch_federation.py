"""The federation dispatcher tier in the port (federation/cells.py,
dispatcher.py, aggregator.py; the federation faults of
replay/faults.py) against the JAX package.

Every case of tests/test_federation.py runs twice, as
tests/test_torch_multikueue.py runs its reference cases: on the JAX
package and on the port (the module's globals pointed at the port's, its
``FakeCellTransport`` then raising the port's ``CellTransportError``,
uid counters aligned), each in a directory of its own. The cases pass
one ``now`` to both, so the route journals they leave must be
byte-identical, and every dispatcher they build ends with the same
routes, cell epochs and ``status()``. The hash-seed case runs both
packages' chaos schedules in child processes under three
``PYTHONHASHSEED``s and holds every output equal. Beyond them: the
HTTP transport against a live endpoint, and the aggregator relaying a
cell's events tagged with the cell. Exact throughout."""

import json
import os
import subprocess
import sys

import pytest

import test_federation
import test_torch_multikueue as tm
import test_torch_resources as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHSEED_CASE = "test_chaos_schedules_independent_of_hashseed"
CASES = [c for c in tr.cases_of(test_federation) if c != HASHSEED_CASE]
ROUTES = "routes.jsonl"


def run(case: str, pkg: str, tmp_path) -> tuple:
    _worlds, made = tm.run_case(test_federation, case, pkg, tmp_path,
                                record=("FederationDispatcher",))
    journal = tmp_path / ROUTES
    data = journal.read_bytes() if journal.exists() else None
    dispatchers = [(json.dumps(d.routes, sort_keys=True),
                    {n: (c.epoch, c.up, getattr(c, "needs_reconcile", False),
                         c.breaker.state) for n, c in d.cells.items()},
                    json.dumps(d.status(), sort_keys=True))
                   for d in made["FederationDispatcher"]]
    return data, dispatchers


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {c: run(c, "jax", tmp_path_factory.mktemp(f"jax-{c}"))
            for c in CASES}


def test_every_reference_case_is_held():
    assert len(CASES) + 1 == 18


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(jax_runs, case, tmp_path):
    got_journal, got = run(case, "port", tmp_path)
    want_journal, want = jax_runs[case]
    assert got_journal == want_journal  # byte for byte
    assert got == want


_SCHEDULES = (
    "from {pkg}.replay.faults import ChaosSchedule, "
    "FederationChaosSchedule\n"
    "for seed in range(1, 9):\n"
    "    for s in ChaosSchedule(seed).stages():\n"
    "        print(seed, repr(s.spec), s.cycles, s.lethal)\n"
    "    for e in FederationChaosSchedule(\n"
    "            seed, ('cell-b', 'cell-a', 'cell-c')).events():\n"
    "        print(seed, e.kind, e.cell, e.at, e.arg)\n"
    "    for e in FederationChaosSchedule(\n"
    "            seed, ('cell-a', 'cell-b', 'cell-c'),\n"
    "            workloads=2000).events():\n"
    "        print(seed, e.kind, e.cell, e.at, e.arg)\n")


def test_chaos_schedules_equal_across_packages_and_hashseeds():
    """The reference's hash-seed case on both packages: the recovery
    ChaosSchedule and the federation chain (at the reference's 24
    workloads and at 2,000) print the same under every
    PYTHONHASHSEED, in the port as in the JAX package."""
    outs = []
    for pkg in ("kueue_tpu", "kueue_tpu_torch"):
        for hashseed in ("0", "1", "4242"):
            env = dict(os.environ, PYTHONHASHSEED=hashseed,
                       JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
            proc = subprocess.run(
                [sys.executable, "-c", _SCHEDULES.format(pkg=pkg)],
                capture_output=True, text=True, timeout=120, env=env,
                cwd=REPO)
            assert proc.returncode == 0, proc.stderr
            outs.append(proc.stdout)
    assert outs[0].strip()
    assert len(set(outs)) == 1


def test_http_transport_against_an_endpoint():
    """HTTPCellTransport over a live HA front door on the CPU: health is
    /debug/ha (role, workloads, shedder), submit carries X-Route-Epoch,
    revoke fences the key (409 at a stale epoch, 201 above it), and a
    closed port raises CellTransportError."""
    import tempfile

    from kueue_tpu_torch.api.serde import to_jsonable
    from kueue_tpu_torch.api.types import PodSet, Workload
    from kueue_tpu_torch.federation import (
        CellTransportError,
        HTTPCellTransport,
    )
    from kueue_tpu_torch.ha.replica import HAReplica
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint

    with tempfile.TemporaryDirectory() as d:
        journal = os.path.join(d, "cell.jsonl")
        rep = HAReplica(journal, journal + ".lease", "a",
                        lease_duration=30, renew_in_background=False,
                        engine_kwargs={"device": "cpu"})
        rep.step(1000.0)
        ep = ServingEndpoint(rep.engine_ref, replica=rep)
        ep.start()
        try:
            t = HTTPCellTransport(f"http://127.0.0.1:{ep.port}")
            h = t.health()
            assert h["role"] == "leader" and h["workloads"] == 0
            body = to_jsonable(Workload(
                name="w0", queue_name="lq",
                pod_sets=(PodSet("main", 1, {"cpu": 1}),)))
            assert t.submit(body, route_epoch=1)["code"] == 201
            assert t.submit(body, route_epoch=1)["code"] == 200
            assert [w["name"] for w in t.workloads()] == ["w0"]
            v = t.revoke(["default/w0"], 3)
            assert v["code"] == 200 and v["deleted"] == ["default/w0"]
            assert t.submit(body, route_epoch=3)["code"] == 409
            assert t.submit(body, route_epoch=4)["code"] == 201
            assert t.events_url.endswith("/events")
        finally:
            ep.stop()
            rep.resign()
    dead = HTTPCellTransport("http://127.0.0.1:9", timeout=0.5)
    with pytest.raises(CellTransportError):
        dead.health()


def test_aggregator_relays_cell_events_tagged():
    """CellEventTailer follows a cell's /events and republishes each
    event into the hub with the cell's name; stop only sets its flag."""
    import threading
    import time

    from kueue_tpu_torch.federation.aggregator import CellEventTailer
    from kueue_tpu_torch.visibility.fanout import FanoutHub
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint

    cell_hub, fed_hub = FanoutHub(shards=1), FanoutHub(shards=1)
    ep = ServingEndpoint(None, hub=cell_hub, heartbeat_seconds=0.2)
    ep.start()
    client = fed_hub.subscribe()
    tailer = CellEventTailer("cell-a", f"http://127.0.0.1:{ep.port}/events",
                             fed_hub, reconnect_seconds=0.1)
    try:
        tailer.start()
        got = None
        deadline = time.monotonic() + 20
        while got is None and time.monotonic() < deadline:
            cell_hub.publish("federation_route",
                             json.dumps({"workload": "default/w0"}))
            try:
                got = client.get(timeout=0.2)
            except Exception:  # noqa: BLE001 — queue.Empty: retry
                got = None
        assert got is not None
        kind, data = got
        assert kind == "federation_route"
        assert json.loads(data) == {"workload": "default/w0",
                                    "cell": "cell-a"}
        assert tailer.events_relayed >= 1
    finally:
        tailer.stop()
        fed_hub.unsubscribe(client)
        ep.stop()
        cell_hub.close()
        fed_hub.close()
    assert isinstance(tailer.thread, threading.Thread)
    assert tailer.thread.daemon


def _front_door(pkg: str, journal: str, requests: list) -> tuple:
    """Replay ``requests`` ((method, path, body bytes, headers)) against
    ``pkg``'s HA leader on ``journal`` behind its serving endpoint.
    Returns ([(status, parsed body)], registered workload keys, the
    replica's revocations and route epoch)."""
    import http.client

    if pkg == "jax":
        from kueue_tpu.ha.replica import HAReplica
        from kueue_tpu.visibility.http_server import ServingEndpoint
        kwargs = {}
    else:
        from kueue_tpu_torch.ha.replica import HAReplica
        from kueue_tpu_torch.visibility.http_server import ServingEndpoint
        kwargs = {"engine_kwargs": {"device": "cpu"}}
    rep = HAReplica(journal, journal + ".lease", "a", lease_duration=30,
                    renew_in_background=False, **kwargs)
    rep.step(1000.0)
    assert rep.roles.is_leader
    ep = ServingEndpoint(rep.engine_ref, replica=rep)
    ep.start()
    out = []
    try:
        for method, path, body, headers in requests:
            c = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=30)
            try:
                c.request(method, path, body=body, headers=headers)
                r = c.getresponse()
                out.append((r.status, json.loads(r.read() or b"null")))
            finally:
                c.close()
        state = (sorted(rep.engine.workloads), dict(rep._revoked),
                 rep.route_epoch)
    finally:
        ep.stop()
        rep.resign()
    return out, state


def test_revoke_and_route_epoch_held_against_the_jax_replica(tmp_path):
    """One journal (the world, no workload), copied for each package:
    the same POSTs with and without ``X-Route-Epoch`` (a malformed one
    counting as absent), revocations, a bad revoke body, and re-sends of
    a revoked key at, below and above the tombstone's epoch get the same
    status and body from the JAX front door and the port's, and leave
    the same workloads, tombstones and route epoch."""
    import shutil

    from kueue_tpu_torch.api import serde as pserde
    from kueue_tpu_torch.api import types as pt
    from kueue_tpu_torch.controllers.engine import Engine as PEngine
    from kueue_tpu_torch.store.journal import attach_new_journal
    from test_torch_journal import aligned_uids

    eng = PEngine(device="cpu")
    seed = str(tmp_path / "seed.jsonl")
    journal = attach_new_journal(eng, seed)
    eng.create_resource_flavor(pt.ResourceFlavor("default"))
    eng.create_cluster_queue(pt.ClusterQueue(
        name="cq", resource_groups=(pt.ResourceGroup(("cpu",), (
            pt.FlavorQuotas("default", {"cpu": pt.ResourceQuota(10)}),)),)))
    eng.create_local_queue(pt.LocalQueue("lq", "default", "cq"))
    journal.close()

    def body(name):
        return json.dumps(pserde.to_jsonable(pt.Workload(
            name=name, queue_name="lq", uid=f"uid-{name}",
            pod_sets=(pt.PodSet("main", 1, {"cpu": 1}),)))).encode()

    def post(name, epoch=None):
        hdrs = {"Content-Type": "application/json"}
        if epoch is not None:
            hdrs["X-Route-Epoch"] = str(epoch)
        return ("POST", "/workloads", body(name), hdrs)

    def revoke(keys, epoch):
        return ("POST", "/federation/revoke",
                json.dumps({"keys": keys, "epoch": epoch}).encode(),
                {"Content-Type": "application/json"})

    requests = [
        post("w0", 1), post("w1"), post("w2", "x"), post("w0", 1),
        revoke(["default/w0", "default/w9"], 2),
        post("w0", 2), post("w0", 1), post("w9", 2),
        ("POST", "/federation/revoke", b"{\"keys\": 1}",
         {"Content-Type": "application/json"}),
        post("w0", 3), post("w0", 3), post("w9", 5), post("w3"),
        ("GET", "/debug/ha", None, {}),
    ]
    runs = []
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        shutil.copy(seed, path)
        with aligned_uids():
            runs.append(_front_door(pkg, path, requests))
    (jax_out, jax_state), (port_out, port_state) = runs
    codes = [code for code, _ in port_out]
    assert codes[:-1] == [201, 201, 201, 200, 200, 409, 409, 409, 400, 201,
                          200, 201, 201]
    assert port_out[-1][1]["revoked"] == jax_out[-1][1]["revoked"] == 0
    assert port_out[-1][1]["routeEpoch"] == jax_out[-1][1]["routeEpoch"]
    assert [(c, b) for c, b in port_out[:-1]] == \
        [(c, b) for c, b in jax_out[:-1]]
    assert port_state == jax_state
