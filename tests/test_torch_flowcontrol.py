"""API priority and fairness (kueue_tpu_torch/visibility/flowcontrol.py)
against the JAX package's, and in front of the port's endpoint.

Both dispatchers classify alike, deal the same shuffle-shard hands (from
sha256 of the flow name, so under any hash seed), and give the same
verdicts, queue choices and ``stats()`` after every step of one scripted
admit/queue/timeout/release sequence, blocked waiters included. The
port's ``ServingEndpoint`` turns APF on by default, as the JAX one does:
``/debug/flowcontrol`` shows its counts, a GET that finds neither a seat
nor queue room answers 429 with a ``Retry-After`` (here: the one seat
held by a GET that waits for the cycle lock), and ``/events`` is exempt.
Exact throughout."""

import json
import threading
import time

import pytest

from kueue_tpu.visibility import flowcontrol as jfc
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.visibility import flowcontrol as pfc
from kueue_tpu_torch.visibility import http_server as phttp
from kueue_tpu_torch.bench import serve_world as sw

FLOWS = [f"visibility/user-{i}" for i in range(64)] + [
    "visibility/system:anonymous", "probes"]


def _dispatcher(fc, **level):
    schemas, levels = fc.default_config()
    for k, v in level.items():
        setattr(levels["visibility"], k, v)
    return fc.APFDispatcher(schemas, levels)


def test_hands_and_classification_match():
    for queues, hand in ((16, 4), (7, 3), (3, 5), (1, 1)):
        j = _dispatcher(jfc, queues=queues, hand_size=hand)
        p = _dispatcher(pfc, queues=queues, hand_size=hand)
        for flow in FLOWS:
            assert (p._shuffle_shard(p.levels["visibility"], flow)
                    == j._shuffle_shard(j.levels["visibility"], flow))
    j, p = jfc.APFDispatcher(), pfc.APFDispatcher()
    for user in ("system:anonymous", "0123456789ab"):
        for path in ("/healthz", "/metrics", "/read/quota", "/"):
            js, jflow = j.classify(user, path)
            ps, pflow = p.classify(user, path)
            assert (ps.name, ps.priority_level, pflow) == (
                js.name, js.priority_level, jflow)


def _script(fc):
    """One admit/queue/timeout/release sequence on a level of 2 seats,
    4 queues of 1, hands of 2. Returns the verdict of each step and the
    stats after it."""
    apf = _dispatcher(fc, nominal_concurrency=2, queues=4, hand_size=2,
                      queue_length_limit=1)
    out = []
    held = []

    def step(label, fn):
        try:
            verdict = fn()
        except fc.RejectedError as e:
            verdict = f"rejected: {e}"
        out.append((label, verdict, apf.stats()))

    def admit(user, timeout=5.0):
        ticket = apf.admit(user, "/capacity", timeout=timeout)
        held.append(ticket)
        return "admitted"

    step("seat 1", lambda: admit("u1"))
    step("seat 2", lambda: admit("u2"))
    step("timeout", lambda: admit("u3", timeout=0.05))
    # Two waiters in the queues of their hands, admitted in arrival
    # order as seats free up.
    waiters = {}
    order = []

    def wait(user):
        apf.admit(user, "/capacity", timeout=10.0)
        order.append(user)
        waiters[user] = True

    threads = []
    for user in ("u4", "u5"):
        t = threading.Thread(target=wait, args=(user,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 5
        while apf.stats()["queued_total"] < len(threads) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
    out.append(("queued", None, apf.stats()))
    step("full", lambda: admit("u5", timeout=0.05))
    step("exempt", lambda: (apf.release(apf.admit("u9", "/healthz")),
                            "exempt")[1])
    for ticket in held:
        apf.release(ticket)
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    out.append(("drained", order, apf.stats()))
    return out


def test_scripted_sequence_matches():
    want = _script(jfc)
    got = _script(pfc)
    assert [(label, v) for label, v, _ in got if label != "full"] == [
        (label, v) for label, v, _ in want if label != "full"]
    assert [s for _, _, s in got] == [s for _, _, s in want]
    full = dict((label, v) for label, v, _ in got)["full"]
    assert full == dict((label, v) for label, v, _ in want)["full"]


@pytest.fixture
def endpoint():
    eng = PEngine(device="cpu")
    apf = _dispatcher(pfc, nominal_concurrency=1, queues=1, hand_size=1,
                      queue_length_limit=0)
    ep = phttp.ServingEndpoint(eng, port=0, flow_control=apf)
    ep.start()
    try:
        yield ep, f"http://127.0.0.1:{ep.port}"
    finally:
        ep.stop()


def test_endpoint_applies_apf(endpoint):
    ep, url = endpoint
    assert phttp.ServingEndpoint(PEngine(device="cpu")).apf is not None
    st = sw.get_json(url, "/debug/flowcontrol")
    assert st["levels"]["visibility"]["executing"] == 1  # this request
    assert st["rejected_total"] == 0
    # The one seat is held by a GET waiting for the cycle lock, which
    # the test holds as the serving loop would.
    box = {}
    with ep.lock.cycle():
        t = threading.Thread(target=lambda: box.update(
            r=sw.get_json(url, "/capacity")))
        t.start()
        deadline = time.monotonic() + 5
        while (ep.apf.stats()["levels"]["visibility"]["executing"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        c = sw._conn(url, 30)
        c.request("GET", "/cohorts")
        r = c.getresponse()
        body = json.loads(r.read())
        assert r.status == 429
        assert int(r.getheader("Retry-After")) >= 1
        assert body["error"] == "too many requests"
        # /healthz is exempt; /events takes no seat.
        assert sw.get_json(url, "/healthz") == {"status": "ok"}
    t.join(timeout=30)
    assert not t.is_alive() and box["r"] == []
    assert ep.apf.stats()["rejected_total"] == 1
