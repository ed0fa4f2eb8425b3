"""The oracle sidecar of the port (kueue_tpu_torch/oracle/service.py:
OracleServer, RemoteExecutor, the sidecar process) and the supervisor
in the port's bridge, against the JAX engine's in-process decisions:

  * the port's engine through the port's RemoteExecutor and OracleServer
    (device="cpu"), in a thread and as a subprocess;
  * the JAX engine's RemoteExecutor against the port's server;
  * the port's engine against the JAX package's OracleServer in a thread;
  * a sidecar that dies after N replies: ``remote-error`` host cycles,
    then ``breaker-open`` ones, then re-promotion once the sidecar is
    restarted, with the same fallback counts, supervisor status and
    decisions as the JAX engine under the same fault.
  * an exception in the sidecar's executor leaves schedule_once (no
    retry, no host cycle), as a local executor's does.

Each run is compared cycle by cycle (engine_worlds.decision_stream) and
by its final state. Worlds: serve_world's small world with its
arrivals, the multi-flavor preemption world (classical_targets crosses
the wire for the sim nomination) and the preemption churn (fused
preemption inside cycle_step). Exact throughout."""

import dataclasses
import random
import threading
import zlib

import pytest

from kueue_tpu.api import types as jtypes
from kueue_tpu.bench import scenario as jscenario
from kueue_tpu.cli import kueuectl as jkueuectl
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.oracle import service as jservice
from kueue_tpu.visibility import server as jvis
from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.cli import kueuectl as pkueuectl
from kueue_tpu_torch.oracle import service as pservice
from kueue_tpu_torch.oracle.service import (
    RemoteExecutor,
    RemoteExecutorError,
    RemoteOracleError,
)
from kueue_tpu_torch.visibility import server as pvis


@pytest.fixture(scope="module")
def kits():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUEUE_TPU_PIPELINE", "0")
        mp.setenv("KUEUE_TPU_ORACLE_BREAKER_COOLDOWN", "2")
        yield (ew.Kit(jtypes, jscenario,
                      lambda fair=False: JEngine(enable_fair_sharing=fair),
                      lambda eng: eng.attach_oracle()),
               ew.port_kit("cpu"))


def _remote(kit, address, port_engine: bool):
    if port_engine:
        attach = (lambda eng: eng.attach_oracle(device="cpu",
                                                remote_address=address))
    else:
        attach = (lambda eng: eng.attach_oracle(remote_address=address))
    return dataclasses.replace(kit, attach=attach)


def _views(eng):
    port = type(eng).__module__.startswith("kueue_tpu_torch")
    return sw.engine_views(eng, (pvis if port else jvis).dump_state,
                           pkueuectl if port else jkueuectl)


def _serve_small(kit, on_cycle):
    eng = sw.build_world(sw.SMALL, kit)
    kit.attach(eng)
    for wl in sw.arrivals(sw.SMALL, kit):
        eng.submit(wl)
    while True:
        r = eng.schedule_once()
        on_cycle(r)
        if r is None:
            return eng


def _multiflavor(kit, on_cycle):
    eng = ew.multiflavor_engine(random.Random(1000), kit=kit)
    ew.multiflavor_churn(eng, random.Random(0), kit=kit, on_cycle=on_cycle)
    return eng


def _preempt_churn(kit, on_cycle):
    eng = ew.preempt_churn_engine(60, n_cohorts=2, kit=kit,
                                  on_cycle=on_cycle)
    ew._drain_engine(eng, on_cycle=on_cycle)
    return eng


WORLDS = {"serve_small": _serve_small, "multiflavor": _multiflavor,
          "preempt_churn": _preempt_churn}


def run(world, kit) -> dict:
    streams = []
    eng = WORLDS[world](kit, lambda r: streams.append(
        ew.decision_stream(r)))
    b = eng.oracle
    return {"streams": streams,
            "state": sw.final_state(*_views(eng)),
            "on_device": b.cycles_on_device,
            "fallback": dict(b.fallback_reasons),
            "supervisor": b.supervisor.status()}


@pytest.fixture(scope="module")
def jax_runs(kits):
    return {w: run(w, kits[0]) for w in WORLDS}


@pytest.fixture(scope="module")
def port_server():
    server = pservice.OracleServer(device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server
    server.close()


@pytest.fixture(scope="module")
def jax_server():
    server = jservice.OracleServer()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _same(got, want):
    assert len(got["streams"]) == len(want["streams"])
    for i, (g, w) in enumerate(zip(got["streams"], want["streams"])):
        assert g == w, f"cycle {i}"
    assert got["state"] == want["state"]
    assert got["on_device"] == want["on_device"] > 0
    assert got["fallback"] == want["fallback"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_port_engine_through_port_server(kits, jax_runs, port_server,
                                         world):
    served = port_server.served
    got = run(world, _remote(kits[1], port_server.address, True))
    _same(got, jax_runs[world])
    assert port_server.served - served >= got["on_device"]


def test_port_engine_through_sidecar_process(kits, jax_runs):
    side, port = sw.start_sidecar("cpu")
    try:
        got = run("serve_small", _remote(kits[1], ("127.0.0.1", port),
                                         True))
    finally:
        rc, last = side.stop()
    _same(got, jax_runs["serve_small"])
    assert rc == 0
    assert (last["heads_launches"], last["compute_replies"]) == \
        (0, got["on_device"])
    assert last["bytes_in"] > last["bytes_out"] > 0


@pytest.mark.parametrize("world", ["serve_small", "multiflavor"])
def test_jax_engine_through_port_server(kits, jax_runs, port_server, world):
    got = run(world, _remote(kits[0], port_server.address, False))
    _same(got, jax_runs[world])


@pytest.mark.parametrize("world", ["serve_small", "multiflavor"])
def test_port_engine_through_jax_server(kits, jax_runs, jax_server, world):
    got = run(world, _remote(kits[1], jax_server.address, True))
    _same(got, jax_runs[world])


def test_wire_bytes_agree_on_both_ends():
    """serve_world.wire_bytes counts what the client sent and received;
    the server counted the same bytes."""
    got = sw.wire_bytes(sw.SMALL)
    assert got["calls"] >= sw.SMALL["arrivals"]
    assert got["first_sent"] > got["sent_per_call"] > \
        got["received_per_call"] > 0
    server = pservice.OracleServer(device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        ex = RemoteExecutor(*server.address)
        ex._call("cycle_step", {}, {})  # an error reply still counts
    except RemoteExecutorError:
        pass
    finally:
        server.close()
    assert (server.served, server.bytes_in, server.bytes_out) == \
        (1, ex.bytes_sent, ex.bytes_received)


def test_remote_executor_error_paths(port_server):
    """A refused connection surfaces as RemoteOracleError (a transport
    failure, which the supervisor retries); an error reply from the
    server's executor, or an unknown op, as RemoteExecutorError, which
    is not a RemoteOracleError. The connection serves on after an error
    reply."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    free = s.getsockname()[1]
    s.close()
    with pytest.raises(RemoteOracleError):
        RemoteExecutor("127.0.0.1", free, timeout=5).cycle_step({}, {})
    ex = RemoteExecutor(*port_server.address)
    with pytest.raises(RemoteExecutorError, match="TypeError"):
        ex.cycle_step({}, {})
    assert ex._call("ping", {}, {}) == []
    with pytest.raises(RemoteExecutorError, match="unknown op"):
        ex._call("no_such_op", {}, {})
    assert not issubclass(RemoteExecutorError, RemoteOracleError)
    ex.close()


def test_sidecar_executor_error_leaves_schedule_once(kits):
    """An exception raised by the sidecar's executor (a kernel that
    fails to build or launch on its device) is not a transport failure:
    it is not retried, it becomes no host cycle, and it leaves
    schedule_once as a local executor's error does. The supervisor
    counts it; once the executor works again the next cycle runs on
    the device through the same connection."""
    server = pservice.OracleServer(device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    kit = _remote(kits[1], server.address, True)
    eng = sw.build_world(sw.SMALL, kit)
    kit.attach(eng)
    working = server.executor.cycle_step

    def planted(tensors, statics):
        raise RuntimeError("planted kernel failure")

    server.executor.cycle_step = planted
    try:
        with pytest.raises(RemoteExecutorError,
                           match="planted kernel failure"):
            eng.schedule_once()
        b = eng.oracle
        assert b.cycles_fallback == 0 and b.fallback_reasons == {}
        st = b.supervisor.status()
        assert (st["state"], st["totalRetries"], st["totalFailures"],
                st["consecutiveFailures"]) == ("closed", 0, 1, 1)
        assert server.served == 1
        server.executor.cycle_step = working
        assert eng.schedule_once() is not None
        assert (b.cycles_on_device, b.cycles_fallback) == (1, 0)
        assert b.supervisor.status()["consecutiveFailures"] == 0
    finally:
        eng.oracle.executor.close()
        server.close()


def test_sidecar_needs_cuda_unless_cpu_is_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pservice.OracleServer()
    with pytest.raises(SystemExit):
        pservice.parse_fault("crash-before:3")
    assert pservice.parse_fault("crash-after:3") == 3
    assert pservice.parse_fault("") is None


N_REPLIES = 4


def _faulted(kit, port_engine: bool) -> dict:
    """serve_small against a sidecar that exits after N_REPLIES compute
    replies; the sidecar is restarted on the same port after the first
    breaker-open cycle. Returns the run, the fallback reasons and
    supervisor status after each cycle, and the restarted sidecar's
    compute replies."""
    side, port = sw.start_sidecar("cpu", fault=f"crash-after:{N_REPLIES}")
    kit = _remote(kit, ("127.0.0.1", port), port_engine)
    trace = []
    state = {"side": side, "restarted": False}
    box = {}

    def on_cycle(r):
        b = box["eng"].oracle
        trace.append((dict(b.fallback_reasons), b.supervisor.status()))
        if b.cycles_on_device == N_REPLIES and state["side"].p.poll() is None:
            state["side"].p.wait(60)  # the fault: it exits after replying
        if (not state["restarted"]
                and b.fallback_reasons.get("breaker-open")):
            state["side"], _ = sw.start_sidecar("cpu", port=port)
            state["restarted"] = True

    eng = sw.build_world(sw.SMALL, kit)
    box["eng"] = eng
    kit.attach(eng)
    for wl in sw.arrivals(sw.SMALL, kit):
        eng.submit(wl)
    streams = []
    while True:
        r = eng.schedule_once()
        streams.append(ew.decision_stream(r))
        on_cycle(r)
        if r is None:
            break
    rc, last = state["side"].stop()
    assert rc == 0 and state["restarted"]
    b = eng.oracle
    return {"streams": streams, "trace": trace,
            "state": sw.final_state(*_views(eng)),
            "on_device": b.cycles_on_device,
            "fallback": dict(b.fallback_reasons),
            "supervisor": b.supervisor.status(),
            "second_sidecar_replies": last["compute_replies"]}


@pytest.fixture(scope="module")
def faulted(kits):
    return {"jax": _faulted(kits[0], False), "port": _faulted(kits[1], True)}


def test_fault_sequence_matches_jax(faulted, jax_runs):
    got, want = faulted["port"], faulted["jax"]
    assert got["streams"] == want["streams"]
    assert got["trace"] == want["trace"]
    assert got["fallback"] == want["fallback"]
    assert got["supervisor"] == want["supervisor"]
    # The host cycles decide as the device ones do: the same final state
    # as the unfaulted run.
    assert got["state"] == jax_runs["serve_small"]["state"]


def test_fault_sequence_shape(faulted):
    """remote-error cycles up to the breaker's threshold, then
    breaker-open cycles, then a probe that re-promotes: device cycles
    resume on the restarted sidecar, which served every one of them."""
    got = faulted["port"]
    fb = got["fallback"]
    assert fb["remote-error"] == 3 and fb["breaker-open"] >= 1
    st = got["supervisor"]
    assert st["state"] == "closed"
    assert (st["demotions"], st["repromotions"]) == (1, 1)
    assert st["totalFailures"] == 3 and st["totalRetries"] == 6
    assert got["on_device"] > N_REPLIES
    assert got["second_sidecar_replies"] == got["on_device"] - N_REPLIES
    states = [s["state"] for _fb, s in got["trace"]]
    first_open = states.index("open")
    assert states[:first_open] == ["closed"] * first_open
    assert "closed" in states[first_open:]
    crc = zlib.crc32(b"".join(got["streams"]))
    assert crc == zlib.crc32(b"".join(faulted["jax"]["streams"]))
