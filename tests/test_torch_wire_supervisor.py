"""The oracle's wire format and supervisor in the port
(kueue_tpu_torch/oracle/wire.py, oracle/supervisor.py) against the JAX
package's: frames byte-identical for the same numpy inputs, each
package's ``unpack`` and ``recv_msg`` reading the other's frames, and the
nine cases of tests/test_oracle_supervisor.py replayed on both
supervisors with the same fault sequence and a recording ``sleep``:
equal sleeps, states, counters and ``status()``. Exact throughout."""

import socket
import threading

import numpy as np
import pytest
import torch

from kueue_tpu.oracle import supervisor as jsup
from kueue_tpu.oracle import wire as jwire
from kueue_tpu.oracle.service import RemoteOracleError as JRemoteOracleError
from kueue_tpu_torch.oracle import supervisor as psup
from kueue_tpu_torch.oracle import wire as pwire
from kueue_tpu_torch.oracle.service import RemoteOracleError

PACKAGES = {"jax": (jsup, JRemoteOracleError),
            "port": (psup, RemoteOracleError)}


def _frame_cases():
    rng = np.random.default_rng(5)
    yield "empty", "ping", {}, {"n": 0}
    yield "cycle inputs", "cycle_step", {
        "pending": rng.random(64) > 0.5,
        "priority": rng.integers(-5, 100, 64).astype(np.int64),
        "requests": rng.integers(0, 1 << 40, (64, 2, 3)).astype(np.int64),
        "cq": rng.integers(-1, 7, 64).astype(np.int32),
        "timestamp": rng.random(64),
    }, {"depth": 3, "num_resources": 3, "num_cqs": 7, "fair_mode": False,
        "num_flavors": 2}
    yield "odd shapes", "classical_targets", {
        "scalar": np.asarray(np.int64(-7)),
        "zero rows": np.zeros((0, 4), np.int32),
        "fortran": np.asfortranarray(
            rng.integers(0, 9, (3, 5)).astype(np.int16)),
        "strided": rng.integers(0, 255, 20).astype(np.uint8)[::3],
        "float32": rng.random((2, 2)).astype(np.float32),
    }, {"depth": 2, "v_cap": 32}
    yield "error reply", "error", {}, {"message": "unknown op x"}
    yield "outputs", "ok", {f"out{i}": rng.integers(0, 3, 10 + i)
                            for i in range(14)}, {"n": 14}


FRAMES = list(_frame_cases())


@pytest.mark.parametrize("case", FRAMES, ids=[c[0] for c in FRAMES])
def test_frames_byte_identical(case):
    _, op, tensors, meta = case
    assert pwire.pack(op, tensors, meta) == jwire.pack(op, tensors, meta)


@pytest.mark.parametrize("case", FRAMES, ids=[c[0] for c in FRAMES])
@pytest.mark.parametrize("writer,reader", [(jwire, pwire), (pwire, jwire)],
                         ids=["jax-to-port", "port-to-jax"])
def test_each_unpacks_the_other(case, writer, reader):
    """Each package reads the other's frame as the writer's own package
    reads it; every array of at least one dimension comes back equal
    (both packages read a 0-d array back as shape (1,))."""
    _, op, tensors, meta = case
    frame = writer.pack(op, tensors, meta)
    got_op, got, got_meta = reader.unpack(frame[4:])
    own_op, own, own_meta = writer.unpack(frame[4:])
    assert (got_op, got_meta) == (own_op, own_meta) == (op, meta)
    assert list(got) == list(own) == list(tensors)
    for name, arr in tensors.items():
        assert got[name].dtype == own[name].dtype == arr.dtype
        assert got[name].shape == own[name].shape
        np.testing.assert_array_equal(got[name], own[name])
        if arr.ndim:
            assert got[name].shape == arr.shape
            np.testing.assert_array_equal(got[name], arr)


@pytest.mark.parametrize("writer,reader", [(jwire, pwire), (pwire, jwire)],
                         ids=["jax-to-port", "port-to-jax"])
def test_send_and_recv_across_packages(writer, reader):
    """Frames larger than one recv chunk cross a socket whole."""
    _, op, tensors, meta = FRAMES[1]
    big = dict(tensors, blob=np.arange(3 << 18, dtype=np.int64))
    a, b = socket.socketpair()
    with a, b:
        frame = writer.pack(op, big, meta)
        t = threading.Thread(target=writer.send_msg, args=(a, frame))
        t.start()
        body = reader.recv_msg(b)
        t.join()
    assert body == frame[4:]
    np.testing.assert_array_equal(reader.unpack(body)[1]["blob"],
                                  big["blob"])


def test_pack_takes_numpy_only():
    with pytest.raises(TypeError):
        pwire.pack("cycle_step", {"x": torch.zeros(3)}, {})


# -- the supervisor: tests/test_oracle_supervisor.py's cases on both --

class _Flaky:
    """Fails the first ``n`` calls, then answers."""

    def __init__(self, n, err):
        self.n = n
        self.err = err
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.n:
            raise self.err("injected")
        return "ok"


def _sup(mod, **kw):
    sleeps = []
    kw.setdefault("sleep", sleeps.append)
    return mod.OracleSupervisor(**kw), sleeps


def _retry_recovers_within_budget(mod, err):
    sup, sleeps = _sup(mod, max_attempts=3)
    fn = _Flaky(2, err)
    assert sup.call("cycle_step", fn) == "ok"
    assert fn.calls == 3 and sup.total_retries == 2 and len(sleeps) == 2
    assert 0.0 <= sleeps[0] <= sup.backoff_base * 2
    assert 0.0 <= sleeps[1] <= sup.backoff_base * 4
    return sup, sleeps, [fn.calls]


def _retry_exhausts_and_raises(mod, err):
    sup, sleeps = _sup(mod, max_attempts=3)
    fn = _Flaky(99, err)
    with pytest.raises(err):
        sup.call("cycle_step", fn)
    assert fn.calls == 3
    return sup, sleeps, [fn.calls]


def _backoff_respects_cap(mod, err):
    sup, sleeps = _sup(mod, max_attempts=8, backoff_base=0.5,
                       backoff_cap=1.0)
    with pytest.raises(err):
        sup.call("cycle_step", _Flaky(99, err))
    assert all(d <= 1.0 for d in sleeps)
    return sup, sleeps, []


def _jitter_is_deterministic_but_decorrelated(mod, err):
    a = mod._jitter01("salt", "site", 1, 1)
    assert a == mod._jitter01("salt", "site", 1, 1)
    assert 0.0 <= a < 1.0
    others = [mod._jitter01(s, "site", 1, 1) for s in "abcdefgh"]
    assert len(set(others)) > 1
    sup, sleeps = _sup(mod)
    return sup, sleeps, [a] + others


def _breaker_opens_after_threshold(mod, err):
    sup, sleeps = _sup(mod, threshold=3, cooldown_cycles=5)
    trace = []
    for seq in (1, 2):
        sup.record_failure(seq)
        trace.append((sup.state, sup.allow_cycle(seq)))
        assert trace[-1] == (mod.CLOSED, True)
    sup.record_failure(3)
    assert sup.state == mod.OPEN and sup.demotions == 1
    trace.append((sup.state, sup.allow_cycle(4)))
    assert trace[-1] == (mod.OPEN, False)
    return sup, sleeps, trace


def _breaker_probe_and_repromotion(mod, err):
    sup, sleeps = _sup(mod, threshold=1, cooldown_cycles=5)
    sup.record_failure(10)
    trace = [sup.state, sup.allow_cycle(14), sup.state,
             sup.allow_cycle(15), sup.state]
    assert trace == [mod.OPEN, False, mod.OPEN, True, mod.HALF_OPEN]
    sup.record_success()
    assert sup.state == mod.CLOSED and sup.repromotions == 1
    assert sup.consecutive_failures == 0
    return sup, sleeps, trace


def _failed_probe_doubles_cooldown_with_cap(mod, err):
    sup, sleeps = _sup(mod, threshold=1, cooldown_cycles=4)
    seq = 0
    sup.record_failure(seq)
    cooldowns = []
    for _round in range(6):
        seq = sup._reopen_at
        assert sup.allow_cycle(seq) and sup.state == mod.HALF_OPEN
        sup.record_failure(seq)
        assert sup.state == mod.OPEN
        cooldowns.append(sup._reopen_at - seq)
    assert cooldowns == [8, 16, 32, 32, 32, 32]
    assert sup.allow_cycle(sup._reopen_at)
    sup.record_success()
    assert sup.state == mod.CLOSED and sup._cooldown == 4
    return sup, sleeps, cooldowns


def _success_resets_failure_streak(mod, err):
    sup, sleeps = _sup(mod, threshold=3)
    sup.record_failure(1)
    sup.record_failure(2)
    sup.record_success()
    sup.record_failure(3)
    sup.record_failure(4)
    assert sup.state == mod.CLOSED
    return sup, sleeps, []


def _status_surface(mod, err):
    """The JAX test's status half (the port has no metrics registry)."""
    sup = mod.OracleSupervisor(threshold=1, cooldown_cycles=2,
                               sleep=lambda _d: None)
    sup.record_failure(1)
    assert sup.allow_cycle(3)
    sup.record_success()
    st = sup.status()
    assert st["state"] == mod.CLOSED
    assert st["demotions"] == 1 and st["repromotions"] == 1
    assert st["totalFailures"] == 1
    return sup, [], []


CASES = [_retry_recovers_within_budget, _retry_exhausts_and_raises,
         _backoff_respects_cap, _jitter_is_deterministic_but_decorrelated,
         _breaker_opens_after_threshold, _breaker_probe_and_repromotion,
         _failed_probe_doubles_cooldown_with_cap,
         _success_resets_failure_streak, _status_surface]


@pytest.mark.parametrize("case", CASES,
                         ids=[c.__name__.strip("_") for c in CASES])
def test_supervisor_cases_match_jax(case):
    got = {}
    for name, (mod, err) in PACKAGES.items():
        sup, sleeps, trace = case(mod, err)
        got[name] = (list(sleeps), trace, sup.state, sup.status(),
                     sup.total_retries, sup.total_failures,
                     sup.demotions, sup.repromotions)
    assert got["port"] == got["jax"]


def test_demote_matches_jax():
    """External demotion: opens, extends an open window, re-promotes
    through a half-open probe, identically."""
    got = {}
    for name, (mod, _err) in PACKAGES.items():
        sup, _ = _sup(mod, cooldown_cycles=3)
        sup.demote(5)
        a = (sup.state, sup.status())
        sup.demote(6)
        b = sup.status()
        c = (sup.allow_cycle(8), sup.allow_cycle(9), sup.state)
        sup.record_success()
        got[name] = (a, b, c, sup.status())
    assert got["port"] == got["jax"]
    assert got["port"][2] == (False, True, psup.HALF_OPEN)
