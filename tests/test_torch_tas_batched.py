"""The batched TAS planner of the port (kueue_tpu_torch/tas/batched.py and
ops/tas.tas_place_batch) against the JAX package's, on the CPU.

``tas_place_batch`` is held against the JAX package's at B = 1, 3
(padded to 4, as the planner pads) and 32, and row by row against the
port's own ``tas_place``. The planner worlds are tests/test_tas_batched.py's
own, run through ``MirroredEngine`` (tests/test_torch_engine.py): every
cycle's decisions, placements, bridge counters and TAS stats equal,
under the planner on and off and with its placements pinned to the
device program. The crossover record is the port's own: held here
against a JAX record and the other way round. Exact throughout."""

import json
import random

import numpy as np
import pytest
import torch

import test_tas_batched as tb
import test_torch_engine as te
from kueue_tpu.ops import tas as jtas
from kueue_tpu.tas import calibration as jcalibration
from kueue_tpu.tas import device as jdevice
from kueue_tpu_torch.ops import tas as ttas
from kueue_tpu_torch.tas import calibration as pcalibration
from kueue_tpu_torch.tas import device as pdevice
from test_torch_tas import _t, _world


@pytest.fixture(autouse=True)
def records(monkeypatch, tmp_path):
    """Both crossover records point at an empty directory; no pin."""
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))
    monkeypatch.delenv("KUEUE_TPU_DEVICE_TAS_MIN", raising=False)
    jcalibration.invalidate_cache()
    pcalibration.invalidate_cache()
    yield
    jcalibration.invalidate_cache()
    pcalibration.invalidate_cache()


def _batch_rows(w, B, rng):
    """B random leaderless requests against the world, padded to a power
    of two as tas/batched._place_batch pads: pad rows request nothing,
    count 1, and take every valid leaf."""
    s = w["struct"]
    m, nl = s["m"], s["nl"]
    Bp = 1 << (B - 1).bit_length() if B > 1 else 1
    S = len(w["cols"])
    per_pod = np.zeros((Bp, S), np.int64)
    count = np.ones(Bp, np.int64)
    slice_size = np.ones(Bp, np.int64)
    mask = np.zeros((Bp, m), bool)
    mask[:] = s["valid"][nl - 1]
    for b in range(B):
        per_pod[b] = w["per_pod"] * rng.choice([1, 2])
        per_pod[b, w["cols"].index("pods")] = 1
        slice_size[b] = rng.choice([1, 2])
        count[b] = slice_size[b] * rng.choice([1, 2, 3, 4, 6, 8, 12])
        mask[b] &= np.array([rng.random() > 0.1 for _ in range(m)])
    return per_pod, mask, count, slice_size


_BATCH_CASES = [(seed, B, mode) for seed, B in ((0, 1), (1, 3), (2, 32),
                                                (3, 3), (4, 32))
                for mode in ("required", "preferred", "unconstrained")]


@pytest.mark.parametrize("seed,B,mode", _BATCH_CASES)
def test_tas_place_batch_matches(seed, B, mode):
    w = _world(500 + seed)
    rng = w["rng"]
    s = w["struct"]
    nl = s["nl"]
    req_level = rng.randrange(nl) if mode != "unconstrained" else nl - 1
    slice_level = rng.randrange(req_level, nl)
    per_pod, mask, count, slice_size = _batch_rows(w, B, rng)
    if slice_level == nl - 1 and rng.random() < 0.5:
        count //= slice_size
        slice_size[:] = 1
    kw = dict(num_levels=nl, max_domains=s["m"],
              pods_col=w["cols"].index("pods"), req_level=req_level,
              slice_level=slice_level, required=mode == "required",
              unconstrained=mode == "unconstrained")
    want = jtas.tas_place_batch(
        *map(np.asarray, (w["free"], w["usage"], per_pod, mask, count,
                          slice_size, s["has_pods_cap"], s["valid"],
                          s["vrank"], s["parent"])), **kw)
    t = w["t"]
    got = ttas.tas_place_batch(
        t["free"], t["usage"], _t(per_pod), _t(mask), _t(count),
        _t(slice_size), t["has_pods_cap"], t["valid"], t["vrank"],
        t["parent"], **kw)
    for g, wv in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    # Row by row, each row is the port's own tas_place.
    zeros = torch.zeros_like(t["usage"])
    for b in range(len(count)):
        one = ttas.tas_place(
            t["free"], t["usage"], zeros, _t(per_pod[b]),
            torch.zeros(per_pod.shape[1], dtype=torch.int64), _t(mask[b]),
            t["has_pods_cap"], t["valid"], t["vrank"], t["parent"],
            int(count[b]), int(slice_size[b]), has_leader=False, **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o), b


@pytest.fixture
def mirrored(monkeypatch):
    """MirroredEngine patched into tests/test_tas_batched.py; every
    mirrored world held to the JAX engine's when the test ends. The JAX
    bridge runs its serial loop."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setattr(tb, "Engine", te.MirroredEngine)
    te._ENGINES.clear()
    yield
    assert te._ENGINES, "no mirrored engine was built"
    for eng in te._ENGINES:
        eng.assert_same_world()
    te._ENGINES.clear()


@pytest.mark.parametrize("seed,levels", [(11, 2), (12, 3), (13, 4),
                                         (14, 3), (15, 4)])
def test_batched_matches_host_randomized(mirrored, monkeypatch, seed,
                                         levels):
    tb.test_batched_matches_host_randomized(monkeypatch, seed, levels)


@pytest.mark.parametrize("seed,levels", [(21, 3), (22, 4)])
def test_batched_device_kernel_matches_host(mirrored, monkeypatch, seed,
                                            levels):
    tb.test_batched_device_kernel_matches_host(monkeypatch, seed, levels)
    port = te._ENGINES[0].port.oracle
    assert port.tas_stats["placed_device"] > 0
    assert sum(port.tas_heads_per_launch.values()) > 0


def test_selector_exclusions_equivalent(mirrored, monkeypatch):
    tb.test_selector_exclusions_equivalent(monkeypatch)


def test_tainted_flavor_demotes_both_arms(mirrored, monkeypatch):
    tb.test_tainted_flavor_demotes_both_arms(monkeypatch)


def test_demotion_reasons_are_labeled(mirrored, monkeypatch):
    tb.test_demotion_reasons_are_labeled(monkeypatch)
    assert te._ENGINES[0].port.oracle.host_root_reasons.get(
        "tas-feature", 0) > 0


def test_rowcache_tas_signature_columns(monkeypatch):
    """The port's pending-row cache carries per-row TAS request
    signatures: the JAX package's tuples, stable across re-reads."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setenv("KUEUE_TPU_TAS_BATCH", "1")
    monkeypatch.setattr(tb, "Engine", te.MirroredEngine)
    eng = tb._build_world(random.Random(71), 3, 2, 6)
    te._ENGINES.clear()
    for e in (eng, eng.port):
        e.oracle.try_cycle()
    jrows, prows = eng.queues.rows, eng.port.queues.rows
    sigs = {}
    for key, i in prows._row_of.items():
        ent = prows.tas_requests(i)
        want = jrows.tas_requests(jrows._row_of[key])
        assert repr(ent) == repr(want)
        if ent:
            assert prows.tas_sig[i] != 0
            sigs[i] = (prows.tas_sig[i], ent)
    assert sigs, "no TAS rows encoded"
    for i, (sig, ent) in sigs.items():
        assert prows.tas_requests(i) is ent
        assert prows.tas_sig[i] == sig


def test_calibration_roundtrip(tmp_path):
    path = str(tmp_path / "port.json")
    assert pcalibration.record_path() == path
    assert pcalibration.lookup("cuda", 3, 5000) is None
    assert pcalibration.save("cuda", 3, 5000, host_place_ms=0.5,
                             device_place_ms=0.1) == path
    with open(path, encoding="utf-8") as f:
        table = json.load(f)
    # Bucketed to the next power of two: 5000 -> 8192.
    assert "cuda:3:8192" in table
    entry = pcalibration.lookup("cuda", 3, 5000)
    assert entry["device_place_ms"] == 0.1
    assert pcalibration.lookup("cuda", 3, 8192) == entry
    assert pcalibration.lookup("cuda", 3, 4096) is None
    assert pcalibration.lookup("cpu", 3, 5000) is None


def _snapshots(monkeypatch):
    """The same small world's forest in both packages (JAX, port)."""
    monkeypatch.setenv("KUEUE_TPU_PIPELINE", "0")
    monkeypatch.setattr(tb, "Engine", te.MirroredEngine)
    eng = tb._build_world(random.Random(81), 3, 2, 0)
    te._ENGINES.clear()
    return (next(iter(eng.cache.tas_prototypes().values())),
            next(iter(eng.port.cache.tas_prototypes().values())))


def test_calibration_drives_worth_offloading(monkeypatch):
    _, psnap = _snapshots(monkeypatch)
    nl = len(psnap.level_keys)
    leaves = len(psnap.domains_per_level[nl - 1])
    assert psnap.device.type == "cpu"
    assert not pdevice.worth_offloading(psnap)
    pcalibration.save("cpu", nl, leaves, host_place_ms=5.0,
                      device_place_ms=0.5)
    assert pdevice.worth_offloading(psnap)
    # A record for another backend does not count.
    pcalibration.save("cpu", nl, leaves, host_place_ms=0.5,
                      device_place_ms=5.0)
    pcalibration.save("cuda", nl, leaves, host_place_ms=5.0,
                      device_place_ms=0.5)
    assert not pdevice.worth_offloading(psnap)
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "0")
    assert pdevice.worth_offloading(psnap)
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "1000000")
    assert not pdevice.worth_offloading(psnap)


def test_records_are_each_packages_own(monkeypatch, tmp_path):
    """Under one XDG_CACHE_HOME the two packages keep two files; a
    record that says the device wins moves only its own package."""
    monkeypatch.delenv("KUEUE_TPU_TAS_CALIBRATION")
    monkeypatch.delenv("KUEUE_TPU_TORCH_TAS_CALIBRATION")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert pcalibration.record_path() == str(
        tmp_path / "cache" / "kueue_tpu_torch" / "tas_crossover.json")
    assert jcalibration.record_path() == str(
        tmp_path / "cache" / "kueue_tpu" / "tas_crossover.json")
    jsnap, psnap = _snapshots(monkeypatch)
    nl = len(psnap.level_keys)
    leaves = len(psnap.domains_per_level[nl - 1])
    jcalibration.save("cpu", nl, leaves, host_place_ms=5.0,
                      device_place_ms=0.5)
    pcalibration.invalidate_cache()
    assert jdevice.worth_offloading(jsnap)
    assert not pdevice.worth_offloading(psnap)
    jcalibration.save("cpu", nl, leaves, host_place_ms=0.5,
                      device_place_ms=5.0)
    pcalibration.save("cpu", nl, leaves, host_place_ms=5.0,
                      device_place_ms=0.5)
    jcalibration.invalidate_cache()
    assert pdevice.worth_offloading(psnap)
    assert not jdevice.worth_offloading(jsnap)


def test_crossover_probe_writes_the_record():
    """The crossover probe on a world's forest measures one placement
    each way and, asked to, writes the port's record, which then decides
    worth_offloading for that forest's shape."""
    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.bench import tas_engine_worlds as tw

    kit = ew.port_kit("cpu")
    out = tw.crossover_measure(tw.QUARTER["tas"], kit=kit, n_probe=1,
                               save=True)
    assert out["host_place_ms"] > 0 and out["device_place_ms"] > 0
    snap = next(iter(tw.build(dict(tw.QUARTER["tas"], n_wl=0), kit)
                     .cache.tas_prototypes().values()))
    entry = pcalibration.lookup("cpu", 3, 640)
    assert entry["host_place_ms"] == round(out["host_place_ms"], 4)
    assert pdevice.worth_offloading(snap) == (
        entry["device_place_ms"] < entry["host_place_ms"])
