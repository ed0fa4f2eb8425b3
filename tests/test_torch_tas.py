"""The TAS tensor programs of the PyTorch port (kueue_tpu_torch/ops/tas.py)
vs the JAX package's kueue_tpu/ops/tas.py, on the CPU.

The inputs are the JAX package's own encodings of the reference suites'
worlds (tests/test_tas_kernel.py random_tas, tests/test_tas_device.py
random_world), carried across with carry.tas_structure, so these tests
hold the tensor programs alone, not the port's copied snapshot code.
Exact: integer outputs, including the int64 extremes that empty
segments leave behind."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_tas_device as ref_device
import test_tas_kernel as ref_kernel
from kueue_tpu.ops import tas as jtas
from kueue_tpu.tas import device as jdevice
from kueue_tpu_torch import carry
from kueue_tpu_torch.ops import tas as ttas

RESOURCES = ["cpu", "pods"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("seed", range(6))
def test_leaf_states_and_bubble_counts_match(seed):
    """tests/test_tas_kernel.py's worlds and slice geometry, the phase-1
    arrays from the JAX package's encode_tas_snapshot."""
    rng = random.Random(seed)
    snap = ref_kernel.random_tas(rng)
    per_pod_cpu = rng.choice([500, 1000, 2000])
    slice_size = rng.choice([1, 2, 4])
    slice_level_idx = rng.choice([1, 2])
    eff_slice_level = slice_level_idx if slice_size > 1 else 2
    enc = jtas.encode_tas_snapshot(snap, RESOURCES)
    L = enc["free_capacity"].shape[0]
    args = (enc["free_capacity"], enc["tas_usage"],
            np.zeros_like(enc["free_capacity"]),
            np.array([per_pod_cpu, 1], np.int64), np.ones(L, bool))
    j_leaf = jtas.leaf_states(*map(jnp.asarray, args))
    t_leaf = ttas.leaf_states(*map(_t, args))
    np.testing.assert_array_equal(t_leaf.numpy(), np.asarray(j_leaf))
    want = jtas.bubble_counts(j_leaf, enc["parent_of_level"],
                              enc["max_domains"], slice_size,
                              eff_slice_level, num_levels=enc["num_levels"])
    got = ttas.bubble_counts(t_leaf, enc["parent_of_level"],
                             enc["max_domains"], slice_size,
                             eff_slice_level, num_levels=enc["num_levels"])
    assert all(g.dtype == torch.int32 for g in got)
    _same(got, want)


def test_encode_tas_snapshot_matches():
    from test_torch_tas_device import port_snapshot

    jsnap = ref_kernel.random_tas(random.Random(3))
    want = jtas.encode_tas_snapshot(jsnap, RESOURCES)
    got = ttas.encode_tas_snapshot(port_snapshot(jsnap), RESOURCES)
    for k in ("num_levels", "max_domains"):
        assert got[k] == want[k]
    for k in ("parent_of_level", "free_capacity", "tas_usage"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert [[d.values for d in lvl] for lvl in got["level_domains"]] == \
        [[d.values for d in lvl] for lvl in want["level_domains"]]


def _world(seed, topology=None):
    """A reference random_world, its JAX encoding carried across, and a
    random request drawn against it."""
    rng = random.Random(seed)
    topology = topology or rng.choice([ref_device.TOPOLOGY3,
                                       ref_device.TOPOLOGY3,
                                       ref_device.TOPOLOGY2])
    snap = ref_device.random_world(rng, topology)
    struct = jdevice._structure(snap)
    per_pod = {"cpu": rng.choice([100, 500, 1000, 2000]), "pods": 1}
    if rng.random() < 0.3:
        per_pod["mem"] = rng.choice([128, 1024])
    leader = {"cpu": rng.choice([100, 1000, 4000]), "pods": 1}
    cols = jdevice._cols_for(struct, per_pod, leader)
    free = jdevice._free_matrix(struct, cols)
    usage = jdevice._usage_matrix(snap, struct, cols)
    m = struct["m"]
    assumed = np.zeros_like(usage)
    for i in range(len(struct["leaves"])):
        if rng.random() < 0.3:
            assumed[i, cols.index("cpu")] = rng.randrange(0, 2000)
    leaf_mask = struct["valid"][-1] & (np.array(
        [rng.random() > 0.15 for _ in range(m)]))
    return dict(
        rng=rng, struct=struct, cols=cols,
        t=carry.tas_structure(dict(struct, free=free, usage=usage),
                              device="cpu"),
        free=free, usage=usage, assumed=assumed,
        per_pod=jdevice._req_vector(per_pod, cols),
        leader=jdevice._req_vector(leader, cols), leaf_mask=leaf_mask)


def _phase1_args(w):
    s = w["struct"]
    return (w["free"], w["usage"], w["assumed"], w["per_pod"], w["leader"],
            w["leaf_mask"], s["has_pods_cap"], s["valid"], s["parent"])


def _port_phase1_args(w):
    t = w["t"]
    return (t["free"], t["usage"], _t(w["assumed"]), _t(w["per_pod"]),
            _t(w["leader"]), _t(w["leaf_mask"]), t["has_pods_cap"],
            t["valid"], t["parent"])


def _port_phase1(free, usage, assumed, per_pod, leader, mask, *rest,
                 slice_size, **kw):
    """The port's batched phase 1 on one row, as [NL, M] arrays."""
    out = ttas._phase1(free, usage, assumed, per_pod[None], leader[None],
                       mask[None], *rest,
                       torch.tensor([slice_size], dtype=torch.int64), **kw)
    return tuple(x[:, 0] for x in out)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("has_leader", [False, True],
                         ids=["no_leader", "leader"])
def test_phase1_matches(seed, has_leader):
    w = _world(100 + seed)
    s = w["struct"]
    nl = s["nl"]
    slice_size = w["rng"].choice([1, 2, 3])
    slice_level = w["rng"].randrange(nl)
    kw = dict(num_levels=nl, max_domains=s["m"],
              pods_col=w["cols"].index("pods"), slice_level=slice_level,
              has_leader=has_leader)
    want = jtas._phase1(*map(jnp.asarray, _phase1_args(w)), slice_size,
                        **kw)
    got = _port_phase1(*_port_phase1_args(w), slice_size=slice_size, **kw)
    _same(got, want)


_PLACE_CASES = [(seed, mode, leader)
                for seed in range(8)
                for mode in ("required", "preferred", "unconstrained")
                for leader in (False, True)
                if not (leader and seed % 2)]


@pytest.mark.parametrize("seed,mode,has_leader", _PLACE_CASES)
def test_tas_place_matches(seed, mode, has_leader):
    w = _world(200 + seed)
    rng = w["rng"]
    s = w["struct"]
    nl = s["nl"]
    req_level = rng.randrange(nl) if mode != "unconstrained" else nl - 1
    slice_level = rng.randrange(req_level, nl)
    slice_size = rng.choice([1, 2]) if slice_level < nl - 1 or \
        rng.random() < 0.5 else 1
    count = slice_size * rng.choice([1, 2, 3, 4, 6, 8, 12])
    kw = dict(num_levels=nl, max_domains=s["m"],
              pods_col=w["cols"].index("pods"), req_level=req_level,
              slice_level=slice_level, required=mode == "required",
              unconstrained=mode == "unconstrained", has_leader=has_leader)
    jargs = _phase1_args(w)
    want = jax.device_get(jtas.tas_place(
        *map(jnp.asarray, jargs[:8]), jnp.asarray(s["vrank"]),
        jnp.asarray(jargs[8]), np.int64(count), np.int64(slice_size), **kw))
    targs = _port_phase1_args(w)
    got = ttas.tas_place(*targs[:8], w["t"]["vrank"], targs[8], count,
                         slice_size, **kw)
    _same(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_tas_feasibility_matches(seed):
    w = _world(300 + seed)
    rng = w["rng"]
    s = w["struct"]
    nl = s["nl"]
    B, S, M = 8, len(w["cols"]), s["m"]
    per_pod = np.zeros((B, S), np.int64)
    per_pod[:, w["cols"].index("cpu")] = [rng.choice([0, 100, 500, 2000])
                                         for _ in range(B)]
    per_pod[:, w["cols"].index("pods")] = 1
    per_pod[0] = 0  # a padding row: no request at all
    slice_size = np.array([rng.choice([1, 2, 4]) for _ in range(B)],
                          np.int64)
    count = slice_size * np.array([rng.choice([1, 2, 5, 9, 30])
                                   for _ in range(B)], np.int64)
    req_level = np.array([rng.randrange(nl) for _ in range(B)], np.int64)
    slice_level = np.array([rng.randrange(r, nl) for r in req_level],
                           np.int64)
    mode = np.array([rng.randrange(3) for _ in range(B)], np.int64)
    leaf_mask = np.array([[rng.random() > 0.1 for _ in range(M)]
                          for _ in range(B)])
    arrays = (per_pod, count, slice_size, slice_level, req_level, mode,
              leaf_mask)
    kw = dict(num_levels=nl, max_domains=M, pods_col=w["cols"].index("pods"))
    want = jtas.tas_feasibility(
        jnp.asarray(w["free"]), jnp.asarray(w["usage"]),
        *map(jnp.asarray, arrays), jnp.asarray(s["valid"]),
        jnp.asarray(s["parent"]), jnp.asarray(s["has_pods_cap"]), **kw)
    t = w["t"]
    got = ttas.tas_feasibility(t["free"], t["usage"], *map(_t, arrays),
                               t["valid"], t["parent"], t["has_pods_cap"],
                               **kw)
    _same(got, want)


@pytest.mark.parametrize("n_keys", [1, 2, 3, 5])
def test_rank_of_multi_key_ties(n_keys):
    """Divergence trap (f): lax.sort over several keys, stable, vs the
    chain of stable argsorts; every key is full of ties."""
    rng = np.random.default_rng(n_keys)
    M = 512
    keys = [rng.integers(-2, 2, M).astype(np.int64) for _ in range(n_keys)]
    keys[-1][::3] = 7  # a last key tied across a third of the slots
    want = jtas._rank_of(tuple(map(jnp.asarray, keys)), M)
    got = ttas._rank_of(tuple(_t(k)[None] for k in keys))
    _same(tuple(x[0] for x in got), want)


def _empty_segment_forest():
    """Two levels, M = 8: root slots 0 and 1 are valid, but only slot 0
    has children (slots 0-2 of level 1). Slot 1's segments are empty."""
    M, nl = 8, 2
    valid = np.zeros((nl, M), bool)
    valid[0, :2] = True
    valid[1, :3] = True
    parent = np.full((nl, M), -1, np.int64)
    parent[1, :3] = 0
    vrank = np.full((nl, M), 1 << 40, np.int64)
    vrank[0, :2] = [0, 1]
    vrank[1, :3] = [0, 1, 2]
    has_pods_cap = np.zeros(M, bool)
    has_pods_cap[:3] = True
    free = np.zeros((M, 4), np.int64)
    free[:3, 0] = [4000, 2000, 8000]
    free[:3, 1] = [4, 8, 2]
    return dict(valid=valid, parent=parent, vrank=vrank,
                has_pods_cap=has_pods_cap, free=free,
                usage=np.zeros_like(free), m=M, nl=nl)


@pytest.mark.parametrize("has_leader", [False, True],
                         ids=["no_leader", "leader"])
def test_empty_segments_keep_int64_extremes(has_leader):
    """Divergence trap (g): an empty segment_min segment is int64 max and
    an empty segment_max segment int64 min. With a leader, the childless
    root slot's leader state is int64 min in both packages."""
    f = _empty_segment_forest()
    t = carry.tas_structure(f, device="cpu")
    per_pod = np.array([1000, 1, 0, 0], np.int64)
    leader = np.array([500, 1, 0, 0], np.int64)
    mask = f["valid"][1].copy()
    kw = dict(num_levels=2, max_domains=8, pods_col=1, slice_level=1,
              has_leader=has_leader)
    zeros = np.zeros_like(f["free"])
    want = jtas._phase1(*map(jnp.asarray, (
        f["free"], f["usage"], zeros, per_pod, leader, mask,
        f["has_pods_cap"], f["valid"], f["parent"])), 1, **kw)
    got = _port_phase1(t["free"], t["usage"], _t(zeros), _t(per_pod),
                       _t(leader), _t(mask), t["has_pods_cap"], t["valid"],
                       t["parent"], slice_size=1, **kw)
    _same(got, want)
    if has_leader:
        assert int(got[4][0, 1]) == -(1 << 63)
    seg = torch.tensor([0, 0, 2])
    assert ttas._segment_min(torch.tensor([5, 3, 1]), seg, 3).tolist() == \
        [3, (1 << 63) - 1, 1]
    assert ttas._segment_max(torch.tensor([5, 3, 1]), seg, 3).tolist() == \
        [5, -(1 << 63), 1]
    # Over a batch axis, row b's segments are b * nseg + seg: a row's
    # empty segment keeps the identity whatever the other rows hold.
    bseg = torch.tensor([[0, 0, 2], [1, 1, 1]])
    bdata = torch.tensor([[5, 3, 1], [4, 6, 2]])
    assert ttas._bseg_min(bdata, bseg, 3).tolist() == \
        [[3, (1 << 63) - 1, 1], [(1 << 63) - 1, 2, (1 << 63) - 1]]
    assert ttas._bseg_max(bdata, bseg, 3).tolist() == \
        [[5, -(1 << 63), 1], [-(1 << 63), 6, -(1 << 63)]]
    for mode in ("required", "preferred", "unconstrained"):
        pk = dict(num_levels=2, max_domains=8, pods_col=1,
                  req_level=0 if mode != "unconstrained" else 1,
                  slice_level=1, required=mode == "required",
                  unconstrained=mode == "unconstrained",
                  has_leader=has_leader)
        for count in (1, 3, 9):
            want = jax.device_get(jtas.tas_place(*map(jnp.asarray, (
                f["free"], f["usage"], zeros, per_pod, leader, mask,
                f["has_pods_cap"], f["valid"], f["vrank"], f["parent"])),
                np.int64(count), np.int64(1), **pk))
            got = ttas.tas_place(t["free"], t["usage"], _t(zeros),
                                 _t(per_pod), _t(leader), _t(mask),
                                 t["has_pods_cap"], t["valid"], t["vrank"],
                                 t["parent"], count, 1, **pk)
            _same(got, want)


@pytest.mark.parametrize("mode", ["required", "preferred", "unconstrained"])
def test_argmin_ties_pick_the_first(mode):
    """Divergence trap (h): identical leaves tie on every sort key but
    the value rank, and argmin takes the first minimal index in both
    packages."""
    from kueue_tpu.api.types import Topology, TopologyLevel
    from kueue_tpu.tas.snapshot import HOSTNAME_LABEL, Node, \
        TASFlavorSnapshot

    snap = TASFlavorSnapshot(Topology("t", (
        TopologyLevel("rack"), TopologyLevel(HOSTNAME_LABEL))))
    for r in range(3):
        for h in range(3):
            name = f"r{r}-h{h}"
            snap.add_node(Node(name, {"rack": f"r{r}", HOSTNAME_LABEL: name},
                               {"cpu": 4000, "pods": 4}))
    struct = jdevice._structure(snap)
    cols = jdevice._cols_for(struct, {"cpu": 1000, "pods": 1}, {})
    free = jdevice._free_matrix(struct, cols)
    t = carry.tas_structure(dict(struct, free=free,
                                 usage=np.zeros_like(free)), device="cpu")
    per_pod = jdevice._req_vector({"cpu": 1000, "pods": 1}, cols)
    zeros = np.zeros_like(free)
    for count in (1, 4, 5, 12):
        pk = dict(num_levels=2, max_domains=struct["m"],
                  pods_col=cols.index("pods"),
                  req_level=0 if mode != "unconstrained" else 1,
                  slice_level=1, required=mode == "required",
                  unconstrained=mode == "unconstrained", has_leader=False)
        want = jax.device_get(jtas.tas_place(*map(jnp.asarray, (
            free, zeros, zeros, per_pod, np.zeros_like(per_pod),
            struct["valid"][1], struct["has_pods_cap"], struct["valid"],
            struct["vrank"], struct["parent"])), np.int64(count),
            np.int64(1), **pk))
        got = ttas.tas_place(t["free"], t["usage"], _t(zeros), _t(per_pod),
                             _t(np.zeros_like(per_pod)), t["valid"][1],
                             t["has_pods_cap"], t["valid"], t["vrank"],
                             t["parent"], count, 1, **pk)
        _same(got, want)
        if count == 1:
            assert int(np.argmax(_np(got[2]))) == 0  # the first leaf


def test_tas_structure_checks_fields():
    with pytest.raises(ValueError):
        carry.tas_structure({"valid": np.zeros((1, 8), bool)}, device="cpu")
    f = _empty_segment_forest()
    with pytest.raises(ValueError):
        carry.tas_structure(dict(f, nl=3), device="cpu")
