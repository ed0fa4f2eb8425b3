"""The batched TAS feasibility launch of the PyTorch port
(kueue_tpu_torch/tas/feasibility.py) vs the JAX package's, on the CPU,
and the TAS world that chip_smoke.py drives on the card.

The feasibility worlds are tests/test_tas_feasibility.py's make_snapshot
and request_of, copied into the port's snapshot. The TAS world of
kueue_tpu_torch/bench/tas_world.py is run through both packages: the
port through find_topology_assignments, the JAX package through its
tas/device.try_find called directly. Exact: verdicts, message
arguments and every checksum."""

import random

import numpy as np
import pytest

import chip_smoke
import test_tas_feasibility as ref
from kueue_tpu.api import types as jtypes
from kueue_tpu.ops import tas as jtas
from kueue_tpu.tas import device as jdevice
from kueue_tpu.tas import feasibility as jfeas
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch.bench import tas_world
from kueue_tpu_torch.tas import feasibility as pfeas
from test_torch_tas_device import port_request, port_snapshot

MODES = [(jtypes.TopologyMode.REQUIRED, "rack"),
         (jtypes.TopologyMode.REQUIRED, "block"),
         (jtypes.TopologyMode.PREFERRED, "rack"),
         (jtypes.TopologyMode.PREFERRED, "block"),
         (jtypes.TopologyMode.UNCONSTRAINED, None)]


def _reqs(feas, snap, requests):
    out = {}
    for tr in requests:
        params = feas._qualify(snap, tr.pod_set, tr.single_pod_requests,
                               tr.count)
        assert params is not None
        sig = feas.request_signature(tr.pod_set, tr.single_pod_requests,
                                     tr.count)
        out[sig] = (tr.single_pod_requests, tr.count, params)
    return out


def assert_same_verdicts(jsnap, jrequests, psnap=None):
    psnap = psnap or port_snapshot(jsnap)
    want = jfeas._launch(jsnap, _reqs(jfeas, jsnap, jrequests))
    got = pfeas._launch(psnap, _reqs(pfeas, psnap,
                                     [port_request(r) for r in jrequests]))
    assert len(got) == len(want)
    assert [tuple(vars(v).values()) for v in got.values()] == \
        [tuple(vars(v).values()) for v in want.values()]
    return got


@pytest.mark.parametrize("seed", range(4))
def test_randomized_verdicts_match(seed):
    rng = random.Random(seed)
    jsnap = ref.make_snapshot(blocks=2, racks=3, hosts=4,
                              ragged=bool(seed % 2))
    for leaf in list(jsnap.leaves.values())[::3]:
        jsnap.add_usage(leaf.values, {"cpu": 1000}, rng.randrange(0, 5))
    requests = []
    for _ in range(24):
        mode, level = rng.choice(MODES)
        requests.append(ref.request_of(
            rng.choice([1, 2, 3, 8, 16, 17, 32, 64, 97, 200]), mode, level,
            cpu=rng.choice([500, 1000, 4000])))
    got = assert_same_verdicts(jsnap, requests)
    assert any(v.fit_used for v in got.values())
    assert not all(v.fit_used for v in got.values())


def test_slices_and_usage_variants_match():
    jsnap = ref.make_snapshot(blocks=1, racks=2, hosts=3, pods=4)
    assert_same_verdicts(jsnap, [
        ref.request_of(24, jtypes.TopologyMode.REQUIRED, "rack",
                       slice_size=2),
        ref.request_of(8, jtypes.TopologyMode.PREFERRED, "block",
                       slice_size=4),
        ref.request_of(6, jtypes.TopologyMode.UNCONSTRAINED, None,
                       slice_size=3)])
    jsnap = ref.make_snapshot(blocks=1, racks=1, hosts=4, pods=8)
    for leaf in jsnap.leaves.values():
        jsnap.add_usage(leaf.values, {}, 6)  # 2 pod slots left each
    got = assert_same_verdicts(jsnap, [ref.request_of(
        16, jtypes.TopologyMode.REQUIRED, "rack")])
    (v,) = got.values()
    assert not v.fit_used and v.fit_empty


def test_node_selector_mask_matches():
    jsnap = ref.make_snapshot()
    ps = jtypes.PodSet("m", 4, {"cpu": 100},
                       node_selector={jsnapshot.HOSTNAME_LABEL: "b0-r0-h0"},
                       topology_request=jtypes.PodSetTopologyRequest(
                           mode=jtypes.TopologyMode.REQUIRED, level="rack"))
    jreq = jsnapshot.TASPodSetRequest(ps, {"cpu": 100}, 4)
    psnap = port_snapshot(jsnap)
    want = jfeas._qualify(jsnap, ps, {"cpu": 100}, 4)
    got = pfeas._qualify(psnap, port_request(jreq).pod_set, {"cpu": 100}, 4)
    assert got == want and got[4]
    assert_same_verdicts(jsnap, [jreq], psnap)


def test_disqualifiers_match():
    jsnap = ref.make_snapshot()
    psnap = port_snapshot(jsnap)
    for kw, count in ((dict(level="rack"), 4),
                      (dict(level="rack", pod_set_group_name="g"), 4),
                      (dict(level="zone"), 4),
                      (dict(level="rack", slice_size=2), 5)):
        ps = jtypes.PodSet("m", count, {"cpu": 100},
                           topology_request=jtypes.PodSetTopologyRequest(
                               mode=jtypes.TopologyMode.REQUIRED, **kw))
        jreq = jsnapshot.TASPodSetRequest(ps, {"cpu": 100}, count)
        want = jfeas._qualify(jsnap, ps, {"cpu": 100}, count)
        got = pfeas._qualify(psnap, port_request(jreq).pod_set,
                             {"cpu": 100}, count)
        assert got == want


def test_parked_verdicts_and_removals():
    jsnap = ref.make_snapshot()
    psnap = port_snapshot(jsnap)
    preq = port_request(ref.request_of(4, jtypes.TopologyMode.REQUIRED,
                                       "rack"))
    assert pfeas.lookup(psnap, preq) is None
    verdicts = pfeas.park(psnap, _reqs(pfeas, psnap, [preq]))
    assert pfeas.lookup(psnap, preq) == next(iter(verdicts.values()))
    assert pfeas.used_valid(psnap)
    leaf = next(iter(psnap.leaves))
    psnap.add_usage(leaf, {"cpu": 100}, 1)
    assert pfeas.used_valid(psnap)   # additions are fine
    psnap.remove_usage(leaf, {"cpu": 100}, 1)
    assert not pfeas.used_valid(psnap)


class JaxBackend:
    """The JAX package's side of tas_world.run: its snapshot, its
    tas/device.try_find called directly, its feasibility launch and its
    leaf_states / bubble_counts."""

    types = jtypes
    snapshot = jsnapshot

    def new_snapshot(self, topology):
        return jsnapshot.TASFlavorSnapshot(topology)

    def find(self, snap, request):
        out = jdevice.try_find(snap, request)
        assert out is not NotImplemented
        return out

    def qualify(self, snap, request):
        ps = request.pod_set
        return (jfeas.request_signature(ps, request.single_pod_requests,
                                        request.count),
                jfeas._qualify(snap, ps, request.single_pod_requests,
                               request.count))

    def feasibility_launch(self, snap, reqs):
        return jfeas._launch(snap, reqs)

    def phase1(self, snap, per_pod):
        enc = jtas.encode_tas_snapshot(snap, tas_world.PHASE1_RESOURCES)
        usage = enc["tas_usage"]
        leaf = jtas.leaf_states(enc["free_capacity"], usage,
                                np.zeros_like(usage),
                                np.asarray(per_pod, np.int64),
                                np.ones(usage.shape[0], bool))
        nl = enc["num_levels"]
        state, slice_state = jtas.bubble_counts(
            leaf, enc["parent_of_level"], enc["max_domains"], 1, nl - 1,
            num_levels=nl)
        return tuple(np.asarray(a) for a in (leaf, state, slice_state))


KEYS = ("requests", "placed", "signatures", "per_pod_vectors",
        "placements", "feasibility_empty", "feasibility_final", "phase1")


def test_reduced_tas_world_matches_jax():
    """The full-width script's generator on a 2 x 4 x 10 forest."""
    want = tas_world.run(JaxBackend(), tas_world.SMALL)
    got = tas_world.run(tas_world.PortBackend("cpu"), tas_world.SMALL)
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert got["requests"] == 440 and got["signatures"] == 21


def test_full_tas_world_checksums_are_the_jax_packages():
    """chip_smoke.py pins the JAX package's outcomes on the 5,120-node
    world; recompute them from the JAX package, and run the port's CPU
    path to the same numbers."""
    want = tas_world.run(JaxBackend(), tas_world.FULL)
    assert {k: want[k] for k in KEYS} == chip_smoke.TAS_EXPECT
    got = tas_world.run(tas_world.PortBackend("cpu"), tas_world.FULL)
    assert {k: got[k] for k in KEYS} == chip_smoke.TAS_EXPECT
    assert 0 < got["device_placements"] <= got["requests"]


def test_request_specs_follow_the_bench_generators():
    specs = tas_world.request_specs(*tas_world.FULL)
    assert len(specs) == 440
    churn, large = specs[:320], specs[320:]
    assert {s.count for s in churn} == {256, 320, 512}
    assert {s.level for s in churn} == {"rack", "block"}
    assert {s.mode for s in churn} == {"Required"}
    assert {s.count for s in large} == {4, 8, 16}
    assert {s.mode for s in large} == {"Required", "Preferred",
                                       "Unconstrained"}
    assert len(tas_world.node_specs(*tas_world.FULL)) == 5120
