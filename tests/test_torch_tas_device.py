"""Device TAS placement in the PyTorch port (kueue_tpu_torch/tas/device.py
-> ops/tas.tas_place) vs the JAX package's tas/device.try_find, called
directly as tests/test_tas_device.py's assert_same calls it, on the CPU.

The worlds and requests are the reference suite's own (random_world,
random_request), built with the JAX package and copied into the port's
snapshot leaf by leaf. Exact: the same assignments (leaf values and pod
counts) and the same failure strings, character for character."""

import random

import numpy as np
import pytest
import torch

import test_tas_device as ref
from test_torch_drain import to_port
from kueue_tpu.api import types as jtypes
from kueue_tpu.tas import device as jdevice
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.cache.queues import scheduling_hash
from kueue_tpu_torch.tas import snapshot as psnapshot
from kueue_tpu_torch.tensor import schema
from kueue_tpu_torch.workload_info import WorkloadInfo


def port_snapshot(jsnap):
    """The port's snapshot of the same forest, capacities, taints and
    usage as a JAX package TASFlavorSnapshot, on the CPU."""
    topology = ptypes.Topology(jsnap.topology_name, tuple(
        ptypes.TopologyLevel(k) for k in jsnap.level_keys))
    snap = psnapshot.TASFlavorSnapshot(
        topology, to_port(tuple(jsnap.flavor_tolerations)), device="cpu")
    for values, leaf in jsnap.leaves.items():
        snap.add_node(psnapshot.Node(
            name=leaf.node_name, labels=dict(leaf.node_labels),
            capacity=dict(leaf.free_capacity),
            taints=to_port(tuple(leaf.node_taints))))
        if leaf.tas_usage:
            snap._apply_deltas(snap.leaves[values], dict(leaf.tas_usage))
    return snap


def port_request(jreq):
    return psnapshot.TASPodSetRequest(
        to_port(jreq.pod_set), dict(jreq.single_pod_requests), jreq.count)


def plain(out):
    """(assignments as {name: (levels, ((values, count), ...))}, reason)
    for either package's result."""
    got, reason = out
    if got is None:
        return None, reason
    return {name: (tuple(ta.levels),
                   tuple((tuple(d.values), d.count) for d in ta.domains))
            for name, ta in got.items()}, reason


def assert_same(jsnap, jreq, psnap=None, **kw):
    want = jdevice.try_find(jsnap, jreq, None, **kw)
    assert want is not NotImplemented
    psnap = psnap or port_snapshot(jsnap)
    got = psnap.find_topology_assignments(port_request(jreq), None, **kw)
    assert plain(got) == plain(want), (jreq, kw)
    return plain(got)


@pytest.mark.parametrize("seed", range(40))
def test_random_worlds_match(seed):
    rng = random.Random(seed)
    topology = rng.choice([ref.TOPOLOGY3, ref.TOPOLOGY3, ref.TOPOLOGY2,
                           ref.TOPOLOGY1])
    jsnap = ref.random_world(rng, topology)
    assert_same(jsnap, ref.random_request(rng, jsnap))


@pytest.mark.parametrize("seed", range(10))
def test_assumed_usage_and_simulate_empty_match(seed):
    rng = random.Random(2000 + seed)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    jreq = ref.random_request(rng, jsnap)
    assumed = {}
    for leaf in list(jsnap.leaves.values()):
        if rng.random() < 0.4:
            assumed[leaf.id] = {"cpu": rng.randrange(0, 2000),
                                "pods": rng.randrange(0, 3)}
    psnap = port_snapshot(jsnap)
    assert_same(jsnap, jreq, psnap, assumed_usage=dict(assumed))
    assert_same(jsnap, jreq, psnap, simulate_empty=True,
                assumed_usage=dict(assumed))
    assert_same(jsnap, jreq, psnap, simulate_empty=True)


@pytest.mark.parametrize("seed", range(10))
def test_replacement_domain_match(seed):
    rng = random.Random(3000 + seed)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    jreq = ref.random_request(rng, jsnap)
    assert_same(jsnap, jreq,
                required_replacement_domain=rng.choice(sorted(jsnap.roots)))


def test_stale_usage_resource_ignored():
    jsnap = jsnapshot.TASFlavorSnapshot(ref.TOPOLOGY2)
    jsnap.add_node(jsnapshot.Node(
        name="h0", labels={"rack": "r0", jsnapshot.HOSTNAME_LABEL: "h0"},
        capacity={"cpu": 4000}))
    jsnap.add_usage(("r0", "h0"), {"gpu": 1}, 1)
    ps = jtypes.PodSet(name="main", count=2,
                       topology_request=jtypes.PodSetTopologyRequest(
                           mode=jtypes.TopologyMode.REQUIRED, level="rack"))
    assert_same(jsnap, jsnapshot.TASPodSetRequest(ps, {"cpu": 1000}, 2))


def test_taints_tolerations_and_affinity_messages():
    """Tainted nodes, a toleration, a flavor toleration and an affinity
    term: the not-fit message's exclusion tail is identical."""
    taint = jtypes.Taint("gpu", "true", "NoSchedule")
    jsnap = jsnapshot.TASFlavorSnapshot(
        ref.TOPOLOGY3, (jtypes.Toleration("maint", "Exists"),))
    rng = random.Random(17)
    for b in range(2):
        for r in range(3):
            for h in range(4):
                name = f"b{b}-r{r}-h{h}"
                taints = ()
                if h == 0:
                    taints = (taint,)
                elif h == 1:
                    taints = (jtypes.Taint("maint", "", "NoExecute"),)
                jsnap.add_node(jsnapshot.Node(
                    name=name,
                    labels={"block": f"b{b}", "rack": f"b{b}-r{r}",
                            "zone": f"z{r % 2}",
                            jsnapshot.HOSTNAME_LABEL: name},
                    capacity={"cpu": rng.choice([1000, 4000]), "pods": 4},
                    taints=taints))
    cases = [
        dict(),
        dict(tolerations=(jtypes.Toleration("gpu", "Equal", "true"),)),
        dict(node_affinity=((("zone", "In", ("z0",)),),)),
        dict(node_selector={"block": "b1"}),
    ]
    for kw in cases:
        for count, mode, level in ((6, jtypes.TopologyMode.REQUIRED, "rack"),
                                   (40, jtypes.TopologyMode.PREFERRED,
                                    "block"),
                                   (90, jtypes.TopologyMode.UNCONSTRAINED,
                                    None)):
            ps = jtypes.PodSet(
                "main", count, {"cpu": 1000},
                topology_request=jtypes.PodSetTopologyRequest(
                    mode=mode, level=level), **kw)
            assert_same(jsnap, jsnapshot.TASPodSetRequest(
                ps, {"cpu": 1000}, count))


def test_usage_changes_are_seen():
    """Placement after add_usage reads the new usage: the device usage
    cache is keyed on the usage version, as the reference's is."""
    rng = random.Random(41)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    psnap = port_snapshot(jsnap)
    ps = jtypes.PodSet("main", 3, {"cpu": 1000},
                       topology_request=jtypes.PodSetTopologyRequest(
                           mode=jtypes.TopologyMode.REQUIRED, level="rack"))
    jreq = jsnapshot.TASPodSetRequest(ps, {"cpu": 1000}, 3)
    for _ in range(100):
        got, reason = assert_same(jsnap, jreq, psnap)
        if got is None:
            break
        for values, count in got["main"][1]:
            jsnap.add_usage(values, {"cpu": 1000}, count)
            psnap.add_usage(values, {"cpu": 1000}, count)
    else:
        pytest.fail("the forest never filled")


@pytest.mark.parametrize("seed", range(4))
def test_leader_requests_raise(seed):
    rng = random.Random(1000 + seed)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    jreq = ref.random_request(rng, jsnap, name="workers")
    leader_ps = jtypes.PodSet(name="leader", count=1,
                              topology_request=jreq.pod_set.topology_request)
    jleader = jsnapshot.TASPodSetRequest(leader_ps, {"cpu": 100}, 1)
    assert jdevice.try_find(jsnap, jreq, jleader) is NotImplemented
    psnap = port_snapshot(jsnap)
    with pytest.raises(NotImplementedError):
        psnap.find_topology_assignments(port_request(jreq),
                                        port_request(jleader))


def test_unported_corners_raise():
    jsnap = ref.random_world(random.Random(5), ref.TOPOLOGY3)
    psnap = port_snapshot(jsnap)
    multi = ptypes.PodSet("main", 8, {"cpu": 100},
                          topology_request=ptypes.PodSetTopologyRequest(
                              mode=ptypes.TopologyMode.REQUIRED,
                              level="block",
                              slice_constraints=(("rack", 4),
                                                 (jsnapshot.HOSTNAME_LABEL,
                                                  2))))
    with pytest.raises(NotImplementedError):
        psnap.find_topology_assignments(
            psnapshot.TASPodSetRequest(multi, {"cpu": 100}, 8))
    elastic = psnapshot.TASPodSetRequest(
        ptypes.PodSet("main", 2, {"cpu": 100}), {"cpu": 100}, 2,
        previous_assignment=psnapshot.TopologyAssignment((), ()))
    with pytest.raises(NotImplementedError):
        psnap.find_topology_assignments(elastic)


def test_resolution_failures_match():
    """Requests the resolver rejects give the reference's reason."""
    jsnap = ref.random_world(random.Random(8), ref.TOPOLOGY3)
    for tr, count in (
            (jtypes.PodSetTopologyRequest(mode=jtypes.TopologyMode.REQUIRED,
                                          level="zone"), 4),
            (jtypes.PodSetTopologyRequest(mode=jtypes.TopologyMode.REQUIRED,
                                          level="rack", slice_size=3), 4),
            (jtypes.PodSetTopologyRequest(
                mode=jtypes.TopologyMode.REQUIRED,
                level=jsnapshot.HOSTNAME_LABEL, slice_size=2,
                slice_level="rack"), 4)):
        ps = jtypes.PodSet("main", count, {"cpu": 100}, topology_request=tr)
        _, reason = assert_same(jsnap, jsnapshot.TASPodSetRequest(
            ps, {"cpu": 100}, count))
        assert reason


def test_snapshot_defaults_to_cuda():
    topology = ptypes.Topology("t", (ptypes.TopologyLevel("rack"),))
    if torch.cuda.is_available():
        assert psnapshot.TASFlavorSnapshot(topology).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            psnapshot.TASFlavorSnapshot(topology)


def test_topology_request_leaves_dense_drain_path():
    """A pod set with a topology request is not decided by the dense
    drain (the drain ignores topology), and it hashes apart from the
    same pod set without one, as in the JAX package."""
    tr = ptypes.PodSetTopologyRequest(mode=ptypes.TopologyMode.REQUIRED,
                                      level="rack")
    plain_wl = ptypes.Workload("a", queue_name="lq", pod_sets=(
        ptypes.PodSet("main", 2, {"cpu": 100}),))
    tas_wl = ptypes.Workload("b", queue_name="lq", pod_sets=(
        ptypes.PodSet("main", 2, {"cpu": 100}, topology_request=tr),))
    assert schema.dense_path_eligible(WorkloadInfo.from_workload(plain_wl))
    assert not schema.dense_path_eligible(WorkloadInfo.from_workload(tas_wl))
    assert scheduling_hash(plain_wl, "cq") != scheduling_hash(tas_wl, "cq")

    from kueue_tpu.cache.queues import scheduling_hash as j_hash
    from kueue_tpu.tensor.schema import dense_path_eligible as j_elig
    from kueue_tpu.workload_info import WorkloadInfo as JWorkloadInfo

    j_tas = jtypes.Workload("b", queue_name="lq", pod_sets=(
        jtypes.PodSet("main", 2, {"cpu": 100},
                      topology_request=jtypes.PodSetTopologyRequest(
                          mode=jtypes.TopologyMode.REQUIRED,
                          level="rack")),))
    assert not j_elig(JWorkloadInfo.from_workload(j_tas))
    assert repr(j_hash(j_tas, "cq")) == repr(scheduling_hash(tas_wl, "cq"))


def test_exclusion_stats_on_a_large_forest_match():
    """At 256 leaves and more the stats take the dense path
    (_np_resource_exclusions); the messages stay identical."""
    from test_tas_feasibility import make_snapshot

    jsnap = make_snapshot(blocks=4, racks=8, hosts=10, cpu=4000, pods=8)
    leaves = list(jsnap.leaves.values())
    rng = random.Random(3)
    for leaf in leaves[::2]:
        jsnap.add_usage(leaf.values, {"cpu": 1000 * rng.randrange(0, 5)},
                        rng.randrange(0, 9))
    psnap = port_snapshot(jsnap)
    for count in (40, 200, 1000):
        ps = jtypes.PodSet("main", count, {"cpu": 1000},
                           topology_request=jtypes.PodSetTopologyRequest(
                               mode=jtypes.TopologyMode.REQUIRED,
                               level="rack"))
        assert_same(jsnap, jsnapshot.TASPodSetRequest(
            ps, {"cpu": 1000}, count), psnap)
    assert np.all(psnap._device_struct["valid"][-1][:len(leaves)])
