"""The port's host TAS descent (kueue_tpu_torch/tas/snapshot.py
find_topology_assignments_host and the forest lifecycle around it)
against the JAX package's, on the CPU.

``MirroredSnapshot`` is the JAX package's TASFlavorSnapshot with a port
snapshot beside it: every add_node / add_usage / remove_usage is made on
both, and every placement call runs both and asserts equal results.
Patched into tests/test_tas.py and the leader cases of
tests/test_tas_extended.py, it runs their own worlds and requests. The
random worlds of tests/test_tas_device.py (leaders, assumed usage,
simulate-empty and replacement domains included) compare the two host
descents directly, and the port's host descent with its own device
program where that takes the request. Both packages are pinned to the
host path (KUEUE_TPU_DEVICE_TAS_MIN=1000000) unless a test says
otherwise. Exact throughout."""

import copy
import random

import pytest

import test_tas
import test_tas_device as ref
import test_tas_extended
from kueue_tpu.tas import snapshot as jsnapshot
from kueue_tpu_torch import carry
from kueue_tpu_torch.tas import device as pdevice
from kueue_tpu_torch.tas import snapshot as psnapshot
from test_torch_tas_device import plain, port_request, port_snapshot


@pytest.fixture(autouse=True)
def host_path(monkeypatch, tmp_path):
    """Both packages place on the host; both crossover records point at
    an empty directory."""
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "1000000")
    monkeypatch.setenv("KUEUE_TPU_TAS_CALIBRATION",
                       str(tmp_path / "jax.json"))
    monkeypatch.setenv("KUEUE_TPU_TORCH_TAS_CALIBRATION",
                       str(tmp_path / "port.json"))


def _port_req(req):
    if req is None:
        return None
    return psnapshot.TASPodSetRequest(
        carry.api_object(req.pod_set), dict(req.single_pod_requests),
        req.count, previous_assignment=carry.api_object(
            req.previous_assignment))


class MirroredSnapshot(jsnapshot.TASFlavorSnapshot):
    """The JAX package's snapshot driving a port snapshot through the
    same calls; placements are compared call by call."""

    calls = 0

    def __init__(self, topology, flavor_tolerations=()):
        super().__init__(topology, flavor_tolerations)
        self.port = psnapshot.TASFlavorSnapshot(
            carry.api_object(topology),
            carry.api_object(tuple(flavor_tolerations)), device="cpu")

    def add_node(self, node, non_tas_usage=None):
        super().add_node(node, non_tas_usage)
        self.port.add_node(carry.api_object(node), non_tas_usage)

    def add_usage(self, values, requests, count):
        super().add_usage(values, requests, count)
        self.port.add_usage(values, dict(requests), count)

    def remove_usage(self, values, requests, count):
        super().remove_usage(values, requests, count)
        self.port.remove_usage(values, dict(requests), count)

    def find_topology_assignments(self, workers, leader=None,
                                  simulate_empty=False, assumed_usage=None,
                                  required_replacement_domain=()):
        before = copy.deepcopy(assumed_usage)
        want = super().find_topology_assignments(
            workers, leader, simulate_empty, assumed_usage,
            required_replacement_domain)
        got = self.port.find_topology_assignments(
            _port_req(workers), _port_req(leader), simulate_empty, before,
            required_replacement_domain)
        assert plain(got) == plain(want), (workers, leader)
        MirroredSnapshot.calls += 1
        return want

    def find_topology_assignments_for_flavor(self, requests, workload=None,
                                             simulate_empty=False,
                                             assumed_usage=None):
        before = copy.deepcopy(assumed_usage)
        want = super().find_topology_assignments_for_flavor(
            requests, workload, simulate_empty, assumed_usage)
        got = self.port.find_topology_assignments_for_flavor(
            [_port_req(r) for r in requests], carry.api_object(workload),
            simulate_empty, before)
        assert _plain_flavor(got) == _plain_flavor(want)
        return want


def _plain_flavor(out):
    results, reason = out
    return {name: (tuple(ta.levels), tuple((tuple(d.values), d.count)
                                           for d in ta.domains))
            for name, ta in results.items()}, reason


def _run_mirrored(monkeypatch, module, name):
    monkeypatch.setattr(module, "TASFlavorSnapshot", MirroredSnapshot)
    MirroredSnapshot.calls = 0
    getattr(module, name)()
    assert MirroredSnapshot.calls > 0


@pytest.mark.parametrize("name", [
    n for n in dir(test_tas) if n.startswith("test_")])
def test_tas_cases_match(monkeypatch, name):
    _run_mirrored(monkeypatch, test_tas, name)


@pytest.mark.parametrize("name", [
    "test_leader_placed_with_workers",
    "test_group_without_leader_unaffected",
    "test_unconstrained_uses_least_free_capacity",
    "test_leader_descent_when_largest_child_cannot_host_leader",
    "test_leader_descent_infeasible_returns_reason_not_crash"])
def test_extended_leader_cases_match(monkeypatch, name):
    _run_mirrored(monkeypatch, test_tas_extended, name)


def _same_host(jsnap, psnap, jreq, jleader=None, **kw):
    pkw = dict(kw)
    if "assumed_usage" in pkw:
        pkw["assumed_usage"] = copy.deepcopy(pkw["assumed_usage"])
    want = jsnap.find_topology_assignments_host(jreq, jleader, **kw)
    got = psnap.find_topology_assignments_host(
        port_request(jreq), None if jleader is None
        else port_request(jleader), **pkw)
    assert plain(got) == plain(want), (jreq, jleader, kw)
    return got


@pytest.mark.parametrize("seed", range(40))
def test_random_worlds_match(seed):
    """The host descents agree, and the port's device program, where it
    takes the request, agrees with its host descent."""
    rng = random.Random(seed)
    topology = rng.choice([ref.TOPOLOGY3, ref.TOPOLOGY3, ref.TOPOLOGY2,
                           ref.TOPOLOGY1])
    jsnap = ref.random_world(rng, topology)
    jreq = ref.random_request(rng, jsnap)
    psnap = port_snapshot(jsnap)
    got = _same_host(jsnap, psnap, jreq)
    dev = pdevice.try_find(psnap, port_request(jreq))
    if dev is not NotImplemented:
        assert plain(dev) == plain(got)


@pytest.mark.parametrize("seed", range(20))
def test_random_leader_worlds_match(seed):
    rng = random.Random(1000 + seed)
    topology = rng.choice([ref.TOPOLOGY3, ref.TOPOLOGY2])
    jsnap = ref.random_world(rng, topology)
    jreq = ref.random_request(rng, jsnap, name="workers")
    leader_ps = ref.PodSet(name="leader", count=1,
                           topology_request=jreq.pod_set.topology_request)
    jleader = jsnapshot.TASPodSetRequest(
        leader_ps, {"cpu": rng.choice([100, 1000, 4000])}, 1)
    psnap = port_snapshot(jsnap)
    _same_host(jsnap, psnap, jreq, jleader)
    assert pdevice.try_find(psnap, port_request(jreq),
                            port_request(jleader)) is NotImplemented


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
    _same_host(jsnap, psnap, jreq, assumed_usage=assumed)
    _same_host(jsnap, psnap, jreq, simulate_empty=True,
               assumed_usage=assumed)
    _same_host(jsnap, psnap, jreq, simulate_empty=True)


@pytest.mark.parametrize("seed", range(10))
def test_replacement_domain_match(seed):
    rng = random.Random(3000 + seed)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    jreq = ref.random_request(rng, jsnap)
    _same_host(jsnap, port_snapshot(jsnap), jreq,
               required_replacement_domain=rng.choice(sorted(jsnap.roots)))


@pytest.mark.parametrize("seed", range(6))
def test_cycle_lifecycle_and_memos_match(seed):
    """An undo scope per cycle, in-cycle usage adds, write-through
    commits between and inside cycles, and repeated identical requests
    (the placement memo, the phase-1 memo and its repair): every
    placement along the way agrees, and each end_cycle restores the
    committed usage."""
    rng = random.Random(4000 + seed)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    psnap = port_snapshot(jsnap)
    reqs = [ref.random_request(rng, jsnap) for _ in range(3)]
    leaves = sorted(jsnap.leaves)
    for _cycle in range(4):
        for s in (jsnap, psnap):
            s.begin_cycle()
        for _ in range(6):
            jreq = rng.choice(reqs)
            want = jsnap.find_topology_assignments(jreq)
            got = psnap.find_topology_assignments(port_request(jreq))
            assert plain(got) == plain(want)
            if want[0] is not None and rng.random() < 0.5:
                for d in want[0][jreq.pod_set.name].domains:
                    jsnap.add_usage(d.values, jreq.single_pod_requests,
                                    d.count)
                    psnap.add_usage(d.values,
                                    dict(jreq.single_pod_requests), d.count)
            if rng.random() < 0.3:
                values = rng.choice(leaves)
                deltas = {"cpu": rng.choice([-500, 500, 1000]),
                          "pods": rng.choice([-1, 1])}
                jsnap.commit_usage(values, dict(deltas))
                psnap.commit_usage(values, dict(deltas))
        for s in (jsnap, psnap):
            s.end_cycle()
        assert {v: dict(leaf.tas_usage) for v, leaf in psnap.leaves.items()
                } == {v: dict(leaf.tas_usage)
                      for v, leaf in jsnap.leaves.items()}
        assert (psnap._usage_version, psnap._usage_removals) == (
            jsnap._usage_version, jsnap._usage_removals)


def test_fork_shares_the_prototype_encoding(monkeypatch):
    """A fork places like its prototype and remaps the prototype's device
    encoding instead of rebuilding and re-uploading it."""
    monkeypatch.setenv("KUEUE_TPU_DEVICE_TAS_MIN", "0")
    rng = random.Random(77)
    jsnap = ref.random_world(rng, ref.TOPOLOGY3)
    psnap = port_snapshot(jsnap)
    jreq = ref.random_request(rng, jsnap)
    proto = pdevice._structure(psnap)
    fork = psnap.fork()
    struct = pdevice._structure(fork)
    assert struct["tensor_cache"] is proto["tensor_cache"]
    assert struct["valid"] is proto["valid"]
    assert all(fork.domains[d.values] is d
               for d in struct["leaves"])
    assert plain(fork.find_topology_assignments(port_request(jreq))) == \
        plain(psnap.find_topology_assignments(port_request(jreq)))
