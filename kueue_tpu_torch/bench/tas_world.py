"""The pod-slice-scale TAS world, as plain specs, and its run.

The forest and the requests of the reference bench's TAS scenarios
(``bench.py``: ``bench_tas_churn`` and ``bench_tas_large``), kept as
plain tuples so that the port and the JAX package build the same world
from them:

  * the forest: topology block / rack / kubernetes.io/hostname, 8 blocks
    x 16 racks x 40 hosts = 5,120 nodes, each with cpu 8000 and pods 8
    (``tas_churn``'s nodes);
  * the requests, 440 in this order: ``tas_churn``'s 320 (seed 11,
    REQUIRED at rack or block, counts one rack of pods less 64, one rack,
    one rack plus 192, cpu 100), then ``tas_large``'s 120 (seed 13,
    REQUIRED, PREFERRED or UNCONSTRAINED at block or rack, counts 4, 8
    or 16, cpu 1000). The generators draw from ``random.Random`` in the
    bench's order, queue picks included, so the same seed gives the
    same requests.

``run`` drives one world through a backend: the feasibility batch over
every request signature at the empty forest, the requests placed one by
one against live usage (each success committed with ``add_usage``, as
the scheduler's assume step does, so the forest fills and later
requests fail), the feasibility batch again at the final usage, and
phase 1 (leaf counts, then the bubble up the tree) once per distinct
per-pod vector at the final usage. Each outcome is folded into a crc32,
so two backends agree when their checksums do.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

HOSTNAME_LABEL = "kubernetes.io/hostname"
LEVELS = ("block", "rack", HOSTNAME_LABEL)
FULL = (8, 16, 40)  # blocks, racks, hosts: 5,120 nodes
SMALL = (2, 4, 10)  # the same generator on 80 nodes
NODE_CPU = 8000
NODE_PODS = 8
PHASE1_RESOURCES = ["cpu", "pods"]


@dataclass(frozen=True)
class NodeSpec:
    name: str
    labels: tuple  # ((label, value), ...)
    capacity: tuple  # ((resource, quantity), ...)


@dataclass(frozen=True)
class RequestSpec:
    name: str
    mode: str  # TopologyMode value: Required | Preferred | Unconstrained
    level: str | None
    count: int
    cpu: int


def node_specs(blocks: int, racks: int, hosts: int) -> list[NodeSpec]:
    out = []
    for b in range(blocks):
        for r in range(racks):
            for h in range(hosts):
                name = f"b{b}-r{r}-h{h}"
                out.append(NodeSpec(
                    name, (("block", f"b{b}"), ("rack", f"b{b}-r{r}"),
                           (HOSTNAME_LABEL, name)),
                    (("cpu", NODE_CPU), ("pods", NODE_PODS))))
    return out


def request_specs(blocks: int, racks: int, hosts: int) -> list[RequestSpec]:
    """tas_churn's 320 requests, then tas_large's 120."""
    del blocks, racks  # the generators read only the rack's pod count
    out = []
    rng = random.Random(11)
    rack_pods = hosts * NODE_PODS
    for i in range(320):
        level = rng.choice(["rack", "block"])
        cnt = rng.choice([rack_pods - 64, rack_pods, rack_pods + 192])
        rng.randrange(32)  # the workload's LocalQueue
        out.append(RequestSpec(f"t-{i}", "Required", level, cnt, 100))
    rng = random.Random(13)
    for i in range(120):
        mode = rng.choice(["Required", "Preferred", "Unconstrained"])
        level = None if mode == "Unconstrained" else \
            rng.choice(["block", "rack"])
        rng.randrange(8)  # the workload's LocalQueue
        cnt = rng.choice([4, 8, 16])
        out.append(RequestSpec(f"tas-{i}", mode, level, cnt, 1000))
    return out


class PortBackend:
    """The port's side of ``run``: its snapshot on ``device``, placement
    through ``find_topology_assignments``, the feasibility launch and
    phase 1 through ``leaf_states`` and ``bubble_counts``."""

    def __init__(self, device=None):
        from kueue_tpu_torch.api import types
        from kueue_tpu_torch.device import resolve_device
        from kueue_tpu_torch.tas import feasibility, snapshot

        self.device = resolve_device(device)
        self.types = types
        self.snapshot = snapshot
        self.feasibility = feasibility
        # Host-clock seconds of the find calls that reached the device
        # program (memo hits excluded).
        self.device_seconds = 0.0

    def new_snapshot(self, topology):
        return self.snapshot.TASFlavorSnapshot(topology, device=self.device)

    def find(self, snap, request):
        before = snap.device_placements
        t0 = time.perf_counter()
        out = snap.find_topology_assignments(request)
        if snap.device_placements != before:
            self.device_seconds += time.perf_counter() - t0
        return out

    def qualify(self, snap, request):
        ps = request.pod_set
        params = self.feasibility._qualify(
            snap, ps, request.single_pod_requests, request.count)
        sig = self.feasibility.request_signature(
            ps, request.single_pod_requests, request.count)
        return sig, params

    def feasibility_launch(self, snap, reqs):
        return self.feasibility.park(snap, reqs)

    def phase1(self, snap, per_pod):
        from kueue_tpu_torch.ops import tas as tops

        enc = tops.encode_tas_snapshot(snap, PHASE1_RESOURCES)
        dev = self.device
        free = torch.as_tensor(enc["free_capacity"], device=dev)
        usage = torch.as_tensor(enc["tas_usage"], device=dev)
        leaf = tops.leaf_states(
            free, usage, torch.zeros_like(usage),
            torch.as_tensor(np.asarray(per_pod, np.int64), device=dev),
            torch.ones(free.shape[0], dtype=torch.bool, device=dev))
        nl = enc["num_levels"]
        state, slice_state = tops.bubble_counts(
            leaf, enc["parent_of_level"], enc["max_domains"], 1, nl - 1,
            num_levels=nl)
        return tuple(t.cpu().numpy() for t in (leaf, state, slice_state))


def build_snapshot(backend, nodes: list[NodeSpec]):
    t = backend.types
    snap = backend.new_snapshot(t.Topology("dc", tuple(
        t.TopologyLevel(label) for label in LEVELS)))
    for spec in nodes:
        snap.add_node(backend.snapshot.Node(
            name=spec.name, labels=dict(spec.labels),
            capacity=dict(spec.capacity)))
    return snap


def make_request(backend, spec: RequestSpec):
    t = backend.types
    single = {"cpu": spec.cpu}
    ps = t.PodSet("main", spec.count, dict(single),
                  topology_request=t.PodSetTopologyRequest(
                      mode=t.TopologyMode(spec.mode), level=spec.level))
    return backend.snapshot.TASPodSetRequest(ps, single, spec.count)


def checksum(records) -> int:
    return zlib.crc32("\n".join(records).encode())


def _verdict_records(firsts: dict, verdicts: dict) -> list[str]:
    return [f"{firsts[sig]}|{v.fit_used}|{v.arg_used}|{v.fit_empty}|"
            f"{v.arg_empty}" for sig, v in verdicts.items()]


def run(backend, dims=FULL) -> dict:
    """Drive the world of ``dims`` (blocks, racks, hosts) through
    ``backend``. Returns the checksums, the counts, and the seconds each
    phase took on the host clock (every backend call returns host
    values, so each call's time includes its device work)."""
    snap = build_snapshot(backend, node_specs(*dims))
    specs = request_specs(*dims)
    requests = [make_request(backend, spec) for spec in specs]

    reqs, firsts = {}, {}
    for spec, request in zip(specs, requests):
        sig, params = backend.qualify(snap, request)
        if params is None:
            raise ValueError(f"{spec.name} does not qualify for the "
                             f"feasibility batch")
        if sig not in reqs:
            reqs[sig] = (request.single_pod_requests, request.count, params)
            firsts[sig] = spec.name

    t0 = time.perf_counter()
    feas_empty = _verdict_records(firsts,
                                  backend.feasibility_launch(snap, reqs))
    feas_empty_s = time.perf_counter() - t0

    records, placed = [], 0
    t0 = time.perf_counter()
    for spec, request in zip(specs, requests):
        got, reason = backend.find(snap, request)
        if got is None:
            records.append(f"{spec.name}|{reason}|")
            continue
        placed += 1
        domains = got[request.pod_set.name].domains
        for d in domains:
            snap.add_usage(d.values, request.single_pod_requests, d.count)
        records.append(f"{spec.name}|ok|" + ";".join(
            "/".join(d.values) + f"={d.count}" for d in domains))
    place_s = time.perf_counter() - t0
    device_placements = getattr(snap, "device_placements", None)

    t0 = time.perf_counter()
    feas_final = _verdict_records(firsts,
                                  backend.feasibility_launch(snap, reqs))
    feas_final_s = time.perf_counter() - t0

    per_pods = list(dict.fromkeys(
        (spec.cpu, 1) for spec in specs))  # (cpu, pods) in first-use order
    crc = 0
    t0 = time.perf_counter()
    for per_pod in per_pods:
        for a in backend.phase1(snap, list(per_pod)):
            crc = zlib.crc32(np.ascontiguousarray(a, np.int32).tobytes(),
                             crc)
    phase1_s = time.perf_counter() - t0
    return {
        "requests": len(specs), "placed": placed,
        "signatures": len(reqs), "per_pod_vectors": len(per_pods),
        "device_placements": device_placements,
        "placements": checksum(records),
        "feasibility_empty": checksum(feas_empty),
        "feasibility_final": checksum(feas_final),
        "phase1": crc,
        "seconds": {"place": place_s, "feasibility_empty": feas_empty_s,
                    "feasibility_final": feas_final_s, "phase1": phase1_s},
    }
