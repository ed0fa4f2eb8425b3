"""Smoke run of the PyTorch/CUDA port (kueue_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the port from csrc/;
  3. heads kernel vs its plain PyTorch version on the card, exact, over
     a grid of (W, C) shapes including the drain's (50000, 1000) and one
     case of each branch of the kernel (one thread-block cluster, several
     clusters, bins beyond shared memory), plus timings at the drain's
     shape: per call and on the device, with exactly one launch a call;
  4. a 512-workload drain on the card: 18 cycles, 207 admitted,
     decision checksum 0x6a18f8b7;
  5. the full-width drain (1,000 ClusterQueues, 50,000 workloads): 73
     cycles, 49,937 admitted, checksum 0x4eaa40c2, with the heads kernel
     launched once per cycle; then the heads kernel vs its plain version
     on the drain's own first-cycle inputs, exact;
  6. TAS leaf kernel vs its plain PyTorch version on the card, exact,
     over the reference's grid, 300 GiB quantities, counts of 2**31 and
     more, no requested column, every leaf masked, the 5,120-leaf forest,
     65,536 x 8 leaves with wrapping int64 quantities, and each load path
     of the kernel (odd S, S = 1, wide rows of 33 and 70 columns, rows off
     16-byte alignment), plus timings at the forest's shape and at
     65,536 x 8;
  7. device TAS on the 5,120-node forest (kueue_tpu_torch/bench/
     tas_world.py): the feasibility batch over the 21 request signatures
     at the empty forest, 440 placements one by one against live usage,
     the feasibility batch at the final usage, and phase 1 (leaf kernel,
     then the bubble up the tree) per per-pod vector, each against the
     JAX package's checksums, with the leaf kernel launched once per
     per-pod vector;
  8. the fair-sharing drain of hierarchical_fair(n_workloads=40000):
     500 ClusterQueues under 50 roots x 2 mid cohorts, 40,000 workloads,
     49 cycles, 22,816 admitted, checksum 0x4135ace0, with the heads
     kernel launched once per cycle; then the heads kernel vs its plain
     version on the drain's first-cycle inputs, exact;
  9. the preemption world at 1,000 ClusterQueues and 20,000 workloads
     (kueue_tpu_torch/bench/preempt_world.py) through
     TorchExecutor.cycle_step with fused classical preemption: 42
     cycles, 2,824 admissions, 2,313 preempting entries, 3,134 victims,
     no overflow, stream checksum 0xb8e888f4, with the heads kernel
     launched once per cycle; then the heads kernel vs its plain version
     on the world's first-cycle inputs, exact.
The expected decisions are the JAX package's own on the same scenarios
(tests/test_torch_drain.py, tests/test_torch_tas_feasibility.py,
tests/test_torch_fair.py and tests/test_torch_preempt_world.py recompute
them). The last two lines are a JSON summary of the kernels
and the result line. Timing helpers and the shared inputs come from
kueue_tpu_torch/bench/profile_kernels.py, which reports the same
split of each kernel's time in more detail.

Exits non-zero without a result when CUDA is absent. Imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib

import numpy as np

BIG_RANK = 1 << 40
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores

SMALL = dict(n_cohorts=4, cqs_per_cohort=4, n_workloads=512,
             nominal_per_cq=40000, sized_to_fit=False)
SMALL_EXPECT = (18, 207, 0x6a18f8b7)
FULL = dict(n_cohorts=200, cqs_per_cohort=5, n_workloads=50000)
FULL_EXPECT = (73, 49937, 0x4eaa40c2)
# The drain's (50000, 1000) and (W, C) shapes of every branch of the
# kernel: one cluster, 64 KB of bins (8192) and all 227 KB of them
# (29056) in shared memory; several clusters just past one cluster's
# rows (65537) and at 1,000,000 rows; bins beyond shared memory (32768),
# global atomics.
HEADS_SHAPES = [(1, 1), (37, 3), (256, 7), (1000, 130), (5000, 1000),
                (50000, 1000), (50000, 8192), (50000, 29056), (65537, 1000),
                (1000000, 1000), (50000, 32768)]
LEAF_GRID = [(1, 1), (100, 3), (640, 2), (1000, 5)]
LEAF_PATHS = [(5120, 3), (5120, 1), (4096, 33), (4096, 70)]
# The JAX package's fair drain of hierarchical_fair(n_workloads=40000):
# cycles, admitted, crc32 of the decision vectors.
HIER_FAIR_EXPECT = (49, 22816, 0x4135ace0)
# The JAX package's cycles through the preemption world at 1,000
# ClusterQueues (kueue_tpu_torch/bench/preempt_world.py): cycles,
# admissions, preempting entries, victims, overflow slots and the crc32
# of the per-cycle decision stream.
PREEMPT_EXPECT = dict(cycles=42, admitted=2824, preempting=2313,
                      victims=3134, overflow=0, checksum=0xb8e888f4)
# The JAX package's outcomes on the 5,120-node TAS world: placed count
# and the crc32 of the placements, both feasibility batches and phase 1.
TAS_EXPECT = dict(requests=440, placed=189, signatures=21,
                  per_pod_vectors=2, placements=0xe61bb495,
                  feasibility_empty=0x76cebe8a,
                  feasibility_final=0x99e5afa2, phase1=0xe7c953cf)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def checksum(stats) -> int:
    return zlib.crc32(stats["admit_cycle"].tobytes()
                      + stats["admit_pos"].tobytes()
                      + stats["wl_flavor"].tobytes())


def heads_cases():
    """(name, eff_rank int64[W], wl_cq, C) on the host, seeded."""
    for w, c in HEADS_SHAPES:
        rng = np.random.default_rng(w * 1000 + c)
        rank = rng.permutation(w).astype(np.int64)
        cq = rng.integers(0, c, w).astype(np.int32)
        active = rng.random(w) > 0.3
        yield f"grid w={w} c={c}", np.where(active, rank, BIG_RANK), cq, c
    rng = np.random.default_rng(7)
    yield ("all inactive", np.full(4096, BIG_RANK, np.int64),
           rng.integers(0, 64, 4096).astype(np.int32), 64)
    cq = rng.integers(0, 100, 20000).astype(np.int32)
    cq[rng.random(20000) < 0.3] = -1
    yield ("cq=-1 rows", rng.permutation(20000).astype(np.int64), cq, 100)
    yield ("ranks up to BIG_RANK-1",
           BIG_RANK - 1 - rng.integers(0, 5000, 50000).astype(np.int64),
           rng.integers(0, 1000, 50000).astype(np.int32), 1000)
    yield ("int64 cq", rng.permutation(50000).astype(np.int64),
           rng.integers(0, 1000, 50000).astype(np.int64), 1000)


def phase_heads(dev, heads, pk):
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0
    for name, eff, cq, c in heads_cases():
        eff_t = torch.as_tensor(eff, device=dev)
        cq_t = torch.as_tensor(cq, device=dev)
        worst = max(worst, check_heads(heads, name, eff_t, cq_t, c, sms))

    # Timing at the drain's shape: W = 50,000 rows, C = 1,000 bins.
    eff_t, cq_t, C = pk.heads_drain_shape(dev)
    W = eff_t.numel()
    base = torch.full((C + 1,), BIG_RANK, dtype=torch.int64, device=dev)
    idx = torch.where((cq_t >= 0) & (cq_t < C), cq_t, C).long()

    def kernel():
        return heads.select_heads(eff_t, cq_t, C, BIG_RANK)

    kernel_ms = pk.time_ms(kernel)
    plain_ms = pk.time_ms(
        lambda: heads.select_heads_plain(eff_t, cq_t, C, BIG_RANK))
    library_ms = pk.time_ms(
        lambda: base.scatter_reduce(0, idx, eff_t, "amin",
                                    include_self=True))
    kernel_ms_2 = pk.time_ms(kernel)
    prof = pk.device_profile(kernel)
    names = [k["name"] for k in prof["kernels"]]
    if (prof["launches_per_call"] != 1
            or "heads_cluster_kernel" not in names[0]):
        raise AssertionError(f"select_heads made {prof['launches_per_call']}"
                             f" device launches a call at W={W} C={C}, "
                             f"want one heads_cluster_kernel: {names}")
    n_bytes = pk.heads_bytes(eff_t, cq_t, C)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = W / SCALAR_OPS_PER_S * 1e3
    print(f"  heads timing W={W} C={C}: kernel_ms={kernel_ms:.6f} "
          f"(again {kernel_ms_2:.6f}) device_ms={prof['device_ms']:.6f} "
          f"launches_per_call={prof['launches_per_call']:g} "
          f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
          f"bound_ms={max(bytes_ms, ops_ms):.6f} ({n_bytes} bytes)")
    return dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                device_ms=prof["device_ms"],
                launches_per_call=prof["launches_per_call"])


def check_heads(heads, name, eff_t, cq_t, c, sms) -> int:
    """The kernel against the plain version on one input, exact; returns
    the max abs error (0)."""
    import torch

    got = heads.select_heads(eff_t, cq_t, c, BIG_RANK)
    want = heads.select_heads_plain(eff_t, cq_t, c, BIG_RANK)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if c else 0
    if not torch.equal(got, want):
        raise AssertionError(f"heads kernel != plain on {name}: "
                             f"max abs err {err}")
    branch = heads.plan(eff_t.numel(), c, sms)
    print(f"  heads {name}: exact ("
          + ("global atomics" if branch == 0 else
             f"{branch} cluster{'s' if branch > 1 else ''}") + ")")
    return err


def leaf_cases(dev, pk):
    """(name, free, tas, assumed, per_pod, mask) as int64/bool tensors on
    ``dev``, seeded."""
    import torch

    from kueue_tpu_torch.bench import tas_world
    from kueue_tpu_torch.ops import tas as tops

    def on(*arrays):
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)

    for leaves, res in LEAF_GRID:
        rng = np.random.default_rng(leaves * 10 + res)
        yield (f"grid {leaves}x{res}",
               *on(rng.integers(0, 1000, (leaves, res)).astype(np.int64),
                   rng.integers(0, 500, (leaves, res)).astype(np.int64),
                   rng.integers(0, 100, (leaves, res)).astype(np.int64),
                   rng.integers(0, 8, res).astype(np.int64),
                   rng.random(leaves) > 0.2))
    gib = 2**30
    yield ("300 GiB", *on(np.array([[300 * gib]], np.int64),
                          np.array([[200 * gib]], np.int64),
                          np.zeros((1, 1), np.int64),
                          np.array([10 * gib], np.int64),
                          np.array([True])))
    rng = np.random.default_rng(31)
    big = rng.integers(2**31, 2**40, (4096, 2)).astype(np.int64)
    yield ("counts >= 2**31", *on(big, np.zeros_like(big), np.zeros_like(big),
                                  np.array([1, 0], np.int64),
                                  rng.random(4096) > 0.1))
    free = rng.integers(0, 10**6, (512, 3)).astype(np.int64)
    yield ("no requested column", *on(free, np.zeros_like(free),
                                      np.zeros_like(free),
                                      np.array([0, -5, 0], np.int64),
                                      np.ones(512, bool)))
    yield ("all leaves masked", *on(free, np.zeros_like(free),
                                    np.zeros_like(free),
                                    np.array([3, 1, 7], np.int64),
                                    np.zeros(512, bool)))
    snap = pk.forest_snapshot(dev)
    enc = tops.encode_tas_snapshot(snap, tas_world.PHASE1_RESOURCES)
    for cpu in (100, 1000):
        yield (f"forest 5120x2 cpu={cpu}",
               *on(enc["free_capacity"], enc["tas_usage"],
                   np.zeros_like(enc["tas_usage"]),
                   np.array([cpu, 1], np.int64),
                   np.ones(len(enc["free_capacity"]), bool)))
    yield ("65536x8 wrapping int64", *pk.leaf_wide(dev))
    # Each load path of the kernel: odd S and S = 1 (scalar loads), wide
    # rows, odd (33, scalar) and even (70, column pairs), and S = 2 with
    # every row 8 bytes off 16-byte alignment (scalar).
    for leaves, res in LEAF_PATHS:
        yield (f"{leaves}x{res} mixed widths",
               *on(*leaf_mixed(np.random.default_rng(leaves + res), leaves,
                               res)))
    free, tas, assumed, per_pod, mask = on(
        *leaf_mixed(np.random.default_rng(5122), 5120, 2))
    yield ("5120x2 rows off 16-byte alignment",
           *(off_by_one_element(t) for t in (free, tas, assumed)), per_pod,
           mask)


def leaf_mixed(rng, leaves, res):
    """Quantities of the forest's size with a tenth of them past 2**32, a
    few leaves over-used, and per-pod requests of 0, -1 and small values,
    and of 2**33 on column 2 (whose quantities are past 2**34): both the
    32-bit and the 64-bit division."""
    shape = (leaves, res)
    free = rng.integers(10**5, 10**6, shape).astype(np.int64)
    big = rng.random(shape) < 0.1
    free[big] = rng.integers(2**32, 2**40, int(big.sum()))
    tas = rng.integers(0, 10**5, shape).astype(np.int64)
    over = rng.random(shape) < 0.02
    tas[over] = rng.integers(10**6, 2**41, int(over.sum()))
    per_pod = rng.integers(-1, 9, res).astype(np.int64)
    per_pod[0] = max(int(per_pod[0]), 1)
    if res > 2:
        free[:, 2] = rng.integers(2**34, 2**44, leaves)
        per_pod[2] = 2**33
    return (free, tas, rng.integers(0, 100, shape).astype(np.int64),
            per_pod, rng.random(leaves) > 0.2)


def off_by_one_element(t):
    """A contiguous copy of ``t`` whose data starts 8 bytes past a
    16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if not view.is_contiguous() or view.data_ptr() % 16 != 8:
        raise AssertionError("the offset view is not 8 bytes off 16")
    return view


def phase_leaf(dev, leaf, pk):
    import torch

    worst = 0
    forest = None
    for name, free, tas, assumed, per_pod, mask in leaf_cases(dev, pk):
        got = leaf.leaf_fit_counts(free, tas, assumed, per_pod, mask)
        want = leaf.leaf_fit_counts_plain(free, tas, assumed, per_pod, mask)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"leaf kernel != plain on {name}: "
                                 f"max abs err {err}")
        if name == "300 GiB" and got.tolist() != [10]:
            raise AssertionError(f"300 GiB case gave {got.tolist()}, "
                                 f"want [10]")
        if name == "counts >= 2**31" and not bool((got < 0).any()):
            raise AssertionError("no count >= 2**31 reached the int32 "
                                 "conversion")
        if name.startswith("forest") and forest is None:
            forest = (free, tas, assumed, per_pod, mask)
        print(f"  leaf {name}: exact")

    rows = {}
    for shape, args in (("forest", forest), ("65536x8", pk.leaf_wide(dev))):
        L, S = args[0].shape

        def kernel(args=args):
            return leaf.leaf_fit_counts(*args)

        kernel_ms = pk.time_ms(kernel)
        plain_ms = pk.time_ms(lambda: leaf.leaf_fit_counts_plain(*args))
        kernel_ms_2 = pk.time_ms(kernel)
        prof = pk.device_profile(kernel)
        n_bytes = pk.leaf_bytes(args[0])
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        # two subtractions, a division and a minimum per (leaf, column)
        ops_ms = 4 * L * S / SCALAR_OPS_PER_S * 1e3
        launch = [(k["grid"], k["block"]) for k in prof["kernels"]]
        print(f"  leaf timing L={L} S={S}: kernel_ms={kernel_ms:.6f} "
              f"(again {kernel_ms_2:.6f}) device_ms={prof['device_ms']:.6f} "
              f"launches_per_call={prof['launches_per_call']:g} "
              f"grid/block={launch} plain_ms={plain_ms:.6f} "
              f"library_ms=none bound_ms={max(bytes_ms, ops_ms):.6f} "
              f"({n_bytes} bytes)")
        rows[shape] = dict(
            max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            device_ms=prof["device_ms"],
            launches_per_call=prof["launches_per_call"])
    return rows["forest"]


def phase_tas(dev, leaf, card):
    """The 5,120-node TAS world on the card against the JAX package's
    checksums; returns the leaf kernel's launches in it."""
    import torch

    from kueue_tpu_torch.bench import tas_world

    backend = tas_world.PortBackend(dev)
    leaf.launches = 0
    torch.cuda.synchronize()
    got = tas_world.run(backend, tas_world.FULL)
    torch.cuda.synchronize()
    launches = leaf.launches
    for key, want in TAS_EXPECT.items():
        print(f"  {key}: {got[key]:#010x}" if key in (
            "placements", "feasibility_empty", "feasibility_final",
            "phase1") else f"  {key}: {got[key]}")
        if got[key] != want:
            raise AssertionError(f"TAS world {key}: got {got[key]}, want "
                                 f"{want}")
    if launches != TAS_EXPECT["per_pod_vectors"]:
        raise AssertionError(f"leaf kernel launched {launches} times in "
                             f"the TAS run, want "
                             f"{TAS_EXPECT['per_pod_vectors']}")
    sec = got["seconds"]
    n_dev = got["device_placements"]
    print(f"  place: {sec['place']:.3f} s for {got['requests']} requests, "
          f"{n_dev} reached try_find: "
          f"{backend.device_seconds / n_dev * 1e3:.3f} ms per try_find | "
          f"{card}")
    print(f"  feasibility: {sec['feasibility_empty'] * 1e3:.3f} ms "
          f"(empty, first launch) {sec['feasibility_final'] * 1e3:.3f} ms "
          f"(final) per launch of {got['signatures']} signatures | {card}")
    print(f"  phase 1: {sec['phase1'] / got['per_pod_vectors'] * 1e3:.3f} "
          f"ms per call (encode, leaf kernel, bubble) | {card}")
    print(f"  leaf_launches={launches}")
    return launches


def check_launches(heads, label, cycles):
    """The heads kernel must have launched once per cycle of the run
    that just ended."""
    if heads.launches != cycles:
        raise AssertionError(f"{label}: heads kernel launched "
                             f"{heads.launches} times in {cycles} cycles")


def phase_hier_fair(heads, pk, card, sms):
    """The 40,000-workload fair drain against the JAX package's
    decisions; returns the heads kernel's launches in it."""
    import torch

    from kueue_tpu_torch.bench.scenario import hierarchical_fair
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    t0 = time.perf_counter()
    scen = hierarchical_fair(n_workloads=40_000)
    solver = BatchedDrainSolver(
        build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors, []),
        scen.pending_infos(), fair=True)
    encode_s = time.perf_counter() - t0
    heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = heads.launches
    check(stats, HIER_FAIR_EXPECT, "hier_fair 40000 workloads")
    check_launches(heads, "hier_fair", stats["cycles"])
    t0 = time.perf_counter()
    _, again = solver.solve()
    torch.cuda.synchronize()
    solve2_s = time.perf_counter() - t0
    check(again, HIER_FAIR_EXPECT, "hier_fair, second solve")
    eff_t, cq_t, C = pk.drain_first_cycle_heads(solver)
    check_heads(heads, f"hier_fair first cycle w={eff_t.numel()} c={C}",
                eff_t, cq_t, C, sms)
    print(f"  encode_s={encode_s:.3f} solve_s={solve_s:.3f} "
          f"ms_per_cycle={solve_s / stats['cycles'] * 1e3:.3f} "
          f"second solve_s={solve2_s:.3f} "
          f"ms_per_cycle={solve2_s / stats['cycles'] * 1e3:.3f} "
          f"heads_launches={launches} | {card}")
    return launches


def phase_preempt_world(heads, pk, card, sms):
    """The 20,000-workload preemption world through the port's executor
    against the JAX package's decisions; returns the heads kernel's
    launches in it."""
    import torch

    from kueue_tpu_torch.bench import preempt_world
    from kueue_tpu_torch.oracle.service import TorchExecutor

    t0 = time.perf_counter()
    world = preempt_world.build(**preempt_world.FULL)
    build_s = time.perf_counter() - t0
    executor = TorchExecutor()
    heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = preempt_world.run(world, executor.cycle_step)
    solve_s = time.perf_counter() - t0
    launches = heads.launches
    got = {k: stats[k] for k in PREEMPT_EXPECT}
    print(f"  cycles={got['cycles']} admitted={got['admitted']} "
          f"preempting={got['preempting']} victims={got['victims']} "
          f"overflow={got['overflow']} checksum=0x{got['checksum']:08x}")
    if got != PREEMPT_EXPECT:
        raise AssertionError(f"preemption world: got {got}, want "
                             f"{PREEMPT_EXPECT}")
    check_launches(heads, "preemption world", stats["cycles"])
    eff_t, cq_t, C = pk.first_heads_inputs(
        lambda: preempt_world.run(world, executor.cycle_step, max_cycles=1))
    check_heads(heads, f"preemption world first cycle w={eff_t.numel()} "
                f"c={C}", eff_t, cq_t, C, sms)
    print(f"  build_s={build_s:.3f} (fill drain on the card) "
          f"solve_s={solve_s:.3f} "
          f"ms_per_cycle={solve_s / stats['cycles'] * 1e3:.3f} "
          f"heads_launches={launches} | {card}")
    return launches


def drain(scenario_kw, device=None):
    from kueue_tpu_torch.bench.scenario import baseline_like
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    t0 = time.perf_counter()
    scen = baseline_like(**scenario_kw)
    snap = build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                          [])
    solver = BatchedDrainSolver(snap, scen.pending_infos(), device=device)
    return solver, time.perf_counter() - t0


def check(stats, expect, label):
    got = (stats["cycles"], stats["admitted"], checksum(stats))
    print(f"  {label}: cycles={got[0]} admitted={got[1]} "
          f"checksum=0x{got[2]:08x}")
    if got != expect:
        raise AssertionError(
            f"{label}: got cycles/admitted/checksum {got[0]}/{got[1]}/"
            f"0x{got[2]:08x}, want {expect[0]}/{expect[1]}/"
            f"0x{expect[2]:08x}")
    ac = stats["admit_cycle"]
    if ac.dtype != np.int32 or stats["wl_flavor"].dtype != np.int32:
        raise AssertionError(f"{label}: decision arrays must be int32")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kueue_tpu_torch.device import resolve_device
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.bench import profile_kernels as pk
    from kueue_tpu_torch.ops import heads, leaf

    dev = resolve_device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {kind}")

    seconds = _build.build()
    for name, s in seconds.items():
        print(f"[2] build {name}: {s:.2f} s "
              f"({_build.library_path(name).name})")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if "registers" in line or "smem" in line:
                    print(f"    {line.strip()}")

    print("[3] heads kernel vs plain on the card")
    heads_row = phase_heads(dev, heads, pk)

    print("[4] small drain on the card")
    solver, _ = drain(SMALL)
    _, stats = solver.solve()
    check(stats, SMALL_EXPECT, "512 workloads")

    print("[5] full-width drain on the card")
    solver, encode_s = drain(FULL)
    heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = heads.launches
    check(stats, FULL_EXPECT, "50000 workloads")
    if launches != FULL_EXPECT[0]:
        raise AssertionError(f"heads kernel launched {launches} times in "
                             f"the drain, want {FULL_EXPECT[0]}")
    t0 = time.perf_counter()
    _, again = solver.solve()
    torch.cuda.synchronize()
    solve2_s = time.perf_counter() - t0
    check(again, FULL_EXPECT, "50000 workloads, second solve")
    eff_t, cq_t, C = pk.drain_first_cycle_heads(solver)
    check_heads(heads, f"drain first cycle w={eff_t.numel()} c={C}", eff_t,
                cq_t, C, torch.cuda.get_device_properties(dev)
                .multi_processor_count)
    print(f"  encode_s={encode_s:.3f} solve_s={solve_s:.3f} "
          f"admissions_per_s={stats['admitted'] / solve_s:.1f} "
          f"second solve_s={solve2_s:.3f} "
          f"admissions_per_s={stats['admitted'] / solve2_s:.1f} "
          f"heads_launches={launches} | {card}")

    print("[6] leaf kernel vs plain on the card")
    leaf_row = phase_leaf(dev, leaf, pk)

    print("[7] device TAS on the 5,120-node forest")
    leaf_launches = phase_tas(dev, leaf, card)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("[8] hier_fair drain on the card")
    fair_launches = phase_hier_fair(heads, pk, card, sms)

    print("[9] preemption world on the card")
    preempt_launches = phase_preempt_world(heads, pk, card, sms)

    by_path = {"full_width_drain": launches, "hier_fair": fair_launches,
               "preempt_world": preempt_launches}
    print(card)
    print(json.dumps({"kernels": [
        dict(name="heads_segment_min", route="cuda",
             source="kueue_tpu_torch/csrc/heads.cu",
             replaces="kueue_tpu/ops/pallas_kernels.py:83",
             launches=sum(by_path.values()), launches_by_path=by_path,
             **heads_row),
        dict(name="leaf_fit_counts", route="cuda",
             source="kueue_tpu_torch/csrc/leaf.cu",
             replaces="kueue_tpu/ops/pallas_kernels.py:152",
             launches=leaf_launches, **leaf_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
