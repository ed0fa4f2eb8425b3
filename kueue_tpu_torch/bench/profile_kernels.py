"""Host and device time of each hand-written kernel at its main-path shape.

    python -m kueue_tpu_torch.bench.profile_kernels [--out FILE] [--sweep]

For every case below, and for each way of computing it (the kernel's
wrapper, its plain PyTorch version and, for heads, one PyTorch library
call), it reports:

  * ``ms``: the per-call time as ``time_ms`` gives it (CUDA events around
    50 back-to-back calls, median of 21), twice, so that the two
    repetitions give the spread;
  * ``host_ms``: the host clock around 50 calls, before the synchronise,
    per call (median of 21): what the wrapper's dispatch costs the host;
  * ``device_ms`` and ``launches_per_call``: torch.profiler over 50
    calls, every device event of the window (kernels, fills, memsets,
    copies) summed and counted per call, with each kernel's name, time
    per launch and launch configuration (grid and block, from the
    trace);
  * ``bound_ms``: the bytes the function must move over the card's
    memory rate.

Cases: heads at the drain's shape (W = 50,000 rows, C = 1,000 bins,
seeded as ``chip_smoke.py`` phase 3 times it) and on the full-width
drain's own first-cycle ``eff_rank``/``wl_cq``, captured from
``BatchedDrainSolver``; leaf at the 5,120-leaf forest (S = 2) and at
65,536 x 8 leaves, the byte-bound shape of ``chip_smoke.py`` phase 6.
Prints one line per (case, way) and the card's name and power limit,
and writes everything as JSON to ``--out``. With ``--sweep`` it also
launches the heads kernel directly at C = 1,000 for each row count of
``SWEEP_ROWS`` and cluster count of ``SWEEP_CLUSTERS``, exact against the
plain version, and reports per-call and device time of each: the
measurement behind ``ops/heads.ROWS_PER_CLUSTER`` and
``MAX_CLUSTERS``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

BIG_RANK = 1 << 40
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FULL_DRAIN = dict(n_cohorts=200, cqs_per_cohort=5, n_workloads=50000)
SWEEP_ROWS = (50000, 131072, 262144, 524288, 1000000)
SWEEP_CLUSTERS = (1, 2, 4, 8, 16)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int = 21, inner: int = 50) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` calls each,
    per call, after a warm-up."""
    import torch

    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def host_ms(fn, reps: int = 21, inner: int = 50) -> float:
    """Median over ``reps`` host-clock timings of ``inner`` calls each,
    per call, taken before the synchronise: the host's side of a call."""
    import torch

    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        samples.append((time.perf_counter() - t0) * 1e3 / inner)
        torch.cuda.synchronize()
    return statistics.median(samples)


def _launch_configs(prof) -> dict:
    """{kernel name: (grid, block)} from the profiler's chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return {e["name"]: (e["args"].get("grid"), e["args"].get("block"))
            for e in events
            if e.get("cat") == "kernel" and "args" in e}


def _profile_window(fn, calls: int):
    """{device event name: [count, µs]} and the launch configurations of
    one torch.profiler window over ``calls`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.device_time_total
    return by_name, _launch_configs(prof)


def device_profile(fn, calls: int = 50, windows: int = 3) -> dict:
    """Every device event of ``calls`` calls of ``fn`` under
    torch.profiler, after a warm-up: device time and launches per call,
    and per kernel name its launches per call, device µs per launch and
    launch configuration. The profiler on the H100 misses device events
    now and then (from one in 50 to more than half of a window), so the
    window is taken ``windows`` times and the one that recorded the most
    events is kept; a call launches a whole number of each of its
    kernels, so each kernel's launches per call are rounded
    (``recorded_per_call`` keeps the raw ratio) and its time per launch
    is the mean over the launches that were recorded."""
    import torch

    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    by_name, configs = max(
        (_profile_window(fn, calls) for _ in range(windows)),
        key=lambda window: sum(n for n, _ in window[0].values()))
    kernels = [dict(name=name, per_call=round(n / calls),
                    recorded_per_call=n / calls, us_per_launch=us / n,
                    grid=configs.get(name, (None, None))[0],
                    block=configs.get(name, (None, None))[1])
               for name, (n, us) in sorted(by_name.items())]
    return dict(
        device_ms=sum(k["per_call"] * k["us_per_launch"]
                      for k in kernels) / 1e3,
        launches_per_call=sum(k["per_call"] for k in kernels),
        kernels=kernels)


def measure(fn) -> dict:
    """Per-call time twice, host time and the device profile of ``fn``."""
    return dict(ms=time_ms(fn), ms_again=time_ms(fn), host_ms=host_ms(fn),
                **device_profile(fn))


def first_heads_inputs(run):
    """(eff_rank, wl_cq, num_cqs) of the first ``select_heads`` call that
    ``run()`` makes through the cycle, cloned."""
    from kueue_tpu_torch.oracle import batched

    captured = []
    original = batched.hops.select_heads

    def capture(eff_rank, wl_cq, num_cqs, big_rank):
        if not captured:
            captured.append((eff_rank.clone(), wl_cq.clone(), num_cqs))
        return original(eff_rank, wl_cq, num_cqs, big_rank)

    batched.hops.select_heads = capture
    try:
        run()
    finally:
        batched.hops.select_heads = original
    return captured[0]


def drain_first_cycle_heads(solver):
    """(eff_rank, wl_cq, num_cqs) that the first cycle of
    ``solver.solve()`` hands to ``select_heads``, cloned."""
    return first_heads_inputs(lambda: solver.solve(max_cycles=1))


def full_drain_solver(device=None):
    from kueue_tpu_torch.bench.scenario import baseline_like
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    scen = baseline_like(**FULL_DRAIN)
    snap = build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                          [])
    return BatchedDrainSolver(snap, scen.pending_infos(), device=device)


def forest_snapshot(dev, seed=5120):
    """The 5,120-node forest with seeded TAS usage on half its leaves."""
    import random

    from kueue_tpu_torch.bench import tas_world

    snap = tas_world.build_snapshot(tas_world.PortBackend(dev),
                                    tas_world.node_specs(*tas_world.FULL))
    rng = random.Random(seed)
    for values in list(snap.leaves):
        if rng.random() < 0.5:
            snap.add_usage(values, {"cpu": rng.randrange(0, 6000)},
                           rng.randrange(0, 8))
    return snap


def heads_drain_shape(dev):
    """chip_smoke.py's timing input: W = 50,000, C = 1,000, seeded."""
    import torch

    rng = np.random.default_rng(50000 * 1000 + 1000)
    W, C = 50000, 1000
    eff = np.where(rng.random(W) > 0.3, rng.permutation(W), BIG_RANK)
    return (torch.as_tensor(eff.astype(np.int64), device=dev),
            torch.as_tensor(rng.integers(0, C, W).astype(np.int32),
                            device=dev), C)


def leaf_forest(dev, cpu=100):
    """The forest's phase-1 inputs at S = 2 for a per-pod cpu request."""
    import torch

    from kueue_tpu_torch.bench import tas_world
    from kueue_tpu_torch.ops import tas as tops

    enc = tops.encode_tas_snapshot(forest_snapshot(dev),
                                   tas_world.PHASE1_RESOURCES)
    L = len(enc["free_capacity"])
    return tuple(torch.as_tensor(a, device=dev) for a in (
        enc["free_capacity"], enc["tas_usage"],
        np.zeros_like(enc["tas_usage"]), np.array([cpu, 1], np.int64),
        np.ones(L, bool)))


def leaf_wide(dev):
    """65,536 x 8 leaves with quantities over the whole int64 range."""
    import torch

    rng = np.random.default_rng(65536)
    shape = (65536, 8)
    free = rng.integers(-2**62, 2**62, shape).astype(np.int64)
    free[::7] = np.iinfo(np.int64).min + rng.integers(0, 100, (1, 8))
    tas = rng.integers(-2**62, 2**62, shape).astype(np.int64)
    assumed = rng.integers(0, 2**40, shape).astype(np.int64)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        free, tas, assumed,
        np.array([1, 0, 3, 2**33, -1, 7, 2**20, 5], np.int64),
        rng.random(65536) > 0.05))


def heads_bytes(eff_rank, wl_cq, num_cqs: int) -> int:
    return eff_rank.numel() * (8 + wl_cq.element_size()) + num_cqs * 8


def leaf_bytes(free) -> int:
    L, S = free.shape
    return 3 * L * S * 8 + S * 8 + L * 1 + L * 4


def heads_rows(eff_rank, wl_cq, num_cqs: int) -> dict:
    import torch

    from kueue_tpu_torch.ops import heads

    C = num_cqs
    base = eff_rank.new_full((C + 1,), BIG_RANK)
    idx = torch.where((wl_cq >= 0) & (wl_cq < C), wl_cq, C).long()
    return dict(
        kernel=measure(
            lambda: heads.select_heads(eff_rank, wl_cq, C, BIG_RANK)),
        plain=measure(
            lambda: heads.select_heads_plain(eff_rank, wl_cq, C, BIG_RANK)),
        library=measure(
            lambda: base.scatter_reduce(0, idx, eff_rank, "amin",
                                        include_self=True)))


def leaf_rows(args) -> dict:
    from kueue_tpu_torch.ops import leaf

    return dict(kernel=measure(lambda: leaf.leaf_fit_counts(*args)),
                plain=measure(lambda: leaf.leaf_fit_counts_plain(*args)))


def heads_cluster_sweep(dev, num_cqs: int = 1000) -> list:
    """Per-call and device time of the heads kernel launched with each
    cluster count of ``SWEEP_CLUSTERS`` at each row count of
    ``SWEEP_ROWS``, every result exact against the plain version."""
    import torch

    from kueue_tpu_torch.ops import _build, heads

    C = num_cqs
    rows = []
    for w in SWEEP_ROWS:
        rng = np.random.default_rng(w)
        eff = torch.as_tensor(rng.permutation(w).astype(np.int64),
                              device=dev)
        cq = torch.as_tensor(rng.integers(0, C, w).astype(np.int32),
                             device=dev)
        want = heads.select_heads_plain(eff, cq, C, BIG_RANK)
        for k in SWEEP_CLUSTERS:
            out = torch.empty(C, dtype=torch.int64, device=dev)
            scratch = torch.empty((k, C), dtype=torch.int64, device=dev)

            def call(w=w, k=k, out=out, scratch=scratch):
                _build.launch("heads", eff.device, eff.data_ptr(),
                              cq.data_ptr(), 4, w, C, BIG_RANK, k,
                              scratch.data_ptr(), out.data_ptr())

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"heads kernel != plain at W={w} "
                                     f"with {k} clusters")
            rows.append(dict(rows=w, clusters=k, ms=time_ms(call),
                             device_ms=device_profile(call)["device_ms"]))
            print(f"  sweep W={w} clusters={k}: ms={rows[-1]['ms']:.6f} "
                  f"device_ms={rows[-1]['device_ms']:.6f}")
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON result file")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep the heads kernel's cluster count")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: CUDA is not available")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    props = torch.cuda.get_device_properties(dev)
    result = dict(card=card, kind=props.name, sms=props.multi_processor_count,
                  torch=torch.__version__, cuda=torch.version.cuda, cases={})

    drain_inputs = drain_first_cycle_heads(full_drain_solver(dev))
    heads_cases = {"heads W=50000 C=1000": heads_drain_shape(dev),
                   "heads drain first cycle": drain_inputs}
    for name, (eff, cq, C) in heads_cases.items():
        result["cases"][name] = dict(
            shape=[eff.numel(), C], bytes=heads_bytes(eff, cq, C),
            bound_ms=heads_bytes(eff, cq, C) / HBM_BYTES_PER_S * 1e3,
            **heads_rows(eff, cq, C))
    for name, inputs in (("leaf forest 5120x2", leaf_forest(dev)),
                         ("leaf 65536x8", leaf_wide(dev))):
        result["cases"][name] = dict(
            shape=list(inputs[0].shape), bytes=leaf_bytes(inputs[0]),
            bound_ms=leaf_bytes(inputs[0]) / HBM_BYTES_PER_S * 1e3,
            **leaf_rows(inputs))

    print(f"{card} | {props.multi_processor_count} SMs | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    for name, case in result["cases"].items():
        print(f"{name}: shape={case['shape']} bound_ms={case['bound_ms']:.6f}")
        for way in ("kernel", "plain", "library"):
            if way not in case:
                continue
            row = case[way]
            print(f"  {way:7s} ms={row['ms']:.6f} again={row['ms_again']:.6f}"
                  f" host_ms={row['host_ms']:.6f} "
                  f"device_ms={row['device_ms']:.6f} "
                  f"launches_per_call={row['launches_per_call']:g}")
            for k in row["kernels"]:
                print(f"    {k['per_call']}x (recorded "
                      f"{k['recorded_per_call']:g}x) "
                      f"{k['us_per_launch']:.3f} us "
                      f"grid={k['grid']} block={k['block']} "
                      f"{k['name'][:90]}")
    if args.sweep:
        print(f"heads cluster sweep, C=1000 | {card}")
        result["sweep"] = heads_cluster_sweep(dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
