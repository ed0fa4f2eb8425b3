"""Where the time of a drain goes on the GPU.

    python -m kueue_tpu_torch.bench.profile_drain [--out FILE]

Builds the full-width baseline-like scenario (1,000 ClusterQueues in 200
cohorts, 50,000 workloads), runs one untimed drain to warm up,
one timed drain, and one drain under torch.profiler. Prints, and writes
as JSON to ``--out``: the timed drain's wall seconds and cycles; the
profiled drain's summed device time, its count of device events
(kernels, copies, fills) and the device's busy share of its wall time;
and the operators with the most device and host time. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kueue_tpu_torch.bench.scenario import baseline_like
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON result file")
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    scen = baseline_like(n_cohorts=200, cqs_per_cohort=5,
                         n_workloads=50_000)
    solver = BatchedDrainSolver(
        build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors, []),
        scen.pending_infos())
    solver.solve()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = solver.solve()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve()
        torch.cuda.synchronize()
        profiled_wall_s = time.perf_counter() - t0
    # Device-side events: kernels, copies and fills.
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in on_device)
    averages = prof.key_averages()

    def top(attr, n=12):
        rows = sorted(averages, key=lambda a: getattr(a, attr),
                      reverse=True)[:n]
        return [dict(name=a.key, count=a.count,
                     self_device_us=a.self_device_time_total,
                     self_cpu_us=a.self_cpu_time_total) for a in rows]

    result = dict(
        card=card, workloads=len(scen.workloads),
        cluster_queues=len(scen.cluster_queues),
        cycles=stats["cycles"], admitted=stats["admitted"],
        wall_s=wall_s, ms_per_cycle=wall_s / stats["cycles"] * 1e3,
        admissions_per_s=stats["admitted"] / wall_s,
        profiled_wall_s=profiled_wall_s,
        device_s=device_us / 1e6, device_events=len(on_device),
        device_events_per_cycle=len(on_device) / stats["cycles"],
        device_busy_share=device_us / 1e6 / profiled_wall_s,
        top_device=top("self_device_time_total"),
        top_cpu=top("self_cpu_time_total"))
    print(json.dumps({k: v for k, v in result.items()
                      if not k.startswith("top_")}))
    for label in ("top_device", "top_cpu"):
        print(label)
        for row in result[label]:
            print(f"  {row['name'][:60]:60s} n={row['count']:7d} "
                  f"dev={row['self_device_us'] / 1e3:9.2f}ms "
                  f"cpu={row['self_cpu_us'] / 1e3:9.2f}ms")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
