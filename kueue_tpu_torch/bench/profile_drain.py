"""Where the time of a drain goes on the GPU.

    python -m kueue_tpu_torch.bench.profile_drain \
        [--scenario baseline|hier_fair|preempt_world] [--out FILE]

Scenarios, all at full width:
  * ``baseline`` (the default): the classical drain of baseline_like,
    1,000 ClusterQueues in 200 cohorts, 50,000 workloads;
  * ``hier_fair``: the fair-sharing drain of hierarchical_fair, 500
    ClusterQueues under 50 roots x 2 mid cohorts, 40,000 workloads;
  * ``preempt_world``: the preemption world of ``bench/preempt_world.py``
    (1,000 ClusterQueues, 20,000 workloads) through
    ``TorchExecutor.cycle_step`` with fused classical preemption, host
    loop included.

Runs one untimed run to warm up, one timed run, and one run under
torch.profiler. Prints, and writes as JSON to ``--out``: the timed
run's wall seconds, cycles and ms per cycle; the profiled run's summed
device time, its device events (kernels, copies, fills) per cycle, the
host's kernel launches, copies and synchronisations per cycle, the heads
kernel's launches, and the device's busy share of its wall time; and the
operators with the most device and host time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

SCENARIOS = ("baseline", "hier_fair", "preempt_world")


def _runner(name):
    """(run() -> stats with cycles and admitted, description)."""
    from kueue_tpu_torch.bench import preempt_world
    from kueue_tpu_torch.bench.scenario import baseline_like, \
        hierarchical_fair
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver
    from kueue_tpu_torch.oracle.service import TorchExecutor

    if name == "preempt_world":
        world = preempt_world.build(**preempt_world.FULL)
        executor = TorchExecutor()
        return (lambda: preempt_world.run(world, executor.cycle_step),
                dict(workloads=world.wls.num_workloads,
                     cluster_queues=world.world.num_cqs))
    if name == "hier_fair":
        scen = hierarchical_fair(n_workloads=40_000)
    else:
        scen = baseline_like(n_cohorts=200, cqs_per_cohort=5,
                             n_workloads=50_000)
    solver = BatchedDrainSolver(
        build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors, []),
        scen.pending_infos(), fair=name == "hier_fair")
    return (lambda: solver.solve()[1],
            dict(workloads=len(scen.workloads),
                 cluster_queues=len(scen.cluster_queues)))


def _count(averages, needle) -> int:
    """Calls of the CUDA runtime API on the host whose name holds
    ``needle`` (device events such as "Memcpy DtoD" are not counted)."""
    return sum(a.count for a in averages
               if a.key.startswith("cuda") and needle in a.key)


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kueue_tpu_torch.ops import heads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=SCENARIOS, default="baseline")
    ap.add_argument("--out", default=None, help="JSON result file")
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    run, described = _runner(args.scenario)
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    cycles = stats["cycles"]

    heads.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_wall_s = time.perf_counter() - t0
    heads_launches = heads.launches
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
        scenario=args.scenario, card=card, **described,
        cycles=cycles, admitted=stats["admitted"],
        wall_s=wall_s, ms_per_cycle=wall_s / cycles * 1e3,
        admissions_per_s=stats["admitted"] / wall_s,
        profiled_wall_s=profiled_wall_s,
        device_s=device_us / 1e6, device_events=len(on_device),
        device_events_per_cycle=len(on_device) / cycles,
        host_launches_per_cycle=_count(averages, "LaunchKernel") / cycles,
        host_copies_per_cycle=_count(averages, "Memcpy") / cycles,
        host_syncs_per_cycle=_count(averages, "Synchronize") / cycles,
        heads_launches=heads_launches,
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
