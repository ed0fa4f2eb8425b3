"""Where the time of a drain or of serving-engine cycles goes on the GPU.

    python -m kueue_tpu_torch.bench.profile_drain \
        [--scenario baseline|hier_fair|preempt_world|cycle_latency|
                    fair_cycle_latency|preempt_churn|multiflavor|
                    tas|tas_large|tas_churn|mixed_world|afs_serving]
        [--path device|host] [--out FILE]

Scenarios, all at full width:
  * ``baseline`` (the default): the classical drain of baseline_like,
    1,000 ClusterQueues in 200 cohorts, 50,000 workloads;
  * ``hier_fair``: the fair-sharing drain of hierarchical_fair, 500
    ClusterQueues under 50 roots x 2 mid cohorts, 40,000 workloads;
  * ``preempt_world``: the preemption world of ``bench/preempt_world.py``
    (1,000 ClusterQueues, 20,000 workloads) through
    ``TorchExecutor.cycle_step`` with fused classical preemption, host
    loop included;
  * ``cycle_latency``, ``fair_cycle_latency``, ``preempt_churn``,
    ``multiflavor``: the serving engine's runs of
    ``bench/engine_worlds.py`` (FULL; three of the twelve multi-flavor
    worlds):
    ``Engine.schedule_once`` through the OracleBridge and TorchExecutor,
    per engine cycle. Their device events, host calls and busy share
    count only what starts inside a schedule_once call: the engine's
    build and the churn's submits are outside every number but the top
    operators. These also report p50 / p95 seconds per timed cycle and
    the mean encode / device / apply / finalize phases;
  * ``tas``, ``tas_large``, ``tas_churn``: the TAS engine runs of
    ``bench/tas_engine_worlds.py`` (FULL; ``tas`` cut to its first 120
    cycles of 456, the profiler would hold every event of all), their
    placements pinned to ``--path`` (the device program by default),
    counted like the engine runs above; they also report the
    tas_place_batch calls and the planner's encode / place / decode
    seconds;
  * ``mixed_world``, ``afs_serving``: the runs of
    ``bench/mixed_worlds.py`` (FULL; ``mixed_world`` cut to its first 40
    of 102 calls, for the same reason), counted like the engine runs;
    their phases include ``sim``, the sim nomination's device calls.

Runs one untimed run to warm up, one timed run, and one run under
torch.profiler. Prints, and writes as JSON to ``--out``: the timed
run's wall seconds, cycles and ms per cycle; the profiled run's summed
device time, its device events (kernels, copies, fills) per cycle, the
host's kernel launches, copies and synchronisations per cycle, the heads
kernel's launches, and the device's busy share of its wall time (for
the engine, also ``device_s_outside``: device time outside the
schedule_once calls); and the operators with the most device and host
time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import time

ENGINE_SCENARIOS = ("cycle_latency", "fair_cycle_latency", "preempt_churn",
                    "multiflavor")
# The multi-flavor worlds profiled: the first two Preempt seeds and the
# first TryNextFlavor seed of engine_worlds.FULL's twelve (the profiler
# would hold every event of all 416 cycles).
MULTIFLAVOR_PROFILED = dict(kind="multiflavor", preempt_seeds=2,
                            try_next_seeds=1)
TAS_SCENARIOS = ("tas", "tas_large", "tas_churn")
MIXED_SCENARIOS = ("mixed_world", "afs_serving")
SCENARIOS = ("baseline", "hier_fair", "preempt_world") + ENGINE_SCENARIOS \
    + TAS_SCENARIOS + MIXED_SCENARIOS


def _mixed_run(name):
    """One mixed-world run, counted like _engine_run's."""
    from kueue_tpu_torch.bench import mixed_worlds as mw

    config = mw.FULL[name]
    if name == "mixed_world":
        config = dict(config, max_cycles=40)
    r = mw.run(config)
    r["decided_cycles"] = r["cycles"]
    r["cycles"] = r["calls"]
    r["wall_s"] = r["engine_s"]
    del r["engine"]
    return r


def _tas_run(name, path):
    """One TAS engine run, counted like _engine_run's."""
    from kueue_tpu_torch.bench import tas_engine_worlds as tw

    config = tw.FULL[name]
    if name == "tas":
        config = dict(config, max_cycles=120)
    r = tw.run(config, path)
    r["decided_cycles"] = r["cycles"]
    r["cycles"] = r["calls"]
    r["wall_s"] = r["engine_s"]
    r["preempting"] = 0
    del r["engine"]
    return r


def _engine_run(name):
    """One engine run; returns its stats with ``cycles`` the
    schedule_once calls and ``wall_s`` their wall seconds."""
    from kueue_tpu_torch.bench import engine_worlds as ew

    r = ew.run(MULTIFLAVOR_PROFILED if name == "multiflavor"
               else ew.FULL[name])
    r["decided_cycles"] = r["cycles"]
    r["cycles"] = r["calls"]
    r["wall_s"] = r["engine_s"]
    del r["engines"]
    return r


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


def _count(events, needle) -> int:
    """Calls of the CUDA runtime API on the host whose name holds
    ``needle`` (device events such as "Memcpy DtoD" are not counted)."""
    return sum(1 for e in events
               if e.name.startswith("cuda") and needle in e.name)


def _inside(events, spans):
    """The events that start inside one of ``spans`` (sorted, disjoint
    (start, end) pairs in the profiler's microseconds)."""
    starts = [s for s, _ in spans]

    def hit(e):
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        return i >= 0 and e.time_range.start <= spans[i][1]
    return [e for e in events if hit(e)]


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kueue_tpu_torch.ops import heads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=SCENARIOS, default="baseline")
    ap.add_argument("--path", choices=("device", "host"), default="device",
                    help="TAS placement path of the tas scenarios")
    ap.add_argument("--out", default=None, help="JSON result file")
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    engine = args.scenario in (ENGINE_SCENARIOS + TAS_SCENARIOS
                               + MIXED_SCENARIOS)
    if args.scenario in MIXED_SCENARIOS:
        def run():
            return _mixed_run(args.scenario)
        described = {}
    elif args.scenario in TAS_SCENARIOS:
        def run():
            return _tas_run(args.scenario, args.path)
        described = dict(path=args.path)
    elif engine:
        def run():
            return _engine_run(args.scenario)
        described = {}
    else:
        run, described = _runner(args.scenario)
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run()
    torch.cuda.synchronize()
    wall_s = stats["wall_s"] if engine else time.perf_counter() - t0
    cycles = stats["cycles"]

    heads.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = run()
        torch.cuda.synchronize()
        profiled_wall_s = time.perf_counter() - t0
    if engine:
        profiled_wall_s = profiled["wall_s"]
    heads_launches = heads.launches
    from kueue_tpu_torch.bench.engine_worlds import SPAN

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # Device-side events: kernels, copies and fills. A profiler range
    # also shows on the device's timeline, spanning its kernels: not one.
    all_device = [e for e in prof.events()
                  if e.device_type == cuda and e.name != SPAN]
    events, on_device = prof.events(), all_device
    if engine:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events
                       if e.name == SPAN and e.device_type == cpu)
        events = _inside(events, spans)
        on_device = _inside(all_device, spans)
    device_us = sum(e.device_time_total for e in on_device)
    # Device time outside the schedule_once calls (engine build, submits).
    outside_us = sum(e.device_time_total for e in all_device) - device_us
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
        device_s_outside=outside_us / 1e6,
        device_events_per_cycle=len(on_device) / cycles,
        host_launches_per_cycle=_count(events, "LaunchKernel") / cycles,
        host_copies_per_cycle=_count(events, "Memcpy") / cycles,
        host_syncs_per_cycle=_count(events, "Synchronize") / cycles,
        heads_launches=heads_launches,
        device_busy_share=device_us / 1e6 / profiled_wall_s,
        top_device=top("self_device_time_total"),
        top_cpu=top("self_cpu_time_total"))
    if engine:
        times = sorted(stats["cycle_seconds"])
        result.update(
            decided_cycles=stats["decided_cycles"],
            preempting=stats["preempting"],
            device_cycles=stats["on_device"],
            hybrid_cycles=stats["hybrid"],
            fallback_cycles=stats["fallback"],
            timed_cycles=len(times),
            p50_s=times[len(times) // 2],
            p95_s=times[min(len(times) - 1, int(len(times) * 0.95))],
            mean_phases_s={
                ph: sum(p.get(ph, 0.0) for p in stats["phases"])
                / max(len(stats["phases"]), 1)
                for ph in ("encode", "sim", "device", "apply", "finalize",
                           "tas_place")})
    if args.scenario in TAS_SCENARIOS:
        result.update(batch_calls=stats["batch_calls"],
                      batch_heads=stats["batch_heads"],
                      tas_seconds=stats["tas_seconds"])
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
