"""Where the time of the TAS world goes on the GPU.

    python -m kueue_tpu_torch.bench.profile_tas [--out FILE]

Runs the 5,120-node TAS world of ``bench/tas_world.py`` (440 placements
one by one, two feasibility batches, phase 1 per per-pod vector) once
to warm up, once timed, and once under torch.profiler. Prints, and
writes as JSON to ``--out``: the timed run's seconds per phase and per
device placement; the profiled run's summed device time, its count of
device events (kernels, copies, fills) per device placement and the
device's busy share of its wall time; and the operators with the most
device and host time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kueue_tpu_torch.bench import tas_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON result file")
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    tas_world.run(tas_world.PortBackend(), tas_world.FULL)  # warm-up
    backend = tas_world.PortBackend()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = tas_world.run(backend, tas_world.FULL)
    wall_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = tas_world.run(tas_world.PortBackend(), tas_world.FULL)
        torch.cuda.synchronize()
        profiled_wall_s = time.perf_counter() - t0
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

    n_dev = timed["device_placements"]
    result = dict(
        card=card, requests=timed["requests"], placed=timed["placed"],
        device_placements=n_dev, wall_s=wall_s,
        seconds=timed["seconds"],
        ms_per_try_find=backend.device_seconds / n_dev * 1e3,
        profiled_wall_s=profiled_wall_s,
        device_s=device_us / 1e6, device_events=len(on_device),
        device_events_per_placement=(
            len(on_device) / profiled["device_placements"]),
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
