"""What the obs layer costs a serving cycle: one engine run of
``engine_worlds.DEFAULT_ARM["cycle_latency"]`` (1 + 8 cycles at 1,000
ClusterQueues x 50,000 workloads, the default loop) per arm, in turns:

    bare     nothing attached
    traced   the tracer (ring 64), the perf recorder and the SLO engine
    hub      traced, and a fanout hub of 2 shards with one draining
             subscriber (one JSON encode per engine event)
    profiled hub, every cycle inside ``Engine.profiled`` (torch.profiler)

Every run must decide as the first bare run did (its pinned numbers and
pipeline_stats, ``engine_worlds.arm_pinned``). Prints, per arm and
repeat, p50 and p95 seconds of the timed cycles and the mean apply and
finalize phases, then one JSON line with every arm's p50s, and with
``--out`` writes it:

    python3 -m kueue_tpu_torch.bench.obs_overhead [--repeats 2]
        [--out obs_overhead.json]

Runs on CUDA (the default device of the port's kit), raising without it.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from contextlib import contextmanager, nullcontext

from kueue_tpu_torch.bench import engine_worlds as ew
from kueue_tpu_torch.bench import obs_worlds as ow

ARMS = ("bare", "traced", "hub", "profiled")


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


@contextmanager
def _extra(arm: str, eng):
    """The attachments an arm adds beyond the tracer and perf recorder
    (``obs_worlds.attached``)."""
    with (tempfile.TemporaryDirectory(prefix="obs_overhead_")
          if arm == "profiled" else nullcontext()) as tmp:
        with ow.attached(eng, hub=arm in ("hub", "profiled"),
                         profile_dir=tmp):
            yield


def run_arm(arm: str, want=None) -> tuple:
    """One run of the cell on ``arm``: (its p50 / p95 s a cycle and mean
    apply and finalize phases, its pinned numbers), which must equal
    ``want`` when given."""
    config = ew.DEFAULT_ARM["cycle_latency"]
    if arm == "bare":
        r = ew.run(config)
    else:
        r, _probe = ow.run(config, extra=lambda eng: _extra(arm, eng))
    got = ew.arm_pinned(r)
    if want is not None and got != want:
        raise AssertionError(f"{arm}: got {got}, want {want}")
    times = r["cycle_seconds"]
    mean = {ph: sum(p.get(ph, 0.0) for p in r["phases"]) / len(r["phases"])
            for ph in ("apply", "finalize")}
    return dict(arm=arm, p50=_pct(times, 0.5), p95=_pct(times, 0.95),
                **{f"{k}_s": v for k, v in mean.items()}), got


def main(argv=None) -> None:
    import subprocess

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    rows = []
    order = list(ARMS)
    want = None
    for k in range(args.repeats):
        for arm in (order if k % 2 == 0 else order[::-1]):
            row, pinned = run_arm(arm, want)
            want = want or pinned
            rows.append(row)
            print(f"{arm} p50_s={row['p50']:.4f} p95_s={row['p95']:.4f} "
                  f"apply_s={row['apply_s']:.4f} "
                  f"finalize_s={row['finalize_s']:.4f} | {card}",
                  flush=True)
    doc = {"card": card, "rows": rows,
           "p50": {a: [r["p50"] for r in rows if r["arm"] == a]
                   for a in ARMS}}
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)


if __name__ == "__main__":
    main()
