"""The deployable control-plane process: a journal-backed engine, the
HTTP serving endpoint and the scheduling loop, with the oracle
in-process or in a sidecar.

The port of ``kueue_tpu/serve.py``'s ``main`` (cmd/kueue/main.go:126,
the manager main), non-HA branch:

    python -m kueue_tpu_torch.serve --journal PATH [--oracle local|off|HOST:PORT]
        [--http HOST:PORT] [--tick SECONDS] [--device cuda|cpu]
        [--checkpoint-interval N] [--checkpoint-keep N]
        [--segment-records N] [--segment-bytes N] [--min-free-bytes N]

It rebuilds the engine from ``--journal`` (store/journal.rebuild_engine:
the newest valid checkpoint plus the journal suffix past it, or a replay
from the first record when there is none), attaches the oracle
(``local``: a TorchExecutor in this process; ``HOST:PORT``: the sidecar
``python -m kueue_tpu_torch.oracle.service``; ``off``: host cycles
only), prints ``rebuilt N records (B bytes) in S s source=checkpoint|
genesis base=N suffix=N`` and then ``... serving on HOST:PORT ...``,
and loops ``schedule_once`` then ``tick`` (the engine clock follows the
wall clock), sleeping ``--tick`` seconds after an idle cycle. SIGTERM or
SIGINT ends the loop; the process prints one JSON line (its heads
kernel launches, cycle counts, the bridge's ``pipeline_stats``, the
checkpoints written and failed with the mean and maximum seconds of a
write, the disk budget's free-space checks, and the wall seconds of its
loop: in ``schedule_once``, of them in the journal's cycle-boundary
sync, in ``tick``, waiting for the lock and asleep) and exits 0. The engine's
metrics registry feeds ``/metrics`` and, through the bridge, the
oracle supervisor's breaker families; the cycle loop runs the bridge's
speculation pipeline and the columnar apply unless
``KUEUE_TPU_PIPELINE=0`` or ``KUEUE_TPU_COLUMNAR=0``. ``--device``
is where this process's engine and in-process programs run: CUDA unless
``cpu`` is asked for.

Bounded-time recovery, with the JAX package's defaults (all off):
``--segment-records`` / ``--segment-bytes`` seal the active journal file
into segments at a cycle boundary, ``--checkpoint-interval`` attaches a
``store/checkpoint.Checkpointer`` that writes a sealed checkpoint every N
non-idle cycles, keeps ``--checkpoint-keep`` of them and deletes the
segments they cover, and ``--min-free-bytes`` sets the disk budget: below
it the journal turns read-only, POST ``/workloads`` answers 503 and the
loop parks (also on a ``JournalDegraded`` raised mid-cycle) until space
returns.

The loop and the HTTP handler threads share one lock
(``visibility/http_server.CycleLock``, requests first between cycles): a
submit or a view never runs inside a cycle.

Environment defaults: KUEUE_TPU_JOURNAL, KUEUE_TPU_ORACLE,
KUEUE_TPU_HTTP_ADDR, KUEUE_TPU_TICK_SECONDS, KUEUE_TPU_AUTH_TOKEN (the
bearer token), KUEUE_TPU_CKPT_INTERVAL, KUEUE_TPU_CKPT_KEEP,
KUEUE_TPU_SEGMENT_RECORDS, KUEUE_TPU_SEGMENT_BYTES,
KUEUE_TPU_MIN_FREE_BYTES, and the bridge's KUEUE_TPU_ORACLE_RETRIES,
KUEUE_TPU_ORACLE_BREAKER_N and KUEUE_TPU_ORACLE_BREAKER_COOLDOWN.

Not ported: HA, federation, read replicas, the flight recorder, fault
injection, tracing, the cycle watchdog and the shedder. Their flags
(and the environment variables that set them) exit 2 with a message
naming them; none is ignored.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

# Flags of the JAX package's serve.py this port does not implement, with
# the environment variables that set them.
NOT_PORTED = {
    "--ha": "KUEUE_TPU_HA",
    "--federate": "KUEUE_TPU_FEDERATE",
    "--read-replica": "KUEUE_TPU_READ_REPLICA",
    "--replica-id": "KUEUE_TPU_REPLICA_ID",
    "--lease": "KUEUE_TPU_LEASE",
    "--lease-duration": "KUEUE_TPU_LEASE_DURATION",
    "--fanout-shards": "KUEUE_TPU_FANOUT_SHARDS",
    "--record": "KUEUE_TPU_RECORD",
    "--fault": "KUEUE_TPU_FAULT",
    "--trace": "KUEUE_TPU_TRACE",
    "--watchdog-deadline": "KUEUE_TPU_WATCHDOG_DEADLINE",
    "--watchdog-hang": "KUEUE_TPU_WATCHDOG_HANG",
    "--shed-rate": "KUEUE_TPU_SHED_RATE",
}

# Bounded-time recovery and the disk budget, as the JAX package's
# serve.py takes them: (flag, environment variable, default, help).
_RECOVERY_FLAGS = (
    ("--checkpoint-interval", "KUEUE_TPU_CKPT_INTERVAL", "0",
     "write a sealed checkpoint every N non-idle cycles (0 = off); a "
     "restart then boots from checkpoint + journal suffix"),
    ("--checkpoint-keep", "KUEUE_TPU_CKPT_KEEP", "2",
     "how many sealed checkpoints to keep"),
    ("--segment-records", "KUEUE_TPU_SEGMENT_RECORDS", "0",
     "seal the journal's active file every N records (0 = off)"),
    ("--segment-bytes", "KUEUE_TPU_SEGMENT_BYTES", "0",
     "seal the journal's active file past N bytes (0 = off)"),
    ("--min-free-bytes", "KUEUE_TPU_MIN_FREE_BYTES", "0",
     "disk budget: below N free bytes the journal turns read-only, "
     "submits answer 503 and cycles park, until space returns (0 = off)"),
)


def _parse(argv):
    import argparse

    parser = argparse.ArgumentParser(
        description="kueue_tpu_torch control plane (engine + serving "
                    "endpoint)")
    parser.add_argument("--journal",
                        default=os.environ.get("KUEUE_TPU_JOURNAL",
                                               "kueue-journal.jsonl"))
    parser.add_argument("--oracle",
                        default=os.environ.get("KUEUE_TPU_ORACLE", "local"),
                        help='"local", "off" or HOST:PORT of a sidecar')
    parser.add_argument("--http",
                        default=os.environ.get("KUEUE_TPU_HTTP_ADDR",
                                               "0.0.0.0:8080"))
    parser.add_argument("--tick", type=float,
                        default=float(os.environ.get(
                            "KUEUE_TPU_TICK_SECONDS", "0.25")))
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without CUDA) or cpu")
    for flag, env, default, text in _RECOVERY_FLAGS:
        parser.add_argument(flag, type=int,
                            default=int(os.environ.get(env, default)),
                            help=text)
    for flag in NOT_PORTED:
        parser.add_argument(flag, nargs="?", const="", default=None,
                            help="not ported (exits 2)")
    args = parser.parse_args(argv)
    given = [flag for flag in NOT_PORTED
             if getattr(args, flag[2:].replace("-", "_")) is not None]
    given += [env for env in NOT_PORTED.values()
              if os.environ.get(env, "") not in ("", "0")]
    if given:
        print("kueue_tpu_torch.serve: not ported: " + ", ".join(given),
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    return args


def boot(args):
    """The engine rebuilt from ``args.journal`` (checkpoint + suffix
    when there is a valid checkpoint) with the journal's rotation and
    disk budget set from the flags, and the Checkpointer when
    ``--checkpoint-interval`` is above 0 (else None)."""
    from kueue_tpu_torch.store.checkpoint import Checkpointer
    from kueue_tpu_torch.store.journal import rebuild_engine

    eng = rebuild_engine(
        args.journal, device=args.device,
        journal_kwargs={"rotate_records": args.segment_records,
                        "rotate_bytes": args.segment_bytes,
                        "min_free_bytes": args.min_free_bytes})
    ckpt = None
    if args.checkpoint_interval > 0:
        ckpt = Checkpointer(eng, interval=args.checkpoint_interval,
                            keep=args.checkpoint_keep,
                            min_free_bytes=args.min_free_bytes)
    return eng, ckpt


def main(argv=None) -> None:
    args = _parse(argv)

    from kueue_tpu_torch.ops import heads
    from kueue_tpu_torch.store.journal import JournalDegraded
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint

    t0 = time.perf_counter()
    eng, ckpt = boot(args)
    rebuild_s = time.perf_counter() - t0
    print(f"rebuilt {eng.rebuild_records} records "
          f"({os.path.getsize(args.journal)} bytes) in {rebuild_s:.3f} s "
          f"source={eng.rebuild_source} base={eng.rebuild_base_records} "
          f"suffix={eng.rebuild_suffix_records}", flush=True)
    if args.oracle == "local":
        eng.attach_oracle()
    elif args.oracle != "off":
        host, _, port = args.oracle.rpartition(":")
        eng.attach_oracle(remote_address=(host or "127.0.0.1", int(port)))

    host, _, port = args.http.rpartition(":")
    endpoint = ServingEndpoint(
        eng, host=host or "0.0.0.0", port=int(port),
        auth_token=os.environ.get("KUEUE_TPU_AUTH_TOKEN"))
    endpoint.start()
    print(f"kueue-tpu-torch engine serving on {host or '0.0.0.0'}:"
          f"{endpoint.port} (journal={args.journal}, "
          f"oracle={args.oracle}, device={eng.device or 'cuda'})",
          flush=True)

    stop = {"flag": False}

    def _stop(*_a):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    # The wait.UntilWithBackoff loop (scheduler.go:207): schedule while
    # fruitful, idle-tick otherwise; the engine clock follows the wall
    # clock.
    loop = dict.fromkeys(("schedule_once", "tick", "lock_wait", "sleep"),
                         0.0)
    while not stop["flag"]:
        t0 = time.monotonic()
        with endpoint.lock.cycle():
            t1 = time.monotonic()
            try:
                result = eng.schedule_once()
            except JournalDegraded as e:
                # An ENOSPC raced past the cycle's writable() gate: park
                # as idle; the next gate re-arms once space returns.
                print(f"journal degraded, parking: {e}", flush=True)
                result = None
            t2 = time.monotonic()
            eng.tick(t2 - t0 + args.tick if result is None else t2 - t0)
            t3 = time.monotonic()
        loop["lock_wait"] += t1 - t0
        loop["schedule_once"] += t2 - t1
        loop["tick"] += t3 - t2
        if result is None:
            time.sleep(args.tick)
            loop["sleep"] += time.monotonic() - t3
    endpoint.stop()
    eng.journal.close()
    b = eng.oracle
    loop["journal_sync"] = eng.journal.sync_seconds
    print(json.dumps({
        "heads_launches": heads.launches, "cycle_seq": eng.cycle_seq,
        "cycles_on_device": b.cycles_on_device if b else 0,
        "cycles_fallback": b.cycles_fallback if b else 0,
        "pipeline_stats": dict(b.pipeline_stats) if b else {},
        "checkpoints_written": ckpt.written if ckpt else 0,
        "checkpoint_failures": ckpt.failures if ckpt else 0,
        "checkpoint_write_mean_s": ckpt.write_s_total / ckpt.written
        if ckpt and ckpt.written else 0.0,
        "checkpoint_write_max_s": ckpt.write_s_max if ckpt else 0.0,
        "disk_budget_checks": eng.journal.budget.checks,
        "loop_s": loop}), flush=True)


if __name__ == "__main__":
    main()
