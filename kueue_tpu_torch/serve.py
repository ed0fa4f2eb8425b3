"""The deployable control-plane process: a journal-backed engine, the
HTTP serving endpoint and the scheduling loop, with the oracle
in-process or in a sidecar.

The port of ``kueue_tpu/serve.py``'s ``main`` (cmd/kueue/main.go:126,
the manager main), non-HA branch:

    python -m kueue_tpu_torch.serve --journal PATH [--oracle local|off|HOST:PORT]
        [--http HOST:PORT] [--tick SECONDS] [--device cuda|cpu]
        [--checkpoint-interval N] [--checkpoint-keep N]
        [--segment-records N] [--segment-bytes N] [--min-free-bytes N]
        [--trace [N]] [--watchdog-deadline S] [--watchdog-hang S]
        [--shed-rate R] [--record TRACE] [--fault SPEC]

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
cycles traced, the watchdog's state and demotions and the ladder's rung
and transitions, the
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

Overload and observability, with the JAX package's defaults:
``--trace [N]`` attaches the admission tracer (obs/tracer.py) with a ring
of N cycles (64 when N is absent or below 2): span trees at
``/debug/trace``, one ``cycle_trace`` journal record and event per
traced cycle. ``--watchdog-deadline`` / ``--watchdog-hang`` attach the
cycle watchdog (obs/watchdog.py; either one set turns it on, the other
defaulting to 5x or 1/5 of it), ``--shed-rate`` the SLO engine and the
token-bucket shedder on POST ``/workloads`` (429 past the rate), and the
degradation ladder (ha/ladder.py) is always attached; ``/debug/slo``
shows its rung and the watchdog's breaker. ``/events`` streams the
engine's events.

Record and faults, as the JAX package's serve takes them: ``--record
TRACE`` attaches the flight recorder (replay/recorder.py) with
``bootstrap=True`` once the engine is rebuilt, so the trace starts with
the rebuilt world and replays alone (``replay.replay_trace``); SIGTERM
closes it with its end frame. ``--fault SPEC`` arms a fault plan
(replay/faults.py, e.g. ``sigkill@admission:N``,
``oracle-crash@cycle:N``) after the watchdog and the ladder, since the
``hang`` fault relies on the watchdog's pre-cycle hook stamping the
cycle start first.

The loop and the HTTP handler threads share one lock
(``visibility/http_server.CycleLock``, requests first between cycles): a
submit or a view never runs inside a cycle.

Environment defaults: KUEUE_TPU_JOURNAL, KUEUE_TPU_ORACLE,
KUEUE_TPU_HTTP_ADDR, KUEUE_TPU_TICK_SECONDS, KUEUE_TPU_AUTH_TOKEN (the
bearer token), KUEUE_TPU_CKPT_INTERVAL, KUEUE_TPU_CKPT_KEEP,
KUEUE_TPU_SEGMENT_RECORDS, KUEUE_TPU_SEGMENT_BYTES,
KUEUE_TPU_MIN_FREE_BYTES, KUEUE_TPU_TRACE, KUEUE_TPU_WATCHDOG_DEADLINE,
KUEUE_TPU_WATCHDOG_HANG, KUEUE_TPU_SHED_RATE, KUEUE_TPU_RECORD,
KUEUE_TPU_FAULT, and the bridge's
KUEUE_TPU_ORACLE_RETRIES, KUEUE_TPU_ORACLE_BREAKER_N and
KUEUE_TPU_ORACLE_BREAKER_COOLDOWN.

Not ported: HA (with its uses of the recorder and the fault plan),
federation, read replicas, and ``--fanout-shards``, which only HA mode
reads. Their flags (and the environment variables that set them) exit 2
with a message naming them; none is ignored.
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
    parser.add_argument("--trace", nargs="?", const="on",
                        default=os.environ.get("KUEUE_TPU_TRACE"),
                        help="attach the admission tracer; the value is"
                             " its ring of cycles (default 64)")
    parser.add_argument("--shed-rate", type=float,
                        default=float(os.environ.get(
                            "KUEUE_TPU_SHED_RATE", "0")),
                        help="admission shedder: POST /workloads past R"
                             " a second answers 429 (0 = off)")
    parser.add_argument("--watchdog-deadline", type=float,
                        default=float(os.environ.get(
                            "KUEUE_TPU_WATCHDOG_DEADLINE", "0")),
                        help="cycle watchdog deadline in seconds: slower"
                             " cycles are overruns that feed its breaker"
                             " (0 = off unless --watchdog-hang is set)")
    parser.add_argument("--watchdog-hang", type=float,
                        default=float(os.environ.get(
                            "KUEUE_TPU_WATCHDOG_HANG", "0")),
                        help="hung-cycle threshold in seconds (0 = 5x the"
                             " deadline when the watchdog is on)")
    parser.add_argument("--record",
                        default=os.environ.get("KUEUE_TPU_RECORD"),
                        help="flight-record the engine's inputs and "
                             "decisions into this trace file")
    parser.add_argument("--fault",
                        default=os.environ.get("KUEUE_TPU_FAULT"),
                        help="arm a fault plan (replay/faults.py spec)")
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


def _attach_overload(eng, args) -> None:
    """The cycle watchdog when its flags ask for it, the SLO engine and
    the shedder with ``--shed-rate``, and always the degradation ladder
    (it idles at rung 0 until a trigger fires), as the JAX package's
    serve attaches them."""
    if args.watchdog_deadline > 0 or args.watchdog_hang > 0:
        from kueue_tpu_torch.obs.watchdog import attach_watchdog
        deadline = args.watchdog_deadline or args.watchdog_hang / 5.0
        hang = args.watchdog_hang or deadline * 5.0
        attach_watchdog(eng, deadline_s=deadline, hang_after_s=hang)
    if args.shed_rate > 0 and eng.shedder is None:
        from kueue_tpu_torch.ha.shedder import AdmissionShedder
        from kueue_tpu_torch.obs.slo import attach_slo
        if eng.slo is None:
            attach_slo(eng)
        eng.shedder = AdmissionShedder(
            rate=args.shed_rate, slo=eng.slo, metrics=eng.registry,
            hub=eng.fanout)
    from kueue_tpu_torch.ha.ladder import attach_ladder
    attach_ladder(eng)


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
    _attach_overload(eng, args)
    recorder = None
    if args.record:
        # Bootstrap frames carry the journal-rebuilt world, then every
        # input and cycle is captured: the trace replays alone.
        from kueue_tpu_torch.replay.recorder import FlightRecorder
        recorder = FlightRecorder(eng, args.record, bootstrap=True,
                                  label=f"serve:{args.journal}")
    if args.fault:
        from kueue_tpu_torch.replay.faults import arm_faults
        arm_faults(eng, args.fault)
    if args.trace:
        # The flag's value doubles as the retention ring size;
        # "on"/"true"/"1" keep the default.
        retain = (int(args.trace) if args.trace.isdigit()
                  and int(args.trace) > 1 else 64)
        eng.attach_tracer(retain=retain)

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
    if recorder is not None:
        recorder.close()
    endpoint.stop()
    watchdog = eng.watchdog
    if watchdog is not None:
        watchdog.detach()  # stops its hang sampler thread
    eng.journal.close()
    b = eng.oracle
    loop["journal_sync"] = eng.journal.sync_seconds
    print(json.dumps({
        "heads_launches": heads.launches, "cycle_seq": eng.cycle_seq,
        "cycles_on_device": b.cycles_on_device if b else 0,
        "cycles_fallback": b.cycles_fallback if b else 0,
        "pipeline_stats": dict(b.pipeline_stats) if b else {},
        "cycles_traced": eng.tracer.cycles_traced if eng.tracer else 0,
        "watchdog": {k: watchdog.status()[k] for k in (
            "state", "overruns", "hungCycles", "demotions")}
        if watchdog else None,
        "ladder": {"rung": eng.ladder.rung,
                   "transitions": eng.ladder.transitions},
        "supervisor_state": b.supervisor.state if b else None,
        "checkpoints_written": ckpt.written if ckpt else 0,
        "checkpoint_failures": ckpt.failures if ckpt else 0,
        "checkpoint_write_mean_s": ckpt.write_s_total / ckpt.written
        if ckpt and ckpt.written else 0.0,
        "checkpoint_write_max_s": ckpt.write_s_max if ckpt else 0.0,
        "disk_budget_checks": eng.journal.budget.checks,

        "loop_s": loop}), flush=True)


if __name__ == "__main__":
    main()
