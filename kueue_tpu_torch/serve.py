"""The deployable control-plane process: a journal-backed engine, the
HTTP serving endpoint and the scheduling loop, with the oracle
in-process or in a sidecar.

The port of ``kueue_tpu/serve.py`` (cmd/kueue/main.go:126, the manager
main), its ``_main_ha`` and ``_main_read_replica`` included:

    python -m kueue_tpu_torch.serve --journal PATH [--oracle local|off|HOST:PORT]
        [--http HOST:PORT] [--tick SECONDS] [--device cuda|cpu]
        [--checkpoint-interval N] [--checkpoint-keep N]
        [--segment-records N] [--segment-bytes N] [--min-free-bytes N]
        [--trace [N]] [--watchdog-deadline S] [--watchdog-hang S]
        [--shed-rate R] [--record TRACE] [--fault SPEC]
        [--ha [--replica-id ID] [--lease PATH] [--lease-duration S]
         [--fanout-shards N] | --read-replica [--replica-id ID]]

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
KUEUE_TPU_FAULT, KUEUE_TPU_HA, KUEUE_TPU_READ_REPLICA,
KUEUE_TPU_REPLICA_ID, KUEUE_TPU_LEASE, KUEUE_TPU_LEASE_DURATION,
KUEUE_TPU_FANOUT_SHARDS, and the bridge's
KUEUE_TPU_ORACLE_RETRIES, KUEUE_TPU_ORACLE_BREAKER_N and
KUEUE_TPU_ORACLE_BREAKER_COOLDOWN.

HA mode (``--ha``, with ``--replica-id``, ``--lease`` (default
JOURNAL.lease), ``--lease-duration`` (5 s) and ``--fanout-shards`` (4)):
the process is one of several sharing the journal. It starts as a
follower (``ha/tailer.JournalTailer``'s read model serves GETs at once)
and tries the fenced lease (``ha/lease.py``) every tick; the winner
replays the journal, proves digest identity with the last ``ha_digest``
checkpoint (``ha/digest.verify_promotion``), attaches a fenced writable
journal and leads: the oracle, the SLO engine, ``--trace``, the overload
tools, ``--record`` and ``--fault`` attach to the promoted engine
(``lease-stall`` reaches its ``ha`` slot). It prints ``... serving on
HOST:PORT ...``, ``ha: replica=ID lease=PATH duration=Ds``, then
``ha: role=ROLE epoch=N`` at each role change and, at promotion, ``ha:
promoted epoch=N acquired_at=T replay_s=S verify_s=S reason=...``. A
renewal thread renews the lease every third of its duration; a refused
renewal, or a journal append refused by the fence, fences the replica
for good. POST ``/workloads`` goes through the replica (503 off the
leader). SIGTERM resigns the lease and prints one JSON line: the role
and epoch, the heads launches, the cycles, ``pipeline_stats``, the
promotion report and its timing, the tailer's rebuilds and the loop's
seconds.

Read-replica mode (``--read-replica``, with ``--replica-id`` and
``--fanout-shards``): ``readplane/replica.ReadReplica`` tails the journal
and serves ``/read/*``, ``/debug/readplane``, its own ``/metrics`` and
``/events``; every POST answers 403. It prints ``... read replica
serving on HOST:PORT ...`` and ``readplane: replica=ID journal=PATH``;
SIGTERM prints one JSON line with its queries, rebuilds, tail position,
admitted-state digest and the sha256 of its ``canonical_answer``.

Not ported: federation (``--federate``, and ``KUEUE_TPU_FEDERATE``),
which exits 2 with a message naming it; it is not ignored.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

# Flags of the JAX package's serve.py this port does not implement, with
# the environment variables that set them: federation (ROADMAP Queue 1
# item 7).
NOT_PORTED = {
    "--federate": "KUEUE_TPU_FEDERATE",
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
    parser.add_argument("--ha", action="store_true",
                        default=os.environ.get("KUEUE_TPU_HA") == "1",
                        help="HA replica: share --journal with others, "
                             "elect a leader through the --lease file")
    parser.add_argument("--read-replica", action="store_true",
                        default=os.environ.get(
                            "KUEUE_TPU_READ_REPLICA") == "1",
                        help="read replica: tail --journal and answer "
                             "staleness-stamped /read/* queries; never "
                             "write, never lead")
    parser.add_argument("--replica-id",
                        default=os.environ.get("KUEUE_TPU_REPLICA_ID"),
                        help="this replica's identity (default host-pid)")
    parser.add_argument("--lease",
                        default=os.environ.get("KUEUE_TPU_LEASE"),
                        help="the HA lease file (default JOURNAL.lease)")
    parser.add_argument("--lease-duration", type=float,
                        default=float(os.environ.get(
                            "KUEUE_TPU_LEASE_DURATION", "5.0")),
                        help="seconds a lease lives unrenewed")
    parser.add_argument("--fanout-shards", type=int,
                        default=int(os.environ.get(
                            "KUEUE_TPU_FANOUT_SHARDS", "4")),
                        help="dispatcher threads of the /events hub of "
                             "an HA or read replica")
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
    if args.read_replica:
        _main_read_replica(args)
        return
    if args.ha:
        _main_ha(args)
        return

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
    _oracle(eng, args)
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

    stop = _stop_flag()

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


def _stop_flag() -> dict:
    """{"flag": False}, set to True by SIGTERM or SIGINT."""
    stop = {"flag": False}

    def _stop(*_a):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    return stop


class _RebuildGC:
    """The GC posture of a process whose loop rebuilds a read model over
    and over (an HA follower, a read replica), after the serving
    engine's (``Engine.apply_serving_gc_posture``): automatic collection
    off and the heap frozen, so a rebuild allocating hundreds of
    thousands of objects never starts a full collection over millions.
    Each loop iteration sweeps the young generation and each rebuild
    freezes the new read model; what the replaced read models left (an
    engine dropped leaves ~20 cyclic objects per workload) is collected
    in one full collection once the tail is quiet (nothing new, nothing
    unfolded: its answers miss nothing meanwhile), or after ``every``
    rebuilds without a quiet poll. (At 50,000 workloads a read model
    holds ~2 million tracked objects, a full collection seconds of the
    loop, which age the replica's answers.)"""

    every = 2

    def __init__(self):
        import gc

        self.seen = 0
        self.owed = 0
        gc.collect()
        gc.freeze()
        gc.disable()

    def after_poll(self, tailer) -> None:
        """After one loop iteration over ``tailer``."""
        import gc

        gc.collect(0)
        quiet = tailer.rebuilds == self.seen and tailer.replay_lag == 0
        if tailer.rebuilds != self.seen:
            self.owed += tailer.rebuilds - self.seen
            self.seen = tailer.rebuilds
            gc.freeze()
        if self.owed and (quiet or self.owed >= self.every):
            gc.unfreeze()
            gc.collect()
            gc.freeze()
            self.owed = 0

    @staticmethod
    def release(eng) -> None:
        """Automatic collection back on, unless ``eng`` took the serving
        posture (an attached oracle does)."""
        import gc

        if not eng._serving_gc:
            gc.unfreeze()
            gc.enable()


def _oracle(eng, args) -> None:
    if args.oracle == "local":
        eng.attach_oracle()
    elif args.oracle != "off":
        host, _, port = args.oracle.rpartition(":")
        eng.attach_oracle(remote_address=(host or "127.0.0.1", int(port)))


def _main_ha(args) -> None:
    """HA replica mode: one of the processes sharing ``--journal`` and
    ``--lease``. It starts as a follower (reads and /events at once);
    winning the lease runs the replay-verified promotion before the
    first write, and the promoted engine gets the oracle, the SLO
    engine, the tracer, the overload tools, the recorder and the fault
    plan. The endpoint resolves the engine per request, since promotion
    swaps it. The loop holds the cycle lock around a leader's cycles
    (and around ``on_promote``), never while it follows."""
    from kueue_tpu_torch.device import resolve_device
    from kueue_tpu_torch.ha.replica import HAReplica
    from kueue_tpu_torch.ha.shedder import AdmissionShedder
    from kueue_tpu_torch.obs.slo import attach_slo
    from kueue_tpu_torch.ops import heads
    from kueue_tpu_torch.store.journal import JournalDegraded, JournalFenced
    from kueue_tpu_torch.visibility.fanout import FanoutHub
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint

    resolve_device(args.device)
    posture = _RebuildGC()
    identity = args.replica_id or f"{os.uname().nodename}-{os.getpid()}"
    lease_path = args.lease or args.journal + ".lease"
    hub = FanoutHub(shards=args.fanout_shards)
    shedder = (AdmissionShedder(rate=args.shed_rate, hub=hub)
               if args.shed_rate > 0 else None)
    held = {}

    def on_promote(eng, replica) -> None:
        # Requests wait while the promoted engine is being equipped.
        with held["endpoint"].lock.cycle():
            _oracle(eng, args)
            _RebuildGC.release(eng)
            attach_slo(eng)
            if shedder is not None:
                shedder.slo = eng.slo
                shedder.metrics = eng.registry
                eng.shedder = shedder
            hub.metrics = eng.registry
            replica.tailer.metrics = eng.registry
            replica.metrics = eng.registry
            if args.trace:
                retain = (int(args.trace) if args.trace.isdigit()
                          and int(args.trace) > 1 else 64)
                eng.attach_tracer(retain=retain)
            _attach_overload(eng, args)
            if args.record:
                from kueue_tpu_torch.replay.recorder import FlightRecorder
                held["recorder"] = FlightRecorder(
                    eng, args.record, bootstrap=True,
                    label=f"serve-ha:{identity}")
            if args.fault:
                # The fault plan reaches engine.ha (lease-stall), which
                # the promotion has set.
                from kueue_tpu_torch.replay.faults import arm_faults
                arm_faults(eng, args.fault)

    replica = HAReplica(
        args.journal, lease_path, identity,
        lease_duration=args.lease_duration,
        hub=hub, shedder=shedder, on_promote=on_promote,
        checkpoint_interval=args.checkpoint_interval,
        checkpoint_keep=args.checkpoint_keep,
        segment_rotate_records=args.segment_records or None,
        segment_rotate_bytes=args.segment_bytes or None,
        min_free_bytes=args.min_free_bytes,
        engine_kwargs={"device": args.device})

    host, _, port = args.http.rpartition(":")
    endpoint = held["endpoint"] = ServingEndpoint(
        replica.engine_ref, host=host or "0.0.0.0", port=int(port),
        auth_token=os.environ.get("KUEUE_TPU_AUTH_TOKEN"),
        hub=hub, replica=replica)
    endpoint.start()
    print(f"kueue-tpu-torch engine serving on {host or '0.0.0.0'}:"
          f"{endpoint.port} (journal={args.journal}, "
          f"oracle={args.oracle}, device={args.device or 'cuda'})",
          flush=True)
    print(f"ha: replica={identity} lease={lease_path} "
          f"duration={args.lease_duration}s", flush=True)

    stop = _stop_flag()
    loop = dict.fromkeys(("schedule_once", "tick", "lock_wait", "sleep",
                          "follow"), 0.0)
    announced = "follower"
    while not stop["flag"]:
        t0 = time.monotonic()
        role = replica.step(time.time())
        if role != announced:
            announced = role
            print(f"ha: role={role} epoch={replica.epoch}", flush=True)
            if role == "leader" and replica.promotion_timing:
                t = replica.promotion_timing
                print(f"ha: promoted epoch={replica.epoch} acquired_at="
                      f"{t['acquired_at']:.6f} replay_s={t['replay_s']:.6f} "
                      f"verify_s={t['verify_s']:.6f} reason="
                      f"{replica.promotion_report['reason']}", flush=True)
        if role != "leader":
            posture.after_poll(replica.tailer)
            loop["follow"] += time.monotonic() - t0
            time.sleep(args.tick)
            continue
        # Once: the renewal thread can fence (and clear) replica.engine
        # between two ticks.
        eng = replica.engine
        if eng is None:
            continue
        t0 = time.monotonic()
        try:
            with endpoint.lock.cycle():
                t1 = time.monotonic()
                result = eng.schedule_once()
                t2 = time.monotonic()
                eng.tick(t2 - t0 + args.tick if result is None
                         else t2 - t0)
                t3 = time.monotonic()
        except JournalFenced as e:
            replica._fence(f"journal fence tripped: {e}")
            continue
        except JournalDegraded as e:
            # An ENOSPC raced past the cycle's gate: stay leader, park
            # this tick; the gate re-arms once space returns.
            print(f"ha: journal degraded, parking: {e}", flush=True)
            time.sleep(args.tick)
            continue
        loop["lock_wait"] += t1 - t0
        loop["schedule_once"] += t2 - t1
        loop["tick"] += t3 - t2
        if result is None:
            time.sleep(args.tick)
            loop["sleep"] += time.monotonic() - t3
    eng = replica.engine
    role, epoch = replica.roles.role, replica.epoch
    if held.get("recorder") is not None:
        held["recorder"].close()
    replica.resign()
    endpoint.stop()
    hub.close()
    b = eng.oracle if eng is not None else None
    if eng is not None:
        if eng.watchdog is not None:
            eng.watchdog.detach()  # stops its hang sampler thread
        eng.journal.close()
    print(json.dumps({
        "role": role, "epoch": epoch, "identity": identity,
        "heads_launches": heads.launches,
        "cycle_seq": eng.cycle_seq if eng is not None else 0,
        "cycles_on_device": b.cycles_on_device if b else 0,
        "cycles_fallback": b.cycles_fallback if b else 0,
        "pipeline_stats": dict(b.pipeline_stats) if b else {},
        "promotion": replica.promotion_report,
        "promotion_timing": replica.promotion_timing,
        "tailer_rebuilds": replica.tailer.rebuilds,
        "loop_s": loop}), flush=True)


def _main_read_replica(args) -> None:
    """Read-replica mode: no admission cycles and no writable journal
    handle. The process tails ``--journal`` (checkpoint base + suffix
    rebuilds), serves staleness-stamped /read/* queries and /events from
    its read model, and refuses every write. SIGTERM ends it with one
    JSON line: its queries, rebuilds, tail position and the sha256 and
    length of ``readplane.canonical_answer`` of its read model."""
    import hashlib

    from kueue_tpu_torch.device import resolve_device
    from kueue_tpu_torch.ha.digest import admitted_state_digest
    from kueue_tpu_torch.metrics.registry import MetricsRegistry
    from kueue_tpu_torch.readplane import ReadReplica, canonical_answer
    from kueue_tpu_torch.visibility.fanout import FanoutHub
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint

    resolve_device(args.device)
    posture = _RebuildGC()
    identity = args.replica_id or f"read-{os.getpid()}"
    registry = MetricsRegistry()
    hub = FanoutHub(shards=args.fanout_shards, metrics=registry)
    replica = ReadReplica(args.journal, replica_id=identity, hub=hub,
                          metrics=registry,
                          engine_kwargs={"device": args.device})
    host, _, port = args.http.rpartition(":")
    endpoint = ServingEndpoint(
        lambda: replica.engine, host=host or "0.0.0.0", port=int(port),
        auth_token=os.environ.get("KUEUE_TPU_AUTH_TOKEN"),
        hub=hub, readplane=replica)
    endpoint.start()
    print(f"kueue-tpu-torch read replica serving on {host or '0.0.0.0'}:"
          f"{endpoint.port} (journal={args.journal})", flush=True)
    print(f"readplane: replica={identity} journal={args.journal}",
          flush=True)

    stop = _stop_flag()
    # Tail fast and sleep only when the journal is quiet: staleness is
    # what this process sells.
    tail_tick = min(args.tick, 0.05)
    while not stop["flag"]:
        try:
            n = replica.poll()
        except FileNotFoundError:
            n = 0  # no journal yet: answer "no read model", retry
        posture.after_poll(replica.tailer)
        if n == 0:
            time.sleep(tail_tick)
    endpoint.stop()
    hub.close()
    eng = replica.engine
    canonical = canonical_answer(eng) if eng is not None else b""
    t = replica.tailer
    print(json.dumps({
        "role": "read-replica", "identity": identity,
        "queries": replica.queries, "rebuilds": t.rebuilds,
        "records_seen": t.records_seen, "position": t.position(),
        "applied_position": t.applied_position,
        "state_digest": admitted_state_digest(eng) if eng else None,
        "canonical_sha256": hashlib.sha256(canonical).hexdigest(),
        "canonical_bytes": len(canonical)}), flush=True)


if __name__ == "__main__":
    main()
