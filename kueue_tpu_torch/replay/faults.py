"""Fault injection for the admission pipeline, under replay or live
smoke (serve.py --fault / KUEUE_TPU_FAULT).

The port of ``kueue_tpu/replay/faults.py`` without its federation
faults (``FederationEvent``, ``PartitionedTransport``,
``FederationChaosSchedule``: ROADMAP Queue 1 item 7). The injector sets
the port's own process-wide seams (``store/checkpoint.WRITE_FAULT``,
``store/diskguard.FREE_BYTES_PROBE``,
``store/journal.MAINTENANCE_CRASH_HOOK``), never the JAX package's.

Spec grammar (comma-separated faults):

  sigkill@cycle:N          SIGKILL this process as cycle N begins
  sigkill@admission:N      SIGKILL mid-apply, at the Nth admission —
                           the journal's torn-tail + crash-recovery
                           path under a real half-applied cycle; the
                           ordinal counts per-entry (_admit) and bulk
                           (device-cycle columnar) admissions alike
  torn-tail@cycle:N        append a partial (newline-less, invalid)
                           record to the journal, fsync it, SIGKILL —
                           the exact artifact of a crash mid-append
  oracle-crash@cycle:N     the oracle executor raises transport errors
                           for the whole of cycle N (sidecar crash);
                           the bridge must fall back sequentially and
                           re-attach on the next cycle
  delay-verdict@cycle:N:MS the oracle's verdicts arrive MS late on
                           cycle N (slow sidecar) — decisions must be
                           unaffected, only phase timings move
  lease-stall@cycle:N      stop renewing the HA lease from cycle N on
                           (a wedged-but-alive leader): a standby must
                           steal the lease at expiry and the stale
                           leader's next journal write must die on
                           JournalFenced, not interleave
  enospc@cycle:N           every checkpoint write during cycle N fails
                           with ENOSPC (store.checkpoint.WRITE_FAULT) —
                           the previous checkpoint must stay the
                           newest valid one, the engine keeps running
  torn-checkpoint@cycle:N  truncate the newest sealed checkpoint file
                           to ~60% as cycle N begins — recovery must
                           reject it on the payload CRC and fall back
                           to the previous checkpoint + longer suffix
  sigkill@compaction:N     SIGKILL inside the Nth journal maintenance
                           event (segment rotation or compaction), at
                           the nastiest point: after the rename,
                           before cleanup/reopen
  clock-skew@cycle:N:MS    jump the engine clock forward MS ms at
                           cycle N (NTP step / VM freeze-thaw): every
                           decision downstream of the skewed stamps
                           must still replay identically from the
                           journal
  oracle-crash-storm@cycle:N:M
                           the executor raises transport errors for M
                           CONSECUTIVE cycles starting at N — long
                           enough to trip the supervisor's circuit
                           breaker (oracle/supervisor.py), which must
                           demote to the host path and re-promote
                           after the storm, digest-identical
  hang@cycle:N:MS          wedge the engine thread for MS ms as cycle
                           N begins (a GC stall / wedged device call):
                           the cycle watchdog's sampler thread
                           (obs/watchdog.py) must notice the in-flight
                           cycle mid-hang, capture stacks, and feed
                           its breaker. Attach the watchdog BEFORE
                           arming faults — its pre-cycle hook must
                           stamp the cycle start before the sleep.
  arrival-storm@cycle:N:M  submit M synthetic workloads as cycle N
                           begins (an open-loop burst landing straight
                           on the engine, past any front door):
                           admission stays exact — every storm
                           workload is journaled, zero lost/duplicate
  slow-consumer-flood@cycle:N:M
                           subscribe M never-draining SSE clients to
                           the fanout hub at cycle N: the hub's
                           slow-consumer policy must evict them
                           without stalling the cycle loop or any
                           live client
  disk-pressure-ramp@cycle:N:M
                           simulated free space collapses to zero for
                           M cycles starting at N (diskguard
                           FREE_BYTES_PROBE): the disk budget must
                           degrade read-only, scheduling park, and
                           the budget re-arm when the window passes —
                           no restart, nothing lost

The recovery contract these faults exist to prove: reboot via
store.journal.rebuild_engine and drain, and the admitted set equals an
uninterrupted run's — zero lost, zero duplicate admissions.

``ChaosSchedule`` expands one integer seed into a deterministic
multi-stage fault plan over those kinds. ``lease-stall`` needs an HA
replica (``engine.ha``, set by ``ha/replica.HAReplica``'s promotion):
on an engine without one it raises, as in the JAX package.
"""

from __future__ import annotations

import os
import random
import signal
from dataclasses import dataclass, field

KINDS = ("sigkill", "torn-tail", "oracle-crash", "delay-verdict",
         "lease-stall", "enospc", "torn-checkpoint", "clock-skew",
         "oracle-crash-storm", "hang", "arrival-storm",
         "slow-consumer-flood", "disk-pressure-ramp")
POINTS = ("cycle", "admission", "compaction")


@dataclass
class Fault:
    kind: str        # one of KINDS
    at: str          # cycle | admission | compaction
    n: int           # trigger point (cycle seq / admission ordinal /
                     # maintenance-event ordinal)
    arg: float = 0.0  # delay-verdict + clock-skew: ms; storm: cycles


@dataclass
class FaultPlan:
    faults: list = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for part in filter(None, (s.strip() for s in spec.split(","))):
            try:
                kind, rest = part.split("@", 1)
                bits = rest.split(":")
                at, n = bits[0], int(bits[1])
                arg = float(bits[2]) if len(bits) > 2 else 0.0
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad fault spec {part!r} "
                    "(want kind@cycle:N or kind@admission:N)") from None
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            if at not in POINTS:
                raise ValueError(f"unknown fault point {at!r}")
            if at != "cycle" and kind != "sigkill":
                raise ValueError(
                    f"{kind} only triggers at cycle boundaries")
            if kind == "clock-skew" and len(bits) < 3:
                raise ValueError(
                    "clock-skew needs a skew: clock-skew@cycle:N:MS")
            if kind == "oracle-crash-storm" and (
                    len(bits) < 3 or arg < 1 or arg != int(arg)):
                raise ValueError(
                    "oracle-crash-storm needs a whole cycle count "
                    ">= 1: oracle-crash-storm@cycle:N:M")
            if kind == "delay-verdict" and arg < 0:
                raise ValueError("delay-verdict delay must be >= 0 ms")
            if kind == "hang" and (len(bits) < 3 or arg <= 0):
                raise ValueError(
                    "hang needs a duration: hang@cycle:N:MS")
            if kind in ("arrival-storm", "slow-consumer-flood",
                        "disk-pressure-ramp") and (
                    len(bits) < 3 or arg < 1 or arg != int(arg)):
                raise ValueError(
                    f"{kind} needs a whole count >= 1: "
                    f"{kind}@cycle:N:M")
            plan.faults.append(Fault(kind, at, n, arg))
        return plan

    @property
    def lethal(self) -> bool:
        """True when some fault SIGKILLs the process (the plan's worker
        is expected to die rather than drain to completion)."""
        return any(f.kind in ("sigkill", "torn-tail")
                   for f in self.faults)

    @property
    def needs_oracle(self) -> bool:
        return any(f.kind in ("oracle-crash", "delay-verdict",
                              "oracle-crash-storm")
                   for f in self.faults)


def _die() -> None:
    # SIGKILL, not sys.exit: no atexit, no finally blocks, no flush —
    # the same crash the fault matrix is meant to prove recovery from.
    os.kill(os.getpid(), signal.SIGKILL)


def _tear_journal_tail(journal) -> None:
    """Plant the artifact of a crash mid-append: a flushed, newline-less
    JSON fragment at the end of the journal file."""
    with open(journal.path, "ab") as fh:
        fh.write(b'{"op":"apply","kind":"workload","ts":9')
        fh.flush()
        os.fsync(fh.fileno())


def _enospc(fh) -> None:
    """store.checkpoint.WRITE_FAULT payload: the disk is full."""
    import errno
    raise OSError(errno.ENOSPC, "injected: no space left on device")


class _ExecutorFaultProxy:
    """Wraps the oracle bridge's executor: raises transport errors while
    ``crashed`` is set, sleeps ``delay_ms`` before returning otherwise."""

    def __init__(self, inner, sleep=None):
        self.inner = inner
        self.crashed = False
        self.delay_ms = 0.0
        self.injected_errors = 0
        self.delayed_calls = 0
        if sleep is None:
            import time
            sleep = time.sleep
        self._sleep = sleep

    def _gate(self):
        from kueue_tpu_torch.oracle.service import RemoteOracleError
        if self.crashed:
            self.injected_errors += 1
            raise RemoteOracleError("injected oracle crash")
        if self.delay_ms > 0:
            self._sleep(self.delay_ms / 1e3)
            self.delayed_calls += 1

    def cycle_step(self, tensors, statics):
        self._gate()
        return self.inner.cycle_step(tensors, statics)

    def classical_targets(self, tensors, statics, derived=None):
        self._gate()
        return self.inner.classical_targets(tensors, statics,
                                            derived=derived)

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()


class FaultInjector:
    """Armed on an engine: hooks the cycle boundary (pre_cycle_hooks)
    and the admission apply path (_admit)."""

    def __init__(self, engine, plan: FaultPlan, sleep=None):
        self.engine = engine
        self.plan = plan
        # Injected wait primitive: wall-clock sleep by default; a
        # virtual clock passes its own sleep so a `hang` fault advances
        # compressed time instead of burning it.
        if sleep is None:
            import time as _time
            sleep = _time.sleep
        self._sleep = sleep
        self.admissions = 0
        self.maintenance_events = 0
        self.fired: list[str] = []
        self.proxy = None
        self._enospc_until = None
        self._disk_ramp_until = None
        self._flood_clients: list = []
        # Storm coverage: [start, end) cycle ranges the executor stays
        # crashed through (vs the single-cycle oracle-crash, which the
        # post-cycle "sidecar restart" clears).
        self._storms = [(f.n, f.n + int(f.arg)) for f in plan.faults
                        if f.kind == "oracle-crash-storm"]
        self._kill_at_admission = min(
            (f.n for f in plan.faults
             if f.kind == "sigkill" and f.at == "admission"),
            default=None)
        self._kill_at_maintenance = min(
            (f.n for f in plan.faults
             if f.kind == "sigkill" and f.at == "compaction"),
            default=None)
        engine.pre_cycle_hooks.append(self._pre_cycle)
        engine.cycle_listeners.append(self._post_cycle)
        if self._kill_at_admission is not None:
            orig = engine._admit

            def admit_and_maybe_die(entry, bulk=None):
                orig(entry, bulk=bulk)
                self.admissions += 1
                if self.admissions == self._kill_at_admission:
                    _die()
            engine._admit = admit_and_maybe_die

            # The bulk assume path (oracle bridge device cycles) admits
            # its fast shape without per-entry _admit calls, so the
            # ordinal must count those too — sigkill@admission:N means
            # the same thing on every decision path. A batch that
            # crosses the ordinal applies exactly the prefix that
            # reaches it and dies mid-apply: in-memory state mutated,
            # the batch's journal records still buffered in the bulk
            # ctx (flush_bulk_admit never runs) — the widest torn
            # window the recovery contract covers. Slow entries inside
            # the prefix still count (and can kill) through the _admit
            # wrap above; the returned pairs are fast-path only, so the
            # two counters never double-count an admission.
            orig_bulk = engine.bulk_assume_batch

            def bulk_and_maybe_die(entries, bulk):
                entries = list(entries)
                budget = self._kill_at_admission - self.admissions
                if 0 < budget <= len(entries):
                    orig_bulk(entries[:budget], bulk)
                    self.admissions = self._kill_at_admission
                    self.fired.append(
                        f"sigkill@admission:{self._kill_at_admission}")
                    _die()
                pairs = orig_bulk(entries, bulk)
                self.admissions += len(pairs)
                return pairs
            engine.bulk_assume_batch = bulk_and_maybe_die
        if self._kill_at_maintenance is not None:
            from kueue_tpu_torch.store import journal as _journal_mod

            def die_in_maintenance(event: str) -> None:
                self.maintenance_events += 1
                if self.maintenance_events == self._kill_at_maintenance:
                    self.fired.append(
                        f"sigkill@compaction:{self.maintenance_events}"
                        f" ({event})")
                    _die()
            _journal_mod.MAINTENANCE_CRASH_HOOK = die_in_maintenance
        if plan.needs_oracle:
            self._ensure_proxy()

    def _ensure_proxy(self):
        bridge = self.engine.oracle
        if bridge is None:
            raise RuntimeError(
                "oracle faults need an attached oracle "
                "(engine.attach_oracle() first)")
        if not isinstance(bridge.executor, _ExecutorFaultProxy):
            bridge.executor = _ExecutorFaultProxy(bridge.executor,
                                                  sleep=self._sleep)
        self.proxy = bridge.executor

    def _storm_covers(self, seq: int) -> bool:
        return any(start <= seq < end for start, end in self._storms)

    def _arrival_storm(self, engine, seq: int, count: int) -> None:
        """Inject ``count`` synthetic workloads straight into the
        engine (the open-loop burst, bypassing any serving front
        door). Deterministic: names carry the cycle seq, the target is
        the lexicographically first local queue."""
        from kueue_tpu_torch.api.types import PodSet, Workload

        lqs = sorted(engine.queues.local_queues)
        if not lqs:
            raise RuntimeError(
                "arrival-storm needs at least one local queue")
        lq = engine.queues.local_queues[lqs[0]]
        for i in range(count):
            engine.submit(Workload(
                name=f"storm-{seq}-{i}", namespace=lq.namespace,
                queue_name=lq.name,
                pod_sets=(PodSet("main", 1, {"cpu": 100}),)))

    def _tear_newest_checkpoint(self, engine) -> None:
        ck = getattr(engine, "checkpointer", None)
        if ck is None:
            raise RuntimeError(
                "torn-checkpoint fault needs an attached Checkpointer")
        files = ck.store._indexed()
        if not files:
            return  # nothing sealed yet; the fault is a no-op
        path = files[-1][1]
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(1, int(size * 0.6)))

    def _pre_cycle(self, seq: int, engine) -> None:
        if self._enospc_until is not None and seq >= self._enospc_until:
            # Cleared at the NEXT cycle's start, not post-cycle: the
            # Checkpointer writes from a cycle listener that may run
            # after ours, and the fault must cover it.
            from kueue_tpu_torch.store import checkpoint as _ckpt
            _ckpt.WRITE_FAULT = None
            self._enospc_until = None
        if (self._disk_ramp_until is not None
                and seq >= self._disk_ramp_until):
            from kueue_tpu_torch.store import diskguard as _dg
            _dg.FREE_BYTES_PROBE = None
            self._disk_ramp_until = None
        for f in self.plan.faults:
            if f.at != "cycle" or f.n != seq:
                continue
            if f.kind == "sigkill":
                self.fired.append(f"sigkill@cycle:{seq}")
                _die()
            elif f.kind == "torn-tail":
                if engine.journal is None:
                    raise RuntimeError("torn-tail fault needs a journal")
                _tear_journal_tail(engine.journal)
                self.fired.append(f"torn-tail@cycle:{seq}")
                _die()
            elif f.kind == "oracle-crash":
                self.proxy.crashed = True
                self.fired.append(f"oracle-crash@cycle:{seq}")
            elif f.kind == "oracle-crash-storm":
                self.proxy.crashed = True
                self.fired.append(
                    f"oracle-crash-storm@cycle:{seq}:{int(f.arg)}")
            elif f.kind == "delay-verdict":
                self.proxy.delay_ms = f.arg
                self.fired.append(f"delay-verdict@cycle:{seq}")
            elif f.kind == "enospc":
                from kueue_tpu_torch.store import checkpoint as _ckpt
                _ckpt.WRITE_FAULT = _enospc
                self._enospc_until = seq + 1
                self.fired.append(f"enospc@cycle:{seq}")
            elif f.kind == "torn-checkpoint":
                self._tear_newest_checkpoint(engine)
                self.fired.append(f"torn-checkpoint@cycle:{seq}")
            elif f.kind == "clock-skew":
                engine.clock += f.arg / 1e3
                self.fired.append(
                    f"clock-skew@cycle:{seq}:{f.arg:g}")
            elif f.kind == "lease-stall":
                if engine.ha is None:
                    raise RuntimeError(
                        "lease-stall fault needs an HA replica "
                        "(engine.ha unset — not running in HA mode)")
                engine.ha.suspend_renewal = True
                self.fired.append(f"lease-stall@cycle:{seq}")
            elif f.kind == "hang":
                self.fired.append(f"hang@cycle:{seq}:{f.arg:g}")
                # The engine thread wedges here, mid-cycle from the
                # watchdog's point of view (its pre-cycle hook already
                # stamped the start when it was attached first). Under
                # a virtual clock the sleep is an instant advance and
                # the watchdog's daemon poll events observe the hang
                # inside this very call.
                self._sleep(f.arg / 1e3)
            elif f.kind == "arrival-storm":
                self._arrival_storm(engine, seq, int(f.arg))
                self.fired.append(
                    f"arrival-storm@cycle:{seq}:{int(f.arg)}")
            elif f.kind == "slow-consumer-flood":
                hub = getattr(engine, "fanout", None)
                if hub is None:
                    raise RuntimeError(
                        "slow-consumer-flood needs a fanout hub "
                        "(engine.fanout unset)")
                # Subscribed, never drained: their queues fill, drops
                # accrue, and the hub's eviction policy must fire.
                self._flood_clients.extend(
                    hub.subscribe() for _ in range(int(f.arg)))
                self.fired.append(
                    f"slow-consumer-flood@cycle:{seq}:{int(f.arg)}")
            elif f.kind == "disk-pressure-ramp":
                from kueue_tpu_torch.store import diskguard as _dg
                _dg.FREE_BYTES_PROBE = lambda path: 0
                self._disk_ramp_until = seq + int(f.arg)
                self.fired.append(
                    f"disk-pressure-ramp@cycle:{seq}:{int(f.arg)}")

    def _post_cycle(self, seq: int, result) -> None:
        # Transient faults clear at the cycle's end: the sidecar
        # "restarts" and the next cycle reconnects. A storm holds the
        # crash through its whole [start, end) range.
        if self.proxy is not None:
            self.proxy.crashed = self._storm_covers(seq + 1)
            self.proxy.delay_ms = 0.0


def arm_faults(engine, plan, sleep=None) -> FaultInjector:
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    return FaultInjector(engine, plan, sleep=sleep)


@dataclass
class ChaosStage:
    """One worker process's life: a fault spec, how many drain cycles
    it gets, and whether the plan is expected to SIGKILL it."""
    spec: str
    cycles: int
    lethal: bool
    needs_oracle: bool


class ChaosSchedule:
    """Expand one integer seed into a deterministic multi-stage,
    multi-fault plan (a chaos runner's input: one worker process per
    stage).

    Stage = one worker process: it reboots from the journal
    (checkpoint base + suffix when one exists), drains under its fault
    plan, and either dies (lethal stage — the next stage is the crash
    recovery) or drains clean. Every stage before the last is lethal so
    each seed exercises a chain of crash/recover transitions; the final
    stage always runs fault-free to completion so the terminal state is
    comparable with the control arm. Cycle numbers restart per process
    (Engine.cycle_seq starts at 0 after every reboot), so each stage's
    triggers are drawn independently in [1, cycles).

    Same seed → byte-identical stages, and the same stages as the JAX
    package's ChaosSchedule (the same ``random.Random`` draws).
    """

    LETHAL = ("sigkill@cycle:{n}",
              "sigkill@admission:{adm}",
              "torn-tail@cycle:{n}",
              "sigkill@compaction:{maint}")
    # BENIGN faults must be INPUT-NEUTRAL: the terminal state is
    # compared byte-for-byte against a fault-free control arm, so a
    # benign fault may delay or reroute decisions but never add or
    # remove inputs. disk-pressure-ramp qualifies (scheduling parks,
    # then resumes — same admitted set, later). arrival-storm does NOT
    # (it injects workloads the control arm never saw); hang and
    # slow-consumer-flood need a watchdog/fanout hub the chaos workers
    # don't attach — all three are exercised by the overload tests
    # instead.
    BENIGN = ("oracle-crash@cycle:{n}",
              "oracle-crash-storm@cycle:{n}:{m}",
              "enospc@cycle:{n}",
              "torn-checkpoint@cycle:{n}",
              "clock-skew@cycle:{n}:{ms}",
              "disk-pressure-ramp@cycle:{n}:{m}")

    def __init__(self, seed: int, stages: int = 3,
                 cycles_per_stage: int = 24, oracle: bool = True):
        self.seed = int(seed)
        self.n_stages = max(2, int(stages))
        self.cycles_per_stage = max(8, int(cycles_per_stage))
        self.oracle = oracle

    def stages(self) -> list:
        rng = random.Random(self.seed)
        benign = [t for t in self.BENIGN
                  if self.oracle or not t.startswith("oracle")]
        out = []
        for i in range(self.n_stages):
            last = i == self.n_stages - 1
            faults = []
            if not last:
                lethal_at = rng.randrange(
                    self.cycles_per_stage // 2, self.cycles_per_stage)
                for tmpl in rng.sample(benign, rng.randrange(0, 3)):
                    # Benign faults land strictly before the lethal one
                    # so they demonstrably fire.
                    faults.append(tmpl.format(
                        n=rng.randrange(1, max(2, lethal_at)),
                        m=rng.randrange(2, 6),
                        ms=rng.choice([250, 1000, 5000])))
                faults.append(rng.choice(self.LETHAL).format(
                    n=lethal_at, adm=rng.randrange(2, 9),
                    maint=rng.randrange(1, 4)))
            spec = ",".join(faults)
            plan = FaultPlan.parse(spec)
            out.append(ChaosStage(
                spec=spec, cycles=self.cycles_per_stage,
                lethal=plan.lethal or any(
                    f.at in ("admission", "compaction")
                    for f in plan.faults),
                needs_oracle=plan.needs_oracle))
        return out
