"""Cycle watchdog: deadline-bounded engine cycles with hung-cycle
detection, stack capture, and breaker-style demotion of the offending
decision path.

Nothing bounded a cycle before this: a device call that wedges, a
pathological preemption search, or a GC stall simply stopped the world
— no metric moved, no degradation fired, and the serving plane only
noticed when the lease expired. The watchdog brackets every
``schedule_once`` with the same hooks the tracer uses (pre_cycle_hooks
/ cycle_listeners — purely observational, digest-neutral) and holds
two thresholds:

  * **deadline** — a completed cycle that took longer than
    ``deadline_s`` is an OVERRUN: counted per decision mode, and fed
    to the breaker as a failure.
  * **hang** — an in-flight cycle older than ``hang_after_s`` is HUNG:
    a background sampler thread notices mid-cycle (the engine thread
    is by definition not going to report it), captures every thread's
    stack via ``sys._current_frames()`` into ``last_hang``, and feeds
    the breaker immediately.

The breaker reuses the oracle supervisor's demote/re-promote shape
(oracle/supervisor.py): ``threshold`` consecutive bad cycles open it;
after ``cooldown_cycles`` engine cycles it half-opens and one clean
cycle re-closes it; a bad probe re-opens with the cooldown doubled
(capped at 8x). Cooldown is measured in cycles, so the state machine
is a deterministic function of the observed duration sequence.

Demotion is WHERE-not-WHAT, like the supervisor: when the offending
cycle ran on the device path, opening the watchdog also demotes the
oracle breaker (``supervisor.demote``) so the next cycles run the host
path; the degradation ladder (ha/ladder.py) folds ``demoted`` into its
rung either way. The watchdog never mutates scheduling state — it
lives under the obs write-only discipline.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
_STATE_CODE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


def capture_stacks(skip_thread_ids=()) -> dict:
    """{thread_name: [frame lines]} for every live thread except the
    listed ids — the post-mortem a hung cycle leaves behind."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        if ident in skip_thread_ids:
            continue
        name = names.get(ident, f"thread-{ident}")
        out[name] = [ln.rstrip("\n") for ln in
                     traceback.format_stack(frame)][-16:]
    return out


class CycleWatchdog:
    """Attached to one engine; see module docstring."""

    def __init__(self, engine, deadline_s: float = 1.0,
                 hang_after_s: float = 5.0, threshold: int = 3,
                 cooldown_cycles: int = 16, poll_s: float = 0.25,
                 watch_thread: bool = True, clock=time.monotonic):
        self.engine = engine
        self.deadline_s = float(deadline_s)
        self.hang_after_s = float(hang_after_s)
        self.threshold = max(1, int(threshold))
        self.cooldown_cycles = max(1, int(cooldown_cycles))
        self.poll_s = max(0.01, float(poll_s))
        self._clock = clock
        # breaker state (the supervisor's shape)
        self.state = CLOSED
        self.consecutive_bad = 0
        self.overruns = 0
        self.hung_cycles = 0
        self.demotions = 0
        self.repromotions = 0
        self.cycles_observed = 0
        self.last_hang: Optional[dict] = None
        self.last_overrun: Optional[dict] = None
        self.last_transition_reason = ""
        self._cooldown = self.cooldown_cycles
        self._reopen_at: Optional[int] = None
        # in-flight cycle: (seq, t0) guarded by _mu; _hang_reported
        # keeps the sampler from double-counting one wedged cycle.
        self._mu = threading.Lock()
        self._inflight: Optional[tuple] = None
        self._hang_reported = -1
        self._pre = self._pre_cycle
        self._post = self._on_cycle
        engine.pre_cycle_hooks.append(self._pre)
        engine.cycle_listeners.append(self._post)
        engine.watchdog = self
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if watch_thread:
            self._thread = threading.Thread(
                target=self._watch_loop, name="cycle-watchdog",
                daemon=True)
            self._thread.start()
        self._export_state()

    @property
    def demoted(self) -> bool:
        return self.state != CLOSED

    # -- capture points --

    def _pre_cycle(self, seq: int, engine) -> None:
        # Infallible by contract: this hook list is shared with fault
        # injectors that raise on purpose.
        if (self.state == OPEN and self._reopen_at is not None
                and seq >= self._reopen_at):
            self._transition(HALF_OPEN, "probe window")
        with self._mu:
            self._inflight = (seq, self._clock())

    def _on_cycle(self, seq: int, result) -> None:
        with self._mu:
            inflight, self._inflight = self._inflight, None
        if inflight is None or inflight[0] != seq:
            return  # attached mid-cycle, or a nested drive loop
        dur = self._clock() - inflight[1]
        self.cycles_observed += 1
        mode = getattr(self.engine, "last_cycle_mode",
                       None) or "sequential"
        hung = self._hang_reported == seq
        if dur > self.deadline_s or hung:
            if not hung:
                # A hang already counted itself from the sampler; an
                # overrun is the milder, completed-late case.
                self.overruns += 1
                self.last_overrun = {"seq": seq, "mode": mode,
                                     "duration_s": round(dur, 6)}
                self._count("watchdog_cycle_overruns_total", (mode,))
            self._record_bad(seq, mode)
        else:
            self._record_good()

    # -- the hang sampler --

    def _watch_loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.poll_s):
            self.poll_once(skip_thread_ids=(me,))

    def poll_once(self, skip_thread_ids=()) -> bool:
        """One hang-sampler observation: report the in-flight cycle as
        HUNG when it is older than ``hang_after_s``. The sampler thread
        calls this every ``poll_s`` of wall time; a simulation with
        ``watch_thread=False`` schedules it as daemon events on the
        virtual clock's heap instead (the JAX package's sim harness) — same
        detection logic, zero threads, deterministic. Returns True when
        a hang was reported."""
        with self._mu:
            inflight = self._inflight
            seq = inflight[0] if inflight else -1
            reported = self._hang_reported
        if inflight is None or seq == reported:
            return False
        elapsed = self._clock() - inflight[1]
        if elapsed < self.hang_after_s:
            return False
        # Hung: the engine thread is wedged mid-cycle. Capture the
        # evidence now — by the time (if ever) the cycle returns,
        # the interesting frames are gone.
        stacks = capture_stacks(skip_thread_ids=skip_thread_ids)
        mode = getattr(self.engine, "last_cycle_mode",
                       None) or "sequential"
        with self._mu:
            if self._hang_reported == seq:
                return False  # raced another report
            self._hang_reported = seq
        self.hung_cycles += 1
        self.last_hang = {"seq": seq, "mode": mode,
                          "elapsed_s": round(elapsed, 3),
                          "stacks": stacks}
        self._count("watchdog_hung_cycles_total", ())
        self._record_bad(seq, mode)
        return True

    # -- the breaker (supervisor shape) --

    def _record_good(self) -> None:
        self.consecutive_bad = 0
        if self.state == HALF_OPEN:
            self.repromotions += 1
            self._cooldown = self.cooldown_cycles
            self._transition(CLOSED, "probe met deadline")

    def _record_bad(self, seq: int, mode: str) -> None:
        self.consecutive_bad += 1
        if self.state == HALF_OPEN:
            self._cooldown = min(self._cooldown * 2,
                                 self.cooldown_cycles * 8)
            self._demote(seq, mode, "probe missed deadline")
        elif (self.state == CLOSED
              and self.consecutive_bad >= self.threshold):
            self._demote(seq, mode,
                         f"{self.consecutive_bad} consecutive "
                         f"deadline misses")

    def _demote(self, seq: int, mode: str, reason: str) -> None:
        self.demotions += 1
        self._reopen_at = seq + self._cooldown
        self._count("watchdog_demotions_total", (mode,))
        self._transition(OPEN, reason)
        if mode in ("device", "hybrid"):
            # The offending path is the device/oracle one: demote it
            # at its own breaker so the next cycles decide on the host
            # path. WHERE, never WHAT — both paths are digest-proven
            # identical, so this cannot change a decision.
            sup = getattr(getattr(self.engine, "oracle", None),
                          "supervisor", None)
            if sup is not None:
                try:
                    sup.demote(seq, f"watchdog: {reason}")
                except Exception:  # noqa: BLE001 — advisory only
                    pass

    def _transition(self, to: str, reason: str) -> None:
        if to == self.state:
            return
        self._count("watchdog_transitions_total", (self.state, to))
        self.state = to
        self.last_transition_reason = reason
        self._export_state()

    # -- observability --

    def _export_state(self) -> None:
        try:
            self.engine.registry.gauge("watchdog_state").set(
                (), _STATE_CODE[self.state])
        except (KeyError, AttributeError):
            pass

    def _count(self, family: str, labels: tuple) -> None:
        try:
            self.engine.registry.counter(family).inc(labels)
        except (KeyError, AttributeError):
            pass

    def status(self) -> dict:
        return {
            "state": self.state,
            "deadlineSeconds": self.deadline_s,
            "hangAfterSeconds": self.hang_after_s,
            "cyclesObserved": self.cycles_observed,
            "overruns": self.overruns,
            "hungCycles": self.hung_cycles,
            "consecutiveBad": self.consecutive_bad,
            "demotions": self.demotions,
            "repromotions": self.repromotions,
            "cooldownCycles": self._cooldown,
            "reopenAt": self._reopen_at,
            "lastOverrun": self.last_overrun,
            "lastHang": None if self.last_hang is None else {
                k: v for k, v in self.last_hang.items()
                if k != "stacks"},
        }

    def detach(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        for lst, fn in ((self.engine.pre_cycle_hooks, self._pre),
                        (self.engine.cycle_listeners, self._post)):
            try:
                lst.remove(fn)
            except ValueError:
                pass
        if getattr(self.engine, "watchdog", None) is self:
            self.engine.watchdog = None


def attach_watchdog(engine, **kwargs) -> CycleWatchdog:
    """Attach a watchdog to a live engine (idempotent)."""
    existing = getattr(engine, "watchdog", None)
    if existing is not None:
        return existing
    return CycleWatchdog(engine, **kwargs)
