"""Explicit degradation ladder: one ordered sequence of things to turn
off under overload, instead of N independent components each guessing.

The metastable-failure literature is clear on the shape of the fix:
when offered load exceeds capacity, shed the *cheapest, least
essential* work first, in a FIXED order, and recover in the reverse
order — ad-hoc per-component reactions produce feedback loops (tracing
stays on while submissions are shed; fanout floods while the journal
is read-only) that keep a system wedged after the trigger clears.

Rungs, cumulative (each includes everything above it):

    0 normal   everything on
    1 trace    span-tree capture off (obs/tracer.py ``capture``)
    2 fanout   SSE detail chatter suppressed (visibility/fanout.py
               ``detail`` / DETAIL_KINDS)
    3 submit   new submissions squeezed below the shedder's own
               floors (AdmissionShedder.degraded_factor: 0.05, or
               0.0 while the journal is disk-degraded — nothing may
               be admitted that cannot be journaled)
    4 device   the device decision path demoted at the oracle
               breaker (supervisor.demote) — host-path-only cycles

Escalation is immediate (the cycle that observes the trigger moves the
rung); relaxation is one rung per ``relax_cycles`` consecutive clean
cycles, so a flapping trigger ratchets the ladder up and walks it down
slowly — hysteresis against oscillation.

Triggers, evaluated every cycle from components already attached to
the engine (all read-only except the documented levers):

    SLO worst() WARN              → at least rung 1
    SLO worst() WARN, burn ≥ 2    → at least rung 2
    SLO worst() BREACH            → at least rung 3
    journal disk-degraded         → at least rung 3 (factor 0.0)
    watchdog demoted (OPEN/probe) → rung 4

The ladder itself is a cycle listener — deterministic in cycle
sequence given the trigger inputs, visible as the
``overload_ladder_rung`` gauge, ``overload_ladder_transitions_total``
counter, and the ``ladder`` block on /debug/slo.
"""

from __future__ import annotations

RUNGS = ("normal", "trace", "fanout", "submit", "device")
R_NORMAL, R_TRACE, R_FANOUT, R_SUBMIT, R_DEVICE = range(5)

STATUS_WARN, STATUS_BREACH = 1, 2


class DegradationLadder:
    """Owns the rung and applies its cumulative effects each cycle."""

    def __init__(self, engine, shedder=None, hub=None,
                 relax_cycles: int = 32, metrics=None):
        self.engine = engine
        self.shedder = shedder
        self.hub = hub
        self.relax_cycles = max(1, int(relax_cycles))
        self.metrics = metrics if metrics is not None else getattr(
            engine, "registry", None)
        self.rung = R_NORMAL
        self.transitions = 0
        self.escalations = 0
        self.relaxations = 0
        self.last_reason = ""
        self._clean_cycles = 0
        self._post = self._on_cycle
        engine.cycle_listeners.append(self._post)
        engine.ladder = self
        self._export()

    # -- trigger evaluation --

    def _target(self) -> tuple:
        """(target rung, reason, disk_degraded) from current signals.
        The max of all triggers wins — rungs are cumulative, so the
        worst signal decides how far down the ladder we are."""
        target, reason = R_NORMAL, "clear"
        slo = getattr(self.engine, "slo", None)
        if slo is not None:
            try:
                status, burn = slo.worst()
            except Exception:  # noqa: BLE001 — ladder must not unwind
                status, burn = 0, 0.0   # the cycle listener chain
            if status >= STATUS_BREACH:
                target, reason = R_SUBMIT, "slo breach"
            elif status >= STATUS_WARN:
                if burn >= 2.0:
                    target, reason = R_FANOUT, f"slo warn burn={burn:.2f}"
                else:
                    target, reason = R_TRACE, "slo warn"
        journal = getattr(self.engine, "journal", None)
        disk = bool(journal is not None
                    and getattr(journal, "degraded", False))
        if disk and target < R_SUBMIT:
            target, reason = R_SUBMIT, "journal disk-degraded"
        watchdog = getattr(self.engine, "watchdog", None)
        if watchdog is not None and getattr(watchdog, "demoted", False):
            target, reason = R_DEVICE, (
                f"watchdog {watchdog.state}: "
                f"{watchdog.last_transition_reason}")
        return target, reason, disk

    # -- the cycle listener --

    def _on_cycle(self, seq: int, result) -> None:
        target, reason, disk = self._target()
        if target > self.rung:
            # Escalate immediately: the trigger cycle is already late.
            self._move(target, reason)
            self._clean_cycles = 0
        elif target < self.rung:
            self._clean_cycles += 1
            if self._clean_cycles >= self.relax_cycles:
                # One rung at a time — re-enable the most recently
                # shed work first and let the next window confirm.
                self._move(self.rung - 1, "relaxed: clean window")
                self._clean_cycles = 0
        else:
            self._clean_cycles = 0
        self._apply(seq, disk)

    # -- effects --

    def _apply(self, seq: int, disk: bool) -> None:
        """Idempotent application of the current rung's cumulative
        effects; called every cycle so late-attached components pick
        the posture up on their first cycle."""
        tracer = getattr(self.engine, "tracer", None)
        if tracer is not None:
            tracer.capture = self.rung < R_TRACE
        hub = self.hub if self.hub is not None else getattr(
            self.engine, "fanout", None)
        if hub is not None:
            hub.detail = self.rung < R_FANOUT
        shedder = self.shedder if self.shedder is not None else getattr(
            self.engine, "shedder", None)
        if shedder is not None:
            if self.rung >= R_SUBMIT:
                # Disk-degraded means admissions cannot be journaled:
                # shed everything, not merely almost-everything.
                shedder.degraded_factor = 0.0 if disk else 0.05
            else:
                shedder.degraded_factor = None
        if self.rung >= R_DEVICE:
            sup = getattr(getattr(self.engine, "oracle", None),
                          "supervisor", None)
            if sup is not None:
                try:
                    # Keeps the breaker's probe window pushed out for
                    # as long as the ladder holds the bottom rung.
                    sup.demote(seq, "ladder: device rung")
                except Exception:  # noqa: BLE001 — advisory only
                    pass

    def _move(self, to: int, reason: str) -> None:
        to = max(R_NORMAL, min(R_DEVICE, to))
        if to == self.rung:
            return
        if to > self.rung:
            self.escalations += 1
        else:
            self.relaxations += 1
        self.transitions += 1
        if self.metrics is not None:
            try:
                self.metrics.counter(
                    "overload_ladder_transitions_total").inc(
                    (RUNGS[self.rung], RUNGS[to]))
            except KeyError:
                pass
        self.rung = to
        self.last_reason = reason
        self._export()

    # -- observability --

    def _export(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.gauge("overload_ladder_rung").set(
                    (), float(self.rung))
            except KeyError:
                pass

    def status(self) -> dict:
        return {
            "rung": self.rung,
            "rungName": RUNGS[self.rung],
            "rungs": list(RUNGS),
            "lastReason": self.last_reason,
            "cleanCycles": self._clean_cycles,
            "relaxCycles": self.relax_cycles,
            "transitions": self.transitions,
            "escalations": self.escalations,
            "relaxations": self.relaxations,
        }

    def detach(self) -> None:
        try:
            self.engine.cycle_listeners.remove(self._post)
        except ValueError:
            pass
        if getattr(self.engine, "ladder", None) is self:
            self.engine.ladder = None


def attach_ladder(engine, **kwargs) -> DegradationLadder:
    """Attach a ladder to a live engine (idempotent)."""
    existing = getattr(engine, "ladder", None)
    if existing is not None:
        return existing
    return DegradationLadder(engine, **kwargs)
