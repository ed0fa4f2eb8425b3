"""SLO engine: declarative objectives over multi-window burn rates.

Objectives are declared, not hard-coded: an :class:`SLO` names a
per-cycle (or per-window) predicate kind, a target, and an error
budget. The engine evaluates each objective over two sliding windows —
a fast window that catches sharp regressions within seconds of cycles
and a slow window that confirms sustained burn (the classic
multi-window, multi-burn-rate alerting shape: page only when BOTH
windows burn, warn when only the fast one does, so a single slow cycle
cannot page and a sustained regression cannot hide behind an old quiet
period).

Windows are measured in **cycles**, not wall-clock: the serving loop's
cadence is the engine's own unit of work, the evaluation stays
deterministic under replay, and no wall time is read outside this
module (obs zone). Rate objectives (admissions/s) convert through the
window's *measured busy seconds* — the sum of per-cycle wall durations
this module itself clocked around ``schedule_once``.

Burn rate semantics per kind:

  * ``latency_p95`` — violation fraction = share of window cycles whose
    duration exceeded ``target`` seconds; burn = fraction / budget
    (budget 0.05 ⇒ "p95 ≤ target": at most 5% of cycles may exceed).
  * ``rate_floor``  — burn = max(0, 1 − rate/target) / budget: how far
    below the floor the window ran, scaled by the tolerated shortfall.
  * ``fallback_ratio`` — burn = fallback-cycle share / target: for a
    ratio objective the target *is* the budget.

Attachment is purely observational: a pre-cycle hook
marks wall start, a cycle listener appends one observation and
refreshes the ``slo_*`` gauges. Nothing feeds back into a decision.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

STATUS_OK, STATUS_WARN, STATUS_BREACH = 0, 1, 2
_STATUS_NAMES = {STATUS_OK: "ok", STATUS_WARN: "warn",
                 STATUS_BREACH: "breach"}


@dataclass(frozen=True)
class SLO:
    """One declarative objective."""

    name: str
    kind: str            # latency_p95 | rate_floor | fallback_ratio
    target: float        # seconds / admissions-per-second / ratio
    budget: float = 0.05  # tolerated violation fraction


DEFAULT_OBJECTIVES = (
    SLO("cycle_latency_p95", kind="latency_p95", target=0.25),
    SLO("admission_rate_floor", kind="rate_floor", target=1.0,
        budget=0.25),
    SLO("fallback_cycle_ratio", kind="fallback_ratio", target=0.25),
)

# (window name, window length in cycles) — fast catches sharp burn,
# slow confirms sustained burn.
DEFAULT_WINDOWS = (("fast", 16), ("slow", 128))

# Read-plane objectives (the JAX package's readplane): both are quantile-bound
# shaped, so they reuse the latency_p95 burn semantics over their own
# sample series — read service latency per query, and the advertised
# staleness bound stamped on each answer. Budget 0.01 ⇒ "p99 ≤ target".
READ_OBJECTIVES = (
    SLO("read_latency_p99", kind="latency_p95", target=0.05,
        budget=0.01),
    SLO("read_staleness_bound", kind="latency_p95", target=5.0,
        budget=0.05),
)


class _Window:
    """One sliding window's running aggregates. Maintained
    incrementally on push/evict so burn evaluation — which runs every
    cycle (gauge export + the SSE posture) — costs a handful of dict
    reads instead of an O(window) rescan."""

    __slots__ = ("length", "ring", "sum_dur", "sum_admitted",
                 "n_fallback", "over")

    def __init__(self, length: int, latency_names) -> None:
        self.length = length
        # (dur, admitted, fallback01, names-over-target)
        self.ring: deque = deque()
        self.sum_dur = 0.0
        self.sum_admitted = 0
        self.n_fallback = 0
        self.over = {name: 0 for name in latency_names}

    def push(self, dur: float, admitted: int, fallback: bool,
             latency_targets: dict) -> None:
        if len(self.ring) == self.length:
            odur, oadm, ofb, onames = self.ring.popleft()
            self.sum_dur -= odur
            self.sum_admitted -= oadm
            self.n_fallback -= ofb
            for n in onames:
                self.over[n] -= 1
        onames = tuple(n for n, t in latency_targets.items() if dur > t)
        self.ring.append((dur, admitted, 1 if fallback else 0, onames))
        self.sum_dur += dur
        self.sum_admitted += admitted
        self.n_fallback += 1 if fallback else 0
        for n in onames:
            self.over[n] += 1


class SLOEngine:
    def __init__(self, engine, objectives=DEFAULT_OBJECTIVES,
                 windows=DEFAULT_WINDOWS):
        self.engine = engine
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)
        self._latency_targets = {o.name: o.target for o in self.objectives
                                 if o.kind == "latency_p95"}
        self._wins = tuple(
            (wname, _Window(wlen, self._latency_targets))
            for wname, wlen in self.windows)
        self.cycles_observed = 0
        self._t0: Optional[float] = None
        self._pre = self._pre_cycle
        self._post = self._on_cycle
        engine.pre_cycle_hooks.append(self._pre)
        engine.cycle_listeners.append(self._post)
        engine.slo = self
        self._export_targets()

    def _export_targets(self) -> None:
        try:
            g = self.engine.registry.gauge("slo_objective_target")
        except KeyError:
            return
        for o in self.objectives:
            g.set((o.name, o.kind), o.target)

    # -- capture points --

    def _pre_cycle(self, seq, eng) -> None:
        self._t0 = time.perf_counter()

    def _on_cycle(self, seq, result) -> None:
        end = time.perf_counter()
        t0, self._t0 = self._t0, None
        if result is None:
            return  # idle attempt: no unit of serving work
        dur = (end - t0) if t0 is not None else 0.0
        mode = self.engine.last_cycle_mode or "sequential"
        is_fallback = (self.engine.oracle is not None
                       and mode == "sequential")
        self.observe_cycle(dur, result.stats.admitted, is_fallback)

    def observe_cycle(self, duration_s: float, admitted: int,
                      is_fallback: bool) -> None:
        """Append one observation and refresh the exported gauges.
        Public so tests (and offline evaluation) can drive synthetic
        trajectories without an engine loop."""
        for _, win in self._wins:
            win.push(duration_s, int(admitted), bool(is_fallback),
                     self._latency_targets)
        self.cycles_observed += 1
        self._export()

    # -- evaluation --

    def _burn(self, o: SLO, win: _Window) -> float:
        n = len(win.ring)
        if n == 0:
            return 0.0
        if o.kind == "latency_p95":
            return (win.over[o.name] / n) / max(o.budget, 1e-9)
        if o.kind == "rate_floor":
            if win.sum_dur <= 0.0:
                return 0.0
            rate = win.sum_admitted / win.sum_dur
            shortfall = max(0.0, 1.0 - rate / max(o.target, 1e-9))
            return shortfall / max(o.budget, 1e-9)
        if o.kind == "fallback_ratio":
            return (win.n_fallback / n) / max(o.target, 1e-9)
        return 0.0

    def evaluate(self) -> dict:
        """{objective: {"burn": {window: rate}, "status": 0|1|2}} over
        the current observation rings."""
        out: dict[str, dict] = {}
        for o in self.objectives:
            burns: dict[str, float] = {}
            for wname, win in self._wins:
                burns[wname] = self._burn(o, win)
            burning = [w for w, b in burns.items() if b >= 1.0]
            if len(burning) == len(self.windows) and burning:
                status = STATUS_BREACH
            elif burning:
                status = STATUS_WARN
            else:
                status = STATUS_OK
            out[o.name] = {"kind": o.kind, "target": o.target,
                           "budget": o.budget, "burn": burns,
                           "status": status,
                           "statusName": _STATUS_NAMES[status]}
        return out

    def worst(self) -> tuple:
        """(status, max_burn) across all objectives and windows — the
        one-number coupling the HA admission shedder keys its refill
        factor off (ha/shedder.py): the worse the worst
        objective burns, the harder the front door sheds."""
        worst_status, worst_burn = STATUS_OK, 0.0
        for ev in self.evaluate().values():
            worst_status = max(worst_status, ev["status"])
            for b in ev["burn"].values():
                worst_burn = max(worst_burn, b)
        return worst_status, worst_burn

    def _export(self) -> None:
        reg = self.engine.registry
        try:
            burn_g = reg.gauge("slo_burn_rate")
            status_g = reg.gauge("slo_status")
        except KeyError:
            return  # registry predates the SLO families
        for name, ev in self.evaluate().items():
            for wname, b in ev["burn"].items():
                burn_g.set((name, wname), round(b, 6))
            status_g.set((name,), ev["status"])

    # -- summaries --

    def summary(self) -> dict:
        return {"cyclesObserved": self.cycles_observed,
                "windows": {w: n for w, n in self.windows},
                "objectives": self.evaluate()}

    def status_string(self) -> str:
        """Compact state for SSE cycle_trace summaries: "ok" when all
        objectives hold, else the worst offenders, e.g.
        "warn:cycle_latency_p95,breach:fallback_cycle_ratio"."""
        parts = [f"{ev['statusName']}:{name}"
                 for name, ev in self.evaluate().items()
                 if ev["status"] != STATUS_OK]
        return ",".join(parts) if parts else "ok"

    def detach(self) -> None:
        for lst, fn in ((self.engine.pre_cycle_hooks, self._pre),
                        (self.engine.cycle_listeners, self._post)):
            try:
                lst.remove(fn)
            except ValueError:
                pass
        if getattr(self.engine, "slo", None) is self:
            self.engine.slo = None


def attach_slo(engine, objectives=DEFAULT_OBJECTIVES,
               windows=DEFAULT_WINDOWS) -> SLOEngine:
    """Attach the SLO engine to a live engine (idempotent)."""
    existing = getattr(engine, "slo", None)
    if existing is not None:
        return existing
    return SLOEngine(engine, objectives=objectives, windows=windows)


class ReadSLOEngine:
    """Multi-window burn evaluation for the read plane.

    Unlike :class:`SLOEngine` this is not attached to an engine — a
    read replica's engine is rebuilt (replaced) on every tail rebuild,
    so the evaluator and its exported gauges must outlive any one
    engine object. The replica owns one of these, feeds it a
    (latency, staleness-bound) pair per answered query, and exports
    through the replica's own stable registry via the same ``slo_*``
    gauge families the cycle-side engine uses.

    Both READ_OBJECTIVES are quantile bounds, so burn per objective is
    simply (violation share / budget) over each window's own sample
    ring — the same multi-window page/warn semantics as the cycle SLOs
    (breach only when every window burns).
    """

    def __init__(self, registry=None, objectives=READ_OBJECTIVES,
                 windows=DEFAULT_WINDOWS):
        self.registry = registry
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)
        # {objective: {window: deque of samples}}
        self._rings = {
            o.name: {w: deque(maxlen=n) for w, n in self.windows}
            for o in self.objectives}
        self.reads_observed = 0
        self._export_targets()

    def _export_targets(self) -> None:
        if self.registry is None:
            return
        try:
            g = self.registry.gauge("slo_objective_target")
        except KeyError:
            return
        for o in self.objectives:
            g.set((o.name, o.kind), o.target)

    def observe_read(self, latency_s: float,
                     staleness_s: Optional[float]) -> None:
        """Append one answered query: its service latency and the
        staleness bound it advertised (None — no bound computable yet,
        e.g. before the first rebuild — counts as a staleness
        violation: an answer that cannot bound its own staleness has
        already busted the objective)."""
        samples = {"read_latency_p99": float(latency_s),
                   "read_staleness_bound": (
                       float("inf") if staleness_s is None
                       else float(staleness_s))}
        for o in self.objectives:
            v = samples.get(o.name)
            if v is None:
                continue
            for _, ring in self._rings[o.name].items():
                ring.append(v)
        self.reads_observed += 1
        self._export()

    def evaluate(self) -> dict:
        out: dict[str, dict] = {}
        for o in self.objectives:
            burns: dict[str, float] = {}
            for wname, ring in self._rings[o.name].items():
                n = len(ring)
                if n == 0:
                    burns[wname] = 0.0
                    continue
                frac = sum(1 for v in ring if v > o.target) / n
                burns[wname] = frac / max(o.budget, 1e-9)
            burning = [w for w, b in burns.items() if b >= 1.0]
            if len(burning) == len(self.windows) and burning:
                status = STATUS_BREACH
            elif burning:
                status = STATUS_WARN
            else:
                status = STATUS_OK
            out[o.name] = {"kind": o.kind, "target": o.target,
                           "budget": o.budget, "burn": burns,
                           "status": status,
                           "statusName": _STATUS_NAMES[status]}
        return out

    def worst(self) -> tuple:
        worst_status, worst_burn = STATUS_OK, 0.0
        for ev in self.evaluate().values():
            worst_status = max(worst_status, ev["status"])
            for b in ev["burn"].values():
                worst_burn = max(worst_burn, b)
        return worst_status, worst_burn

    def _export(self) -> None:
        if self.registry is None:
            return
        try:
            burn_g = self.registry.gauge("slo_burn_rate")
            status_g = self.registry.gauge("slo_status")
        except KeyError:
            return
        for name, ev in self.evaluate().items():
            for wname, b in ev["burn"].items():
                burn_g.set((name, wname), round(min(b, 1e9), 6))
            status_g.set((name,), ev["status"])

    def summary(self) -> dict:
        return {"readsObserved": self.reads_observed,
                "windows": {w: n for w, n in self.windows},
                "objectives": self.evaluate()}
