"""CycleTracer: per-cycle span trees from the engine's capture points.

The port of ``kueue_tpu/obs/tracer.py``: the same span trees, journal
``cycle_trace`` records and ``cycle_trace`` engine events as the JAX
tracer on the same world (the port's separate ``sim`` phase is folded
into ``encode``, where the JAX bridge times it).

Attachment is purely observational — a pre-cycle hook captures the wall
start and arms the rationale buffer (obs.hooks), and a cycle listener
reconstructs the span tree from artifacts the cycle already produced:
the CycleResult entries (assignment, per-flavor rejection reasons,
preemption targets, statuses), Engine.last_cycle_phases and
last_cycle_mode, and the drained rationale events. Nothing here feeds
back into a decision, which is what keeps a traced run's decision
digest byte-identical to an untraced run (asserted against the JAX
package's tracer by tests/test_torch_obs_trace.py).

Both decision paths land here unchanged: the sequential core and the
oracle bridge (device/hybrid) both deliver CycleResult entries through
Engine.cycle_listeners, so workload spans carry the same attributes
regardless of which path decided them.

Retention is a bounded ring (``retain`` cycles) — the /debug/trace and
``kueuectl explain`` working set, not an archive; export what you want
to keep (``obs.perfetto.write_perfetto``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from kueue_tpu_torch.obs import hooks
from kueue_tpu_torch.obs.span import Span, correlation_id

_STATUS_TO_DECISION = {
    "assumed": "admitted",
    "preempting": "preempting",
    "skipped": "skipped",
    "inadmissible": "inadmissible",
    "nominated": "nominated",
    "": "not-nominated",
}


class CycleTracer:
    def __init__(self, engine, retain: int = 64,
                 journal_correlation: bool = True,
                 emit_events: bool = True):
        self.engine = engine
        self.retain = retain
        self.journal_correlation = journal_correlation
        self.emit_events = emit_events
        # Degradation-ladder lever (ha/ladder.py rung "trace"): False
        # skips span-tree construction entirely — the cheapest work to
        # drop under overload, since traces are a debugging aid, not a
        # correctness artifact. Flipping it is digest-neutral (nothing
        # here feeds a decision either way).
        self.capture = True
        self._spans: deque[Span] = deque(maxlen=retain)
        self.cycles_traced = 0
        self.last_cid: Optional[str] = None
        self._epoch = time.perf_counter()
        self._t0: Optional[float] = None
        self._pre = self._pre_cycle
        self._post = self._on_cycle
        engine.pre_cycle_hooks.append(self._pre)
        engine.cycle_listeners.append(self._post)
        engine.tracer = self

    # -- capture points --

    def _pre_cycle(self, seq, eng) -> None:
        # Runs un-isolated in schedule_once (fault injectors share this
        # hook list and raise on purpose) — keep it infallible.
        self._t0 = time.perf_counter()
        hooks.CURRENT = hooks.RationaleBuffer()

    def _on_cycle(self, seq, result) -> None:
        buf, hooks.CURRENT = hooks.CURRENT, None
        end = time.perf_counter()
        t0 = self._t0 if self._t0 is not None else end
        self._t0 = None
        if result is None:
            return  # idle: no decisions, no span tree
        if not self.capture:
            return  # shed by the degradation ladder (rung "trace")
        root = self._build(seq, result, buf, t0, end)
        self._spans.append(root)
        self.cycles_traced += 1
        self.last_cid = root.attrs["cid"]
        self._report(root, result)

    # -- span-tree construction --

    def _build(self, seq, result, buf, t0: float, end: float) -> Span:
        from kueue_tpu_torch.replay.trace import canonical_decisions

        eng = self.engine
        decisions = canonical_decisions(result)
        cid = correlation_id(seq, decisions)
        mode = eng.last_cycle_mode or "sequential"
        ts = (t0 - self._epoch) * 1e6
        root = Span(f"cycle/{seq}", "cycle", ts, (end - t0) * 1e6, {
            "seq": seq, "cid": cid, "mode": mode, "clock": eng.clock,
            "admitted": result.stats.admitted,
            "preempting": result.stats.preempting,
            "skipped": result.stats.skipped,
            "inadmissible": result.stats.inadmissible,
        })
        # Phases laid end-to-end from the cycle start, in the order the
        # decision path recorded them (snapshot/decide/apply on the host
        # path; encode/device/apply/finalize on the device path).
        cursor = ts
        decide_ts = ts
        apply_span = None
        phases = dict(eng.last_cycle_phases)
        sim = phases.pop("sim", None)
        if sim is not None and "encode" in phases:
            # The port times the sim nomination's device calls apart;
            # the JAX encode holds them, so the span tree folds them
            # back, as the registry's phase series do.
            phases["encode"] += sim
        for phase, secs in phases.items():
            dur = secs * 1e6
            ps = root.child(f"phase/{phase}", "phase", cursor, dur,
                            seconds=round(secs, 6))
            if phase == "apply":
                apply_span = ps
            if phase in ("decide", "device"):
                decide_ts = cursor
            cursor += dur
        # Apply micro-attribution (obs.perf): when the perf recorder is
        # attached, nest this cycle's apply sub-step samples as spans
        # under phase/apply, laid end-to-end — the span tree and the
        # aggregated histograms speak the same vocabulary. Samples
        # aggregate per sub-phase name (a cycle admitting N workloads
        # records N diff_build scopes): one span per name keeps the
        # tree bounded regardless of batch size.
        perf = getattr(eng, "perf", None)
        if perf is not None and apply_span is not None:
            agg: dict = {}
            for name, secs in perf.current_samples():
                if name.startswith("apply."):
                    tot, n = agg.get(name, (0.0, 0))
                    agg[name] = (tot + secs, n + 1)
            sub_cursor = apply_span.ts
            for name, (secs, n) in agg.items():
                sdur = secs * 1e6
                apply_span.child(f"subphase/{name}", "subphase",
                                 sub_cursor, sdur,
                                 seconds=round(secs, 6), samples=n)
                sub_cursor += sdur
        # Workload spans are captured COLUMNAR and materialized lazily:
        # the cycle-time capture flattens each decided entry into a
        # tuple of primitives (strings/ints/nested tuples) and the
        # query surface expands those into Span objects on first read.
        # Two costs disappear from the serving loop: the per-workload
        # Span+attrs constructions, and — the larger one — the GC drag
        # of retaining object graphs. CPython untracks tuples and dicts
        # that hold only untracked values, so a retention ring of
        # primitive columns drops out of every generational scan, while
        # a ring of Span trees (or retained Entry graphs) is re-scanned
        # for the whole ``retain`` window.
        rationale = buf.by_workload() if buf is not None else {}
        root.attrs["_pending"] = (
            tuple(self._workload_cols(e, rationale)
                  for e in result.entries),
            tuple(self._workload_cols(e, rationale)
                  for e in result.inadmissible),
            decide_ts)
        return root

    def _workload_cols(self, e, rationale: dict) -> tuple:
        """One entry flattened to primitives — the columnar capture
        record behind a lazy workload span. Field order matches
        _span_from_cols."""
        a = e.assignment
        if a is None:
            flavors = reasons = borrowing = None
        else:
            flavors = tuple(
                (ps.name, tuple((res, fa.name)
                                for res, fa in ps.flavors.items()))
                for ps in a.pod_sets if ps.flavors)
            reasons = tuple((ps.name, tuple(ps.reasons))
                            for ps in a.pod_sets if ps.reasons)
            borrowing = a.borrowing
        key = e.info.key
        status = e.status.value
        return (
            key,
            _STATUS_TO_DECISION.get(status, status),
            e.info.cluster_queue,
            flavors, reasons, borrowing,
            tuple((t.workload.key, t.reason)
                  for t in e.preemption_targets)
            if e.preemption_targets else (),
            e.inadmissible_msg,
            None if status in ("assumed", "") else e.requeue_reason.value,
            e.commit_position,
            tuple((kind, tuple(ev.items()))
                  for kind, ev in rationale.get(key, ())),
        )

    # -- lazy materialization --

    @property
    def spans(self) -> deque:
        """Retained cycle span trees, workload spans materialized."""
        for root in self._spans:
            if "_pending" in root.attrs:
                self._materialize(root)
        return self._spans

    def _materialize(self, root: Span) -> None:
        entries, inadmissible, decide_ts = root.attrs.pop("_pending")
        for cols in entries + inadmissible:
            root.children.append(self._span_from_cols(cols, decide_ts))

    def _span_from_cols(self, cols: tuple, ts: float) -> Span:
        """Expand one columnar capture record (_workload_cols) into the
        workload Span the eager path used to build — same names, same
        attrs, same to_dict shape."""
        (key, decision, cq, flavors, reasons, borrowing, preempt,
         msg, requeue, commit_position, rationale) = cols
        attrs = {"decision": decision, "cluster_queue": cq}
        if borrowing is not None:  # assignment was present
            if flavors:
                attrs["flavors"] = {ps: dict(fl) for ps, fl in flavors}
            if reasons:
                attrs["reasons"] = {ps: list(rs) for ps, rs in reasons}
            attrs["borrowing"] = borrowing
        if preempt:
            attrs["preemption_chosen"] = sorted(
                [k, r] for k, r in preempt)
        if msg:
            attrs["message"] = msg
        if requeue is not None:
            attrs["requeue_reason"] = requeue
        if commit_position >= 0:
            attrs["commit_position"] = commit_position
        for kind, ev in rationale:
            attrs.setdefault("rationale", []).append(
                {"kind": kind, **dict(ev)})
        return Span(f"workload/{key}", "workload", ts, 0.0, attrs)

    # -- side channels: metrics, journal correlation, SSE summary --

    def _report(self, root: Span, result) -> None:
        eng = self.engine
        attrs = root.attrs
        try:
            reg = eng.registry
            reg.counter("trace_cycles_total").inc((attrs["mode"],))
            dec = reg.counter("trace_workload_decisions_total")
            # Decision counts straight from the entry statuses — the
            # workload spans that used to carry them are now lazy.
            counts: dict = {}
            for e in result.entries:
                counts[e.status.value] = counts.get(e.status.value, 0) + 1
            for e in result.inadmissible:
                counts[e.status.value] = counts.get(e.status.value, 0) + 1
            for status, n in counts.items():
                dec.inc((_STATUS_TO_DECISION.get(status, status),), n)
        except KeyError:
            pass  # registry predates the trace families
        if self.journal_correlation and eng.journal is not None:
            # The cross-artifact join record: the same cid the flight
            # recorder stamps on its cycle frame. rebuild_engine skips
            # unknown kinds, so old engines replay journals with these
            # records untouched.
            eng.journal.apply("cycle_trace", {
                "name": attrs["cid"], "seq": attrs["seq"],
                "mode": attrs["mode"], "admitted": attrs["admitted"],
                "preempting": attrs["preempting"]}, ts=eng.clock)
        if self.emit_events:
            detail = (f"cid={attrs['cid']} mode={attrs['mode']} "
                      f"admitted={attrs['admitted']} "
                      f"preempting={attrs['preempting']} "
                      f"inadmissible={attrs['inadmissible']} "
                      f"dur_ms={root.dur / 1e3:.3f}")
            slo = getattr(eng, "slo", None)
            if slo is not None:
                # SLO posture rides the per-cycle summary: a dashboard
                # following the SSE stream sees burn state change on the
                # very cycle that turned it.
                try:
                    detail += f" slo={slo.status_string()}"
                except Exception:  # noqa: BLE001 — summary must not
                    pass           # unwind the cycle listener
            eng._event("cycle_trace", "", "", detail=detail)

    # -- query surface --

    def trees(self) -> list[dict]:
        """Retained span trees, oldest first (the /debug/trace body)."""
        return [s.to_dict() for s in self.spans]

    def find_workload(self, key: str):
        """Newest retained (cycle-span, workload-span) pair for ``key``,
        or (None, None)."""
        name = f"workload/{key}"
        for root in reversed(self.spans):
            for s in root.children:
                if s.name == name:
                    return root, s
        return None, None

    def detach(self) -> None:
        for lst, fn in ((self.engine.pre_cycle_hooks, self._pre),
                        (self.engine.cycle_listeners, self._post)):
            try:
                lst.remove(fn)
            except ValueError:
                pass
        if getattr(self.engine, "tracer", None) is self:
            self.engine.tracer = None
        hooks.CURRENT = None
