"""Deterministic replayer: re-execute a trace through the real engine.

The port of ``kueue_tpu/replay/replayer.py``. Modes:

  host    a plain engine (sequential decision core);
  device  the engine with its oracle attached (the batched path on the
          card, hybrid cycles included);
  both    differential: host AND device engines consume the trace side
          by side; every cycle's decision record must match the
          recording AND each other.

The determinism contract: applying the trace's input frames at their
recorded clocks to a fresh engine and running exactly the recorded
number of schedule_once() calls yields a byte-identical decision stream
(canonical per-cycle records, chained CRC digest). Any divergence is
reported with the first differing cycle and a decision-level diff.

Per-cycle phase timings are captured on both sides; the report's
attribution table (recorded vs replayed, per phase: total, mean, share)
says where a recorded cycle's time went against the replay's.

``device`` is where the fresh engines and their oracles run: CUDA unless
the caller asks for the CPU.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.replay.recorder import apply_input
from kueue_tpu_torch.replay.trace import (
    TraceReader,
    canonical_decisions,
    decision_digest,
)


@dataclass
class CycleMismatch:
    seq: int
    kind: str  # "decisions" | "host-vs-device" | "extra-decisions"
    detail: str = ""


@dataclass
class ReplayReport:
    trace: str
    mode: str
    cycles: int = 0
    idle_cycles: int = 0
    inputs: int = 0
    admitted: int = 0
    preempting: int = 0
    truncated: bool = False
    recorded_digest: str = ""
    replayed_digest: str = ""
    mismatches: list = field(default_factory=list)
    # phase -> seconds summed over cycles, recorded vs replayed (and
    # "device:<phase>" when mode == "both").
    phases_recorded: dict = field(default_factory=dict)
    phases_replayed: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return (not self.mismatches
                and self.recorded_digest == self.replayed_digest)

    def attribution(self, which: str = "replayed") -> dict:
        """Per-phase attribution: {phase: {total_s, mean_ms, share}}."""
        phases = (self.phases_recorded if which == "recorded"
                  else self.phases_replayed)
        total = sum(phases.values()) or 1.0
        n = max(self.cycles, 1)
        return {p: {"total_s": round(t, 6),
                    "mean_ms": round(t / n * 1e3, 3),
                    "share": round(t / total, 4)}
                for p, t in sorted(phases.items(),
                                   key=lambda kv: -kv[1])}

    def render(self) -> str:
        lines = [
            f"trace    {self.trace}",
            f"mode     {self.mode}",
            f"cycles   {self.cycles} ({self.idle_cycles} idle), "
            f"{self.inputs} inputs, {self.admitted} admitted, "
            f"{self.preempting} preempting",
            f"digest   recorded={self.recorded_digest or '-'} "
            f"replayed={self.replayed_digest or '-'}"
            + (" [TRUNCATED TAIL]" if self.truncated else ""),
            f"verdict  {'BYTE-IDENTICAL' if self.ok else 'DIVERGED'}",
        ]
        for which in ("recorded", "replayed"):
            attr = self.attribution(which)
            if not attr:
                continue
            lines.append(f"phases ({which}):")
            for p, a in attr.items():
                lines.append(f"  {p:<10} {a['mean_ms']:>9.3f} ms/cycle  "
                             f"{a['share'] * 100:5.1f}%")
        for m in self.mismatches[:5]:
            lines.append(f"MISMATCH cycle {m.seq} [{m.kind}]: "
                         f"{m.detail[:400]}")
        if len(self.mismatches) > 5:
            lines.append(f"... {len(self.mismatches) - 5} more mismatches")
        return "\n".join(lines)


def _diff_decisions(want: list, got: list) -> str:
    w = json.dumps(want, sort_keys=True)
    g = json.dumps(got, sort_keys=True)
    if w == g:
        return ""
    # First differing character region, for a readable probe.
    i = next((k for k in range(min(len(w), len(g)))
              if w[k] != g[k]), min(len(w), len(g)))
    lo = max(0, i - 60)
    return (f"recorded[{lo}:]={w[lo:i + 120]!r} "
            f"replayed[{lo}:]={g[lo:i + 120]!r}")


def _fresh_engine(with_oracle: bool, engine_factory=None, device=None):
    """A new engine (``engine_factory()``, else the port's Engine on
    ``device``), with its oracle attached on ``device`` when
    ``with_oracle``."""
    if engine_factory is not None:
        eng = engine_factory()
    else:
        from kueue_tpu_torch.controllers.engine import Engine
        eng = Engine(device=device)
    if with_oracle:
        eng.attach_oracle(device=device)
    return eng


def replay_trace(path: str, mode: str = "host",
                 engine_factory=None, faults=None,
                 stop_after_cycles: Optional[int] = None,
                 device=None) -> ReplayReport:
    """Replay ``path`` and verify the decision stream. ``engine_factory``
    builds the fresh engine(s) (default: the port's Engine on
    ``device``); ``faults`` is a FaultPlan (or its spec) armed on the
    primary replay engine: replay doubles as the fault-injection
    harness, exercising crash paths against a known decision stream."""
    if mode not in ("host", "device", "both"):
        raise ValueError(f"unknown replay mode {mode!r}")
    report = ReplayReport(trace=path, mode=mode)
    engines = {}
    engines["primary"] = _fresh_engine(mode == "device", engine_factory,
                                       device)
    if mode == "both":
        engines["device"] = _fresh_engine(True, engine_factory, device)
    if faults is not None:
        from kueue_tpu_torch.replay.faults import arm_faults
        arm_faults(engines["primary"], faults)

    reader = TraceReader(path)
    digest = 0
    for frame in reader:
        kind = frame["f"]
        if kind == "input":
            for eng in engines.values():
                apply_input(eng, frame)
            report.inputs += 1
            continue
        if kind == "idle":
            for _ in range(frame["n"]):
                for name, eng in engines.items():
                    eng.clock = frame["clock"]
                    got_idle = canonical_decisions(eng.schedule_once())
                    # A recorded idle can replay as an entry-less result
                    # on the other path (skipped heads materialize as
                    # entries host-side); only actual DECISIONS diverge.
                    if got_idle:
                        report.mismatches.append(CycleMismatch(
                            eng.cycle_seq - 1, "extra-decisions",
                            f"{name}: recorded idle, replay produced "
                            f"{json.dumps(got_idle)[:300]}"))
                report.idle_cycles += 1
            continue
        if kind != "cycle":
            continue
        seq = frame["seq"]
        got = {}
        for name, eng in engines.items():
            eng.clock = frame["clock"]
            result = eng.schedule_once()
            got[name] = canonical_decisions(result)
            for p, dur in eng.last_cycle_phases.items():
                key = p if name == "primary" else f"{name}:{p}"
                report.phases_replayed[key] = \
                    report.phases_replayed.get(key, 0.0) + dur
        want = frame["decisions"]
        diff = _diff_decisions(want, got["primary"])
        if diff:
            report.mismatches.append(
                CycleMismatch(seq, "decisions", diff))
        if mode == "both":
            ddiff = _diff_decisions(got["primary"], got["device"])
            if ddiff:
                report.mismatches.append(CycleMismatch(
                    seq, "host-vs-device", ddiff))
        digest = decision_digest(got["primary"], digest)
        report.cycles += 1
        report.admitted += len(want[0]) if want else 0
        report.preempting += len(want[1]) if want else 0
        for p, dur in frame.get("phases", {}).items():
            report.phases_recorded[p] = \
                report.phases_recorded.get(p, 0.0) + dur
        if stop_after_cycles is not None \
                and report.cycles >= stop_after_cycles:
            break
    report.truncated = reader.truncated
    report.recorded_digest = reader.digest
    report.replayed_digest = f"{digest:08x}"
    if reader.truncated and not reader.digest:
        # No end frame and no cycle reached: nothing to compare against.
        report.recorded_digest = report.replayed_digest
    return report
