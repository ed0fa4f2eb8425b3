"""Admission tracing and decision explainability.

The port of ``kueue_tpu/obs``: per-cycle span trees with structured
decision rationale (obs.tracer), cheap rationale hooks for the decision
path (obs.hooks), Chrome/Perfetto export (obs.perfetto), ``explain``
(obs.explain), perf telemetry (obs.perf), SLO burn rates (obs.slo), the
cycle watchdog (obs.watchdog), and device-path profiler ranges that
line host spans up with ``torch.profiler`` traces (obs.device).
"""

from kueue_tpu_torch.obs import hooks
from kueue_tpu_torch.obs.explain import explain_workload, render_explain
from kueue_tpu_torch.obs.perf import PerfRecorder, PhaseHistogram, attach_perf
from kueue_tpu_torch.obs.perfetto import (
    spans_from_flight_trace,
    to_perfetto,
    write_perfetto,
)
from kueue_tpu_torch.obs.slo import SLO, SLOEngine, attach_slo
from kueue_tpu_torch.obs.span import Span, correlation_id
from kueue_tpu_torch.obs.tracer import CycleTracer


def attach_tracer(engine, retain: int = 64, **kwargs) -> CycleTracer:
    """Attach a CycleTracer to a live engine (idempotent: an existing
    tracer is returned rather than doubled)."""
    existing = getattr(engine, "tracer", None)
    if existing is not None:
        return existing
    return CycleTracer(engine, retain=retain, **kwargs)


__all__ = [
    "CycleTracer",
    "PerfRecorder",
    "PhaseHistogram",
    "SLO",
    "SLOEngine",
    "Span",
    "attach_perf",
    "attach_slo",
    "attach_tracer",
    "correlation_id",
    "explain_workload",
    "hooks",
    "render_explain",
    "spans_from_flight_trace",
    "to_perfetto",
    "write_perfetto",
]
