"""Structured logging and profiling hooks.

The port of ``kueue_tpu/utils/structlog.py``. Reference: the manager
logs structured key-value records (zap via logr) — scheduler.go:291-358
logs per-phase durations, controllers log transitions with object keys;
and Go pprof fills the profiling role. Here: JSON-lines structured logs,
and ``torch.profiler`` for device traces (``device_trace`` writes a
Chrome trace, the CUDA kernels included when the engine runs on CUDA).
"""

from __future__ import annotations

import io
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Optional

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class StructuredLogger:
    """JSON-lines logger: one object per record, logr-style named
    hierarchy and key-value pairs."""

    def __init__(self, name: str = "kueue_tpu", stream=None,
                 level: str = "info", clock=None):
        self.name = name
        self.stream = stream if stream is not None else sys.stderr
        self.level = LEVELS.get(level, 20)
        self.clock = clock or time.time
        self._bound: dict = {}

    def with_name(self, suffix: str) -> "StructuredLogger":
        child = StructuredLogger(f"{self.name}.{suffix}", self.stream,
                                 clock=self.clock)
        child.level = self.level
        child._bound = dict(self._bound)
        return child

    def with_values(self, **kv) -> "StructuredLogger":
        child = self.with_name("")  # copy
        child.name = self.name
        child._bound.update(kv)
        return child

    def log(self, level: str, msg: str, **kv) -> None:
        if LEVELS.get(level, 20) < self.level:
            return
        record = {"ts": self.clock(), "level": level, "logger": self.name,
                  "msg": msg}
        record.update(self._bound)
        record.update(kv)
        self.stream.write(json.dumps(record, default=str) + "\n")

    def debug(self, msg: str, **kv) -> None:
        self.log("debug", msg, **kv)

    def info(self, msg: str, **kv) -> None:
        self.log("info", msg, **kv)

    def warning(self, msg: str, **kv) -> None:
        self.log("warning", msg, **kv)

    def error(self, msg: str, **kv) -> None:
        self.log("error", msg, **kv)


def attach_engine_logging(engine, stream=None,
                          level: str = "info") -> StructuredLogger:
    """Wire a structured event stream onto an engine: every EngineEvent
    becomes one JSON record (the controllers' transition logs + the
    events stream), and each cycle logs its phase durations
    (scheduler.go:291-358)."""
    logger = StructuredLogger("kueue_tpu.engine", stream=stream,
                              level=level, clock=lambda: engine.clock)

    def on_event(ev):
        logger.info(ev.kind, workload=ev.workload,
                    clusterQueue=ev.cluster_queue, detail=ev.detail)

    engine.event_listeners.append(on_event)

    original = engine.schedule_once

    def logged_schedule_once():
        result = original()
        if result is not None and engine.last_cycle_phases:
            logger.debug("cycle", **{
                f"phase_{k}_s": round(v, 6)
                for k, v in engine.last_cycle_phases.items()})
        return result

    engine.schedule_once = logged_schedule_once
    return logger


@contextmanager
def device_trace(log_dir: Optional[str] = None, device=None):
    """A ``torch.profiler`` session around a scheduling region, the
    pprof analog for the device path: on exit it writes one Chrome trace
    (``kueue_tpu_torch.<pid>.<n>.pt.trace.json``) into ``log_dir``,
    with the CPU ops and, unless ``device`` is the CPU and when CUDA is
    present, the CUDA kernels. No-op when ``log_dir`` is None. A
    profiler that cannot start or export leaves the region to run
    unprofiled; an error raised inside the region propagates."""
    if log_dir is None:
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        on_cpu = device is not None and torch.device(device).type == "cpu"
        if torch.cuda.is_available() and not on_cpu:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # noqa: BLE001 — profiling must never break serving
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            global _TRACES
            _TRACES += 1
            prof.export_chrome_trace(os.path.join(
                log_dir,
                f"kueue_tpu_torch.{os.getpid()}.{_TRACES}.pt.trace.json"))
        except Exception:  # noqa: BLE001
            pass


_TRACES = 0


def capture_to_buffer(engine, level: str = "info"
                      ) -> tuple[StructuredLogger, io.StringIO]:
    buf = io.StringIO()
    return attach_engine_logging(engine, stream=buf, level=level), buf
