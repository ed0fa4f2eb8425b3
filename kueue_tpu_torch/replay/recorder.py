"""FlightRecorder: capture a live engine's inputs and decision stream.

The port of ``kueue_tpu/replay/recorder.py``. Attachment wraps the
engine's public mutators as instance attributes (the class methods stay
untouched) and registers a cycle listener on the engine's capture
points (``Engine.cycle_listeners``). Every top-level input call writes
an ``input`` frame BEFORE delegating; the frame carries the pre-call
clock, so replay reproduces out-of-band clock manipulation
(``eng.clock += x``) exactly. Nested calls made by the engine itself
(preemption evictions inside a cycle, retention sweeps inside tick) are
consequences of recorded inputs, not inputs: a reentrancy guard keeps
them out of the trace, or replay would apply them twice.

Idle cycles are coalesced into one ``idle`` frame per run of consecutive
Nones (a serve loop idles thousands of times between submissions; the
replayer still executes every one of them, because an idle cycle runs
the second-pass queue and its count is part of the determinism
contract).
"""

from __future__ import annotations

import functools
import warnings

from kueue_tpu_torch.api.serde import from_jsonable, to_jsonable
from kueue_tpu_torch.replay.trace import TraceWriter, canonical_decisions

# Engine methods that constitute the input surface, the JAX package's
# list. Arguments round-trip through the api.serde codec (dataclasses
# get __t__ tags; primitives pass through).
RECORDED_METHODS = (
    "create_cohort",
    "create_resource_flavor",
    "create_cluster_queue",
    "create_local_queue",
    "create_topology",
    "create_node",
    "create_workload_priority_class",
    "create_limit_range",
    "create_runtime_class",
    "set_namespace_labels",
    "observe_pod",
    "observe_pod_deleted",
    "delete_node",
    "mark_node_unhealthy",
    "submit",
    "restore_workload",
    "reconcile_workload",
    "finish",
    "hold_workload",
    "clear_hold",
    "tick",
)

# Methods whose first argument is a live engine-owned Workload: recorded
# by key, resolved against engine.workloads on replay (serializing a
# copy would make replay act on a detached object).
BY_KEY_METHODS = ("evict",)


class FlightRecorder:
    def __init__(self, engine, path: str, label: str = "",
                 bootstrap: bool = False, fsync: bool = True):
        self.engine = engine
        self.writer = TraceWriter(path, label=label, fsync=fsync)
        self._depth = 0  # reentrancy guard: record top-level calls only
        self._idle = 0
        self._idle_clock = 0.0
        # name -> the instance attribute the wrapper shadows (None when
        # the class method was bound).
        self._wrapped: dict = {}
        self._listener = self._on_cycle
        if bootstrap:
            self._bootstrap()
        elif engine.cache.cluster_queues or engine.workloads:
            warnings.warn(
                "FlightRecorder attached to a populated engine without "
                "bootstrap=True: the trace will not carry the existing "
                "world and cannot replay faithfully", stacklevel=2)
        self._wrap_all()
        engine.cycle_listeners.append(self._listener)

    # -- capture --

    def _bootstrap(self) -> None:
        """Emit the engine's CURRENT state as input frames, so a trace
        can start from a journal-rebuilt world (serve --record): the
        replayer reconstructs the same world from the trace alone."""
        eng = self.engine
        clock = eng.clock
        write = self.writer.input
        for kind, objs in (
                ("create_cohort", eng.cache.cohorts.values()),
                ("create_resource_flavor",
                 eng.cache.resource_flavors.values()),
                ("create_cluster_queue", eng.cache.cluster_queues.values()),
                ("create_local_queue", eng.queues.local_queues.values()),
                ("create_topology", eng.cache.topologies.values()),
                ("create_node", eng.cache.nodes.values())):
            for obj in objs:
                write(clock, kind, [to_jsonable(obj)], {})
        for name, value in eng.workload_priority_classes.items():
            write(clock, "create_workload_priority_class", [name, value], {})
        for ns, labels in eng.namespace_labels.items():
            write(clock, "set_namespace_labels", [ns, dict(labels)], {})
        for wl in eng.workloads.values():
            write(clock, "restore_workload", [to_jsonable(wl)], {})

    def _wrap_all(self) -> None:
        eng = self.engine
        for name in RECORDED_METHODS + BY_KEY_METHODS:
            orig = getattr(eng, name)
            self._wrapped[name] = eng.__dict__.get(name)
            setattr(eng, name,
                    self._make_wrapper(name, orig,
                                       by_key=name in BY_KEY_METHODS))
        # schedule_once is NOT an input (the replayer drives cycles from
        # cycle frames), but everything the cycle itself calls
        # (preemption evictions, the columnar apply's, bulk_assume_batch)
        # must count as nested, or replay would apply those evictions
        # twice.
        orig_cycle = eng.schedule_once

        @functools.wraps(orig_cycle)
        def cycle_guard():
            self._depth += 1
            try:
                return orig_cycle()
            finally:
                self._depth -= 1
        self._wrapped["schedule_once"] = eng.__dict__.get("schedule_once")
        eng.schedule_once = cycle_guard

    def _make_wrapper(self, name: str, orig, by_key: bool):
        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if self._depth == 0:
                self._flush_idle()
                if by_key:
                    enc = [args[0].key] + [to_jsonable(a)
                                           for a in args[1:]]
                else:
                    enc = [to_jsonable(a) for a in args]
                self.writer.input(
                    self.engine.clock, name, enc,
                    {k: to_jsonable(v) for k, v in kwargs.items()})
            self._depth += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._depth -= 1
        return wrapper

    def _on_cycle(self, seq: int, result) -> None:
        eng = self.engine
        if result is None:
            if self._idle == 0:
                self._idle_clock = eng.clock
            self._idle += 1
            return
        self._flush_idle()
        verdict = None
        if eng.oracle is not None:
            verdict = getattr(eng.oracle, "last_verdict_digest", None)
        decisions = canonical_decisions(result)
        # The cid is a pure function of (seq, decisions), computed here
        # independently of any attached tracer, so the frame joins
        # against journal cycle_trace records and retained span trees
        # whether or not tracing was on during the recording.
        from kueue_tpu_torch.obs.span import correlation_id
        self.writer.cycle(
            seq, eng.clock, eng.last_cycle_mode or "sequential",
            decisions, dict(eng.last_cycle_phases),
            verdict_digest=verdict,
            cid=correlation_id(seq, decisions))

    def _flush_idle(self) -> None:
        if self._idle:
            self.writer.idle(self._idle, self._idle_clock)
            self._idle = 0

    # -- lifecycle --

    @property
    def digest(self) -> str:
        return self.writer.digest

    def close(self) -> None:
        """Detach from the engine and seal the trace (end frame)."""
        try:
            self.engine.cycle_listeners.remove(self._listener)
        except ValueError:
            pass
        for name, before in self._wrapped.items():
            # The wrapper shadows the class method as an instance
            # attribute: deleting it restores the class binding, and an
            # instance attribute it shadowed is put back.
            if before is None:
                self.engine.__dict__.pop(name, None)
            else:
                setattr(self.engine, name, before)
        self._wrapped = {}
        self._flush_idle()
        self.writer.close()


def decode_args(frame: dict) -> tuple:
    """Replay-side decoding for an input frame (shared with replayer)."""
    args = [from_jsonable(a) for a in frame.get("args", [])]
    kwargs = {k: from_jsonable(v)
              for k, v in frame.get("kwargs", {}).items()}
    return args, kwargs


def apply_input(engine, frame: dict) -> None:
    """Apply one input frame to an engine, restoring the recorded clock
    first (the determinism contract: identical clocks at every call)."""
    method = frame["method"]
    engine.clock = frame["clock"]
    args, kwargs = decode_args(frame)
    if method in BY_KEY_METHODS:
        wl = engine.workloads.get(args[0])
        if wl is None:
            raise KeyError(
                f"replay: {method} targets unknown workload {args[0]!r}")
        args[0] = wl
    getattr(engine, method)(*args, **kwargs)
