"""The flight recorder on a serving-engine cell: a recorded run, its
replay on the host and the device side by side, and its replay on the
device under a fault plan.

``record(config, path, kit)`` is ``engine_worlds.run`` of a ``cycles``
config with, once the world is built and its oracle attached and before
the first cycle, the kit's ``FlightRecorder`` attached with
``bootstrap=True`` (the built world becomes the trace's input frames),
and closed after the last cycle. The world's workload uids are drawn
from a counter started at ``UID_START`` and restored after, so the
trace's bytes do not depend on what the process ran before.
``replay(path, mode, kit, faults)`` is the kit's ``replay_trace`` on the
config's loop arm, with fresh engines from the kit (their oracle on the
kit's device) in the recorded run's GC posture, a count of the executor calls that reached each engine's
executor (``dispatched``: one heads launch each) and the seconds the
input frames took to rebuild the world (``rebuild_s``).
``masked_checksum(path)`` is the crc32 over the trace's frames, each as
canonical JSON without ``phases`` (wall timings) and ``crc`` (which
chains over them): equal checksums mean equal inputs, decisions, modes,
verdict digests and cids. Each step goes through the kit's own modules,
so the same record and replays run through the JAX package with its
kit (``Kit.replay``): ``chip_smoke.py`` phase 29 and the parity tests
hold the two packages' numbers equal.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import time
import zlib
from contextlib import contextmanager

from kueue_tpu_torch.bench import engine_worlds as ew

UID_START = 70_000_001
LABEL = "replay_world"
# Phase 29's fault plan on the recorded cycle_latency cell (cycles 0 to
# 8, each admitting 1,000): a single-cycle sidecar crash, a delayed
# verdict and a two-cycle crash storm, each on a non-idle cycle.
FAULTS = ("oracle-crash@cycle:3,delay-verdict@cycle:5:50,"
          "oracle-crash-storm@cycle:6:2")


@contextmanager
def pinned_uids(types):
    """Workload uids from ``UID_START`` in ``types`` (either package's
    API types module) for the block; the counter is restored after."""
    old = types._uid_counter
    types._uid_counter = itertools.count(UID_START)
    try:
        yield
    finally:
        types._uid_counter = old


def record(config: dict, path: str, kit=None) -> tuple:
    """(engine_worlds.run result, info) of ``config`` recorded into
    ``path``. ``info``: the recorder's ``digest``, ``frames`` and
    ``cycles``, the trace's ``bytes``, the bootstrap's ``bootstrap_s``
    and ``bootstrap_frames``, and ``dispatched``, the executor calls
    the run made."""
    kit = kit or ew.port_kit()
    info: dict = {}

    @contextmanager
    def recorded(engine):
        counter = count_dispatches(engine)
        t0 = time.perf_counter()
        rec = kit.replay.FlightRecorder(engine, path, label=LABEL,
                                        bootstrap=True)
        info["bootstrap_s"] = time.perf_counter() - t0
        info["bootstrap_frames"] = rec.writer.frames
        try:
            yield
        finally:
            rec.close()
            info.update(digest=rec.digest, frames=rec.writer.frames,
                        cycles=rec.writer.cycles,
                        bytes=os.path.getsize(path),
                        dispatched=counter["calls"])

    with pinned_uids(kit.types):
        r = ew.run(config, kit=kit, obs=recorded)
    return r, info


def count_dispatches(engine) -> dict:
    """Count the ``cycle_step`` calls that reach ``engine``'s executor:
    wrapped on the executor object itself, behind a fault proxy when one
    is in front of it, so a call the proxy fails is not counted. Returns
    the live counter."""
    counter = {"calls": 0}
    ex = engine.oracle.executor
    ex = getattr(ex, "inner", ex)
    inner = ex.cycle_step

    def cycle_step(tensors, statics):
        counter["calls"] += 1
        return inner(tensors, statics)

    ex.cycle_step = cycle_step
    return counter


def replay(config: dict, path: str, mode: str, kit=None,
           faults=None) -> tuple:
    """(report, info) of the kit's ``replay_trace`` of ``path`` in
    ``mode`` on ``config``'s loop arm, under the fault plan ``faults``
    (a spec) when given. ``info``: ``rebuild_s`` (the input frames, up to
    the first cycle) and, per engine with an oracle (by role: ``device``
    in the device and both modes), its ``dispatched`` executor calls and
    its bridge's ``on_device``, ``hybrid``, ``fallback``,
    ``fallback_reasons`` and ``pipeline_stats``; with ``faults``, the
    injector's ``fired`` list and the proxy's ``injected_errors`` and
    ``delayed_calls``."""
    kit = kit or ew.port_kit()
    built: list = []
    marks: dict = {}
    counters: dict = {}

    def first_cycle(seq, engine):
        # Inputs make no executor call: count from the first cycle on.
        if "first_cycle" not in marks:
            marks["first_cycle"] = time.perf_counter()
        if id(engine) not in counters and engine.oracle is not None:
            counters[id(engine)] = count_dispatches(engine)

    def factory():
        eng = kit.engine(False)
        # The recorded run's GC posture (engine_worlds.run): automatic
        # collection off, a young sweep after every cycle.
        eng.apply_serving_gc_posture()
        eng.pre_cycle_hooks.append(first_cycle)
        built.append(eng)
        return eng

    with ew.loop_arm(config.get("arm")):
        t0 = time.perf_counter()
        try:
            report = kit.replay.replay_trace(
                path, mode, engine_factory=factory, faults=faults)
        finally:
            gc.enable()
            gc.unfreeze()
    info: dict = {"rebuild_s": marks.get("first_cycle", t0) - t0}
    roles = ["host", "device"] if mode == "both" else [mode]
    for role, eng in zip(roles, built):
        b = eng.oracle
        if b is None:
            continue
        info[role] = dict(
            dispatched=counters.get(id(eng), {"calls": 0})["calls"],
            on_device=b.cycles_on_device, hybrid=b.cycles_hybrid,
            fallback=b.cycles_fallback,
            fallback_reasons=dict(sorted(b.fallback_reasons.items())),
            pipeline_stats=dict(b.pipeline_stats))
    if faults is not None:
        inj = injector_of(built[0])
        info.update(fired=list(inj.fired),
                    injected_errors=inj.proxy.injected_errors,
                    delayed_calls=inj.proxy.delayed_calls)
    return report, info


def injector_of(engine):
    """The FaultInjector armed on ``engine`` (its pre-cycle hook's
    owner)."""
    for fn in engine.pre_cycle_hooks:
        owner = getattr(fn, "__self__", None)
        if owner is not None and hasattr(owner, "fired"):
            return owner
    raise LookupError("no fault injector armed on the engine")


def masked_frames(path: str) -> list:
    """The trace's frames in order, each without ``phases`` and ``crc``
    (read as written: the CRC chain is not checked here)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if line.strip():
                frame = json.loads(line)
                frame.pop("phases", None)
                frame.pop("crc", None)
                out.append(frame)
    return out


def masked_checksum(path: str) -> int:
    crc = 0
    for frame in masked_frames(path):
        crc = zlib.crc32(json.dumps(frame, sort_keys=True,
                                    separators=(",", ":")).encode(), crc)
    return crc
