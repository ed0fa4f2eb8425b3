"""Always-on perf telemetry: apply-phase micro-attribution + device
counters.

The engine's phase clocks say how long a cycle's apply takes; this layer
says *where inside apply* the time goes, continuously and cheaply enough
to leave on in production. Two pieces:

  * **Scope samples** — decision-path code brackets its apply sub-steps
    (columnar diff build, rowcache writeback, undo-log commit, journal
    append, listener fanout) with ``begin()``/``end()`` calls that cost
    one global load when recording is off (the obs.hooks CURRENT-slot
    pattern). Samples buffer per cycle and flush into deterministic,
    mergeable :class:`PhaseHistogram` aggregates keyed by
    ``(subphase, mode)`` — mode resolves only at cycle end
    (Engine.last_cycle_mode), so the emit sites stay mode-agnostic.
  * **Device counters** — kernel launch counts, host↔device transfer
    bytes, jit compile cache hits/misses (tracked as *shape
    signatures*: a (shapes, dtypes, statics) tuple not seen before at a
    call site is a miss — the JAX package's deterministic proxy for a
    compile cache, kept so the sequences compare), and the TAS
    batched-vs-host-fallback cycle mix (deltas of the bridge's
    tas_stats). Flushed to the metrics registry at cycle end.

Histogram bucket edges are the fixed log-spaced
``metrics.registry.PERF_BUCKETS`` — never fitted to data — so
histograms from different runs, processes, or replicas merge by
element-wise addition.

Digest neutrality: everything here is write-only over engine state.
Timing uses ``time.perf_counter`` *inside this module* (the obs zone,
where wall clocks are legal); decision zones only call the
``begin``/``end``/``count`` wrappers, whose results can never feed back
into a scheduling decision. Traced and untraced runs therefore produce
byte-identical decision digests (tests/test_torch_obs_perf.py).

The port of ``kueue_tpu/obs/perf.py``. Device counters read ``nbytes``,
``shape`` and ``dtype``, which torch tensors and numpy arrays both
carry, so the byte counts equal the JAX package's on the same world;
the signature strings do not (``torch.int64`` against ``int64``), so
only the hit/miss sequence compares across the packages.

Process-global ACTIVE slot by design, like obs.hooks: one engine per
process is the serving posture.
"""

from __future__ import annotations

import time
from bisect import bisect_left
from typing import Optional

from kueue_tpu_torch.metrics.registry import PERF_BUCKETS

ACTIVE: Optional["PerfRecorder"] = None

# The apply-phase vocabulary: every named sub-step a cycle's
# apply span decomposes into, on either decision path.
APPLY_SUBPHASES = (
    "apply.diff_build",        # entry/assignment construction from verdicts
    "apply.rowcache_writeback",  # pending-world exit + cache assume
    "apply.undo_log_commit",   # snapshot close: TAS undo-scope unwind
    "apply.journal_append",    # workload records to the journal
    "apply.listener_fanout",   # events + status conditions to listeners
)

BUCKET_EDGES = PERF_BUCKETS


def begin() -> Optional[float]:
    """Open a scope: a perf_counter mark, or None when recording is off
    (one global load + identity check on the hot path)."""
    if ACTIVE is None:
        return None
    return time.perf_counter()


def end(name: str, t0: Optional[float]) -> None:
    """Close a scope opened by :func:`begin`; free when recording is
    off or the scope was opened while it was off."""
    rec = ACTIVE
    if rec is not None and t0 is not None:
            rec._samples.append((name, time.perf_counter() - t0))


def count(family: str, labels: tuple = (), amount: float = 1.0) -> None:
    """Buffer a counter increment; flushed to the registry at cycle
    end (one dict write per call site per cycle, not per event)."""
    rec = ACTIVE
    if rec is not None:
        key = (family, labels)
        rec._counts[key] = rec._counts.get(key, 0.0) + amount


def device_call(site: str, tensors: dict, statics: dict) -> None:
    """Record one device program launch: launch count, host→device
    bytes, and the jit shape-signature cache event for ``site``."""
    rec = ACTIVE
    if rec is None:
        return
    rec._counts[("perf_kernel_launches_total", (site,))] = \
        rec._counts.get(("perf_kernel_launches_total", (site,)), 0.0) + 1
    h2d = 0
    sig = []
    for k in sorted(tensors):
        v = tensors[k]
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            h2d += int(nb)
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        sig.append((k, tuple(shape) if shape is not None else None,
                    str(dtype)))
    count("perf_transfer_bytes_total", (site, "h2d"), float(h2d))
    signature = (tuple(sig), tuple(sorted(statics.items())))
    seen = rec._jit_sigs.setdefault(site, set())
    if signature in seen:
        count("perf_jit_cache_events_total", (site, "hit"))
    else:
        seen.add(signature)
        count("perf_jit_cache_events_total", (site, "miss"))


def device_result(site: str, outputs) -> None:
    """Record the device→host bytes of a launch's outputs."""
    if ACTIVE is None:
        return
    d2h = 0
    for v in outputs:
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            d2h += int(nb)
    count("perf_transfer_bytes_total", (site, "d2h"), float(d2h))


def active() -> bool:
    return ACTIVE is not None


class PhaseHistogram:
    """A deterministic, mergeable duration histogram over the fixed
    log-spaced :data:`BUCKET_EDGES`.

    Integer bucket counts plus (sum, total); no per-instance state
    beyond that, so ``merge`` is element-wise addition and two
    histograms built from the same observation multiset are equal
    regardless of observation order or which process observed what.
    """

    __slots__ = ("counts", "total", "sum")

    edges = BUCKET_EDGES

    def __init__(self) -> None:
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, seconds: float) -> None:
        self.counts[bisect_left(self.edges, seconds)] += 1
        self.total += 1
        self.sum += seconds

    def merge(self, other: "PhaseHistogram") -> "PhaseHistogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum
        return self

    def quantile(self, q: float) -> float:
        """Upper-bound quantile from bucket counts (0.0 when empty)."""
        if self.total <= 0:
            return 0.0
        target = q * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc and acc >= target:
                return (self.edges[i] if i < len(self.edges)
                        else float("inf"))
        return float("inf")

    def to_dict(self) -> dict:
        return {"counts": list(self.counts), "total": self.total,
                "sum": self.sum}

    @classmethod
    def from_dict(cls, d: dict) -> "PhaseHistogram":
        h = cls()
        h.counts = list(d["counts"])
        h.total = int(d["total"])
        h.sum = float(d["sum"])
        return h

    def __eq__(self, other) -> bool:
        return (isinstance(other, PhaseHistogram)
                and self.counts == other.counts
                and self.total == other.total)


class PerfRecorder:
    """The always-on aggregation point: buffers scope samples and
    counter increments during a cycle, flushes them at cycle end keyed
    by the mode the cycle resolved to."""

    def __init__(self, engine):
        global ACTIVE
        self.engine = engine
        # Hot-path buffers (appended by the module-level helpers).
        self._samples: list[tuple[str, float]] = []
        self._counts: dict[tuple, float] = {}
        self._jit_sigs: dict[str, set] = {}
        # Aggregates: (subphase, mode) -> PhaseHistogram.
        self.hist: dict[tuple[str, str], PhaseHistogram] = {}
        self.cycles_seen = 0
        # Samples of the most recently flushed cycle, for span-tree
        # nesting (obs.tracer reads these to add subphase spans).
        self.last_cycle_samples: list[tuple[str, float]] = []
        self._tas_prev = (0.0, 0.0)  # (plan_cycles, placed_host)
        self._post = self._on_cycle
        engine.cycle_listeners.append(self._post)
        engine.perf = self
        ACTIVE = self

    # Tracer hook: this cycle's samples whether or not the flush
    # listener has run yet (listener order is attach order).
    def current_samples(self) -> list[tuple[str, float]]:
        return list(self._samples) if self._samples \
            else list(self.last_cycle_samples)

    def _on_cycle(self, seq, result) -> None:
        eng = self.engine
        mode = eng.last_cycle_mode or "sequential"
        samples, self._samples = self._samples, []
        counts, self._counts = self._counts, {}
        if result is None and not samples and not counts:
            return
        self.cycles_seen += 1
        self.last_cycle_samples = samples
        try:
            reg_hist = eng.registry.histogram(
                "apply_subphase_duration_seconds")
        except KeyError:
            reg_hist = None  # registry predates the perf families
        by_name: dict[str, list] = {}
        for name, secs in samples:
            by_name.setdefault(name, []).append(secs)
        for name, vals in by_name.items():
            h = self.hist.get((name, mode))
            if h is None:
                h = self.hist[(name, mode)] = PhaseHistogram()
            for v in vals:
                h.observe(v)
            if reg_hist is not None:
                reg_hist.observe_many(vals, (name, mode))
        # TAS batched-vs-fallback cycle mix, from the bridge's stats
        # deltas: a cycle that ran the batched planner vs one whose TAS
        # heads were placed by the host fallback.
        b = eng.oracle
        if b is not None and mode in ("device", "hybrid"):
            plan = float(b.tas_stats.get("plan_cycles", 0))
            host = float(b.tas_stats.get("placed_host", 0))
            prev_plan, prev_host = self._tas_prev
            if plan > prev_plan:
                counts[("perf_tas_cycle_mix_total", ("batched",))] = \
                    counts.get(
                        ("perf_tas_cycle_mix_total", ("batched",)), 0.0) + 1
            if host > prev_host:
                counts[("perf_tas_cycle_mix_total", ("host_fallback",))] = \
                    counts.get(("perf_tas_cycle_mix_total",
                                ("host_fallback",)), 0.0) + 1
            self._tas_prev = (plan, host)
        for (family, labels), amount in counts.items():
            try:
                eng.registry.counter(family).inc(labels, amount)
            except KeyError:
                pass

    # -- query surface --

    def subphases(self, mode: Optional[str] = None) -> dict:
        """{subphase: PhaseHistogram} (merged across modes, or one
        mode's view)."""
        out: dict[str, PhaseHistogram] = {}
        for (name, m), h in self.hist.items():
            if mode is not None and m != mode:
                continue
            agg = out.get(name)
            if agg is None:
                out[name] = agg = PhaseHistogram()
            agg.merge(h)
        return out

    def summary(self) -> dict:
        """JSON-ready aggregate view (kueuectl / debug surfaces)."""
        return {
            "cyclesSeen": self.cycles_seen,
            "subphases": {
                f"{name}|{m}": {"p50": h.quantile(0.5),
                                "p95": h.quantile(0.95),
                                "total": h.total,
                                "sum_s": h.sum}
                for (name, m), h in sorted(self.hist.items())},
        }

    def detach(self) -> None:
        global ACTIVE
        try:
            self.engine.cycle_listeners.remove(self._post)
        except ValueError:
            pass
        if getattr(self.engine, "perf", None) is self:
            self.engine.perf = None
        if ACTIVE is self:
            ACTIVE = None


def attach_perf(engine) -> PerfRecorder:
    """Attach the perf telemetry layer to a live engine (idempotent)."""
    existing = getattr(engine, "perf", None)
    if existing is not None:
        return existing
    return PerfRecorder(engine)
