"""Serving-engine runs with the obs layer attached: the tracer (ring 64)
and the perf recorder, probed cycle by cycle.

``run(config, kit, extra)`` is ``engine_worlds.run`` of a ``cycles``
config with, once the world is built and its oracle attached, the
tracer and the perf recorder attached and a cycle listener after them
that records each non-idle cycle's correlation id, its committed device
calls (``perf_kernel_launches_total{cycle_step}``), host-to-device and
device-to-host bytes, its shape-signature cache hits and misses, and its
perf samples. ``extra(engine)``, when given, returns a context manager
entered inside that: ``attached`` is the one that ``chip_smoke.py``
phase 27 and ``obs_overhead`` use (the SLO engine, the watchdog, a
fanout hub with one draining subscriber, the cycles profiled). Each
attachment is made through the engine's own ``attach_*`` methods and
hook lists, so the same run goes through the JAX package's engine with
its kit: ``obs_numbers`` of the two are the numbers the parity tests and
``chip_smoke.py`` hold equal.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import contextmanager, nullcontext

from kueue_tpu_torch.bench import engine_worlds as ew

SITE = "cycle_step"


class Probe:
    """Per-cycle obs numbers of one engine (see the module docstring)."""

    def __init__(self, engine, retain: int = 64):
        self.engine = engine
        self.tracer = engine.attach_tracer(retain=retain)
        self.perf = engine.attach_perf()
        self.cycles: list = []
        self._prev: dict = {}
        self._post = self._on_cycle
        engine.cycle_listeners.append(self._post)

    def _counters(self) -> dict:
        reg = self.engine.registry
        out = {}
        for fam in ("perf_kernel_launches_total",
                    "perf_transfer_bytes_total",
                    "perf_jit_cache_events_total"):
            for labels, v in reg.counter(fam).values.items():
                if labels and labels[0] == SITE:
                    out[(fam,) + tuple(labels[1:])] = v
        return out

    def _on_cycle(self, seq, result) -> None:
        now = self._counters()
        prev, self._prev = self._prev, now
        if result is None:
            return
        delta = {k: v - prev.get(k, 0.0) for k, v in now.items()}
        self.cycles.append(dict(
            cid=self.tracer.last_cid,
            traced=self.tracer.cycles_traced,
            launches=int(delta.get(("perf_kernel_launches_total",), 0)),
            h2d=int(delta.get(("perf_transfer_bytes_total", "h2d"), 0)),
            d2h=int(delta.get(("perf_transfer_bytes_total", "d2h"), 0)),
            hits=int(delta.get(("perf_jit_cache_events_total", "hit"), 0)),
            misses=int(delta.get(("perf_jit_cache_events_total", "miss"),
                                 0)),
            samples=list(self.perf.last_cycle_samples)))

    def detach(self) -> None:
        try:
            self.engine.cycle_listeners.remove(self._post)
        except ValueError:
            pass
        self.perf.detach()
        self.tracer.detach()


def obs_numbers(probe: Probe) -> dict:
    """What a traced run pins against the JAX package's: the cycles
    traced, the cid chain, the committed device calls, the bytes each
    way and the signature cache's (hits, misses) per cycle."""
    cyc = probe.cycles
    return dict(
        cycles_traced=probe.tracer.cycles_traced,
        cids=[c["cid"] for c in cyc],
        launches=sum(c["launches"] for c in cyc),
        h2d_bytes=sum(c["h2d"] for c in cyc),
        d2h_bytes=sum(c["d2h"] for c in cyc),
        jit=[(c["hits"], c["misses"]) for c in cyc])


def subphase_seconds(probe: Probe) -> dict:
    """{sub-phase: [seconds per cycle]} of the perf samples, each cycle's
    samples of one name summed."""
    out: dict = {}
    for c in probe.cycles:
        per: dict = {}
        for name, secs in c["samples"]:
            per[name] = per.get(name, 0.0) + secs
        for name, secs in per.items():
            out.setdefault(name, []).append(secs)
    return out


@contextmanager
def attached(engine, *, hub: bool = False, watchdog=None,
             profile_dir=None):
    """The traced cell's attachments beyond the tracer and the perf
    recorder: the SLO engine; with ``watchdog=(deadline_s, hang_s)`` the
    cycle watchdog; with ``hub`` a ``FanoutHub`` of 2 shards whose queues
    hold a whole window's events (it drops none) and one subscriber that
    a thread drains; with ``profile_dir`` every cycle of the block inside
    ``engine.profiled(profile_dir)``. Yields a dict that holds, once the
    block has exited, the window's engine events (``events``), what the
    subscriber saw as (kind, data) in order (``seen``), the hub's stats
    (``hub``) and the watchdog's status (``watchdog``)."""
    from kueue_tpu_torch.obs.watchdog import attach_watchdog
    from kueue_tpu_torch.visibility.fanout import FanoutHub

    got: dict = {}
    slo = engine.attach_slo()
    wd = (attach_watchdog(engine, deadline_s=watchdog[0],
                          hang_after_s=watchdog[1])
          if watchdog is not None else None)
    fan = reader = None
    seen: list = []
    stop = threading.Event()
    if hub:
        fan = FanoutHub(shards=2, client_queue_depth=1 << 17,
                        inbox_depth=1 << 17)
        fan.attach_engine(engine)
        client = fan.subscribe()

        def drain():
            while True:
                try:
                    seen.append(client.get(timeout=0.05))
                except queue.Empty:
                    if stop.is_set():
                        return

        reader = threading.Thread(target=drain)
        reader.start()
    first = len(engine.events)
    try:
        with (engine.profiled(profile_dir) if profile_dir is not None
              else nullcontext()):
            yield got
    finally:
        if fan is not None:
            while any(not s.inbox.empty() for s in fan.shards):
                time.sleep(0.01)
            time.sleep(0.2)
            stop.set()
            reader.join()
            got["hub"] = fan.stats()
            fan.close()
        got.update(seen=seen, events=engine.events[first:],
                   watchdog=wd.status() if wd is not None else None)
        if wd is not None:
            wd.detach()
        slo.detach()


def run(config: dict, kit=None, extra=None) -> tuple:
    """(engine_worlds.run result, Probe) of a traced ``cycles`` run."""
    box = {}

    @contextmanager
    def obs(engine):
        probe = box["probe"] = Probe(engine)
        try:
            with extra(engine) if extra is not None else nullcontext():
                yield
        finally:
            probe.detach()

    r = ew.run(config, kit=kit, obs=obs)
    return r, box["probe"]
