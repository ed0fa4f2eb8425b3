"""Aggregated cross-cell SSE view (the port of
``kueue_tpu/federation/aggregator.py``): one tailer thread per cell follows
the cell's /events stream and republishes every event into the
dispatcher's FanoutHub, tagged with the cell name. Browsers/CLIs watch
ONE endpoint (the dispatcher's /events) and see the whole federation.

Liveness under failure is structural, not best-effort: a dead cell
kills only its own tailer's connection — the thread reconnects with
capped backoff while every other cell's events (and the dispatcher's
own federation_route / federation_cell events) keep flowing through
the hub. The bench's federation_failover scenario asserts exactly
this: the aggregated stream stays live across a whole-cell SIGKILL.
"""

from __future__ import annotations

import json
import threading
import urllib.request


class CellEventTailer:
    """Follows one cell's SSE stream; republishes into ``hub``."""

    def __init__(self, cell_name: str, events_url: str, hub,
                 reconnect_seconds: float = 1.0):
        self.cell_name = cell_name
        self.events_url = events_url
        self.hub = hub
        self.reconnect_seconds = float(reconnect_seconds)
        self.events_relayed = 0
        self.reconnects = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name=f"fed-tail-{cell_name}", daemon=True)

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._follow()
            except (OSError, ValueError):
                pass  # connection refused/reset: the cell is down
            if self._stop.wait(self.reconnect_seconds):
                return
            self.reconnects += 1

    def _follow(self) -> None:
        # Short read timeout so a stalled stream re-checks _stop; the
        # cell's SSE heartbeat (~15 s) keeps healthy streams alive.
        with urllib.request.urlopen(self.events_url, timeout=30) as resp:
            kind = ""
            for raw in resp:
                if self._stop.is_set():
                    return
                line = raw.decode("utf-8", "replace").rstrip("\n")
                if line.startswith("event:"):
                    kind = line[len("event:"):].strip()
                elif line.startswith("data:"):
                    data = line[len("data:"):].strip()
                    self._relay(kind or "message", data)
                    kind = ""

    def _relay(self, kind: str, data: str) -> None:
        try:
            body = json.loads(data)
            if isinstance(body, dict):
                body.setdefault("cell", self.cell_name)
                data = json.dumps(body)
        except ValueError:
            pass  # non-JSON payload: relay verbatim
        self.hub.publish(kind, data)
        self.events_relayed += 1


class CellReadAggregator:
    """Aggregated per-cell reads over the global read plane: one
    ReadFrontend per cell (each routing to that cell's replicas, never
    its leader), fanned out per query and merged with per-cell
    staleness envelopes intact. A dead cell degrades to an explicit
    per-cell error entry — the federation answer never silently drops
    a cell, and the caller sees exactly which cell answered from which
    journal position at what age."""

    def __init__(self, frontends: dict):
        """``frontends``: {cell_name: kueue_tpu_torch.readplane.ReadFrontend}."""
        self.frontends = dict(frontends)
        self.queries = 0

    def query(self, kind: str, arg: str = None) -> dict:
        self.queries += 1
        cells: dict = {}
        for name in sorted(self.frontends):
            try:
                cells[name] = self.frontends[name].query(kind, arg)
            except Exception as e:  # noqa: BLE001 — cell-wide outage
                cells[name] = {"error": str(e), "staleness": None}
        return {"kind": kind, "cells": cells,
                "staleness": {
                    name: (ans.get("staleness") or {}).get(
                        "wallAgeSeconds")
                    for name, ans in cells.items()}}

    def status(self) -> dict:
        return {"queries": self.queries,
                "cells": {name: fe.status()
                          for name, fe in sorted(self.frontends.items())}}


class EventAggregator:
    """Owns one tailer per cell; lifecycle matches the dispatcher."""

    def __init__(self, cells: list, hub,
                 reconnect_seconds: float = 1.0):
        self.tailers = [
            CellEventTailer(c.name, c.transport.events_url, hub,
                            reconnect_seconds=reconnect_seconds)
            for c in cells
            if hasattr(c.transport, "events_url")]

    def start(self) -> None:
        for t in self.tailers:
            t.start()

    def stop(self) -> None:
        for t in self.tailers:
            t.stop()

    def stats(self) -> dict:
        return {t.cell_name: {"relayed": t.events_relayed,
                              "reconnects": t.reconnects}
                for t in self.tailers}
