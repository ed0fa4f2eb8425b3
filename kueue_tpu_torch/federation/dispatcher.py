"""FederationDispatcher: the routing tier in front of N HA cells.

The port of ``kueue_tpu/federation/dispatcher.py``. The route journal is
the port's ``store/journal.Journal``; ``HANDOFF_CRASH_HOOK`` is this
module's own global (setting the JAX package's does not reach it). Route
records carry ``ts=now``, so two dispatchers write byte-identical
journals only when given one ``now``. ``_headroom_score`` scans every
route for every pick, as the JAX one does: quadratic in the routes.

Protocol (the exactly-once argument, ARCHITECTURE.md "Federation"):

  1. ``submit`` picks a cell (quota headroom + SLO burn + zone
     locality), journals a ``fed_route`` INTENT record carrying the
     full workload body, and fsyncs it BEFORE the handoff leaves the
     process. A dispatcher crash at any later point replays to a
     consistent routing state: every unacked intent is re-sent.
  2. The handoff POST is at-least-once: re-sends are deduplicated by
     workload name at the cell's front door (ha/replica.py submit —
     200 deduplicated vs 201 fresh), so at-least-once sends compose to
     exactly-once admission per cell.
  3. Health probes feed a per-cell circuit breaker (cells.py, the
     oracle supervisor's shape). The breaker OPENING fences the cell:
     its epoch is bumped and journaled (``fed_cell``), and every route
     on it not yet CONFIRMED admitted is re-routed to survivors.
  4. A zombie cell rejoining (half-open probe succeeds) is reconciled
     before it re-enters rotation: any workload it admitted whose
     route now points elsewhere is revoked — deleted cell-side under
     the bumped fence epoch, so a late handoff replay at the old epoch
     is refused (409) and the zombie cannot double-admit.

Route states: intent -> acked -> admitted (terminal). State changes
are journaled so a crashed dispatcher never re-routes a workload it
already confirmed. The journal kinds are declared ephemeral in
store/journal.py (graftlint R1): they fold into THIS dispatcher's
routing table, never into an engine.
"""

from __future__ import annotations

import json
from typing import Optional

from kueue_tpu_torch.api.serde import to_jsonable
from kueue_tpu_torch.federation.cells import (
    OPEN,
    CellHandle,
    CellTransportError,
)

# Test hook (the MAINTENANCE_CRASH_HOOK idiom): called with the handoff
# ordinal and workload key AFTER the route intent is durable and BEFORE
# the transport send — the nastiest point for a dispatcher crash.
HANDOFF_CRASH_HOOK = None

INTENT, ACKED, ADMITTED = "intent", "acked", "admitted"
_CONFIRMED_STATUSES = ("Admitted", "QuotaReserved", "Finished")


class FederationDispatcher:
    """Routes workloads across ``cells``; owns the durable route
    journal at ``journal_path`` (store/journal.py segments)."""

    def __init__(self, journal_path: str, cells: list,
                 metrics=None, hub=None, zone: str = "",
                 confirm_interval_ticks: int = 2,
                 locality_label: str = "kueue.tpu/zone",
                 fsync: bool = True):
        from kueue_tpu_torch.store.journal import Journal

        self.cells: dict[str, CellHandle] = {c.name: c for c in cells}
        self.metrics = metrics
        self.hub = hub
        self.zone = zone
        self.locality_label = locality_label
        self.confirm_interval_ticks = max(1, int(confirm_interval_ticks))
        self.tick_seq = 0
        self.handoffs = 0
        self.redispatches = 0
        self.revocations = 0
        for c in self.cells.values():
            if c.metrics is None:
                c.metrics = metrics
                c.breaker.metrics = metrics
        # key -> route record (the fold of the journal's fed_route
        # stream; the journal is the source of truth across crashes).
        self.routes: dict[str, dict] = {}
        self.journal = Journal(journal_path, fsync=fsync)
        self._replay()

    # -- crash recovery --

    def _replay(self) -> None:
        """Fold the route journal: last record wins per key. Unacked
        intents go back on the wire (at-least-once; the cells dedup)."""
        cell_state: dict[str, dict] = {}
        for rec in self.journal.replay():
            obj = rec.get("obj", {})
            if rec["kind"] == "fed_route":
                if rec["op"] == "delete":
                    self.routes.pop(rec["key"], None)
                else:
                    self.routes[obj["name"]] = dict(obj)
            elif rec["kind"] == "fed_cell" and rec["op"] != "delete":
                cell_state[obj["name"]] = obj
        for name, st in cell_state.items():
            cell = self.cells.get(name)
            if cell is not None:
                # Epochs only move forward: a replayed fence must
                # still dominate anything the old process handed out.
                cell.epoch = max(cell.epoch, int(st.get("epoch", 1)))
                if not st.get("up", True):
                    # Last journaled word on this cell was a fence with
                    # no reconcile after it: a dispatcher that crashed
                    # in that window must still treat the cell's next
                    # successful probe as a zombie rejoin.
                    cell.needs_reconcile = True

    # -- routing --

    def _headroom_score(self, cell: CellHandle, wl_zone: str) -> float:
        """Lower is better. Quota headroom proxy (the cell's own
        registered+in-flight load), SLO burn (the cell shedder's
        SLO-coupled factor: 1.0 = budget intact), topology locality."""
        load = float(cell.last_probe.get("workloads", 0))
        load += sum(1 for r in self.routes.values()
                    if r["cell"] == cell.name and r["state"] != ADMITTED)
        shed = cell.last_probe.get("shedder") or {}
        burn = 1.0 - float(shed.get("factor", 1.0))
        locality = 0.0 if (wl_zone and wl_zone == cell.zone) else 4.0
        if not wl_zone:
            locality = 0.0
        return load + 8.0 * burn + locality

    def _pick_cell(self, workload=None,
                   exclude: tuple = ()) -> Optional[CellHandle]:
        wl_zone = ""
        if workload is not None:
            labels = getattr(workload, "labels", None) or {}
            wl_zone = labels.get(self.locality_label, "")
        best, best_score = None, None
        for name in sorted(self.cells):
            cell = self.cells[name]
            if name in exclude or not cell.up:
                continue
            score = self._headroom_score(cell, wl_zone)
            if best_score is None or score < best_score:
                best, best_score = cell, score
        return best

    # -- the write front door (serve.py --federate POSTs land here) --

    def submit(self, workload, now: float) -> dict:
        key = workload.key
        existing = self.routes.get(key)
        if existing is not None:
            # Idempotent retry across the whole federation: the route
            # journal is the dedup surface, exactly like the cell-side
            # workload-name dedup one layer down.
            return {"accepted": True, "code": 200, "workload": key,
                    "deduplicated": True, "cell": existing["cell"],
                    "state": existing["state"]}
        cell = self._pick_cell(workload)
        if cell is None:
            return {"accepted": False, "code": 503,
                    "reason": "no healthy cell",
                    "retryAfter": 1.0,
                    "cells": [c.status() for c in self.cells.values()]}
        rec = {"name": key, "cell": cell.name, "state": INTENT,
               "epoch": cell.epoch, "attempt": 1,
               "wl": to_jsonable(workload), "ts": now}
        # Intent durable BEFORE the handoff leaves the process: the
        # crash-honesty half of the exactly-once story.
        self.journal.apply("fed_route", rec, ts=now)
        self.journal.sync()
        self.routes[key] = rec
        verdict = self._handoff(rec, now)
        code = 201 if verdict.get("code") == 201 else (
            200 if verdict.get("code") == 200 else 202)
        return {"accepted": True, "code": code, "workload": key,
                "cell": cell.name, "state": rec["state"]}

    def _handoff(self, rec: dict, now: float) -> dict:
        """One at-least-once send of a route intent to its cell."""
        global HANDOFF_CRASH_HOOK
        cell = self.cells[rec["cell"]]
        self.handoffs += 1
        if HANDOFF_CRASH_HOOK is not None:
            HANDOFF_CRASH_HOOK(self.handoffs, rec["name"])
        try:
            # graftlint: allow[F1] at-least-once handoff of an already-durable intent: every caller journals+fsyncs the route record before invoking _handoff; the ACK can only be journaled after the RPC returns
            verdict = cell.transport.submit(rec["wl"],
                                            route_epoch=rec["epoch"])
        except CellTransportError as e:
            self._count("federation_dispatch_total",
                        (cell.name, "unreachable"))
            return {"code": 0, "error": str(e)}
        code = verdict.get("code", 0)
        if code in (200, 201):
            rec["state"] = ACKED
            self.journal.apply("fed_route", rec, ts=now)
            self._count("federation_dispatch_total", (cell.name, "acked"))
            self._observe("federation_handoff_latency_seconds",
                          (cell.name,), max(0.0, now - rec["ts"]))
            self._publish("federation_route",
                          {"workload": rec["name"], "cell": cell.name,
                           "state": ACKED})
        elif code == 409:
            # Fenced: the cell saw this key revoked at our epoch or
            # newer — a newer route owns it. Leave the record for the
            # resend loop to re-route under a fresh epoch.
            self._count("federation_dispatch_total", (cell.name, "fenced"))
        else:
            # 503 (mid-election) / 429 (shed): healthy refusal, the
            # resend loop retries next tick.
            self._count("federation_dispatch_total",
                        (cell.name, f"http{code}"))
        return verdict

    # -- the drive loop --

    def tick(self, now: float) -> None:
        """One dispatcher cycle: probe due cells, drain newly-opened
        breakers, re-send pending intents, confirm admissions."""
        self.tick_seq += 1
        for name in sorted(self.cells):
            cell = self.cells[name]
            if not cell.probe_due(self.tick_seq):
                continue
            self._probe(cell, now)
        self._resend(now)
        if self.tick_seq % self.confirm_interval_ticks == 0:
            self._confirm(now)
        self.journal.sync()
        self._export()

    def _probe(self, cell: CellHandle, now: float) -> None:
        cell.last_probe_tick = self.tick_seq
        try:
            payload = cell.transport.health()
        except CellTransportError:
            was_up = cell.up
            cell.up = False
            opened = cell.breaker.record_failure(self.tick_seq)
            cell.schedule_next_probe(self.tick_seq, failed=True)
            if opened:
                self._drain(cell, now)
            elif was_up:
                # graftlint: allow[F1] pure health notification: probe transitions are transient cell state, never journaled — there is nothing for durability to order against
                self._publish("federation_cell",
                              {"cell": cell.name, "up": False,
                               "reason": "probe failed"})
            return
        cell.breaker.record_success()
        cell.last_probe = payload
        cell.schedule_next_probe(self.tick_seq, failed=False)
        is_leader = payload.get("role") == "leader"
        if not is_leader:
            # Reachable but mid-election: healthy refusal, not a fault.
            cell.up = False
            return
        if getattr(cell, "needs_reconcile", False):
            # Zombie rejoin: reconcile BEFORE re-entering rotation.
            if not self._reconcile(cell, now):
                return
        if not cell.up:
            cell.up = True
            # graftlint: allow[F1] pure health notification: probe transitions are transient cell state, never journaled — there is nothing for durability to order against
            self._publish("federation_cell",
                          {"cell": cell.name, "up": True,
                           "epoch": cell.epoch})

    def _drain(self, cell: CellHandle, now: float) -> None:
        """Whole-cell failure path: fence the cell (epoch bump,
        journaled), then re-route everything on it not yet CONFIRMED
        admitted. Confirmed admissions stay — they are durable in the
        cell's own journal and come back with it."""
        cell.up = False
        cell.needs_reconcile = True
        cell.epoch += 1
        self.journal.apply("fed_cell",
                           {"name": cell.name, "epoch": cell.epoch,
                            "up": False}, ts=now)
        self.journal.sync()
        moved = 0
        for key in sorted(self.routes):
            rec = self.routes[key]
            if rec["cell"] != cell.name or rec["state"] == ADMITTED:
                continue
            target = self._pick_cell(exclude=(cell.name,))
            if target is None:
                continue  # no survivors yet; _resend keeps trying
            rec.update(cell=target.name, state=INTENT,
                       epoch=target.epoch,
                       attempt=rec.get("attempt", 1) + 1)
            self.journal.apply("fed_route", rec, ts=now)
            self._count("federation_redispatch_total",
                        (cell.name, target.name))
            self._handoff(rec, now)
            moved += 1
        self.redispatches += moved
        self.journal.sync()
        self._publish("federation_cell",
                      {"cell": cell.name, "up": False,
                       "epoch": cell.epoch, "drained": moved,
                       "reason": "breaker open"})

    def _resend(self, now: float) -> None:
        """At-least-once delivery of pending intents. Intents stranded
        on a down cell are re-routed as capacity appears."""
        for key in sorted(self.routes):
            rec = self.routes[key]
            if rec["state"] != INTENT:
                continue
            cell = self.cells.get(rec["cell"])
            if cell is not None and cell.up:
                self._handoff(rec, now)
            elif cell is None or cell.breaker.state == OPEN:
                target = self._pick_cell(exclude=(rec["cell"],))
                if target is None:
                    continue
                rec.update(cell=target.name, state=INTENT,
                           epoch=target.epoch,
                           attempt=rec.get("attempt", 1) + 1)
                self.journal.apply("fed_route", rec, ts=now)
                self._count("federation_redispatch_total",
                            (rec["cell"], target.name))
                self._handoff(rec, now)

    def _confirm(self, now: float) -> None:
        """Poll each live cell's workload list and promote acked
        routes to ADMITTED (terminal) once the cell reports the
        admission. Confirmed routes are never re-routed by a drain."""
        for name in sorted(self.cells):
            cell = self.cells[name]
            if not cell.up:
                continue
            try:
                listed = cell.transport.workloads()
            except CellTransportError:
                continue  # the probe path owns failure accounting
            confirmed = {f"{w['namespace']}/{w['name']}"
                         for w in listed
                         if w.get("status") in _CONFIRMED_STATUSES}
            for key, rec in self.routes.items():
                if (rec["cell"] == name and rec["state"] != ADMITTED
                        and key in confirmed):
                    rec["state"] = ADMITTED
                    self.journal.apply("fed_route", rec, ts=now)
                    self._publish("federation_route",
                                  {"workload": key, "cell": name,
                                   "state": ADMITTED})

    def _reconcile(self, cell: CellHandle, now: float) -> bool:
        """Zombie-rejoin fencing: before the cell re-enters rotation,
        revoke every workload it admitted whose route now points at a
        survivor (it was drained away while the cell was dark). The
        revocation carries the post-drain fence epoch, so the zombie
        also refuses any late handoff replay at the old epoch."""
        try:
            listed = cell.transport.workloads()
        except CellTransportError:
            return False
        present = {f"{w['namespace']}/{w['name']}": w.get("status")
                   for w in listed}
        revoke = []
        for key, status in sorted(present.items()):
            rec = self.routes.get(key)
            if rec is None or rec["cell"] == cell.name:
                continue
            revoke.append(key)
        if revoke:
            try:
                # graftlint: allow[F1] reconcile revokes keys whose re-route is already journaled+fsynced (the drain fence); the zombie's tombstones are the RPC's outcome, journaled after it returns
                cell.transport.revoke(revoke, epoch=cell.epoch)
            except CellTransportError:
                return False
            self.revocations += len(revoke)
            self._count("federation_revocations_total", (cell.name,),
                        n=len(revoke))
            # The tombstones fence everything AT OR BELOW the
            # revocation epoch; move the cell past it so a future
            # legitimate re-route of a once-revoked key back here
            # (its survivor died too) dominates the fence instead of
            # 409ing forever.
            cell.epoch += 1
        # Routes still pointing at the zombie (drained with no
        # survivor, or confirmed there pre-crash) that it durably
        # admitted are good: adopt the admission.
        for key, rec in self.routes.items():
            if (rec["cell"] == cell.name and rec["state"] != ADMITTED
                    and present.get(key) in _CONFIRMED_STATUSES):
                rec["state"] = ADMITTED
                self.journal.apply("fed_route", rec, ts=now)
        cell.needs_reconcile = False
        self.journal.apply("fed_cell",
                           {"name": cell.name, "epoch": cell.epoch,
                            "up": True}, ts=now)
        self.journal.sync()
        self._publish("federation_cell",
                      {"cell": cell.name, "up": True,
                       "epoch": cell.epoch, "revoked": len(revoke),
                       "reason": "reconciled"})
        return True

    # -- observability --

    def _count(self, family: str, labels: tuple, n: int = 1) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.counter(family).inc(labels, n)
        except KeyError:
            pass

    def _observe(self, family: str, labels: tuple, v: float) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.histogram(family).observe(v, labels)
        except KeyError:
            pass

    def _publish(self, kind: str, body: dict) -> None:
        if self.hub is not None:
            self.hub.publish(kind, json.dumps(body))

    def _export(self) -> None:
        if self.metrics is None:
            return
        counts = self.route_counts()
        try:
            for state in (INTENT, ACKED, ADMITTED):
                self.metrics.gauge("federation_routes").set(
                    (state,), float(counts.get(state, 0)))
            for cell in self.cells.values():
                self.metrics.gauge("federation_cell_up").set(
                    (cell.name,), 1.0 if cell.up else 0.0)
        except KeyError:
            pass

    def route_counts(self) -> dict:
        counts: dict[str, int] = {}
        for rec in self.routes.values():
            counts[rec["state"]] = counts.get(rec["state"], 0) + 1
        return counts

    def status(self) -> dict:
        per_cell: dict[str, dict] = {}
        for rec in self.routes.values():
            d = per_cell.setdefault(rec["cell"], {})
            d[rec["state"]] = d.get(rec["state"], 0) + 1
        return {
            "tick": self.tick_seq,
            "handoffs": self.handoffs,
            "redispatches": self.redispatches,
            "revocations": self.revocations,
            "routes": self.route_counts(),
            "cells": [dict(self.cells[n].status(),
                           routes=per_cell.get(n, {}))
                      for n in sorted(self.cells)],
        }

    def close(self) -> None:
        self.journal.sync()
        self.journal.close()
