"""HAReplica: the per-process orchestrator serve.py runs in HA mode.

The port of ``kueue_tpu/ha/replica.py``. The lease, its renewal and its
expiry read the wall clock (``step(now)``, the renewal thread); no
scheduling decision does. ``revoke`` is reached only by the federation
dispatcher, which is not ported: it is here, unreached.

One replica = one role at a time (roles.RoleMachine). The drive loop
calls ``step(now)`` every tick:

  * follower — tail the journal (read model + SSE synthesis), then try
    the lease; winning it starts the candidate promotion protocol.
  * candidate (transient, inside ``_promote``) — replay the journal to
    head, verify the last ``ha_digest`` checkpoint (digest.py), and
    only then attach a WRITABLE journal handle and go leader.
  * leader — renew the lease every ``renew_interval``; a failed renew
    (holder or epoch mismatch: we were deposed) fences the replica
    before the next journal write can land. Renewal runs on a
    background thread (``renew_in_background``) so a long admission
    cycle can't starve it past the lease — the drive-loop renewal in
    ``step`` remains as a backstop.
  * fenced — terminal. Keeps tailing for reads; never writes again.

The journal handle a leader holds carries a fence callable
(store.journal.Journal.fence): every append re-checks
``roles.is_leader`` inside the flock critical section, so a deposed
leader's in-flight cycle dies on JournalFenced instead of interleaving
stale writes with the new leader's.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from typing import Callable, Optional

from kueue_tpu_torch.ha.digest import DigestChain, admitted_state_digest, \
    verify_promotion
from kueue_tpu_torch.ha.lease import FencedLease
from kueue_tpu_torch.ha.roles import (
    CANDIDATE,
    FENCED,
    FOLLOWER,
    LEADER,
    ROLE_CODES,
    RoleMachine,
)
from kueue_tpu_torch.ha.shedder import AdmissionShedder
from kueue_tpu_torch.ha.tailer import JournalTailer


class HAReplica:
    def __init__(self, journal_path: str, lease_path: str, identity: str,
                 lease_duration: float = 15.0,
                 renew_interval: Optional[float] = None,
                 hub=None, shedder: Optional[AdmissionShedder] = None,
                 metrics=None, fsync: bool = True,
                 engine_kwargs: Optional[dict] = None,
                 on_promote: Optional[Callable] = None,
                 on_demote: Optional[Callable] = None,
                 renew_in_background: bool = True,
                 checkpoint_interval: int = 0,
                 checkpoint_keep: int = 2,
                 segment_rotate_bytes: Optional[int] = None,
                 segment_rotate_records: Optional[int] = None,
                 retain_segments: bool = True,
                 dedup_capacity: int = 4096,
                 min_free_bytes: int = 0):
        self.journal_path = journal_path
        # Disk budget (store/diskguard.py): the promoted leader's
        # journal refuses appends below this free-space floor and the
        # submit path sheds with 503 until the budget re-arms.
        self.min_free_bytes = int(min_free_bytes)
        # Bounded-time recovery knobs (store/checkpoint.py): a leader
        # with checkpoint_interval > 0 writes sealed checkpoints every
        # N non-idle cycles and rotates the journal into segments;
        # promotion then boots from checkpoint + suffix.
        self.checkpoint_interval = int(checkpoint_interval)
        self.checkpoint_keep = int(checkpoint_keep)
        self.segment_rotate_bytes = segment_rotate_bytes
        self.segment_rotate_records = segment_rotate_records
        self.retain_segments = retain_segments
        self.identity = identity
        self.lease = FencedLease(lease_path)
        self.lease_duration = float(lease_duration)
        self.renew_interval = float(
            renew_interval if renew_interval is not None
            else lease_duration / 3.0)
        self.roles = RoleMachine(FOLLOWER)
        self.hub = hub
        self.shedder = shedder
        self.metrics = metrics
        self.fsync = fsync
        self.engine_kwargs = dict(engine_kwargs or {})
        self.on_promote = on_promote
        self.on_demote = on_demote
        self.epoch = 0
        # Bounded submit dedup map: key -> submit time, for in-flight
        # idempotent-retry acks. Entries are evicted by the post-sync
        # cycle listener once the admission is durably journaled (from
        # then on engine.workloads + the journal answer retries), so
        # the map stays O(in-flight), not O(every name ever submitted).
        # ``dedup_capacity`` is the hard backstop on top of that:
        # insertion order (OrderedDict) evicts the OLDEST entry at the
        # bound, so a submit storm that outruns the cycle listener
        # cannot grow the map without limit. An evicted key whose
        # workload is also gone from engine.workloads re-acks as a
        # fresh 201, not a stale idempotent 200 — pinned by
        # tests.
        self.dedup_capacity = max(1, int(dedup_capacity))
        self._inflight_submits: OrderedDict = OrderedDict()
        # Federation fencing surface: key -> fence epoch at revocation.
        # A handoff replay carrying a route epoch <= the recorded one
        # is refused with 409 (the zombie double-admit guard); a NEWER
        # epoch means the dispatcher deliberately routed the key back
        # here and clears the tombstone.
        self._revoked: dict = {}
        self.route_epoch = 0
        self.engine = None              # live engine (leader only)
        self.digest_chain: Optional[DigestChain] = None
        self.promotion_report: Optional[dict] = None
        self.promotion_timing: Optional[dict] = None
        self.tailer = JournalTailer(journal_path, hub=hub,
                                    metrics=metrics,
                                    engine_kwargs=self.engine_kwargs)
        self.suspend_renewal = False    # fault hook: lease-stall@cycle:N
        self._last_renew = 0.0
        # Renewal thread (leaders only): an admission cycle larger than
        # the lease window must not depose a healthy leader. Tests that
        # drive step() with a synthetic clock pass False — a wall-clock
        # renewal would pin the lease un-expirable under synthetic time.
        self.renew_in_background = renew_in_background
        self._renew_stop: Optional[threading.Event] = None
        self._fence_lock = threading.Lock()
        self.roles.listeners.append(self._on_transition)
        # A follower must serve reads from tick zero (an empty journal
        # rebuilds to an empty engine, not a 503).
        self.tailer.rebuild()

    # -- role-keyed engine access (the HTTP layer resolves per request
    # because promotion SWAPS the engine object) --

    def engine_ref(self):
        """Current engine to serve reads from: the live engine when
        leading, the tailer's read model otherwise."""
        if self.roles.is_leader and self.engine is not None:
            return self.engine
        return self.tailer.engine

    # -- the drive loop --

    def step(self, now: float) -> str:
        """One HA tick. Returns the post-tick role."""
        role = self.roles.role
        if role == LEADER:
            self._leader_tick(now)
        elif role == FOLLOWER:
            self.tailer.poll()
            state = self.lease.try_acquire(self.identity, now,
                                           self.lease_duration)
            if state is not None:
                self._last_renew = now
                self._promote(state)
        else:  # fenced: read-only forever, but stay a useful follower
            self.tailer.poll()
        self._export(now)
        return self.roles.role

    def _leader_tick(self, now: float) -> None:
        if self.suspend_renewal:
            return  # fault injection: let the lease expire underneath us
        if now - self._last_renew < self.renew_interval:
            return
        state = self.lease.renew(self.identity, self.epoch, now)
        if state is None:
            # Holder or epoch moved on: we were deposed. Fence BEFORE
            # any further journal write (the journal fence backstops
            # writes already in flight).
            self._fence("lease renewal refused (deposed)")
            return
        self._last_renew = now

    def _renew_loop(self, stop: threading.Event) -> None:
        """Leader-lifetime renewal thread: keeps the lease alive even
        when one admission cycle runs longer than the lease window (the
        drive loop only reaches ``step`` between cycles). A refused
        renew fences exactly like the in-loop path."""
        while not stop.wait(self.renew_interval):
            if not self.roles.is_leader:
                return
            if self.suspend_renewal:
                continue  # fault injection: let the lease expire
            now = _time.time()
            if self.lease.renew(self.identity, self.epoch, now) is None:
                self._fence("lease renewal refused (deposed)")
                return
            self._last_renew = now

    # -- promotion: the replay-verified failover protocol --

    def _promote(self, lease_state) -> None:
        from kueue_tpu_torch.store.checkpoint import recover_records
        from kueue_tpu_torch.store.journal import (
            Journal,
            engine_from_records,
        )
        from kueue_tpu_torch.store.journal import _key_of as _journal_key_of

        self.roles.to(CANDIDATE,
                      f"lease acquired epoch={lease_state.epoch}")
        t0 = _time.perf_counter()
        # Journal() repairs a torn tail (the dead leader's SIGKILL
        # mid-append) under the journal flock before we read. Recovery
        # is checkpoint base + suffix when a sealed checkpoint exists
        # (O(delta) promotion), full genesis replay otherwise — and
        # verify_promotion proves digest identity either way. The JAX
        # replica opens a reader and then this writer (each open parses
        # the journal); this one reads through the writer.
        journal = Journal(self.journal_path, fsync=self.fsync,
                          rotate_bytes=self.segment_rotate_bytes,
                          rotate_records=self.segment_rotate_records,
                          min_free_bytes=self.min_free_bytes,
                          metrics=self.metrics)
        base, suffix, ckpt_meta = recover_records(journal)
        if ckpt_meta is None:
            base, suffix = [], list(journal.replay())
        engine = engine_from_records(base + suffix, **self.engine_kwargs)
        if ckpt_meta is not None:
            engine.clock = max(engine.clock, ckpt_meta.clock)
        t1 = _time.perf_counter()
        report = verify_promotion(suffix, engine,
                                  new_epoch=lease_state.epoch,
                                  base_records=base,
                                  base_meta=ckpt_meta)
        self.promotion_report = report
        # Wall seconds of the protocol's steps (not part of the report,
        # which is the JAX package's): the lease's acquire time, the
        # replay to head and the verification.
        self.promotion_timing = {
            "acquired_at": lease_state.acquire_time,
            "replay_s": t1 - t0, "verify_s": _time.perf_counter() - t1}
        if not report["verified"]:
            journal.close()
            self.lease.release(self.identity)
            self.roles.to(FENCED,
                          f"promotion verification failed: "
                          f"{report['reason']}")
            return
        self.epoch = lease_state.epoch
        journal.fence = self._write_allowed
        if base:
            journal.seed_generations(
                {(r["kind"], _journal_key_of(r)): int(r.get("gen", 0))
                 for r in base if r.get("gen")})
        engine.attach_journal(journal, record_existing=False)
        engine.ha = self
        self.digest_chain = DigestChain(
            engine, self.epoch,
            seed_chain=report["chain_seed"],
            seed_seq=report["seq_seed"])
        if self.checkpoint_interval > 0:
            from kueue_tpu_torch.store.checkpoint import Checkpointer
            Checkpointer(engine, interval=self.checkpoint_interval,
                         keep=self.checkpoint_keep,
                         retain_segments=self.retain_segments)
        self._inflight_submits.clear()
        engine.cycle_listeners.append(self._evict_submit_dedup)
        self.engine = engine
        if self.hub is not None:
            self.hub.attach_engine(engine)
        self.roles.to(LEADER,
                      f"verified: {report['reason']}")
        if self.renew_in_background:
            self._renew_stop = threading.Event()
            threading.Thread(
                target=self._renew_loop, args=(self._renew_stop,),
                name=f"ha-renew-{self.identity}", daemon=True).start()
        if self.on_promote is not None:
            self.on_promote(engine, self)

    def _write_allowed(self) -> bool:
        """Journal fence predicate, evaluated inside the append flock:
        this replica leads, and the lease file still names it at its
        epoch. The JAX predicate reads the role alone, so a leader whose
        renewals stall (``lease-stall``) goes on writing after a standby
        took the lease, until a renewal is refused; here its next write
        after the takeover raises JournalFenced instead."""
        if not self.roles.is_leader:
            return False
        lease = self.lease.read()
        return (lease is not None and lease.holder == self.identity
                and lease.epoch == self.epoch)

    def _fence(self, reason: str) -> None:
        # Idempotent and thread-safe: the renewal thread and the drive
        # loop (JournalFenced handler) can race to fence the same
        # deposed leader.
        with self._fence_lock:
            if self.roles.is_fenced:
                return
            if self._renew_stop is not None:
                self._renew_stop.set()
                self._renew_stop = None
            if self.hub is not None and self.engine is not None:
                self.hub.detach_engine()
            if self.digest_chain is not None:
                self.digest_chain.detach()
                self.digest_chain = None
            self.roles.to(FENCED, reason)
            if self.on_demote is not None:
                self.on_demote(self.engine, self, reason)
            self.engine = None
            self._inflight_submits.clear()

    def resign(self) -> None:
        """Graceful shutdown handoff: release the lease so a standby
        can take over without waiting out the expiry window."""
        if self.roles.is_leader:
            self.lease.release(self.identity)
            self._fence("resigned")

    # -- the write front door (HTTP POST /workloads lands here) --

    def submit(self, workload, now: float,
               route_epoch: Optional[int] = None) -> dict:
        """Leader check, then fencing, then dedup, then shed check,
        then Engine.submit. Shed requests never reach the engine — they
        must not become flight-recorder input frames (replay would
        diverge). ``route_epoch`` is the federation dispatcher's fence
        epoch for this cell (X-Route-Epoch): a handoff for a revoked
        key at a stale epoch is refused so a zombie cell rejoining the
        federation cannot double-admit."""
        if not self.roles.is_leader or self.engine is None:
            lease = self.lease.read()
            out = {"accepted": False, "code": 503,
                   "reason": f"not leader (role={self.roles.role})",
                   "leaderHint": lease.holder if lease else ""}
            if self.shedder is not None:
                # Same clamped backoff guidance as the 429 path, so
                # failover-window retries stay jittered + bounded.
                out["retryAfter"] = self.shedder.retry_after_hint()
            return out
        if route_epoch is not None:
            self.route_epoch = max(self.route_epoch, int(route_epoch))
            fenced_at = self._revoked.get(workload.key)
            if fenced_at is not None:
                if int(route_epoch) <= fenced_at:
                    return {"accepted": False, "code": 409,
                            "reason": f"fenced: revoked at epoch "
                                      f"{fenced_at}",
                            "workload": workload.name,
                            "fencedEpoch": fenced_at}
                del self._revoked[workload.key]
        if (workload.key in self._inflight_submits
                or workload.key in self.engine.workloads):
            # Idempotent retry: a client that lost its 201 to a leader
            # crash re-POSTs after promotion. The name is the dedup key
            # — re-submitting would reset an already-admitted workload
            # to pending. At-least-once retries + this ack are the
            # exactly-once admission story. Checked before the shedder:
            # a retry of accepted work must not burn bucket tokens.
            # The in-flight map fronts engine.workloads so dedup stays
            # correct even while a submission is between accept and
            # its first durable cycle.
            return {"accepted": True, "code": 200,
                    "workload": workload.name, "deduplicated": True}
        journal = getattr(self.engine, "journal", None)
        if journal is not None and journal.degraded:
            # Disk budget exhausted (store/diskguard.py): the journal
            # is read-only, so an accept here could never be made
            # durable. 503 (retryable elsewhere / later), checked
            # after dedup (acked work still answers 200) and before
            # the shedder (don't burn bucket tokens on a full disk).
            out = {"accepted": False, "code": 503,
                   "reason": "journal degraded: disk budget exhausted"}
            if self.shedder is not None:
                out["retryAfter"] = self.shedder.retry_after_hint()
            return out
        if self.shedder is not None:
            verdict = self.shedder.admit(now)
            if not verdict["accepted"]:
                return {"accepted": False, "code": 429,
                        "reason": "shed: admission rate limit",
                        "retryAfter": verdict["retryAfter"],
                        "factor": verdict["factor"]}
        self.engine.submit(workload)
        self._inflight_submits[workload.key] = now
        while len(self._inflight_submits) > self.dedup_capacity:
            # Oldest-entry eviction at the capacity bound: the oldest
            # in-flight entry is the most likely to already be durable
            # (answered by engine.workloads + the journal on retry).
            self._inflight_submits.popitem(last=False)
        return {"accepted": True, "code": 201,
                "workload": workload.name}

    def revoke(self, keys, epoch: int, now: float) -> dict:
        """Federation fencing: tombstone ``keys`` at ``epoch`` and
        delete any that this cell registered (journaled delete, usage
        released) — the cell side of zombie-rejoin reconciliation. The
        tombstone outlives the delete so a late handoff replay at a
        stale route epoch gets 409, not a fresh admission."""
        if not self.roles.is_leader or self.engine is None:
            return {"accepted": False, "code": 503,
                    "reason": f"not leader (role={self.roles.role})"}
        from kueue_tpu_torch.cli.kueuectl import Kueuectl

        ctl = Kueuectl(self.engine)
        deleted = []
        for key in keys:
            self._revoked[key] = max(self._revoked.get(key, 0),
                                     int(epoch))
            self._inflight_submits.pop(key, None)
            if key in self.engine.workloads:
                ctl.delete_workload(key)
                deleted.append(key)
        if deleted and self.engine.journal is not None:
            self.engine.journal.sync()
        return {"accepted": True, "code": 200, "epoch": int(epoch),
                "revoked": len(keys), "deleted": deleted}

    def _evict_submit_dedup(self, seq: int, result) -> None:
        """Post-sync cycle listener (runs AFTER journal.sync, so this
        cycle's admissions are durable): drop dedup entries whose
        workload reached a durably-journaled admission or terminal
        state. Keeps the map O(in-flight)."""
        if result is None or not self._inflight_submits:
            return
        eng = self.engine
        if eng is None:
            return
        for key in list(self._inflight_submits):
            wl = eng.workloads.get(key)
            if wl is not None and (wl.is_finished
                                   or wl.status.admission is not None):
                del self._inflight_submits[key]

    # -- observability --

    def _on_transition(self, old: str, new: str, reason: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.counter("ha_role_transitions_total").inc(
                    (old, new))
            except KeyError:
                pass

    def _export(self, now: float) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.gauge("ha_role").set(
                (), float(ROLE_CODES[self.roles.role]))
            self.metrics.gauge("ha_lease_epoch").set(
                (), float(self.epoch or self.lease.epoch_of()))
        except KeyError:
            pass

    def status(self) -> dict:
        lease = self.lease.read()
        out = {
            "identity": self.identity,
            "role": self.roles.role,
            "epoch": self.epoch or (lease.epoch if lease else 0),
            "leaseHolder": lease.holder if lease else "",
            "leaseRenewTime": lease.renew_time if lease else 0.0,
            "replayLag": self.tailer.replay_lag,
            "tailer": self.tailer.status(),
            "transitions": self.roles.history(last=16),
            "promotion": self.promotion_report,
        }
        if self.engine is not None:
            out["stateDigest"] = admitted_state_digest(self.engine)
            out["inflightSubmits"] = len(self._inflight_submits)
            out["dedupCapacity"] = self.dedup_capacity
            # Federation routing inputs: registered/admitted load is
            # the dispatcher's quota-headroom proxy; revoked/routeEpoch
            # surface the fencing state for kueuectl cells.
            out["workloads"] = len(self.engine.workloads)
            out["admittedWorkloads"] = sum(
                1 for w in self.engine.workloads.values()
                if w.status.admission is not None and not w.is_finished)
            out["revoked"] = len(self._revoked)
            out["routeEpoch"] = self.route_epoch
            if self.digest_chain is not None:
                out["decisionDigest"] = self.digest_chain.digest
                out["digestSeq"] = self.digest_chain.last_seq
            if self.engine.checkpointer is not None:
                out["checkpointer"] = self.engine.checkpointer.status()
        if self.hub is not None:
            out["sse"] = self.hub.stats()
            out["sseClients"] = self.hub.stats()["clients"]
        if self.shedder is not None:
            out["shedder"] = self.shedder.status()
        return out
