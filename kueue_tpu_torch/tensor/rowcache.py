"""Incremental workload row cache: the pending set as live tensors.

The reference keeps its pending world incrementally correct (heaps and
maps updated on every informer event, pkg/cache/queue/manager.go) and the
scheduler snapshots it per cycle. Round 1 re-encoded every pending
workload into dense arrays from scratch each serving cycle —
O(W) Python per cycle, which at the 50k north-star scale costs more than
the device solve itself. This module makes the tensor encoding itself
incremental: queue transitions (push / park / pop / delete) update rows
in O(1), and a cycle only pays for rows that changed since the last one.

Layout: one row per known pending workload (active in the heap, parked
inadmissible, or popped in-flight). Rows hold
  * world-independent fields captured at push time: priority, queue-order
    timestamp, the exact heap sort key (AFS usage frozen at push,
    cluster_queue.go:208), requeue-at, quota-reservation flag;
  * world-dependent fields (CQ index, request columns, fast-path
    eligibility, scheduling-equivalence hash id) recomputed lazily for
    dirty rows against the currently-bound world signature.

Scheduling-equivalence hash ids are refcounted so the dense id space
stays bounded by the row capacity (the cycle kernel scatters them into a
rows+1 sized mask, oracle/batched.py).

The cache is advisory: the engine bridge uses it when present, and the
from-scratch encoder (tensor/schema.encode_workloads) remains both the
fallback and the differential oracle (tests/test_rowcache.py).

Copied from ``kueue_tpu/tensor/rowcache.py`` without the perf spans.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from kueue_tpu_torch.obs import perf as _perf
from kueue_tpu_torch.workload_info import WorkloadInfo

_INF_TS = np.inf


class _HashRegistry:
    """Dense, refcounted ids for scheduling-equivalence hash tuples.

    Ids are recycled when their refcount drops to zero, so the id space
    never outgrows the maximum number of concurrently-known rows."""

    def __init__(self) -> None:
        self._id_of: dict = {}
        self._count: dict = {}
        self._free: list[int] = []
        self._next = 0

    def acquire(self, h) -> int:
        hid = self._id_of.get(h)
        if hid is None:
            hid = heapq.heappop(self._free) if self._free else self._next
            if hid == self._next:
                self._next += 1
            self._id_of[h] = hid
            self._count[hid] = 0
        self._count[hid] += 1
        return hid

    def release(self, h) -> None:
        hid = self._id_of.get(h)
        if hid is None:
            return
        self._count[hid] -= 1
        if self._count[hid] <= 0:
            del self._count[hid]
            del self._id_of[h]
            heapq.heappush(self._free, hid)


class WorkloadRowCache:
    """Pending workloads as incrementally-maintained dense rows."""

    MIN_CAPACITY = 64

    def __init__(self) -> None:
        self._cap = self.MIN_CAPACITY
        self._row_of: dict[str, int] = {}
        self._free: list[int] = list(range(self._cap - 1, -1, -1))
        self.info_of: list[Optional[WorkloadInfo]] = [None] * self._cap
        self._hash_tuple: list = [None] * self._cap
        # Per-row TAS request signatures (tas/feasibility.request_
        # signature per pod set), computed lazily by tas_requests() and
        # carried across cycles like _hash_tuple — the batched TAS
        # planner re-reads only rows that re-encoded.
        self._tas_req: list = [None] * self._cap
        self._dirty: set[int] = set()
        self._hashes = _HashRegistry()
        # Monotone mutation counter: bumped on every structural change
        # (push/park/pop/remove/world-bind).  The pipelined cycle loop
        # folds it into its speculation token so a speculative encode is
        # only reused when the cache is bit-for-bit unchanged.
        self.mutation_seq = 0

        # world-independent columns
        self.priority = np.zeros(self._cap, np.int64)
        self.timestamp = np.zeros(self._cap, np.float64)
        self.has_qr = np.zeros(self._cap, bool)
        self.requeue_at = np.full(self._cap, -_INF_TS, np.float64)
        self.active = np.zeros(self._cap, bool)
        # heap sort key (afs usage, -priority, ts, seq) frozen at push
        self.key_afs = np.zeros(self._cap, np.float64)
        self.key_negpri = np.zeros(self._cap, np.int64)
        self.key_ts = np.zeros(self._cap, np.float64)
        self.key_seq = np.full(self._cap, np.int64(1) << 60, np.int64)

        # world-dependent columns (valid when row not dirty and the
        # bound signature matches)
        self._signature = None
        self.cq = np.full(self._cap, -1, np.int32)
        # [cap, P, S]: podset axis grows on demand (pow2, capped by
        # schema.MAX_FAST_PODSETS; larger workloads are ineligible).
        self.requests = np.zeros((self._cap, 1, 1), np.int64)
        self.eligible = np.zeros(self._cap, bool)
        self.hash_id = np.zeros(self._cap, np.int32)
        # [cap, NF]: per-flavor eligibility (taints/selectors/affinity),
        # sized at bind_world.
        self.flavor_ok = None
        # Stable digest of the row's TAS request signatures (0 = not
        # computed / no pod sets): a cheap cross-cycle change marker
        # for diagnostics; decisions read the _tas_req tuples.
        self.tas_sig = np.zeros(self._cap, np.int64)

    # -- queue transition hooks (O(1) amortized) --

    def on_push(self, info: WorkloadInfo, sort_key: tuple) -> None:
        """Workload entered (or re-entered) a pending heap."""
        self.mutation_seq += 1
        i = self._row_of.get(info.key)
        wl = info.obj
        if i is None:
            i = self._alloc()
            self._row_of[info.key] = i
            fresh = True
        else:
            # Re-push of the SAME info (requeue after eviction / NoFit):
            # the world-dependent fields are functions of the info's
            # immutable pod-set shape plus the mutable hash prefix
            # checked here (scheduling_hash elements 1-4) — when neither
            # changed, skip the dirty re-encode. Churn worlds requeue
            # thousands of rows per cycle.
            h = self._hash_tuple[i]
            fresh = (self.info_of[i] is not info or h is None
                     or h[1] != wl.priority
                     or h[2] != wl.allowed_resource_flavor
                     or h[3] != wl.has_closed_preemption_gate()
                     or h[4] != tuple(sorted(
                         wl.status.reclaimable_pods.items())))
        self.info_of[i] = info
        from kueue_tpu_torch.workload_info import queue_order_timestamp
        self.priority[i] = wl.effective_priority
        # FIFO timestamp is the eviction-aware queue-order timestamp so
        # the device tiebreak can never diverge from the host heap.
        self.timestamp[i] = queue_order_timestamp(wl)
        self.has_qr[i] = wl.has_quota_reservation
        ra = wl.status.requeue_at
        self.requeue_at[i] = -_INF_TS if ra is None else ra
        self.key_afs[i], negpri, kts, kseq = sort_key
        self.key_negpri[i] = negpri
        self.key_ts[i] = kts
        self.key_seq[i] = kseq
        self.active[i] = True
        if fresh:
            self._dirty.add(i)

    def on_park(self, info: WorkloadInfo) -> None:
        """Workload moved to the inadmissible side map (row kept: a
        cluster event can re-activate it)."""
        self.mutation_seq += 1
        i = self._row_of.get(info.key)
        if i is None:  # parked without ever being pushed
            from kueue_tpu_torch.workload_info import queue_order_timestamp
            self.on_push(info, (0.0, -info.obj.effective_priority,
                                queue_order_timestamp(info.obj),
                                np.int64(1) << 59))
        i = self._row_of[info.key]
        self.info_of[i] = info
        self.active[i] = False

    def on_pop(self, key: str) -> None:
        """Workload popped (in flight with the sequential path)."""
        self.mutation_seq += 1
        i = self._row_of.get(key)
        if i is not None:
            self.active[i] = False

    def on_remove(self, key: str) -> None:
        """Workload left the pending world (admitted / deleted)."""
        self.mutation_seq += 1
        i = self._row_of.pop(key, None)
        if i is None:
            return
        self.active[i] = False
        self.info_of[i] = None
        h = self._hash_tuple[i]
        if h is not None:
            self._hashes.release(h)
            self._hash_tuple[i] = None
        self._tas_req[i] = None
        self.tas_sig[i] = 0
        self.key_seq[i] = np.int64(1) << 60
        self.requeue_at[i] = -_INF_TS
        self._dirty.discard(i)
        self._free.append(i)

    def on_remove_batch(self, keys) -> None:
        """Batched :meth:`on_remove`: clear every departing row's
        columns in four vectorized writes instead of one
        row-at-a-time walk. The per-row Python that remains is only
        the bookkeeping numpy can't express (dict pop, flyweight
        release, free-list push); row order is preserved so the
        free-list matches the serial path exactly.
        """
        self.mutation_seq += 1
        rows = []
        row_pop = self._row_of.pop
        info_of = self.info_of
        hash_tuple = self._hash_tuple
        tas_req = self._tas_req
        dirty_discard = self._dirty.discard
        free_append = self._free.append
        append = rows.append
        # _HashRegistry.release, inlined: the per-key method call is
        # measurable at batch sizes (~1k keys/cycle in the serving
        # drain) and the registry's dicts are stable for the whole
        # batch.
        hashes = self._hashes
        id_of = hashes._id_of
        count = hashes._count
        hash_free = hashes._free
        heappush = heapq.heappush
        for key in keys:
            i = row_pop(key, None)
            if i is None:
                continue
            append(i)
            info_of[i] = None
            h = hash_tuple[i]
            if h is not None:
                hid = id_of.get(h)
                if hid is not None:
                    c = count[hid] - 1
                    if c <= 0:
                        del count[hid]
                        del id_of[h]
                        heappush(hash_free, hid)
                    else:
                        count[hid] = c
                hash_tuple[i] = None
            tas_req[i] = None
            dirty_discard(i)
            free_append(i)
        if not rows:
            return
        idx = np.asarray(rows, np.int64)
        self.active[idx] = False
        self.tas_sig[idx] = 0
        self.key_seq[idx] = np.int64(1) << 60
        self.requeue_at[idx] = -_INF_TS

    # -- capacity management --

    def _alloc(self) -> int:
        if not self._free:
            self._grow(self._cap * 2)
        return self._free.pop()

    def _grow(self, new_cap: int) -> None:
        old = self._cap
        self._cap = new_cap
        for name in ("priority", "timestamp", "has_qr", "requeue_at",
                     "active", "key_afs", "key_negpri", "key_ts",
                     "key_seq", "cq", "eligible", "hash_id", "tas_sig"):
            arr = getattr(self, name)
            fill = {"requeue_at": -_INF_TS, "cq": -1,
                    "key_seq": np.int64(1) << 60}.get(name, 0)
            grown = np.full(new_cap, fill, arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        reqs = np.zeros((new_cap,) + self.requests.shape[1:], np.int64)
        reqs[:old] = self.requests
        self.requests = reqs
        if self.flavor_ok is not None:
            fo = np.ones((new_cap, self.flavor_ok.shape[1]), bool)
            fo[:old] = self.flavor_ok
            self.flavor_ok = fo
        self.info_of.extend([None] * (new_cap - old))
        self._hash_tuple.extend([None] * (new_cap - old))
        self._tas_req.extend([None] * (new_cap - old))
        self._free.extend(range(new_cap - 1, old - 1, -1))

    def maybe_compact(self) -> None:
        """Shrink after a drain: keep the dense-row invariant cheap. Runs
        only between cycles (row indices change)."""
        used = len(self._row_of)
        if self._cap <= self.MIN_CAPACITY or used * 4 > self._cap:
            return
        keep = sorted(self._row_of.values())
        new_cap = max(self.MIN_CAPACITY, 1 << (max(used * 2, 1) - 1)
                      .bit_length())
        remap = {old: new for new, old in enumerate(keep)}
        for name in ("priority", "timestamp", "has_qr", "requeue_at",
                     "active", "key_afs", "key_negpri", "key_ts",
                     "key_seq", "cq", "eligible", "hash_id", "tas_sig"):
            arr = getattr(self, name)
            fill = {"requeue_at": -_INF_TS, "cq": -1,
                    "key_seq": np.int64(1) << 60}.get(name, 0)
            grown = np.full(new_cap, fill, arr.dtype)
            if keep:
                grown[:used] = arr[keep]
            setattr(self, name, grown)
        reqs = np.zeros((new_cap,) + self.requests.shape[1:], np.int64)
        if keep:
            reqs[:used] = self.requests[keep]
        self.requests = reqs
        if self.flavor_ok is not None:
            fo = np.ones((new_cap, self.flavor_ok.shape[1]), bool)
            if keep:
                fo[:used] = self.flavor_ok[keep]
            self.flavor_ok = fo
        self.info_of = [self.info_of[i] for i in keep] + \
            [None] * (new_cap - used)
        self._hash_tuple = [self._hash_tuple[i] for i in keep] + \
            [None] * (new_cap - used)
        self._tas_req = [self._tas_req[i] for i in keep] + \
            [None] * (new_cap - used)
        self._row_of = {k: remap[i] for k, i in self._row_of.items()}
        self._dirty = {remap[i] for i in self._dirty if i in remap}
        self._cap = new_cap
        self._free = list(range(new_cap - 1, used - 1, -1))
        # Re-index hash ids: id values are bounded by the peak row count
        # between rebuilds, and the kernel scatters them into a
        # rows+1-sized mask — after shrinking, rebuild the registry so
        # ids fit the new capacity again.
        self._hashes = _HashRegistry()
        for i in range(used):
            h = self._hash_tuple[i]
            if h is not None:
                self.hash_id[i] = self._hashes.acquire(h)

    # -- per-cycle encoding --

    @staticmethod
    def world_signature(world) -> tuple:
        """Everything the world-dependent row fields depend on: the CQ
        index space, the resource column space, and per-CQ resource
        coverage (drives implicit-pods and uncovered-resource
        eligibility)."""
        return (tuple(world.cq_names), tuple(world.resource_names),
                world.group_of_res.tobytes(),
                world.flavor_spec_token())

    def bind_world(self, world) -> None:
        sig = self.world_signature(world)
        if sig == self._signature:
            return
        self.mutation_seq += 1
        self._signature = sig
        S = max(world.num_resources, 1)
        if S != self.requests.shape[2]:
            self.requests = np.zeros(
                (self._cap, self.requests.shape[1], S), np.int64)
        NF = max(world.num_flavors, 1)
        if self.flavor_ok is None or NF != self.flavor_ok.shape[1]:
            self.flavor_ok = np.ones((self._cap, NF), bool)
        self._dirty.update(self._row_of.values())

    def _encode_row(self, i: int, world, cq_idx: dict,
                    s_idx: dict) -> None:
        """World-dependent fields for one row — the single-row form of
        tensor/schema.encode_workloads."""
        from kueue_tpu_torch.cache.queues import scheduling_hash

        info = self.info_of[i]
        wl = info.obj
        old_h = self._hash_tuple[i]
        h = scheduling_hash(wl, info.cluster_queue)
        if h != old_h:
            if old_h is not None:
                self._hashes.release(old_h)
            self.hash_id[i] = self._hashes.acquire(h)
            self._hash_tuple[i] = h
        # A re-encode means the info (and so its pod-set requests) may
        # have changed; the TAS side table recomputes on next use.
        self._tas_req[i] = None
        self.tas_sig[i] = 0
        ci = cq_idx.get(info.cluster_queue, -1)
        self.cq[i] = ci
        self.requests[i] = 0
        from kueue_tpu_torch.tensor.schema import (
            flavor_eligibility_mask,
            pow2_bucket,
            serving_shape_eligible,
        )
        # Serving rows use the RELAXED predicate: node filters become a
        # per-flavor mask consumed by the cycle kernel instead of
        # demoting the row (round-4 verdict ask #4: head-ineligible),
        # and topology requests stay on device when the batched TAS
        # planner is on (it nominates placements pre-kernel).
        eligible = ci >= 0 and serving_shape_eligible(info)
        if eligible and self.flavor_ok is not None:
            mask = flavor_eligibility_mask(info, world)
            if mask is None:
                eligible = False  # pod sets disagree: host path
            else:
                self.flavor_ok[i] = mask
        if eligible:
            n_ps = len(info.total_requests)
            if n_ps > self.requests.shape[1]:
                # Grow the podset axis (pow2-bucketed so recurring worlds
                # reuse one compiled program per bucket).
                newP = pow2_bucket(n_ps, 1)
                reqs = np.zeros((self._cap, newP,
                                 self.requests.shape[2]), np.int64)
                reqs[:, :self.requests.shape[1]] = self.requests
                self.requests = reqs
            from kueue_tpu_torch.tensor.schema import encode_podset_requests
            if not encode_podset_requests(info, ci, world, s_idx,
                                          self.requests[i]):
                eligible = False
        self.eligible[i] = eligible

    def flush(self, world) -> None:
        """Re-encode every dirty row against the bound world."""
        self.bind_world(world)
        if not self._dirty:
            return
        _pt = _perf.begin()
        cq_idx = {n: i for i, n in enumerate(world.cq_names)}
        s_idx = {n: i for i, n in enumerate(world.resource_names)}
        for i in self._dirty:
            if self.info_of[i] is not None:
                self._encode_row(i, world, cq_idx, s_idx)
        self._dirty.clear()
        _perf.end("encode.rowcache_flush", _pt)

    def tas_requests(self, i: int) -> tuple:
        """Per-podset TAS request tuples for a row — (pod_set_name,
        request_signature, single_pod_requests, count, group_name) per
        pod set — computed once and carried across cycles with the row
        (invalidated by _encode_row / on_remove, remapped on compact).
        The batched TAS planner's collect phase becomes incremental:
        unchanged retried heads cost a list lookup, not a signature
        rebuild."""
        ent = self._tas_req[i]
        if ent is None:
            info = self.info_of[i]
            if info is None:
                return ()
            from kueue_tpu_torch.tas.feasibility import request_signature
            out = []
            for p, psr in enumerate(info.total_requests):
                ps = info.obj.pod_sets[p]
                single = psr.single_pod_requests()
                tr = ps.topology_request
                out.append((ps.name,
                            request_signature(ps, single, psr.count),
                            single, psr.count,
                            tr.pod_set_group_name if tr is not None
                            else None))
            ent = tuple(out)
            self._tas_req[i] = ent
            import zlib
            self.tas_sig[i] = zlib.crc32(repr(
                [(e[0], e[1], e[4]) for e in ent]).encode())
        return ent

    def refresh_held(self, now: float) -> None:
        """Re-read requeue-at for rows currently held back: eviction
        backoff is the one field controllers touch without a queue
        transition."""
        held = np.nonzero(self.requeue_at > now)[0]
        for i in held:
            info = self.info_of[i]
            if info is None:
                continue
            ra = info.obj.status.requeue_at
            self.requeue_at[i] = -_INF_TS if ra is None else ra

    # -- views --

    def info_for(self, key: str) -> Optional[WorkloadInfo]:
        """The WorkloadInfo currently holding this key's row (None when
        the key has no row) — the queue manager uses it to keep the
        one-ClusterQueue-per-pending-workload invariant."""
        i = self._row_of.get(key)
        return None if i is None else self.info_of[i]

    @property
    def num_rows(self) -> int:
        return self._cap

    def tensors(self, world):
        """A WorkloadTensors over the full row space (flush first).
        ``keys`` stays empty — consumers hold ``info_of`` and a per-row
        key list would cost O(rows) Python every cycle."""
        from kueue_tpu_torch.tensor.schema import WorkloadTensors

        self.flush(world)
        return WorkloadTensors(
            num_workloads=self._cap, keys=[], cq=self.cq,
            priority=self.priority, timestamp=self.timestamp,
            requests=self.requests, has_quota_reservation=self.has_qr,
            eligible=self.eligible, hash_id=self.hash_id,
            num_podsets=self.requests.shape[1],
            flavor_ok=self.flavor_ok)

    def head_ranks(self) -> np.ndarray:
        """Global rank by the stored heap sort keys — by construction the
        order the host heaps pop (AFS usage included)."""
        order = np.lexsort((self.key_seq, self.key_ts, self.key_negpri,
                            self.key_afs))
        rank = np.empty(self._cap, np.int64)
        rank[order] = np.arange(self._cap)
        return rank

    def commit_ranks(self) -> np.ndarray:
        """FIFO commit tiebreak: queue-order timestamp, then push
        sequence (scheduler.go:1001)."""
        order = np.lexsort((self.key_seq, self.timestamp))
        rank = np.empty(self._cap, np.int64)
        rank[order] = np.arange(self._cap)
        return rank


class AdmittedRows:
    """Incremental admitted-side tensors for the device preemption
    kernels: the AdmittedTensors encode (tensor/schema.encode_admitted)
    maintained as live rows updated from the scheduler cache's
    admitted-change log (Cache.admitted_dirty) instead of re-encoded
    O(A) every cycle — churn worlds change a handful of admitted rows
    per cycle while A is thousands.

    Holes (freed rows) keep cq=-1 / zero usage, so they can never
    classify as preemption candidates; `info_of` is aligned with rows
    for victim-id mapping. The uid rank (CandidatesOrdering tiebreak,
    common/ordering.go:42) is recomputed vectorized over a fixed-width
    string array whenever any row changed."""

    MIN_CAPACITY = 64
    _HOLE_UID = "￿"  # sorts above every real uid

    def __init__(self, world) -> None:
        self.signature = (WorkloadRowCache.world_signature(world),
                          tuple(world.flavor_names))
        self._cq_idx = {n: i for i, n in enumerate(world.cq_names)}
        self._fl_idx = {n: i for i, n in enumerate(world.flavor_names)}
        self._s_idx = {n: i for i, n in enumerate(world.resource_names)}
        self._S = world.num_resources
        self._R = max(world.num_flavors * world.num_resources, 1)
        self._cap = self.MIN_CAPACITY
        self._row_of: dict[str, int] = {}
        self._free = list(range(self._cap - 1, -1, -1))
        self.info_of: list = [None] * self._cap
        self.cq = np.full(self._cap, -1, np.int32)
        self.priority = np.zeros(self._cap, np.int64)
        self.timestamp = np.zeros(self._cap, np.float64)
        self.qr_time = np.zeros(self._cap, np.float64)
        self.evicted = np.zeros(self._cap, bool)
        self.usage = np.zeros((self._cap, self._R), np.int64)
        self._uids = np.full(self._cap, self._HOLE_UID, dtype="U96")
        self._built = False
        self._epoch = 0
        self._tensors = None

    def _grow(self, new_cap: int) -> None:
        old = self._cap
        self._cap = new_cap
        for name, fill in (("cq", -1), ("priority", 0), ("timestamp", 0),
                           ("qr_time", 0), ("evicted", False)):
            arr = getattr(self, name)
            grown = np.full(new_cap, fill, arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        usage = np.zeros((new_cap, self._R), np.int64)
        usage[:old] = self.usage
        self.usage = usage
        uids = np.full(new_cap, self._HOLE_UID, dtype="U96")
        uids[:old] = self._uids
        self._uids = uids
        self.info_of.extend([None] * (new_cap - old))
        self._free.extend(range(new_cap - 1, old - 1, -1))

    def _encode(self, i: int, info, now: float) -> None:
        wl = info.obj
        self.info_of[i] = info
        self.cq[i] = self._cq_idx.get(info.cluster_queue, -1)
        self.priority[i] = wl.effective_priority
        self.timestamp[i] = wl.creation_time
        self.qr_time[i] = wl.quota_reservation_time(now)
        self.evicted[i] = wl.is_evicted
        self._uids[i] = wl.uid
        row = self.usage[i]
        row[:] = 0
        S = self._S
        from kueue_tpu_torch.api.types import INF
        for fr, v in info.usage().items():
            fi = self._fl_idx.get(fr.flavor)
            si = self._s_idx.get(fr.resource)
            if fi is not None and si is not None:
                # INF saturation (see schema.encode_podset_requests).
                row[fi * S + si] = v if v < INF else INF

    def sync(self, cache, now: float):
        """Apply the cache's admitted-change log; returns the (possibly
        unchanged — identity matters, downstream pads are memoized on
        it) AdmittedTensors view."""
        from kueue_tpu_torch.tensor.schema import AdmittedTensors

        epoch = getattr(cache, "admitted_dirty_epoch", 0)
        if not self._built or epoch != self._epoch:
            # First build, or the cache capped/dropped its change log:
            # full resync (stale rows freed below via the key union).
            dirty = set(cache.workloads.keys())
            dirty.update(self._row_of.keys())
            dirty.update(cache.admitted_dirty)
            self._built = True
            self._epoch = epoch
        elif cache.admitted_dirty:
            dirty = set(cache.admitted_dirty)
        else:
            dirty = None
        cache.admitted_dirty.clear()
        if dirty is None and self._tensors is not None:
            return self._tensors
        _pt = _perf.begin()
        if dirty:
            for key in dirty:
                info = cache.workloads.get(key)
                i = self._row_of.get(key)
                if info is None:
                    if i is not None:
                        del self._row_of[key]
                        self.info_of[i] = None
                        self.cq[i] = -1
                        self.usage[i] = 0
                        self.evicted[i] = False
                        self._uids[i] = self._HOLE_UID
                        self._free.append(i)
                    continue
                if i is None:
                    if not self._free:
                        self._grow(self._cap * 2)
                    i = self._free.pop()
                    self._row_of[key] = i
                self._encode(i, info, now)
        uid_rank = np.empty(self._cap, np.int64)
        uid_rank[np.argsort(self._uids, kind="stable")] = \
            np.arange(self._cap)
        self._tensors = AdmittedTensors(
            num_admitted=self._cap, keys=[], cq=self.cq,
            priority=self.priority, timestamp=self.timestamp,
            qr_time=self.qr_time, uid_rank=uid_rank,
            evicted=self.evicted, usage=self.usage,
            live=len(self._row_of))
        _perf.end("encode.admitted_sync", _pt)
        return self._tensors

    @property
    def live(self) -> int:
        return len(self._row_of)
