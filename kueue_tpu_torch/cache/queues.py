"""Pending-side queue manager: per-ClusterQueue heaps, LocalQueue mapping,
inadmissible bookkeeping with backoff.

Reference: pkg/cache/queue/{manager.go,cluster_queue.go}.
  * heap order: lower LocalQueue usage first on an admission-fair-sharing
    ClusterQueue (frozen at push), then higher effective priority, then
    earlier queue-order timestamp (cluster_queue.go heap less).
  * StrictFIFO keeps a sticky head and does not surface deeper workloads;
    BestEffortFIFO pops past inadmissible heads (cluster_queue.go:124+).
  * NoFit requeues park the workload in an ``inadmissible`` side map until a
    relevant event (cluster_queue.go:451 backoffWaitingTimeExpired,
    QueueInadmissibleWorkloads).
  * scheduling-equivalence hashing: identical pending workloads are bulk
    moved to inadmissible on a NoFit (cluster_queue.go:615
    handleInadmissibleHash; workload.go:236 SchedulingHash).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Optional

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    LocalQueue,
    QueueingStrategy,
    StopPolicy,
    Workload,
)
from kueue_tpu_torch.scheduler.cycle import RequeueReason
from kueue_tpu_torch.workload_info import (
    DEFAULT_ORDERING,
    WorkloadInfo,
    queue_order_timestamp,
)

_seq = itertools.count()


class PyIndexedHeap:
    """The pending heap with lazy deletion: the pure-Python form of the
    JAX package's indexed heap (``kueue_tpu/utils/native.py``), which its
    native build mirrors."""

    def __init__(self):
        self._heap: list = []
        self._live: dict[int, tuple] = {}

    def push(self, id_: int, usage: float, neg_priority: int, ts: float,
             seq: int) -> None:
        key = (usage, neg_priority, ts, seq)
        self._live[id_] = key
        heapq.heappush(self._heap, (key, id_))

    def remove(self, id_: int) -> bool:
        return self._live.pop(id_, None) is not None

    def _prune(self) -> None:
        while self._heap and self._live.get(
                self._heap[0][1]) != self._heap[0][0]:
            heapq.heappop(self._heap)

    def peek(self) -> Optional[int]:
        self._prune()
        return self._heap[0][1] if self._heap else None

    def pop(self) -> Optional[int]:
        self._prune()
        if not self._heap:
            return None
        _, id_ = heapq.heappop(self._heap)
        del self._live[id_]
        return id_

    def __len__(self) -> int:
        return len(self._live)


def scheduling_hash(wl: Workload, cluster_queue: str) -> tuple:
    """pkg/workload/workload.go:236 (SchedulingHash): workloads with equal
    shape share admission outcomes within a cycle."""
    return (
        cluster_queue,
        wl.priority,
        # A flavor-pinned variant schedules differently from its
        # unpinned (or differently-pinned) siblings.
        wl.allowed_resource_flavor,
        # Closed preemption gates change schedulability too.
        wl.has_closed_preemption_gate(),
        # Reclaimable pods scale the effective counts/requests
        # (workload_types.go:874): spec-equal workloads with different
        # reclaim states have different admission verdicts and must not
        # be treated as scheduling-equivalent.
        tuple(sorted(wl.status.reclaimable_pods.items())),
        tuple(sorted(
            (ps.name, ps.count, tuple(sorted(ps.requests.items())),
             tuple(sorted(ps.node_selector.items())),
             ps.node_affinity,
             ps.min_count,
             (ps.topology_request.mode.value
              if ps.topology_request.mode is not None else None,
              ps.topology_request.level,
              ps.topology_request.slice_level,
              ps.topology_request.slice_size,
              ps.topology_request.pod_set_group_name)
             if ps.topology_request is not None else None,
             ps.tolerations)
            for ps in wl.pod_sets)),
    )


class PendingClusterQueue:
    """pkg/cache/queue/cluster_queue.go:124 (ClusterQueue pending heap)."""

    def __init__(self, spec: ClusterQueue, manager=None):
        self.spec = spec
        self.name = spec.name
        self.manager = manager
        # Indexed heap (native C++ when available, Python fallback) —
        # push-or-update / remove by id in O(log n), no stale entries.
        self._hp = PyIndexedHeap()
        self._id_of: dict[str, int] = {}  # workload key -> heap id
        self._entry_of: dict[int, tuple] = {}  # heap id -> (info, key)
        self.items: dict[str, WorkloadInfo] = {}  # key -> live entry
        self.inadmissible: dict[str, WorkloadInfo] = {}
        self.in_flight: Optional[str] = None  # popped, not yet requeued

    def _key(self, info: WorkloadInfo) -> tuple:
        wl = info.obj
        # AFS ordering: lower LocalQueue decayed usage first
        # (cluster_queue.go:208 AFS hooks). Reading the usage decays it,
        # so it is read here, at push, and nowhere else on this path.
        usage = 0.0
        if (self.manager is not None
                and self.manager.lq_usage_fn is not None
                and self.spec.admission_scope
                == "UsageBasedAdmissionFairSharing"):
            usage = self.manager.lq_usage_fn(
                f"{wl.namespace}/{wl.queue_name}")
            info.local_queue_fs_usage = usage
        # FIFO position honors the eviction-aware queue-order timestamp
        # (workload.go:1087), not raw creation time, under the manager's
        # ordering (waitForPodsReady.requeuingTimestamp).
        ordering = (self.manager.workload_ordering
                    if self.manager is not None else None)
        ts = queue_order_timestamp(wl, ordering or DEFAULT_ORDERING)
        return (usage, -wl.effective_priority, ts, next(_seq))

    def _heap_push(self, info: WorkloadInfo,
                   sort_key: Optional[tuple] = None) -> None:
        sort_key = sort_key if sort_key is not None else self._key(info)
        id_ = self._id_of.get(info.key)
        if id_ is None:
            id_ = next(_seq)
            self._id_of[info.key] = id_
        self._entry_of[id_] = (info, sort_key)
        self._hp.push(id_, sort_key[0], sort_key[1], sort_key[2],
                      sort_key[3])
        if self.manager is not None:
            self.manager.rows.on_push(info, sort_key)

    def sort_key_of(self, key: str) -> Optional[tuple]:
        """The stored heap sort key for a pending workload — the exact
        ordering the next pop() honors (AFS usage is FROZEN at push
        time, cluster_queue.go:208). The device bridge ranks with these
        so device and host head order can never diverge."""
        id_ = self._id_of.get(key)
        if id_ is None:
            return None
        return self._entry_of[id_][1]

    def _heap_remove(self, key: str) -> None:
        id_ = self._id_of.pop(key, None)
        if id_ is not None:
            self._hp.remove(id_)
            self._entry_of.pop(id_, None)

    def push_or_update(self, info: WorkloadInfo) -> None:
        """cluster_queue.go:356 (PushOrUpdate)."""
        key = info.key
        self.inadmissible.pop(key, None)
        self.items[key] = info
        self._heap_push(info)

    def delete(self, key: str) -> None:
        self.items.pop(key, None)
        self.inadmissible.pop(key, None)
        self._heap_remove(key)
        if self.in_flight == key:
            self.in_flight = None
        if self.manager is not None:
            self.manager.rows.on_remove(key)

    def delete_lazy(self, key: str) -> None:
        """delete() for the bulk-assume path (admitted verdicts): the
        heap entry is left to pop()'s lazy discard — the same strategy
        park() documents — and a later re-push of the same key reuses
        the live id via the native heap's push-or-update, so the heap
        never diverges. Skips one native remove per admission."""
        self.items.pop(key, None)
        self.inadmissible.pop(key, None)
        if self.in_flight == key:
            self.in_flight = None
        if self.manager is not None:
            self.manager.rows.on_remove(key)

    def park(self, key: str) -> None:
        """Move an active pending workload to the inadmissible side map
        (the oracle bridge's NoFit verdict application). The heap entry
        is left to lazy deletion — pop() discards entries whose key is
        no longer live in ``items``, and a later re-activation's
        push-or-update reuses the id — so bulk parking (whole
        scheduling-equivalence classes at once) stays O(1) per row."""
        info = self.items.pop(key, None)
        if info is None:
            return
        self.inadmissible[key] = info
        if self.manager is not None:
            self.manager.rows.on_park(info)

    def requeue_if_not_present(self, info: WorkloadInfo,
                               reason: RequeueReason) -> bool:
        """cluster_queue.go requeueIfNotPresent: NoFit and
        PreemptionNoCandidates park the workload as inadmissible under
        BestEffortFIFO; other reasons go straight back to the heap."""
        key = info.key
        if self.in_flight == key:
            self.in_flight = None
        if key in self.items or key in self.inadmissible:
            return False
        if self.spec.queueing_strategy == QueueingStrategy.STRICT_FIFO:
            # StrictFIFO blocks the queue on its head rather than
            # parking it — except namespace mismatch, which only a
            # namespace/CQ change can cure (cluster_queue.go:919).
            immediate = reason != RequeueReason.NAMESPACE_MISMATCH
        else:
            immediate = reason not in (
                RequeueReason.NO_FIT,
                RequeueReason.PREEMPTION_NO_CANDIDATES,
                RequeueReason.NAMESPACE_MISMATCH)
        if immediate:
            self.push_or_update(info)
        else:
            self.inadmissible[key] = info
            if self.manager is not None:
                self.manager.rows.on_park(info)
            self._park_same_hash(info)
        return True

    def _park_same_hash(self, info: WorkloadInfo) -> None:
        """Scheduling-equivalence hashing (cluster_queue.go:615
        handleInadmissibleHash): pending workloads identical in shape to a
        NoFit head would get the same verdict — bulk-park them. Gated:
        kube_features.go SchedulingEquivalenceHashing."""
        from kueue_tpu_torch.config import features
        if not features.enabled("SchedulingEquivalenceHashing"):
            return
        h = scheduling_hash(info.obj, self.name)
        for key, other in list(self.items.items()):
            if scheduling_hash(other.obj, self.name) == h:
                # Lazy heap deletion (see park()).
                del self.items[key]
                self.inadmissible[key] = other
                if self.manager is not None:
                    self.manager.rows.on_park(other)

    def queue_inadmissible(self) -> bool:
        """manager.go QueueInadmissibleWorkloads — move all inadmissible
        workloads back into the heap (on relevant cluster events).

        Fast path: park() leaves the heap node to lazy deletion, so an
        unchanged workload un-parks as a pure map move plus a row-cache
        re-activation (dirty-skipped when the shape is unchanged) — no
        key recompute, no native push. Requires the
        SAME info object still backing the live node (a re-submission
        would strand the new object) and a non-AFS queue (AFS keys
        freeze LocalQueue usage at push time, so a re-push must
        re-read it)."""
        moved = bool(self.inadmissible)
        afs = self.spec.admission_scope == "UsageBasedAdmissionFairSharing"
        for info in self.inadmissible.values():
            key = info.key
            self.items[key] = info
            id_ = self._id_of.get(key)
            if not afs and id_ is not None:
                entry = self._entry_of.get(id_)
                if entry is not None and entry[0] is info:
                    if self.manager is not None:
                        self.manager.rows.on_push(info, entry[1])
                    continue
            self._heap_push(info)
        self.inadmissible.clear()
        return moved

    def pop(self, now: Optional[float] = None) -> Optional[WorkloadInfo]:
        """cluster_queue.go:715 (Pop) — skip stale heap entries; entries
        with a future requeueAt (eviction backoff, workload_types.go:774
        requeueState) are held back until due."""
        held: list[tuple] = []  # (info, original sort key)
        result = None
        while True:
            id_ = self._hp.pop()
            if id_ is None:
                break
            info, sort_key = self._entry_of.pop(id_)
            self._id_of.pop(info.key, None)
            if self.items.get(info.key) is not info:
                continue
            requeue_at = info.obj.status.requeue_at
            if (now is not None and requeue_at is not None
                    and requeue_at > now):
                held.append((info, sort_key))
                continue
            del self.items[info.key]
            self.in_flight = info.key
            if self.manager is not None:
                self.manager.rows.on_pop(info.key)
            result = info
            break
        for info, sort_key in held:
            self._heap_push(info, sort_key)
        return result

    def pending(self) -> int:
        return len(self.items) + len(self.inadmissible)

    def pending_active(self) -> int:
        return len(self.items)


class SecondPassQueue:
    """pkg/cache/queue/second_pass_queue.go:36 — workloads whose admission
    needs a delayed re-evaluation (TAS node replacement, delayed topology
    requests). Two-step protocol: ``prequeue`` marks the intent, ``queue``
    arms it; ``take_all_ready`` drains everything armed and due."""

    INITIAL_BACKOFF = 1.0
    BACKOFF_FACTOR = 2.0
    MAX_BACKOFF = 30.0

    def __init__(self) -> None:
        self._prequeued: set[str] = set()
        self._queued: dict[str, WorkloadInfo] = {}
        self._ready_at: dict[str, float] = {}

    def prequeue(self, key: str) -> None:
        self._prequeued.add(key)

    def queue(self, info: WorkloadInfo, now: float = 0.0,
              iteration: int = 0) -> bool:
        enqueued = info.key in self._prequeued
        if enqueued:
            self._queued[info.key] = info
            self._ready_at[info.key] = now + self.next_delay(iteration)
        self._prequeued.discard(info.key)
        return enqueued

    def delete(self, key: str) -> None:
        self._queued.pop(key, None)
        self._ready_at.pop(key, None)
        self._prequeued.discard(key)

    def next_delay(self, iteration: int) -> float:
        return min(self.INITIAL_BACKOFF * self.BACKOFF_FACTOR ** iteration,
                   self.MAX_BACKOFF) if iteration > 0 else 0.0

    def take_all_ready(self, now: float) -> list[WorkloadInfo]:
        ready = [k for k, t in self._ready_at.items() if t <= now]
        out = [self._queued.pop(k) for k in ready]
        for k in ready:
            self._ready_at.pop(k, None)
        return out


class QueueManager:
    """pkg/cache/queue/manager.go:147 (Manager)."""

    def __init__(self, workload_ordering=None) -> None:
        from kueue_tpu_torch.tensor.rowcache import WorkloadRowCache

        self.cluster_queues: dict[str, PendingClusterQueue] = {}
        self.local_queues: dict[str, LocalQueue] = {}
        # Which timestamp drives FIFO for PodsReady-evicted workloads
        # (workload_info.Ordering); shared with the scheduler cycle so
        # heap pops and entry ordering agree. The row cache's timestamp
        # column keeps the default ordering, as the JAX package's does.
        self.workload_ordering = workload_ordering
        # AFS hook: lq key -> decayed usage (manager.go:68), set by
        # controllers/afs.AfsManager.
        self.lq_usage_fn = None
        self.second_pass = SecondPassQueue()
        # Incremental tensor rows over the pending world (the oracle
        # bridge's per-cycle encoding, tensor/rowcache.py).
        self.rows = WorkloadRowCache()
        # workload_info.InfoOptions (resource transformations, excluded
        # prefixes), set by the engine (workload.go:139 plumbing).
        self.info_options = None

    def add_cluster_queue(self, cq: ClusterQueue) -> None:
        existing = self.cluster_queues.get(cq.name)
        if existing is not None:
            # UpdateClusterQueue (manager.go:402): swap the spec in place
            # — the pending heap and inadmissible map survive a spec
            # update — then retry THIS queue's inadmissible workloads
            # (manager.go:423 scopes the retry to the updated CQ).
            existing.spec = cq
            self.queue_inadmissible_workloads({cq.name})
            return
        self.cluster_queues[cq.name] = PendingClusterQueue(cq, manager=self)

    def delete_cluster_queue(self, name: str) -> None:
        pcq = self.cluster_queues.pop(name, None)
        if pcq is not None:
            keys = set(pcq.items) | set(pcq.inadmissible)
            if pcq.in_flight is not None:
                keys.add(pcq.in_flight)
            for key in keys:
                self.rows.on_remove(key)

    def add_local_queue(self, lq: LocalQueue) -> None:
        self.local_queues[lq.key] = lq

    def delete_local_queue(self, key: str) -> None:
        self.local_queues.pop(key, None)

    def cluster_queue_for_workload(self, wl: Workload) -> Optional[str]:
        lq = self.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
        if lq is None:
            return None
        return lq.cluster_queue or None

    def add_or_update_workload(self, wl: Workload) -> Optional[WorkloadInfo]:
        """manager.go AddOrUpdateWorkload. A held LocalQueue keeps its
        workloads out of the pending heap (manager.go LQ stopPolicy
        gating); resume re-queues them."""
        lq = self.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
        if lq is not None and lq.stop_policy != StopPolicy.NONE:
            return None
        cq_name = self.cluster_queue_for_workload(wl)
        if cq_name is None or cq_name not in self.cluster_queues:
            return None
        # One-ClusterQueue invariant: a LocalQueue retarget between
        # pushes would otherwise leave the workload live in two pending
        # heaps (and delete_workload's one-CQ fast path would miss one).
        prev = self.rows.info_for(wl.key)
        if prev is not None and prev.cluster_queue != cq_name:
            old = self.cluster_queues.get(prev.cluster_queue)
            if old is not None:
                old.delete(wl.key)
        info = WorkloadInfo.from_workload(wl, cq_name,
                                          options=self.info_options)
        self.cluster_queues[cq_name].push_or_update(info)
        return info

    def delete_workload(self, wl: Workload) -> None:
        """Drop a workload from the pending world. Fast path: its
        LocalQueue mapping names the one ClusterQueue that can hold it;
        the full sweep only runs when the mapping is stale (LQ retarget
        between push and delete)."""
        key = wl.key
        cq_name = self.cluster_queue_for_workload(wl)
        pcq = self.cluster_queues.get(cq_name) if cq_name else None
        if pcq is not None and (key in pcq.items or key in pcq.inadmissible
                                or pcq.in_flight == key):
            pcq.delete(key)  # pcq.delete already releases the row
        else:
            # The JAX package calls delete on every ClusterQueue's queue
            # here; on one that does not hold the key that only releases
            # the row, which the call below does once. A workload that
            # left the pending world (finished, deactivated) takes this
            # path on deletion: at 1,000 ClusterQueues the sweep cost
            # 4 ms a delete (ROADMAP trap (cl)).
            for pcq in self.cluster_queues.values():
                if (key in pcq.items or key in pcq.inadmissible
                        or pcq.in_flight == key or key in pcq._id_of):
                    pcq.delete(key)
            self.rows.on_remove(key)
        self.second_pass.delete(key)

    def requeue_workload(self, info: WorkloadInfo,
                         reason: RequeueReason) -> bool:
        """manager.go:734 (RequeueWorkload)."""
        pcq = self.cluster_queues.get(info.cluster_queue)
        if pcq is None:
            return False
        return pcq.requeue_if_not_present(info, reason)

    def queue_inadmissible_workloads(self,
                                     cq_names: Optional[set[str]] = None) -> None:
        for name, pcq in self.cluster_queues.items():
            if cq_names is None or name in cq_names:
                pcq.queue_inadmissible()

    def heads(self, now: Optional[float] = None) -> list[WorkloadInfo]:
        """manager.go:872 (Heads) — one head per ClusterQueue.  Non-blocking
        variant: returns [] when nothing is pending."""
        out = []
        for pcq in self.cluster_queues.values():
            head = pcq.pop(now)
            if head is not None:
                out.append(head)
        return out

    def pending_workloads(self, cq_name: str) -> int:
        pcq = self.cluster_queues.get(cq_name)
        return pcq.pending() if pcq else 0

    def has_pending(self) -> bool:
        return any(pcq.pending_active() > 0
                   for pcq in self.cluster_queues.values())
