"""Engine <-> batched-oracle bridge: hybrid device/host scheduling cycles.

The port of ``kueue_tpu/oracle/engine_bridge.py``. The control plane
snapshots its caches into dense tensors, the device solves
nominate + order + commit for every ClusterQueue head at once
(``oracle/batched.cycle_step`` through the executor, a
``service.TorchExecutor``), and verdicts are applied through the same
assume path the sequential scheduler uses.

A cohort root runs on the device unless one of its member ClusterQueues
needs the host this cycle: a head the dense path cannot encode, a
flavor with taints, a namespace-selector mismatch, a closed preemption
gate, a TAS head the batched planner cannot place (``tas-*`` reasons),
or a preemption beyond the device preemptor (fair-sharing strategies,
more than ``v_cap`` victims). Host roots go through the
engine's sequential cycle in the same ``schedule_once`` call; roots
never share quota, so device-then-host is cycle-equivalent.

Multi-flavor resource groups on preemption-enabled ClusterQueues run the
sim-augmented nomination: the flavor grid (``ops/assign.flavor_grid``)
plus one batched preemption simulation per (group, flavor, resource)
cell (``ops/preempt.classical_targets``), folded through the host
fungibility lattice, then committed through the cycle's slot overrides.

TAS heads get their topology placements from the batched planner
(``tas/batched.plan_cycle``) before the cycle program runs, and the
device admits carrying one are re-checked in commit order
(``tas/batched.commit_plan``); ``KUEUE_TPU_TAS_BATCH=0`` hands every
root with a TAS flavor to the host instead.

Admission fair sharing and WorkloadPriorityClasses change only the rank
the heads kernel reduces: the row cache ranks on each workload's heap
sort key (LocalQueue usage frozen at push, then priority, timestamp and
sequence), so device and host head order agree by construction.
Admission checks change only the apply: with a check manager attached,
every admitted entry takes the engine's per-entry ``_admit``, which
reserves quota and holds Admitted until its checks are Ready. Neither
demotes a root.

Every executor call goes through the supervisor
(``oracle/supervisor.OracleSupervisor``, configured as in the JAX
package from ``KUEUE_TPU_ORACLE_RETRIES``, ``KUEUE_TPU_ORACLE_BREAKER_N``
and ``KUEUE_TPU_ORACLE_BREAKER_COOLDOWN``): a RemoteOracleError is
retried with backoff, a call that still fails feeds the circuit breaker
and leaves ``try_cycle`` (the engine decides the cycle on the host,
reason ``remote-error``), and while the breaker is open every cycle is a
``breaker-open`` host cycle until a half-open probe re-promotes the
device. Any other executor error (or a failed TAS launch) is counted by
the supervisor and propagates out of ``schedule_once``, as in the JAX
package; so does a RemoteExecutorError, the sidecar's executor failing
on its device. With a remote executor (``service.RemoteExecutor``, which has
no device) the bridge encodes on the engine's device, and the executor
ships host copies.

The speculation pipeline (``KUEUE_TPU_PIPELINE``, default on, as in the
JAX package): at the end of a device cycle ``_maybe_speculate`` encodes
the next cycle and runs its device program; the next ``try_cycle`` takes
it if the state token (clock, spec and admitted versions, row-cache
mutations, journal writes, workload and namespace counts) still matches,
and otherwise encodes afresh. A discarded speculation leaves what the JAX
package's leaves (the admitted-row sync, the row-cache flush, TAS memo
entries, the supervisor's bookkeeping of its executor call); its
counters and stats are deferred (``enc.deferred``) and applied only when
it is used. After two discards in a row the next end-of-cycle skips
speculating once (``pipeline_stats["skipped"]``). The executor here syncs
inside its call, so a speculative cycle's device time is spent in the
previous ``schedule_once``; ``last_cycle_phases["spec_encode"]`` reports
it, device time included, on the cycle that uses it.

The bridge writes the engine's registry as the JAX package's does
(``oracle_fallback_total``, ``oracle_host_root_total``,
``oracle_cycles_total``, the ``scheduler_phase_duration_seconds``
observations of a device cycle) and hands it to the supervisor (the
breaker's state and its counters). The JAX package also counts
``oracle_pipeline_total``, a family its registry does not register, so
its write is dropped; the port drops it too, and ``pipeline_stats``
holds the same counts.

With the obs layer attached the bridge reports what the JAX bridge
reports: ``obs.perf.device_call`` / ``device_result`` on the
``cycle_step`` call (launches, host-to-device and device-to-host bytes,
the shape-signature cache), the first through ``emit`` so a speculation
counts only when it is used; the ``apply.diff_build`` and
``apply.rowcache_writeback`` scopes; and, while a tracer is on,
``obs.device.PhaseAnnotator`` profiler ranges per phase.

The module-level ``cq_policy_cfg``, ``adm_padded`` and ``slot_maybe``
are the numpy argument helpers of the fused-preemption cycle.
"""

from __future__ import annotations

import os
import time
import zlib
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from kueue_tpu_torch.api.types import (
    BorrowWithinCohortPolicy,
    FlavorResource,
    PreemptionPolicy,
)
from kueue_tpu_torch.ops import assign as aops
from kueue_tpu_torch.obs import perf as _obs_perf
from kueue_tpu_torch.obs.device import PhaseAnnotator
from kueue_tpu_torch.ops import commit as cops
from kueue_tpu_torch.ops import preempt as pops
from kueue_tpu_torch.ops import quota as qops
from kueue_tpu_torch.oracle.supervisor import OracleSupervisor
from kueue_tpu_torch.scheduler.cycle import (
    CycleResult,
    Entry,
    EntryStatus,
    RequeueReason,
)
from kueue_tpu_torch.scheduler.flavorassigner import (
    BEST,
    WORST,
    Assignment,
    FlavorAssignment,
    GranularMode,
    Mode,
    PMode,
    PodSetAssignment,
    is_preferred,
    should_try_next_flavor,
)
from kueue_tpu_torch.scheduler.preemption import (
    IN_CLUSTER_QUEUE,
    IN_COHORT_RECLAIM_WHILE_BORROWING,
    IN_COHORT_RECLAMATION,
    Target,
)
from kueue_tpu_torch.tensor.schema import (
    WL_PAD_FILLS,
    encode_snapshot,
    pad_axis0,
    pow2_bucket,
)
from kueue_tpu_torch.workload_info import namespace_selector_mismatch

_HOST_BIG = np.int64(1) << 60


def pipeline_enabled() -> bool:
    """The speculation pipeline is on unless KUEUE_TPU_PIPELINE=0 or
    KUEUE_TPU_PIPELINE_DEPTH is 0 (the slot is single, so any depth of 1
    or more runs one cycle ahead), read per call as the JAX package
    reads them."""
    if os.environ.get("KUEUE_TPU_PIPELINE", "1") == "0":
        return False
    try:
        depth = int(os.environ.get("KUEUE_TPU_PIPELINE_DEPTH", "1"))
    except ValueError:
        depth = 1
    return depth > 0

_POLICY_CODE = {
    PreemptionPolicy.NEVER: pops.POLICY_NEVER,
    PreemptionPolicy.LOWER_PRIORITY: pops.POLICY_LOWER,
    PreemptionPolicy.LOWER_OR_NEWER_EQUAL_PRIORITY:
        pops.POLICY_LOWER_OR_NEWER_EQ,
    PreemptionPolicy.ANY: pops.POLICY_ANY,
}

_VARIANT_REASON = {
    pops.V_WITHIN_CQ: IN_CLUSTER_QUEUE,
    pops.V_HIERARCHICAL_RECLAIM: IN_COHORT_RECLAMATION,
    pops.V_RECLAIM_WITHOUT_BORROWING: IN_COHORT_RECLAMATION,
    pops.V_RECLAIM_WHILE_BORROWING: IN_COHORT_RECLAIM_WHILE_BORROWING,
}

# The world-structure arrays of the cycle, by cycle argument name.
_WORLD_ARGS = dict(
    nominal="nominal", lend_limit="lend_limit", borrow_limit="borrow_limit",
    parent="parent", ancestors="ancestors", height="height",
    group_of_res="group_of_res", group_flavors="group_flavors",
    no_preemption="no_preemption", can_pwb="can_preempt_while_borrowing",
    can_always_reclaim="can_always_reclaim", best_effort="best_effort",
    fung_borrow_try_next="fung_borrow_try_next",
    fung_pref_preempt_first="fung_pref_preempt_first",
    root_members="root_members", root_nodes="root_nodes",
    local_chain="local_chain", fair_weight="fair_weight",
    child_rank="child_rank", local_depth="local_depth",
    root_parent_local="root_parent_local")


def cq_policy_cfg(world, cluster_queues) -> dict:
    """Per-CQ preemption policy codes for the classical preemptor.
    ``cluster_queues`` maps a ClusterQueue name to its spec. Returns
    wcq_policy, reclaim_policy int32[C], bwc_forbidden bool[C],
    bwc_threshold int64[C] (NO_THRESHOLD = none) and cq_has_parent
    bool[C]."""
    C = world.num_cqs
    wcq_policy = np.zeros(C, np.int32)
    reclaim_policy = np.zeros(C, np.int32)
    bwc_forbidden = np.ones(C, bool)
    bwc_threshold = np.full(C, pops.NO_THRESHOLD, np.int64)
    cq_has_parent = np.zeros(C, bool)
    for ci, name in enumerate(world.cq_names):
        spec = cluster_queues[name]
        p = spec.preemption
        wcq_policy[ci] = _POLICY_CODE[p.within_cluster_queue]
        reclaim_policy[ci] = _POLICY_CODE[p.reclaim_within_cohort]
        if (p.borrow_within_cohort is not None
                and p.borrow_within_cohort.policy
                != BorrowWithinCohortPolicy.NEVER):
            bwc_forbidden[ci] = False
            thr = p.borrow_within_cohort.max_priority_threshold
            if thr is not None:
                bwc_threshold[ci] = thr
        cq_has_parent[ci] = spec.cohort is not None
    return dict(wcq_policy=wcq_policy, reclaim_policy=reclaim_policy,
                bwc_forbidden=bwc_forbidden, bwc_threshold=bwc_threshold,
                cq_has_parent=cq_has_parent)


def adm_padded(adm, world) -> dict:
    """The admitted axis padded to a power of two (padded rows have cq
    -1 and zero usage, so they are never candidates), the admitted ids
    grouped by cohort root (``adm_by_root`` int32[Rn, A_l], -1 pad; A_l
    the power-of-two bucket of the largest root's count) and the
    composite candidate-ordering rank (priority asc, reservation recency
    desc, uid asc). Keys: adm_cq, adm_pri, adm_ts, adm_qrt, adm_uid,
    adm_ev, adm_rank, adm_by_root, adm_usage."""
    A = adm.num_admitted
    Ap = pow2_bucket(A, 8)
    Rn = world.root_members.shape[0]
    root_of = np.where(adm.cq >= 0, world.root_of_cq[np.maximum(
        adm.cq, 0)], Rn) if A else np.zeros(0, np.int64)
    counts = np.bincount(root_of, minlength=Rn + 1)[:Rn]
    A_l = pow2_bucket(int(counts.max()) if counts.size else 1, 8)
    adm_by_root = np.full((max(Rn, 1), A_l), -1, np.int32)
    if A:
        order = np.argsort(root_of, kind="stable")
        sr = root_of[order]
        pos = np.arange(A) - np.searchsorted(sr, sr)
        valid = sr < Rn
        adm_by_root[sr[valid], pos[valid]] = order[valid]
    rank = np.empty(A, np.int64)
    rank[np.lexsort((adm.uid_rank, -adm.qr_time, adm.priority))] = \
        np.arange(A)
    tail = np.arange(A, Ap, dtype=np.int64)
    return dict(
        adm_cq=pad_axis0(adm.cq, Ap, -1),
        adm_pri=pad_axis0(adm.priority, Ap, 0),
        adm_ts=pad_axis0(adm.timestamp, Ap, 0.0),
        adm_qrt=pad_axis0(adm.qr_time, Ap, 0.0),
        adm_uid=(np.concatenate([adm.uid_rank, tail])
                 if Ap != A else adm.uid_rank),
        adm_ev=pad_axis0(adm.evicted, Ap, False),
        adm_rank=np.concatenate([rank, tail]) if Ap != A else rank,
        adm_by_root=adm_by_root,
        adm_usage=pad_axis0(adm.usage, Ap, 0))


def slot_maybe(world, pcfg, adm, head_pri) -> np.ndarray:
    """bool[C]: this slot's head could have preemption candidates, a
    conservative precheck against the admitted set (False only when no
    admitted workload can be a candidate). Cross-CQ reclaim is never
    prechecked; within-CQ policies are checked against each CQ's lowest
    admitted priority. ``head_pri`` int64[C] is each CQ head's priority
    (0 where there is none)."""
    C = world.num_cqs
    maybe = ((pcfg["reclaim_policy"] != pops.POLICY_NEVER)
             & pcfg["cq_has_parent"])
    wcq = pcfg["wcq_policy"]
    A = adm.num_admitted
    if A:
        valid = adm.cq >= 0
        cq_safe = np.where(valid, adm.cq, 0)
        big = np.iinfo(np.int64).max
        minpri = np.full(C, big, np.int64)
        np.minimum.at(minpri, cq_safe, np.where(valid, adm.priority, big))
        count = np.bincount(cq_safe, weights=valid, minlength=C)
        within = np.where(
            wcq == pops.POLICY_ANY, count > 0,
            np.where(wcq == pops.POLICY_LOWER, minpri < head_pri,
                     np.where(wcq == pops.POLICY_LOWER_OR_NEWER_EQ,
                              minpri <= head_pri, False)))
        maybe = maybe | within
    return maybe


class _CycleExit:
    """An early-exit verdict of :meth:`OracleBridge._encode_cycle`: a
    named fallback (``fallback_reason``) or a literal return value."""

    __slots__ = ("fallback_reason", "value")

    def __init__(self, fallback_reason=None, value=None):
        self.fallback_reason = fallback_reason
        self.value = value


def _flavor_taint_unsafe(rf) -> bool:
    """A flavor whose workloads must take the host path regardless of
    the batched TAS planner: taints need the host toleration
    matching."""
    return rf is not None and bool(rf.node_taints)


def _flavor_unsafe(rf) -> bool:
    """The host-path predicate with the batched TAS planner off: taints
    AND topologies demote. With the planner on, a topology alone no
    longer demotes — tas/batched.plan_cycle nominates placements for TAS
    heads inside the hybrid cycle and demotes per head only when a
    request needs an unsupported TAS feature."""
    return rf is not None and bool(rf.node_taints or rf.topology_name)


def _flavor_predicate():
    from kueue_tpu_torch.tas import batched as _tb
    return _flavor_taint_unsafe if _tb.enabled() else _flavor_unsafe


class OracleBridge:
    def __init__(self, engine, executor, max_depth: int = 4):
        self.engine = engine
        self.max_depth = max_depth
        # Where the device programs run: in-process
        # (service.TorchExecutor, on its device) or in an oracle sidecar
        # (service.RemoteExecutor).
        self.executor = executor
        # Where the cycle's inputs are encoded: the executor's device, or
        # the engine's when the executor has none (a remote one).
        self.device = getattr(executor, "device", None)
        if self.device is None:
            from kueue_tpu_torch.device import resolve_device
            self.device = resolve_device(engine.device)
        # Retry + circuit breaker around executor calls; breaker-open
        # cycles are refused up front in try_cycle until a half-open
        # probe re-promotes.
        self.supervisor = OracleSupervisor(
            metrics=engine.registry,
            max_attempts=int(os.environ.get("KUEUE_TPU_ORACLE_RETRIES", "3")),
            threshold=int(os.environ.get("KUEUE_TPU_ORACLE_BREAKER_N", "3")),
            cooldown_cycles=int(os.environ.get(
                "KUEUE_TPU_ORACLE_BREAKER_COOLDOWN", "8")))
        self.cycles_on_device = 0
        self.cycles_fallback = 0
        self.cycles_hybrid = 0  # device cycles with a host-root tail
        # Why try_cycle returned None, by label.
        self.fallback_reasons: dict[str, int] = {}
        # Why individual roots were handed to the host path.
        self.host_root_reasons: dict[str, int] = {}
        # CRC-32 of the last device cycle's raw verdict arrays.
        self.last_verdict_digest: Optional[int] = None
        # Batched-TAS planner accounting: per-phase totals and the
        # heads-per-launch histogram of tas_place_batch.
        self.tas_stats: dict[str, float] = {
            "plan_cycles": 0, "heads_planned": 0, "placed_device": 0,
            "placed_host": 0, "memo_hits": 0, "commit_drops": 0,
            "encode_s": 0.0, "place_s": 0.0, "decode_s": 0.0}
        self.tas_heads_per_launch: dict[int, int] = {}
        # Wall seconds of the last sim nomination's device calls.
        self.sim_seconds = 0.0
        # The speculation slot: (state_token, enc) of the next cycle,
        # encoded and run on the device, or ("error", exc) when that
        # failed (raised at the next try_cycle); None when empty.
        self._spec = None
        self.pipeline_stats: dict[str, int] = {
            "speculated": 0, "used": 0, "discarded": 0, "skipped": 0}
        # Discards in a row, and end-of-cycles left to skip speculating.
        self._spec_miss = 0
        self._spec_backoff = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def world_is_fast_path_safe(self) -> bool:
        """False while WaitForPodsReady's BlockAdmission holds admission
        (the host path owns the hold-everything requeue), and when every
        ClusterQueue with pending work has a flavor that demotes to the
        host (every root would demote)."""
        eng = self.engine
        if (eng.pods_ready is not None
                and eng.pods_ready.admission_blocked()):
            return False
        unsafe = _flavor_predicate()
        any_safe = False
        any_pending = False
        for name, pcq in eng.queues.cluster_queues.items():
            if not pcq.items:
                continue
            any_pending = True
            cq = eng.cache.cluster_queues.get(name)
            if cq is None:
                continue
            if not any(unsafe(eng.cache.resource_flavors.get(fq.name))
                       for rg in cq.resource_groups
                       for fq in rg.flavors):
                any_safe = True
                break
        if any_pending and not any_safe:
            return False
        return True

    def _fallback(self, reason: str) -> None:
        self.fallback_reasons[reason] = \
            self.fallback_reasons.get(reason, 0) + 1
        self._count("oracle_fallback_total", (reason,))
        return None

    def _host_root(self, reason: str, count: int = 1) -> None:
        self.host_root_reasons[reason] = \
            self.host_root_reasons.get(reason, 0) + count
        self._count("oracle_host_root_total", (reason,), count)

    def _count(self, family: str, labels: tuple,
               amount: float = 1.0) -> None:
        """Mirror a bridge counter into the engine's registry. A family
        the registry does not register is dropped, as in the JAX
        package."""
        try:
            self.engine.registry.counter(family).inc(labels, amount)
        except KeyError:
            pass

    def _exec_call(self, site: str, fn, *args, **kwargs):
        """Route one executor call through the supervisor: a
        RemoteOracleError is retried with backoff; a call that still
        fails feeds the circuit breaker before propagating."""
        sup = self.supervisor
        try:
            out = sup.call(site, fn, *args, **kwargs)
        except Exception:
            sup.record_failure(self.engine.cycle_seq)
            raise
        sup.record_success()
        return out

    def _world_tensors(self):
        """World structure tensors memoized by the cache's spec version;
        only the usage matrix is refilled per cycle from the live
        per-CQ aggregates."""
        cache = self.engine.cache
        cached = getattr(self, "_world_cache", None)
        if cached is None or cached[0] != cache.spec_version:
            w = encode_snapshot(cache.snapshot(), max_depth=self.max_depth)
            cq_idx = {n: i for i, n in enumerate(w.cq_names)}
            fl_idx = {n: i for i, n in enumerate(w.flavor_names)}
            s_idx = {n: i for i, n in enumerate(w.resource_names)}
            cached = (cache.spec_version, w, cq_idx, fl_idx, s_idx)
            self._world_cache = cached
        _, w, cq_idx, fl_idx, s_idx = cached
        S = w.num_resources
        usage = np.zeros_like(w.usage)
        for name, cqu in cache.cq_usage.items():
            ci = cq_idx.get(name)
            if ci is None:
                continue
            for fr, v in cqu.items():
                fi = fl_idx.get(fr.flavor)
                si = s_idx.get(fr.resource)
                if fi is not None and si is not None:
                    usage[ci, fi * S + si] = v
        w.usage = usage
        return w

    def _device_world_args(self, w) -> dict:
        """Device copies of the world-structure arrays, uploaded once
        per spec version."""
        ver = self.engine.cache.spec_version
        cached = getattr(self, "_dev_world_cache", None)
        if cached is None or cached[0] != ver:
            dev = {k: self._tensor(getattr(w, f))
                   for k, f in _WORLD_ARGS.items()}
            cached = (ver, dev)
            self._dev_world_cache = cached
        return dict(cached[1])

    def _cq_has_selector(self, w):
        """bool[C] mask of CQs with a namespace selector, or None when
        no CQ has one. Memoized by spec version."""
        cached = getattr(self, "_sel_cache", None)
        ver = self.engine.cache.spec_version
        if cached is None or cached[0] != ver:
            mask = np.zeros(w.num_cqs, bool)
            for ci, name in enumerate(w.cq_names):
                if self.engine.cache.cluster_queues[name] \
                        .namespace_selector is not None:
                    mask[ci] = True
            cached = (ver, mask if mask.any() else None)
            self._sel_cache = cached
        return cached[1]

    def _cq_flavor_safe(self, w) -> np.ndarray:
        """bool[C]: none of the CQ's flavors demotes to the host. With
        the batched TAS planner on, only taints demote here;
        topology-carrying CQs stay and get their placements from
        tas/batched.plan_cycle (which applies its own per-head demotion
        matrix)."""
        eng = self.engine
        unsafe = _flavor_predicate()
        safe = np.ones(w.num_cqs, bool)
        for ci, name in enumerate(w.cq_names):
            spec = eng.cache.cluster_queues[name]
            safe[ci] = not any(
                unsafe(eng.cache.resource_flavors.get(fq.name))
                for rg in spec.resource_groups for fq in rg.flavors)
        return safe

    def _cq_tas_mask(self, w):
        """bool[C] mask of CQs referencing at least one TAS flavor, or
        None when the world has none (the common case — skips the
        whole TAS planning block). Memoized by spec version."""
        cached = getattr(self, "_tas_mask_cache", None)
        ver = self.engine.cache.spec_version
        if cached is None or cached[0] != ver:
            from kueue_tpu_torch.tas import batched as _tb
            info = _tb.cq_tas_info(self.engine.cache)
            mask = np.zeros(w.num_cqs, bool)
            for ci, name in enumerate(w.cq_names):
                if name in info:
                    mask[ci] = True
            cached = (ver, mask if mask.any() else None)
            self._tas_mask_cache = cached
        return cached[1]

    def _cq_policy_cfg(self, w):
        """cq_policy_cfg of the live specs, with device copies under
        ``"j"`` (and ``root_of_cq``). Memoized by spec version."""
        cached = getattr(self, "_pcfg_cache", None)
        ver = self.engine.cache.spec_version
        if cached is not None and cached[0] == ver and cached[1] is w:
            return cached[2]
        cfg = cq_policy_cfg(w, self.engine.cache.cluster_queues)
        cfg["j"] = {k: self._tensor(v) for k, v in cfg.items()}
        cfg["j"]["root_of_cq"] = self._tensor(w.root_of_cq)
        self._pcfg_cache = (ver, w, cfg)
        return cfg

    def _encode_admitted(self, w):
        """Admitted tensors for the preemption kernels: an incremental
        row set updated from the cache's admitted-change log; ``info_of``
        maps kernel victim ids back to WorkloadInfos."""
        from kueue_tpu_torch.tensor.rowcache import AdmittedRows, \
            WorkloadRowCache

        sig = (WorkloadRowCache.world_signature(w), tuple(w.flavor_names))
        ar = getattr(self, "_adm_rows", None)
        if ar is None or ar.signature != sig:
            ar = AdmittedRows(w)
            self._adm_rows = ar
        adm = ar.sync(self.engine.cache, now=self.engine.clock)
        return ar.info_of, adm

    def _adm_padded(self, adm, w) -> dict:
        """adm_padded on the device, memoized per encoded admitted set."""
        cached = getattr(self, "_adm_pad_cache", None)
        if cached is not None and cached[0] is adm:
            return cached[1]
        ap = {k: self._tensor(v) for k, v in adm_padded(adm, w).items()}
        self._adm_pad_cache = (adm, ap)
        return ap

    def _slot_maybe(self, w, pcfg, adm, head_pri) -> np.ndarray:
        """slot_maybe, memoized per (adm, pcfg, heads): the sim
        nomination and the fused setup both need it within one cycle."""
        memo = getattr(self, "_maybe_memo", None)
        if (memo is not None and memo[0] is adm and memo[1] is pcfg
                and np.array_equal(memo[2], head_pri)):
            return memo[3]
        maybe = slot_maybe(w, pcfg, adm, head_pri)
        self._maybe_memo = (adm, pcfg, np.array(head_pri), maybe)
        return maybe

    def _classical_call(self, w, adm, pcfg, usage, slot_need, slot_pri,
                        slot_ts, slot_fr, slot_req, v_cap=32,
                        derived=None, slot_cq=None):
        """One batched classical_targets launch via the executor;
        returns numpy (found, overflow, mask, variant, borrow_after).
        ``derived`` is the caller's quota.derive_world for this usage;
        ``slot_cq`` decouples rows from CQ ids (batched sim cells)."""
        C = slot_need.shape[0]
        live = adm.live if adm.live is not None else adm.num_admitted
        if live == 0:
            return (np.zeros(C, bool), np.zeros(C, bool),
                    np.zeros((C, 0), bool), np.zeros((C, 0), np.int32),
                    np.zeros(C, np.int32))
        ap = self._adm_padded(adm, w)
        dw = self._device_world_args(w)
        tensors = dict(
            slot_need=slot_need, slot_pri=slot_pri, slot_ts=slot_ts,
            slot_fr=slot_fr, slot_req=slot_req,
            adm_cq=ap["adm_cq"], adm_pri=ap["adm_pri"],
            adm_ts=ap["adm_ts"], adm_qrt=ap["adm_qrt"],
            adm_uid=ap["adm_uid"], adm_ev=ap["adm_ev"],
            adm_rank=ap["adm_rank"], adm_by_root=ap["adm_by_root"],
            adm_usage=ap["adm_usage"], usage=usage,
            root_of_cq=pcfg["j"]["root_of_cq"],
            **{k: pcfg["j"][k] for k in (
                "wcq_policy", "reclaim_policy", "bwc_forbidden",
                "bwc_threshold", "cq_has_parent")},
            **{k: dw[k] for k in (
                "nominal", "lend_limit", "borrow_limit", "parent",
                "ancestors", "height", "local_chain", "root_nodes")})
        if slot_cq is not None:
            tensors["slot_cq"] = slot_cq
        found, overflow, mask, _n, variant, borrow_after = \
            self._exec_call(
                "classical_targets", self.executor.classical_targets,
                tensors, {"depth": int(w.depth), "v_cap": int(v_cap)},
                derived=derived)
        return found, overflow, mask, variant, borrow_after

    def _sim_nomination(self, w, wls, usage, head_idx, sim_slots,
                        adm, admitted, pcfg, v_cap=32):
        """Sim-augmented nomination for heads whose flavor choice depends
        on preemption simulations (multi-flavor groups on
        preemption-enabled CQs): the flavor grid on the device, each
        Preempt-gated (group, flavor, resource) cell simulated with the
        device classical preemptor (preemption_oracle.go:41
        SimulatePreemption), the fungibility lattice folded host-side
        with the scheduler/flavorassigner semantics, and slot overrides
        for the cycle.

        Returns (override, borrows_override, flavor_override, victims
        (row, vals, ids) or None, targets_by_slot, demote_cq bool[C]).
        The wall seconds of its two device calls (the flavor grid and the
        batched cell simulations, host copies included) are left in
        ``self.sim_seconds``."""
        C, S = w.num_cqs, w.num_resources
        G, F = w.group_flavors.shape[1], w.group_flavors.shape[2]
        demote_cq = np.zeros(C, bool)
        override = np.full(C, -1, np.int32)
        borrows_override = np.full(C, -1, np.int32)
        flavor_override = np.full((C, S), -1, np.int32)
        targets_by_slot: dict[int, list] = {}

        slots = np.nonzero(sim_slots)[0]
        h = head_idx[slots]
        h_cq = np.zeros(C, np.int32)
        h_req = np.zeros((C, S), np.int64)
        h_cq[slots] = slots  # head CQ == slot for valid heads
        # Sim heads are single-podset (try_cycle demotes multi-podset
        # heads on sim-needing CQs): pod set 0 carries the request.
        h_req[slots] = wls.requests[h, 0]

        t_grid = time.perf_counter()
        dw = self._device_world_args(w)
        derived = qops.derive_world(
            dw["nominal"], dw["lend_limit"], dw["borrow_limit"], usage,
            dw["parent"], depth=w.depth)
        g_pmode, g_borrow, g_sim, _g_in = aops.flavor_grid(
            self._tensor(h_cq), self._tensor(h_req), derived,
            dw["nominal"], dw["ancestors"], dw["height"],
            dw["group_of_res"], dw["group_flavors"], dw["no_preemption"],
            dw["can_pwb"], depth=w.depth, num_resources=S)
        g_pmode = g_pmode.cpu().numpy()
        g_borrow = g_borrow.cpu().numpy()
        g_sim = g_sim.cpu().numpy()
        self.sim_seconds = time.perf_counter() - t_grid
        g_sim[~sim_slots] = False

        # Batched per-cell sims: every (slot, group, flavor, resource)
        # cell in one classical_targets launch, each cell its own row
        # with slot_cq naming the head's CQ. Cells whose slot provably
        # has no candidates (_slot_maybe) resolve to found=False.
        head_pri = self._head_pri(wls, head_idx)
        head_ts = self._head_ts(wls, head_idx)
        maybe = self._slot_maybe(w, pcfg, adm, head_pri)
        cells = list(zip(*np.nonzero(np.any(g_sim, axis=0))))
        # cell -> (found bool[C], victims dict ci -> idx array,
        # borrow int32[C])
        sim_out: dict[tuple, tuple] = {
            cell: (np.zeros(C, bool), {}, np.zeros(C, np.int32))
            for cell in cells}
        row_ci: list[int] = []
        row_cell: list[tuple] = []
        for cell in cells:
            g, f, s = cell
            for ci in np.nonzero(g_sim[:, g, f, s] & maybe)[0]:
                row_ci.append(int(ci))
                row_cell.append(cell)
        adm_live = adm.live if adm.live is not None else adm.num_admitted
        if row_ci and adm_live:
            n_rows = len(row_ci)
            Rw = pow2_bucket(n_rows, 8)
            r_cq = np.zeros(Rw, np.int32)
            r_need = np.zeros(Rw, bool)
            r_pri = np.zeros(Rw, np.int64)
            r_ts = np.zeros(Rw, np.float64)
            r_fr = np.full((Rw, S), -1, np.int32)
            r_req = np.zeros((Rw, S), np.int64)
            for r, (ci, (g, f, s)) in enumerate(zip(row_ci, row_cell)):
                r_cq[r] = ci
                r_need[r] = True
                r_pri[r] = head_pri[ci]
                r_ts[r] = head_ts[ci]
                r_fr[r, s] = w.group_flavors[ci, g, f] * S + s
                r_req[r, s] = h_req[ci, s]
            t_cells = time.perf_counter()
            found_r, overflow_r, mask_r, _variant_r, borrow_r = \
                self._classical_call(
                    w, adm, pcfg, usage, r_need, r_pri, r_ts,
                    r_fr, r_req, v_cap=v_cap, derived=derived,
                    slot_cq=r_cq)
            self.sim_seconds += time.perf_counter() - t_cells
            for r, (ci, cell) in enumerate(zip(row_ci, row_cell)):
                f_arr, victims, b_arr = sim_out[cell]
                if overflow_r[r]:
                    demote_cq[ci] = True
                if found_r[r]:
                    f_arr[ci] = True
                    victims[ci] = np.nonzero(mask_r[r])[0]
                    b_arr[ci] = borrow_r[r]

        # Host-side fungibility fold (findFlavorForPodSets semantics)
        # on the device-computed granular modes.
        rep_of_slot = np.full(C, -1, np.int64)
        for ci in slots:
            if demote_cq[ci]:
                continue
            spec = self.engine.cache.cluster_queues[w.cq_names[ci]]
            fung = spec.flavor_fungibility
            req = h_req[ci]
            choice = np.full(S, -1, np.int32)
            rep_overall = int(PMode.FIT)
            overall_borrow = 0
            ok = True
            for g in range(G):
                res_ids = [s for s in range(S)
                           if w.group_of_res[ci, s] == g and req[s] > 0]
                if not res_ids:
                    continue
                best_mode = WORST
                best_fl = -1
                for f in range(F):
                    fl = int(w.group_flavors[ci, g, f])
                    if fl < 0:
                        continue
                    rep = BEST
                    for s in res_ids:
                        pm = int(g_pmode[ci, g, f, s])
                        br = int(g_borrow[ci, g, f, s])
                        if g_sim[ci, g, f, s]:
                            found, victims, borrow_after = \
                                sim_out[(g, f, s)]
                            if found[ci]:
                                vs = victims[ci]
                                same = any(adm.cq[v] == ci for v in vs)
                                pm = int(PMode.PREEMPT if same
                                         else PMode.RECLAIM)
                                br = int(borrow_after[ci])
                            else:
                                pm = int(PMode.NO_CANDIDATES)
                        mode = GranularMode(PMode(pm), br)
                        if is_preferred(rep, mode, fung):
                            rep = mode
                        if rep.pmode == PMode.NO_FIT:
                            break
                    if not should_try_next_flavor(rep, fung):
                        best_mode, best_fl = rep, fl
                        break
                    if is_preferred(rep, best_mode, fung):
                        best_mode, best_fl = rep, fl
                if best_fl < 0 or best_mode.pmode == PMode.NO_FIT:
                    ok = False
                    break
                for s in res_ids:
                    choice[s] = best_fl
                rep_overall = min(rep_overall, int(best_mode.pmode))
                overall_borrow = max(overall_borrow, best_mode.borrow)
            if not ok:
                continue  # NO_FIT: the plain assign pass parks identically
            flavor_override[ci] = choice
            rep_of_slot[ci] = rep_overall
            borrows_override[ci] = overall_borrow
            if rep_overall == int(PMode.FIT):
                override[ci] = cops.ENTRY_FIT

        # Final target selection for every preempt-mode representative
        # (NO_CANDIDATES included — the scheduler runs GetTargets for any
        # RepresentativeMode()==Preempt entry, preemption.go:129), with
        # the chosen assignment's full flavor-resource set.
        pre_slots = np.nonzero(
            (rep_of_slot >= int(PMode.NO_CANDIDATES))
            & (rep_of_slot < int(PMode.FIT)))[0]
        victims = None
        if pre_slots.size:
            need = np.zeros(C, bool)
            need[pre_slots] = True
            # Precheck-masked slots resolve to found=False without the
            # launch; skip it when no slot could have candidates.
            kernel_need = need & maybe
            if kernel_need.any():
                slot_fr = np.where(
                    flavor_override >= 0,
                    flavor_override.astype(np.int64) * S
                    + np.arange(S)[None, :], -1).astype(np.int32)
                slot_fr[~kernel_need] = -1
                slot_req = np.where(kernel_need[:, None], h_req, 0)
                found, overflow, mask, variant, borrow_after = \
                    self._classical_call(
                        w, adm, pcfg, usage, kernel_need,
                        np.where(sim_slots, head_pri, 0),
                        np.where(sim_slots, head_ts, 0.0),
                        slot_fr, slot_req, v_cap=v_cap, derived=derived)
                demote_cq |= overflow & kernel_need
            else:
                found = np.zeros(C, bool)
                mask = np.zeros((C, 0), bool)
                variant = np.zeros((C, 0), np.int32)
                borrow_after = np.zeros(C, np.int32)
            V = v_cap
            R = max(w.num_flavors, 1) * max(S, 1)
            victim_row = np.full((C, V), -1, np.int32)
            victim_vals = np.zeros((C, V, R), np.int64)
            victim_ids = np.full((C, V), -1, np.int32)
            for ci in pre_slots:
                if demote_cq[ci]:
                    continue
                if found[ci]:
                    override[ci] = cops.ENTRY_PREEMPT
                    borrows_override[ci] = borrow_after[ci]
                    self._fill_victims(
                        ci, np.nonzero(mask[ci])[0][:V], variant[ci],
                        admitted, adm, w, victim_row, victim_vals,
                        victim_ids, targets_by_slot)
                else:
                    override[ci] = (cops.ENTRY_SKIP
                                    if w.can_always_reclaim[ci]
                                    else cops.ENTRY_RESERVE)
            victims = (victim_row, victim_vals, victim_ids)
        return (override, borrows_override, flavor_override, victims,
                targets_by_slot, demote_cq)

    @staticmethod
    def _fill_victims(ci, vs, variant_row, admitted, adm, w, victim_row,
                      victim_vals, victim_ids, targets_by_slot):
        """Pack one slot's chosen victims into the kernel's victim arrays
        and the host-side target list."""
        targets_by_slot[int(ci)] = [
            (admitted[v],
             _VARIANT_REASON.get(int(variant_row[v]), IN_CLUSTER_QUEUE))
            for v in vs]
        for j, v in enumerate(vs):
            victim_row[ci, j] = w.local_chain[adm.cq[v], 0]
            victim_vals[ci, j] = adm.usage[v]
            victim_ids[ci, j] = v

    @staticmethod
    def _head_pri(wls, head_idx):
        h = np.maximum(head_idx, 0)
        return np.where(head_idx >= 0, wls.priority[h], 0)

    @staticmethod
    def _head_ts(wls, head_idx):
        h = np.maximum(head_idx, 0)
        return np.where(head_idx >= 0, wls.timestamp[h], 0.0)

    def try_cycle(self) -> Optional[CycleResult]:
        """Attempt one hybrid cycle. Returns None to request full
        sequential fallback (nothing has been mutated in that case)."""
        eng = self.engine
        if not self.supervisor.allow_cycle(eng.cycle_seq):
            # Breaker open: the device path is known-bad; go straight to
            # the host path without paying retries or timeouts.
            self._spec = None
            return self._fallback("breaker-open")
        if not self.world_is_fast_path_safe():
            self._spec = None
            return self._fallback("world")

        if not any(pcq.items for pcq in
                   eng.queues.cluster_queues.values()):
            if any(pcq.inadmissible for pcq in
                   eng.queues.cluster_queues.values()):
                # Only parked workloads remain; the sequential path owns
                # the inadmissible re-queueing bookkeeping.
                return self._fallback("idle-inadmissible")
            return CycleResult()

        t0 = time.perf_counter()
        enc = self._take_speculation()
        if enc is None:
            enc = self._encode_cycle()
            if isinstance(enc, _CycleExit):
                if enc.fallback_reason is not None:
                    return self._fallback(enc.fallback_reason)
                return enc.value
        t_encode = time.perf_counter()
        result = self._commit_cycle(enc, t0, t_encode)
        if result is not None:
            self._maybe_speculate()
        return result

    # -- the speculation pipeline --

    def _state_token(self) -> tuple:
        """Everything _encode_cycle reads, versioned: a speculation is
        used only if the token at its dispatch equals the token at use."""
        eng = self.engine
        return (eng.clock,
                eng.cache.spec_version,
                eng.cache.admitted_version,
                eng.queues.rows.mutation_seq,
                getattr(eng.journal, "writes_seq", 0),
                len(eng.workloads),
                len(eng.namespace_labels))

    def _take_speculation(self):
        """The speculated cycle if its token still holds, its deferred
        counters applied; None for a fresh encode. A failed speculative
        dispatch raises here, where the serial loop would have."""
        slot = self._spec
        if slot is None:
            return None
        self._spec = None
        head, payload = slot
        if head == "error":
            raise payload
        if head != self._state_token():
            self.pipeline_stats["discarded"] += 1
            self._count("oracle_pipeline_total", ("discarded",))
            self._spec_miss += 1
            if self._spec_miss >= 2:
                self._spec_backoff = 1
            return None
        for fn, a in payload.deferred:
            fn(*a)
        payload.deferred = ()
        self.pipeline_stats["used"] += 1
        self._count("oracle_pipeline_total", ("used",))
        self._spec_miss = 0
        self._spec_backoff = 0
        return payload

    def _maybe_speculate(self) -> None:
        """Encode the next cycle and run its device program now, its
        counters deferred until it is used (a discarded one leaves them
        as the serial loop would)."""
        eng = self.engine
        if not pipeline_enabled():
            self._spec = None
            return
        if self._spec_backoff > 0:
            self._spec_backoff -= 1
            self.pipeline_stats["skipped"] += 1
            self._spec = None
            return
        if not any(pcq.items for pcq in
                   eng.queues.cluster_queues.values()):
            self._spec = None
            return
        try:
            enc = self._encode_cycle(defer_stats=True)
        except Exception as e:  # noqa: BLE001 — raised at the next cycle
            self._spec = ("error", e)
            return
        if isinstance(enc, _CycleExit):
            self._spec = None
            return
        enc.speculative = True
        self._spec = (self._state_token(), enc)
        self.pipeline_stats["speculated"] += 1

    def _commit_tas_stats(self, tas_plan) -> None:
        st = self.tas_stats
        st["plan_cycles"] += 1
        st["heads_planned"] += len(tas_plan.placements) + sum(
            len(v) for v in tas_plan.demote.values())
        st["placed_device"] += tas_plan.placed_device
        st["placed_host"] += tas_plan.placed_host
        st["memo_hits"] += tas_plan.memo_hits
        st["encode_s"] += tas_plan.timings["encode"]
        st["place_s"] += tas_plan.timings["place"]
        st["decode_s"] += tas_plan.timings["decode"]
        for n in tas_plan.launch_sizes:
            self.tas_heads_per_launch[n] = \
                self.tas_heads_per_launch.get(n, 0) + 1

    def _encode_cycle(self, defer_stats: bool = False):
        """The encode phase: world + row tensors, head selection with
        hold-back, per-root host/device partitioning, batched TAS
        nomination, the sim-augmented multi-flavor nomination, the
        cycle's device inputs, and the executor's call. Returns the
        encoded cycle, its device outputs in ``out``, for _commit_cycle,
        or a _CycleExit. ``defer_stats`` (a speculation) buffers the
        host-root counters and TAS stats into ``enc.deferred``."""
        eng = self.engine
        t_start = time.perf_counter()
        deferred: list = []
        if defer_stats:
            def emit(fn, *a):
                deferred.append((fn, a))
        else:
            def emit(fn, *a):
                fn(*a)
        # Profiler ranges mirroring the phase marks: a torch.profiler
        # capture shows kueue_tpu_torch.oracle.{encode,device,apply,
        # finalize} around the kernels each phase launched (no-op unless
        # a cycle tracer is active). Every early return closes it.
        _ann = PhaseAnnotator()
        _ann.phase("encode")
        now = eng.clock
        rows = eng.queues.rows
        rows.maybe_compact()
        w = self._world_tensors()
        rows.refresh_held(now)
        wl = rows.tensors(w)
        pending_infos = rows.info_of
        W = wl.num_workloads
        C = w.num_cqs
        Rn = w.root_members.shape[0]

        # --- host-side head + root partitioning ---
        ready = rows.requeue_at <= now
        active = rows.active & ready & (wl.cq >= 0)
        rank = rows.head_ranks()
        cq_safe_idx = np.maximum(wl.cq, 0)

        # Head selection with live hold-back checks: requeue-at can be
        # mutated on status without a queue transition, and only heads
        # gate on it (cluster_queue.go:715). A held head yields to the
        # next-ranked workload of its CQ.
        for _hold_round in range(16):
            eff = np.where(active, rank, _HOST_BIG)
            head_rank = np.full(C, _HOST_BIG, np.int64)
            np.minimum.at(head_rank, cq_safe_idx,
                          np.where(wl.cq >= 0, eff, _HOST_BIG))
            has_head = head_rank < _HOST_BIG
            is_head = active & (wl.cq >= 0) \
                & (eff == head_rank[cq_safe_idx])
            head_wid = np.full(C, -1, np.int64)
            head_wid[wl.cq[is_head]] = np.nonzero(is_head)[0]
            held = []
            for wid in head_wid[has_head]:
                ra = pending_infos[wid].obj.status.requeue_at
                rows.requeue_at[wid] = -np.inf if ra is None else ra
                if ra is not None and ra > now:
                    held.append(wid)
            if not held:
                break
            active[held] = False
        else:
            _ann.close()
            return _CycleExit(fallback_reason="held-head-churn")

        head_eligible = np.zeros(C, bool)
        head_eligible[has_head] = wl.eligible[head_wid[has_head]]
        flavor_safe = self._cq_flavor_safe(w)

        # Namespace-selector CQs: a mismatched head parks as
        # inadmissible at nomination (scheduler.go:636); the host path
        # owns that bookkeeping, so those heads' roots demote.
        ns_mismatch = np.zeros(C, bool)
        sel_cqs = self._cq_has_selector(w)
        if sel_cqs is not None:
            for ci in np.nonzero(has_head & sel_cqs)[0]:
                if namespace_selector_mismatch(
                        eng.cache.cluster_queues[w.cq_names[ci]]
                        .namespace_selector,
                        eng.namespace_labels.get(
                            pending_infos[head_wid[ci]].obj.namespace)):
                    ns_mismatch[ci] = True

        root_of_cq = w.root_of_cq
        host_root = np.zeros(Rn, bool)

        def demote(cq_mask: np.ndarray, reason: str) -> None:
            """Hand every root containing a flagged CQ to the host path;
            reason counters are per newly-demoted root."""
            roots = np.unique(root_of_cq[cq_mask])
            new = roots[~host_root[roots]]
            if new.size:
                emit(self._host_root, reason, int(new.size))
                host_root[new] = True

        demote(has_head & ~head_eligible, "head-ineligible")
        demote(has_head & ~flavor_safe, "flavor-unsafe")
        demote(ns_mismatch, "namespace-mismatch")
        # Closed preemption gates: the gate semantics live in the host
        # path (cycle.py _process_entry), so gated heads go there.
        gated = np.zeros(C, bool)
        for ci in np.nonzero(has_head)[0]:
            if pending_infos[head_wid[ci]].obj.has_closed_preemption_gate():
                gated[ci] = True
        demote(gated, "preemption-gated")

        # --- batched TAS planning (tas/batched.py) ---
        # Nominate a topology assignment for every device-eligible TAS
        # head BEFORE the cycle program launches; heads needing an
        # unsupported TAS feature (or whose placement fails) demote
        # only their root. With the planner off (KUEUE_TPU_TAS_BATCH=0)
        # _cq_flavor_safe already demoted every TAS CQ above.
        from kueue_tpu_torch.tas import batched as _tb
        tas_plan = None
        tas_cq = None
        t_tas0 = time.perf_counter()
        if _tb.enabled():
            tas_cq = self._cq_tas_mask(w)
            # The serving rows keep topology heads device-eligible on
            # the planner's behalf (schema.serving_shape_eligible); a
            # topology head on a CQ with no TAS flavor can't be placed
            # by anyone — the host path owns its inadmissible verdict.
            topo = np.zeros(C, bool)
            for ci in np.nonzero(has_head)[0]:
                inf = pending_infos[head_wid[ci]]
                h = getattr(inf, "_has_topo_req", None)
                if h is None:
                    h = any(ps.topology_request is not None
                            for ps in inf.obj.pod_sets)
                    inf._has_topo_req = h
                topo[ci] = h
            demote(topo if tas_cq is None else (topo & ~tas_cq),
                   "tas-flavor-mismatch")
        if tas_cq is not None:
            # Preemption-enabled TAS CQs: the host owns the
            # PREEMPT -> simulate-empty ladder AND the sim grid never
            # sees TAS flavors (pre-demoting keeps sim_cq clean).
            demote(has_head & tas_cq & ~w.no_preemption,
                   "tas-preemption")
            need = has_head & tas_cq & ~host_root[root_of_cq]
            if need.any():
                tas_plan = _tb.plan_cycle(eng, w, head_wid, need)
                for reason, cis in sorted(tas_plan.demote.items()):
                    m = np.zeros(C, bool)
                    m[cis] = True
                    demote(m, reason)
                # Shared-forest closure: forests also committed by
                # host-root TAS heads must serialize through one path.
                closed = _tb.closure_demotions(
                    tas_plan, _tb.cq_tas_info(eng.cache), w, has_head,
                    tas_cq, host_root)
                if closed:
                    m = np.zeros(C, bool)
                    m[closed] = True
                    demote(m, "tas-forest-shared")
                emit(self._commit_tas_stats, tas_plan)
        t_tas = time.perf_counter() - t_tas0
        cq_on_device = ~host_root[root_of_cq]

        # Multi-flavor groups on preemption-enabled CQs: the flavor
        # choice depends on preemption simulations
        # (flavorassigner.go:1198 + preemption_oracle.go:30), so those
        # heads get the sim-augmented nomination before the cycle runs.
        if w.group_flavors.shape[2] > 1:
            mf = np.any(w.group_flavors[:, :, 1:] >= 0, axis=(1, 2))
        else:
            mf = np.zeros(C, bool)
        sim_cq = (mf & ~w.no_preemption & has_head & head_eligible
                  & flavor_safe & cq_on_device)
        if sim_cq.any():
            # The sim grid doesn't thread per-workload flavor masks;
            # node-filtered heads that need simulation go host.
            if wl.flavor_ok is not None:
                masked = np.zeros(C, bool)
                for ci in np.nonzero(sim_cq)[0]:
                    # Only flavors the CQ's resource groups reference
                    # matter.
                    fls = w.group_flavors[ci]
                    fls = fls[fls >= 0]
                    if fls.size and not wl.flavor_ok[
                            head_wid[ci]][fls].all():
                        masked[ci] = True
                if masked.any():
                    demote(masked, "sim-flavor-mask")
                    cq_on_device = ~host_root[root_of_cq]
                    sim_cq = sim_cq & cq_on_device
        if sim_cq.any():
            # The sim grid is single-podset; multi-podset heads needing
            # it go host.
            multi_ps = np.zeros(C, bool)
            for ci in np.nonzero(sim_cq)[0]:
                if len(pending_infos[head_wid[ci]].total_requests) > 1:
                    multi_ps[ci] = True
            if multi_ps.any():
                demote(multi_ps, "sim-multi-podset")
                cq_on_device = ~host_root[root_of_cq]
                sim_cq = sim_cq & cq_on_device
        pre = None
        pcfg = adm = admitted = None
        t_sim = 0.0
        if sim_cq.any():
            if eng.cycle.enable_fair_sharing:
                # Fair-sharing preemption stays host-side; so do heads
                # whose nomination would need it.
                demote(sim_cq, "fair-needs-sim")
                cq_on_device = ~host_root[root_of_cq]
            else:
                pcfg = self._cq_policy_cfg(w)
                admitted, adm = self._encode_admitted(w)
                (p_override, p_borrows, p_flavor, p_victims, p_targets,
                 demote_cq) = self._sim_nomination(
                    w, wl, self._tensor(w.usage), head_wid,
                    sim_cq, adm, admitted, pcfg)
                t_sim = self.sim_seconds
                if demote_cq.any():
                    demote(demote_cq, "sim-overflow")
                    cq_on_device = ~host_root[root_of_cq]
                off = ~cq_on_device
                p_override[off] = -1
                p_borrows[off] = -1
                p_flavor[off] = -1
                if p_victims is not None:
                    p_victims[0][off] = -1
                    p_victims[2][off] = -1
                p_targets = {ci: t for ci, t in p_targets.items()
                             if cq_on_device[ci]}
                pre = (p_override, p_borrows, p_flavor, p_victims,
                       p_targets)

        device_w = active & wl.eligible & (wl.cq >= 0) \
            & cq_on_device[cq_safe_idx]
        if not device_w.any():
            _ann.close()
            return _CycleExit(fallback_reason="all-host")

        # --- device cycle ---
        # World-structure arrays stay on the device across cycles
        # (re-uploaded only on spec changes); per-cycle uploads are the
        # row arrays and the usage. The workload axis is bucket-padded.
        host = dict(rank=rank, commit_rank=rows.commit_ranks(),
                    wl_cq=wl.cq, wl_req=wl.requests,
                    wl_priority=wl.priority,
                    wl_has_qr=wl.has_quota_reservation,
                    wl_hash=wl.hash_id, wl_ts=wl.timestamp)
        if wl.flavor_ok is not None:
            # Per-workload flavor eligibility (taints/selectors/affinity):
            # node-filtered rows ride the dense path.
            host["wl_flavor_ok"] = wl.flavor_ok
        Wp = pow2_bucket(W, 64)
        device_w_padded = device_w
        if Wp != W:
            for key, fill in WL_PAD_FILLS.items():
                if key in host:
                    host[key] = pad_axis0(host[key], Wp, fill)
            device_w_padded = pad_axis0(device_w, Wp, False)
        args = {k: self._tensor(v) for k, v in host.items()}
        args.update(self._device_world_args(w))
        # Plain ints and bools: a remote executor sends them as JSON.
        statics = dict(depth=int(w.depth),
                       num_resources=int(w.num_resources),
                       num_cqs=int(w.num_cqs),
                       fair_mode=bool(eng.cycle.enable_fair_sharing),
                       num_flavors=int(max(w.num_flavors, 1)))
        pre_kwargs = {}
        preempt_targets: dict[int, list] = {}
        if pre is not None:
            p_override, p_borrows, p_flavor, p_victims, p_targets = pre
            preempt_targets.update(p_targets)
            pre_kwargs = dict(
                slot_kind_override=self._tensor(p_override),
                slot_borrows_override=self._tensor(p_borrows),
                slot_flavor_override=self._tensor(p_flavor))
            if p_victims is not None:
                a_pad = pow2_bucket(adm.num_admitted, 8)
                pre_kwargs.update(
                    slot_victim_row=self._tensor(p_victims[0]),
                    slot_victim_vals=self._tensor(p_victims[1]),
                    slot_victim_ids=self._tensor(p_victims[2]),
                    claimed0=self._tensor(np.zeros(a_pad, bool)))

        # Fused classical preemption: with any preemption-enabled CQ in
        # a classical world, ship the admitted tensors + policy config so
        # preempt-flagged slots get their victims selected inside the
        # cycle.
        fused = (not eng.cycle.enable_fair_sharing
                 and bool(np.any(~w.no_preemption)))
        if fused:
            if pcfg is None:
                pcfg = self._cq_policy_cfg(w)
            if adm is None:
                admitted, adm = self._encode_admitted(w)
            ap = self._adm_padded(adm, w)
            pre_kwargs.update(
                adm_cq=ap["adm_cq"], adm_pri=ap["adm_pri"],
                adm_ts=ap["adm_ts"], adm_qrt=ap["adm_qrt"],
                adm_uid=ap["adm_uid"], adm_evicted=ap["adm_ev"],
                adm_usage=ap["adm_usage"],
                pc_wcq_policy=pcfg["j"]["wcq_policy"],
                pc_reclaim_policy=pcfg["j"]["reclaim_policy"],
                pc_bwc_forbidden=pcfg["j"]["bwc_forbidden"],
                pc_bwc_threshold=pcfg["j"]["bwc_threshold"],
                pc_cq_has_parent=pcfg["j"]["cq_has_parent"],
                root_of_cq=pcfg["j"]["root_of_cq"],
                adm_rank=ap["adm_rank"],
                adm_by_root=ap["adm_by_root"],
                slot_maybe=self._tensor(self._slot_maybe(
                    w, pcfg, adm, self._head_pri(wl, head_wid))))
        _ann.phase("device")
        inputs = dict(pending=self._tensor(device_w_padded),
                      inadmissible=self._tensor(np.zeros(Wp, bool)),
                      usage=self._tensor(w.usage), **args, **pre_kwargs)
        # Counted when the call is committed: a speculation's count waits
        # in ``deferred`` and a discarded one counts nothing.
        emit(_obs_perf.device_call, "cycle_step", inputs, statics)
        t_call = time.perf_counter()
        out = self._exec_call("cycle_step", self.executor.cycle_step,
                              inputs, statics)
        t_end = time.perf_counter()
        _ann.close()
        return SimpleNamespace(
            out=out, w=w, wl=wl,
            pending_infos=pending_infos, now=now, W=W, C=C,
            cq_safe_idx=cq_safe_idx, device_w=device_w,
            cq_on_device=cq_on_device, host_root=host_root,
            root_of_cq=root_of_cq, has_head=has_head, fused=fused,
            admitted=admitted, preempt_targets=preempt_targets,
            tas_plan=tas_plan, t_tas=t_tas, t_sim=t_sim,
            device_s=t_end - t_call, encode_s=t_end - t_start,
            deferred=deferred, speculative=False)

    def _commit_cycle(self, enc, t0: float,
                      t_encode: float) -> Optional[CycleResult]:
        """Commit a device cycle (``enc`` fresh or the used
        speculation): the TAS commit-order re-check, the verdicts
        through the engine's assume path, then status finalization,
        then the host tail."""
        from kueue_tpu_torch.tas import batched as _tb

        eng = self.engine
        w, wl, out = enc.w, enc.wl, enc.out
        pending_infos = enc.pending_infos
        now, W, C = enc.now, enc.W, enc.C
        cq_safe_idx, device_w = enc.cq_safe_idx, enc.device_w
        cq_on_device = enc.cq_on_device
        host_root, root_of_cq = enc.host_root, enc.root_of_cq
        has_head = enc.has_head
        admitted = enc.admitted
        preempt_targets = enc.preempt_targets

        def demote(cq_mask: np.ndarray, reason: str) -> None:
            roots = np.unique(root_of_cq[cq_mask])
            new = roots[~host_root[roots]]
            if new.size:
                self._host_root(reason, int(new.size))
                host_root[new] = True

        _ann = PhaseAnnotator()
        _ann.phase("device")
        if _obs_perf.ACTIVE is not None:
            _obs_perf.device_result("cycle_step", out)
        (new_pending, new_inadmissible, usage2, wl_admitted, slot_admitted,
         slot_position, flavor_of_res, any_oracle, slot_oracle,
         slot_preempting, head_idx, slot_overflow, victim_mask,
         victim_variant) = out
        t_device = time.perf_counter()
        _ann.phase("apply")

        if enc.fused:
            overflow = slot_overflow & cq_on_device
            if overflow.any():
                # More victims than v_cap: the host preemptor owns those
                # roots this cycle.
                demote(overflow, "preemption-overflow")
                cq_on_device = ~host_root[root_of_cq]
            # Host-side Target lists for the preempting slots, from the
            # in-program victim selection. Slots with a victim set whose
            # commit lost are the reference's skipped preemptions,
            # counted by _apply.
            sp = slot_preempting
            vmask = victim_mask
            found_any = (vmask.any(axis=1) if vmask.size
                         else np.zeros(C, bool))
            if (sp | found_any).any():
                for ci in np.nonzero((sp | found_any) & cq_on_device)[0]:
                    if int(ci) in preempt_targets:
                        continue  # sim-nomination slot (host-built)
                    preempt_targets[int(ci)] = [
                        (admitted[v],
                         _VARIANT_REASON.get(int(victim_variant[ci, v]),
                                             IN_CLUSTER_QUEUE))
                        for v in np.nonzero(vmask[ci])[0]]
        if bool(any_oracle):
            if eng.cycle.enable_fair_sharing:
                # Fair-sharing preemption strategies stay host-side.
                demote(slot_oracle, "preemption-scope")
                cq_on_device = ~host_root[root_of_cq]
            # Defensive: any slot still flagged must be on a host root
            # (classical worlds decide preemption in-program).
            still = slot_oracle & cq_on_device
            if still.any():
                demote(still, "unexpected-oracle-flag")
                cq_on_device = ~host_root[root_of_cq]

        self.cycles_on_device += 1
        # A fingerprint of the raw device verdicts (before host decode).
        vd = 0
        for arr in (wl_admitted, slot_admitted, slot_position,
                    slot_preempting, victim_mask):
            vd = zlib.crc32(np.ascontiguousarray(arr).tobytes(), vd)
        self.last_verdict_digest = vd

        # Commit-order re-check for planned TAS admits: serialize them
        # through the overlay (tas/batched.commit_plan); a nominated
        # placement beaten to its leaves by an earlier slot DROPS its
        # admit verdict — the batched form of the sequential commit
        # skip. Dropped rows were never popped, so they simply stay
        # pending for the next cycle.
        tas_plan = enc.tas_plan
        tas_attach = None
        tas_drops: list = []
        if tas_plan is not None and tas_plan.placements:
            for _round in range(C + 1):
                tas_attach, tas_drops, demote_cis = _tb.commit_plan(
                    eng, w, wl, tas_plan, wl_admitted, slot_position,
                    flavor_of_res, cq_on_device, W)
                if not demote_cis:
                    break
                # A drop on a multi-CQ root invalidates the root's
                # later quota verdicts; the host re-runs the root.
                m = np.zeros(C, bool)
                m[demote_cis] = True
                demote(m, "tas-commit-conflict")
                cq_on_device = ~host_root[root_of_cq]
            if tas_drops:
                self.tas_stats["commit_drops"] += len(tas_drops)
                wl_admitted = wl_admitted.copy()
                wl_admitted[tas_drops] = False

        apply_rows = device_w & cq_on_device[cq_safe_idx]
        result, finalize = self._apply(
            w, wl, pending_infos, wl_admitted, new_inadmissible,
            slot_position, flavor_of_res, apply_rows=apply_rows,
            slot_mask=cq_on_device, slot_preempting=slot_preempting,
            head_idx=head_idx, preempt_targets=preempt_targets,
            tas_attach=tas_attach)
        for i in tas_drops:
            # Sequential stats/entry parity for commit skips
            # (_process_entry's "no longer fits" verdict).
            e = Entry(info=pending_infos[i])
            e.status = EntryStatus.SKIPPED
            e.inadmissible_msg = (
                "Workload no longer fits after processing another "
                "workload")
            result.entries.append(e)
            result.stats.skipped += 1
        t_apply = time.perf_counter()
        _ann.phase("finalize")
        finalize()
        # Phase accounting: encode (snapshot + tensorize + the sim
        # nomination's host fold; TAS planning included, also reported
        # as tas_place) / sim (the sim nomination's two device calls) /
        # device (the cycle's executor call, transfers included) / apply
        # (decode + cache assume) / finalize (status).
        t_final = time.perf_counter()
        _ann.close()
        # A fresh cycle ran its device call inside the encode interval;
        # a used speculation ran all of it in the previous cycle, whose
        # wall holds ``spec_encode`` (device time included), and its
        # encode here is the token check.
        if enc.speculative:
            encode_s, sim_s, device_s = t_encode - t0, 0.0, 0.0
        else:
            encode_s, sim_s, device_s = (
                t_encode - t0 - enc.device_s - enc.t_sim, enc.t_sim,
                enc.device_s)
        phases = {"encode": encode_s, "sim": sim_s,
                  "device": device_s + (t_device - t_encode),
                  "apply": t_apply - t_device, "finalize": t_final - t_apply,
                  "tas_place": enc.t_tas}
        if enc.speculative:
            phases["spec_encode"] = enc.encode_s
        eng.last_cycle_phases = phases
        # The registry's phase series are the JAX package's: its encode
        # holds the sim nomination.
        hist = eng.registry.histogram("scheduler_phase_duration_seconds")
        for phase, dur in phases.items():
            if phase == "sim":
                continue
            hist.observe(dur + sim_s if phase == "encode" else dur, (phase,))

        # --- host tail: sequential cycle over the host roots ---
        eng.last_cycle_mode = "device"
        host_cqs = np.nonzero(has_head & ~cq_on_device)[0]
        if host_cqs.size:
            self.cycles_hybrid += 1
            eng.last_cycle_mode = "hybrid"
            heads = []
            for ci in host_cqs:
                pcq = eng.queues.cluster_queues.get(w.cq_names[ci])
                if pcq is None:
                    continue
                h = pcq.pop(now)
                if h is not None:
                    heads.append(h)
            if heads:
                host_result = eng._sequential_cycle(heads,
                                                    count_cycle=False)
                result.entries.extend(host_result.entries)
                result.inadmissible.extend(host_result.inadmissible)
                st, hst = result.stats, host_result.stats
                st.admitted += hst.admitted
                st.preempting += hst.preempting
                st.skipped += hst.skipped
                st.inadmissible += hst.inadmissible
                for k, v in hst.preemption_skips.items():
                    st.preemption_skips[k] = \
                        st.preemption_skips.get(k, 0) + v
        self._count("oracle_cycles_total", (eng.last_cycle_mode,))
        return result

    def _apply(self, w, wls, pending_infos, wl_admitted, parked,
               slot_position, flavor_of_res, apply_rows=None,
               slot_mask=None, slot_preempting=None,
               head_idx=None, preempt_targets=None, tas_attach=None):
        """Apply verdicts through the engine's assume path. Rows outside
        ``apply_rows`` / slots outside ``slot_mask`` belong to host roots
        and are left untouched (the sequential tail owns them).

        Returns ``(CycleResult, finalize)``: the caller invokes
        ``finalize()`` (status conditions and events) after stopping the
        apply-phase clock."""
        eng = self.engine
        result = CycleResult()
        W = len(pending_infos)
        if apply_rows is None:
            apply_rows = np.ones(W, bool)
        if slot_mask is None:
            slot_mask = np.ones(w.num_cqs, bool)
        if slot_preempting is None:
            slot_preempting = np.zeros(w.num_cqs, bool)

        # Group verdict rows per slot.
        admit_of_slot: dict[int, int] = {}
        parked_of_slot: dict[int, list[int]] = {}
        adm_rows = np.nonzero(wl_admitted[:W] & apply_rows)[0]
        for ci, i in zip(wls.cq[adm_rows].tolist(), adm_rows.tolist()):
            admit_of_slot[ci] = i
        park_rows = np.nonzero(parked[:W] & apply_rows)[0]
        for ci, i in zip(wls.cq[park_rows].tolist(), park_rows.tolist()):
            parked_of_slot.setdefault(ci, []).append(i)

        # Apply per slot in the host's nominate order (the queue manager's
        # ClusterQueue iteration order). Cohort-inadmissible requeues
        # triggered by evictions are deferred to one bulk pass after the
        # loop, exactly like the sequential path.
        cq_idx = {n: i for i, n in enumerate(w.cq_names)}
        nominate_order = [cq_idx[n] for n in eng.queues.cluster_queues
                          if n in cq_idx]
        bulk = eng.begin_bulk_admit()
        requeue_cohorts: set = set()
        eng._deferred_cohort_requeue = requeue_cohorts
        try:
            pairs = self._apply_slots(
                nominate_order, slot_mask, admit_of_slot,
                parked_of_slot, pending_infos, w, wls,
                flavor_of_res, slot_position,
                slot_preempting, head_idx, preempt_targets,
                eng, bulk, result, tas_attach=tas_attach)
        finally:
            eng._deferred_cohort_requeue = None

        def finalize() -> None:
            eng.bulk_finalize_batch(pairs, bulk)
            eng._requeue_cohorts_bulk(requeue_cohorts)
            eng.flush_bulk_admit(bulk)

        return result, finalize

    def _apply_slots(self, nominate_order, slot_mask, admit_of_slot,
                     parked_of_slot, pending_infos, w, wls, flavor_of_res,
                     slot_position, slot_preempting, head_idx,
                     preempt_targets, eng, bulk, result, tas_attach=None):
        admits = []
        _pt = _obs_perf.begin()
        # The per-slot loop reads its verdict columns through plain
        # Python lists, and the assignment-flyweight key bytes for all
        # slots come from one contiguous tobytes() sliced per slot.
        slot_mask_l = slot_mask.tolist()
        slot_preempting_l = slot_preempting.tolist()
        slot_position_l = slot_position.tolist()
        head_idx_l = head_idx.tolist() if head_idx is not None else None
        fob = np.ascontiguousarray(flavor_of_res)
        fb_stride = fob.shape[1] * fob.shape[2] * fob.itemsize
        fb_all = fob.tobytes()
        for ci in nominate_order:
            if not slot_mask_l[ci]:
                continue
            i = admit_of_slot.get(ci)
            if i is not None:
                info = pending_infos[i]
                entry = self._make_entry(
                    info, w, wls, flavor_of_res, i,
                    topo=None if tas_attach is None
                    else tas_attach.get(i),
                    fbytes=fb_all[ci * fb_stride:(ci + 1) * fb_stride],
                    ci=ci)
                entry.status = EntryStatus.ASSUMED
                entry.commit_position = slot_position_l[ci]
                admits.append(entry)
                result.entries.append(entry)
                result.stats.admitted += 1
            if slot_preempting_l[ci]:
                wid = head_idx_l[ci]
                info = pending_infos[wid]
                entry = self._make_entry(info, w, wls, flavor_of_res, wid)
                entry.status = EntryStatus.PREEMPTING
                entry.preemption_targets = [
                    Target(victim, reason)
                    for victim, reason in preempt_targets.get(int(ci), [])]
                entry.inadmissible_msg = (
                    f"Preempting {len(entry.preemption_targets)} "
                    "workload(s)")
                eng._issue_preemptions(entry, bulk=bulk)
                result.entries.append(entry)
                result.stats.preempting += 1
            head_row = head_idx_l[ci] if head_idx_l is not None else -1
            for i in parked_of_slot.get(ci, ()):
                info = pending_infos[i]
                pcq = eng.queues.cluster_queues.get(info.cluster_queue)
                if pcq is not None:
                    pcq.park(info.key)
                # Entries surface only for parked heads (the sequential
                # path parks scheduling-equivalence siblings silently).
                if i == head_row:
                    entry = Entry(info=info,
                                  requeue_reason=RequeueReason.NO_FIT)
                    entry.inadmissible_msg = "NoFit (batched oracle)"
                    result.entries.append(entry)
        _obs_perf.end("apply.diff_build", _pt)
        # Preempt-mode slots whose victim set was selected but whose
        # commit lost are the reference's skipped preemptions
        # (scheduler.go:432): counted like _sequential_cycle does.
        if preempt_targets:
            for ci, targets in preempt_targets.items():
                if targets and not slot_preempting[ci]:
                    name = w.cq_names[ci]
                    result.stats.preemption_skips[name] = \
                        result.stats.preemption_skips.get(name, 0) + 1
            for cq_name, skips in result.stats.preemption_skips.items():
                m = eng.metrics.admission_cycle_preemption_skips
                m[cq_name] = m.get(cq_name, 0) + skips
                eng.registry.counter(
                    "admission_cycle_preemption_skips").inc(
                    (cq_name,), skips)
        # The whole cycle's admissions assumed in one flat engine pass;
        # status finalization is deferred to the finalize phase.
        _pt = _obs_perf.begin()
        pairs = eng.bulk_assume_batch(admits, bulk)
        _obs_perf.end("apply.rowcache_writeback", _pt)
        return pairs

    def _make_entry(self, info, w, wls, flavor_of_res, i,
                    topo=None, fbytes=None, ci=None) -> Entry:
        """Entry for an admitted verdict row. Assignments are flyweights:
        rows with equal scheduling-equivalence hash (less its ClusterQueue)
        and equal slot flavor picks share one immutable Assignment. TAS
        admits carry a per-admission topology assignment (``topo``) and
        bypass the flyweight both ways.

        ``flavor_of_res[ci]`` is [P, S]: one PodSetAssignment per real
        pod set (flavorassigner.go:707)."""
        if ci is None:
            ci = int(wls.cq[i])
        ver = self.engine.cache.spec_version
        cache = getattr(self, "_assignment_cache", None)
        if cache is None or cache[0] != ver:
            cache = (ver, {})
            self._assignment_cache = cache
        rows = self.engine.queues.rows
        if fbytes is None:
            fbytes = flavor_of_res[ci].tobytes()
        h = rows._hash_tuple[i]
        key = (h[1:] if h is not None else None, fbytes)
        if topo is None and h is not None:
            cached = cache[1].get(key)
            if cached is not None:
                return Entry(info=info, assignment=cached)
        pod_sets = []
        usage: dict[FlavorResource, int] = {}
        for p, psr in enumerate(info.total_requests):
            flavors = {}
            for s_i, res in enumerate(w.resource_names):
                fl = flavor_of_res[ci, p, s_i]
                if fl < 0 or wls.requests[i, p, s_i] <= 0:
                    continue
                name = w.flavor_names[fl]
                flavors[res] = FlavorAssignment(name=name, mode=Mode.FIT)
                fr = FlavorResource(name, res)
                usage[fr] = usage.get(fr, 0) + int(wls.requests[i, p, s_i])
            pod_sets.append(PodSetAssignment(
                name=psr.name, flavors=flavors,
                requests=dict(psr.requests), count=psr.count,
                topology_assignment=None if topo is None
                else topo.get(psr.name)))
        assignment = Assignment(pod_sets=pod_sets, usage=usage)
        if topo is None and h is not None:
            cache[1][key] = assignment
        return Entry(info=info, assignment=assignment)
