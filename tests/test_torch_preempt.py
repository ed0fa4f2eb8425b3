"""The port's preemption target selection (kueue_tpu_torch/ops/preempt.py)
vs the JAX package's, on the CPU: within_cq_targets on the worlds of
tests/test_preempt_device.py and classical_targets (all six outputs) on
those of tests/test_classical_preempt_device.py, with the optional
slot_cq, adm_rank and adm_by_root given and not given, and a case that
needs more than v_cap victims. The worlds are encoded by the JAX package
and carried across with carry.py; every output must be equal, dtype
included."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_classical_preempt_device as tcp
import test_preempt_device as tpd
from kueue_tpu.api.types import PodSet, PreemptionPolicy, Workload
from kueue_tpu.ops import preempt as jp
from kueue_tpu.ops import quota as jq
from kueue_tpu.tensor.schema import encode_admitted, encode_snapshot
from kueue_tpu_torch import carry
from kueue_tpu_torch.oracle import engine_bridge as eb
from kueue_tpu_torch.ops import preempt as tp
from kueue_tpu_torch.ops import quota as tq
from test_torch_drain import to_port


def _t(a):
    return torch.as_tensor(np.array(a))


def assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for i, (g, x) in enumerate(zip(got, want)):
        x = np.asarray(x)
        g = g.numpy()
        assert g.dtype == x.dtype, (i, g.dtype, x.dtype)
        np.testing.assert_array_equal(g, x, err_msg=f"output {i}")


def engine_inputs(eng, head, rng):
    """The world, its admitted set and one slot per ClusterQueue: the
    preemptor ``head`` (a WorkloadInfo) at its ClusterQueue with the
    host's flavor assignment, random heads elsewhere. Encoded by the JAX
    package and carried across."""
    now = eng.clock
    snapshot = eng.cache.snapshot()
    world = encode_snapshot(snapshot, max_depth=4)
    admitted = [info for cqs in snapshot.cluster_queues.values()
                for info in cqs.workloads.values()]
    adm = encode_admitted(world, admitted, now=now)
    C, S = world.num_cqs, world.num_resources
    slots = dict(
        slot_need=rng.random(C) < 0.8,
        slot_pri=rng.integers(0, 10, C).astype(np.int64),
        slot_ts=rng.random(C) * now,
        slot_fr=np.tile(np.arange(S, dtype=np.int32), (C, 1)),
        slot_req=rng.choice([500, 1500, 2500, 4000], (C, S)).astype(
            np.int64))
    from kueue_tpu.scheduler.cycle import SchedulerCycle
    assignment, _ = SchedulerCycle()._get_assignments(head, snapshot, now)
    ci = world.cq_names.index(head.cluster_queue)
    slots["slot_need"][ci] = True
    slots["slot_pri"][ci] = head.obj.effective_priority
    slots["slot_ts"][ci] = head.obj.creation_time
    slots["slot_fr"][ci] = -1
    slots["slot_req"][ci] = 0
    for fr, v in assignment.usage.items():
        s = world.resource_names.index(fr.resource)
        slots["slot_fr"][ci, s] = world.fr_index(fr.flavor, fr.resource)
        slots["slot_req"][ci, s] = v
    usage = np.zeros((world.num_nodes, world.nominal.shape[1]), np.int64)
    usage[:C] = world.usage[:C]
    return (carry.world_tensors(vars(world)),
            carry.admitted_tensors(vars(adm)), slots, usage, snapshot)


def derive_both(w, usage):
    args = (w.nominal, w.lend_limit, w.borrow_limit, usage, w.parent)
    return (jq.derive_world(*map(jnp.asarray, args), depth=w.depth),
            tq.derive_world(*map(_t, args), depth=w.depth))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("policy", [
    PreemptionPolicy.LOWER_PRIORITY,
    PreemptionPolicy.LOWER_OR_NEWER_EQUAL_PRIORITY,
])
def test_within_cq_targets_match_jax(seed, policy):
    rng = random.Random(1000 * seed + 7)
    eng = tpd.build_engine(rng, n_cqs=rng.randrange(1, 4), policy=policy)
    now = eng.clock + 1.0
    eng.clock = now
    wl = Workload(name="pre", queue_name="lq0", priority=rng.choice([3, 5]),
                  creation_time=now,
                  pod_sets=(PodSet("main", 1,
                                   {"cpu": rng.choice([1500, 2500])}),))
    eng.submit(wl)
    pcq = eng.queues.cluster_queues["cq0"]
    head = pcq.items.get(wl.key) or next(iter(pcq.items.values()))
    w, adm, slots, usage, snapshot = engine_inputs(
        eng, head, np.random.default_rng(seed))
    wcq_policy = np.array([
        tpd._POLICY_CODE.get(
            snapshot.cluster_queues[n].spec.preemption.within_cluster_queue,
            jp.POLICY_NEVER) for n in w.cq_names], np.int32)
    jd, td = derive_both(w, usage)
    arrays = (slots["slot_need"], slots["slot_pri"], slots["slot_ts"],
              slots["slot_fr"], slots["slot_req"], wcq_policy, adm.cq,
              adm.priority, adm.timestamp, adm.qr_time, adm.uid_rank,
              adm.evicted, adm.usage)
    tail = (w.lend_limit, w.borrow_limit, w.ancestors)
    for v_max in (16, 1):
        want = jp.within_cq_targets(
            *map(jnp.asarray, arrays), jd["usage"], jd["subtree_quota"],
            *map(jnp.asarray, tail), depth=w.depth, v_max=v_max)
        got = tp.within_cq_targets(
            *map(_t, arrays), td["usage"], td["subtree_quota"],
            *map(_t, tail), depth=w.depth, v_max=v_max)
        assert_outputs_equal(got, want)


def classical_world(seed):
    """tests/test_classical_preempt_device.py's world for ``seed``, with
    its preemptor submitted."""
    rng = random.Random(31 * seed + 5)
    eng, n_cqs = tcp.build_engine(rng)
    now = eng.clock + 1.0
    eng.clock = now
    wl = Workload(name="pre", queue_name=f"lq{rng.randrange(n_cqs)}",
                  priority=rng.choice([3, 5, 9]), creation_time=now,
                  pod_sets=(PodSet("main", 1,
                                   {"cpu": rng.choice([1500, 2500])}),))
    eng.submit(wl)
    pcq = eng.queues.cluster_queues[
        eng.queues.cluster_queue_for_workload(wl)]
    return engine_inputs(eng, pcq.items[wl.key],
                         np.random.default_rng(seed))


def policy_arrays(w, snapshot):
    """The policy codes, through the port's cq_policy_cfg (held against
    the bridge's own in test_torch_preempt_world.py)."""
    return eb.cq_policy_cfg(w, {n: to_port(snapshot.cluster_queues[n].spec)
                                for n in w.cq_names})


def classical_both(w, adm, slots, usage, snapshot, *, v_cap, slot_cq=None,
                   ranked=False, grouped=False):
    pcfg = policy_arrays(w, snapshot)
    if ranked or grouped:
        ap = eb.adm_padded(adm, w)
        adm_arrays = (ap["adm_cq"], ap["adm_pri"], ap["adm_ts"],
                      ap["adm_qrt"], ap["adm_uid"], ap["adm_ev"],
                      ap["adm_usage"])
    else:
        adm_arrays = (adm.cq, adm.priority, adm.timestamp, adm.qr_time,
                      adm.uid_rank, adm.evicted, adm.usage)
    arrays = (slots["slot_need"], slots["slot_pri"], slots["slot_ts"],
              slots["slot_fr"], slots["slot_req"], pcfg["wcq_policy"],
              pcfg["reclaim_policy"], pcfg["bwc_forbidden"],
              pcfg["bwc_threshold"], pcfg["cq_has_parent"]) + adm_arrays
    tail = (w.lend_limit, w.borrow_limit, w.nominal, w.ancestors, w.height,
            w.local_chain, w.root_nodes, w.root_of_cq)
    opts = dict(slot_cq=slot_cq,
                adm_rank=ap["adm_rank"] if ranked else None,
                adm_by_root=ap["adm_by_root"] if grouped else None)
    jd, td = derive_both(w, usage)
    want = jp.classical_targets(
        *map(jnp.asarray, arrays), jd["usage"], jd["subtree_quota"],
        *map(jnp.asarray, tail), depth=w.depth, v_cap=v_cap,
        **{k: None if v is None else jnp.asarray(v)
           for k, v in opts.items()})
    got = tp.classical_targets(
        *map(_t, arrays), td["usage"], td["subtree_quota"], *map(_t, tail),
        depth=w.depth, v_cap=v_cap,
        **{k: None if v is None else _t(v) for k, v in opts.items()})
    assert_outputs_equal(got, want)
    return [np.asarray(x) for x in want]


@pytest.mark.parametrize("seed", range(12))
def test_classical_targets_match_jax(seed):
    w, adm, slots, usage, snapshot = classical_world(seed)
    classical_both(w, adm, slots, usage, snapshot, v_cap=16)


@pytest.mark.parametrize("mode", ["plain", "adm_rank", "adm_by_root",
                                  "both", "slot_cq"])
@pytest.mark.parametrize("seed", [0, 7])
def test_classical_targets_optional_inputs(seed, mode):
    w, adm, slots, usage, snapshot = classical_world(seed)
    slot_cq = None
    if mode == "slot_cq":
        # Rows decoupled from CQ ids: every CQ once, then random CQs.
        rng = np.random.default_rng(seed + 100)
        C = w.num_cqs
        extra = rng.integers(0, C, 5)
        slot_cq = np.concatenate([np.arange(C), extra]).astype(np.int32)
        slots = {k: np.concatenate([v, v[extra]]) for k, v in slots.items()}
        slots["slot_pri"] = rng.integers(0, 10, len(slot_cq))
    classical_both(w, adm, slots, usage, snapshot, v_cap=16,
                   slot_cq=slot_cq, ranked=mode in ("adm_rank", "both"),
                   grouped=mode in ("adm_by_root", "both"))


@pytest.mark.parametrize("grouped", [False, True])
def test_classical_targets_overflow(grouped):
    """With v_cap 1, slots that need two or more victims overflow."""
    hits = 0
    for seed in range(3):
        w, adm, slots, usage, snapshot = classical_world(seed)
        slots["slot_need"][:] = True
        slots["slot_pri"][:] = 9
        slots["slot_req"][:] = 4000
        want = classical_both(w, adm, slots, usage, snapshot, v_cap=1,
                              ranked=grouped, grouped=grouped)
        hits += int(want[1].sum())
    assert hits > 0


@pytest.mark.parametrize("seed", range(3))
def test_lexsort_matches_numpy_lexsort(seed):
    """Chained stable argsorts, least significant key first, equal
    jnp.lexsort row by row, ties included (trap (k))."""
    rng = np.random.default_rng(seed)
    B, n = 4, 64
    keys = [rng.integers(0, 3, (B, n)), rng.integers(0, 2, n),
            -np.round(rng.random(n), 1), rng.integers(0, 2, (B, n))]
    got = tp._lexsort([_t(k) for k in keys], (B, n)).numpy()
    for b in range(B):
        want = np.asarray(jnp.lexsort(tuple(
            jnp.asarray(k[b] if k.ndim == 2 else k) for k in keys)))
        np.testing.assert_array_equal(got[b], want)
