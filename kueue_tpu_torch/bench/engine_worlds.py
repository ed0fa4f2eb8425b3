"""Serving-engine worlds of the JAX package's bench and tests, driven
through the port's ``Engine``, and the runs that ``chip_smoke.py``
phases 10-13 and ``profile_drain.py`` make of them.

Copies of ``bench.py``'s ``build_cycle_engine`` and ``_drain_engine``
(the ``cycle_latency`` and ``fair_cycle_latency`` scenarios), of the
world of ``bench_preempt_churn`` and of the world and churn of
``tests/test_multiflavor_preempt_device.py``. Each takes a ``Kit``: the
API types, scenario generators and engine to build the world with. The
port's kit (``port_kit``) is the default; the parity tests pass the JAX
package's to compute the same runs there. ``decision_stream`` serialises
one cycle's decisions as the engine parity tests compare them; the crc32
of the concatenated streams pins a run against the JAX engine's.
"""

from __future__ import annotations

import gc
import os
import random
import time
import zlib
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from types import ModuleType
from typing import Callable


@dataclass
class Kit:
    """What a world is built with: ``types`` (the API types module),
    ``scenario`` (the scenario generators module), ``engine(fair,
    **kwargs)`` a new engine (keywords such as ``config=`` go to the
    engine), ``attach(engine)`` attaching its oracle, ``tas`` the TAS
    snapshot module (its ``Node`` and ``HOSTNAME_LABEL``), ``afs``
    the admission-fair-sharing module (``AfsManager``, ``_LqUsage``),
    ``admissionchecks`` the admission-checks module, ``non_tas_usage``
    the non-TAS pod usage module (its ``PodUsage``), ``replay`` the
    flight recorder package (``FlightRecorder``, ``replay_trace``), and
    the job path's modules: ``jobframework`` (``BatchJob``,
    ``JobReconciler``), ``integrations`` (``StatefulSetJob``),
    ``webhooks`` (``JobWebhookRegistry``), ``podtemplate`` and
    ``limitrange``, the controllers world's: ``config_api`` (its
    ``from_dict``), ``podsready``, ``status``, ``booster``,
    ``concurrentadmission``, ``importer`` and ``populator``, and the
    MultiKueue world's: ``multikueue`` (``MultiKueueController``,
    ``MultiKueueConfig``, ``Dispatcher``) and ``features`` (the feature
    gates it sets), and the client world's: ``client`` (the client
    package: ``KueueClient``, ``Informer``, ``ApplyEngine`` and its
    builders, ``RemoteClient``), ``kueuectl`` (the CLI module: ``run``,
    ``main``), ``http_server`` (its ``ServingEndpoint``) and ``journal``
    (the journal module: ``attach_new_journal``)."""

    types: ModuleType
    scenario: ModuleType
    engine: Callable
    attach: Callable
    tas: ModuleType = None
    afs: ModuleType = None
    admissionchecks: ModuleType = None
    non_tas_usage: ModuleType = None
    replay: ModuleType = None
    jobframework: ModuleType = None
    integrations: ModuleType = None
    webhooks: ModuleType = None
    podtemplate: ModuleType = None
    limitrange: ModuleType = None
    config_api: ModuleType = None
    podsready: ModuleType = None
    status: ModuleType = None
    booster: ModuleType = None
    concurrentadmission: ModuleType = None
    importer: ModuleType = None
    populator: ModuleType = None
    multikueue: ModuleType = None
    features: ModuleType = None
    client: ModuleType = None
    kueuectl: ModuleType = None
    http_server: ModuleType = None
    journal: ModuleType = None


def port_kit(device=None) -> Kit:
    """The port's types, scenarios and Engine, its TAS forests and its
    oracle on ``device`` (CUDA unless the caller asks for the CPU)."""
    from kueue_tpu_torch import client, replay
    from kueue_tpu_torch.api import types
    from kueue_tpu_torch.bench import scenario
    from kueue_tpu_torch.config import api as config_api
    from kueue_tpu_torch.config import features
    from kueue_tpu_torch.controllers import (
        admissionchecks,
        afs,
        booster,
        concurrentadmission,
        importer,
        integrations,
        jobframework,
        multikueue,
        podsready,
        populator,
        status,
    )
    from kueue_tpu_torch.cli import kueuectl
    from kueue_tpu_torch.controllers.engine import Engine
    from kueue_tpu_torch.store import journal
    from kueue_tpu_torch.tas import non_tas_usage, snapshot
    from kueue_tpu_torch.utils import limitrange, podtemplate
    from kueue_tpu_torch.visibility import http_server
    from kueue_tpu_torch.webhooks import jobwebhooks

    return Kit(types, scenario,
               lambda fair=False, **kw: Engine(enable_fair_sharing=fair,
                                               device=device, **kw),
               lambda eng: eng.attach_oracle(device=device), snapshot,
               afs, admissionchecks, non_tas_usage, replay, jobframework,
               integrations, jobwebhooks, podtemplate, limitrange,
               config_api, podsready, status, booster, concurrentadmission,
               importer, populator, multikueue, features, client,
               kueuectl, http_server, journal)


# The serving loop's arms: (KUEUE_TPU_PIPELINE, KUEUE_TPU_COLUMNAR).
# "full" is both packages' default.
LOOP_ARMS = {"serial": ("0", "0"), "columnar": ("0", "1"),
             "pipelined": ("1", "0"), "full": ("1", "1")}


@contextmanager
def loop_arm(name):
    """Run the block with the serving loop's variables set to the arm
    ``name`` (an entry of LOOP_ARMS; None leaves the environment as it
    is), in both packages alike; restores them after."""
    if name is None:
        yield
        return
    keys = ("KUEUE_TPU_PIPELINE", "KUEUE_TPU_COLUMNAR")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(zip(keys, LOOP_ARMS[name]))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def build_cycle_engine(scen, fair=False, kit=None):
    """One serving engine over a scenario world, oracle attached."""
    kit = kit or port_kit()
    eng = kit.engine(fair)
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts:
        eng.create_cohort(co)
    for cq in scen.cluster_queues:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues:
        eng.create_local_queue(lq)
    for wl in scen.workloads:
        eng.clock += 0.0001
        eng.submit(wl)
    kit.attach(eng)
    return eng


def _drain_engine(eng, max_cycles=5_000, on_cycle=None):
    """Cycles until one neither admits nor preempts; preempting cycles
    are followed by ``tick(0.0)``. ``on_cycle(result)`` sees every
    cycle's result."""
    admitted = preempting = 0
    while max_cycles > 0:
        max_cycles -= 1
        r = eng.schedule_once()
        if on_cycle is not None:
            on_cycle(r)
        if r is None:
            break
        admitted += r.stats.admitted
        preempting += r.stats.preempting
        if r.stats.preempting:
            eng.tick(0.0)  # evictions land; victims requeue
        elif not r.stats.admitted:
            break
    return admitted, preempting


def preempt_churn_engine(n_pending, n_cohorts=20, cqs_per_cohort=5,
                         kit=None, on_cycle=None, on_attach=None):
    """``bench_preempt_churn``'s world: an admitted low-priority
    population at about 80% of capacity (drained through the engine),
    then ``n_pending`` high-priority arrivals that must preempt or
    reclaim their way in. Returns the engine with the wave pending.
    ``on_attach(engine)`` runs once the oracle is attached."""
    kit = kit or port_kit()
    t = kit.types
    n_cqs = n_cohorts * cqs_per_cohort
    nominal = 4000
    rng = random.Random(7)
    eng = kit.engine()
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    for c in range(n_cohorts):
        eng.create_cohort(t.Cohort(f"co-{c}"))
    for i in range(n_cqs):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort=f"co-{i % n_cohorts}",
            preemption=t.ClusterQueuePreemption(
                within_cluster_queue=t.PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=(
                    t.PreemptionPolicy.LOWER_PRIORITY if i % 2
                    else t.PreemptionPolicy.NEVER)),
            resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas("default",
                                          {"cpu": t.ResourceQuota(
                                              nominal)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq-{i}", "default",
                                            f"cq-{i}"))
    fill = n_cqs * nominal * 8 // (10 * 1000)
    for i in range(fill):
        eng.clock += 0.001
        eng.submit(t.Workload(
            name=f"low-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            priority=0,
            pod_sets=(t.PodSet("main", 1, {"cpu": 1000}),)))
    kit.attach(eng)
    if on_attach is not None:
        on_attach(eng)
    _drain_engine(eng, on_cycle=on_cycle)
    for i in range(n_pending):
        eng.clock += 0.001
        eng.submit(t.Workload(
            name=f"high-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            priority=rng.choice([10, 50]),
            pod_sets=(t.PodSet("main", 1,
                               {"cpu": rng.choice([1000, 2000])}),)))
    return eng


def multiflavor_engine(rng: random.Random, n_cqs=3, try_next=False,
                       kit=None):
    """``tests/test_multiflavor_preempt_device.py``'s world: ClusterQueues
    over two or three of three flavors, within-CQ preemption and a
    random reclaim policy, whenCanPreempt Preempt (or TryNextFlavor),
    oracle attached."""
    kit = kit or port_kit()
    t = kit.types
    when_can_preempt = (t.FungibilityPolicy.TRY_NEXT_FLAVOR if try_next
                        else t.FungibilityPolicy.PREEMPT)
    eng = kit.engine()
    for f in ("on-demand", "spot", "reserved"):
        eng.create_resource_flavor(t.ResourceFlavor(f))
    eng.create_cohort(t.Cohort("co"))
    for i in range(n_cqs):
        flavors = tuple(
            t.FlavorQuotas(f, {"cpu": t.ResourceQuota(
                rng.choice([1000, 2000, 4000]))})
            for f in rng.sample(["on-demand", "spot", "reserved"],
                                rng.choice([2, 3])))
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", cohort="co",
            preemption=t.ClusterQueuePreemption(
                within_cluster_queue=t.PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=rng.choice(
                    [t.PreemptionPolicy.NEVER, t.PreemptionPolicy.ANY,
                     t.PreemptionPolicy.LOWER_PRIORITY])),
            flavor_fungibility=t.FlavorFungibility(
                when_can_preempt=when_can_preempt),
            resource_groups=(t.ResourceGroup(("cpu",), flavors),)))
        eng.create_local_queue(t.LocalQueue(f"lq{i}", "default",
                                            f"cq{i}"))
    kit.attach(eng)
    return eng


def multiflavor_churn(eng, rng: random.Random, kit=None, n=30,
                      on_cycle=None):
    """The test's churn: submissions with random cycles and finishes in
    between, then cycles until one neither admits nor preempts."""
    t = (kit or port_kit()).types
    names = []
    for i in range(n):
        eng.clock += 0.5
        wl = t.Workload(
            name=f"w{i}", queue_name=f"lq{rng.randrange(3)}",
            priority=rng.choice([0, 2, 5, 9]),
            pod_sets=(t.PodSet("main", 1,
                             {"cpu": rng.choice([500, 900, 1500,
                                                 2500])}),))
        eng.submit(wl)
        names.append(wl.name)
        if rng.random() < 0.4:
            r = eng.schedule_once()
            if on_cycle is not None:
                on_cycle(r)
        if rng.random() < 0.2:
            admitted = [k for k, x in eng.workloads.items()
                        if x.is_admitted]
            if admitted:
                eng.finish(rng.choice(admitted))
    for _ in range(120):
        r = eng.schedule_once()
        if on_cycle is not None:
            on_cycle(r)
        if r is None or (not r.assumed and not any(
                e.preemption_targets for e in r.entries)):
            break
        eng.tick(0.0)
    return names


def decision_stream(result) -> bytes:
    """One cycle's decisions, serialised: every entry in order (workload
    key, ClusterQueue, status, requeue reason and message, flavor per pod
    set and resource, the
    preemption targets with their reasons), the inadmissible entries and
    the cycle stats. ``b"idle"`` for an idle cycle. Works on either
    package's CycleResult."""
    if result is None:
        return b"idle"
    rows = []
    for e in result.entries:
        flavors = ()
        if e.assignment is not None and e.status.value in (
                "assumed", "preempting"):
            flavors = tuple(
                (psa.name, tuple(sorted(
                    (res, getattr(fa, "name", fa))
                    for res, fa in psa.flavors.items())))
                for psa in e.assignment.pod_sets)
        rows.append(("E", e.obj.key, e.info.cluster_queue, e.status.value,
                     e.requeue_reason.value, e.inadmissible_msg,
                     flavors, tuple(sorted(
                         (t.workload.key, t.reason)
                         for t in e.preemption_targets))))
    for e in result.inadmissible:
        rows.append(("I", e.obj.key, e.info.cluster_queue))
    st = result.stats
    rows.append(("S", st.admitted, st.preempting, st.skipped,
                 st.inadmissible, tuple(sorted(st.preemption_skips.items()))))
    return repr(rows).encode()


# The engine runs of chip_smoke.py phases 10-13: bench.py's
# cycle_latency (1,000 ClusterQueues x 50,000 workloads) and
# fair_cycle_latency (500 ClusterQueues x 20,000 workloads) at full size,
# 1 untimed and then 8 (6) timed cycles; bench_preempt_churn's world
# (100 ClusterQueues, 4,000 pending) drained; the multi-flavor
# preemption worlds of tests/test_multiflavor_preempt_device.py (8
# Preempt and 4 TryNextFlavor seeds), each on the serial loop with the
# columnar apply (``arm``, the loop its JAX constants came from).
# QUARTER holds the smaller twins the CPU tests run against the JAX
# engine. DEFAULT_ARM holds the runs of chip_smoke.py phases 22 and 23:
# cycle_latency and preempt_churn at full width on both packages'
# default loop (the speculation pipeline and the columnar apply).
# OTHER_ARMS holds phases 24 and 25, the two arms with the per-entry
# assume: cycle_latency on the serial loop (its apply against phase
# 10's columnar one) and preempt_churn on the speculation pipeline.
FULL = {
    "cycle_latency": dict(kind="cycles", scenario="baseline_like",
                          kw=dict(n_cohorts=200, cqs_per_cohort=5,
                                  n_workloads=50_000),
                          fair=False, cycles=8, arm="columnar"),
    "fair_cycle_latency": dict(kind="cycles", scenario="hierarchical_fair",
                               kw=dict(n_workloads=20_000), fair=True,
                               cycles=6, arm="columnar"),
    "preempt_churn": dict(kind="churn", n_pending=4_000, n_cohorts=20,
                          arm="columnar"),
    "multiflavor": dict(kind="multiflavor", preempt_seeds=8,
                        try_next_seeds=4, arm="columnar"),
}
DEFAULT_ARM = {name: dict(FULL[name], arm="full")
               for name in ("cycle_latency", "preempt_churn")}
OTHER_ARMS = {
    "cycle_latency_serial": dict(FULL["cycle_latency"], arm="serial"),
    "preempt_churn_pipelined": dict(FULL["preempt_churn"], arm="pipelined"),
}
QUARTER = {
    "cycle_latency": dict(FULL["cycle_latency"],
                          kw=dict(n_cohorts=50, cqs_per_cohort=5,
                                  n_workloads=12_500), cycles=4),
    "fair_cycle_latency": dict(FULL["fair_cycle_latency"],
                               kw=dict(n_roots=13, n_workloads=5_000),
                               cycles=3),
    "preempt_churn": dict(FULL["preempt_churn"], n_pending=100,
                          n_cohorts=2),
    "multiflavor": dict(FULL["multiflavor"], preempt_seeds=1,
                        try_next_seeds=0),
}
# The numbers a run must reproduce (against the JAX engine's).
PINNED = ("cycles", "admitted", "preempting", "preemptions", "checksum",
          "on_device", "hybrid", "fallback", "overridden")


SPAN = "engine_worlds.schedule_once"


def arm_pinned(r: dict) -> dict:
    """What a run on a chosen loop arm (DEFAULT_ARM, OTHER_ARMS) must
    reproduce: its PINNED numbers, its evictions and its
    pipeline_stats."""
    got = {k: r[k] for k in PINNED}
    got["evicted"] = sum(1 for eng in r["engines"] for e in eng.events
                         if e.kind == "Evicted")
    got["pipeline_stats"] = r["pipeline_stats"]
    return got


def _instrument(eng, out):
    """Count the cycles whose device call carries the sim nomination's
    slot overrides, count and time every schedule_once (``calls``,
    ``engine_s``), record the bridge's ``pipeline_stats`` after each
    (``pipeline``), and record the wall seconds and phases of each while
    ``out["timing"]`` is set. Each schedule_once is a profiler range
    named ``SPAN``."""
    from torch.profiler import record_function

    ex = eng.oracle.executor
    inner_step = ex.cycle_step
    inner_once = eng.schedule_once

    def cycle_step(tensors, statics):
        if "slot_kind_override" in tensors:
            out["overridden"] += 1
        return inner_step(tensors, statics)

    def schedule_once():
        with record_function(SPAN):
            t0 = time.perf_counter()
            r = inner_once()
            dt = time.perf_counter() - t0
        out["calls"] += 1
        out["engine_s"] += dt
        out["pipeline"].append(dict(eng.oracle.pipeline_stats))
        if out["timing"]:
            out["cycle_seconds"].append(dt)
            out["phases"].append(dict(eng.last_cycle_phases))
        return r

    ex.cycle_step = cycle_step
    eng.schedule_once = schedule_once


def run(config: dict, kit=None, obs=None) -> dict:
    """Drive one engine run of ``config`` (an entry of FULL, QUARTER,
    DEFAULT_ARM or OTHER_ARMS) on its loop arm (``config["arm"]``, see
    loop_arm). ``obs(engine)``, for a ``cycles`` run, returns a context
    manager that the run's cycles go inside, entered once the world is
    built and its oracle attached (bench/obs_worlds.py attaches the obs
    layer there). Returns the PINNED numbers (cycles that decided something,
    admitted and preempting entries, preemptions issued, the crc32 of every
    cycle's decision stream, the bridge's device / hybrid / fallback
    cycles, cycles with slot overrides), ``pipeline_stats`` (summed over
    the run's engines) and ``pipeline`` (the bridge's after each
    schedule_once), plus ``cycle_seconds`` and
    ``phases`` (wall seconds and ``last_cycle_phases`` of each timed
    cycle: all but the first of a cycle run, the wave's of the churn,
    every one of the multi-flavor worlds), ``calls`` and ``engine_s``
    (every schedule_once and their wall seconds) and ``engines``."""
    if obs is not None and config["kind"] != "cycles":
        raise ValueError("obs= applies to a cycles run")
    with loop_arm(config.get("arm")):
        return _run(config, kit or port_kit(), obs)


def _run(config: dict, kit, obs=None) -> dict:
    out = dict.fromkeys(PINNED, 0)
    out.update(cycle_seconds=[], phases=[], timing=False, calls=0,
               engine_s=0.0, pipeline=[], pipeline_stats={})

    def on_cycle(r):
        out["checksum"] = zlib.crc32(decision_stream(r), out["checksum"])
        if r is not None:
            out["cycles"] += 1
            out["admitted"] += r.stats.admitted
            out["preempting"] += r.stats.preempting

    kind = config["kind"]
    if kind == "cycles":
        scen = getattr(kit.scenario, config["scenario"])(**config["kw"])
        eng = build_cycle_engine(scen, fair=config["fair"], kit=kit)
        _instrument(eng, out)
        engines = [eng]
        eng.apply_serving_gc_posture()
        try:
            with obs(eng) if obs is not None else nullcontext():
                for k in range(config["cycles"] + 1):
                    out["timing"] = k > 0  # the first encodes every row
                    r = eng.schedule_once()
                    on_cycle(r)
                    if r is None or not r.stats.admitted:
                        break
        finally:
            gc.enable()
            gc.unfreeze()
    elif kind == "churn":
        eng = preempt_churn_engine(
            config["n_pending"], n_cohorts=config["n_cohorts"], kit=kit,
            on_cycle=on_cycle, on_attach=lambda e: _instrument(e, out))
        engines = [eng]
        out["timing"] = True
        _drain_engine(eng, on_cycle=on_cycle)
    else:
        engines = []
        out["timing"] = True
        cases = ([(s, False) for s in range(config["preempt_seeds"])]
                 + [(s, True) for s in range(config["try_next_seeds"])])
        for seed, try_next in cases:
            eng = multiflavor_engine(
                random.Random((2000 if try_next else 1000) + seed),
                try_next=try_next, kit=kit)
            _instrument(eng, out)
            engines.append(eng)
            multiflavor_churn(eng, random.Random(seed), kit=kit,
                              on_cycle=on_cycle)
    out["timing"] = False
    for eng in engines:
        b = eng.oracle
        out["on_device"] += b.cycles_on_device
        out["hybrid"] += b.cycles_hybrid
        out["fallback"] += b.cycles_fallback
        out["preemptions"] += eng.metrics.preemptions_total
        for k, v in b.pipeline_stats.items():
            out["pipeline_stats"][k] = out["pipeline_stats"].get(k, 0) + v
    out["engines"] = engines
    return out
