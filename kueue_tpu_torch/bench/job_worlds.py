"""The job world of ``chip_smoke.py`` phase 31: jobs and pod templates
at full width through the serving engine.

It starts from ``cycle_latency``'s world (``engine_worlds.FULL``,
``bench.py``'s ``baseline_like``: 200 cohorts x 5 = 1,000 ClusterQueues,
one ``default`` namespace, the ``cpu`` resource), whose 50,000 workloads
give each entry its LocalQueue, priority and size class. Entry ``i``
becomes:

* a ``BatchJob`` (``i % 5 < 3``, 60%): one pod of the entry's size, sent
  through ``JobWebhookRegistry`` and ``JobReconciler.create_job``. Every
  200th of them asks for partial admission with a minParallelism equal
  to its parallelism, which the webhook refuses (``JobRejected``);
* a ``Workload`` whose one pod set carries a ``PodTemplate`` (40%),
  given to ``Engine.submit``. Counting the templated entries ``t = 0, 1,
  ...``: an ``app`` container requests the size less 250 and a
  ``sidecar`` container names no cpu, so the LimitRange's default
  request (250) fills it in; ``t % 4 == 1`` sets pod-level limits only
  (KEP-2837 pod resources), which become the pod's requests;
  ``t % 10 == 3`` adds an init container of the size plus 500, larger
  than the containers' sum; ``t % 8 == 5`` names the RuntimeClass
  ``sandboxed`` (a cpu overhead of 100); ``t % 200 == 199`` asks one
  container for 32,000, above the LimitRange's container maximum of
  24,000, so the workload is registered inactive with ``Inadmissible``
  and never queued.

Before them, ``statefulsets`` ``StatefulSetJob``s (one pod of 1,000 at
priority 200, above every entry's, each on its own ClusterQueue, spread
evenly) go through the same webhook and reconciler, so the first cycle
admits them. The namespace holds one LimitRange (a container default
request of 250 cpu and a container maximum of 24,000) and the engine
one RuntimeClass.

The run: ``cycles`` cycles on the default loop (``arm="full"``), the
first untimed. After each cycle, every fifth BatchJob among the entries
the cycle admitted (in the cycle's entry order) succeeds: its
``succeeded`` is set to its parallelism and ``reconcile`` finishes its
workload, which frees its quota. Each StatefulSet admitted in a cycle
then scales to zero (``hold_workload`` through the reconciler: OnHold),
once, and back to one replica after the cycle two later
(``clear_hold``: HoldCleared; the job stops until its workload is
admitted again).

Workload names and uids come from process-wide counters in both
packages (the jobframework's ``_wl_suffix``, the API types'
``_uid_counter``): ``run`` starts both at fixed values (ROADMAP trap
(a)) and restores them after. Each function takes a ``Kit``
(``engine_worlds.Kit``); the port's is the default, and the tests pass
the JAX package's to compute the same run there.
"""

from __future__ import annotations

import gc
import itertools
import time
import zlib
from contextlib import contextmanager

from kueue_tpu_torch.bench import engine_worlds as ew

FULL = {"jobs_world": dict(n_cohorts=200, cqs_per_cohort=5,
                           n_entries=50_000, statefulsets=50, cycles=9,
                           arm="full")}
# The small twin the CPU tests run against the JAX engine.
SMALL = {"jobs_world": dict(n_cohorts=10, cqs_per_cohort=5,
                            n_entries=2_500, statefulsets=10, cycles=3,
                            arm="full")}

UID_START = 70_000_001
LIMIT_MAX = 24_000
DEFAULT_REQUEST = 250
RUNTIME_CLASS = "sandboxed"
RUNTIME_OVERHEAD = 100
OVERSIZED = 32_000
STATEFULSET_PRIORITY = 200

# What a run must reproduce against the JAX engine: engine_worlds'
# PINNED numbers, the evictions and pipeline_stats (arm_pinned), and
# the job path's counts.
COUNTS = ("inadmissible", "job_rejected", "on_hold", "hold_cleared",
          "started", "succeeded")


@contextmanager
def pinned_counters(kit):
    """Start the API types' uid counter and the jobframework's workload
    name counter at fixed values for the block; restore both after."""
    t, jf = kit.types, kit.jobframework
    old = (t._uid_counter, jf._wl_suffix)
    t._uid_counter = itertools.count(UID_START)
    jf._wl_suffix = itertools.count(1)
    try:
        yield
    finally:
        t._uid_counter, jf._wl_suffix = old


def template(kit, t: int, size: int):
    """The pod template of the ``t``-th templated entry, of size
    ``size`` (see the module docstring)."""
    pt = kit.podtemplate
    if t % 200 == 199:
        return pt.PodTemplate(containers=[
            pt.ContainerSpec("app", {"cpu": OVERSIZED})])
    containers = [pt.ContainerSpec("app", {"cpu": size - DEFAULT_REQUEST}),
                  pt.ContainerSpec("sidecar")]
    tpl = pt.PodTemplate(containers=containers)
    if t % 4 == 1:
        containers[0].requests = {}
        tpl.pod_limits = {"cpu": size}
    if t % 10 == 3:
        tpl.init_containers = [pt.ContainerSpec("init", {"cpu": size + 500})]
    if t % 8 == 5:
        tpl.runtime_class_name = RUNTIME_CLASS
    return tpl


def build(config: dict, kit=None):
    """The world of ``config`` (an entry of FULL or SMALL), oracle
    attached. Returns ``(engine, reconciler, jobs, build_s)``, ``jobs``
    the registered StatefulSets and BatchJobs in creation order and
    ``build_s`` the seconds spent creating the entries."""
    kit = kit or ew.port_kit()
    t, jf, lr = kit.types, kit.jobframework, kit.limitrange
    n_cqs = config["n_cohorts"] * config["cqs_per_cohort"]
    scen = kit.scenario.baseline_like(
        n_cohorts=config["n_cohorts"],
        cqs_per_cohort=config["cqs_per_cohort"],
        n_workloads=config["n_entries"])
    eng = kit.engine(False)
    for rf in scen.flavors:
        eng.create_resource_flavor(rf)
    for co in scen.cohorts:
        eng.create_cohort(co)
    for cq in scen.cluster_queues:
        eng.create_cluster_queue(cq)
    for lq in scen.local_queues:
        eng.create_local_queue(lq)
    eng.create_limit_range(lr.LimitRange("defaults", "default", (
        lr.LimitRangeItem(lr.LIMIT_TYPE_CONTAINER, max={"cpu": LIMIT_MAX},
                          default_request={"cpu": DEFAULT_REQUEST}),)))
    eng.create_runtime_class(RUNTIME_CLASS, {"cpu": RUNTIME_OVERHEAD})
    rec = jf.JobReconciler(
        eng, webhooks=kit.webhooks.JobWebhookRegistry(eng))
    jobs = []
    t0 = time.perf_counter()
    n_sts = config["statefulsets"]
    for k in range(n_sts):
        eng.clock += 0.0001
        job = kit.integrations.StatefulSetJob(
            name=f"serve-{k}", queue_name=f"lq-{k * n_cqs // n_sts}",
            priority=STATEFULSET_PRIORITY, replicas=1,
            requests={"cpu": 1000})
        if not rec.create_job(job):
            jobs.append(job)
    n_jobs = n_templated = 0
    for i, w in enumerate(scen.workloads):
        eng.clock += 0.0001
        size = w.pod_sets[0].requests["cpu"]
        if i % 5 < 3:
            rejected = n_jobs % 200 == 199
            n_jobs += 1
            job = jf.BatchJob(
                name=f"job-{i}", queue_name=w.queue_name, parallelism=1,
                requests={"cpu": size}, priority=w.priority,
                min_parallelism=1 if rejected else None)
            if not rec.create_job(job):
                jobs.append(job)
        else:
            eng.submit(t.Workload(
                name=f"wl-{i}", queue_name=w.queue_name,
                priority=w.priority, pod_sets=(t.PodSet(
                    "main", 1, template=template(kit, n_templated, size)),)))
            n_templated += 1
    build_s = time.perf_counter() - t0
    kit.attach(eng)
    return eng, rec, jobs, build_s


def _between_cycles(k: int, r, rec, rescale: dict, held: set) -> int:
    """After cycle ``k``: every fifth BatchJob the cycle admitted
    succeeds, each StatefulSet it admitted for the first time scales to
    zero, and those held after cycle ``k - 2`` scale back up. Returns
    the jobs that succeeded."""
    admitted = [rec.jobs[j] for j in (
        rec.workload_to_job.get(e.obj.key) for e in r.entries
        if e.status.value == "assumed") if j in rec.jobs]
    succeeded = 0
    batch = [j for j in admitted if hasattr(j, "parallelism")]
    for job in batch[::5]:
        job.succeeded = job.parallelism
        rec.reconcile(job)
        succeeded += 1
    for job in admitted:
        if getattr(job, "hold_at_zero", False) and job.key not in held:
            held.add(job.key)
            job.scale(0)
            rec.reconcile(job)
            rescale[job.key] = k + 2
    for key, at in list(rescale.items()):
        if at == k:
            del rescale[key]
            job = rec.jobs[key]
            job.scale(1)
            rec.reconcile(job)
    return succeeded


def run(config: dict, kit=None, on_built=None, on_cycle=None) -> dict:
    """Build and drive the world of ``config`` on its loop arm.
    ``on_built(engine)`` runs once the world is built and its oracle
    attached (a test attaches a journal there); ``on_cycle(k, engine)``
    after cycle ``k``'s between-cycle steps. Returns engine_worlds'
    PINNED numbers, ``evicted``, ``pipeline_stats`` (the bridge's at the
    end) and ``pipeline`` (after each cycle), the COUNTS, ``build_s``,
    ``cycle_seconds`` and ``phases`` of every cycle but the first,
    ``calls``, ``engine_s`` and ``engines``."""
    kit = kit or ew.port_kit()
    with ew.loop_arm(config.get("arm")), pinned_counters(kit):
        return _run(config, kit, on_built, on_cycle)


def _run(config, kit, on_built, on_cycle) -> dict:
    out = dict.fromkeys(ew.PINNED, 0)
    out.update(cycle_seconds=[], phases=[], timing=False, calls=0,
               engine_s=0.0, pipeline=[], succeeded=0)
    eng, rec, jobs, out["build_s"] = build(config, kit)
    if on_built is not None:
        on_built(eng)
    ew._instrument(eng, out)
    eng.apply_serving_gc_posture()
    rescale: dict = {}
    held: set = set()
    try:
        for k in range(1, config["cycles"] + 1):
            out["timing"] = k > 1  # the first encodes every row
            r = eng.schedule_once()
            out["checksum"] = zlib.crc32(ew.decision_stream(r),
                                         out["checksum"])
            if r is not None:
                out["cycles"] += 1
                out["admitted"] += r.stats.admitted
                out["preempting"] += r.stats.preempting
                out["succeeded"] += _between_cycles(k, r, rec, rescale,
                                                    held)
            if on_cycle is not None:
                on_cycle(k, eng)
    finally:
        gc.enable()
        gc.unfreeze()
    out["timing"] = False
    b = eng.oracle
    out.update(on_device=b.cycles_on_device, hybrid=b.cycles_hybrid,
               fallback=b.cycles_fallback,
               preemptions=eng.metrics.preemptions_total,
               pipeline_stats=dict(b.pipeline_stats))
    kinds = [e.kind for e in eng.events]
    out["evicted"] = kinds.count("Evicted")
    for name, kind in (("inadmissible", "Inadmissible"),
                       ("job_rejected", "JobRejected"),
                       ("on_hold", "OnHold"),
                       ("hold_cleared", "HoldCleared")):
        out[name] = kinds.count(kind)
    out["started"] = sum(not j.is_suspended() for j in rec.jobs.values())
    out["engines"] = [eng]
    return out


def pinned(r: dict) -> dict:
    """What a run must reproduce against the JAX engine's: its PINNED
    numbers, evictions, pipeline_stats and COUNTS."""
    got = {k: r[k] for k in ew.PINNED}
    got.update(evicted=r["evicted"], pipeline_stats=r["pipeline_stats"])
    got.update({k: r[k] for k in COUNTS})
    return got
