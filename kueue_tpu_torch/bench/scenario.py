"""Benchmark scenario generation, copied from ``kueue_tpu/bench/scenario.py``
so that the same seed gives the same scenario in both packages: cohorts x
ClusterQueues with borrowing, and a pending workload population in
small/medium/large classes.

The baseline-like scenario mirrors the shape of the reference baseline
(5 cohorts x 6 CQs, 15k workloads in 3 size classes) scaled up to the
north-star size (1k CQs, 50k workloads)."""

from __future__ import annotations

import random
from dataclasses import dataclass

from kueue_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_tpu_torch.workload_info import WorkloadInfo

CPU = "cpu"

@dataclass
class Scenario:
    cluster_queues: list
    cohorts: list
    flavors: list
    local_queues: list
    workloads: list  # api Workloads (pending)

    def pending_infos(self):
        lq_to_cq = {lq.name: lq.cluster_queue for lq in self.local_queues}
        return [WorkloadInfo.from_workload(w, lq_to_cq[w.queue_name])
                for w in self.workloads]


def baseline_like(n_cohorts: int = 200, cqs_per_cohort: int = 5,
                  n_workloads: int = 50_000, nominal_per_cq: int = 5_000,
                  seed: int = 0, sized_to_fit: bool = True) -> Scenario:
    """5-cohorts-x-6-CQs shape scaled: each CQ has nominal quota and can
    borrow within its cohort; workloads come in 1/5/20-unit classes
    (reference baseline generator.yaml:4-33).

    With ``sized_to_fit`` the total demand stays within total capacity so
    a drain admits everything (pure decision-throughput measurement).
    """
    rng = random.Random(seed)
    n_cqs = n_cohorts * cqs_per_cohort
    cohorts = [Cohort(f"cohort-{i}") for i in range(n_cohorts)]
    flavors = [ResourceFlavor("default")]

    # Size classes in milli-units: small=1, medium=5, large=20 units
    # (reference baseline generator.yaml class mix).
    classes = [(1000, 0.70), (5000, 0.20), (20000, 0.10)]
    sizes = []
    for _ in range(n_workloads):
        r = rng.random()
        acc = 0.0
        size = classes[-1][0]
        for sz, frac in classes:
            acc += frac
            if r < acc:
                size = sz
                break
        sizes.append(size)
    if sized_to_fit:
        # Capacity sized so the cohort-borrowing drain can admit ~all of
        # the population (slack for uneven per-cohort demand).
        nominal_per_cq = max(nominal_per_cq,
                             int(sum(sizes) / (n_cqs * 0.85)) + 1)

    cqs, lqs = [], []
    for i in range(n_cqs):
        name = f"cq-{i}"
        cqs.append(ClusterQueue(
            name=name, cohort=f"cohort-{i % n_cohorts}",
            resource_groups=(ResourceGroup(
                (CPU,),
                (FlavorQuotas("default",
                              {CPU: ResourceQuota(nominal_per_cq)}),)),),
        ))
        lqs.append(LocalQueue(f"lq-{i}", "default", name))

    workloads = [
        Workload(
            name=f"wl-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            priority=rng.choice([0, 0, 0, 50, 100]),
            creation_time=float(i),
            pod_sets=(PodSet("main", 1, {CPU: size}),))
        for i, size in enumerate(sizes)
    ]
    return Scenario(cqs, cohorts, flavors, lqs, workloads)


def hierarchical_fair(n_roots: int = 50, mids_per_root: int = 2,
                      cqs_per_mid: int = 5, n_workloads: int = 20_000,
                      nominal_per_cq: int = 4_000, seed: int = 1,
                      oversubscribe: float = 1.5) -> Scenario:
    """BASELINE.json config 3: 3-level cohort tree (root -> mid -> CQs)
    with fair-sharing weights at every level and demand oversubscribed so
    the DRS tournament ordering decides who gets capacity.

    Workload sizes scale to the tree's capacity so the scenario really
    contains ``n_workloads`` workloads (the round-2 form silently capped
    the count at the capacity budget — a 674-workload 13 ms "bench")."""
    from kueue_tpu_torch.api.types import FairSharing

    rng = random.Random(seed)
    cohorts, cqs, lqs = [], [], []
    ci = 0
    for r in range(n_roots):
        cohorts.append(Cohort(
            f"root-{r}", resource_groups=(ResourceGroup(
                (CPU,), (FlavorQuotas("default",
                                      {CPU: ResourceQuota(
                                          nominal_per_cq * 2)}),)),)))
        for m in range(mids_per_root):
            cohorts.append(Cohort(
                f"mid-{r}-{m}", parent=f"root-{r}",
                fair_sharing=FairSharing(
                    weight=rng.choice([0.5, 1.0, 2.0]))))
            for _ in range(cqs_per_mid):
                name = f"cq-{ci}"
                cqs.append(ClusterQueue(
                    name=name, cohort=f"mid-{r}-{m}",
                    fair_sharing=FairSharing(
                        weight=rng.choice([0.5, 1.0, 1.0, 2.0])),
                    resource_groups=(ResourceGroup(
                        (CPU,),
                        (FlavorQuotas("default",
                                      {CPU: ResourceQuota(
                                          nominal_per_cq)}),)),)))
                lqs.append(LocalQueue(f"lq-{ci}", "default", name))
                ci += 1
    n_cqs = ci
    capacity = n_roots * nominal_per_cq * 2 \
        + n_cqs * nominal_per_cq
    budget = int(capacity * oversubscribe)
    avg = max(1, budget // n_workloads)
    sizes = [max(1, avg // 2), avg, avg * 2]
    workloads = []
    for i in range(n_workloads):
        workloads.append(Workload(
            name=f"wl-{i}", queue_name=f"lq-{rng.randrange(n_cqs)}",
            priority=rng.choice([0, 0, 10]), creation_time=float(i),
            pod_sets=(PodSet("main", 1, {CPU: rng.choice(sizes)}),)))
    return Scenario(cqs, cohorts, [ResourceFlavor("default")], lqs,
                    workloads)
