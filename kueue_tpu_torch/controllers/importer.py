"""Importer: adopt pre-existing running workloads as admitted.

The port of ``kueue_tpu/controllers/importer.py``, with what it does
alike: ``check`` records a workload as imported even after it records an
error for it, and ``import_workloads`` writes no journal record (the
adopted workloads enter the engine's maps and cache directly).
Reference: cmd/importer — mapping rules (mapping/mapping.go:48 Rule:
match pods by priorityClassName + labels -> LocalQueue, first match
wins, unmatched skip), check phase (validate queue mapping and flavor
assignment), import phase (create admitted Workloads without scheduling
them, admitWorkload pod/import.go:173)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.types import (
    Admission,
    FlavorResource,
    PodSet,
    PodSetAssignmentStatus,
    Workload,
    WorkloadConditionType,
)


@dataclass
class MappingRule:
    """mapping.go:48 (Rule): labels + optional priority class ->
    LocalQueue; ``skip`` short-circuits (explicitly unmanaged pods)."""

    to_local_queue: str = ""
    match_labels: dict[str, str] = field(default_factory=dict)
    priority_class_name: str = ""
    skip: bool = False

    def matches(self, priority_class: str,
                labels: dict[str, str]) -> bool:
        if self.priority_class_name \
                and priority_class != self.priority_class_name:
            return False
        return all(labels.get(k) == v
                   for k, v in self.match_labels.items())


@dataclass
class MappingRules:
    """mapping.go:54 (Rules): ordered, first match wins."""

    rules: tuple[MappingRule, ...] = ()

    def queue_for(self, priority_class: str, labels: dict[str, str]
                  ) -> tuple[Optional[str], bool]:
        """Returns (queue name, matched); (None, True) = matched a skip
        rule (:56 QueueFor)."""
        for rule in self.rules:
            if rule.matches(priority_class, labels):
                return (None, True) if rule.skip \
                    else (rule.to_local_queue, True)
        return None, False

    @classmethod
    def for_label(cls, label: str) -> "MappingRules":
        """RulesForLabel (:78): the value of ``label`` IS the queue."""
        return cls(rules=(MappingRule(to_local_queue=f"${{{label}}}"),))


@dataclass
class PodToImport:
    """The pod-shaped input of the importer (cmd/importer/pod)."""

    name: str
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    priority_class_name: str = ""
    priority: int = 0
    requests: dict[str, int] = field(default_factory=dict)


def pods_to_workloads(pods: list[PodToImport], rules: MappingRules,
                      queue_label: Optional[str] = None
                      ) -> tuple[list[Workload], list[str]]:
    """The mapping pass: each managed pod becomes a one-pod Workload in
    its mapped LocalQueue; unmatched/skipped pods are reported."""
    out: list[Workload] = []
    skipped: list[str] = []
    for pod in pods:
        queue, matched = rules.queue_for(pod.priority_class_name,
                                         pod.labels)
        if matched and queue is not None and queue.startswith("${"):
            # RulesForLabel indirection: ${label-name}.
            queue = pod.labels.get(queue[2:-1])
        if not matched or queue is None:
            skipped.append(f"{pod.namespace}/{pod.name}")
            continue
        out.append(Workload(
            name=pod.name, namespace=pod.namespace, queue_name=queue,
            priority=pod.priority,
            priority_class_name=pod.priority_class_name or None,
            pod_sets=(PodSet("main", 1, dict(pod.requests)),)))
    return out, skipped


@dataclass
class ImportResult:
    imported: list[str] = field(default_factory=list)
    errors: dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors


def check(engine, workloads: list[Workload],
          flavor_mapping: dict[str, str]) -> ImportResult:
    """The dry-run check phase."""
    result = ImportResult()
    for wl in workloads:
        lq = engine.queues.local_queues.get(
            f"{wl.namespace}/{wl.queue_name}")
        if lq is None:
            result.errors[wl.key] = (
                f"no LocalQueue {wl.queue_name} in {wl.namespace}")
            continue
        cq = engine.cache.cluster_queues.get(lq.cluster_queue)
        if cq is None:
            result.errors[wl.key] = (
                f"LocalQueue {lq.name} points to missing ClusterQueue")
            continue
        for ps in wl.pod_sets:
            for res in ps.requests:
                flavor = flavor_mapping.get(res)
                if flavor is None:
                    result.errors[wl.key] = f"no flavor mapping for {res}"
                    break
                if cq.quota_for(FlavorResource(flavor, res)).nominal == 0 \
                        and not any(
                            fq.name == flavor
                            for rg in cq.resource_groups
                            for fq in rg.flavors):
                    result.errors[wl.key] = (
                        f"flavor {flavor} not in ClusterQueue "
                        f"{cq.name}")
                    break
        result.imported.append(wl.key)
    return result


def import_workloads(engine, workloads: list[Workload],
                     flavor_mapping: dict[str, str]) -> ImportResult:
    """The import phase: admit directly (bypassing scheduling), matching
    the reference's adoption of already-running pods."""
    precheck = check(engine, workloads, flavor_mapping)
    if not precheck.ok:
        return precheck
    result = ImportResult()
    for wl in workloads:
        lq = engine.queues.local_queues[f"{wl.namespace}/{wl.queue_name}"]
        psas = []
        for ps in wl.pod_sets:
            flavors = {res: flavor_mapping[res] for res in ps.requests}
            usage = {res: q * ps.count for res, q in ps.requests.items()}
            psas.append(PodSetAssignmentStatus(
                name=ps.name, flavors=flavors, resource_usage=usage,
                count=ps.count))
        wl.status.admission = Admission(
            cluster_queue=lq.cluster_queue,
            pod_set_assignments=tuple(psas))
        wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, True,
                         reason="Imported", now=engine.clock)
        wl.set_condition(WorkloadConditionType.ADMITTED, True,
                         reason="Imported", now=engine.clock)
        engine.workloads[wl.key] = wl
        engine.cache.add_or_update_workload(wl)
        result.imported.append(wl.key)
    return result
