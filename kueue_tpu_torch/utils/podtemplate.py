"""Pod template resource model and the pod-requests calculation.

The port of ``kueue_tpu/utils/podtemplate.py``, unchanged.

The reference takes each PodSet's full pod template and derives the
per-pod effective requests with the upstream scheduler algorithm
(pkg/resources/requests.go:61 NewRequestsFromPodSpec, which delegates to
k8s.io/component-helpers/resource PodRequests): per resource,

    total = max(sum(app containers) + sum(restartable init containers),
                running-max over init containers)  + pod overhead,

optionally overridden by pod-level resources, and adjusted beforehand by
RuntimeClass overhead, LimitRange defaults and limits-as-missing-requests
(pkg/workload/resources.go:141 AdjustResources).

Quantities are plain ints (milli-units for cpu by repo convention).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def merge_keep_first(dst: dict[str, int],
                     src: dict[str, int]) -> dict[str, int]:
    """pkg/util/resource/resource.go:46 MergeResourceListKeepFirst."""
    out = dict(src)
    out.update(dst)
    return out


def merge_keep_max(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, v), v)
    return out


def merge_keep_min(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    out = dict(a)
    for k, v in b.items():
        out[k] = min(out.get(k, v), v)
    return out


@dataclass
class ContainerSpec:
    """One container's resource stanza (corev1.Container.Resources)."""

    name: str = ""
    requests: dict[str, int] = field(default_factory=dict)
    limits: dict[str, int] = field(default_factory=dict)
    # Init containers with restartPolicy=Always are sidecars: they run for
    # the pod's whole lifetime and add to, rather than precede, the app
    # containers' requests.
    restart_always: bool = False


@dataclass
class PodTemplate:
    """The resource-bearing slice of a PodSet's pod template spec."""

    containers: list[ContainerSpec] = field(default_factory=list)
    init_containers: list[ContainerSpec] = field(default_factory=list)
    # RuntimeClass overhead (nodev1.RuntimeClass.Overhead.PodFixed); either
    # set directly or resolved from runtime_class_name at adjust time.
    overhead: dict[str, int] = field(default_factory=dict)
    runtime_class_name: Optional[str] = None
    # Pod-level resources (KEP-2837): when set, override the aggregated
    # container values for the resources they name.
    pod_requests: Optional[dict[str, int]] = None
    pod_limits: Optional[dict[str, int]] = None


def use_limits_as_missing_requests(template: PodTemplate) -> None:
    """pkg/workload/resources.go:127 UseLimitsAsMissingRequestsInPod."""
    for c in template.init_containers + template.containers:
        c.requests = merge_keep_first(c.requests, c.limits)
    if template.pod_limits is not None:
        template.pod_requests = merge_keep_first(
            template.pod_requests or {}, template.pod_limits)


def pod_requests(template: PodTemplate) -> dict[str, int]:
    """Effective per-pod requests (component-helpers PodRequests)."""
    names: set[str] = set()
    for c in template.containers + template.init_containers:
        names |= set(c.requests)
    if template.pod_requests:
        names |= set(template.pod_requests)
    names |= set(template.overhead)

    out: dict[str, int] = {}
    for res in names:
        app = sum(c.requests.get(res, 0) for c in template.containers)
        sidecars = 0
        init_max = 0
        for c in template.init_containers:
            if c.restart_always:
                sidecars += c.requests.get(res, 0)
                init_max = max(init_max, sidecars)
            else:
                init_max = max(init_max,
                               sidecars + c.requests.get(res, 0))
        total = max(app + sidecars, init_max)
        if template.pod_requests is not None \
                and res in template.pod_requests:
            total = template.pod_requests[res]
        total += template.overhead.get(res, 0)
        if total:
            out[res] = total
    return out


def validate_requests_under_limits(template: PodTemplate) -> list[str]:
    """pkg/workload/resources.go:178 ValidateResources: per container (and
    pod level), requests must not exceed limits."""
    errs = []
    for c in template.init_containers + template.containers:
        over = [r for r, q in c.requests.items()
                if r in c.limits and q > c.limits[r]]
        if over:
            errs.append(f"container {c.name or '?'}: requests exceed "
                        f"limits for {sorted(over)}")
    if template.pod_requests is not None and template.pod_limits is not None:
        over = [r for r, q in template.pod_requests.items()
                if r in template.pod_limits and q > template.pod_limits[r]]
        if over:
            errs.append(f"pod resources: requests exceed limits "
                        f"for {sorted(over)}")
    return errs
