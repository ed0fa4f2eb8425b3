"""LimitRange summarization, defaulting, and validation.

The port of ``kueue_tpu/utils/limitrange.py``, unchanged.

Reference: pkg/util/limitrange/limitrange.go (Summarize, ValidatePodSpec)
and pkg/workload/resources.go:78 (handlePodLimitRange — defaulting).
All per-namespace LimitRanges are folded into one Summary per limit type:
lowest Max, highest Min, first-seen Default/DefaultRequest.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_tpu_torch.utils.podtemplate import (
    PodTemplate,
    merge_keep_first,
    merge_keep_max,
    merge_keep_min,
    pod_requests,
)

LIMIT_TYPE_POD = "Pod"
LIMIT_TYPE_CONTAINER = "Container"


@dataclass
class LimitRangeItem:
    """corev1.LimitRangeItem."""

    type: str = LIMIT_TYPE_CONTAINER
    max: dict[str, int] = field(default_factory=dict)
    min: dict[str, int] = field(default_factory=dict)
    default: dict[str, int] = field(default_factory=dict)  # default limits
    default_request: dict[str, int] = field(default_factory=dict)


@dataclass
class LimitRange:
    """corev1.LimitRange (namespaced)."""

    name: str
    namespace: str = "default"
    limits: tuple[LimitRangeItem, ...] = ()


def summarize(ranges: list[LimitRange]) -> dict[str, LimitRangeItem]:
    """limitrange.go:38 Summarize: per limit type keep the lowest Max,
    highest Min, first-seen Default/DefaultRequest."""
    out: dict[str, LimitRangeItem] = {}
    for lr in ranges:
        for item in lr.limits:
            acc = out.setdefault(item.type, LimitRangeItem(type=item.type))
            acc.max = merge_keep_min(acc.max, item.max)
            acc.min = merge_keep_max(acc.min, item.min)
            acc.default = merge_keep_first(acc.default, item.default)
            acc.default_request = merge_keep_first(
                acc.default_request, item.default_request)
    return out


def apply_defaults(template: PodTemplate,
                   summary: dict[str, LimitRangeItem]) -> None:
    """resources.go:78 handlePodLimitRange: merge the Container-type
    Default into each container's limits and DefaultRequest into its
    requests (keep-first), Pod-type into pod-level resources."""
    citem = summary.get(LIMIT_TYPE_CONTAINER)
    if citem is not None:
        for c in template.init_containers + template.containers:
            c.limits = merge_keep_first(c.limits, citem.default)
            c.requests = merge_keep_first(c.requests, citem.default_request)
    pitem = summary.get(LIMIT_TYPE_POD)
    if pitem is not None and template.pod_requests is not None:
        template.pod_limits = merge_keep_first(
            template.pod_limits or {}, pitem.default)
        template.pod_requests = merge_keep_first(
            template.pod_requests, pitem.default_request)


def validate_template(template: PodTemplate,
                      summary: dict[str, LimitRangeItem]) -> list[str]:
    """limitrange.go:85 ValidatePodSpec: containers against the Container
    bounds (using max(requests, limits) vs Max and min(requests, limits)
    vs Min, as the reference does), the whole pod against the Pod bounds."""
    errs: list[str] = []
    citem = summary.get(LIMIT_TYPE_CONTAINER)
    if citem is not None:
        for c in template.init_containers + template.containers:
            hi = merge_keep_max(c.requests, c.limits)
            lo = merge_keep_min(c.requests, c.limits)
            above = [r for r, q in hi.items()
                     if r in citem.max and q > citem.max[r]]
            below = [r for r, q in citem.min.items()
                     if lo.get(r, 0) < q]
            if above:
                errs.append(f"container {c.name or '?'}: requests above "
                            f"limitRange max for {sorted(above)}")
            if below:
                errs.append(f"container {c.name or '?'}: requests below "
                            f"limitRange min for {sorted(below)}")
    pitem = summary.get(LIMIT_TYPE_POD)
    if pitem is not None:
        total = pod_requests(template)
        above = [r for r, q in total.items()
                 if r in pitem.max and q > pitem.max[r]]
        below = [r for r, q in pitem.min.items() if total.get(r, 0) < q]
        if above:
            errs.append(f"pod: requests above limitRange max "
                        f"for {sorted(above)}")
        if below:
            errs.append(f"pod: requests below limitRange min "
                        f"for {sorted(below)}")
    return errs
