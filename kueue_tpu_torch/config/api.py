"""Configuration API: the manager's startup config file schema.

A copy of ``kueue_tpu/config/api.py`` (apis/config/v1beta2/
configuration_types.go:35 and pkg/config's load, validate and
defaults), with the same field names and defaults, trimmed to the
fields a ported path reads: no MultiKueue section
(``MultiKueueConfigSpec``), namespace, manageJobsWithoutQueueName,
feature gates or oracle settings. ``from_dict`` reads the kept fields'
camelCase keys as the JAX reader does, what it leaves unread included
(``waitForPodsReady``'s ``requeuingTimestamp``,
``admissionFairSharing``)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class WaitForPodsReady:
    """configuration_types.go (WaitForPodsReady)."""

    enable: bool = False
    timeout_seconds: int = 300
    block_admission: bool = False
    requeuing_backoff_base_seconds: int = 60
    requeuing_backoff_limit_count: Optional[int] = None
    requeuing_backoff_max_seconds: int = 3600
    # FIFO anchor for PodsReady-evicted workloads: "Eviction" (default)
    # or "Creation" (configuration_types.go RequeuingStrategy.Timestamp).
    requeuing_timestamp: str = "Eviction"


@dataclass
class FairSharingConfig:
    enable: bool = False
    preemption_strategies: tuple[str, ...] = (
        "LessThanOrEqualToFinalShare", "LessThanInitialShare")


@dataclass
class AdmissionFairSharingConfig:
    usage_half_life_seconds: int = 600
    usage_sampling_interval_seconds: int = 60
    resource_weights: dict[str, float] = field(default_factory=dict)


@dataclass
class ResourceTransformationSpec:
    """configuration_types.go:560 (ResourceTransformation)."""

    input: str = ""
    strategy: str = "Retain"  # Retain | Replace
    outputs: dict[str, float] = field(default_factory=dict)
    multiply_by: str = ""


@dataclass
class ResourcesConfig:
    """configuration_types.go:540 (Resources): resources excluded from
    quota accounting and input->output transformations."""

    exclude_resource_prefixes: tuple[str, ...] = ()
    transformations: tuple[ResourceTransformationSpec, ...] = ()


@dataclass
class Configuration:
    """configuration_types.go:35. The engine reads ``fair_sharing``,
    ``wait_for_pods_ready`` (its requeuing timestamp orders the pending
    heaps and the cycle), the retention durations (a StatusController
    with its sweep), the resources section (its Info options),
    ``metrics_custom_labels`` (``metrics.registry.CustomLabelEntry``s)
    and ``profile_dir``, where ``Engine.profiled`` writes its profiler
    trace when the caller names no directory."""

    integrations: tuple[str, ...] = ("batch/job",)
    wait_for_pods_ready: WaitForPodsReady = field(
        default_factory=WaitForPodsReady)
    fair_sharing: FairSharingConfig = field(
        default_factory=FairSharingConfig)
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    # objectRetentionPolicies.workloads (configuration_types.go:648),
    # durations in seconds; None = keep forever.
    retention_after_finished_seconds: Optional[float] = None
    retention_after_deactivated_seconds: Optional[float] = None
    metrics_custom_labels: list = field(default_factory=list)
    profile_dir: Optional[str] = None

    def info_options(self):
        """Build workload_info.InfoOptions from the resources section."""
        from kueue_tpu_torch.workload_info import (
            InfoOptions,
            ResourceTransformation,
        )

        return InfoOptions.from_transform_list(
            [ResourceTransformation(input=t.input, outputs=dict(t.outputs),
                                    strategy=t.strategy,
                                    multiply_by=t.multiply_by)
             for t in self.resources.transformations],
            excluded=self.resources.exclude_resource_prefixes)

    def validate(self) -> list[str]:
        """pkg/config/validation.go."""
        errs = []
        if self.wait_for_pods_ready.timeout_seconds <= 0:
            errs.append("waitForPodsReady.timeout must be > 0")
        if self.wait_for_pods_ready.requeuing_backoff_base_seconds < 1:
            errs.append("waitForPodsReady.requeuingBackoffBaseSeconds >= 1")
        for s in self.fair_sharing.preemption_strategies:
            if s not in ("LessThanOrEqualToFinalShare",
                         "LessThanInitialShare"):
                errs.append(f"unknown preemption strategy {s}")
        # pkg/config/validation.go:455 validateResourceTransformations.
        seen_inputs = set()
        for t in self.resources.transformations:
            if not t.input:
                errs.append("resource transformation needs an input")
            if t.input in seen_inputs:
                errs.append(f"duplicate transformation input {t.input}")
            seen_inputs.add(t.input)
            if t.strategy not in ("Retain", "Replace"):
                errs.append(f"unknown transformation strategy {t.strategy}")
        return errs


def load(path: str) -> Configuration:
    """pkg/config/config.go (Load): read, default, validate. A JSON
    file, or YAML where PyYAML is installed."""
    with open(path) as f:
        text = f.read()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        raw = yaml.safe_load(text)
    cfg = from_dict(raw or {})
    errs = cfg.validate()
    if errs:
        raise ValueError("invalid configuration: " + "; ".join(errs))
    return cfg


def _duration_seconds(value) -> Optional[float]:
    """Accepts a number of seconds or a Go-style duration string
    ("300s", "5m", "1h30m")."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    import re

    text = str(value)
    parts = re.findall(r"([\d.]+)(ms|h|m|s)", text)
    # An unparseable duration must not become 0 (instant deletion):
    # it reads as unset, the safe direction.
    if not parts or "".join(q + u for q, u in parts) != text:
        return None
    return sum(float(qty) * {"h": 3600.0, "m": 60.0, "s": 1.0,
                             "ms": 0.001}[unit]
               for qty, unit in parts)


def from_dict(raw: dict) -> Configuration:
    """The Configuration of a config file's mapping (its camelCase keys,
    as ``kueue_tpu/config/api.py``'s ``from_dict`` reads them)."""
    from kueue_tpu_torch.metrics.registry import CustomLabelEntry

    cfg = Configuration()
    cfg.integrations = tuple(
        raw.get("integrations", {}).get("frameworks", cfg.integrations)
        if isinstance(raw.get("integrations"), dict)
        else raw.get("integrations", cfg.integrations))
    w = raw.get("waitForPodsReady") or {}
    strategy = w.get("requeuingStrategy") or {}
    cfg.wait_for_pods_ready = WaitForPodsReady(
        enable=w.get("enable", False),
        timeout_seconds=w.get("timeout", 300),
        block_admission=w.get("blockAdmission", False),
        requeuing_backoff_base_seconds=strategy.get(
            "backoffBaseSeconds", 60),
        requeuing_backoff_limit_count=strategy.get("backoffLimitCount"),
        requeuing_backoff_max_seconds=strategy.get(
            "backoffMaxSeconds", 3600),
    )
    fs = raw.get("fairSharing") or {}
    cfg.fair_sharing = FairSharingConfig(
        enable=fs.get("enable", False),
        preemption_strategies=tuple(fs.get(
            "preemptionStrategies",
            FairSharingConfig().preemption_strategies)))
    res = raw.get("resources") or {}
    cfg.resources = ResourcesConfig(
        exclude_resource_prefixes=tuple(
            res.get("excludeResourcePrefixes", ())),
        transformations=tuple(
            ResourceTransformationSpec(
                input=t.get("input", ""),
                strategy=t.get("strategy", "Retain"),
                outputs={k: float(v)
                         for k, v in (t.get("outputs") or {}).items()},
                multiply_by=t.get("multiplyBy", ""))
            for t in res.get("transformations", ())))
    cfg.metrics_custom_labels = [
        CustomLabelEntry(
            name=e.get("name", ""),
            source_label_key=e.get("sourceLabelKey", ""),
            source_annotation_key=e.get("sourceAnnotationKey", ""))
        for e in (raw.get("metrics") or {}).get("customLabels", ())]
    ret = ((raw.get("objectRetentionPolicies") or {})
           .get("workloads") or {})
    cfg.retention_after_finished_seconds = _duration_seconds(
        ret.get("afterFinished"))
    cfg.retention_after_deactivated_seconds = _duration_seconds(
        ret.get("afterDeactivatedByKueue"))
    cfg.profile_dir = raw.get("profileDir")
    return cfg
