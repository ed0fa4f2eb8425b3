"""Configuration API: the part of the manager's config schema the port
reads.

A trimmed copy of ``kueue_tpu/config/api.py``: admission fair sharing's
settings (apis/config/v1beta2/configuration_types.go
AdmissionFairSharing) and, of the manager's ``Configuration``, the job
integrations it enables (``integrations``), the resources section
(excluded prefixes and transformations, the engine's Info options), the
metrics' custom labels (``metrics.customLabels``) and the profiler
directory (``profileDir``), with the same field names and defaults.
``from_dict`` reads those keys of a config file's mapping."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


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
    """The part of the manager's Configuration the port reads:
    ``integrations`` (the job frameworks the manager enables),
    ``resources`` (the engine's Info options), ``metrics_custom_labels``,
    a list of ``metrics.registry.CustomLabelEntry``, and ``profile_dir``,
    where ``Engine.profiled`` writes its profiler trace when the caller
    names no directory."""

    integrations: tuple[str, ...] = ("batch/job",)
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
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


def from_dict(raw: dict) -> Configuration:
    """The Configuration of a config file's mapping (its camelCase keys,
    as ``kueue_tpu/config/api.py``'s ``from_dict`` reads them)."""
    from kueue_tpu_torch.metrics.registry import CustomLabelEntry

    cfg = Configuration()
    cfg.integrations = tuple(
        raw.get("integrations", {}).get("frameworks", cfg.integrations)
        if isinstance(raw.get("integrations"), dict)
        else raw.get("integrations", cfg.integrations))
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
    cfg.profile_dir = raw.get("profileDir")
    return cfg
