"""Configuration API: the part of the manager's config schema the port
reads.

A trimmed copy of ``kueue_tpu/config/api.py``: admission fair sharing's
settings (apis/config/v1beta2/configuration_types.go
AdmissionFairSharing) and, of the manager's ``Configuration``, the
metrics' custom labels (``metrics.customLabels``) and the profiler
directory (``profileDir``), with the same field names and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class AdmissionFairSharingConfig:
    usage_half_life_seconds: int = 600
    usage_sampling_interval_seconds: int = 60
    resource_weights: dict[str, float] = field(default_factory=dict)


@dataclass
class Configuration:
    """The part of the manager's Configuration the engine reads:
    ``metrics_custom_labels``, a list of
    ``metrics.registry.CustomLabelEntry``, and ``profile_dir``, where
    ``Engine.profiled`` writes its profiler trace when the caller names
    no directory."""

    metrics_custom_labels: list = field(default_factory=list)
    profile_dir: Optional[str] = None
