"""Configuration API: the part of the manager's config schema the port
reads.

A trimmed copy of ``kueue_tpu/config/api.py``: admission fair sharing's
settings (apis/config/v1beta2/configuration_types.go
AdmissionFairSharing), with the same field names and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AdmissionFairSharingConfig:
    usage_half_life_seconds: int = 600
    usage_sampling_interval_seconds: int = 60
    resource_weights: dict[str, float] = field(default_factory=dict)
