"""MultiKueue cluster connectivity: remote clients with exponential
reconnect, kubeconfig hot-reload, and origin-labeled orphan GC.

The port of ``kueue_tpu/controllers/multikueue_cluster.py``; the
``MultiKueueClusterProfile`` gate is read from the port's
``config/features.py``.

Reference: pkg/controller/admissionchecks/multikueue/
multikueuecluster.go — the per-cluster client lifecycle (retryAfter
backoff :96-103, failedConnAttempts reset/bump :282-290, the Active
condition on the MultiKueueCluster object, runGC :608) — and
fswatch.go, which watches kubeconfig files so credential rotations
rebuild the client without a manager restart. The fsnotify watcher maps
to an mtime poll here (tick() is driven from the controller's reconcile
loop the way the watcher's events drive the reference's reconciler).

The transport is abstracted as ``connect(config) -> worker``: a
callable that builds a live worker handle from the kubeconfig's parsed
contents and raises on failure (bad endpoint, bad credential). Tests
and deployments provide it; the controller only manages the lifecycle.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Optional

# multikueuecluster.go:96 retryAfter: 0, then 2^(min(n, max)-1) * inc.
RETRY_MAX_STEPS = 7
DEFAULT_RETRY_INCREMENT = 1.0

# kueue.MultiKueueOriginLabel: marks remote objects created by this
# manager so runGC only collects its own orphans.
ORIGIN_LABEL = "kueue.x-k8s.io/multikueue-origin"


class _GateDisabled(RuntimeError):
    """ClusterProfile source used while MultiKueueClusterProfile is
    off."""


def retry_after(failed_attempts: int,
                increment: float = DEFAULT_RETRY_INCREMENT) -> float:
    """multikueuecluster.go:98 (retryAfter)."""
    if failed_attempts == 0:
        return 0.0
    return float(1 << (min(failed_attempts, RETRY_MAX_STEPS) - 1)) \
        * increment


@dataclass
class ClusterActive:
    """The MultiKueueCluster Active condition surface."""

    status: bool = False
    reason: str = "Pending"
    message: str = ""


@dataclass
class ClusterProfile:
    """cluster-inventory-api ClusterProfile, reduced to what the access
    provider consumes (multikueuecluster.go:716
    clusterProfileAccessProvider.BuildConfigFromCP)."""

    name: str
    config: dict = None
    generation: int = 0


class ClusterProfileRegistry:
    """The ClusterProfile object store + access provider: resolves a
    profile reference into a connection config. Registering a profile
    bumps its generation, the analog of the watch event that re-triggers
    the cluster reconciler (multikueuecluster.go:836)."""

    def __init__(self):
        self._profiles: dict[str, ClusterProfile] = {}
        self._gen = 0  # registry-wide, survives delete: a
        # delete + re-register rotation between ticks must still
        # present a NEW generation to the change detector.

    def register(self, profile: ClusterProfile) -> None:
        self._gen += 1
        profile.generation = self._gen
        self._profiles[profile.name] = profile

    def delete(self, name: str) -> None:
        self._profiles.pop(name, None)

    def get(self, name: str) -> Optional[ClusterProfile]:
        return self._profiles.get(name)

    def build_config(self, name: str) -> dict:
        """BuildConfigFromCP: raises on a missing profile (reconcile
        re-triggers when the ClusterProfile is created,
        multikueuecluster.go:836)."""
        profile = self._profiles.get(name)
        if profile is None or profile.config is None:
            raise KeyError(f"ClusterProfile {name!r} not found")
        return profile.config


class RemoteClient:
    """One worker cluster's client lifecycle (remoteClient in
    multikueuecluster.go): connect from a kubeconfig file OR a
    ClusterProfile reference (ClusterSource is exactly one of the two,
    multikueue_types.go ClusterSource), reconnect with exponential
    backoff after failures, rebuild when the source changes. The
    ClusterProfile source is gated by MultiKueueClusterProfile
    (multikueuecluster.go:859: gate off => Active=False with reason
    MultiKueueClusterProfileFeatureDisabled)."""

    def __init__(self, name: str, kubeconfig_path: str = None,
                 connect: Callable[[dict], object] = None,
                 clock: Callable[[], float] = None,
                 retry_increment: float = DEFAULT_RETRY_INCREMENT,
                 cluster_profile: str = None,
                 profiles: Optional[ClusterProfileRegistry] = None):
        if (kubeconfig_path is None) == (cluster_profile is None):
            raise ValueError("exactly one of kubeconfig_path and "
                             "cluster_profile must be set")
        self.name = name
        self.kubeconfig_path = kubeconfig_path
        self.cluster_profile = cluster_profile
        self.profiles = profiles
        self.connect = connect
        self.clock = clock
        self.retry_increment = retry_increment
        self.worker: Optional[object] = None
        self.failed_attempts = 0
        self.next_attempt_at = 0.0
        self.active = ClusterActive()
        self._mtime: Optional[int] = None

    def _stat_mtime(self):
        if self.kubeconfig_path is None:
            # ClusterProfile source: the profile's generation is the
            # change signal (a re-registered profile bumps it, the
            # watch-event analog); the gate state participates so a
            # flip re-triggers connection handling immediately.
            from kueue_tpu_torch.config import features
            if not features.enabled("MultiKueueClusterProfile"):
                return "gate-disabled"
            profile = (self.profiles.get(self.cluster_profile)
                       if self.profiles is not None else None)
            return None if profile is None else profile.generation
        try:
            return os.stat(self.kubeconfig_path).st_mtime_ns
        except OSError:
            return None

    def _load_config(self) -> dict:
        if self.kubeconfig_path is not None:
            with open(self.kubeconfig_path, encoding="utf-8") as f:
                return json.load(f)
        from kueue_tpu_torch.config import features
        if not features.enabled("MultiKueueClusterProfile"):
            raise _GateDisabled(
                "MultiKueueClusterProfile feature gate is disabled")
        if self.profiles is None:
            raise KeyError("no ClusterProfile registry attached")
        return self.profiles.build_config(self.cluster_profile)

    def mark_lost(self, reason: str) -> None:
        """Watch-ended / transport-failure event (the reference's
        queueWatchEndedEvent): drop the client and schedule a
        backed-off reconnect (failedConnAttempts++, :289)."""
        self.worker = None
        self.failed_attempts += 1
        self.next_attempt_at = self.clock() + retry_after(
            self.failed_attempts, self.retry_increment)
        self.active = ClusterActive(False, "ClientConnectionLost", reason)

    def tick(self) -> str:
        """One lifecycle step. Returns the transition that happened:
        "" (none), "connected" (a fresh client is live),
        "reconfigured" (kubeconfig changed AND the rebuilt client
        connected in the same step — the old client must be torn down
        before the new one serves), or "disconnected" (kubeconfig
        changed and the rebuild failed — the old client is dead and
        must be torn down NOW; reconnects continue under backoff)."""
        now = self.clock()
        mtime = self._stat_mtime()
        reconfigured = False
        if mtime != self._mtime:
            # fswatch.go: the kubeconfig changed — rebuild immediately
            # (credential rotation must not wait out a backoff). While
            # DISCONNECTED the same rule cancels any accumulated
            # reconnect backoff: the operator just rotated the
            # credentials the backoff was waiting on.
            if self.worker is not None:
                self.worker = None
                self.active = ClusterActive(False, "KubeconfigChanged", "")
                reconfigured = True
            self.next_attempt_at = now
            self._mtime = mtime
        if self.worker is None and now >= self.next_attempt_at:
            try:
                config = self._load_config()
                self.worker = self.connect(config)
                self._mtime = mtime
                self.failed_attempts = 0
                self.active = ClusterActive(True, "Active", "Connected")
                return "reconfigured" if reconfigured else "connected"
            except _GateDisabled as e:
                # multikueuecluster.go:859: no backoff churn — the gate
                # flip itself re-triggers via the source version.
                self.active = ClusterActive(
                    False, "MultiKueueClusterProfileFeatureDisabled",
                    str(e))
                if reconfigured:
                    return "disconnected"
            except Exception as e:  # noqa: BLE001 — any connect failure
                self.failed_attempts += 1
                self.next_attempt_at = now + retry_after(
                    self.failed_attempts, self.retry_increment)
                self.active = ClusterActive(
                    False, "ClientConnectionFailed", str(e)[:200])
                if reconfigured:
                    return "disconnected"
        return ""
