"""DRA (Dynamic Resource Allocation): claims, device classes, counters.

The port of ``kueue_tpu/controllers/dra.py``. It runs on the host only,
as its JAX counterpart does: no engine path calls it, and the feature
gates it reads (``KueueDRAIntegration``,
``KueueDRAIntegrationExtendedResource``) are on by default, as in the
JAX package.

Reference: pkg/dra —
  * ``ResourceMapper`` (mapper.go:36): DeviceClass -> logical extended
    resource, populated from Configuration deviceClassMappings, with
    optional counter definitions (per-device counter charges);
  * claims (claims.go:58 countDevicesPerClass, :155
    GetResourceRequestsForResourceClaimTemplates): a pod's claim
    templates request N devices per class, optionally filtered by
    selectors — the counts become quota-space requests;
  * resource slices / pools (counters.go:224 poolInfo, :243
    groupSlicesByPool): drivers publish device inventories in slices; a
    pool is usable only when all its slices arrived;
  * counter charges (counters.go:36 GetCounterResourcesForWorkload):
    counter-based logical resources (e.g. gpu memory) are charged per
    matched device from the pool's counter sets;
  * workload integration (workload.go:625-645): claim-derived resources
    replace the raw extended resources in each PodSet's effective
    requests.

Device selectors come in two forms, as in the reference: plain
attribute-equality maps, and CEL expressions (claims.go:235
validateCELSelectors / :411 validateCELSelectorsAgainstDevices)
evaluated per device with ``device.driver`` / ``device.attributes`` /
``device.capacity`` in scope (utils/cel.py implements the expression
subset; compile errors reject the claim before quota admission, and an
insufficient match count is surfaced exactly like the reference's
"insufficient matching devices" error).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DeviceClass:
    """A device class exposed as an extended resource, optionally
    charging per-device counters (configapi DeviceClassMapping)."""

    name: str  # e.g. "tpu.google.com/v5e"
    extended_resource: str  # e.g. "tpu-v5e"
    # counter name -> per-device charge (deviceClassCounterConfig).
    counters: dict[str, int] = field(default_factory=dict)


@dataclass
class Device:
    """One device in a ResourceSlice (resourcev1.Device)."""

    name: str
    attributes: dict[str, str] = field(default_factory=dict)
    # counter set: counter name -> capacity this device consumes.
    counters: dict[str, int] = field(default_factory=dict)
    driver: str = ""  # stamped from the slice for the CEL env

    def cel_env(self) -> dict:
        return {"device": {"driver": self.driver,
                           "attributes": dict(self.attributes),
                           "capacity": dict(self.counters)}}


def validate_cel_selectors(requests) -> list[str]:
    """claims.go:235 validateCELSelectors: compile every expression up
    front; syntax errors reject the claim before quota admission."""
    from kueue_tpu_torch.utils import cel

    errs = []
    for i, req in enumerate(requests):
        for j, expr in enumerate(getattr(req, "cel_selectors", ()) or ()):
            try:
                cel.compile_cel(expr)
            except cel.CelCompileError as e:
                errs.append(f"devices.requests[{i}].selectors[{j}]: "
                            f"CEL compilation failed: {e}")
    return errs


def _device_matches(dev: Device, req: DeviceRequest) -> bool:
    """All attribute-equality AND all CEL selectors must hold; a CEL
    runtime error (missing key, type mismatch) means no-match for that
    device, the upstream evaluator's per-device error behavior."""
    if any(dev.attributes.get(k) != v for k, v in req.selectors.items()):
        return False
    if req.cel_selectors:
        from kueue_tpu_torch.utils import cel

        env = dev.cel_env()
        for expr in req.cel_selectors:
            try:
                if not cel.evaluate_predicate(expr, env):
                    return False
            except cel.CelEvalError:
                # Upstream evaluates per device and an evaluation error
                # (missing attribute, bad regex, non-bool result) means
                # this device doesn't match.
                return False
    return True


@dataclass
class ResourceSlice:
    """A driver-published inventory shard (counters.go:243).
    ``name`` is the slice's object identity: re-publishing the same name
    upserts rather than duplicates."""

    driver: str
    pool: str
    pool_slice_count: int  # total slices the pool publishes
    devices: list[Device] = field(default_factory=list)
    name: str = ""


@dataclass
class DeviceRequest:
    """One request inside a claim template (claims.go:47)."""

    device_class: str
    count: int = 1
    # Attribute-equality selectors (the fast path).
    selectors: dict[str, str] = field(default_factory=dict)
    # CEL selector expressions, ALL of which must match a device
    # (resourcev1.DeviceSelector.CEL; claims.go:45 celDeviceRequest).
    cel_selectors: tuple[str, ...] = ()


@dataclass
class ResourceClaim:
    """A claim for devices (claims.go countDevicesPerClass input)."""

    device_class: str = ""
    count: int = 1
    requests: tuple[DeviceRequest, ...] = ()

    def device_requests(self) -> list[DeviceRequest]:
        if self.requests:
            return list(self.requests)
        return [DeviceRequest(self.device_class, self.count)]


class DeviceClassMapper:
    """mapper.go:36 (ResourceMapper) + the slice/pool inventory."""

    def __init__(self) -> None:
        self.classes: dict[str, DeviceClass] = {}
        # (driver, pool, slice name) -> slice: controller upserts
        # replace, never duplicate.
        self._slices: dict[tuple, ResourceSlice] = {}

    @property
    def slices(self) -> list[ResourceSlice]:
        return list(self._slices.values())

    # -- registry (PopulateFromConfiguration) --

    def add_device_class(self, dc: DeviceClass) -> None:
        self.classes[dc.name] = dc

    def delete_device_class(self, name: str) -> None:
        self.classes.pop(name, None)

    @classmethod
    def from_mappings(cls, mappings: list[dict]) -> "DeviceClassMapper":
        """mapper.go:65 PopulateFromConfiguration."""
        m = cls()
        for entry in mappings:
            m.add_device_class(DeviceClass(
                name=entry["name"],
                extended_resource=entry.get("logicalResourceName",
                                            entry["name"]),
                counters={k: int(v) for k, v in
                          (entry.get("counters") or {}).items()}))
        return m

    # -- inventory (groupSlicesByPool / poolInfo) --

    def add_resource_slice(self, s: ResourceSlice) -> None:
        for d in s.devices:
            if not d.driver:
                d.driver = s.driver
        if not s.name:
            # Anonymous slices get a collision-free generated identity
            # (a monotonic counter — dict length would reuse names
            # after deletes and clobber live inventory).
            self._anon_counter = getattr(self, "_anon_counter", 0) + 1
            s.name = f"anon-slice-{self._anon_counter}"
        self._slices[(s.driver, s.pool, s.name)] = s

    def delete_resource_slice(self, driver: str, pool: str,
                              name: str) -> None:
        self._slices.pop((driver, pool, name), None)

    def complete_pools(self, driver: Optional[str] = None
                       ) -> dict[str, list[Device]]:
        """counters.go:231 isComplete: a pool counts only when every
        published slice has arrived."""
        groups: dict[str, list[ResourceSlice]] = {}
        for s in self.slices:
            if driver is not None and s.driver != driver:
                continue
            groups.setdefault(f"{s.driver}/{s.pool}", []).append(s)
        out: dict[str, list[Device]] = {}
        for pool, slices in groups.items():
            if len(slices) >= slices[0].pool_slice_count:
                out[pool] = [d for s in slices for d in s.devices]
        return out

    # -- claim resolution --

    def resolve(self, claims: list[ResourceClaim]) -> dict[str, int]:
        """countDevicesPerClass -> extended-resource requests; raises on
        unmapped classes. Gated: kube_features.go KueueDRAIntegration
        (+ KueueDRAIntegrationExtendedResource for the mapping itself);
        with the gate off, claims are rejected rather than silently
        dropped (KueueDRARejectWorkloadsWhenDRADisabled semantics)."""
        from kueue_tpu_torch.config import features
        if claims and not features.enabled("KueueDRAIntegration"):
            raise KeyError(
                "workload carries ResourceClaims but the"
                " KueueDRAIntegration feature gate is disabled")
        if claims and not features.enabled(
                "KueueDRAIntegrationExtendedResource"):
            raise KeyError(
                "extended-resource mapping disabled"
                " (KueueDRAIntegrationExtendedResource)")
        out: dict[str, int] = {}
        for claim in claims:
            for req in claim.device_requests():
                dc = self.classes.get(req.device_class)
                if dc is None:
                    raise KeyError(
                        f"unknown device class {req.device_class}")
                out[dc.extended_resource] = out.get(
                    dc.extended_resource, 0) + req.count
        return out

    def counter_resources(self, claims: list[ResourceClaim]
                          ) -> dict[str, int]:
        """counters.go:36 GetCounterResourcesForWorkload: charge
        counter-based logical resources for the devices each request
        would match, taken greedily from complete pools."""
        pools = self.complete_pools()
        matched: set[tuple[str, str]] = set()  # (pool, device name)
        charges: dict[str, int] = {}
        for claim in claims:
            for req in claim.device_requests():
                dc = self.classes.get(req.device_class)
                if dc is None:
                    raise KeyError(
                        f"unknown device class {req.device_class}")
                needed = req.count
                for pool, devices in pools.items():
                    for dev in devices:
                        if needed == 0:
                            break
                        if (pool, dev.name) in matched:
                            continue
                        if not _device_matches(dev, req):
                            continue
                        matched.add((pool, dev.name))
                        needed -= 1
                        for counter, per_dev in dc.counters.items():
                            cap = dev.counters.get(counter, per_dev)
                            charges[counter] = charges.get(counter, 0) \
                                + cap
                    if needed == 0:
                        break
                if needed > 0:
                    raise LookupError(
                        f"not enough devices for class "
                        f"{req.device_class}: {needed} short")
        return charges

    def validate_against_devices(self, claims: list[ResourceClaim]
                                 ) -> list[str]:
        """claims.go:411 validateCELSelectorsAgainstDevices: compile the
        selectors, count matching devices across complete pools, and
        report shortages so quota is never held by workloads whose pods
        can never be scheduled."""
        errs = []
        for claim in claims:
            errs.extend(validate_cel_selectors(claim.device_requests()))
        if errs:
            return errs
        pools = self.complete_pools()
        matched: set[tuple[str, str]] = set()
        for claim in claims:
            for i, req in enumerate(claim.device_requests()):
                # Selector-less requests still CONSUME devices from the
                # pools (counter_resources allocates greedily in claim
                # order), so they participate in the matched-set
                # accounting — skipping them would validate claims that
                # allocation must reject.
                dc = self.classes.get(req.device_class)
                if dc is None:
                    errs.append(f"unknown device class "
                                f"{req.device_class}")
                    continue
                count = 0
                for pool, devices in pools.items():
                    for dev in devices:
                        if (pool, dev.name) in matched:
                            continue
                        if _device_matches(dev, req):
                            matched.add((pool, dev.name))
                            count += 1
                            if count >= req.count:
                                break
                    if count >= req.count:
                        break
                if count < req.count:
                    errs.append(
                        f"insufficient matching devices for selector in "
                        f"DeviceClass {req.device_class}: {count} "
                        f"device(s) match in the cluster but "
                        f"{req.count} requested")
        return errs

    def apply_claims(self, pod_set, claims: list[ResourceClaim],
                     with_counters: bool = False):
        """workload.go:625-645: merge claim-derived requests into a pod
        set's requests, REPLACING any raw request for the mapped
        extended resources (replacedExtendedResources)."""
        resolved = self.resolve(claims)
        merged = {r: q for r, q in pod_set.requests.items()
                  if r not in resolved}
        for res, count in resolved.items():
            merged[res] = merged.get(res, 0) + count
        if with_counters:
            for counter, charge in self.counter_resources(claims).items():
                merged[counter] = merged.get(counter, 0) + charge
        from dataclasses import replace as _replace

        return _replace(pod_set, requests=merged)
