"""The port's DRA (kueue_tpu_torch/controllers/dra.py) and its CEL subset
(kueue_tpu_torch/utils/cel.py) against the JAX package's.

Every case runs once per package through ``both``: the same calls on
each package's modules, and every result, or the type and message of
every error raised, must be equal. The cases are those of
``tests/test_extended_controllers.py`` (its ``test_dra_*``),
``tests/test_feature_gates.py::test_dra_gates`` and the CEL and DRA-CEL
classes of ``tests/test_client_extensions.py``, plus the CEL error
messages of a set of malformed expressions, the insertion order in which
pools and their devices are matched, and the gates' defaults (on in both
packages: ROADMAP trap (az))."""

import dataclasses

import pytest

from kueue_tpu.api import types as jtypes
from kueue_tpu.config import features as jfeatures
from kueue_tpu.controllers import dra as jdra
from kueue_tpu.utils import cel as jcel
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.config import features as pfeatures
from kueue_tpu_torch.controllers import dra as pdra
from kueue_tpu_torch.utils import cel as pcel

PACKAGES = {"jax": (jdra, jcel, jfeatures, jtypes),
            "port": (pdra, pcel, pfeatures, ptypes)}


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("raised", type(e).__name__, str(e))
    if dataclasses.is_dataclass(out):
        return ("value", type(out).__name__, dataclasses.asdict(out))
    return ("value", out)


def both(case):
    """``case(dra, cel, features, types)`` -> a list of (fn, args)
    steps, run in each package with the gates reset before and after;
    the outcomes must be equal. Returns the port's outcomes."""
    got = {}
    for pkg, mods in PACKAGES.items():
        mods[2].reset()
        try:
            got[pkg] = [_outcome(fn, *a) for fn, a in case(*mods)]
        finally:
            mods[2].reset()
    assert got["port"] == got["jax"]
    return got["port"]


def test_gates_default_on_in_both_packages():
    for name in ("KueueDRAIntegration",
                 "KueueDRAIntegrationExtendedResource"):
        assert jfeatures.enabled(name)
        assert pfeatures.enabled(name)


def test_dra_mapper():
    def case(dra, cel, features, t):
        m = dra.DeviceClassMapper()
        m.add_device_class(dra.DeviceClass("tpu.google.com/v5e", "tpu-v5e"))
        ps = t.PodSet("main", 4, {"cpu": 1000})
        return [(lambda: m.apply_claims(
                    ps, [dra.ResourceClaim("tpu.google.com/v5e", 4)])
                 .requests, ()),
                (m.resolve, ([dra.ResourceClaim("unknown", 1)],))]

    out = both(case)
    assert out[0] == ("value", {"cpu": 1000, "tpu-v5e": 4})
    assert out[1][:2] == ("raised", "KeyError")


def test_dra_pools_and_counters():
    def case(dra, cel, features, t):
        m = dra.DeviceClassMapper()
        m.add_device_class(dra.DeviceClass(
            "gpu.example.com/a100", "gpu-a100",
            counters={"gpu-mem-gib": 40}))
        claims = [dra.ResourceClaim(requests=(
            dra.DeviceRequest("gpu.example.com/a100", 2),))]
        selective = [dra.ResourceClaim(requests=(
            dra.DeviceRequest("gpu.example.com/a100", 2,
                              selectors={"zone": "a"}),))]

        def pools():
            return {k: [d.name for d in v]
                    for k, v in m.complete_pools().items()}

        return [
            (m.add_resource_slice, (dra.ResourceSlice(
                driver="gpu.example.com", pool="p1", pool_slice_count=2,
                devices=[dra.Device("d0", {"zone": "a"},
                                    {"gpu-mem-gib": 40})]),)),
            (pools, ()),
            (m.add_resource_slice, (dra.ResourceSlice(
                driver="gpu.example.com", pool="p1", pool_slice_count=2,
                devices=[dra.Device("d1", {"zone": "b"},
                                    {"gpu-mem-gib": 80})]),)),
            (pools, ()),
            (m.resolve, (claims,)),
            (m.counter_resources, (claims,)),
            (m.counter_resources, (selective,))]

    out = both(case)
    assert out[1] == ("value", {})
    assert out[3] == ("value", {"gpu.example.com/p1": ["d0", "d1"]})
    assert out[5] == ("value", {"gpu-mem-gib": 120})
    assert out[6][:2] == ("raised", "LookupError")


def test_dra_apply_claims_replaces_extended_resources():
    def case(dra, cel, features, t):
        m = dra.DeviceClassMapper()
        m.add_device_class(dra.DeviceClass("tpu.google.com/v5e", "tpu-v5e"))
        ps = t.PodSet("main", 1, {"cpu": 1000, "tpu-v5e": 99})
        return [(lambda: m.apply_claims(
            ps, [dra.ResourceClaim("tpu.google.com/v5e", 4)]).requests, ())]

    assert both(case) == [("value", {"cpu": 1000, "tpu-v5e": 4})]


def test_dra_from_config_mappings():
    def case(dra, cel, features, t):
        m = dra.DeviceClassMapper.from_mappings([
            {"name": "gpu.example.com/mig-1g",
             "logicalResourceName": "gpu-mem",
             "counters": {"mem-gib": 5}}])
        return [(m.resolve,
                 ([dra.ResourceClaim("gpu.example.com/mig-1g", 3)],))]

    assert both(case) == [("value", {"gpu-mem": 3})]


def test_dra_slice_republish_upserts():
    def case(dra, cel, features, t):
        m = dra.DeviceClassMapper()
        m.add_device_class(dra.DeviceClass("gpu.example.com/a", "gpu-a"))

        def pools():
            return {k: [d.name for d in v]
                    for k, v in m.complete_pools().items()}

        return [
            (m.add_resource_slice, (dra.ResourceSlice(
                driver="d", pool="p", pool_slice_count=2, name="s0",
                devices=[dra.Device("d0")]),)),
            (m.add_resource_slice, (dra.ResourceSlice(
                driver="d", pool="p", pool_slice_count=2, name="s0",
                devices=[dra.Device("d0"), dra.Device("d0b")]),)),
            (pools, ()),
            (m.add_resource_slice, (dra.ResourceSlice(
                driver="d", pool="p", pool_slice_count=2, name="s1",
                devices=[dra.Device("d1")]),)),
            (pools, ())]

    out = both(case)
    assert out[2] == ("value", {})
    assert out[4] == ("value", {"d/p": ["d0", "d0b", "d1"]})


def test_dra_gates():
    def case(dra, cel, features, t):
        mapper = dra.DeviceClassMapper()
        mapper.add_device_class(dra.DeviceClass(
            name="gpus", extended_resource="example.com/gpu"))
        claims = [dra.ResourceClaim(requests=(
            dra.DeviceRequest(device_class="gpus", count=2),))]
        return [(mapper.resolve, (claims,)),
                (features.set_feature, ("KueueDRAIntegration", False)),
                (mapper.resolve, (claims,)),
                (features.reset, ()),
                (features.set_feature,
                 ("KueueDRAIntegrationExtendedResource", False)),
                (mapper.resolve, (claims,))]

    out = both(case)
    assert out[0] == ("value", {"example.com/gpu": 2})
    assert out[2][:2] == ("raised", "KeyError")
    assert "KueueDRAIntegration" in out[2][2]
    assert "ExtendedResource" in out[5][2]


CEL_ENV = {"device": {"driver": "tpu.example.com",
                      "attributes": {"family": "v5e", "cores": 8},
                      "capacity": {"memory": 16}}}
CEL_EXPRESSIONS = [
    'device.driver == "tpu.example.com"',
    'device.attributes["family"] == "v5e" && '
    'device.attributes["cores"] >= 8',
    'device.attributes["cores"] > 8',
    'device.driver.startsWith("tpu.")',
    'device.driver.matches("^tpu\\\\.")',
    '"family" in device.attributes',
    '"missing" in device.attributes',
    'device.capacity["memory"] - 8 >= 8',
    'device.attributes["family"] in ["v5e", "v5p"]',
    '!(device.attributes["cores"] < 4)',
    'device.driver.size() > 5',
    # runtime errors
    'device.attributes["missing"] == 1',
    'device.driver + 1 == 2',
    'device.driver.matches("[")',
    '1 in device.driver',
    'device.attributes["family"]',
    # compile errors
    "device.attributes[", "a &&", "1 ===2", "foo(",
    'device.driver.nosuch("x")', "", "   ", '"unterminated',
    "device.attributes[\"a\"] ==", "(device.driver", "[1, 2",
    "device..driver", "1 2", "!",
]


def test_cel_results_and_messages_match():
    """Every expression through compile, evaluate and evaluate_predicate
    in both packages: the same values, and the same error classes and
    messages."""
    def case(dra, cel, features, t):
        steps = []
        for expr in CEL_EXPRESSIONS:
            steps.append((lambda e=expr: (cel.compile_cel(e), None)[1],
                          ()))
            steps.append((cel.evaluate, (expr, CEL_ENV)))
            steps.append((cel.evaluate_predicate, (expr, CEL_ENV)))
        return steps

    out = both(case)
    assert ("value", True) in out
    assert any(o[:2] == ("raised", "CelCompileError") for o in out)
    assert any(o[:2] == ("raised", "CelEvalError") for o in out)


def test_cel_error_classes_are_the_jax_ones_by_name():
    for name in ("CelError", "CelCompileError", "CelEvalError"):
        if hasattr(jcel, name):
            j, p = getattr(jcel, name), getattr(pcel, name)
            assert [c.__name__ for c in p.__mro__] == \
                [c.__name__ for c in j.__mro__]


def _cel_mapper(dra):
    m = dra.DeviceClassMapper()
    m.add_device_class(dra.DeviceClass(
        "tpu.example.com/v5e", "tpu-v5e", counters={"mem": 16}))
    m.add_resource_slice(dra.ResourceSlice(
        driver="tpu.example.com", pool="p0", pool_slice_count=1,
        devices=[
            dra.Device("d0", {"family": "v5e", "zone": "a"}),
            dra.Device("d1", {"family": "v5e", "zone": "b"}),
            dra.Device("d2", {"family": "v5p", "zone": "a"}),
        ]))
    return m


@pytest.mark.parametrize("claims", [
    [(2, ('device.attributes["family"] == "v5e"',))],
    [(3, ('device.attributes["family"] == "v5e"',))],
    [(1, ('device.attributes["nope"] == "x"',))],
    [(1, ('device.attributes["family"].matches("[")',))],
    [(1, ('device.attributes["family"]',))],
    [(2, ()), (2, ('device.attributes["family"] == "v5e"',))],
    [(1, ('device.driver == "tpu.example.com" && '
          'device.attributes["zone"] == "b"',))],
    [(1, ('device.attributes[',))],
], ids=["fits", "short", "eval-error", "bad-regex", "non-bool",
        "selectorless-first", "counter-charge", "compile-error"])
def test_dra_cel_validation_and_counters(claims):
    """``TestDraCel``'s cases: validation against the devices, the
    counter charges, and the up-front compile check."""
    def case(dra, cel, features, t):
        m = _cel_mapper(dra)
        rcs = [dra.ResourceClaim(requests=(dra.DeviceRequest(
            "tpu.example.com/v5e", count=n, cel_selectors=sel),))
            for n, sel in claims]
        reqs = [r for rc in rcs for r in rc.device_requests()]
        return [(m.validate_against_devices, (rcs,)),
                (m.counter_resources, (rcs,)),
                (dra.validate_cel_selectors, (reqs,)),
                (m.resolve, (rcs,))]

    both(case)


def test_greedy_matching_follows_slice_insertion_order():
    """Pools and their devices are matched in the order the slices were
    published: publishing the same devices in two orders charges
    different counters, equally in both packages."""
    def run(order):
        def case(dra, cel, features, t):
            m = dra.DeviceClassMapper()
            m.add_device_class(dra.DeviceClass("g/a", "ga"))
            slices = {
                "x": dra.ResourceSlice(driver="g", pool="x",
                                       pool_slice_count=1, name="x",
                                       devices=[dra.Device(
                                           "x0", {"z": "1"}, {"m": 10})]),
                "y": dra.ResourceSlice(driver="g", pool="y",
                                       pool_slice_count=1, name="y",
                                       devices=[dra.Device(
                                           "y0", {"z": "1"}, {"m": 30})])}
            steps = [(m.add_resource_slice, (slices[k],)) for k in order]
            claim = [dra.ResourceClaim(requests=(
                dra.DeviceRequest("g/a", 1),))]
            steps.append((m.counter_resources, (claim,)))
            steps.append((lambda: list(m.complete_pools()), ()))
            return steps
        return both(case)

    assert run("xy")[-2:] != run("yx")[-2:]
