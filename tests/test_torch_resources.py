"""The effective-requests pipeline of the port (utils/podtemplate.py,
utils/limitrange.py, ``workload_info.adjust_resources``,
``validate_admissibility`` and the Info options, the engine's
``create_limit_range``, ``create_runtime_class`` and ``submit``), its
preemption expectation store (utils/expectations.py) and its admission
routine (utils/routine.py) against the JAX package's.

Every case of tests/test_resources_pipeline.py (14) and
tests/test_expectations_routine.py (12) runs twice: as it is, on the JAX
package, and on the port, with the module's globals pointed at the
port's (``port_globals``: the API types, utils, workload_info and
config, the Engine on the CPU) and the names a case imports inside its
body patched on the JAX modules it imports them from. Both runs start
the uid and workload-name counters at one value (ROADMAP trap (a)). The
port run passes the case's own assertions, and every engine the two
runs build must end in the same world: the same workloads with the same
outcomes and per-pod requests, and the same event stream. The JAX runs
are shared through a module fixture. Exact throughout."""

import contextlib
import importlib
import itertools
import types

import pytest

import test_expectations_routine
import test_resources_pipeline
from kueue_tpu.api import types as jtypes
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu_torch import carry
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers import jobframework as pjf
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from test_torch_engine import outcome

UID_START = 80_000_001

# Names the reference cases import inside their bodies, by the JAX
# module they import them from.
IN_BODY = {
    "kueue_tpu.api.types": ("FlavorResource", "PodSet", "Workload"),
    "kueue_tpu.config": ("features",),
    "kueue_tpu.config.api": ("from_dict",),
    "kueue_tpu.controllers.admissionchecks": (
        "PodSetUpdate", "ProvisioningRequestConfig",
        "ProvisioningRequestRetryStrategy"),
    "kueue_tpu.controllers.jobframework": ("BatchJob", "JobReconciler"),
    "kueue_tpu.webhooks.validators": ("default_workload",),
}


def port_name(name: str) -> str:
    return "kueue_tpu_torch" + name[len("kueue_tpu"):]


def port_of(obj):
    """The port's object of the same name as ``obj`` (a module, class or
    function of the JAX package), or None when ``obj`` is none of
    those."""
    if isinstance(obj, types.ModuleType):
        if obj.__name__.startswith("kueue_tpu."):
            return importlib.import_module(port_name(obj.__name__))
        return None
    mod = getattr(obj, "__module__", None) or ""
    if not mod.startswith("kueue_tpu.") or not hasattr(obj, "__name__"):
        return None
    return getattr(importlib.import_module(port_name(mod)), obj.__name__)


@contextlib.contextmanager
def aligned_counters(t, jf):
    """Start one package's uid and workload-name counters at fixed
    values; restore them after."""
    old = (t._uid_counter, jf._wl_suffix)
    t._uid_counter = itertools.count(UID_START)
    jf._wl_suffix = itertools.count(1)
    try:
        yield
    finally:
        t._uid_counter, jf._wl_suffix = old


def world(eng) -> tuple:
    """What two engines that decided alike must share."""
    return (eng.clock, sorted(eng.workloads),
            {k: (outcome(w), [(ps.name, ps.count, dict(ps.requests))
                              for ps in w.pod_sets])
             for k, w in eng.workloads.items()},
            [(e.time, e.kind, e.workload, e.cluster_queue, e.detail)
             for e in eng.events])


def _port_engine(built):
    def make(*args, config=None, **kwargs):
        if config is not None and type(config).__module__.startswith(
                "kueue_tpu."):
            config = carry.configuration(config)
        eng = PEngine(*args, device="cpu", config=config, **kwargs)
        built.append(eng)
        return eng
    return make


def _jax_engine(built):
    def make(*args, **kwargs):
        eng = JEngine(*args, **kwargs)
        built.append(eng)
        return eng
    return make


def port_globals(mp, module, built) -> None:
    """Point ``module``'s globals at the port (``mp`` a MonkeyPatch),
    its ``Engine`` at a port engine on the CPU appended to ``built``,
    and the names its cases import inside their bodies at the port's."""
    for name, obj in list(vars(module).items()):
        if name == "Engine":
            mp.setattr(module, name, _port_engine(built))
            continue
        ported = port_of(obj)
        if ported is not None:
            mp.setattr(module, name, ported)
    for jname, names in IN_BODY.items():
        jmod = importlib.import_module(jname)
        pmod = importlib.import_module(port_name(jname))
        for name in names:
            obj = getattr(pmod, name, None)
            if obj is None:  # a submodule not imported yet
                obj = importlib.import_module(f"{pmod.__name__}.{name}")
            mp.setattr(jmod, name, obj)


def call(module, case: str) -> None:
    """Run one case of ``module``: ``test_x`` or ``Class.test_x``."""
    owner, _, name = case.rpartition(".")
    if owner:
        getattr(getattr(module, owner)(), name)()
    else:
        getattr(module, name)()


def run_case(module, case: str, pkg: str) -> list:
    """Run ``case`` of ``module`` on ``pkg`` ("jax" or "port"); returns
    the world of every engine it built."""
    built: list = []
    with pytest.MonkeyPatch.context() as mp:
        if pkg == "port":
            port_globals(mp, module, built)
            counters = aligned_counters(ptypes, pjf)
        else:
            mp.setattr(module, "Engine", _jax_engine(built))
            counters = aligned_counters(jtypes, jjf)
        with counters:
            call(module, case)
    return [world(e) for e in built]


def cases_of(module) -> list:
    out = []
    for name, obj in vars(module).items():
        if name.startswith("test_") and callable(obj):
            out.append(name)
        elif name.startswith("Test") and isinstance(obj, type):
            out += [f"{name}.{m}" for m in vars(obj) if m.startswith("test_")]
    return sorted(out)


MODULES = {"resources_pipeline": test_resources_pipeline,
           "expectations_routine": test_expectations_routine}
CASES = [(m, c) for m, mod in MODULES.items() for c in cases_of(mod)]


@pytest.fixture(scope="module")
def jax_runs():
    return {(m, c): run_case(MODULES[m], c, "jax") for m, c in CASES}


def test_every_reference_case_is_held():
    assert len(cases_of(test_resources_pipeline)) == 14
    assert len(cases_of(test_expectations_routine)) == 12


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(jax_runs, module, case):
    got = run_case(MODULES[module], case, "port")
    want = jax_runs[module, case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_templates_adjust_and_validate_as_the_jax_package():
    """Templates of every shape the pipeline distinguishes, adjusted and
    validated by both packages under one LimitRange and RuntimeClass:
    the per-pod requests, the first failure and the adjusted template
    equal; the carried template is a copy (ROADMAP trap (d))."""
    from kueue_tpu import workload_info as jwi
    from kueue_tpu.utils import limitrange as jlr
    from kueue_tpu.utils import podtemplate as jpt
    from kueue_tpu_torch import workload_info as pwi

    def templates():
        yield jpt.PodTemplate(containers=[jpt.ContainerSpec("a")])
        yield jpt.PodTemplate(
            containers=[jpt.ContainerSpec("a", {"cpu": 300}),
                        jpt.ContainerSpec("b", limits={"cpu": 900})],
            init_containers=[jpt.ContainerSpec("i", {"cpu": 2000})],
            runtime_class_name="kata")
        yield jpt.PodTemplate(
            containers=[jpt.ContainerSpec("a", {"cpu": 100})],
            init_containers=[jpt.ContainerSpec(
                "side", {"cpu": 50, "mem": 8}, restart_always=True)],
            pod_limits={"cpu": 700})
        yield jpt.PodTemplate(containers=[
            jpt.ContainerSpec("a", {"cpu": 900}, limits={"cpu": 500})])
        yield jpt.PodTemplate(containers=[jpt.ContainerSpec(
            "a", {"cpu": 5000})], overhead={"cpu": 7})
        yield jpt.PodTemplate(containers=[jpt.ContainerSpec(
            "a", {"cpu": 20})], pod_requests={"cpu": 40})

    ranges = [jlr.LimitRange("d", limits=(
        jlr.LimitRangeItem(jlr.LIMIT_TYPE_CONTAINER, max={"cpu": 4000},
                           min={"cpu": 30},
                           default_request={"cpu": 250, "mem": 16}),
        jlr.LimitRangeItem(jlr.LIMIT_TYPE_POD, max={"cpu": 6000},
                           default={"cpu": 800}))),
        jlr.LimitRange("other", namespace="elsewhere", limits=(
            jlr.LimitRangeItem(jlr.LIMIT_TYPE_CONTAINER,
                               max={"cpu": 1}),))]
    overheads = {"kata": {"cpu": 120}}
    for i, tpl in enumerate(templates()):
        wl = jtypes.Workload(name=f"w{i}", pod_sets=(
            jtypes.PodSet("main", 2, template=tpl),))
        pw = carry.api_object(wl)
        assert pw.pod_sets[0].template is not tpl
        jwi.adjust_resources(wl, ranges, overheads)
        pwi.adjust_resources(pw, carry.api_object(ranges), overheads)
        assert pw.pod_sets[0].requests == wl.pod_sets[0].requests, i
        assert carry.api_object(wl.pod_sets[0].template) == \
            pw.pod_sets[0].template, i
        assert pwi.validate_admissibility(pw, carry.api_object(ranges)) \
            == jwi.validate_admissibility(wl, ranges), i
