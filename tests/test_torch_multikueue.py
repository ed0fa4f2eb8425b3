"""MultiKueue in the port (controllers/multikueue.py,
multikueue_adapters.py, and the five MultiKueue gates of
config/features.py) against the JAX package.

Every case of tests/test_multikueue.py (17) and
tests/test_feature_gates.py::test_incremental_dispatcher_gate runs
twice, as tests/test_torch_controllers.py runs its own: as it is, on the
JAX package, and on the port (``port_globals``: the module's globals
pointed at the port's, the names a case imports inside its body patched
on the JAX modules it imports them from, every Engine on the CPU), the
uid and workload-name counters started at one value in both (remote
copies keep the manager workload's uid, so the workers' candidate order
ties on the same uid rank). The port run passes the case's own
assertions, every engine the two runs build ends in the same world, and
every MultiKueueController they build ends with the same per-workload
remote state (nominated clusters, created copies, the winner), the same
ClusterQueue conditions and the same ``workloads_dispatched_total``
series on its manager. The JAX runs are shared through a module fixture.
Exact throughout."""

import importlib
import inspect

import pytest

import test_feature_gates
import test_multikueue
import test_torch_resources as tr
from kueue_tpu.api import types as jtypes
from kueue_tpu.config import features as jfeatures
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.config import features as pfeatures
from kueue_tpu_torch.controllers import jobframework as pjf

# Names the MultiKueue reference cases import inside their bodies, by the
# JAX module they import them from.
IN_BODY = {
    "kueue_tpu.api.types": ("ClusterQueuePreemption", "PreemptionPolicy"),
    "kueue_tpu.config": ("features",),
    "kueue_tpu.controllers": ("multikueue",),
    "kueue_tpu.controllers.jobframework": ("BatchJob", "JobReconciler"),
    "kueue_tpu.controllers.integrations": ("DEFAULT_INTEGRATIONS",
                                           "MPIJob"),
    "kueue_tpu.controllers.multikueue": ("MULTIKUEUE_PREEMPTION_GATE",
                                         "SINGLE_CLUSTER_PREEMPTION_TIMEOUT"),
    "kueue_tpu.controllers.multikueue_adapters": ("DEFAULT_ADAPTERS",),
    "kueue_tpu.controllers.multikueue_cluster": ("ClusterProfile",),
    "kueue_tpu.metrics.registry": ("MetricsRegistry",),
}


def _recording(cls, sink):
    """A subclass of ``cls`` that appends every instance to ``sink``."""
    return type(cls.__name__, (cls,), {
        "__init__": lambda self, *a, **kw: (cls.__init__(self, *a, **kw),
                                            sink.append(self))[0]})


def controller_state(mk) -> tuple:
    """What two MultiKueue controllers that decided alike share."""
    states = {k: (list(s.nominated), dict(s.created), s.cluster_name,
                  s.last_round_time)
              for k, s in mk.states.items()}
    fam = mk.engine.registry.counter("workloads_dispatched_total")
    active = {name: (rc.active.status, rc.active.reason,
                     rc.failed_attempts, rc.next_attempt_at)
              for name, rc in mk.remote_clients.items()}
    return (states, sorted(mk.clusters), dict(mk.cq_conditions),
            sorted(fam.values.items()), active)


def call(module, case: str, tmp_path=None) -> None:
    """Run ``case`` of ``module``, passing ``tmp_path`` and a
    MonkeyPatch where its signature asks for them."""
    fn = getattr(module, case)
    params = inspect.signature(fn).parameters
    kwargs = {}
    with pytest.MonkeyPatch.context() as mp:
        if "tmp_path" in params:
            kwargs["tmp_path"] = tmp_path
        if "monkeypatch" in params:
            kwargs["monkeypatch"] = mp
        fn(**kwargs)


def run_case(module, case: str, pkg: str, tmp_path=None,
             in_body=IN_BODY, record=("MultiKueueController",)) -> tuple:
    """Run ``case`` of ``module`` on ``pkg`` ("jax" or "port"). Returns
    (the world of every engine it built, the instances of each class
    named in ``record`` that it built, by name). Both packages' feature
    gates are reset after."""
    built: list = []
    made = {name: [] for name in record}
    try:
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "port":
                tr.port_globals(mp, module, built)
                for jname, names in in_body.items():
                    jmod = importlib.import_module(jname)
                    pmod = importlib.import_module(tr.port_name(jname))
                    for name in names:
                        obj = getattr(pmod, name, None)
                        if obj is None:  # a submodule not imported yet
                            obj = importlib.import_module(
                                f"{pmod.__name__}.{name}")
                        mp.setattr(jmod, name, obj)
                counters = tr.aligned_counters(ptypes, pjf)
            else:
                if hasattr(module, "Engine"):
                    mp.setattr(module, "Engine", tr._jax_engine(built))
                counters = tr.aligned_counters(jtypes, jjf)
            for name in record:
                if not hasattr(module, name):
                    continue
                mp.setattr(module, name,
                           _recording(getattr(module, name), made[name]))
            with counters:
                call(module, case, tmp_path)
    finally:
        jfeatures.reset()
        pfeatures.reset()
    return [tr.world(e) for e in built], made


MK_CASES = [("multikueue", c) for c in tr.cases_of(test_multikueue)]
CASES = MK_CASES + [("feature_gates", "test_incremental_dispatcher_gate")]
MODULES = {"multikueue": test_multikueue,
           "feature_gates": test_feature_gates}


@pytest.fixture(scope="module")
def jax_runs():
    return {(m, c): run_case(MODULES[m], c, "jax") for m, c in CASES}


def test_every_reference_case_is_held():
    assert len(MK_CASES) == 17


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(jax_runs, module, case):
    got, got_mk = run_case(MODULES[module], case, "port")
    want, want_mk = jax_runs[module, case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    pm, jm = got_mk["MultiKueueController"], want_mk["MultiKueueController"]
    assert len(pm) == len(jm)
    for p, j in zip(pm, jm):
        assert controller_state(p) == controller_state(j)


def test_gates_at_the_jax_defaults():
    """The five MultiKueue gates read as the JAX package's, and each
    package keeps its own overrides."""
    names = ("MultiKueue", "MultiKueueOrchestratedPreemption",
             "MultiKueueManagerQuotaAutomation",
             "MultiKueueIncrementalDispatcherConfig",
             "MultiKueueClusterProfile")
    assert [pfeatures.enabled(n) for n in names] == \
        [jfeatures.enabled(n) for n in names] == \
        [True, False, False, True, False]
    try:
        pfeatures.set_feature("MultiKueueClusterProfile", True)
        assert not jfeatures.enabled("MultiKueueClusterProfile")
    finally:
        pfeatures.reset()


def test_adapters_cover_the_same_kinds():
    from kueue_tpu.controllers import multikueue_adapters as ja
    from kueue_tpu_torch.controllers import multikueue_adapters as pa

    assert {k: (a.kind, a.status_fields)
            for k, a in pa.DEFAULT_ADAPTERS.items()} == \
        {k: (a.kind, a.status_fields) for k, a in ja.DEFAULT_ADAPTERS.items()}
