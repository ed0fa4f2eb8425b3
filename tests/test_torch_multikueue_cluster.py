"""MultiKueue cluster connectivity in the port
(controllers/multikueue_cluster.py: RemoteClient, the retry_after
backoff, kubeconfig hot-reload, ClusterProfile sources, origin-labeled
orphan GC) against the JAX package.

The 8 cases of tests/test_multikueue_cluster.py run twice, as
tests/test_torch_multikueue.py runs test_multikueue.py's: on the JAX
package and on the port (module globals and in-body imports pointed at
the port's, engines on the CPU, uid counters aligned), each in a
directory of its own for its kubeconfig files. The port run passes the
case's own assertions, every engine ends in the same world, and every
controller with the same remote state, connection state and dispatch
series. The JAX runs are shared through a module fixture. Exact."""

import pytest

import test_multikueue_cluster
import test_torch_multikueue as tm
import test_torch_resources as tr

CASES = tr.cases_of(test_multikueue_cluster)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {c: tm.run_case(test_multikueue_cluster, c, "jax",
                           tmp_path_factory.mktemp(f"jax-{c}"))
            for c in CASES}


def test_every_reference_case_is_held():
    assert len(CASES) == 8


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(jax_runs, case, tmp_path):
    got, got_mk = tm.run_case(test_multikueue_cluster, case, "port",
                              tmp_path)
    want, want_mk = jax_runs[case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    pm, jm = got_mk["MultiKueueController"], want_mk["MultiKueueController"]
    assert len(pm) == len(jm)
    for p, j in zip(pm, jm):
        assert tm.controller_state(p) == tm.controller_state(j)


def test_retry_after_curve_equals_the_jax_one():
    from kueue_tpu.controllers import multikueue_cluster as jc
    from kueue_tpu_torch.controllers import multikueue_cluster as pc

    for inc in (0.25, 1.0, 3.0):
        assert [pc.retry_after(n, inc) for n in range(0, 12)] == \
            [jc.retry_after(n, inc) for n in range(0, 12)]
    assert pc.ORIGIN_LABEL == jc.ORIGIN_LABEL
