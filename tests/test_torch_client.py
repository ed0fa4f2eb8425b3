"""The port's client layer (kueue_tpu_torch/client: the clientset,
informers, listers, server-side apply and the remote client),
``utils/parallelize.py``, ``utils/cert.py`` and the endpoint's TLS
against the JAX package's.

These reference cases run twice, as they are on the JAX package and on
the port: the 4 of ``tests/test_client.py``, ``TestListers`` and
``TestApplyConfigurations`` of ``tests/test_client_extensions.py``, the
8 of ``tests/test_parallelize.py`` and the 3 of
``tests/test_serving_hardening.py`` (bearer token, TLS, TLS with a
token). On the port, the case's module globals point at the port's
(``test_torch_resources.port_of``: API types, the client modules, the
endpoint, ``until``), its ``Engine`` at a port engine on the CPU, and
the names it imports inside its body at the port's. Both runs start the
uid counters at one value; the port run passes the case's own
assertions, and every engine the two runs build must end in the same
world (workloads, outcomes, events). The JAX runs are shared through a
module fixture. Exact throughout."""

import importlib

import pytest

import test_client
import test_client_extensions
import test_parallelize
import test_serving_hardening
from kueue_tpu.api import types as jtypes
from kueue_tpu.controllers import jobframework as jjf
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers import jobframework as pjf
from test_torch_resources import (
    _jax_engine,
    _port_engine,
    aligned_counters,
    port_name,
    port_of,
    world,
)

# Names the cases import inside their bodies, by the JAX module they
# import them from.
IN_BODY = {
    "kueue_tpu.api.types": (
        "ClusterQueue", "FlavorQuotas", "LocalQueue", "PodSet",
        "ResourceFlavor", "ResourceGroup", "ResourceQuota", "StopPolicy",
        "Workload"),
    "kueue_tpu.client.applyconfigurations": ("LocalQueueApply",),
    "kueue_tpu.client.http_client": ("RemoteClient",),
    "kueue_tpu.visibility.http_server": ("ServingEndpoint",),
}


def port_globals(mp, module, built, in_body=IN_BODY) -> None:
    """Point ``module``'s globals at the port (``mp`` a MonkeyPatch),
    its ``Engine`` (and the one a case imports in its body) at a port
    engine on the CPU appended to ``built``, and the names ``in_body``
    lists at the port's."""
    make = _port_engine(built)
    for name, obj in list(vars(module).items()):
        if name == "Engine":
            mp.setattr(module, name, make)
            continue
        ported = port_of(obj)
        if ported is not None:
            mp.setattr(module, name, ported)
    if not hasattr(module, "Engine"):
        mp.setattr(importlib.import_module("kueue_tpu.controllers.engine"),
                   "Engine", make)
    for jname, names in in_body.items():
        jmod = importlib.import_module(jname)
        pmod = importlib.import_module(port_name(jname))
        for name in names:
            mp.setattr(jmod, name, getattr(pmod, name))


def call(module, case: str, tmp_path) -> None:
    """Run one case of ``module`` (``test_x`` or ``Class.test_x``),
    handing it ``tmp_path`` when it takes one."""
    owner, _, name = case.rpartition(".")
    fn = getattr(getattr(module, owner)(), name) if owner \
        else getattr(module, name)
    code = fn.__code__
    if "tmp_path" in code.co_varnames[:code.co_argcount]:
        fn(tmp_path)
    else:
        fn()


def run_case(module, case: str, pkg: str, tmp_path, in_body=IN_BODY
             ) -> list:
    """Run ``case`` of ``module`` on ``pkg`` ("jax" or "port"); returns
    the world of every engine it built."""
    built: list = []
    with pytest.MonkeyPatch.context() as mp:
        if pkg == "port":
            port_globals(mp, module, built, in_body)
            counters = aligned_counters(ptypes, pjf)
        else:
            make = _jax_engine(built)
            if hasattr(module, "Engine"):
                mp.setattr(module, "Engine", make)
            else:  # its cases import Engine inside their bodies
                mp.setattr(importlib.import_module(
                    "kueue_tpu.controllers.engine"), "Engine", make)
            counters = aligned_counters(jtypes, jjf)
        with counters:
            call(module, case, tmp_path)
    return [world(e) for e in built]


MODULES = {"client": test_client,
           "client_extensions": test_client_extensions,
           "parallelize": test_parallelize,
           "serving_hardening": test_serving_hardening}
CASES = (
    [("client", c) for c in (
        "test_clientset_crud_and_lifecycle",
        "test_informer_replays_and_follows",
        "test_remote_client_against_endpoint", "test_dashboard_served")]
    + [("client_extensions",
        "TestListers.test_workload_indices_and_selectors")]
    + [("client_extensions", f"TestApplyConfigurations.{c}") for c in (
        "test_field_ownership_and_conflict",
        "test_queue_move_requeues_pending",
        "test_priority_apply_rekeys_pending_entry",
        "test_queue_move_to_missing_queue_rejected_upfront",
        "test_failed_apply_grants_no_ownership",
        "test_priority_apply_survives_deleted_queue",
        "test_invalid_stop_policy_rejected_not_resumed",
        "test_stop_policy_apply_retracts_pending",
        "test_cluster_queue_apply_upserts_spec")]
    + [("parallelize", c) for c in (
        "TestErrorChannel.test_keeps_first_error",
        "TestErrorChannel.test_none_is_ignored",
        "TestUntil.test_runs_all_pieces", "TestUntil.test_worker_cap",
        "TestUntil.test_first_error_returned",
        "TestUntil.test_cancel_stops_new_pieces",
        "TestUntil.test_zero_pieces", "test_remote_client_fanout")]
    + [("serving_hardening", c) for c in (
        "test_bearer_token_auth", "test_tls_serving_with_generated_cert",
        "test_tls_plus_token")])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {(m, c): run_case(MODULES[m], c, "jax",
                             tmp_path_factory.mktemp("jax"))
            for m, c in CASES}


def test_every_listed_case_exists():
    assert len(CASES) == 25
    for m, c in CASES:
        owner, _, name = c.rpartition(".")
        obj = getattr(MODULES[m], owner) if owner else MODULES[m]
        assert callable(getattr(obj, name)), c


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m}.{c}" for m, c in CASES])
def test_reference_case_on_the_port(jax_runs, module, case, tmp_path):
    got = run_case(MODULES[module], case, "port", tmp_path)
    want = jax_runs[module, case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_tls_endpoint_serves_what_a_plain_one_does(tmp_path):
    """``ServingEndpoint(cert_dir=)`` on the port: ``tls`` is set, the
    generated pair is the JAX package's layout (``tls.crt``,
    ``tls.key`` at 0600, reused on the next start), and a client that
    trusts the certificate reads the same ``/clusterqueues`` as a plain
    endpoint over the same engine."""
    import json
    import os
    import ssl
    import urllib.request

    from kueue_tpu_torch.api import types as t
    from kueue_tpu_torch.controllers.engine import Engine
    from kueue_tpu_torch.visibility.http_server import ServingEndpoint

    eng = Engine(device="cpu")
    eng.create_resource_flavor(t.ResourceFlavor("d"))
    eng.create_cluster_queue(t.ClusterQueue(name="cq", resource_groups=(
        t.ResourceGroup(("cpu",), (t.FlavorQuotas(
            "d", {"cpu": t.ResourceQuota(1000)}),)),)))
    cert_dir = str(tmp_path / "certs")
    tls, plain = ServingEndpoint(eng, cert_dir=cert_dir), \
        ServingEndpoint(eng)
    assert tls.tls and not plain.tls
    crt = os.path.join(cert_dir, "tls.crt")
    key = os.path.join(cert_dir, "tls.key")
    assert os.stat(key).st_mode & 0o777 == 0o600
    first = open(crt, "rb").read()
    tls.start()
    plain.start()
    try:
        ctx = ssl.create_default_context(cafile=crt)
        ctx.check_hostname = False
        got = json.loads(urllib.request.urlopen(
            f"https://127.0.0.1:{tls.port}/clusterqueues", context=ctx,
            timeout=5).read())
        want = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{plain.port}/clusterqueues",
            timeout=5).read())
        assert got == want and got[0]["name"] == "cq"
    finally:
        tls.stop()
        plain.stop()
    again = ServingEndpoint(eng, cert_dir=cert_dir)
    again.httpd.server_close()
    assert open(crt, "rb").read() == first


def test_cert_is_made_lazily():
    """``utils/cert`` imports ``cryptography`` only inside
    ``generate_self_signed``: importing the module, or the endpoint,
    loads none of it."""
    import subprocess
    import sys

    probe = ("import sys\n"
             "import kueue_tpu_torch.utils.cert\n"
             "import kueue_tpu_torch.visibility.http_server\n"
             "import kueue_tpu_torch.client\n"
             "assert not [m for m in sys.modules "
             "if m.startswith('cryptography')]\n"
             "print('lazy')\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60)
    assert out.stdout.strip() == "lazy", out.stderr
