"""The port's read plane (kueue_tpu_torch/readplane: queries, the read
replica, the front end, and the endpoint's ``/read/*`` routes) against
the JAX package's.

``tests/test_readplane.py``'s cases run on the port: that file's module
globals (its API types, ``Engine``, the tailer, the read SLO engine, the
read-plane classes and functions, the journal functions) are pointed at
the port's, engines on ``device="cpu"``, and the endpoint and registry
its HTTP cases import inside their bodies too, and the ``kueuectl
run`` its explain-provenance case imports (the port's, rendering the
port's rebuilt engine). Beside them: on one
journal (a backlog past quota), the port's
``canonical_answer`` of its rebuilt engine and of a read replica's tail
is byte-equal to the JAX package's, and so is every ``answer_query``
kind; the same stamped query surface is served over HTTP. A quiet poll
re-stamps a current read model, where the JAX tailer stamps only its
rebuilds. Exact throughout."""

import functools

import pytest

import test_readplane as ref
from kueue_tpu.readplane import queries as jqueries
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch import readplane as preadplane
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.ha import digest as pdigest
from kueue_tpu_torch.ha import tailer as ptailer
from kueue_tpu_torch.metrics import registry as pregistry
from kueue_tpu_torch.obs import slo as pslo
from kueue_tpu_torch.readplane import queries as pqueries
from kueue_tpu_torch.store import journal as pjournal
from kueue_tpu_torch.visibility import http_server as phttp
from kueue_tpu_torch.bench import serve_world as sw
from test_torch_ha import JAX, leader_journal
from test_torch_journal import aligned_uids

CPU = {"device": "cpu"}


def port_globals(mp) -> None:
    for name, obj in list(vars(ref).items()):
        if getattr(obj, "__module__", None) == "kueue_tpu.api.types":
            mp.setattr(ref, name, getattr(ptypes, name))
    mp.setattr(ref, "Engine", lambda: PEngine(device="cpu"))
    mp.setattr(ref, "admitted_state_digest", pdigest.admitted_state_digest)
    mp.setattr(ref, "JournalTailer",
               functools.partial(ptailer.JournalTailer, engine_kwargs=CPU))
    mp.setattr(ref, "ReadSLOEngine", pslo.ReadSLOEngine)
    for name in ("QUERY_KINDS", "ReadFrontend", "answer_query",
                 "canonical_answer"):
        mp.setattr(ref, name, getattr(preadplane, name))
    mp.setattr(ref, "ReadReplica",
               functools.partial(preadplane.ReadReplica, engine_kwargs=CPU))
    mp.setattr(ref, "Journal", pjournal.Journal)
    mp.setattr(ref, "attach_new_journal", pjournal.attach_new_journal)
    mp.setattr(ref, "rebuild_engine",
               functools.partial(pjournal.rebuild_engine, device="cpu"))
    import kueue_tpu.metrics.registry as jregistry
    import kueue_tpu.visibility.http_server as jhttp
    mp.setattr(jhttp, "ServingEndpoint", phttp.ServingEndpoint)
    mp.setattr(jregistry, "MetricsRegistry", pregistry.MetricsRegistry)
    import kueue_tpu.cli.kueuectl as jkueuectl

    from kueue_tpu_torch.cli import kueuectl as pkueuectl
    mp.setattr(jkueuectl, "run", pkueuectl.run)


@pytest.fixture
def on_port(monkeypatch):
    port_globals(monkeypatch)


REFERENCE_CASES = [
    "test_tailer_position_tracks_journal_position",
    "test_tailer_follows_across_segment_rotation",
    "test_tailer_resyncs_on_compaction_lineage_bump",
    "test_canonical_answer_byte_identical_after_rebuild",
    "test_pending_answer_ignores_backoff_parking",
    "test_replica_query_stamps_staleness_envelope",
    "test_replica_answers_before_first_rebuild_degrade",
    "test_replica_cid_rides_the_tail",
    "test_replica_explain_matches_leader",
    "test_frontend_routes_to_freshest_replica",
    "test_frontend_degrades_past_dead_replica",
    "test_frontend_raises_only_when_all_dead",
    "test_frontend_replica_without_model_ranks_last_but_routable",
    "test_read_slo_none_staleness_is_a_violation",
    "test_http_read_surface_and_write_rejection",
    "test_leader_counts_read_queries_for_zero_read_proof",
    "test_explain_on_rebuilt_engine_stamps_journal_position",
]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case_on_the_port(on_port, name, tmp_path):
    fn = getattr(ref, name)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


@pytest.fixture(scope="module")
def backlog(tmp_path_factory):
    """One JAX leader's journal with a backlog past quota (10 of the 20
    workloads admitted, the others pending), and the JAX package's
    answers on its rebuild: (path, canonical bytes, {kind: answer})."""
    d = tmp_path_factory.mktemp("readplane")
    path = d / "j.jsonl"
    with aligned_uids():
        leader_journal(JAX, path, waves=((4, 0), (12, 4), (4, 50)))
    eng = jjournal.rebuild_engine(str(d / "j.jsonl"))
    eng.journal.close()
    keys = sorted(eng.workloads)
    answers = {("position", "cq0"): jqueries.answer_query(eng, "position",
                                                          "cq0"),
               ("quota", None): jqueries.answer_query(eng, "quota"),
               ("pending", None): jqueries.answer_query(eng, "pending"),
               ("explain", keys[0]): jqueries.answer_query(
                   eng, "explain", keys[0]),
               ("explain", keys[-1]): jqueries.answer_query(
                   eng, "explain", keys[-1])}
    return path, jqueries.canonical_answer(eng), answers


def test_canonical_answer_equals_jax(backlog):
    path, want, answers = backlog
    eng = pjournal.rebuild_engine(str(path), device="cpu")
    eng.journal.close()
    assert pqueries.canonical_answer(eng) == want
    assert answers[("pending", None)]["pending"]["cq0"]
    for (kind, arg), answer in answers.items():
        assert pqueries.answer_query(eng, kind, arg) == answer


def test_replica_tail_answers_equal_jax(backlog):
    path, want, answers = backlog
    replica = preadplane.ReadReplica(str(path), replica_id="r",
                                     engine_kwargs=CPU)
    assert replica.poll() > 0
    assert pqueries.canonical_answer(replica.engine) == want
    for (kind, arg), answer in answers.items():
        out = replica.query(kind, arg)
        assert out["answer"] == answer
        assert out["staleness"]["lagRecords"] == 0


def test_http_answers_equal_jax(backlog):
    path, _want, answers = backlog
    replica = preadplane.ReadReplica(str(path), replica_id="r",
                                     engine_kwargs=CPU)
    replica.poll()
    ep = phttp.ServingEndpoint(lambda: replica.engine, port=0,
                               hub=replica.hub, readplane=replica)
    ep.start()
    try:
        url = f"http://127.0.0.1:{ep.port}"
        for (kind, arg), answer in answers.items():
            route = f"/read/{kind}" + (f"/{arg}" if arg else "")
            got = sw.get_json(url, route)
            assert got["answer"] == answer
            assert got["staleness"]["replica"] == "r"
        assert sw.get_json(url, "/debug/readplane")["queries"] == len(
            answers)
        text = sw.get_text(url, "/metrics")[0]
        assert sw.metric_values(text, "visibility_queries_total") == {
            ("read",): float(len(answers))}
    finally:
        ep.stop()


def test_quiet_poll_restamps_the_read_model(backlog):
    """A poll that finds no new record while nothing is unfolded
    re-stamps the read model as current (the port's tailer; the JAX
    tailer stamps only rebuilds, so a quiet journal, such as an HA
    failover's window, ages the answers of its read replicas)."""
    from kueue_tpu.ha import tailer as jtailer

    path = str(backlog[0])
    now = {"t": 100.0}
    clock = lambda: now["t"]  # noqa: E731
    pt = ptailer.JournalTailer(path, rebuild_every=1, clock=clock,
                               engine_kwargs=CPU)
    jt = jtailer.JournalTailer(path, rebuild_every=1, clock=clock)
    assert pt.poll() == jt.poll() > 0
    assert pt.applied_at == jt.applied_at == 100.0
    now["t"] = 160.0
    assert pt.poll() == jt.poll() == 0
    assert pt.applied_at == 160.0 and jt.applied_at == 100.0
    assert pt.rebuilds == jt.rebuilds == 1
    assert pt.applied_position == jt.applied_position
