"""The port's ``kueuectl`` (kueue_tpu_torch/cli/kueuectl.py) against the
JAX package's.

The six ``kueuectl`` cases of ``tests/test_cli_webhooks.py`` run twice,
on the JAX package and on the port (``test_torch_client.run_case``: the
module's globals and the names its cases import inside their bodies
pointed at the port's, ``rebuild_engine`` on the CPU), and every engine
they build must end in the same world. Beyond that file, on one input
each: the parser takes every verb of the JAX parser but ``lint`` and
``sim``; ``kueuectl cells`` folds a route journal that the port's
federation dispatcher wrote to the JAX CLI's text and JSON; ``trace
export --input`` of one flight-recorder trace writes the JAX CLI's
events; ``record`` on a journal and then ``replay --mode both`` give
both packages the same cycles and digest, each replaying the other's
trace too; ``main --device cpu`` renders what the JAX ``main`` does, and
without ``--device`` the port's ``main`` asks for CUDA. Exact
throughout."""

import functools
import json
import re
import shutil

import pytest
import torch

import test_cli_webhooks
from kueue_tpu.cli import kueuectl as jk
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.cli import kueuectl as pk
from kueue_tpu_torch.store import journal as pjournal
from test_torch_client import run_case
from test_torch_journal import aligned_uids

IN_BODY = {"kueue_tpu.cli.kueuectl": ("run",),
           "kueue_tpu.store.journal": ("attach_new_journal",)}
CASES = ["test_cli_create_and_list_flow", "test_cli_stop_resume_workload",
         "test_cli_stop_cluster_queue_holds_admission",
         "test_cli_create_describe_pods_and_delete",
         "test_stopped_local_queue_blocks_admission_until_resume",
         "test_cli_journal_tombstones"]


def _run_cli_case(case, pkg, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        if pkg == "port":
            mp.setattr(jjournal, "rebuild_engine", functools.partial(
                pjournal.rebuild_engine, device="cpu"))
        return run_case(test_cli_webhooks, case, pkg, tmp_path, IN_BODY)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {c: _run_cli_case(c, "jax", tmp_path_factory.mktemp("jax"))
            for c in CASES}


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(jax_runs, case, tmp_path):
    got = _run_cli_case(case, "port", tmp_path)
    assert got == jax_runs[case]


def _verbs(parser) -> dict:
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {name: sorted(a.dest for a in p._actions)
            for name, p in sub.choices.items()}


def test_parser_takes_every_jax_verb_but_lint_and_sim():
    want = _verbs(jk.build_parser())
    for left_out in ("lint", "sim"):
        want.pop(left_out)
    assert _verbs(pk.build_parser()) == want
    assert pk.VERSION == jk.VERSION


# -- cells offline on the port dispatcher's route journal --

def _route_journal(tmp_path) -> str:
    """A route journal from the port's dispatcher: 12 submits over three
    cells, confirmed, then cell ``c`` unreachable until its breaker
    fences it and its routes drain to the survivors."""
    import test_federation as ref
    from kueue_tpu_torch.federation.cells import (
        CellHandle,
        CellTransportError,
    )
    from kueue_tpu_torch.federation.dispatcher import FederationDispatcher

    class Transport(ref.FakeCellTransport):
        def _gate(self):
            if not self.reachable:
                raise CellTransportError(f"{self.name} unreachable")

    tr = {n: Transport(n) for n in "abc"}
    path = str(tmp_path / "routes.jsonl")
    disp = FederationDispatcher(
        path, [CellHandle(n, tr[n], probe_interval_ticks=1,
                          breaker_threshold=2, breaker_cooldown_ticks=2)
               for n in "abc"], confirm_interval_ticks=1)
    disp.tick(0.0)
    for i in range(12):
        disp.submit(ptypes.Workload(
            name=f"w{i}", queue_name="lq0",
            pod_sets=(ptypes.PodSet("main", 1, {"cpu": 100}),)), now=0.0)
    for _ in range(2):
        disp.tick(0.0)
    tr["c"].reachable = False
    for _ in range(4):
        disp.tick(0.0)
    disp.journal.close()
    return path


def test_cells_offline_folds_the_port_dispatchers_journal(tmp_path, capsys):
    path = _route_journal(tmp_path)
    out = {}
    for pkg in ("jax", "port"):
        copy = str(tmp_path / f"{pkg}.jsonl")
        shutil.copy(path, copy)
        if pkg == "jax":
            eng = jjournal.rebuild_engine(copy)
            out[pkg] = [jk.run(eng, ["cells"]),
                        jk.run(eng, ["cells", "--json"])]
        else:
            eng = pjournal.rebuild_engine(copy, device="cpu")
            out[pkg] = [pk.run(eng, ["cells"]),
                        pk.run(eng, ["cells", "--json"])]
        eng.journal.close()
    assert out["port"] == out["jax"]
    status = json.loads(out["port"][1])
    assert status["offline"] and sum(status["routes"].values()) == 12
    assert {c["name"] for c in status["cells"]} == {"a", "b", "c"}
    assert [c["epoch"] for c in status["cells"] if c["name"] == "c"] \
        != [1]
    copy = str(tmp_path / "main.jsonl")
    shutil.copy(path, copy)
    pk.main(["--journal", copy, "--device", "cpu", "cells", "--json"])
    assert json.loads(capsys.readouterr().out) == status


# -- a small world recorded and replayed --

def _small_world(t, engine):
    eng = engine()
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    for i in range(4):
        eng.create_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", cohort="co", resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas("default", {"cpu": t.ResourceQuota(
                    3000)}),)),)))
        eng.create_local_queue(t.LocalQueue(f"lq{i}", "default", f"cq{i}"))
    for i in range(40):
        eng.clock += 0.5
        eng.submit(t.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", priority=i % 3,
            pod_sets=(t.PodSet("main", 1, {"cpu": 500 + 250 * (i % 5)}),)))
    return eng


@pytest.fixture(scope="module")
def journal_path(tmp_path_factory):
    """A journal of the small world, written by the port (uids from a
    fixed value)."""
    from kueue_tpu_torch.controllers.engine import Engine

    path = str(tmp_path_factory.mktemp("journal") / "world.jsonl")
    with aligned_uids():
        eng = _small_world(ptypes, lambda: Engine(device="cpu"))
    pjournal.attach_new_journal(eng, path)
    eng.journal.close()
    return path


def _main(mod, argv, capsys) -> str:
    mod.main(argv)
    return capsys.readouterr().out


def test_record_then_replay_both_equal_across_packages(journal_path,
                                                      tmp_path, capsys):
    traces, lines = {}, {}
    for pkg, mod, extra in (("jax", jk, []), ("port", pk,
                                              ["--device", "cpu"])):
        journal = str(tmp_path / f"{pkg}.jsonl")
        shutil.copy(journal_path, journal)
        traces[pkg] = str(tmp_path / f"{pkg}.trace.jsonl")
        lines[pkg] = _main(mod, ["--journal", journal, *extra, "record",
                                 traces[pkg]], capsys)
    pat = r"recorded (\d+) cycle\(s\) -> .* \(digest (\w+)\)"
    got = {pkg: re.fullmatch(pat, line.strip()).groups()
           for pkg, line in lines.items()}
    assert got["port"] == got["jax"] and int(got["port"][0]) > 1
    digest = got["port"][1]
    for trace in traces.values():
        got = {}
        for pkg, mod, extra in (("jax", jk, []), ("port", pk,
                                                  ["--device", "cpu"])):
            text = _main(mod, [*extra, "replay", trace, "--mode", "both"],
                         capsys)
            got[pkg] = [ln for ln in text.splitlines()
                        if ln.startswith(("cycles", "digest", "verdict"))]
        assert got["port"] == got["jax"]
        assert f"recorded={digest} replayed={digest}" in got["port"][1]
        assert got["port"][2] == "verdict  BYTE-IDENTICAL"


def test_trace_export_of_one_trace_equal(journal_path, tmp_path):
    from kueue_tpu.controllers.engine import Engine as JEngine
    from kueue_tpu_torch.controllers.engine import Engine as PEngine

    journal = str(tmp_path / "w.jsonl")
    shutil.copy(journal_path, journal)
    trace = str(tmp_path / "t.jsonl")
    eng = pjournal.rebuild_engine(journal, device="cpu")
    pk.run(eng, ["record", trace])
    eng.journal.close()
    out = {}
    for pkg, run, eng in (("jax", jk.run, JEngine()),
                          ("port", pk.run, PEngine(device="cpu"))):
        dest = str(tmp_path / f"{pkg}.perfetto.json")
        out[pkg] = (run(eng, ["trace", "export", "--input", trace, "--out",
                              dest]).replace(dest, "OUT"),
                    json.load(open(dest)))
    assert out["port"] == out["jax"]
    assert out["port"][0].startswith("exported ")


def test_main_device_flag(journal_path, tmp_path, capsys):
    got = _main(pk, ["--device", "cpu", "version"], capsys)
    assert got == _main(jk, ["version"], capsys)
    for argv in (["list", "workloads"], ["list", "clusterqueues"],
                 ["describe", "workload", "w3"], ["explain", "w39"]):
        want_j = str(tmp_path / "j.jsonl")
        want_p = str(tmp_path / "p.jsonl")
        shutil.copy(journal_path, want_j)
        shutil.copy(journal_path, want_p)
        want = _main(jk, ["--journal", want_j, *argv], capsys)
        got = _main(pk, ["--journal", want_p, "--device", "cpu", *argv],
                    capsys)
        if argv[0] == "explain":  # the rebuild's wall-clock staleness
            want, got = (
                [ln for ln in s.splitlines() if "stale" not in ln]
                for s in (want, got))
        assert got == want, argv
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pk.main(["version"])
