"""``kueue_tpu_torch/bench/serve_traced.py``: the deployed serve
process's traced schedule (``chip_smoke.py`` phase 28) and its untraced
control, on the CPU at ``serve_world.SMALL`` (20 ClusterQueues x 1,000
workloads, 40 arrivals).

Both arms end in the same final state, with every arrival admitted on
the SSE stream; the traced arm's ``/debug/trace``, SIGTERM line and
journal count the same traced cycles, and its stream carries one
``cycle_trace`` event for each cycle traced after the client joined; the
untraced arm traces nothing. ``summary`` reads both.
"""

import pytest

from kueue_tpu_torch.bench import serve_traced as st
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.store import journal


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_traced")
    seed = work / "seed.jsonl"
    sw.seed_journal(seed, sw.SMALL)
    bodies = sw.arrival_bodies(sw.SMALL)
    return {arm: st.run(seed, work, bodies, flags, arm, device="cpu")
            for arm, flags in (("untraced", ()),
                               ("traced", st.TRACE_FLAGS))}


def _arrivals_admitted(r):
    return {d["workload"] for k, d in r["stream"] if k == "Admitted"
            and d["workload"].startswith("default/arrival-")}


def test_both_arms_decide_alike(runs):
    u, t = runs["untraced"], runs["traced"]
    for r in (u, t):
        assert set(r["posted"]["codes"]) == {201}
        assert (r["rc"], r["side_rc"]) == (0, 0)
        assert len(_arrivals_admitted(r)) == sw.SMALL["arrivals"]
    assert sw.final_state(*u["views"]) == sw.final_state(*t["views"])
    assert sw.final_state(*t["views"])["arrivals_admitted"] == \
        sw.SMALL["arrivals"]


def test_traced_counts_agree(runs):
    t = runs["traced"]
    records = sum(1 for rec in journal.read_records(str(t["path"]))
                  if rec.get("kind") == "cycle_trace")
    traces = [d for k, d in t["stream"] if k == "cycle_trace"]
    assert t["trace"]["cyclesTraced"] == t["last"]["cycles_traced"] \
        == records > 0
    assert len(traces) == records - t["traced0"] > 0
    assert t["perf"] == {"enabled": False}
    assert t["slo"]["ladder"]["rung"] == 0
    assert t["slo"]["watchdog"]["state"] == "closed"


def test_untraced_traces_nothing(runs):
    u = runs["untraced"]
    assert u["traced0"] is None and u["last"]["cycles_traced"] == 0
    assert u["trace"] == {"enabled": False, "cycles": []}
    assert not any(k == "cycle_trace" for k, _d in u["stream"])
    assert not any(rec.get("kind") == "cycle_trace"
                   for rec in journal.read_records(str(u["path"])))


def test_summary(runs):
    u, t = (st.summary(runs[a]) for a in ("untraced", "traced"))
    for row in (u, t):
        assert 0 < row["post_p50_s"] <= row["post_p95_s"] <= row["post_max_s"]
        assert row["device_cycles"] > 0 and row["wall_per_device_cycle_s"] > 0
        assert set(row["loop_s"]) >= {"schedule_once", "lock_wait"}
    assert u["traced_cycle_p50_s"] is None
    assert 0 < t["traced_cycle_p50_s"] <= t["traced_cycle_p95_s"]
