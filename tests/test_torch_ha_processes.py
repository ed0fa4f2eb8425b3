"""The port's HA serving plane and read plane as processes on the CPU
(``python -m kueue_tpu_torch.serve --ha`` and ``--read-replica``,
``--device cpu``), against the JAX package computed in this process.

The failover arm is ``tools/ha_smoke.py``'s sigkill arm on its world
(40 workloads journaled pending by the JAX package, 12 more POSTed):
leader A drains the 40, takes the 12 over POST and SIGKILLs itself at
the 52nd admission (``sigkill@admission:52``), after a real
``ha_digest`` checkpoint; follower B takes the lease at expiry and
promotes at epoch 2 on the prefix-replay path (the partial cycle's
durable records adopted). B's final ``admitted_state_digest`` equals
the JAX control arm's (``ha_smoke.control_arm``). A read replica R on
the same journal, reached only through a ``ReadFrontend``, answers with
staleness stamps within ``readplane_smoke.STALENESS_BOUND_S`` before
and after the kill, and once its tail drains its ``canonical_answer``
is byte-equal to the JAX package's of a cold rebuild of the final
journal. A and B serve no read query (no ``visibility_queries_total``
sample in their ``/metrics``). The lease-stall arm is on
``tools/readplane_smoke.py``'s world (40 + 24): leader A stops renewing
(``lease-stall@cycle:1``), B takes the lease, and A's next write (a
POST) dies on JournalFenced: A fences and answers 503 naming B, and
nothing of it reaches the journal; B takes the 24 and ends in the JAX
control's state. Every child is stopped by its role (SIGTERM: rc 0 and
a JSON line; the killed leader: rc -SIGKILL); at the end no descendant
of this process is alive (``/proc``), and a start helper that times out
leaves no child either."""

import dataclasses
import importlib.util
import json
import shutil
import signal
import time
from pathlib import Path

import pytest

from kueue_tpu.api import serde as jserde
from kueue_tpu.ha import digest as jdigest
from kueue_tpu.readplane import queries as jqueries
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch.bench import serve_world as sw
from kueue_tpu_torch.store.journal import read_records

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ha_smoke = _tool("ha_smoke")
readplane_smoke = _tool("readplane_smoke")
LEASE_S = 1.5
BOUND_S = readplane_smoke.STALENESS_BOUND_S


def _bodies(workloads):
    return [json.dumps(jserde.to_jsonable(w)).encode() for w in workloads]


def _wait_ha(url, pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        st = sw.get_json(url, "/debug/ha")
        if pred(st):
            return st
        if time.monotonic() > deadline:
            raise TimeoutError(f"/debug/ha never matched: {st}")
        time.sleep(0.1)


def _read_samples(metrics_text):
    return sw.metric_lines(metrics_text, "visibility_queries_total")


def _failover(work):
    seed = work / "seed.jsonl"
    ha_smoke.seed_journal(str(seed))
    control = ha_smoke.control_arm(str(seed), str(work))
    journal = work / "fo.jsonl"
    shutil.copy(seed, journal)
    wave2 = _bodies(ha_smoke.scenario().workloads[ha_smoke.N_WORKLOADS:])
    total = ha_smoke.N_WORKLOADS + ha_smoke.N_WAVE2
    out = {"control": control, "journal": journal}
    a, aurl, _ = sw.start_ha(journal, "a", "off", "cpu", LEASE_S,
                             fault=f"sigkill@admission:{total}",
                             timeout=120)
    a.wait_line("ha: role=leader epoch=1", 60)
    _wait_ha(aurl, lambda s: s.get("stateDigest")
             == control["wave1"]["digest"])
    b, burl, _ = sw.start_ha(journal, "b", "off", "cpu", LEASE_S,
                             timeout=120)
    r, rurl, _ = sw.start_read_replica(journal, "r", "cpu", timeout=120)
    out["b_follower"] = _wait_ha(burl, lambda s: s["role"] == "follower")
    deadline = time.monotonic() + 60
    while sw.get_json(rurl, "/debug/readplane")["staleness"] is None:
        assert time.monotonic() < deadline, "no read model"
        time.sleep(0.05)
    reader = sw.ReadPoller([rurl], 0.2)
    reader.start()
    # The wave kills A within a fraction of a second: let R answer once
    # before it, or the reads before the kill race A's death.
    deadline = time.monotonic() + 60
    while not reader.answers and not reader.errors:
        assert time.monotonic() < deadline, "no read answer"
        time.sleep(0.05)
    out["a_metrics"] = sw.get_text(aurl, "/metrics")[0]
    out["a_codes"] = [sw.post(aurl, "/workloads", body)[0]
                      for body in wave2]
    out["a_rc"] = a.p.wait(60)
    out["killed_at"] = time.time()
    a.stop()
    b.wait_line("ha: role=leader epoch=2", 60)
    out["b_codes"] = [sw.post(burl, "/workloads", body)[0]
                      for body in wave2]
    out["b_status"] = _wait_ha(
        burl, lambda s: s.get("stateDigest") == control["wave2"]["digest"])
    out["b_metrics"] = sw.get_text(burl, "/metrics")[0]
    out["b_stop"] = b.stop()
    deadline = time.monotonic() + 60
    size = journal.stat().st_size
    while True:
        st = sw.get_json(rurl, "/debug/readplane")
        env = st.get("staleness") or {}
        if env.get("lagRecords") == 0 and st["tailer"]["recordsSeen"] \
                == sum(1 for _ in read_records(str(journal))) and \
                journal.stat().st_size == size:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"read replica never drained: {st}")
        time.sleep(0.1)
    reader.stop()
    out["reader"] = reader
    out["r_reads"] = {k: sw.get_json(rurl, f"/read/{k}")
                      for k in ("pending", "quota")}
    out["r_stop"] = r.stop()
    cold = work / "cold.jsonl"
    shutil.copy(journal, cold)
    eng = jjournal.rebuild_engine(str(cold))
    eng.journal.close()
    out["cold"] = {"digest": jdigest.admitted_state_digest(eng),
                   "canonical": jqueries.canonical_answer(eng),
                   "answers": {k: jqueries.answer_query(eng, k)
                               for k in ("pending", "quota")}}
    return out


def _lease_stall(work):
    seed = work / "rp-seed.jsonl"
    readplane_smoke.seed_journal(str(seed))
    n_seed = readplane_smoke.N_SEED
    storm = readplane_smoke.scenario().workloads[n_seed:]
    shutil.copy(seed, work / "ls-control.jsonl")
    control = jjournal.rebuild_engine(str(work / "ls-control.jsonl"))
    for wl in storm:
        control.clock += 0.001
        control.submit(wl)
    while control.schedule_once() is not None:
        pass
    journal = work / "ls.jsonl"
    shutil.copy(seed, journal)
    out = {"control": jdigest.admitted_state_digest(control)}
    a, aurl, _ = sw.start_ha(journal, "a", "off", "cpu", LEASE_S,
                             fault="lease-stall@cycle:1", timeout=120)
    a.wait_line("ha: role=leader epoch=1", 60)
    b, burl, _ = sw.start_ha(journal, "b", "off", "cpu", LEASE_S,
                             timeout=120)
    b.wait_line("ha: role=leader epoch=2", 60)
    stale = dataclasses.replace(storm[0], name="stale-0", uid="stale-0")
    out["stale_name"] = stale.name
    stale = _bodies([stale])[0]
    out["a_post"] = sw.post(aurl, "/workloads", stale)
    out["a_status"] = sw.get_json(aurl, "/debug/ha")
    out["b_codes"] = [sw.post(burl, "/workloads", body)[0]
                      for body in _bodies(storm)]
    out["b_status"] = _wait_ha(
        burl, lambda s: s.get("stateDigest") == out["control"])
    out["a_stop"] = a.stop()
    out["b_stop"] = b.stop()
    out["records"] = list(read_records(str(journal)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ha_proc")
    try:
        yield {"failover": _failover(work), "lease_stall": _lease_stall(work)}
    finally:
        sw.stop_all()


def test_leader_dies_by_its_fault(runs):
    fo = runs["failover"]
    assert fo["a_rc"] == -signal.SIGKILL
    assert set(fo["a_codes"]) == {201}
    assert fo["b_follower"]["role"] == "follower"


def test_follower_promotes_verified_on_the_prefix_path(runs):
    st = runs["failover"]["b_status"]
    promo = st["promotion"]
    assert st["role"] == "leader" and st["epoch"] == 2
    assert promo["verified"] and promo["partial_cycle"]
    assert promo["checkpoint_epoch"] == 1 and promo["checkpoint_seq"] >= 0
    assert "adopted partial-cycle" in promo["reason"]


def test_final_state_equals_the_jax_control_arm(runs):
    fo = runs["failover"]
    want = fo["control"]["wave2"]["digest"]
    assert fo["b_status"]["stateDigest"] == want
    assert fo["cold"]["digest"] == want
    assert set(fo["b_codes"]) <= {200, 201}
    assert fo["b_stop"][1]["role"] == "leader"


def test_read_replica_answers_stamped_within_the_bound(runs):
    fo = runs["failover"]
    reader = fo["reader"]
    assert not reader.errors
    before = [a for a in reader.answers if a[0] < fo["killed_at"]]
    after = [a for a in reader.answers if a[0] > fo["killed_at"]]
    assert before and after
    for _t, _kind, out, _s in reader.answers:
        assert "error" not in out
        age = out["staleness"]["wallAgeSeconds"]
        assert age is not None and age <= BOUND_S
        assert out["staleness"]["replica"] == "r"


def test_read_replica_equals_a_cold_jax_rebuild(runs):
    import hashlib

    fo = runs["failover"]
    rc, last = fo["r_stop"]
    assert rc == 0 and last["role"] == "read-replica"
    canonical = fo["cold"]["canonical"]
    assert last["canonical_sha256"] == hashlib.sha256(canonical).hexdigest()
    assert last["canonical_bytes"] == len(canonical)
    assert last["state_digest"] == fo["cold"]["digest"]
    for kind, answer in fo["cold"]["answers"].items():
        assert fo["r_reads"][kind]["answer"] == answer


def test_leaders_serve_no_reads(runs):
    fo = runs["failover"]
    assert _read_samples(fo["a_metrics"]) == []
    assert _read_samples(fo["b_metrics"]) == []


def test_sigterm_ends_each_replica_with_its_line(runs):
    fo, ls = runs["failover"], runs["lease_stall"]
    for rc, last in (fo["b_stop"], fo["r_stop"], ls["a_stop"],
                     ls["b_stop"]):
        assert rc == 0 and last is not None
    assert fo["b_stop"][1]["epoch"] == 2
    assert fo["b_stop"][1]["heads_launches"] == 0  # the plain version


def test_lease_stall_fences_the_stale_leader(runs):
    ls = runs["lease_stall"]
    code, body = ls["a_post"]
    assert code == 503 and body["leaderHint"] == "b"
    assert ls["a_status"]["role"] == "fenced"
    assert ls["a_stop"][1]["role"] == "fenced"
    assert not any(rec["kind"] == "workload"
                   and rec["obj"]["name"] == ls["stale_name"]
                   for rec in ls["records"])
    epochs = [rec["obj"]["epoch"] for rec in ls["records"]
              if rec["kind"] == "ha_digest"]
    assert epochs == sorted(epochs) and epochs[-1] == 2
    assert set(ls["b_codes"]) == {201}
    assert ls["b_status"]["stateDigest"] == ls["control"]


def test_no_descendant_is_left(runs):
    assert sw.survivors() == []


def test_a_start_helper_that_times_out_leaves_no_child(tmp_path):
    before = {p for p, _ in sw.survivors()}
    registered = set(sw._LIVE)
    with pytest.raises(TimeoutError):
        # A read replica never prints the plain serve's "rebuilt " line.
        sw.start_serve(tmp_path / "none.jsonl", "off", "cpu", timeout=0.5,
                       extra=("--read-replica",))
    assert {p for p, _ in sw.survivors()} == before
    assert set(sw._LIVE) == registered
