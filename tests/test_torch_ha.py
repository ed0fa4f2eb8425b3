"""The port's HA serving plane (kueue_tpu_torch/ha: the fenced lease,
the role machine, the decision chain and replay-verified promotion, the
journal tailer and HAReplica) against the JAX package's.

``tests/test_ha_replica.py``'s cases run on the port: that file's
module globals (its API types, ``Engine``, the ha classes and helpers,
the journal functions) are pointed at the port's, with every engine on
``device="cpu"``, so its own code drives the port's lease, promotion,
fencing, front door, shedder and tailer, and its ``kueuectl status``
case the port's ``kueuectl run``. Left out: the bench sentinel, which
reads the benchmark's ``BENCH_r*.json`` captures and waits for the
port's benchmark.

Beside them, the JAX package on the same inputs: mirrored leaders (the
uid counters aligned) write byte-identical journals, ``ha_digest``
records included; ``verify_promotion`` gives both packages' reports on
the clean, partial, tampered and epoch-violating journals; the lease
files are interchangeable; both tailers consume a journal to the same
position and state; and a journal one package's leader wrote promotes
under the other package's ``HAReplica`` with ``verified`` true and equal
digests, both ways. Exact throughout."""

import functools
import json

import pytest

import test_ha_replica as ref
from kueue_tpu.api import types as jtypes
from kueue_tpu.controllers.engine import Engine as JEngine
from kueue_tpu.ha import digest as jdigest
from kueue_tpu.ha import lease as jlease
from kueue_tpu.ha import replica as jreplica
from kueue_tpu.ha import tailer as jtailer
from kueue_tpu.store import journal as jjournal
from kueue_tpu_torch import ha as pha
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.cli import kueuectl as pkueuectl
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.ha import digest as pdigest
from kueue_tpu_torch.ha import lease as please
from kueue_tpu_torch.ha import replica as preplica
from kueue_tpu_torch.ha import roles as proles
from kueue_tpu_torch.ha import shedder as pshedder
from kueue_tpu_torch.ha import tailer as ptailer
from kueue_tpu_torch.store import journal as pjournal
from test_torch_journal import aligned_uids

CPU = {"device": "cpu"}


def _port_replica(*args, **kwargs):
    kwargs.setdefault("engine_kwargs", CPU)
    return preplica.HAReplica(*args, **kwargs)


def port_globals(mp) -> None:
    """Point ``test_ha_replica``'s module globals at the port (``mp`` a
    MonkeyPatch): the API types, the Engine on the CPU, the ha classes
    and helpers, the journal functions, and the Kueuectl and
    ``kueuectl.run`` two cases import inside their bodies."""
    for name, obj in list(vars(ref).items()):
        if getattr(obj, "__module__", None) == "kueue_tpu.api.types":
            mp.setattr(ref, name, getattr(ptypes, name))
    mp.setattr(ref, "Engine", lambda: PEngine(device="cpu"))
    for name in ("DigestChain", "admitted_state_digest", "last_checkpoint",
                 "verify_promotion"):
        mp.setattr(ref, name, getattr(pdigest, name))
    mp.setattr(ref, "FencedLease", please.FencedLease)
    mp.setattr(ref, "HAReplica", _port_replica)
    for name in ("CANDIDATE", "FENCED", "FOLLOWER", "LEADER", "ROLE_CODES",
                 "RoleMachine", "RoleTransitionError"):
        mp.setattr(ref, name, getattr(proles, name))
    for name in ("STATUS_BREACH", "STATUS_OK", "STATUS_WARN",
                 "AdmissionShedder", "TokenBucket"):
        mp.setattr(ref, name, getattr(pshedder, name))
    mp.setattr(ref, "JournalTailer", ptailer.JournalTailer)
    mp.setattr(ref, "Journal", pjournal.Journal)
    mp.setattr(ref, "JournalFenced", pjournal.JournalFenced)
    mp.setattr(ref, "attach_new_journal", pjournal.attach_new_journal)
    mp.setattr(ref, "engine_from_records", pjournal.engine_from_records)
    mp.setattr(ref, "rebuild_engine",
               functools.partial(pjournal.rebuild_engine, device="cpu"))
    import kueue_tpu.cli.kueuectl as jkueuectl
    mp.setattr(jkueuectl, "Kueuectl", pkueuectl.Kueuectl)
    mp.setattr(jkueuectl, "run", pkueuectl.run)


@pytest.fixture
def on_port(monkeypatch):
    port_globals(monkeypatch)


REFERENCE_CASES = [
    "test_lease_epoch_monotonic_fencing",
    "test_lease_survives_corrupt_file",
    "test_role_machine_legal_path_and_history",
    "test_role_machine_rejects_protocol_skips",
    "test_digest_chain_checkpoints_inside_cycle",
    "test_verify_promotion_clean_boundary",
    "test_verify_promotion_adopts_partial_cycle",
    "test_verify_promotion_fences_on_tamper",
    "test_verify_promotion_fences_on_epoch_violation",
    "test_failover_promotes_verified_and_fences_stale_leader",
    "test_submit_front_door_role_and_shed_gates",
    "test_token_bucket_refill_and_factor",
    "test_shedder_slo_coupling",
    "test_shedder_counts_and_status",
    "test_tailer_reads_complete_lines_only",
    "test_tailer_throttles_rebuilds",
    "test_tailer_rebuild_backoff_full_jitter",
    "test_shedder_retry_after_jitter_decorrelates",
    "test_shedder_retry_after_clamped",
    "test_follower_503_carries_clamped_retry_after",
    "test_submit_dedup_map_stays_bounded",
    "test_submit_dedup_capacity_evicts_oldest",
    "test_kueuectl_status_offline_renders_checkpoint",
]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case_on_the_port(on_port, name, tmp_path):
    fn = getattr(ref, name)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


# -- the same leader in both packages --

class Pkg:
    def __init__(self, name, t, engine, digest, journal, lease, tailer,
                 replica, replica_kwargs):
        self.name, self.t, self.engine = name, t, engine
        self.digest, self.journal, self.lease = digest, journal, lease
        self.tailer, self.replica = tailer, replica
        self.replica_kwargs = replica_kwargs


JAX = Pkg("jax", jtypes, JEngine, jdigest, jjournal, jlease, jtailer,
          jreplica, {})
PORT = Pkg("port", ptypes, lambda: PEngine(device="cpu"), pdigest,
           pjournal, please, ptailer, preplica, {"engine_kwargs": CPU})


def _world(pkg, eng):
    t = pkg.t
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cohort(t.Cohort("co"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq0", cohort="co",
        resource_groups=(t.ResourceGroup(
            ("cpu",), (t.FlavorQuotas(
                "default", {"cpu": t.ResourceQuota(1_000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq0", "default", "cq0"))


def _wave(pkg, eng, n, start=0, cpu=100):
    for i in range(start, start + n):
        eng.clock += 0.01
        eng.submit(pkg.t.Workload(
            name=f"w{i}", queue_name="lq0",
            pod_sets=(pkg.t.PodSet("main", 1, {"cpu": cpu}),)))


def _drain(eng):
    while eng.schedule_once() is not None:
        pass


def leader_journal(pkg, path, waves=((3, 0), (9, 3))):
    """A leader's journal: the world, then per-cycle ha_digest records
    written through the pre-sync hook, one drain per wave (the quota
    holds 10 of the 12, so two stay pending)."""
    eng = pkg.engine()
    pkg.journal.attach_new_journal(eng, str(path))
    _world(pkg, eng)
    pkg.digest.DigestChain(eng, epoch=1)
    for n, start in waves:
        _wave(pkg, eng, n, start=start)
        _drain(eng)
    eng.journal.sync()
    eng.journal.close()
    return eng


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """The same leader run in each package, uids aligned: (directory,
    {package name: (journal path, final admitted-state digest)})."""
    d = tmp_path_factory.mktemp("ha")
    out = {}
    for pkg in (JAX, PORT):
        with aligned_uids():
            eng = leader_journal(pkg, d / f"{pkg.name}.jsonl")
        out[pkg.name] = (d / f"{pkg.name}.jsonl",
                         pkg.digest.admitted_state_digest(eng))
    return d, out


def test_leaders_write_byte_identical_journals(journals):
    _d, out = journals
    jax_bytes = out["jax"][0].read_bytes()
    assert out["port"][0].read_bytes() == jax_bytes
    assert out["port"][1] == out["jax"][1]
    records = [json.loads(line) for line in jax_bytes.splitlines()]
    assert sum(r["kind"] == "ha_digest" for r in records) >= 2


def _tampered(records):
    idx, _ = jdigest.last_checkpoint(records)
    out = json.loads(json.dumps(records))
    out[idx]["obj"]["state"] = "deadbeef"
    return out


VARIANTS = {
    "clean": (lambda r: r, 2),
    "partial": (lambda r: r[:-1], 2),
    "tampered": (_tampered, 2),
    "epoch": (lambda r: r, 1),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_verify_promotion_reports_match(journals, variant):
    _d, out = journals
    cut, epoch = VARIANTS[variant]
    records = cut(list(pjournal.read_records(str(out["jax"][0]))))
    want = jdigest.verify_promotion(
        records, jjournal.engine_from_records(records), new_epoch=epoch)
    got = pdigest.verify_promotion(
        records, pjournal.engine_from_records(records, device="cpu"),
        new_epoch=epoch)
    assert got == want
    assert got["verified"] == (variant in ("clean", "partial"))


def test_leases_are_interchangeable(tmp_path):
    path = str(tmp_path / "lease.json")
    a = please.FencedLease(path).try_acquire("a", now=0.0, duration=3.0)
    assert jlease.FencedLease(path).read() == jlease.LeaseState(**vars(a))
    assert jlease.FencedLease(path).try_acquire("b", 1.0, 3.0) is None
    b = jlease.FencedLease(path).try_acquire("b", 10.0, 3.0)
    assert b.epoch == 2
    assert please.FencedLease(path).renew("a", 1, 11.0) is None
    assert vars(please.FencedLease(path).read()) == vars(b)


def _tail_view(tailer):
    st = tailer.status()
    return {"recordsSeen": st["recordsSeen"], "replayLag": st["replayLag"],
            "lastCheckpoint": st["lastCheckpoint"],
            "position": st["position"],
            "appliedPosition": st["appliedPosition"],
            "lastCycleCid": st["lastCycleCid"]}


def test_tailers_consume_alike(journals):
    _d, out = journals
    path = str(out["jax"][0])
    jt = jtailer.JournalTailer(path, rebuild_every=1)
    pt = ptailer.JournalTailer(path, rebuild_every=1,
                               engine_kwargs=CPU)
    assert jt.poll() == pt.poll() > 0
    assert _tail_view(pt) == _tail_view(jt)
    assert (pdigest.admitted_state_digest(pt.engine)
            == jdigest.admitted_state_digest(jt.engine) == out["jax"][1])


def _promote(pkg, journal, lease, identity, now):
    replica = pkg.replica.HAReplica(
        str(journal), str(lease), identity, lease_duration=3.0,
        renew_in_background=False, **pkg.replica_kwargs)
    assert replica.step(now) == "leader"
    return replica


@pytest.mark.parametrize("writer,promoter", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_cross_package_promotion(tmp_path, writer, promoter):
    """One package's HA leader writes the journal and stalls; the other
    package's replica takes the lease at expiry and promotes, verified,
    on the same state; its next writes carry epoch 2."""
    journal = tmp_path / "ha.jsonl"
    lease = tmp_path / "ha.jsonl.lease"
    with aligned_uids():
        a = _promote(writer, journal, lease, "a", 0.0)
        _world(writer, a.engine)
        _wave(writer, a.engine, 12)
        _drain(a.engine)
        want = writer.digest.admitted_state_digest(a.engine)
        a.suspend_renewal = True
        b = _promote(promoter, journal, lease, "b", 100.0)
    report = b.promotion_report
    assert report["verified"] and report["checkpoint_epoch"] == 1
    assert report["reason"] == "digest identity at checkpoint"
    assert b.epoch == 2
    assert promoter.digest.admitted_state_digest(b.engine) == want
    _wave(promoter, b.engine, 1, start=100, cpu=1)
    _drain(b.engine)
    last = list(pjournal.read_records(str(journal)))[-1]
    assert last["kind"] == "ha_digest" and last["obj"]["epoch"] == 2
    assert writer.digest.admitted_state_digest(
        writer.journal.rebuild_engine(
            str(journal), **writer.replica_kwargs.get("engine_kwargs", {}))
    ) == promoter.digest.admitted_state_digest(b.engine)


def test_promotion_timing_and_engine_slot(tmp_path):
    """The port's replica records the wall seconds of its promotion's
    replay and verification beside the lease's acquire time, and sets
    the promoted engine's ``ha`` slot, which the ``lease-stall`` fault
    reaches."""
    from kueue_tpu_torch.replay.faults import arm_faults

    journal = tmp_path / "ha.jsonl"
    r = _promote(PORT, journal, tmp_path / "lease", "a", 7.0)
    t = r.promotion_timing
    assert t["acquired_at"] == 7.0 and t["replay_s"] >= 0
    assert t["verify_s"] >= 0
    assert r.engine.ha is r
    _world(PORT, r.engine)
    arm_faults(r.engine, "lease-stall@cycle:1")
    _wave(PORT, r.engine, 1)
    _drain(r.engine)
    assert r.suspend_renewal
    assert pha.HAReplica is preplica.HAReplica
