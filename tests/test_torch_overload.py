"""The port's overload layer (kueue_tpu_torch/obs/watchdog.py,
ha/ladder.py, ha/shedder.py and the fanout hub's detail lever) against
the JAX package's.

``tests/test_overload.py``'s own cases for the Retry-After clamp, the
token bucket, the shedder floors, the watchdog breaker and hang sampler,
the degradation ladder and the tracer's capture lever run on the port's
classes and engine (the module's names rebound to the port's). Then the
same drives go through both packages side by side, with the same fake
clocks and the same trigger sequences, and every state after every step
must be equal: the breaker's ``status()``, the ladder's ``status()`` with
the levers it pulls, and the shedder's verdicts and Retry-After hints
from one seeded generator."""

import random
import types

import pytest

import test_overload as ref
from kueue_tpu.ha import ladder as jladder
from kueue_tpu.ha import shedder as jshedder
from kueue_tpu.obs import hooks as jhooks
from kueue_tpu.obs import watchdog as jwatchdog
from kueue_tpu_torch.api import types as pt
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.ha import ladder as pladder
from kueue_tpu_torch.ha import shedder as pshedder
from kueue_tpu_torch.obs import hooks as phooks
from kueue_tpu_torch.obs import watchdog as pwatchdog
from kueue_tpu_torch.visibility import fanout as pfanout


def _port_world(journal_path=None, min_free_bytes=0):
    from kueue_tpu_torch.store.journal import attach_new_journal

    eng = PEngine(device="cpu")
    if journal_path is not None:
        attach_new_journal(eng, str(journal_path),
                           min_free_bytes=min_free_bytes)
    eng.create_resource_flavor(pt.ResourceFlavor("default"))
    eng.create_cluster_queue(pt.ClusterQueue(
        name="cq",
        resource_groups=(pt.ResourceGroup(
            ("cpu",), (pt.FlavorQuotas(
                "default", {"cpu": pt.ResourceQuota(100_000)}),)),)))
    eng.create_local_queue(pt.LocalQueue("lq", "default", "cq"))
    return eng


def _port_wl(name):
    return pt.Workload(name=name, queue_name="lq",
                       pod_sets=(pt.PodSet("main", 1, {"cpu": 100}),))


@pytest.fixture
def on_the_port(monkeypatch):
    """test_overload's names rebound to the port's."""
    for name in ("TokenBucket", "AdmissionShedder", "clamped_retry_after"):
        monkeypatch.setattr(ref, name, getattr(pshedder, name))
    for name in ("CycleWatchdog", "attach_watchdog", "CLOSED", "OPEN",
                 "HALF_OPEN"):
        monkeypatch.setattr(ref, name, getattr(pwatchdog, name))
    for name in ("attach_ladder", "R_NORMAL", "R_TRACE", "R_FANOUT",
                 "R_SUBMIT", "R_DEVICE"):
        monkeypatch.setattr(ref, name, getattr(pladder, name))
    monkeypatch.setattr(ref, "Engine", PEngine)
    monkeypatch.setattr(ref, "_world", _port_world)
    monkeypatch.setattr(ref, "_wl", _port_wl)
    yield
    phooks.CURRENT = None


REFERENCE_CASES = [
    ("TestClampedRetryAfter", "test_cap_is_hard"),
    ("TestClampedRetryAfter", "test_jitter_bounds"),
    ("TestClampedRetryAfter", "test_zero_jitter_is_exact"),
    ("TestClampedRetryAfter", "test_negative_base_is_zero"),
    ("TestTokenBucketTimeSafety", "test_backwards_now_grants_nothing"),
    ("TestTokenBucketTimeSafety", "test_refill_resumes_after_backwards_step"),
    ("TestTokenBucketTimeSafety", "test_refill_scaled_by_factor"),
    ("TestShedderFloors", "test_ok_is_full_rate"),
    ("TestShedderFloors", "test_warn_floor_quarter"),
    ("TestShedderFloors", "test_warn_tracks_burn_above_floor"),
    ("TestShedderFloors", "test_breach_floor_five_percent"),
    ("TestShedderFloors", "test_breach_mild_burn_keeps_quarter_scale"),
    ("TestShedderFloors", "test_slo_error_never_blocks_intake"),
    ("TestShedderFloors", "test_degraded_factor_caps_computed"),
    ("TestShedderFloors",
     "test_degraded_zero_sheds_everything_with_retry_hint"),
    ("TestWatchdogBreaker", "test_overruns_counted_and_breaker_opens"),
    ("TestWatchdogBreaker", "test_good_cycle_resets_consecutive"),
    ("TestWatchdogBreaker", "test_halfopen_probe_recloses"),
    ("TestWatchdogBreaker", "test_bad_probe_doubles_cooldown_capped"),
    ("TestWatchdogBreaker", "test_device_mode_demotes_oracle_supervisor"),
    ("TestWatchdogBreaker", "test_attach_idempotent_and_detach"),
    ("TestWatchdogHangSampler", "test_hung_cycle_detected_with_stacks"),
    ("TestWatchdogHangSampler", "test_fast_cycles_never_flag"),
    ("TestDegradationLadder", "test_normal_world_stays_normal"),
    ("TestDegradationLadder", "test_warn_sheds_trace_first"),
    ("TestDegradationLadder", "test_breach_squeezes_submissions"),
    ("TestDegradationLadder", "test_disk_degraded_sheds_everything"),
    ("TestDegradationLadder", "test_watchdog_demotion_hits_device_rung"),
    ("TestDegradationLadder", "test_relax_one_rung_per_clean_window"),
    ("TestDegradationLadder", "test_flap_resets_clean_counter"),
    ("TestDegradationLadder", "test_attach_idempotent_and_detach"),
    ("TestTracerCaptureLever", "test_capture_off_stops_trees_not_attachment"),
]


@pytest.mark.parametrize("cls,name", REFERENCE_CASES,
                         ids=[f"{c}.{n}" for c, n in REFERENCE_CASES])
def test_reference_case_on_the_port(on_the_port, cls, name):
    getattr(getattr(ref, cls)(), name)()


def test_hot_warn_sheds_the_ports_fanout_detail(on_the_port):
    """``test_hot_warn_sheds_fanout`` with the port's own hub."""
    eng, slo, shedder, ladder = ref._ladder_world()
    eng.schedule_once()
    hub = pfanout.FanoutHub(shards=1)
    eng.fanout = hub
    slo.status, slo.burn = 1, 3.0
    eng.schedule_once()
    assert ladder.rung == pladder.R_FANOUT
    assert not hub.detail
    hub.close()


def test_fanout_detail_lever_matches_jax():
    """``TestFanoutDetailLever`` in both packages: the same kinds are
    suppressed and the same stats reported."""
    from kueue_tpu.visibility import fanout as jfanout

    assert pfanout.DETAIL_KINDS == jfanout.DETAIL_KINDS
    stats = []
    for mod in (jfanout, pfanout):
        hub = mod.FanoutHub(shards=1)
        try:
            hub.detail = False
            for kind in sorted(mod.DETAIL_KINDS):
                hub.publish(kind, "{}")
            hub.publish("heartbeat", "{}")
            stats.append(hub.stats())
        finally:
            hub.close()
    assert stats[1] == stats[0]
    assert stats[1]["detailSuppressed"] == len(pfanout.DETAIL_KINDS)


@pytest.mark.parametrize("seed", range(4))
def test_watchdog_breaker_state_sequence_matches_jax(seed):
    """One random run of cycle durations (and mode switches) through
    both breakers on fake clocks: equal ``status()`` after every cycle,
    and the same supervisor demotions."""
    rng = random.Random(seed)
    drives = []
    for mod in (jwatchdog, pwatchdog):
        eng = ref._StubEngine()
        calls = []
        eng.oracle = types.SimpleNamespace(supervisor=types.SimpleNamespace(
            demote=lambda seq, reason, calls=calls: calls.append(
                (seq, reason))))
        clk = ref._FakeClock()
        wd = mod.CycleWatchdog(eng, deadline_s=0.1, threshold=3,
                               cooldown_cycles=4, watch_thread=False,
                               clock=clk)
        drives.append((eng, clk, wd, calls))
    for seq in range(120):
        dur = rng.choice((0.01, 0.05, 0.2, 0.3))
        mode = rng.choice(("sequential", "device", "hybrid"))
        hang = rng.random() < 0.05
        got = []
        for eng, clk, wd, calls in drives:
            eng.last_cycle_mode = mode
            wd._pre_cycle(seq, eng)
            clk.t += wd.hang_after_s + 1.0 if hang else dur
            if hang:
                wd.poll_once()
            wd._on_cycle(seq, object())
            st = wd.status()
            if st["lastHang"] is not None:
                st["lastHang"] = dict(st["lastHang"])
            got.append((st, list(calls)))
        assert got[1] == got[0], seq


def _ladder_pair():
    """(JAX world, port world), each with a fake SLO, a shedder, a
    tracer and a ladder with relax_cycles 3."""
    out = []
    for eng, mod_l, mod_s in ((ref._world(), jladder, jshedder),
                              (_port_world(), pladder, pshedder)):
        slo = ref._FakeSLO()
        eng.slo = slo
        eng.shedder = mod_s.AdmissionShedder(rate=10.0)
        eng.attach_tracer()
        out.append((eng, slo, mod_l.attach_ladder(eng, relax_cycles=3)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_ladder_state_sequence_matches_jax(seed):
    """The same trigger sequence (SLO status and burn, a disk-degraded
    journal, a demoted watchdog) through both ladders: the rung, its
    status and every lever after every cycle are equal."""
    rng = random.Random(100 + seed)
    pair = _ladder_pair()
    try:
        for step in range(80):
            status = rng.choice((0, 0, 0, 1, 1, 2))
            burn = rng.choice((0.0, 1.2, 3.0, 6.0))
            demoted = rng.random() < 0.05
            got = []
            for eng, slo, ladder in pair:
                slo.status, slo.burn = status, burn
                eng.watchdog = (types.SimpleNamespace(
                    demoted=True, state="open",
                    last_transition_reason="hung") if demoted else None)
                eng.schedule_once()
                got.append((ladder.status(), eng.tracer.capture,
                            eng.shedder.degraded_factor))
            assert got[1] == got[0], step
    finally:
        jhooks.CURRENT = phooks.CURRENT = None


def test_shedder_verdicts_match_jax():
    """One arrival clock, one SLO trajectory and one seeded generator
    per package: the same accept/shed verdicts, factors and Retry-After
    hints, and the same status."""
    rng = random.Random(5)
    steps = []
    t = 0.0
    for _ in range(400):
        t += rng.expovariate(40.0)
        steps.append((t, rng.choice((0, 0, 1, 2)),
                      rng.choice((0.0, 0.5, 3.0))))
    got = []
    for mod in (jshedder, pshedder):
        slo = ref._FakeSLO()
        s = mod.AdmissionShedder(rate=20.0, burst=5.0, slo=slo,
                                 rng=random.Random(11))
        verdicts = []
        for now, status, burn in steps:
            slo.status, slo.burn = status, burn
            verdicts.append(s.admit(now))
        got.append((verdicts, s.status()))
    assert got[1] == got[0]


def test_watchdog_demotes_the_ports_supervisor():
    """On a real port engine with the oracle on the CPU: three overruns
    of device cycles open the watchdog and demote the bridge's own
    supervisor (``supervisor.demote``), so the next cycles run on the
    host; decisions are unchanged."""
    from test_torch_obs_trace import _port_submit, _port_world as world

    eng = world(nominal=100_000)
    eng.attach_oracle(device="cpu")
    clk = ref._FakeClock()
    wd = pwatchdog.attach_watchdog(eng, deadline_s=0.1, threshold=3,
                                   cooldown_cycles=4, watch_thread=False,
                                   clock=clk)
    inner = eng._schedule_once_impl

    def slow():
        r = inner()
        clk.t += 1.0
        return r

    eng._schedule_once_impl = slow
    for i in range(3):
        _port_submit(eng, f"w{i}", 100)
        eng.schedule_once()
    assert wd.state == pwatchdog.OPEN
    assert eng.oracle.supervisor.state != "closed"
    assert all(w.is_admitted for w in eng.workloads.values())
    wd.detach()
