"""The SSE fanout hub in the port's HA serving plane
(kueue_tpu_torch/visibility/fanout.py) against the JAX package's.

``tests/test_ha_fanout.py``'s cases (the slow-consumer contract: drops,
eviction, no stall of the publisher or of other clients) run on the
port: that file's module globals (its API types, ``Engine``, the hub
classes) are pointed at the port's, engines on ``device="cpu"``. Then
the hub's HA uses in both packages on one journal: a follower's tailer
publishes the same synthesized ``journal`` and ``ha_checkpoint`` events
in the same order, and a replica's promotion attaches the hub to the
promoted engine, whose admissions then reach subscribers (and its
fencing detaches it again). Exact throughout."""

import json
import time

import pytest

import test_ha_fanout as ref
from kueue_tpu.ha import tailer as jtailer
from kueue_tpu.visibility import fanout as jfanout
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.controllers.engine import Engine as PEngine
from kueue_tpu_torch.ha import replica as preplica
from kueue_tpu_torch.ha import tailer as ptailer
from kueue_tpu_torch.metrics import registry as pregistry
from kueue_tpu_torch.visibility import fanout as pfanout
from test_torch_ha import JAX, leader_journal
from test_torch_journal import aligned_uids


def port_globals(mp) -> None:
    for name, obj in list(vars(ref).items()):
        if getattr(obj, "__module__", None) == "kueue_tpu.api.types":
            mp.setattr(ref, name, getattr(ptypes, name))
    mp.setattr(ref, "Engine", lambda: PEngine(device="cpu"))
    for name in ("EVICTED", "FanoutClient", "FanoutHub"):
        mp.setattr(ref, name, getattr(pfanout, name))
    import kueue_tpu.metrics.registry as jregistry
    mp.setattr(jregistry, "MetricsRegistry", pregistry.MetricsRegistry)


@pytest.fixture
def on_port(monkeypatch):
    port_globals(monkeypatch)


REFERENCE_CASES = [
    "test_basic_delivery_all_clients",
    "test_configured_client_depth_is_honored",
    "test_slow_consumer_evicted_other_clients_unharmed",
    "test_evicted_client_receives_no_further_events",
    "test_engine_attach_single_listener_and_cycle_not_stalled",
    "test_unsubscribe_removes_client",
    "test_metrics_counters_wired",
]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case_on_the_port(on_port, name, tmp_path):
    fn = getattr(ref, name)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


def _events(fanout, tailer_mod, path, **kw):
    hub = fanout.FanoutHub(shards=2, client_queue_depth=4096)
    client = hub.subscribe()
    try:
        tailer = tailer_mod.JournalTailer(str(path), hub=hub,
                                          rebuild_every=1, **kw)
        n = tailer.poll()
        got = ref.drain(client, timeout=5.0)
        while len(got) < n:
            more = ref.drain(client, timeout=1.0)
            if not more:
                break
            got += more
    finally:
        hub.close()
    return n, got


def test_tailers_publish_the_same_events(tmp_path):
    with aligned_uids():
        leader_journal(JAX, tmp_path / "j.jsonl")
    n, want = _events(jfanout, jtailer, tmp_path / "j.jsonl")
    m, got = _events(pfanout, ptailer, tmp_path / "j.jsonl",
                     engine_kwargs={"device": "cpu"})
    assert m == n == len(got)
    assert got == want
    kinds = [k for k, _ in got]
    assert "ha_checkpoint" in kinds and "journal" in kinds
    assert json.loads(got[-1][1])["epoch"] == 1


def test_promotion_attaches_the_hub(tmp_path):
    """A follower's hub carries tailer events; promotion attaches it to
    the promoted engine (its admissions reach subscribers) and fencing
    detaches it."""
    journal = str(tmp_path / "ha.jsonl")
    hub = pfanout.FanoutHub(shards=2, client_queue_depth=4096)
    client = hub.subscribe(depth=4096)
    try:
        r = preplica.HAReplica(journal, journal + ".lease", "a",
                               lease_duration=3.0,
                               renew_in_background=False, hub=hub,
                               engine_kwargs={"device": "cpu"})
        assert r.step(0.0) == "leader"
        assert r.engine.fanout is hub
        eng = r.engine
        t = ptypes
        eng.create_resource_flavor(t.ResourceFlavor("default"))
        eng.create_cluster_queue(t.ClusterQueue(
            name="cq", resource_groups=(t.ResourceGroup(
                ("cpu",), (t.FlavorQuotas(
                    "default", {"cpu": t.ResourceQuota(1000)}),)),)))
        eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
        eng.submit(t.Workload(name="w", queue_name="lq",
                              pod_sets=(t.PodSet("main", 1, {"cpu": 1}),)))
        eng.schedule_once()
        deadline = time.monotonic() + 5
        kinds = []
        while "Admitted" not in kinds and time.monotonic() < deadline:
            kinds += [k for k, _ in ref.drain(client, timeout=0.5)]
        assert "Admitted" in kinds
        r.resign()
        assert r.roles.role == "fenced"
        assert eng.fanout is None
    finally:
        hub.close()
