"""The port's plain leader election (kueue_tpu_torch/utils/
leaderelection.py: ``LeaseFile``, ``LeaderElector``, ``HAEngine``)
against the JAX package's.

``tests/test_leaderelection.py``'s election and failover cases run on
the port: that file's module globals (its API types and the three
classes) are pointed at the port's (its engines schedule on the host,
with no oracle attached). Its structured-log cases import the JAX
package inside their bodies and are covered by
``tests/test_torch_observability.py``. Beside them: the lease files are
interchangeable, and both packages' elector sequences agree tick for
tick; a journal the JAX ``HAEngine`` leader wrote is taken over by the
port's at expiry with the same admitted state, and the other way round.
Exact throughout."""

import pytest

import test_leaderelection as ref
from kueue_tpu.api import types as jtypes
from kueue_tpu.ha import digest as jdigest
from kueue_tpu.utils import leaderelection as jle
from kueue_tpu_torch.api import types as ptypes
from kueue_tpu_torch.ha import digest as pdigest
from kueue_tpu_torch.utils import leaderelection as ple


def port_globals(mp) -> None:
    for name, obj in list(vars(ref).items()):
        if getattr(obj, "__module__", None) == "kueue_tpu.api.types":
            mp.setattr(ref, name, getattr(ptypes, name))
    mp.setattr(ref, "LeaseFile", ple.LeaseFile)
    mp.setattr(ref, "LeaderElector", ple.LeaderElector)
    mp.setattr(ref, "HAEngine", ple.HAEngine)


@pytest.fixture
def on_port(monkeypatch):
    port_globals(monkeypatch)


@pytest.mark.parametrize("name", ["test_single_leader_and_renewal",
                                  "test_graceful_release",
                                  "test_ha_failover_preserves_state"])
def test_reference_case_on_the_port(on_port, name, tmp_path):
    getattr(ref, name)(tmp_path)


TICKS = [("a", 0.0), ("b", 1.0), ("a", 5.0), ("b", 12.0), ("b", 16.0),
         ("a", 17.0), ("a", 40.0), ("b", 41.0)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_electors_share_one_lease_file(tmp_path, writer):
    """Two replicas of different packages on one lease file: each tick's
    leadership is the single-package sequence's."""
    path = str(tmp_path / "lease.json")
    mods = {"a": jle if writer == "jax" else ple,
            "b": ple if writer == "jax" else jle}
    mixed = {n: m.LeaderElector(n, m.LeaseFile(path), 10)
             for n, m in mods.items()}
    alone = {n: jle.LeaderElector(n, jle.LeaseFile(
        str(tmp_path / "alone.json")), 10) for n in mods}
    for name, now in TICKS:
        assert mixed[name].tick(now) == alone[name].tick(now), (name, now)
    assert vars(ple.LeaseFile(path).read()) == vars(
        jle.LeaseFile(str(tmp_path / "alone.json")).read())


def _world(t, eng):
    eng.create_resource_flavor(t.ResourceFlavor("default"))
    eng.create_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=(t.ResourceGroup(
            ("cpu",),
            (t.FlavorQuotas("default", {"cpu": t.ResourceQuota(1000)}),)),)))
    eng.create_local_queue(t.LocalQueue("lq", "default", "cq"))
    for i, cpu in enumerate((600, 300, 600)):
        eng.submit(t.Workload(name=f"w{i}", queue_name="lq",
                              pod_sets=(t.PodSet("main", 1, {"cpu": cpu}),)))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_failover_across_packages(tmp_path, first):
    lease = str(tmp_path / "lease.json")
    journal = str(tmp_path / "journal.jsonl")
    pkgs = {"jax": (jle.HAEngine, jtypes, jdigest),
            "port": (ple.HAEngine, ptypes, pdigest)}
    second = "port" if first == "jax" else "jax"
    cls, t, dig = pkgs[first]
    a = cls("a", lease, journal, lease_duration_seconds=10)
    a.tick(0.0)
    _world(t, a.engine)
    a.schedule_once()
    a.schedule_once()
    want = dig.admitted_state_digest(a.engine)
    cls, t, dig = pkgs[second]
    b = cls("b", lease, journal, lease_duration_seconds=10)
    b.tick(1.0)
    assert not b.elector.is_leader
    b.tick(20.0)
    assert b.elector.is_leader
    assert dig.admitted_state_digest(b.engine) == want
    assert b.engine.workloads["default/w0"].is_admitted
    assert not b.engine.workloads["default/w2"].is_admitted
