"""The federation as processes on the CPU
(kueue_tpu_torch/bench/federation_world.py at SMALL size): two cells
``python -m kueue_tpu_torch.serve --ha --device cpu`` behind a
``python -m kueue_tpu_torch.serve --federate`` process, every child
started through ``serve_world.Proc``. 40 arrivals go through the
dispatcher; before the 14th, cell-a is SIGKILLed (cell-sigkill), and
before the 28th it is restarted on its own journal and port under a new
identity (zombie-rejoin). Then the invariants of ``federation_world.
check``: every route admitted, ``/cells`` and ``/debug/federation``
answered, the union of the cells' admitted sets (cold rebuilds of their
journals, each digest equal to the live cell's) equal to the 40
submitted and pairwise disjoint, SIGTERM ending each live cell and the
dispatcher with rc 0; and no process left behind."""

import pytest

from kueue_tpu_torch.bench import federation_world as fw
from kueue_tpu_torch.bench import serve_world as sw


@pytest.fixture
def one_thread(monkeypatch):
    """The children's torch on one thread each: three processes share
    the box with the rest of the suite."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_two_cells_behind_federate_kill_and_zombie(one_thread, tmp_path):
    before = {pid for pid, _ in sw.survivors()}
    r = fw.run(fw.SMALL, device="cpu", work=tmp_path / "fed")
    lines = fw.check(fw.SMALL, r, "cpu")
    assert r["killed"] == ["cell-a"]
    assert r["federate_status"]["routes"] == {"admitted": 40}
    assert r["federate_last"]["role"] == "federation"
    assert len(r["post_latencies"]) == 40
    assert lines[-1].startswith("  union == submitted (40)")
    # The live cells ended by SIGTERM: cell-b and the zombie cell-a-r1.
    assert sorted(last["identity"] for runs in r["ended"].values()
                  for _rc, last in runs) == ["cell-a-r1", "cell-b"]
    assert {pid for pid, _ in sw.survivors()} <= before
