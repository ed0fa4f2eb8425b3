"""The port's columnar apply (kueue_tpu_torch/controllers/colapply.py)
and its serial twin (``Engine._assume_batch_serial``), against the JAX
package under each of the four arms of tests/test_colapply.py.

``TestDigestIdentity``: under every (KUEUE_TPU_PIPELINE,
KUEUE_TPU_COLUMNAR) arm, the JAX engine and the port's run the
process-kill churn world (tests/test_process_kill_restart.py: preemption
policies, priority churn, both apply shapes) through ``MirroredEngine``
(tests/test_torch_engine.py), which holds every cycle's decisions, path
and bridge counters equal; the chained crc32 of the decision streams
must be the serial arm's pinned value in every arm, and the final
fingerprint, the tensor-row free list and the row map must be the JAX
engine's. ``TestPsaColumns``: the flyweighted Admission halves equal
``admission_from_assignment`` and the JAX package's columns.
``TestRowBatchRelease``: ``on_remove_batch`` leaves the free list and
the hash registry of the per-key removes, in both packages alike."""

import zlib

import numpy as np
import pytest

import test_process_kill_restart as tpk
from kueue_tpu.controllers import colapply as jcol
from kueue_tpu.controllers import engine as jengine_mod
from kueue_tpu_torch.bench.engine_worlds import decision_stream
from kueue_tpu_torch.controllers import colapply as pcol
from test_torch_engine import _ENGINES, MirroredEngine

ARMS = {
    "serial": {"KUEUE_TPU_PIPELINE": "0", "KUEUE_TPU_COLUMNAR": "0"},
    "columnar": {"KUEUE_TPU_PIPELINE": "0", "KUEUE_TPU_COLUMNAR": "1"},
    "pipelined": {"KUEUE_TPU_PIPELINE": "1", "KUEUE_TPU_COLUMNAR": "0"},
    "full": {"KUEUE_TPU_PIPELINE": "1", "KUEUE_TPU_COLUMNAR": "1"},
}
# The chained crc32 of the churn world's decision streams (the serial
# arm's; every arm must give it).
DIGEST = 0xD34291F9


def _set_arm(monkeypatch, arm: str) -> None:
    for k, v in ARMS[arm].items():
        monkeypatch.setenv(k, v)


def _churn_world(monkeypatch):
    """The process-kill churn world on a MirroredEngine, oracle
    attached; returns it with the chained digest of its churn and drain
    and the cycles that decided something."""
    monkeypatch.setattr(jengine_mod, "Engine", MirroredEngine)
    eng = tpk.build_world()
    eng.attach_oracle()
    digest, cycles = 0, 0
    inner = eng.schedule_once

    def schedule_once():
        nonlocal digest, cycles
        r = inner()
        digest = zlib.crc32(decision_stream(r), digest)
        cycles += r is not None
        return r

    eng.schedule_once = schedule_once
    for _ in tpk.run_churn(eng):
        pass
    tpk.drain(eng)
    return eng, digest, cycles


class TestDigestIdentity:
    @pytest.mark.parametrize("arm", list(ARMS))
    def test_arm_matches_jax(self, monkeypatch, arm):
        _set_arm(monkeypatch, arm)
        _ENGINES.clear()
        eng, digest, cycles = _churn_world(monkeypatch)
        assert cycles > 0 and eng.oracle.cycles_on_device > 0
        assert digest == DIGEST, f"{arm}: 0x{digest:08x}"
        eng.assert_same_world()
        assert tpk.fingerprint(eng.port) == tpk.fingerprint(eng)
        jrows, prows = eng.queues.rows, eng.port.queues.rows
        assert prows._free == jrows._free
        assert prows._row_of == jrows._row_of
        assert prows.mutation_seq == jrows.mutation_seq
        jp, pp = eng.oracle.pipeline_stats, eng.port.oracle.pipeline_stats
        assert pp == jp
        if ARMS[arm]["KUEUE_TPU_PIPELINE"] == "1":
            assert jp["used"] > 0
        else:
            assert jp == dict.fromkeys(jp, 0)
        _ENGINES.clear()

    def test_columnar_flag_read_per_call(self, monkeypatch):
        for value, want in (("0", False), ("1", True)):
            monkeypatch.setenv("KUEUE_TPU_COLUMNAR", value)
            assert pcol.columnar_enabled() is want
            assert jcol.columnar_enabled() is want
        monkeypatch.delenv("KUEUE_TPU_COLUMNAR")
        assert pcol.columnar_enabled() and jcol.columnar_enabled()


class TestPsaColumns:
    def test_matches_admission_from_assignment(self, monkeypatch):
        """The flyweighted Admission halves equal what the serial loop's
        admission_from_assignment builds, and the JAX package's columns
        of the same entries."""
        from kueue_tpu_torch.api.types import Admission
        from kueue_tpu_torch.workload_info import admission_from_assignment

        _set_arm(monkeypatch, "serial")
        _ENGINES.clear()
        monkeypatch.setattr(jengine_mod, "Engine", MirroredEngine)
        eng = tpk.build_world()
        eng.attach_oracle()
        port_results = []
        port_once = eng.port.schedule_once
        eng.port.schedule_once = lambda: port_results.append(
            port_once()) or port_results[-1]
        seen = 0
        for _ in range(40):
            want = eng.schedule_once()
            if want is None:
                break
            got = port_results[-1]
            if want.stats.preempting:
                eng.tick(0.0)
            for pe, je in zip(got.entries, want.entries):
                if pe.assignment is None or pe.status.value != "assumed":
                    continue
                ref = admission_from_assignment(
                    pe.info.cluster_queue, pe.assignment.pod_sets)
                psas, flavor_dicts = pcol._psa_columns(
                    pe.assignment.pod_sets)
                assert Admission(cluster_queue=pe.info.cluster_queue,
                                 pod_set_assignments=psas) == ref
                assert flavor_dicts == [dict(p.flavors)
                                        for p in ref.pod_set_assignments]
                jpsas, jflavors = jcol._psa_columns(je.assignment.pod_sets)
                assert [(p.name, p.flavors, p.resource_usage, p.count)
                        for p in psas] == [
                    (p.name, p.flavors, p.resource_usage, p.count)
                    for p in jpsas]
                assert flavor_dicts == jflavors
                seen += 1
        assert seen > 0, "no admissions to compare"
        _ENGINES.clear()


class TestRowBatchRelease:
    def test_batch_release_matches_serial_free_order(self):
        """on_remove_batch leaves the free list, the row map and the
        hash registry of the per-key removes, in both packages alike,
        and a refill takes rows in the same order."""
        from kueue_tpu.api.types import PodSet as JPodSet
        from kueue_tpu.api.types import Workload as JWorkload
        from kueue_tpu.tensor.rowcache import WorkloadRowCache as JRows
        from kueue_tpu.workload_info import WorkloadInfo as JInfo
        from kueue_tpu_torch.api.types import PodSet, Workload
        from kueue_tpu_torch.tensor.rowcache import WorkloadRowCache
        from kueue_tpu_torch.workload_info import WorkloadInfo

        kinds = ((JRows, JWorkload, JPodSet, JInfo),
                 (WorkloadRowCache, Workload, PodSet, WorkloadInfo))

        def fill(kind):
            rows_cls, wl_cls, ps_cls, info_cls = kind
            rc = rows_cls()
            for i in range(32):
                wl = wl_cls(name=f"w{i}", queue_name="lq",
                            pod_sets=(ps_cls("main", 1, {"cpu": 100 + i}),))
                info = info_cls.from_workload(wl, "cq")
                rc.on_push(info, (0.0, 0, float(i), np.int64(i)))
                row = rc._row_of[info.key]
                h = ("sig", i % 8)
                rc.hash_id[row] = rc._hashes.acquire(h)
                rc._hash_tuple[row] = h
            return rc

        keys = [f"default/w{i}" for i in (3, 0, 17, 17, 9, 31, 5)]
        caches = []
        for kind in kinds:
            a, b = fill(kind), fill(kind)
            for k in keys:
                a.on_remove(k)
            b.on_remove_batch(keys)
            for x in (a, b):
                for i in (3, 0, 17):
                    wl = kind[1](name=f"r{i}", queue_name="lq",
                                 pod_sets=(kind[2]("main", 1, {"cpu": 1}),))
                    x.on_push(kind[3].from_workload(wl, "cq"),
                              (0.0, 0, 1.0, np.int64(99)))
            caches += [a, b]
        state = [(c._free, c._row_of, c._hashes._id_of, c._hashes._count,
                  sorted(c._hashes._free), c._hash_tuple, c._dirty)
                 for c in caches]
        assert state[1] == state[0]
        assert state[2] == state[0] and state[3] == state[0]
        # The mutation counters (the speculation token reads them) move
        # alike in both packages, per-key and batched.
        seqs = [c.mutation_seq for c in caches]
        assert seqs[2:] == seqs[:2] and min(seqs) > 0
