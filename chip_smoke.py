"""Smoke run of the PyTorch/CUDA port (kueue_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the port from csrc/;
  3. heads kernel vs its plain PyTorch version on the card, exact, over
     a grid of (W, C) shapes including the drain's (50000, 1000) and one
     case of each branch of the kernel (one thread-block cluster, several
     clusters, bins beyond shared memory), plus timings at the drain's
     shape: per call and on the device, with exactly one launch a call;
  4. a 512-workload drain on the card: 18 cycles, 207 admitted,
     decision checksum 0x6a18f8b7;
  5. the full-width drain (1,000 ClusterQueues, 50,000 workloads): 73
     cycles, 49,937 admitted, checksum 0x4eaa40c2, with the heads kernel
     launched once per cycle; then the heads kernel vs its plain version
     on the drain's own first-cycle inputs, exact;
  6. TAS leaf kernel vs its plain PyTorch version on the card, exact,
     over the reference's grid, 300 GiB quantities, counts of 2**31 and
     more, no requested column, every leaf masked, the 5,120-leaf forest,
     65,536 x 8 leaves with wrapping int64 quantities, and each load path
     of the kernel (odd S, S = 1, wide rows of 33 and 70 columns, rows off
     16-byte alignment), plus timings at the forest's shape and at
     65,536 x 8;
  7. device TAS on the 5,120-node forest (kueue_tpu_torch/bench/
     tas_world.py): the feasibility batch over the 21 request signatures
     at the empty forest, 440 placements one by one against live usage,
     the feasibility batch at the final usage, and phase 1 (leaf kernel,
     then the bubble up the tree) per per-pod vector, each against the
     JAX package's checksums, with the leaf kernel launched once per
     per-pod vector;
  8. the fair-sharing drain of hierarchical_fair(n_workloads=40000):
     500 ClusterQueues under 50 roots x 2 mid cohorts, 40,000 workloads,
     49 cycles, 22,816 admitted, checksum 0x4135ace0, with the heads
     kernel launched once per cycle; then the heads kernel vs its plain
     version on the drain's first-cycle inputs, exact;
  9. the preemption world at 1,000 ClusterQueues and 20,000 workloads
     (kueue_tpu_torch/bench/preempt_world.py) through
     TorchExecutor.cycle_step with fused classical preemption: 42
     cycles, 2,824 admissions, 2,313 preempting entries, 3,134 victims,
     no overflow, stream checksum 0xb8e888f4, with the heads kernel
     launched once per cycle; then the heads kernel vs its plain version
     on the world's first-cycle inputs, exact;
 10-13. the serving engine (Engine.schedule_once through the OracleBridge
     and TorchExecutor, kueue_tpu_torch/bench/engine_worlds.py FULL, on
     the serial loop with the columnar apply, the loop the JAX constants
     of phases 10 to 18 came from; each run pins it):
     bench.py's cycle_latency (1,000 ClusterQueues x 50,000 workloads, 1
     untimed and 8 timed cycles) and fair_cycle_latency (500 ClusterQueues
     x 20,000 workloads, 1 + 6 cycles), bench_preempt_churn's world (100
     ClusterQueues, 4,000 pending) drained, and the multi-flavor
     preemption worlds (sim nomination: flavor_grid and the slot overrides
     on the card); each against the JAX engine's cycles, admissions,
     preemptions, decision-stream crc32 and device / hybrid / fallback
     cycles, with the heads kernel launched once per device cycle and
     held against its plain version on the run's first-cycle inputs;
     each prints p50 and p95 s/cycle and the mean phases;
 14-16. topology-aware scheduling in the serving engine
     (kueue_tpu_torch/bench/tas_engine_worlds.py FULL): bench.py's tas
     (640 nodes, 800 gang workloads), tas_large (5,120 nodes, 120
     workloads) and tas_churn (5,120 nodes, 32 ClusterQueues, 80 fill and
     20 churn cycles), each run with its TAS placements pinned to the
     host descent and to the device program (tas_churn also with the
     feasibility batch off); every arm against the JAX engine's cycles,
     admissions, decision-stream and placement crc32, device / hybrid /
     fallback cycles, host-root reasons and TAS stats (placed by each
     path, memo hits, commit drops, tas_place_batch calls), with the
     heads kernel launched once per device cycle and held against its
     plain version on the world's first-cycle inputs; each prints p50
     and p95 s/cycle, the planner's encode, place and decode seconds,
     tas_place_batch calls and heads per call, and the crossover probe
     (one host descent against one device placement on the world's
     forest);
 17-18. the mixed serving worlds (kueue_tpu_torch/bench/mixed_worlds.py
     FULL): bench.py's bench_mixed (30 roots x 4 ClusterQueues, plain,
     multi-flavor and TAS roots in one engine, 10,000 workloads) drained
     once, and afs_serving (the cycle_latency world under admission fair
     sharing with 4 tenant LocalQueues per ClusterQueue, priority
     classes and a provisioning admission check on half the queues, 1 +
     8 cycles with check outcomes, finishes and arrivals between them);
     each against the JAX engine's cycles, reservations, evictions,
     finishes, decision-stream and placement crc32, device / hybrid /
     fallback cycles, slot-override cycles, reasons and final
     LocalQueue usage, with the heads kernel launched once per device
     cycle and held against its plain version on the run's first-cycle
     inputs; each prints p50 and p95 s/cycle and the mean encode / sim /
     device / apply / finalize phases;
 19. the deployed control plane (kueue_tpu_torch/bench/serve_world.py
     FULL) on the default serving loop (the speculation pipeline and the
     columnar apply): the cycle_latency world plus an ``arrivals``
     ClusterQueue, seeded into a journal (52,204 records); the oracle sidecar
     (``python -m kueue_tpu_torch.oracle.service``) on the card and
     ``python -m kueue_tpu_torch.serve --oracle 127.0.0.1:PORT --device
     cuda`` rebuilding the journal; 1,000 arrivals POSTed at 200 a
     second; the loop drained to idle; both processes stopped with
     SIGTERM (exit 0 each). Gated on the final state's checksum, held
     quota count and arrivals against the JAX package's, every arrival
     admitted exactly once (its journal records), no fallback cycle but
     ``idle-*``, the sidecar's heads launches and compute replies equal
     to the device calls the serve process dispatched (device cycles
     less used speculations, plus every speculation), and one /metrics
     scrape before SIGTERM: the admitted_workloads_total,
     pending_workloads, cluster_queue_resource_usage,
     local_queue_pending_workloads and oracle_breaker_state series
     against the JAX package's, oracle_cycles_total against the
     process's /oracle and only ``idle-*`` in oracle_fallback_total.
     Prints the restart (journal bytes, records, rebuild and boot
     seconds), the mean cycle wall time (drain
     seconds over device cycles), p50 and p95 of the ``lastCyclePhases``
     each /debug/dump poll sampled (and of each /oracle poll that saw a
     new device cycle), frame bytes per device call each way, POST p50
     and p95 latency, the drain seconds, the serve loop's wall split,
     its pipeline_stats and the scrape's bytes and seconds;
 20. crash and restart with bounded-time recovery: the same world with
     ``--oracle local``, checkpoints every 12 non-idle cycles (2 kept),
     segments of 20,000 records and a disk budget of 1 MiB free; the
     serve process SIGKILLed after 30 device cycles, once retention has
     deleted segment 0 (the seeded genesis records), while the arrivals
     are POSTed, restarted on the same journal with checkpoints every
     250 cycles, the arrivals POSTed again (200 deduplicated or 201) and
     the loop drained. Gated on invariants: segment 0 gone before the
     restart, the first boot from genesis and the restart from a
     checkpoint (its base and suffix counts printed), no checkpoint
     failure, every checkpoint file loading clean (CRC and count), the
     torn tail repaired, every admission the journal held before the
     kill present after the restart, no key admitted twice (both read
     from the genesis chain: each sealed segment is hard-linked aside as
     it appears, so retention's deletions leave it whole), no
     ClusterQueue's or cohort's usage above its cohort's quota, every
     arrival admitted, the restarted process's heads launches equal to
     its dispatched device calls, the port's recover_engine of the whole
     journal set (every segment, the active file, the checkpoints)
     coming through a checkpoint with the admitted-state digest of the
     genesis replay (prove_genesis), and its rebuild_engine coming
     through a checkpoint and, drained to idle on the host, giving the
     live engine's dump_state. Prints both boots' seconds (genesis and
     checkpoint), the checkpoints written, their write seconds (mean and
     maximum) and bytes, the segments sealed and left, the disk
     budget's statvfs checks and cost, and two ways to check a written
     checkpoint: a load of it (parse and count) against a read-back of
     its bytes;
 21. (beside phase 20: both are gates on processes of their own) the
     breaker on the card, posting the first 250 arrivals (a quarter) to
     a copy of the journal: the sidecar run as ``--fault crash-after:3`` and
     KUEUE_TPU_ORACLE_BREAKER_COOLDOWN=2; once ``breaker-open`` shows in
     /oracle the sidecar is restarted on the same port. Gated on
     ``remote-error`` and ``breaker-open`` host cycles, device cycles
     again after them (the half-open probe re-promotes), the new
     sidecar's heads launches equal to the device calls dispatched
     after the demotion, and the JAX package's final state with those
     arrivals;
 22-23. the serving engine on the default loop (engine_worlds.DEFAULT_ARM):
     cycle_latency (the columnar apply at 1,000 admissions a cycle) and
     preempt_churn (the speculation pipeline's renumbered victims), each
     against the JAX engine's numbers on its default loop (cycles,
     admissions, preemptions, evictions, decision-stream crc32, device /
     hybrid / fallback cycles and pipeline_stats), with the heads kernel
     launched once per dispatched device call and held against its
     plain version on the run's first-cycle inputs; each prints p50 and
     p95 s/cycle and the mean phases, spec_encode included;
 24-25. the two arms with the per-entry assume (engine_worlds.OTHER_ARMS):
     cycle_latency on the serial loop (its apply against phase 10's
     columnar one) and preempt_churn on the speculation pipeline, gated
     as phases 22 and 23 against the JAX engine's numbers on each arm;
 26. TAS through node failures and foreign pods
     (kueue_tpu_torch/bench/tas_engine_worlds.py FULL tas_lifecycle, on
     the default loop): the tas_churn world with 160 DaemonSet pods
     (observe_pod before the first cycle, one observe_pod_deleted per
     churn cycle) and five node failures (mark_node_unhealthy) whose
     lost pods the second pass re-places, with its backoff, at the top
     of the following cycles; run with its TAS placements pinned to the
     host descent and to the device program (the replacements with
     them), the feasibility batch on; each arm against the JAX engine's
     numbers (those of phase 16 plus the NodeUnhealthy and NodeReplaced
     events, the second pass's retries and replacement placements, the
     crc32 of those events and of every admitted workload's final
     topology assignment) and pipeline_stats, with the heads kernel
     launched once per dispatched device call and held against its plain
     version on the world's first-cycle inputs; prints p50 and p95
     s/cycle of the churn cycles, the second pass's wall per churn cycle
     and the replacement placements by path.
Before the kernel summary it prints each phase's wall seconds.
The expected decisions are the JAX package's own on the same scenarios
(tests/test_torch_drain.py, tests/test_torch_tas_feasibility.py,
tests/test_torch_fair.py, tests/test_torch_preempt_world.py,
tests/test_torch_engine_worlds.py, tests/test_torch_tas_engine_worlds.py,
tests/test_torch_mixed_worlds.py, tests/test_torch_serve.py and
tests/test_torch_tas_lifecycle_world.py recompute them). Phases 19 to 21
read the heads launches of the process that launches them (the sidecar,
or the restarted serve process), from the JSON line it prints when
stopped. The last two lines are a JSON summary of the kernels and the
result line. Timing helpers and the shared inputs come from
kueue_tpu_torch/bench/profile_kernels.py, which reports the same
split of each kernel's time in more detail.

Exits non-zero without a result when CUDA is absent. Imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import json
import shutil
import signal
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np

BIG_RANK = 1 << 40
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores

SMALL = dict(n_cohorts=4, cqs_per_cohort=4, n_workloads=512,
             nominal_per_cq=40000, sized_to_fit=False)
SMALL_EXPECT = (18, 207, 0x6a18f8b7)
FULL = dict(n_cohorts=200, cqs_per_cohort=5, n_workloads=50000)
FULL_EXPECT = (73, 49937, 0x4eaa40c2)
# The drain's (50000, 1000) and (W, C) shapes of every branch of the
# kernel: one cluster, 64 KB of bins (8192) and all 227 KB of them
# (29056) in shared memory; several clusters just past one cluster's
# rows (65537) and at 1,000,000 rows; bins beyond shared memory (32768),
# global atomics.
HEADS_SHAPES = [(1, 1), (37, 3), (256, 7), (1000, 130), (5000, 1000),
                (50000, 1000), (50000, 8192), (50000, 29056), (65537, 1000),
                (1000000, 1000), (50000, 32768)]
LEAF_GRID = [(1, 1), (100, 3), (640, 2), (1000, 5)]
LEAF_PATHS = [(5120, 3), (5120, 1), (4096, 33), (4096, 70)]
# The JAX package's fair drain of hierarchical_fair(n_workloads=40000):
# cycles, admitted, crc32 of the decision vectors.
HIER_FAIR_EXPECT = (49, 22816, 0x4135ace0)
# The JAX package's cycles through the preemption world at 1,000
# ClusterQueues (kueue_tpu_torch/bench/preempt_world.py): cycles,
# admissions, preempting entries, victims, overflow slots and the crc32
# of the per-cycle decision stream.
PREEMPT_EXPECT = dict(cycles=42, admitted=2824, preempting=2313,
                      victims=3134, overflow=0, checksum=0xb8e888f4)
# The JAX package's outcomes on the 5,120-node TAS world: placed count
# and the crc32 of the placements, both feasibility batches and phase 1.
# The serving engine's runs (kueue_tpu_torch/bench/engine_worlds.py
# FULL): the JAX engine's numbers on the same worlds and calls, with its
# serial cycle loop (tests/test_torch_engine_worlds.py recomputes them).
ENGINE_EXPECT = {
    "cycle_latency": dict(
        cycles=9, admitted=9000, preempting=0, preemptions=0,
        checksum=0x32e2d6f0, on_device=9, hybrid=0, fallback=0,
        overridden=0),
    "fair_cycle_latency": dict(
        cycles=7, admitted=3500, preempting=0, preemptions=0,
        checksum=0xe7d3c224, on_device=7, hybrid=0, fallback=0,
        overridden=0),
    "preempt_churn": dict(
        cycles=39, admitted=600, preempting=231, preemptions=309,
        checksum=0xdce70507, on_device=39, hybrid=0, fallback=1,
        overridden=0),
    "multiflavor": dict(
        cycles=416, admitted=379, preempting=146, preemptions=150,
        checksum=0x9403afa8, on_device=416, hybrid=0, fallback=0,
        overridden=416),
}
# The TAS engine runs (kueue_tpu_torch/bench/tas_engine_worlds.py FULL):
# the JAX engine's numbers on the same worlds, calls and pins, in every
# arm (tests/test_torch_tas_engine_worlds.py recomputes them). ``placed``
# heads go to placed_device or placed_host by the arm's path;
# ``batch_calls`` are the device arm's tas_place_batch launches.
TAS_ENGINE_EXPECT = {
    "tas": dict(
        cycles=456, admitted=800, checksum=0xc5be1efd,
        placements=0xc288e4dd, on_device=456, hybrid=0, fallback=0,
        host_root_reasons={}, placed=2815, memo_hits=0, commit_drops=2823,
        batch_calls=1828),
    "tas_large": dict(
        cycles=100, admitted=120, checksum=0x0ee1d4d2,
        placements=0x75070b6e, on_device=100, hybrid=0, fallback=0,
        host_root_reasons={}, placed=579, memo_hits=0, commit_drops=630,
        batch_calls=396),
    "tas_churn": dict(
        cycles=45, admitted=263, checksum=0x63450bb7,
        placements=0xd60b382d, on_device=13, hybrid=13, fallback=33,
        host_root_reasons={"tas-commit-conflict": 13, "tas-no-fit": 32},
        placed=154, memo_hits=0, commit_drops=0, batch_calls=70),
}
# Phase 26 (tas_engine_worlds.FULL["tas_lifecycle"], on the default
# loop): the JAX engine's numbers on the same world and calls, under
# either TAS path pin (arm_expect splits the placements, batch calls and
# replacement placements by path), and its pipeline_stats.
LIFECYCLE_EXPECT = dict(
    cycles=41, admitted=263, checksum=0xed7a2d86, placements=0xaa44addb,
    on_device=10, hybrid=9, fallback=32,
    host_root_reasons={"tas-commit-conflict": 9, "tas-no-fit": 31},
    placed=114, memo_hits=13, commit_drops=0, batch_calls=56,
    node_unhealthy=33, node_replaced=32, retries=5, replace_calls=37,
    events_crc=0x851c408f, final_crc=0xc8fb35a8)
LIFECYCLE_PIPELINE = dict(speculated=7, used=7, discarded=0, skipped=0)
# The mixed serving worlds (kueue_tpu_torch/bench/mixed_worlds.py FULL):
# the JAX engine's numbers on the same worlds and calls, with its serial
# cycle loop (tests/test_torch_mixed_worlds.py recomputes them).
MIXED_EXPECT = {
    "mixed_world": dict(
        cycles=101, admitted=7041, preempting=0, evicted=0, finished=0,
        checksum=0xf5d45a83, placements=0x0396321a, on_device=101,
        hybrid=82, fallback=1, overridden=98,
        host_root_reasons={"sim-multi-podset": 57, "tas-preemption": 504},
        fallback_reasons={"idle-inadmissible": 1}, afs_usage=0),
    "afs_serving": dict(
        cycles=9, admitted=9000, preempting=0, evicted=400, finished=7600,
        checksum=0x0c8d9fbc, placements=0x7498a0d8, on_device=9,
        hybrid=0, fallback=0, overridden=0, host_root_reasons={},
        fallback_reasons={}, afs_usage=0xdd3128cf),
}
# The deployed control plane's world (kueue_tpu_torch/bench/
# serve_world.py FULL): the JAX engine's final state after rebuilding the
# seeded journal and draining it with the 1,000 arrivals
# (tests/test_torch_serve.py recomputes it): the final-state checksum,
# the workloads holding quota and of them the arrivals.
SERVE_EXPECT = dict(checksum=0x41b5f911, admitted=50937,
                    arrivals_admitted=1000)
# The /metrics series of phase 19 that do not depend on when the loop
# ran: the JAX engine's after the same drain on its default loop
# (tests/test_torch_serve.py recomputes them): the admissions in all,
# the crc32 of the sample lines of admitted_workloads_total,
# pending_workloads (no sample: the deployed loop's cycles that set it
# are idle ones, which return before it),
# cluster_queue_resource_usage and local_queue_pending_workloads (the
# last two refreshed by the scrape from the final state), and the
# breaker's state.
SERVE_METRICS_EXPECT = dict(admitted_total=50937.0,
                            admitted_series=0xa4713e32, pending_series=0,
                            usage_series=0x257777d4,
                            lq_pending_series=0x8f28d4ae,
                            breaker_state={(): 0.0})
# Phase 21 posts the first quarter of the arrivals only.
BREAKER_ARRIVALS = 250
# Phase 21's world (serve_world.FULL with its first 250 arrivals): the
# JAX engine's final state (tests/test_torch_serve.py recomputes it).
SERVE_BREAKER_EXPECT = dict(checksum=0x638086c7, admitted=50187,
                            arrivals_admitted=250)
# Phases 22 and 23 (engine_worlds.DEFAULT_ARM): the JAX engine's numbers
# on its default loop, the speculation pipeline and the columnar apply
# on (tests/test_torch_engine_worlds.py recomputes them).
DEFAULT_ARM_EXPECT = {
    "cycle_latency": dict(
        cycles=9, admitted=9000, preempting=0, preemptions=0,
        checksum=0x32e2d6f0, on_device=9, hybrid=0, fallback=0,
        overridden=0, evicted=0,
        pipeline_stats=dict(speculated=9, used=8, discarded=0, skipped=0)),
    "preempt_churn": dict(
        cycles=39, admitted=600, preempting=231, preemptions=309,
        checksum=0xdce70507, on_device=39, hybrid=0, fallback=1,
        overridden=0, evicted=309,
        pipeline_stats=dict(speculated=38, used=37, discarded=0,
                            skipped=0)),
}
# Phases 24 and 25 (engine_worlds.OTHER_ARMS): the JAX engine's numbers
# with the per-entry assume, cycle_latency on the serial loop and
# preempt_churn on the speculation pipeline
# (tests/test_torch_engine_worlds.py recomputes them).
OTHER_ARMS_EXPECT = {
    "cycle_latency_serial": dict(
        cycles=9, admitted=9000, preempting=0, preemptions=0,
        checksum=0x32e2d6f0, on_device=9, hybrid=0, fallback=0,
        overridden=0, evicted=0,
        pipeline_stats=dict(speculated=0, used=0, discarded=0, skipped=0)),
    "preempt_churn_pipelined": dict(
        cycles=39, admitted=600, preempting=231, preemptions=309,
        checksum=0xdce70507, on_device=39, hybrid=0, fallback=1,
        overridden=0, evicted=309,
        pipeline_stats=dict(speculated=38, used=37, discarded=0,
                            skipped=0)),
}
TAS_EXPECT = dict(requests=440, placed=189, signatures=21,
                  per_pod_vectors=2, placements=0xe61bb495,
                  feasibility_empty=0x76cebe8a,
                  feasibility_final=0x99e5afa2, phase1=0xe7c953cf)


# Start times of the script's phases, for the wall split it prints.
_SPANS: list = []


def span(label: str) -> None:
    """Mark the start of a phase (and the end of the one before)."""
    _SPANS.append((label, time.perf_counter()))


def spans_line() -> str:
    marks = _SPANS + [("end", time.perf_counter())]
    return " ".join(f"{a}={t1 - t0:.1f}"
                    for (a, t0), (_b, t1) in zip(marks, marks[1:]))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def checksum(stats) -> int:
    return zlib.crc32(stats["admit_cycle"].tobytes()
                      + stats["admit_pos"].tobytes()
                      + stats["wl_flavor"].tobytes())


def heads_cases():
    """(name, eff_rank int64[W], wl_cq, C) on the host, seeded."""
    for w, c in HEADS_SHAPES:
        rng = np.random.default_rng(w * 1000 + c)
        rank = rng.permutation(w).astype(np.int64)
        cq = rng.integers(0, c, w).astype(np.int32)
        active = rng.random(w) > 0.3
        yield f"grid w={w} c={c}", np.where(active, rank, BIG_RANK), cq, c
    rng = np.random.default_rng(7)
    yield ("all inactive", np.full(4096, BIG_RANK, np.int64),
           rng.integers(0, 64, 4096).astype(np.int32), 64)
    cq = rng.integers(0, 100, 20000).astype(np.int32)
    cq[rng.random(20000) < 0.3] = -1
    yield ("cq=-1 rows", rng.permutation(20000).astype(np.int64), cq, 100)
    yield ("ranks up to BIG_RANK-1",
           BIG_RANK - 1 - rng.integers(0, 5000, 50000).astype(np.int64),
           rng.integers(0, 1000, 50000).astype(np.int32), 1000)
    yield ("int64 cq", rng.permutation(50000).astype(np.int64),
           rng.integers(0, 1000, 50000).astype(np.int64), 1000)


def phase_heads(dev, heads, pk):
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0
    for name, eff, cq, c in heads_cases():
        eff_t = torch.as_tensor(eff, device=dev)
        cq_t = torch.as_tensor(cq, device=dev)
        worst = max(worst, check_heads(heads, name, eff_t, cq_t, c, sms))

    # Timing at the drain's shape: W = 50,000 rows, C = 1,000 bins.
    eff_t, cq_t, C = pk.heads_drain_shape(dev)
    W = eff_t.numel()
    base = torch.full((C + 1,), BIG_RANK, dtype=torch.int64, device=dev)
    idx = torch.where((cq_t >= 0) & (cq_t < C), cq_t, C).long()

    def kernel():
        return heads.select_heads(eff_t, cq_t, C, BIG_RANK)

    kernel_ms = pk.time_ms(kernel)
    plain_ms = pk.time_ms(
        lambda: heads.select_heads_plain(eff_t, cq_t, C, BIG_RANK))
    library_ms = pk.time_ms(
        lambda: base.scatter_reduce(0, idx, eff_t, "amin",
                                    include_self=True))
    kernel_ms_2 = pk.time_ms(kernel)
    prof = pk.device_profile(kernel)
    names = [k["name"] for k in prof["kernels"]]
    if (prof["launches_per_call"] != 1
            or "heads_cluster_kernel" not in names[0]):
        raise AssertionError(f"select_heads made {prof['launches_per_call']}"
                             f" device launches a call at W={W} C={C}, "
                             f"want one heads_cluster_kernel: {names}")
    n_bytes = pk.heads_bytes(eff_t, cq_t, C)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = W / SCALAR_OPS_PER_S * 1e3
    print(f"  heads timing W={W} C={C}: kernel_ms={kernel_ms:.6f} "
          f"(again {kernel_ms_2:.6f}) device_ms={prof['device_ms']:.6f} "
          f"launches_per_call={prof['launches_per_call']:g} "
          f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
          f"bound_ms={max(bytes_ms, ops_ms):.6f} ({n_bytes} bytes)")
    return dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                device_ms=prof["device_ms"],
                launches_per_call=prof["launches_per_call"])


def check_heads(heads, name, eff_t, cq_t, c, sms, say=print) -> int:
    """The kernel against the plain version on one input, exact; returns
    the max abs error (0)."""
    import torch

    got = heads.select_heads(eff_t, cq_t, c, BIG_RANK)
    want = heads.select_heads_plain(eff_t, cq_t, c, BIG_RANK)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if c else 0
    if not torch.equal(got, want):
        raise AssertionError(f"heads kernel != plain on {name}: "
                             f"max abs err {err}")
    branch = heads.plan(eff_t.numel(), c, sms)
    say(f"  heads {name}: exact ("
          + ("global atomics" if branch == 0 else
             f"{branch} cluster{'s' if branch > 1 else ''}") + ")")
    return err


def leaf_cases(dev, pk):
    """(name, free, tas, assumed, per_pod, mask) as int64/bool tensors on
    ``dev``, seeded."""
    import torch

    from kueue_tpu_torch.bench import tas_world
    from kueue_tpu_torch.ops import tas as tops

    def on(*arrays):
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)

    for leaves, res in LEAF_GRID:
        rng = np.random.default_rng(leaves * 10 + res)
        yield (f"grid {leaves}x{res}",
               *on(rng.integers(0, 1000, (leaves, res)).astype(np.int64),
                   rng.integers(0, 500, (leaves, res)).astype(np.int64),
                   rng.integers(0, 100, (leaves, res)).astype(np.int64),
                   rng.integers(0, 8, res).astype(np.int64),
                   rng.random(leaves) > 0.2))
    gib = 2**30
    yield ("300 GiB", *on(np.array([[300 * gib]], np.int64),
                          np.array([[200 * gib]], np.int64),
                          np.zeros((1, 1), np.int64),
                          np.array([10 * gib], np.int64),
                          np.array([True])))
    rng = np.random.default_rng(31)
    big = rng.integers(2**31, 2**40, (4096, 2)).astype(np.int64)
    yield ("counts >= 2**31", *on(big, np.zeros_like(big), np.zeros_like(big),
                                  np.array([1, 0], np.int64),
                                  rng.random(4096) > 0.1))
    free = rng.integers(0, 10**6, (512, 3)).astype(np.int64)
    yield ("no requested column", *on(free, np.zeros_like(free),
                                      np.zeros_like(free),
                                      np.array([0, -5, 0], np.int64),
                                      np.ones(512, bool)))
    yield ("all leaves masked", *on(free, np.zeros_like(free),
                                    np.zeros_like(free),
                                    np.array([3, 1, 7], np.int64),
                                    np.zeros(512, bool)))
    snap = pk.forest_snapshot(dev)
    enc = tops.encode_tas_snapshot(snap, tas_world.PHASE1_RESOURCES)
    for cpu in (100, 1000):
        yield (f"forest 5120x2 cpu={cpu}",
               *on(enc["free_capacity"], enc["tas_usage"],
                   np.zeros_like(enc["tas_usage"]),
                   np.array([cpu, 1], np.int64),
                   np.ones(len(enc["free_capacity"]), bool)))
    yield ("65536x8 wrapping int64", *pk.leaf_wide(dev))
    # Each load path of the kernel: odd S and S = 1 (scalar loads), wide
    # rows, odd (33, scalar) and even (70, column pairs), and S = 2 with
    # every row 8 bytes off 16-byte alignment (scalar).
    for leaves, res in LEAF_PATHS:
        yield (f"{leaves}x{res} mixed widths",
               *on(*leaf_mixed(np.random.default_rng(leaves + res), leaves,
                               res)))
    free, tas, assumed, per_pod, mask = on(
        *leaf_mixed(np.random.default_rng(5122), 5120, 2))
    yield ("5120x2 rows off 16-byte alignment",
           *(off_by_one_element(t) for t in (free, tas, assumed)), per_pod,
           mask)


def leaf_mixed(rng, leaves, res):
    """Quantities of the forest's size with a tenth of them past 2**32, a
    few leaves over-used, and per-pod requests of 0, -1 and small values,
    and of 2**33 on column 2 (whose quantities are past 2**34): both the
    32-bit and the 64-bit division."""
    shape = (leaves, res)
    free = rng.integers(10**5, 10**6, shape).astype(np.int64)
    big = rng.random(shape) < 0.1
    free[big] = rng.integers(2**32, 2**40, int(big.sum()))
    tas = rng.integers(0, 10**5, shape).astype(np.int64)
    over = rng.random(shape) < 0.02
    tas[over] = rng.integers(10**6, 2**41, int(over.sum()))
    per_pod = rng.integers(-1, 9, res).astype(np.int64)
    per_pod[0] = max(int(per_pod[0]), 1)
    if res > 2:
        free[:, 2] = rng.integers(2**34, 2**44, leaves)
        per_pod[2] = 2**33
    return (free, tas, rng.integers(0, 100, shape).astype(np.int64),
            per_pod, rng.random(leaves) > 0.2)


def off_by_one_element(t):
    """A contiguous copy of ``t`` whose data starts 8 bytes past a
    16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if not view.is_contiguous() or view.data_ptr() % 16 != 8:
        raise AssertionError("the offset view is not 8 bytes off 16")
    return view


def phase_leaf(dev, leaf, pk):
    import torch

    worst = 0
    forest = None
    for name, free, tas, assumed, per_pod, mask in leaf_cases(dev, pk):
        got = leaf.leaf_fit_counts(free, tas, assumed, per_pod, mask)
        want = leaf.leaf_fit_counts_plain(free, tas, assumed, per_pod, mask)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"leaf kernel != plain on {name}: "
                                 f"max abs err {err}")
        if name == "300 GiB" and got.tolist() != [10]:
            raise AssertionError(f"300 GiB case gave {got.tolist()}, "
                                 f"want [10]")
        if name == "counts >= 2**31" and not bool((got < 0).any()):
            raise AssertionError("no count >= 2**31 reached the int32 "
                                 "conversion")
        if name.startswith("forest") and forest is None:
            forest = (free, tas, assumed, per_pod, mask)
        print(f"  leaf {name}: exact")

    rows = {}
    for shape, args in (("forest", forest), ("65536x8", pk.leaf_wide(dev))):
        L, S = args[0].shape

        def kernel(args=args):
            return leaf.leaf_fit_counts(*args)

        kernel_ms = pk.time_ms(kernel)
        plain_ms = pk.time_ms(lambda: leaf.leaf_fit_counts_plain(*args))
        kernel_ms_2 = pk.time_ms(kernel)
        prof = pk.device_profile(kernel)
        n_bytes = pk.leaf_bytes(args[0])
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        # two subtractions, a division and a minimum per (leaf, column)
        ops_ms = 4 * L * S / SCALAR_OPS_PER_S * 1e3
        launch = [(k["grid"], k["block"]) for k in prof["kernels"]]
        print(f"  leaf timing L={L} S={S}: kernel_ms={kernel_ms:.6f} "
              f"(again {kernel_ms_2:.6f}) device_ms={prof['device_ms']:.6f} "
              f"launches_per_call={prof['launches_per_call']:g} "
              f"grid/block={launch} plain_ms={plain_ms:.6f} "
              f"library_ms=none bound_ms={max(bytes_ms, ops_ms):.6f} "
              f"({n_bytes} bytes)")
        rows[shape] = dict(
            max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            device_ms=prof["device_ms"],
            launches_per_call=prof["launches_per_call"])
    return rows["forest"]


def phase_tas(dev, leaf, card):
    """The 5,120-node TAS world on the card against the JAX package's
    checksums; returns the leaf kernel's launches in it."""
    import torch

    from kueue_tpu_torch.bench import tas_world

    backend = tas_world.PortBackend(dev)
    leaf.launches = 0
    torch.cuda.synchronize()
    got = tas_world.run(backend, tas_world.FULL)
    torch.cuda.synchronize()
    launches = leaf.launches
    for key, want in TAS_EXPECT.items():
        print(f"  {key}: {got[key]:#010x}" if key in (
            "placements", "feasibility_empty", "feasibility_final",
            "phase1") else f"  {key}: {got[key]}")
        if got[key] != want:
            raise AssertionError(f"TAS world {key}: got {got[key]}, want "
                                 f"{want}")
    if launches != TAS_EXPECT["per_pod_vectors"]:
        raise AssertionError(f"leaf kernel launched {launches} times in "
                             f"the TAS run, want "
                             f"{TAS_EXPECT['per_pod_vectors']}")
    sec = got["seconds"]
    n_dev = got["device_placements"]
    print(f"  place: {sec['place']:.3f} s for {got['requests']} requests, "
          f"{n_dev} reached try_find: "
          f"{backend.device_seconds / n_dev * 1e3:.3f} ms per try_find | "
          f"{card}")
    print(f"  feasibility: {sec['feasibility_empty'] * 1e3:.3f} ms "
          f"(empty, first launch) {sec['feasibility_final'] * 1e3:.3f} ms "
          f"(final) per launch of {got['signatures']} signatures | {card}")
    print(f"  phase 1: {sec['phase1'] / got['per_pod_vectors'] * 1e3:.3f} "
          f"ms per call (encode, leaf kernel, bubble) | {card}")
    print(f"  leaf_launches={launches}")
    return launches


def check_launches(heads, label, cycles):
    """The heads kernel must have launched once per cycle of the run
    that just ended."""
    if heads.launches != cycles:
        raise AssertionError(f"{label}: heads kernel launched "
                             f"{heads.launches} times in {cycles} cycles")


def phase_hier_fair(heads, pk, card, sms):
    """The 40,000-workload fair drain against the JAX package's
    decisions; returns the heads kernel's launches in it."""
    import torch

    from kueue_tpu_torch.bench.scenario import hierarchical_fair
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    t0 = time.perf_counter()
    scen = hierarchical_fair(n_workloads=40_000)
    solver = BatchedDrainSolver(
        build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors, []),
        scen.pending_infos(), fair=True)
    encode_s = time.perf_counter() - t0
    heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = heads.launches
    check(stats, HIER_FAIR_EXPECT, "hier_fair 40000 workloads")
    check_launches(heads, "hier_fair", stats["cycles"])
    t0 = time.perf_counter()
    _, again = solver.solve()
    torch.cuda.synchronize()
    solve2_s = time.perf_counter() - t0
    check(again, HIER_FAIR_EXPECT, "hier_fair, second solve")
    eff_t, cq_t, C = pk.drain_first_cycle_heads(solver)
    check_heads(heads, f"hier_fair first cycle w={eff_t.numel()} c={C}",
                eff_t, cq_t, C, sms)
    print(f"  encode_s={encode_s:.3f} solve_s={solve_s:.3f} "
          f"ms_per_cycle={solve_s / stats['cycles'] * 1e3:.3f} "
          f"second solve_s={solve2_s:.3f} "
          f"ms_per_cycle={solve2_s / stats['cycles'] * 1e3:.3f} "
          f"heads_launches={launches} | {card}")
    return launches


def phase_preempt_world(heads, pk, card, sms):
    """The 20,000-workload preemption world through the port's executor
    against the JAX package's decisions; returns the heads kernel's
    launches in it."""
    import torch

    from kueue_tpu_torch.bench import preempt_world
    from kueue_tpu_torch.oracle.service import TorchExecutor

    t0 = time.perf_counter()
    world = preempt_world.build(**preempt_world.FULL)
    build_s = time.perf_counter() - t0
    executor = TorchExecutor()
    heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = preempt_world.run(world, executor.cycle_step)
    solve_s = time.perf_counter() - t0
    launches = heads.launches
    got = {k: stats[k] for k in PREEMPT_EXPECT}
    print(f"  cycles={got['cycles']} admitted={got['admitted']} "
          f"preempting={got['preempting']} victims={got['victims']} "
          f"overflow={got['overflow']} checksum=0x{got['checksum']:08x}")
    if got != PREEMPT_EXPECT:
        raise AssertionError(f"preemption world: got {got}, want "
                             f"{PREEMPT_EXPECT}")
    check_launches(heads, "preemption world", stats["cycles"])
    eff_t, cq_t, C = pk.first_heads_inputs(
        lambda: preempt_world.run(world, executor.cycle_step, max_cycles=1))
    check_heads(heads, f"preemption world first cycle w={eff_t.numel()} "
                f"c={C}", eff_t, cq_t, C, sms)
    print(f"  build_s={build_s:.3f} (fill drain on the card) "
          f"solve_s={solve_s:.3f} "
          f"ms_per_cycle={solve_s / stats['cycles'] * 1e3:.3f} "
          f"heads_launches={launches} | {card}")
    return launches


def dispatched(r) -> int:
    """The device cycles a run dispatched, so the heads launches it must
    show: the cycles that encoded afresh (device cycles less the used
    speculations) and every speculation (used or discarded)."""
    ps = r["pipeline_stats"]
    return r["on_device"] - ps.get("used", 0) + ps.get("speculated", 0)


def phase_engine(name, config, expect, heads, pk, card, sms):
    """One serving-engine run of kueue_tpu_torch/bench/engine_worlds.py
    (Engine.schedule_once through the OracleBridge and TorchExecutor)
    against the JAX engine's pinned numbers, with the heads kernel
    launched once per dispatched device cycle and held against its plain
    version on the run's first-cycle inputs. ``config`` is an entry of
    FULL (the serial loop with the columnar apply), DEFAULT_ARM or
    OTHER_ARMS, run on the loop arm it names; for the last two the
    evictions and pipeline_stats are pinned too (engine_worlds.
    arm_pinned). Returns its heads launches."""
    from kueue_tpu_torch.bench import engine_worlds as ew

    box = {}
    heads.launches = 0
    t0 = time.perf_counter()
    eff_t, cq_t, C = pk.first_heads_inputs(
        lambda: box.update(r=ew.run(config)))
    total_s = time.perf_counter() - t0
    launches = heads.launches
    r = box["r"]
    got = (ew.arm_pinned(r) if "pipeline_stats" in expect
           else {k: r[k] for k in ew.PINNED})
    print("  " + " ".join(
        f"{k}=0x{v:08x}" if k == "checksum" else f"{k}={v}"
        for k, v in got.items()))
    if got != expect:
        raise AssertionError(f"{name}: got {got}, want {expect}")
    if launches != dispatched(r):
        raise AssertionError(
            f"{name}: heads kernel launched {launches} times for "
            f"{r['on_device']} device cycles and pipeline_stats "
            f"{r['pipeline_stats']}")
    check_heads(heads, f"{name} first cycle w={eff_t.numel()} c={C}",
                eff_t, cq_t, C, sms)
    times = sorted(r["cycle_seconds"])
    p50 = times[len(times) // 2]
    p95 = times[min(len(times) - 1, int(len(times) * 0.95))]
    mean = {ph: sum(p.get(ph, 0.0) for p in r["phases"]) / len(r["phases"])
            for ph in ("encode", "sim", "device", "apply", "finalize",
                       "spec_encode")}
    print(f"  timed_cycles={len(times)} p50_s={p50:.4f} p95_s={p95:.4f} "
          "mean_phases_s=" + ",".join(f"{k}:{v:.4f}" for k, v in mean.items())
          + f" run_s={total_s:.2f} heads_launches={launches} | {card}")
    return launches


def phase_tas_engine(name, heads, pk, card, sms):
    """One TAS world of kueue_tpu_torch/bench/tas_engine_worlds.py through
    Engine.schedule_once, every arm against the JAX engine's numbers,
    with the heads kernel launched once per device cycle and held
    against its plain version on the world's first-cycle inputs.
    Returns its heads launches over all arms."""
    import torch

    from kueue_tpu_torch.bench import tas_engine_worlds as tw

    config = tw.FULL[name]
    launches = 0
    first = None
    cycle_ms = {}
    for path, feas in tw.ARMS[name]:
        box = {}
        heads.launches = 0
        t0 = time.perf_counter()

        def run(path=path, feas=feas, box=box):
            box["r"] = tw.run(config, path, feas,
                              sync=torch.cuda.synchronize)

        if first is None:
            first = pk.first_heads_inputs(run)
        else:
            run()
        total_s = time.perf_counter() - t0
        r = box["r"]
        launches += heads.launches
        got = tw.pinned_numbers(r)
        want = tw.arm_expect(TAS_ENGINE_EXPECT[name], path)
        print(f"  [{path} feas={feas}] " + " ".join(
            f"{k}=0x{v:08x}" if k in ("checksum", "placements")
            else f"{k}={v}" for k, v in got.items()))
        if got != want:
            raise AssertionError(f"{name} {path} feas={feas}: got {got}, "
                                 f"want {want}")
        if heads.launches != dispatched(r):
            raise AssertionError(
                f"{name} {path}: heads kernel launched {heads.launches} "
                f"times for {r['on_device']} device cycles and "
                f"pipeline_stats {r['pipeline_stats']}")
        times = sorted(r["cycle_seconds"])
        p50 = times[len(times) // 2]
        p95 = times[min(len(times) - 1, int(len(times) * 0.95))]
        cycle_ms[(path, feas)] = sum(times) / len(times) * 1e3
        per_call = (r["batch_heads"] / r["batch_calls"]
                    if r["batch_calls"] else 0.0)
        ts = r["tas_seconds"]
        print(f"  [{path} feas={feas}] timed_cycles={len(times)} "
              f"p50_s={p50:.4f} p95_s={p95:.4f} "
              f"mean_cycle_ms={cycle_ms[(path, feas)]:.3f} "
              f"planner_s=encode:{ts['encode']:.4f},"
              f"place:{ts['place']:.4f},decode:{ts['decode']:.4f} "
              f"tas_place_batch_calls={r['batch_calls']} "
              f"heads_per_call={per_call:.3f} run_s={total_s:.2f} "
              f"heads_launches={heads.launches} | {card}")
    eff_t, cq_t, C = first
    check_heads(heads, f"{name} first cycle w={eff_t.numel()} c={C}",
                eff_t, cq_t, C, sms)
    if name == "tas_churn":
        print(f"  churn cycle ms, feasibility batch on: device "
              f"{cycle_ms[('device', '1')]:.3f} host "
              f"{cycle_ms[('host', '1')]:.3f}; off: device "
              f"{cycle_ms[('device', '0')]:.3f} host "
              f"{cycle_ms[('host', '0')]:.3f} | {card}")
    xo = tw.crossover_measure(config, sync=torch.cuda.synchronize)
    print(f"  crossover probe: host_place_ms={xo['host_place_ms']:.4f} "
          f"device_place_ms={xo['device_place_ms']:.4f} | {card}")
    return launches


def phase_lifecycle(heads, pk, card, sms):
    """Phase 26: tas_lifecycle through Engine.schedule_once on the
    default loop, each TAS path pin against the JAX engine's numbers and
    pipeline_stats, with the heads kernel launched once per dispatched
    device call and held against its plain version on the world's
    first-cycle inputs. Returns its heads launches over both arms."""
    import torch

    from kueue_tpu_torch.bench import tas_engine_worlds as tw

    config = tw.FULL["tas_lifecycle"]
    launches = 0
    first = None
    for path, feas in tw.ARMS["tas_lifecycle"]:
        box = {}
        heads.launches = 0
        t0 = time.perf_counter()

        def run(path=path, feas=feas, box=box):
            box["r"] = tw.run(config, path, feas,
                              sync=torch.cuda.synchronize)

        if first is None:
            first = pk.first_heads_inputs(run)
        else:
            run()
        total_s = time.perf_counter() - t0
        r = box["r"]
        launches += heads.launches
        got = tw.pinned_numbers(r)
        want = tw.arm_expect(LIFECYCLE_EXPECT, path)
        print(f"  [{path} feas={feas}] " + " ".join(
            f"{k}=0x{v:08x}" if k in ("checksum", "placements",
                                      "events_crc", "final_crc")
            else f"{k}={v}" for k, v in got.items()))
        if got != want:
            raise AssertionError(f"tas_lifecycle {path}: got {got}, "
                                 f"want {want}")
        if r["pipeline_stats"] != LIFECYCLE_PIPELINE:
            raise AssertionError(
                f"tas_lifecycle {path}: pipeline_stats "
                f"{r['pipeline_stats']}, want {LIFECYCLE_PIPELINE}")
        if heads.launches != dispatched(r):
            raise AssertionError(
                f"tas_lifecycle {path}: heads kernel launched "
                f"{heads.launches} times for {r['on_device']} device "
                f"cycles and pipeline_stats {r['pipeline_stats']}")
        if r["replace_device_placements"] != r["replace_device"]:
            raise AssertionError(
                f"tas_lifecycle {path}: {r['replace_device_placements']} "
                f"replacement placements on the device program, "
                f"{r['replace_device']} calls off the host descent")
        times = sorted(r["cycle_seconds"])
        p50 = times[len(times) // 2]
        p95 = times[min(len(times) - 1, int(len(times) * 0.95))]
        sp_ms = [s * 1e3 for s in r["second_pass_s"]]
        print(f"  [{path} feas={feas}] churn_cycles={len(times)} "
              f"p50_s={p50:.4f} p95_s={p95:.4f} "
              f"replacements: device={r['replace_device']} "
              f"host={r['replace_host']} "
              f"run_s={total_s:.2f} heads_launches={heads.launches} "
              f"| {card}")
        print(f"  [{path} feas={feas}] second_pass_ms per churn cycle: "
              + ",".join(f"{v:.3f}" for v in sp_ms)
              + f" (max {max(sp_ms):.3f}) | {card}")
    eff_t, cq_t, C = first
    check_heads(heads, f"tas_lifecycle first cycle w={eff_t.numel()} "
                f"c={C}", eff_t, cq_t, C, sms)
    return launches


def phase_mixed(name, heads, pk, card, sms):
    """One run of kueue_tpu_torch/bench/mixed_worlds.py through
    Engine.schedule_once against the JAX engine's pinned numbers, with
    the heads kernel launched once per device cycle and held against its
    plain version on the run's first-cycle inputs. Returns its heads
    launches."""
    from kueue_tpu_torch.bench import mixed_worlds as mw

    box = {}
    heads.launches = 0
    t0 = time.perf_counter()
    eff_t, cq_t, C = pk.first_heads_inputs(
        lambda: box.update(r=mw.run(mw.FULL[name])))
    total_s = time.perf_counter() - t0
    launches = heads.launches
    r = box["r"]
    got = {k: r[k] for k in mw.PINNED}
    print("  " + " ".join(
        f"{k}=0x{v:08x}" if k in ("checksum", "placements", "afs_usage")
        else f"{k}={v}" for k, v in got.items()))
    if got != MIXED_EXPECT[name]:
        raise AssertionError(f"{name}: got {got}, want {MIXED_EXPECT[name]}")
    if launches != dispatched(r):
        raise AssertionError(
            f"{name}: heads kernel launched {launches} times for "
            f"{r['on_device']} device cycles and pipeline_stats "
            f"{r['pipeline_stats']}")
    check_heads(heads, f"{name} first cycle w={eff_t.numel()} c={C}",
                eff_t, cq_t, C, sms)
    times = sorted(r["cycle_seconds"])
    p50 = times[len(times) // 2]
    p95 = times[min(len(times) - 1, int(len(times) * 0.95))]
    mean = {ph: sum(p.get(ph, 0.0) for p in r["phases"]) / len(r["phases"])
            * 1e3 for ph in ("encode", "sim", "device", "apply", "finalize",
                             "tas_place")}
    print(f"  timed_cycles={len(times)} p50_s={p50:.4f} "
          f"p95_s={p95:.4f} mean_phases_ms="
          + ",".join(f"{k}:{v:.3f}" for k, v in mean.items())
          + f" outcomes={r['outcomes']} run_s={total_s:.2f} "
          f"heads_launches={launches} | {card}")
    return launches


def pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


def phase_samples_line(samples) -> str:
    keys = sorted({k for p in samples for k in p})
    return ",".join(
        f"{k}:p50={pct([p.get(k, 0.0) for p in samples], 0.5) * 1e3:.3f}"
        f"/p95={pct([p.get(k, 0.0) for p in samples], 0.95) * 1e3:.3f}"
        for k in keys)


def serve_views(sw, url):
    return sw.get_json(url, "/workloads"), sw.get_json(url, "/debug/dump")


def check_serve_state(sw, views, label, say=print, expect=None):
    expect = expect or SERVE_EXPECT
    got = sw.final_state(*views)
    say(f"  {label}: checksum=0x{got['checksum']:08x} "
          f"admitted={got['admitted']} "
          f"arrivals_admitted={got['arrivals_admitted']}")
    if got != expect:
        raise AssertionError(f"{label}: got {got}, want {expect}")


def serve_metrics(sw, text) -> dict:
    """The numbers of SERVE_METRICS_EXPECT, from a /metrics text."""
    return dict(
        admitted_total=sum(sw.metric_values(
            text, "admitted_workloads_total").values()),
        admitted_series=sw.metrics_digest(text, "admitted_workloads_total"),
        pending_series=sw.metrics_digest(text, "pending_workloads"),
        usage_series=sw.metrics_digest(text, "cluster_queue_resource_usage"),
        lq_pending_series=sw.metrics_digest(
            text, "local_queue_pending_workloads"),
        breaker_state=sw.metric_values(text, "oracle_breaker_state"))


def check_serve_metrics(sw, text, oracle):
    """Phase 19's /metrics scrape: the series that do not depend on when
    the loop's idle iterations ran against the JAX package's, and the
    bridge's counters against the process's own /oracle view."""
    got = serve_metrics(sw, text)
    print("  /metrics: " + " ".join(
        f"{k}=0x{v:08x}" if k.endswith("_series") else f"{k}={v}"
        for k, v in got.items()))
    if got != SERVE_METRICS_EXPECT:
        raise AssertionError(f"/metrics: got {got}, want "
                             f"{SERVE_METRICS_EXPECT}")
    cycles = sw.metric_values(text, "oracle_cycles_total")
    fallback = sw.metric_values(text, "oracle_fallback_total")
    print(f"  /metrics: oracle_cycles_total={cycles} "
          f"oracle_fallback_total={fallback}")
    device = cycles.get(("device",), 0) + cycles.get(("hybrid",), 0)
    if device != oracle["cyclesOnDevice"]:
        raise AssertionError(f"oracle_cycles_total {cycles}, /oracle "
                             f"{oracle['cyclesOnDevice']} device cycles")
    if (any(not k[0].startswith("idle-") for k in fallback)
            or cycles.get(("fallback",), 0) != sum(fallback.values())):
        raise AssertionError(f"fallbacks {fallback}, cycles {cycles}")


def check_arrivals_once(sw, path, label, arrivals):
    """Each of the ``arrivals`` arrivals' journal records went from not
    admitted to admitted exactly once."""
    st = sw.journal_state(path)
    arr = {k: n for k, n in st["transitions"].items()
           if k.startswith("default/arrival-")}
    if len(arr) != arrivals or set(arr.values()) != {1}:
        raise AssertionError(
            f"{label}: {len(arr)} arrivals admitted, admissions per key "
            f"{sorted(set(arr.values()))}")
    return st


def stop_all(procs):
    for p in procs:
        if p.p.poll() is None:
            p.p.kill()
            p.p.wait()


def phase_serve(seed, work, bodies, card):
    """Phase 19: the sidecar on the card behind the serve process.
    Returns the sidecar's heads launches."""
    from kueue_tpu_torch.bench import serve_world as sw

    path = work / "p19.jsonl"
    shutil.copy(seed, path)
    procs = []
    try:
        side, port = sw.start_sidecar("cuda")
        procs.append(side)
        serve, url, boot = sw.start_serve(path, f"127.0.0.1:{port}", "cuda")
        procs.append(serve)
        t0 = time.perf_counter()
        posted = sw.post_arrivals(url, bodies, sw.FULL["rate"])
        idle = sw.wait_idle(url, 900, dump_every=30.0)
        drain_s = time.perf_counter() - t0
        views = serve_views(sw, url)
        text, scrape_s, scrape_bytes = sw.get_text(url, "/metrics")
        oracle = sw.get_json(url, "/oracle")
        rc, last = serve.stop()
        side_rc, side_last = side.stop()
    finally:
        stop_all(procs)
    if set(posted["codes"]) != {201}:
        raise AssertionError(f"POST codes {sorted(set(posted['codes']))}")
    check_serve_state(sw, views, "final state")
    check_arrivals_once(sw, path, "arrivals", sw.FULL["arrivals"])
    check_serve_metrics(sw, text, oracle)
    fb = idle["oracle"]["fallbackReasons"]
    if any(not k.startswith("idle-") for k in fb):
        raise AssertionError(f"fallback cycles {fb}")
    if (rc, side_rc) != (0, 0):
        raise AssertionError(f"exit codes serve={rc} sidecar={side_rc}")
    cycles = last["cycles_on_device"]
    calls = dispatched(dict(on_device=cycles,
                            pipeline_stats=last["pipeline_stats"]))
    if not (side_last["heads_launches"] == side_last["compute_replies"]
            == calls > 0):
        raise AssertionError(
            f"sidecar heads launches {side_last['heads_launches']}, "
            f"replies {side_last['compute_replies']}, device cycles "
            f"{cycles}, pipeline_stats {last['pipeline_stats']}")
    lat = posted["latencies"]
    print(f"  restart: journal_bytes={boot['bytes']} "
          f"records={boot['records']} rebuild_s={boot['rebuild_s']:.3f} "
          f"boot_wall_s={boot['wall_s']:.3f}")
    print(f"  device_cycles={cycles} dispatched={calls} fallback={fb} "
          f"drain_s={drain_s:.3f} mean_cycle_s={drain_s / cycles:.5f} "
          f"frame_bytes_per_call in={side_last['bytes_in'] / calls:.0f} "
          f"out={side_last['bytes_out'] / calls:.0f}")
    print(f"  pipeline_stats={last['pipeline_stats']} "
          f"metrics_scrape bytes={scrape_bytes} s={scrape_s:.4f}")
    print(f"  POST p50_s={pct(lat, 0.5):.5f} p95_s={pct(lat, 0.95):.5f} "
          f"post_wall_s={posted['seconds']:.3f}")
    print("  serve loop s: " + ",".join(
        f"{k}={v:.3f}" for k, v in last["loop_s"].items()))
    print(f"  sampled phases ms ({len(idle['phase_samples'])} dumps): "
          + phase_samples_line(idle["phase_samples"]))
    print(f"  phases ms of the /oracle polls that saw a new device cycle "
          f"({len(idle['oracle_samples'])}): "
          + phase_samples_line(idle["oracle_samples"]))
    print(f"  heads_launches={side_last['heads_launches']} (sidecar) "
          f"| {card}")
    return side_last["heads_launches"]


def check_usage(capacity, cohorts):
    """No ClusterQueue and no cohort uses more than its cohort's
    quota."""
    quota = {c["name"]: c["subtreeQuota"] for c in cohorts}
    for c in cohorts:
        for k, v in c["usage"].items():
            if v > c["subtreeQuota"].get(k, 0):
                raise AssertionError(f"cohort {c['name']} uses {v} of "
                                     f"{k}, quota {c['subtreeQuota']}")
    for row in capacity:
        k = f"{row['flavor']}/{row['resource']}"
        if row["usage"] > quota[row["cohort"]].get(k, 0):
            raise AssertionError(f"{row['clusterQueue']} uses "
                                 f"{row['usage']} of {k}")


# Phase 20's recovery flags: the first process seals the seeded active
# file at its first non-idle sync, checkpoints every 12 non-idle cycles
# and deletes segment 0 once its first checkpoint (in segment 1) is
# written; the restarted one checkpoints every RESTART_CKPT_INTERVAL.
RECOVERY_FLAGS = ("--checkpoint-keep", "2", "--segment-records", "20000",
                  "--min-free-bytes", "1048576")
FIRST_CKPT_INTERVAL = 12
RESTART_CKPT_INTERVAL = 250


class SegmentKeeper:
    """Hard-links each sealed segment of the journal at ``path`` into
    ``side`` as it appears (every 20 ms, in a thread): a link keeps the
    segment's inode after the journal's retention unlinks its name, so
    the genesis chain stays readable."""

    def __init__(self, path, side):
        self.path, self.side = Path(path), Path(side)
        self.side.mkdir()
        self.missed = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def sweep(self):
        import os

        base = self.path.name + ".seg"
        with self._lock:
            for src in self.path.parent.glob(base + "*"):
                dst = self.side / src.name
                if not src.name[len(base):].isdigit() or dst.exists():
                    continue
                try:
                    os.link(src, dst)
                except FileNotFoundError:
                    self.missed.append(src.name)

    def _run(self):
        while not self._stop.wait(0.02):
            self.sweep()

    def stop(self):
        self._stop.set()
        self._thread.join()
        self.sweep()

    def chain(self, dest):
        """``dest``/<journal name>: every sealed segment kept (linked)
        and a copy of the active file, the whole genesis chain. Fails
        when a sealed ordinal was not kept."""
        import os

        from kueue_tpu_torch.store.journal import read_active_ordinal

        self.sweep()
        kept = sorted(self.side.iterdir())
        want = [f"{self.path.name}.seg{o:06d}"
                for o in range(read_active_ordinal(str(self.path)))]
        if [k.name for k in kept] != want or self.missed:
            raise AssertionError(f"segments kept {[k.name for k in kept]}, "
                                 f"sealed {want}, missed {self.missed}")
        dest = Path(dest)
        dest.mkdir()
        for k in kept:
            os.link(k, dest / k.name)
        shutil.copy(self.path, dest / self.path.name)
        return dest / self.path.name


def statvfs_s(path, n=20_000) -> float:
    """Mean wall seconds of one os.statvfs on ``path``'s filesystem."""
    import os

    t0 = time.perf_counter()
    for _ in range(n):
        os.statvfs(path)
    return (time.perf_counter() - t0) / n


def phase_restart(seed, work, bodies, card, kill_after=30, say=print):
    """Phase 20: the serve process (oracle in-process) with checkpoints,
    segment rotation and the disk budget on, SIGKILLed after
    ``kill_after`` device cycles once retention deleted segment 0, and
    restarted on the same journal, which it can only recover through a
    checkpoint; checks the invariants. Returns the restarted process's
    heads launches."""
    import os

    from kueue_tpu_torch.bench import serve_world as sw
    from kueue_tpu_torch.store.checkpoint import (
        CheckpointStore,
        recover_engine,
    )
    from kueue_tpu_torch.store.journal import (
        read_active_ordinal,
        rebuild_engine,
    )
    from kueue_tpu_torch.visibility.server import dump_state

    path = work / "p20.jsonl"
    seg0 = work / "p20.jsonl.seg000000"
    shutil.copy(seed, path)
    store = CheckpointStore.for_journal(str(path))
    keeper = SegmentKeeper(path, work / "p20-kept")
    procs = []
    try:
        serve, url, boot = sw.start_serve(
            path, "local", "cuda", extra=RECOVERY_FLAGS + (
                "--checkpoint-interval", str(FIRST_CKPT_INTERVAL)))
        procs.append(serve)
        box = {}
        poster = threading.Thread(target=lambda: box.update(
            r=sw.post_arrivals(url, bodies, sw.FULL["rate"])))
        poster.start()
        deadline = time.monotonic() + 600
        while (sw.get_json(url, "/oracle")["cyclesOnDevice"] < kill_after
               or seg0.exists()):
            if time.monotonic() > deadline:
                raise TimeoutError("serve loop too slow to kill, or "
                                   "segment 0 never deleted")
            time.sleep(0.02)
        rc, _ = serve.stop(signal.SIGKILL)
        poster.join()
        seg0_gone = not seg0.exists()
        first_ckpts = store._indexed()[-1][0] if store._indexed() else 0
        torn = sw.torn_tail(path)
        # What the journal held at the kill, read from its genesis chain
        # (the kept segments and the killed process's active file).
        before = sw.journal_state(keeper.chain(work / "p20-kill"))
        serve2, url2, boot2 = sw.start_serve(
            path, "local", "cuda", extra=RECOVERY_FLAGS + (
                "--checkpoint-interval", str(RESTART_CKPT_INTERVAL)))
        procs.append(serve2)
        reposted = sw.post_arrivals(url2, bodies, sw.FULL["rate"])
        sw.wait_idle(url2, 900, dump_every=15.0)
        views = serve_views(sw, url2)
        capacity = sw.get_json(url2, "/capacity")
        cohorts = sw.get_json(url2, "/cohorts")
        rc2, last2 = serve2.stop()
    finally:
        stop_all(procs)
        keeper.stop()
    if rc != -signal.SIGKILL or rc2 != 0:
        raise AssertionError(f"exit codes {rc}, {rc2}")
    if not seg0_gone:
        raise AssertionError("segment 0 still there at the kill")
    if boot["source"] != "genesis" or boot2["source"] != "checkpoint" \
            or not boot2["base"] or boot2["records"] != \
            boot2["base"] + boot2["suffix"]:
        raise AssertionError(f"boots {boot}, {boot2}: the restart did not "
                             f"come through a checkpoint")
    if last2["checkpoint_failures"] or not last2["checkpoints_written"]:
        raise AssertionError(
            f"restarted serve: {last2['checkpoints_written']} checkpoints "
            f"written, {last2['checkpoint_failures']} failed")
    # Every checkpoint file loads clean. Each load is also what the JAX
    # package's write does to check a checkpoint it wrote, and what its
    # retention does for each file (live_metas); the port reads the
    # bytes back, and reads the headers for retention: both timed here.
    ckpts = store._indexed()
    bad, load_s, readback_s = [], [], []
    for i, p in ckpts:
        data = Path(p).read_bytes()
        t0 = time.perf_counter()
        loaded = store.load(i, p)
        t1 = time.perf_counter()
        with open(p, "rb") as fh:
            same = fh.read() == data
        readback_s.append(time.perf_counter() - t1)
        load_s.append(t1 - t0)
        if loaded is None or not same:
            bad.append(p)
    if not ckpts or bad:
        raise AssertionError(f"checkpoints {ckpts}: {bad} do not load")
    t0 = time.perf_counter()
    metas = store.live_metas()
    live_metas_s = time.perf_counter() - t0
    if [m.index for m in metas] != [i for i, _p in reversed(ckpts)]:
        raise AssertionError(f"live_metas {metas} against files {ckpts}")
    if set(reposted["codes"]) - {200, 201}:
        raise AssertionError(f"re-POST codes {sorted(set(reposted['codes']))}")
    if sw.torn_tail(path):
        raise AssertionError("the journal's torn tail was not repaired")
    # The whole journal set: every segment the two processes sealed
    # (kept aside), the active file, and, once the genesis chain has
    # been read, the checkpoints.
    sealed = read_active_ordinal(str(path))
    left = sorted(s.name[-6:] for s in work.glob("p20.jsonl.seg*"))
    copy = keeper.chain(work / "p20-rebuild")
    after = check_arrivals_once(sw, copy, "arrivals", len(bodies))
    lost = before["admitted"] - set(views[1]["admitted"])
    if lost or not before["admitted"] <= after["admitted"]:
        raise AssertionError(f"{len(lost)} admissions lost in the restart")
    if max(after["transitions"].values()) != 1:
        raise AssertionError("a workload was admitted twice")
    check_usage(capacity, cohorts)
    got = sw.final_state(*views)
    if got["arrivals_admitted"] != len(bodies):
        raise AssertionError(f"arrivals admitted {got}")
    if last2["heads_launches"] != dispatched(dict(
            on_device=last2["cycles_on_device"],
            pipeline_stats=last2["pipeline_stats"])):
        raise AssertionError(f"restarted serve: heads launches "
                             f"{last2['heads_launches']}, device cycles "
                             f"{last2['cycles_on_device']}, pipeline_stats "
                             f"{last2['pipeline_stats']}")
    shutil.copytree(store.directory, copy.parent / "p20.jsonl.ckpt")
    # Checkpoint plus suffix against the genesis replay of every record.
    t0 = time.perf_counter()
    _eng, report = recover_engine(str(copy), {"device": "cpu"},
                                  prove_genesis=True)
    prove_s = time.perf_counter() - t0
    del _eng
    if report["source"] != "checkpoint" or not report["identical"]:
        raise AssertionError(f"recover_engine(prove_genesis=True): "
                             f"{report}")
    # The port's rebuild_engine of the same set, drained to idle on the
    # host (the parked workloads it re-activates park again), comes
    # through a checkpoint and gives the live engine's dump.
    t0 = time.perf_counter()
    eng = rebuild_engine(str(copy), device="cpu")
    rebuild_s = time.perf_counter() - t0
    if eng.rebuild_source != "checkpoint":
        raise AssertionError(f"final rebuild from {eng.rebuild_source}")
    sw.drain_in_process(eng)
    eng.journal.close()
    rebuilt = json.loads(json.dumps(dump_state(eng)))
    live = views[1]
    # The phases and the unadmitted gauges are the process's own, never
    # journaled: a rebuild starts them empty.
    for d in (rebuilt, live):
        d.pop("lastCyclePhases")
        d.pop("unadmittedByReason")
    if rebuilt != live:
        raise AssertionError("rebuild_engine of the final journal set "
                             "differs from the live engine's dump_state")
    per_statvfs = statvfs_s(str(work))
    say(f"  killed after {kill_after} device cycles: torn_tail={torn} "
        f"admitted_before_kill={len(before['admitted'])} "
        f"seg000000_deleted={seg0_gone} checkpoints_written_before_kill="
        f"{first_ckpts} final: checksum=0x{got['checksum']:08x} "
        f"admitted={got['admitted']}")
    say(f"  restart: source={boot2['source']} base={boot2['base']} "
        f"suffix={boot2['suffix']} active_bytes={boot2['bytes']} "
        f"rebuild_s={boot2['rebuild_s']:.3f} boot_wall_s="
        f"{boot2['wall_s']:.3f} (first boot, genesis: records="
        f"{boot['records']} rebuild_s={boot['rebuild_s']:.3f} boot_wall_s="
        f"{boot['wall_s']:.3f}); final in-process rebuild: source="
        f"{eng.rebuild_source} base={eng.rebuild_base_records} suffix="
        f"{eng.rebuild_suffix_records} rebuild_s={rebuild_s:.3f}; "
        f"recover_engine(prove_genesis=True): base="
        f"{report['base_records']} suffix={report['suffix_records']} "
        f"identical={report['identical']} state={report['state']} "
        f"s={prove_s:.3f}")
    say(f"  checkpoints: restarted serve wrote "
        f"{last2['checkpoints_written']} (interval "
        f"{RESTART_CKPT_INTERVAL}) failures={last2['checkpoint_failures']} "
        f"write_s mean={last2['checkpoint_write_mean_s']:.3f} "
        f"max={last2['checkpoint_write_max_s']:.3f}; files "
        f"{[i for i, _p in ckpts]} bytes "
        f"{[os.path.getsize(p) for _i, p in ckpts]}; segments sealed="
        f"{sealed} on disk={left}")
    say(f"  checking a written checkpoint (files {[i for i, _p in ckpts]}): "
        f"load s={[round(t, 6) for t in load_s]} read-back s="
        f"{[round(t, 6) for t in readback_s]}; retention's headers: "
        f"live_metas s={live_metas_s:.6f}, a load of each file s="
        f"{sum(load_s):.6f}")
    say(f"  disk budget: {last2['disk_budget_checks']} free-space checks in "
        f"the restarted serve, statvfs {per_statvfs * 1e6:.2f} us each "
        f"(~{last2['disk_budget_checks'] * per_statvfs:.3f} s); journal "
        f"sync s={last2['loop_s']['journal_sync']:.3f} schedule_once s="
        f"{last2['loop_s']['schedule_once']:.3f}")
    say(f"  heads_launches={last2['heads_launches']} (restarted serve, "
        f"{last2['cycles_on_device']} device cycles, pipeline_stats "
        f"{last2['pipeline_stats']}) | {card}")
    return last2["heads_launches"]


def phase_breaker(seed, work, bodies, card, say=print):
    """Phase 21 with the first BREAKER_ARRIVALS arrivals: the sidecar
    crashes after 3 replies; the breaker opens; the restarted sidecar is
    re-promoted. Returns its heads launches."""
    from kueue_tpu_torch.bench import serve_world as sw

    path = work / "p21.jsonl"
    shutil.copy(seed, path)
    bodies = bodies[:BREAKER_ARRIVALS]
    env = sw.child_env(KUEUE_TPU_ORACLE_BREAKER_COOLDOWN="2")
    procs = []
    try:
        side, port = sw.start_sidecar("cuda", fault="crash-after:3")
        procs.append(side)
        serve, url, _boot = sw.start_serve(path, f"127.0.0.1:{port}",
                                           "cuda", env=env)
        procs.append(serve)
        box = {}
        poster = threading.Thread(target=lambda: box.update(
            r=sw.post_arrivals(url, bodies, sw.FULL["rate"])))
        poster.start()
        deadline = time.monotonic() + 600
        while True:
            st = sw.get_json(url, "/oracle")
            if st["fallbackReasons"].get("breaker-open"):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"the breaker did not open: {st}")
            time.sleep(0.05)
        demoted = st
        side_rc = side.p.wait(60)
        side2, _ = sw.start_sidecar("cuda", port=port)
        procs.append(side2)
        idle = sw.wait_idle(url, 900, dump_every=15.0,
                            until=lambda s: s["cyclesOnDevice"]
                            > demoted["cyclesOnDevice"])
        poster.join()
        views = serve_views(sw, url)
        rc, last = serve.stop()
        rc2, side2_last = side2.stop()
    finally:
        stop_all(procs)
    fb = idle["oracle"]["fallbackReasons"]
    say(f"  at demotion: cyclesOnDevice={demoted['cyclesOnDevice']} "
          f"fallbackReasons={demoted['fallbackReasons']}; final: "
          f"cyclesOnDevice={last['cycles_on_device']} fallbackReasons={fb}")
    if (side_rc, rc, rc2) != (17, 0, 0):
        raise AssertionError(f"exit codes sidecar={side_rc} serve={rc} "
                             f"new sidecar={rc2}")
    if set(box["r"]["codes"]) != {201}:
        raise AssertionError(f"POST codes {sorted(set(box['r']['codes']))}")
    if not (fb.get("remote-error") and fb.get("breaker-open")):
        raise AssertionError(f"no remote-error and breaker-open: {fb}")
    served = last["cycles_on_device"] - demoted["cyclesOnDevice"]
    calls = dispatched(dict(on_device=last["cycles_on_device"],
                            pipeline_stats=last["pipeline_stats"])) - \
        dispatched(dict(on_device=demoted["cyclesOnDevice"],
                        pipeline_stats=demoted["pipelineStats"]))
    if not (served > 0 and side2_last["heads_launches"]
            == side2_last["compute_replies"] == calls):
        raise AssertionError(
            f"new sidecar: heads launches {side2_last['heads_launches']}, "
            f"replies {side2_last['compute_replies']}, device calls "
            f"after re-promotion {calls} ({served} device cycles)")
    check_serve_state(sw, views, "final state", say,
                      expect=SERVE_BREAKER_EXPECT)
    say(f"  heads_launches={side2_last['heads_launches']} (restarted "
          f"sidecar, {served} device cycles after re-promotion, "
          f"pipeline_stats {last['pipeline_stats']}) | {card}")
    return side2_last["heads_launches"]


def check_serve_heads(seed, heads, pk, sms, say=print):
    """The heads kernel against its plain version on the inputs of the
    first device cycle that the serve process gives the sidecar: the
    seeded journal rebuilt on the card as the serve process rebuilds
    it, one schedule_once in-process. Its launches count on no path."""
    from kueue_tpu_torch.store import journal

    eng = journal.engine_from_records(
        list(journal.read_records(str(seed))), device="cuda")
    eng.attach_oracle()
    eff_t, cq_t, C = pk.first_heads_inputs(eng.schedule_once)
    check_heads(heads, f"serve_world first cycle w={eff_t.numel()} c={C}",
                eff_t, cq_t, C, sms, say=say)


def phases_serve(card, by_path, heads, pk, sms):
    """Phases 19 to 21 on one seeded journal."""
    from kueue_tpu_torch.bench import serve_world as sw

    work = Path(__file__).resolve().parent / "kueue_tpu_torch" / \
        "_build" / "serve_world"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    seed = work / "seed.jsonl"
    seeded = sw.seed_journal(seed, sw.FULL)
    bodies = sw.arrival_bodies(sw.FULL)
    print(f"  seeded journal: records={seeded['records']} "
          f"bytes={seeded['bytes']} in {time.perf_counter() - t0:.2f} s")
    span("19")
    print("[19] deployed control plane: serve + oracle sidecar on the card")
    by_path["serve_world"] = phase_serve(seed, work, bodies, card)
    # Phases 20 and 21 are gates on other worlds' processes (their own
    # journals, sidecar and ports), and phase 19's heads check a gate on
    # an engine of this process: they run side by side, each printing
    # its lines when all are done.
    runs = {"serve_restart": (phase_restart, "[20] crash and restart of "
                              "the serve process (beside 21)"),
            "serve_breaker": (phase_breaker, "[21] the breaker: sidecar "
                              "crash, host cycles, re-promotion (beside 20)"),
            "serve_heads": (
                lambda *_a, say: check_serve_heads(seed, heads, pk, sms,
                                                   say=say),
                "[19] heads on the serve path's first-cycle inputs")}
    lines = {name: [] for name in runs}
    done = {}

    def run(name):
        try:
            done[name] = runs[name][0](seed, work, bodies, card,
                                       say=lines[name].append)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            done[name] = e

    threads = [threading.Thread(target=run, args=(name,)) for name in runs]
    span("20+21")
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (_fn, title) in runs.items():
        print(title)
        for line in lines[name]:
            print(line)
    for name in runs:
        if isinstance(done[name], BaseException):
            raise done[name]
        if name != "serve_heads":
            by_path[name] = done[name]
    shutil.rmtree(work, ignore_errors=True)


def drain(scenario_kw, device=None):
    from kueue_tpu_torch.bench.scenario import baseline_like
    from kueue_tpu_torch.cache.snapshot import build_snapshot
    from kueue_tpu_torch.oracle.batched import BatchedDrainSolver

    t0 = time.perf_counter()
    scen = baseline_like(**scenario_kw)
    snap = build_snapshot(scen.cluster_queues, scen.cohorts, scen.flavors,
                          [])
    solver = BatchedDrainSolver(snap, scen.pending_infos(), device=device)
    return solver, time.perf_counter() - t0


def check(stats, expect, label):
    got = (stats["cycles"], stats["admitted"], checksum(stats))
    print(f"  {label}: cycles={got[0]} admitted={got[1]} "
          f"checksum=0x{got[2]:08x}")
    if got != expect:
        raise AssertionError(
            f"{label}: got cycles/admitted/checksum {got[0]}/{got[1]}/"
            f"0x{got[2]:08x}, want {expect[0]}/{expect[1]}/"
            f"0x{expect[2]:08x}")
    ac = stats["admit_cycle"]
    if ac.dtype != np.int32 or stats["wl_flavor"].dtype != np.int32:
        raise AssertionError(f"{label}: decision arrays must be int32")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kueue_tpu_torch.device import resolve_device
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.bench import profile_kernels as pk
    from kueue_tpu_torch.ops import heads, leaf

    span("1-2")
    dev = resolve_device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {kind}")

    seconds = _build.build()
    for name, s in seconds.items():
        print(f"[2] build {name}: {s:.2f} s "
              f"({_build.library_path(name).name})")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if "registers" in line or "smem" in line:
                    print(f"    {line.strip()}")

    span("3")
    print("[3] heads kernel vs plain on the card")
    heads_row = phase_heads(dev, heads, pk)

    span("4")
    print("[4] small drain on the card")
    solver, _ = drain(SMALL)
    _, stats = solver.solve()
    check(stats, SMALL_EXPECT, "512 workloads")

    span("5")
    print("[5] full-width drain on the card")
    solver, encode_s = drain(FULL)
    heads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = heads.launches
    check(stats, FULL_EXPECT, "50000 workloads")
    if launches != FULL_EXPECT[0]:
        raise AssertionError(f"heads kernel launched {launches} times in "
                             f"the drain, want {FULL_EXPECT[0]}")
    t0 = time.perf_counter()
    _, again = solver.solve()
    torch.cuda.synchronize()
    solve2_s = time.perf_counter() - t0
    check(again, FULL_EXPECT, "50000 workloads, second solve")
    eff_t, cq_t, C = pk.drain_first_cycle_heads(solver)
    check_heads(heads, f"drain first cycle w={eff_t.numel()} c={C}", eff_t,
                cq_t, C, torch.cuda.get_device_properties(dev)
                .multi_processor_count)
    print(f"  encode_s={encode_s:.3f} solve_s={solve_s:.3f} "
          f"admissions_per_s={stats['admitted'] / solve_s:.1f} "
          f"second solve_s={solve2_s:.3f} "
          f"admissions_per_s={stats['admitted'] / solve2_s:.1f} "
          f"heads_launches={launches} | {card}")

    span("6")
    print("[6] leaf kernel vs plain on the card")
    leaf_row = phase_leaf(dev, leaf, pk)

    span("7")
    print("[7] device TAS on the 5,120-node forest")
    leaf_launches = phase_tas(dev, leaf, card)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    span("8")
    print("[8] hier_fair drain on the card")
    fair_launches = phase_hier_fair(heads, pk, card, sms)

    span("9")
    print("[9] preemption world on the card")
    preempt_launches = phase_preempt_world(heads, pk, card, sms)

    by_path = {"full_width_drain": launches, "hier_fair": fair_launches,
               "preempt_world": preempt_launches}
    for i, name in enumerate(("cycle_latency", "fair_cycle_latency",
                              "preempt_churn", "multiflavor"), start=10):
        span(str(i))
        print(f"[{i}] serving engine: {name}")
        by_path[name] = phase_engine(name, ew.FULL[name], ENGINE_EXPECT[name],
                                     heads, pk, card, sms)
    for i, name in enumerate(("tas", "tas_large", "tas_churn"), start=14):
        span(str(i))
        print(f"[{i}] serving engine, TAS: {name}")
        by_path[f"{name}_engine"] = phase_tas_engine(name, heads, pk, card,
                                                     sms)
    for i, name in enumerate(("mixed_world", "afs_serving"), start=17):
        span(str(i))
        print(f"[{i}] serving engine, mixed: {name}")
        by_path[name] = phase_mixed(name, heads, pk, card, sms)
    span("19-21 setup")
    phases_serve(card, by_path, heads, pk, sms)
    for i, name in enumerate(("cycle_latency", "preempt_churn"), start=22):
        span(str(i))
        print(f"[{i}] serving engine, default loop: {name}")
        by_path[f"{name}_default"] = phase_engine(
            name, ew.DEFAULT_ARM[name], DEFAULT_ARM_EXPECT[name], heads, pk,
            card, sms)
    for i, name in enumerate(ew.OTHER_ARMS, start=24):
        span(str(i))
        print(f"[{i}] serving engine, per-entry assume: {name}")
        by_path[name] = phase_engine(name, ew.OTHER_ARMS[name],
                                     OTHER_ARMS_EXPECT[name], heads, pk,
                                     card, sms)
    span("26")
    print("[26] serving engine, TAS lifecycle: tas_lifecycle")
    by_path["tas_lifecycle_engine"] = phase_lifecycle(heads, pk, card, sms)
    print(f"phase seconds: {spans_line()}")
    print(card)
    print(json.dumps({"kernels": [
        dict(name="heads_segment_min", route="cuda",
             source="kueue_tpu_torch/csrc/heads.cu",
             replaces="kueue_tpu/ops/pallas_kernels.py:83",
             launches=sum(by_path.values()), launches_by_path=by_path,
             **heads_row),
        dict(name="leaf_fit_counts", route="cuda",
             source="kueue_tpu_torch/csrc/leaf.cu",
             replaces="kueue_tpu/ops/pallas_kernels.py:152",
             launches=leaf_launches, **leaf_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
