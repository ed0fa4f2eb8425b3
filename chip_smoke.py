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
 20. (beside phases 21, 28, 29 and 30) crash and restart with
     bounded-time recovery: the same world with
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
     genesis replay (prove_genesis, in a child process while this one
     checks the rest), and its rebuild_engine coming
     through a checkpoint and, drained to idle on the host, giving the
     live engine's dump_state. Prints both boots' seconds (genesis and
     checkpoint), the checkpoints written, their write seconds (mean and
     maximum) and bytes, the segments sealed and left, the disk
     budget's statvfs checks and cost, and two ways to check a written
     checkpoint: a load of it (parse and count) against a read-back of
     its bytes;
 21. (beside phases 20 and 30: each is a gate on processes of its
     own) the breaker on the card, posting the first 250 arrivals (a quarter) to
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
     and the replacement placements by path;
 27. the serving engine traced (kueue_tpu_torch/bench/obs_worlds.py over
     engine_worlds.DEFAULT_ARM cycle_latency, uncut: 1 + 8 cycles, 9,000
     admitted at 1,000 ClusterQueues x 50,000 workloads, the heads
     kernel on the card) with the tracer (ring 64), the perf recorder,
     the SLO engine, the cycle watchdog (deadline 30 s, hang 120 s) and
     a fanout hub of 2 shards with one draining subscriber attached,
     every cycle inside ``Engine.profiled`` (a torch.profiler Chrome
     trace). Gated on phase 22's JAX numbers (traced decides as
     untraced), 9 cycles traced with the JAX package's cid chain, its
     committed device calls, host-to-device and device-to-host bytes and
     shape-signature hit/miss sequence, the heads kernel launched once
     per dispatched call (10), the Chrome trace holding the bridge's
     phase ranges and one heads-kernel device event per launch of the
     window, the subscriber seeing every event of the window in order,
     and the watchdog closed with no demotion anywhere. Prints the
     traced p50 and p95 beside phase 22's and the per-cycle medians of
     the apply and encode sub-phases;
 28. (after phase 21 in its thread, beside phases 20, 29 and 30) the
     deployed process traced (kueue_tpu_torch/bench/serve_traced.py, whose main
     runs the same schedule untraced beside it): ``python -m
     kueue_tpu_torch.serve`` with the sidecar on the card and ``--trace
     64 --watchdog-deadline 30 --watchdog-hang 120`` on its own copy of
     phase 19's journal, phase 21's first 250 arrivals POSTed at 200 a
     second once the seeded backlog has drained, one SSE client on
     ``/events`` from then on. Gated on phase 21's JAX final state
     (``0x638086c7``, 50,187 holding quota), each arrival admitted once
     in the journal and seen admitted on the stream, the traced cycles
     (``/debug/trace``, the SIGTERM line) equal to the journal's
     ``cycle_trace`` records, the stream's ``cycle_trace`` events equal
     to those traced after it joined, with the ladder at rung 0 and the
     watchdog closed (``/debug/slo``), ``/debug/perf`` answering
     ``{"enabled": false}`` as the JAX serve's does, ``/`` and
     ``/dashboard`` answering 200, and the sidecar's heads launches
     equal to the dispatched device calls. Prints POST
     p50 and p95 and the wall per device cycle beside phases 19 and 21.
 29. (after phase 30 in its thread, beside phases 20 and 28, in a
     process of its own that prints its lines and its heads launches)
     the flight recorder
     (kueue_tpu_torch/bench/replay_world.py over engine_worlds.DEFAULT_ARM
     cycle_latency, 1,000 ClusterQueues x 50,000 workloads, 1 + 8 cycles
     on the default loop): (a) the run recorded, the recorder attached
     with ``bootstrap=True`` once the world is built, gated on phase 22's
     JAX numbers (a recorded run decides as an unrecorded one), on the
     trace's decision digest, the crc32 of its frames without ``phases``
     and ``crc``, its frames and cycles against the JAX recorder's on the
     same world, and on the heads kernel launched once per dispatched
     call; (b) the trace replayed in ``both`` mode (a host engine and a
     device engine side by side), gated on no mismatch of either kind,
     the replayed digest equal to the recorded one and the device
     engine's heads launches equal to its dispatched calls; (c) the trace
     replayed in ``device`` mode under the fault plan
     ``oracle-crash@cycle:3,delay-verdict@cycle:5:50,
     oracle-crash-storm@cycle:6:2``, gated on byte-identical decisions,
     on the faults fired, the injected errors, the delayed calls, the
     device / hybrid / fallback cycles, the fallback reasons and
     pipeline_stats against the JAX replayer's on the same trace and
     plan, and on the heads launches equal to the dispatched calls.
     Prints the bootstrap seconds, the trace's bytes and frames, each
     replay's rebuild seconds and the recorded against replayed phase
     attribution.
 30. (beside phases 20, 21 and 28: a gate on processes of its own) the HA
     serving plane and the read plane on serve_world's journal
     (kueue_tpu_torch/ha, kueue_tpu_torch/readplane): leader A (``serve
     --ha --oracle local``, its lease 3 s, ``--fault sigkill@admission:N``)
     drains the seeded backlog; follower B and read replica R (``serve
     --read-replica``) start once A leads; the first 100 arrivals are
     POSTed to A at 200 a second once the backlog is admitted and R holds
     it, and A dies at the 40th arrival's admission (mid-apply, after its
     ``ha_digest`` records); B takes the lease at expiry, promotes at
     epoch 2 with a verified report against a real checkpoint, takes all
     100 arrivals again (200 or 201) and drains; a ReadFrontend that
     knows only R queries pending and quota every 0.5 s throughout.
     Gated on A's -SIGKILL and B's and R's 0, 30 to 50 arrivals journaled
     admitted at the kill, no admission lost across it and none twice,
     every arrival admitted once, usage within quota, B's and R's
     admitted-state digest equal to a cold ``rebuild_engine`` of the
     final journal on the CPU, R's ``canonical_answer`` byte-equal to
     that rebuild's (sha256) and its pending and quota answers equal,
     every read answered by R with a staleness stamp within 10 s, before
     and after the kill, no ``visibility_queries_total`` sample on A or
     B, and B's heads launches equal to its dispatched device calls.
     Prints the boot seconds of A, B and R, the promotion split (lease
     wait, replay, verify), POST p50 and p95 to A and B, the maximum
     staleness, the drain, the wall per device cycle, B's memory and the
     phase's marks.
Before the kernel summary it prints each phase's wall seconds; the
phases that run side by side share one span. Every child process runs in a session and process group of its own and is
registered from its spawn (kueue_tpu_torch/bench/serve_world.py); when
the phases end, or one fails, every registered child is killed and
reaped, and the script looks in /proc for any process left below it or
in one of those sessions and in ``nvidia-smi --query-compute-apps`` for
another process on the card: it kills what it finds and fails without a
result line.
The expected decisions are the JAX package's own on the same scenarios
(tests/test_torch_drain.py, tests/test_torch_tas_feasibility.py,
tests/test_torch_fair.py, tests/test_torch_preempt_world.py,
tests/test_torch_engine_worlds.py, tests/test_torch_tas_engine_worlds.py,
tests/test_torch_mixed_worlds.py, tests/test_torch_serve.py,
tests/test_torch_tas_lifecycle_world.py and
tests/test_torch_replay_world.py recompute them). Phases 19 to 21,
28, 29 and 30 read the heads launches of the process that launches them
(the sidecar, the restarted serve process, phase 29's process or the
promoted leader), from the JSON line it prints. The last two lines are a JSON summary of the kernels and the
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
# Phase 27 (obs_worlds.run of DEFAULT_ARM cycle_latency): the JAX
# engine's obs numbers on the same run (tests/test_torch_obs_worlds.py
# recomputes them): the cid of every traced cycle, the committed device
# calls, their bytes each way and the signature cache's (hits, misses)
# per cycle.
TRACED_EXPECT = dict(
    cycles_traced=9,
    cids=["000000-b4d15ee7", "000001-7e6faf68", "000002-79aa0dd3",
          "000003-5c3f591a", "000004-99c92531", "000005-ff4b5638",
          "000006-f950e287", "000007-6bdfcc11", "000008-86496ffa"],
    launches=9, h2d_bytes=31920048, d2h_bytes=1999881,
    jit=[(0, 1)] + [(1, 0)] * 8)
# Phase 29 (bench/replay_world.py over DEFAULT_ARM cycle_latency): the
# JAX recorder's trace of the same run (its decision digest, the crc32 of
# its frames without phases and crc, its frames, those the bootstrap
# wrote and its cycle frames) and the JAX replayer's device-mode replay
# of that trace under replay_world.FAULTS: the faults fired, the
# proxy's injected errors and delayed calls, and the bridge's device,
# hybrid and fallback cycles, fallback reasons and pipeline_stats
# (tests/test_torch_replay_world.py recomputes them).
REPLAY_EXPECT = dict(
    digest="e24b560f", masked=0xa1d2a71a, frames=52212,
    bootstrap_frames=52202, cycles=9,
    faults=dict(
        fired=["oracle-crash@cycle:3", "delay-verdict@cycle:5",
               "oracle-crash-storm@cycle:6:2"],
        injected_errors=6, delayed_calls=2, on_device=7, hybrid=0,
        fallback=2, fallback_reasons={"remote-error": 2},
        pipeline_stats=dict(speculated=5, used=4, discarded=0,
                            skipped=0)))
# The heads kernel's device functions, one of which every call launches
# (heads.cu: the cluster kernel, or the atomic kernel past shared memory).
HEADS_DEVICE_KERNELS = ("heads_cluster_kernel", "heads_atomic_kernel")
TAS_EXPECT = dict(requests=440, placed=189, signatures=21,
                  per_pod_vectors=2, placements=0xe61bb495,
                  feasibility_empty=0x76cebe8a,
                  feasibility_final=0x99e5afa2, phase1=0xe7c953cf)


# Start times of the script's phases, for the wall split it prints.
_SPANS: list = []
# What phases 22, 19 and 21 measured, for phases 27 and 28 to print
# beside their own: (name, arm) -> (p50, p95) s a cycle; phase -> POST
# p50 and p95 and wall seconds per device cycle.
ENGINE_TIMES: dict = {}
SERVE_TIMES: dict = {}


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
    ENGINE_TIMES[name, config.get("arm")] = (p50, p95)
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
    """SIGKILL each Proc's process group and reap it."""
    for p in procs:
        p.kill()


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
    SERVE_TIMES["19"] = (pct(lat, 0.5), pct(lat, 0.95), drain_s / cycles)
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


def _restart_checks(store, reposted, path, work, copy, bodies, before,
                    views, capacity, cohorts, last2):
    """Phase 20's checks of the journal set and the checkpoints after
    the restarted serve process stopped, and the port's rebuild_engine
    of the set (``copy``) against the live engine's dump. Returns what
    the phase prints."""
    from kueue_tpu_torch.bench import serve_world as sw
    from kueue_tpu_torch.store.journal import (
        read_active_ordinal,
        rebuild_engine,
    )
    from kueue_tpu_torch.visibility.server import dump_state

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
    sealed = read_active_ordinal(str(path))
    left = sorted(s.name[-6:] for s in work.glob("p20.jsonl.seg*"))
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
    return (ckpts, load_s, readback_s, live_metas_s, sealed, left, got,
            eng, rebuild_s)


def start_recover_proof(copy):
    """A child process that runs ``recover_engine(prove_genesis=True)``
    on the CPU over the journal set at ``copy`` and prints one JSON
    line: its seconds and the report's source, record counts, states
    and ``identical``."""
    from kueue_tpu_torch.bench import serve_world as sw

    return sw.Proc(["-c", (
        "import gc, json, time\n"
        "from kueue_tpu_torch.store.checkpoint import recover_engine\n"
        "gc.disable()\n"
        "t0 = time.perf_counter()\n"
        f"_eng, report = recover_engine({str(copy)!r}, {{'device': 'cpu'}},"
        " prove_genesis=True)\n"
        "print(json.dumps({'s': time.perf_counter() - t0, **{k: report[k]"
        " for k in ('source', 'base_records', 'suffix_records', 'state',"
        " 'genesis_state', 'identical')}}))\n")])


def phase_restart(seed, work, bodies, card, kill_after=30, say=print):
    """Phase 20: the serve process (oracle in-process) with checkpoints,
    segment rotation and the disk budget on, SIGKILLed after
    ``kill_after`` device cycles once retention deleted segment 0, and
    restarted on the same journal, which it can only recover through a
    checkpoint; checks the invariants. Returns the restarted process's
    heads launches."""
    import os

    from kueue_tpu_torch.bench import serve_world as sw
    from kueue_tpu_torch.store.checkpoint import CheckpointStore

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
    # The whole journal set: every segment the two processes sealed
    # (kept aside), the active file, and, once the genesis chain has
    # been read, the checkpoints. Its checkpoint-plus-suffix recovery
    # against the genesis replay of every record runs in a child on the
    # host's CPU while this thread checks the rest.
    copy = keeper.chain(work / "p20-rebuild")
    shutil.copytree(store.directory, copy.parent / "p20.jsonl.ckpt")
    prover = start_recover_proof(copy)
    try:
        proof = _restart_checks(store, reposted, path, work, copy, bodies,
                                before, views, capacity, cohorts, last2)
        report = json.loads(prover.wait_line('"identical"', 600))
        prover.stop()
    finally:
        prover.kill()
    if report["source"] != "checkpoint" or not report["identical"]:
        raise AssertionError(f"recover_engine(prove_genesis=True): "
                             f"{report}")
    (ckpts, load_s, readback_s, live_metas_s, sealed, left, got, eng,
     rebuild_s) = proof
    prove_s = report["s"]
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
        t_post = time.perf_counter()
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
        drain_s = time.perf_counter() - t_post
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
    lat = box["r"]["latencies"]
    SERVE_TIMES["21"] = (pct(lat, 0.5), pct(lat, 0.95),
                         drain_s / last["cycles_on_device"])
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
    """Phases 19 to 21, 28 and 30 on one seeded journal, and phase 29
    beside them."""
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
    # Phases 20, 21, 28, 29 and 30 are gates on other worlds' processes
    # (their own journals, sidecars, leases and ports), and phase 19's
    # heads check a gate on an engine of this process: they run side by
    # side, 28 after 21 (the same 250 arrivals, traced) and 29 after 30,
    # each printing its lines when all are done.
    runs = {"serve_restart": [(phase_restart, "[20] crash and restart of "
                               "the serve process (beside 21, 28 and 30)")],
            "serve_breaker": [(phase_breaker, "[21] the breaker: sidecar "
                               "crash, host cycles, re-promotion (beside 20 "
                               "and 30)"),
                              (phase_serve_traced, "[28] deployed control "
                               "plane traced: serve + sidecar, /events "
                               "(after 21, beside 20 and 30)")],
            "ha_failover": [(phase_ha, "[30] HA failover: leader A "
                             "SIGKILLed mid-apply, B promoted, reads on "
                             "read replica R (beside 20, 21 and 28)"),
                            (phase_replay_beside, "[29] flight recorder: "
                             "cycle_latency recorded, replayed both, "
                             "replayed under faults (after 30, beside 20 "
                             "and 28, in a process of its own)")],
            "serve_heads": [(
                lambda *_a, say: check_serve_heads(seed, heads, pk, sms,
                                                   say=say),
                "[19] heads on the serve path's first-cycle inputs")]}
    paths = {phase_breaker: "serve_breaker", phase_serve_traced:
             "serve_traced", phase_restart: "serve_restart",
             phase_ha: "ha_failover"}
    lines = {fn: [] for chain in runs.values() for fn, _t in chain}
    done = {}

    def run(chain):
        for fn, _title in chain:
            try:
                done[fn] = fn(seed, work, bodies, card, say=lines[fn].append)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                done[fn] = e
                return

    threads = [threading.Thread(target=run, args=(chain,))
               for chain in runs.values()]
    span("20+21+28+29+30")
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    shutil.rmtree(work, ignore_errors=True)
    for chain in runs.values():
        for fn, title in chain:
            if fn in done:
                print(title)
                for line in lines[fn]:
                    print(line)
    for chain in runs.values():
        for fn, _title in chain:
            if fn not in done:
                continue  # an earlier phase of its chain failed
            if isinstance(done[fn], BaseException):
                raise done[fn]
            if fn is phase_replay_beside:
                by_path.update(done[fn])
            elif fn in paths:
                by_path[paths[fn]] = done[fn]


def heads_trace_events(trace_dir) -> tuple:
    """(heads-kernel device events, names of every range) of the one
    Chrome trace ``Engine.profiled`` wrote into ``trace_dir``."""
    (path,) = sorted(Path(trace_dir).glob("*.json"))
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel"
                  and any(k in e.get("name", "")
                          for k in HEADS_DEVICE_KERNELS))
    return kernels, {e.get("name") for e in events}, path.stat().st_size


def phase_traced_engine(heads, card):
    """Phase 27: DEFAULT_ARM cycle_latency with the obs layer attached
    and every cycle profiled. Returns the heads kernel's launches."""
    from contextlib import contextmanager

    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.bench import obs_worlds as ow

    trace_dir = Path(__file__).resolve().parent / "kueue_tpu_torch" / \
        "_build" / "traced"
    shutil.rmtree(trace_dir, ignore_errors=True)
    box = {}

    @contextmanager
    def extra(eng):
        box["eng"] = eng
        heads.launches = 0
        with ow.attached(eng, hub=True, watchdog=(30.0, 120.0),
                         profile_dir=str(trace_dir)) as got:
            box["got"] = got
            yield
        box["launches"] = heads.launches

    t0 = time.perf_counter()
    r, probe = ow.run(ew.DEFAULT_ARM["cycle_latency"], extra=extra)
    run_s = time.perf_counter() - t0
    launches, got = box["launches"], box["got"]
    pinned = ew.arm_pinned(r)
    print("  " + " ".join(
        f"{k}=0x{v:08x}" if k == "checksum" else f"{k}={v}"
        for k, v in pinned.items()))
    if pinned != DEFAULT_ARM_EXPECT["cycle_latency"]:
        raise AssertionError(f"traced cycle_latency: got {pinned}, want "
                             f"{DEFAULT_ARM_EXPECT['cycle_latency']}")
    numbers = ow.obs_numbers(probe)
    print(f"  cycles_traced={numbers['cycles_traced']} "
          f"cids={numbers['cids'][0]}..{numbers['cids'][-1]} "
          f"launches={numbers['launches']} h2d={numbers['h2d_bytes']} "
          f"d2h={numbers['d2h_bytes']} jit={numbers['jit']}")
    want = dict(TRACED_EXPECT, jit=[tuple(j) for j in TRACED_EXPECT["jit"]])
    if numbers != want:
        raise AssertionError(f"traced obs numbers: got {numbers}, want "
                             f"{want}")
    if launches != dispatched(r) or launches != 10:
        raise AssertionError(
            f"traced: heads kernel launched {launches} times, dispatched "
            f"{dispatched(r)} ({r['pipeline_stats']})")
    t1 = time.perf_counter()
    kernel_events, names, trace_bytes = heads_trace_events(trace_dir)
    parse_s = time.perf_counter() - t1
    ranges = [f"kueue_tpu_torch.oracle.{p}"
              for p in ("encode", "device", "apply", "finalize")]
    missing = [n for n in ranges if n not in names]
    print(f"  chrome trace: bytes={trace_bytes} parse_s={parse_s:.2f} "
          f"heads_device_events={kernel_events} heads_launches={launches} "
          f"phase_ranges_missing={missing}")
    if missing:
        raise AssertionError(f"the trace lacks the phase ranges {missing}")
    if kernel_events != launches:
        raise AssertionError(
            f"the trace holds {kernel_events} heads-kernel device events "
            f"for {launches} launches in its window")
    want_events = [(e.kind, e.workload, e.cluster_queue, e.detail, e.time)
                   for e in got["events"]]
    seen = []
    for kind, data in got["seen"]:
        d = json.loads(data)
        seen.append((kind, d["workload"], d["clusterQueue"], d["detail"],
                     d["time"]))
    print(f"  subscriber: events={len(seen)} of {len(want_events)} "
          f"hub={got['hub']}")
    if seen != want_events or not seen:
        raise AssertionError(f"the subscriber saw {len(seen)} events, the "
                             f"window had {len(want_events)}")
    wd, sup = got["watchdog"], box["eng"].oracle.supervisor
    print(f"  watchdog: state={wd['state']} overruns={wd['overruns']} "
          f"demotions={wd['demotions']}; supervisor: state={sup.state} "
          f"demotions={sup.demotions}")
    if wd["state"] != "closed" or wd["demotions"] or sup.state != \
            "closed" or sup.demotions:
        raise AssertionError("a demotion happened: the run did not "
                             "measure the device path")
    times = sorted(r["cycle_seconds"])
    untraced = ENGINE_TIMES.get(("cycle_latency", "full"), (0.0, 0.0))
    subs = ow.subphase_seconds(probe)
    print(f"  traced p50_s={pct(times, 0.5):.4f} "
          f"p95_s={pct(times, 0.95):.4f} against phase 22's untraced "
          f"p50_s={untraced[0]:.4f} p95_s={untraced[1]:.4f} "
          f"(this run profiled, alone on the card)")
    print("  sub-phase medians ms per cycle: " + ",".join(
        f"{k}={pct(v, 0.5) * 1e3:.3f}" for k, v in sorted(subs.items())
        if k.startswith(("apply.", "encode."))))
    print(f"  run_s={run_s:.2f} heads_launches={launches} | {card}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    return launches


def phase_serve_traced(seed, work, bodies, card, say=print):
    """Phase 28: the serve process traced, with the watchdog, behind the
    sidecar on the card; one SSE client from the arrivals on. Returns the
    sidecar's heads launches."""
    from kueue_tpu_torch.bench import serve_traced as st
    from kueue_tpu_torch.bench import serve_world as sw
    from kueue_tpu_torch.store import journal

    r = st.run(seed, work, bodies[:BREAKER_ARRIVALS], st.TRACE_FLAGS, "p28")
    path, stream, last, side_last = (r["path"], r["stream"], r["last"],
                                     r["side_last"])
    if set(r["posted"]["codes"]) != {201}:
        raise AssertionError(
            f"POST codes {sorted(set(r['posted']['codes']))}")
    check_serve_state(sw, r["views"], "final state", say,
                      expect=SERVE_BREAKER_EXPECT)
    check_arrivals_once(sw, path, "arrivals", BREAKER_ARRIVALS)
    if (r["rc"], r["side_rc"]) != (0, 0):
        raise AssertionError(f"exit codes serve={r['rc']} "
                             f"sidecar={r['side_rc']}")
    fb = r["idle"]["fallbackReasons"]
    if any(not k.startswith("idle-") for k in fb):
        raise AssertionError(f"fallback cycles {fb}")
    admitted = {d["workload"] for k, d in stream if k == "Admitted"
                and d["workload"].startswith("default/arrival-")}
    traces = [d for k, d in stream if k == "cycle_trace"]
    records = sum(1 for rec in journal.read_records(str(path))
                  if rec.get("kind") == "cycle_trace")
    trace, perf, traced0 = r["trace"], r["perf"], r["traced0"]
    ladder, wd = r["slo"]["ladder"], r["slo"]["watchdog"]
    say(f"  backlog: device_cycles={r['backlog']['cyclesOnDevice']} "
        f"traced={traced0} before the client joined")
    say(f"  stream: events={len(stream)} arrivals_admitted="
        f"{len(admitted)} cycle_trace={len(traces)}; /debug/trace "
        f"cyclesTraced={trace['cyclesTraced']} retained="
        f"{len(trace['cycles'])}; journal cycle_trace={records}; "
        f"sigterm cycles_traced={last['cycles_traced']}")
    say(f"  /debug/slo: ladder rung={ladder['rung']} transitions="
        f"{ladder['transitions']} watchdog={wd['state']} overruns="
        f"{wd['overruns']} demotions={wd['demotions']}; /debug/perf="
        f"{perf}; page bytes={r['pages']}")
    if len(admitted) != BREAKER_ARRIVALS:
        raise AssertionError(f"the stream saw {len(admitted)} arrivals "
                             "admitted")
    if ladder["rung"] or ladder["transitions"] or wd["state"] != "closed":
        raise AssertionError(
            f"ladder rung {ladder['rung']} ({ladder['transitions']} "
            f"transitions), watchdog {wd['state']}: the ladder sheds "
            "tracing, so the traced counts need not agree")
    counts = dict(debug_trace=trace["cyclesTraced"], journal=records,
                  sigterm=last["cycles_traced"])
    if (len(set(counts.values())) != 1 or not len(traces)
            or len(traces) != records - traced0):
        raise AssertionError(
            f"traced cycles disagree: {counts}; the stream saw "
            f"{len(traces)} of the {records - traced0} after it joined")
    if perf != {"enabled": False}:
        raise AssertionError(f"/debug/perf answered {perf}")
    calls = dispatched(dict(on_device=last["cycles_on_device"],
                            pipeline_stats=last["pipeline_stats"]))
    if not (side_last["heads_launches"] == side_last["compute_replies"]
            == calls > 0):
        raise AssertionError(
            f"sidecar heads launches {side_last['heads_launches']}, "
            f"replies {side_last['compute_replies']}, dispatched {calls}")
    got = st.summary(r)
    say(f"  POST p50_s={got['post_p50_s']:.5f} "
        f"p95_s={got['post_p95_s']:.5f} wall_per_device_cycle_s="
        f"{got['wall_per_device_cycle_s']:.5f} (arrival device_cycles="
        f"{got['device_cycles']} drain_s={got['drain_s']:.3f}; boot "
        f"rebuild_s={r['boot']['rebuild_s']:.3f}; phases 19 and 21 post "
        "while the backlog drains; kueue_tpu_torch.bench.serve_traced "
        "runs this schedule untraced)")
    for ph in ("19", "21"):
        if ph in SERVE_TIMES:
            p50, p95, per = SERVE_TIMES[ph]
            say(f"  phase {ph}: POST p50_s={p50:.5f} p95_s={p95:.5f} "
                f"wall_per_device_cycle_s={per:.5f}")
    say(f"  heads_launches={side_last['heads_launches']} (sidecar) "
        f"| {card}")
    return side_last["heads_launches"]


def replay_launches(label, heads, info) -> int:
    """The heads launches since the counter was zeroed, which must equal
    the executor calls that reached the replay's device engine and the
    calls its bridge dispatched (device cycles less used speculations,
    plus every speculation)."""
    launches = heads.launches
    ps = info["pipeline_stats"]
    want = info["on_device"] - ps.get("used", 0) + ps.get("speculated", 0)
    if launches != info["dispatched"] or launches != want:
        raise AssertionError(
            f"{label}: heads kernel launched {launches} times, executor "
            f"calls {info['dispatched']}, dispatched {want} ({ps})")
    return launches


def phase_replay(heads, card) -> dict:
    """Phase 29: DEFAULT_ARM cycle_latency flight-recorded, its trace
    replayed on the host and the card side by side, and replayed on the
    card under replay_world.FAULTS. Returns the heads launches of each
    run by path."""
    from kueue_tpu_torch.bench import engine_worlds as ew
    from kueue_tpu_torch.bench import replay_world as rw

    work = Path(__file__).resolve().parent / "kueue_tpu_torch" / \
        "_build" / "replay"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    path = str(work / "cycle_latency.jsonl")
    config = ew.DEFAULT_ARM["cycle_latency"]
    by_path = {}

    heads.launches = 0
    t0 = time.perf_counter()
    r, info = rw.record(config, path)
    record_s = time.perf_counter() - t0
    launches = heads.launches
    pinned = ew.arm_pinned(r)
    del r  # the recorded engine
    if pinned != DEFAULT_ARM_EXPECT["cycle_latency"]:
        raise AssertionError(f"recorded cycle_latency: got {pinned}, want "
                             f"{DEFAULT_ARM_EXPECT['cycle_latency']}")
    got = dict(digest=info["digest"], masked=rw.masked_checksum(path),
               frames=info["frames"],
               bootstrap_frames=info["bootstrap_frames"],
               cycles=info["cycles"])
    want = {k: v for k, v in REPLAY_EXPECT.items() if k != "faults"}
    print(f"  (a) record: checksum=0x{pinned['checksum']:08x} "
          f"digest={got['digest']} masked=0x{got['masked']:08x} "
          f"frames={got['frames']} bootstrap_frames="
          f"{got['bootstrap_frames']} cycles={got['cycles']} bytes="
          f"{info['bytes']} bootstrap_s={info['bootstrap_s']:.3f} "
          f"record_s={record_s:.2f} heads_launches={launches}")
    if got != want:
        raise AssertionError(f"recorded trace: got {got}, want {want}")
    dispatched_calls = (pinned["on_device"]
                        - pinned["pipeline_stats"]["used"]
                        + pinned["pipeline_stats"]["speculated"])
    if launches != info["dispatched"] or launches != dispatched_calls:
        raise AssertionError(
            f"record: heads kernel launched {launches} times, executor "
            f"calls {info['dispatched']}, dispatched {dispatched_calls}")
    by_path["replay_record"] = launches

    heads.launches = 0
    t0 = time.perf_counter()
    report, binfo = rw.replay(config, path, "both")
    both_s = time.perf_counter() - t0
    by_path["replay_both"] = replay_launches("both", heads, binfo["device"])
    print("  (b) replay both: " + "\n      ".join(
        report.render().splitlines()))
    print(f"      rebuild_s={binfo['rebuild_s']:.3f} (two engines) "
          f"replay_s={both_s:.2f} device={binfo['device']} "
          f"heads_launches={by_path['replay_both']}")
    if not report.ok or report.mismatches or \
            report.replayed_digest != info["digest"] or \
            report.cycles != REPLAY_EXPECT["cycles"]:
        raise AssertionError("replay both:\n" + report.render())
    del report, binfo  # its two engines

    heads.launches = 0
    t0 = time.perf_counter()
    report, finfo = rw.replay(config, path, "device", faults=rw.FAULTS)
    faults_s = time.perf_counter() - t0
    by_path["replay_faults"] = replay_launches("faults", heads,
                                               finfo["device"])
    got = dict(fired=finfo["fired"],
               injected_errors=finfo["injected_errors"],
               delayed_calls=finfo["delayed_calls"],
               **{k: finfo["device"][k] for k in (
                   "on_device", "hybrid", "fallback", "fallback_reasons",
                   "pipeline_stats")})
    print(f"  (c) replay device under {rw.FAULTS}: digest="
          f"{report.replayed_digest} ok={report.ok} {got}")
    print(f"      rebuild_s={finfo['rebuild_s']:.3f} replay_s={faults_s:.2f} "
          f"heads_launches={by_path['replay_faults']}")
    if not report.ok or report.replayed_digest != info["digest"]:
        raise AssertionError("replay under faults:\n" + report.render())
    if got != REPLAY_EXPECT["faults"]:
        raise AssertionError(f"replay under faults: got {got}, want "
                             f"{REPLAY_EXPECT['faults']}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"  heads_launches={sum(by_path.values())} {by_path} | {card}")
    return by_path


def phase_replay_beside(seed, work, bodies, card, say=print) -> dict:
    """Phase 29 in a child process of its own, so that it runs beside
    the serve phases (its heads launches count in that process, trap
    (an)): the child runs ``phase_replay``, prints its lines and then
    one JSON line of the launches by path, which this returns."""
    from kueue_tpu_torch.bench import serve_world as sw

    proc = sw.Proc(["-c", (
        "import json\n"
        "import chip_smoke\n"
        "from kueue_tpu_torch.ops import heads\n"
        f"by_path = chip_smoke.phase_replay(heads, {card!r})\n"
        "print(json.dumps({'replay_by_path': by_path}))\n")])
    try:
        line = proc.wait_line('"replay_by_path"', 900)
        rc = proc.p.wait(120)
    finally:
        proc.kill()
    for out in proc.out:
        if out != line:
            say(out)
    if rc != 0:
        raise AssertionError(f"phase 29's process exited {rc}: "
                             f"{proc.tail()}")
    return json.loads(line)["replay_by_path"]


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


# Phase 30: the first HA_ARRIVALS arrivals, POSTed once the leader A
# has admitted the seeded backlog (SERVE_EXPECT less every arrival:
# 49,937 of the 50,000); A dies at the admission of the
# HA_KILL_ARRIVAL-th arrival, so that between 30 and 50 arrivals are
# journaled admitted when it dies.
HA_ARRIVALS = 100
HA_KILL_ARRIVAL = 40
HA_SEEDED_ADMITTED = SERVE_EXPECT["admitted"] - SERVE_EXPECT[
    "arrivals_admitted"]
HA_LEASE_S = 3.0
# The read plane's staleness bound (tools/readplane_smoke.py's).
STALENESS_BOUND_S = 10.0


def _journal_prefix_state(sw, path, size, copy):
    """serve_world.journal_state of the first ``size`` bytes of the
    journal at ``path`` (written to ``copy``)."""
    with open(path, "rb") as src, open(copy, "wb") as dst:
        dst.write(src.read(size))
    return sw.journal_state(copy)


def _wait_status(sw, url, pred, timeout, every=0.5):
    """/debug/ha until ``pred`` holds (not a read query)."""
    deadline = time.monotonic() + timeout
    while True:
        st = sw.get_json(url, "/debug/ha")
        if pred(st):
            return st
        if time.monotonic() > deadline:
            raise TimeoutError(f"/debug/ha never matched: role "
                               f"{st.get('role')} epoch {st.get('epoch')}")
        time.sleep(every)


def _wait_idle_ha(sw, url, journal, admitted, timeout, settle=1.5):
    """The HA leader at ``url`` idle: /debug/ha shows ``admitted``
    workloads holding quota, and neither its last digest cycle nor the
    journal's size moved for ``settle`` seconds."""
    deadline = time.monotonic() + timeout
    last = None
    while True:
        size = Path(journal).stat().st_size
        st = sw.get_json(url, "/debug/ha")
        key = (st.get("digestSeq"), size, st.get("admittedWorkloads"))
        if key == last and key[2] == admitted:
            return st
        last = key
        if time.monotonic() > deadline:
            raise TimeoutError(f"HA leader not idle: {key}, want "
                               f"{admitted} admitted")
        time.sleep(settle)


def start_cold_rebuild(path, copy):
    """A child process that runs ``rebuild_engine`` on the CPU over a
    copy of the journal at ``path`` and prints one JSON line: its
    seconds, the admitted-state digest, the sha256 and length of
    ``readplane.canonical_answer`` and the pending and quota answers."""
    from kueue_tpu_torch.bench import serve_world as sw

    shutil.copy(path, copy)
    return sw.Proc(["-c", (
        "import gc, hashlib, json, time\n"
        "from kueue_tpu_torch.ha.digest import admitted_state_digest\n"
        "from kueue_tpu_torch.readplane import answer_query, "
        "canonical_answer\n"
        "from kueue_tpu_torch.store.journal import rebuild_engine\n"
        "gc.disable()\n"
        "t0 = time.perf_counter()\n"
        f"eng = rebuild_engine({str(copy)!r}, device='cpu')\n"
        "eng.journal.close()\n"
        "s = time.perf_counter() - t0\n"
        "c = canonical_answer(eng)\n"
        "print(json.dumps({'s': s, 'digest': admitted_state_digest(eng),"
        " 'canonical_sha256': hashlib.sha256(c).hexdigest(),"
        " 'canonical_bytes': len(c), 'answers': {k: answer_query(eng, k)"
        " for k in ('pending', 'quota')}}))\n")])


def phase_ha(seed, work, bodies, card, say=print, ha_extra=()):
    """Phase 30: HA failover with the reads on a read replica. Returns
    the promoted leader's heads launches. ``ha_extra``: more serve
    arguments for A and B, such as ``("--checkpoint-interval", "25")``
    to measure the read plane's staleness with sealed checkpoints (the
    script passes none)."""
    from kueue_tpu_torch.bench import serve_world as sw

    path = work / "p30.jsonl"
    shutil.copy(seed, path)
    bodies = bodies[:HA_ARRIVALS]
    kill_at = HA_SEEDED_ADMITTED + HA_KILL_ARRIVAL
    procs = []
    poller = None
    try:
        t0 = time.perf_counter()
        a, aurl, a_serving = sw.start_ha(
            path, "a", "local", "cuda", HA_LEASE_S,
            fault=f"sigkill@admission:{kill_at}", extra=ha_extra)
        procs.append(a)
        a.wait_line("ha: role=leader epoch=1", 600)
        a_boot = time.perf_counter() - t0
        # B and R boot side by side while A drains the seeded backlog.
        box = {}
        starts = [threading.Thread(target=lambda: box.update(b=sw.start_ha(
                      path, "b", "local", "cuda", HA_LEASE_S,
                      extra=ha_extra))),
                  threading.Thread(target=lambda: box.update(
                      r=sw.start_read_replica(path, "r", "cuda")))]
        for t in starts:
            t.start()
        for t in starts:
            t.join()
        for name in ("b", "r"):
            if name not in box:
                raise RuntimeError(f"replica {name} did not start")
            procs.append(box[name][0])
        b, burl, b_boot = box["b"]
        r, rurl, r_boot = box["r"]
        _wait_status(sw, burl, lambda st: st["role"] == "follower", 60)
        deadline = time.monotonic() + 600
        while sw.get_json(rurl, "/debug/readplane")["staleness"] is None:
            if time.monotonic() > deadline:
                raise TimeoutError("the read replica built no read model")
            time.sleep(0.1)
        marks = {"replicas_ready": time.perf_counter() - t0}
        # The arrivals go in once A has drained the seeded backlog, so
        # the admission A dies at is the HA_KILL_ARRIVAL-th arrival's,
        # and the reads start once R's read model holds that drain.
        _wait_status(sw, aurl, lambda st: st.get("admittedWorkloads")
                     == HA_SEEDED_ADMITTED, 600, every=1.0)
        marks["seeded_drained"] = time.perf_counter() - t0
        lines = path.read_bytes().count(b"\n")
        deadline = time.monotonic() + 600
        while (sw.get_json(rurl, "/debug/readplane")["staleness"]
               ["position"]["offset"] < lines):
            if time.monotonic() > deadline:
                raise TimeoutError("the read replica did not catch up")
            time.sleep(0.2)
        marks["reads_start"] = time.perf_counter() - t0
        poller = sw.ReadPoller([rurl], 0.5)
        poller.start()
        # A's reads, scraped while it lives (an infrastructure route).
        a_metrics = sw.get_text(aurl, "/metrics")[0]
        posted_a = sw.post_arrivals(aurl, bodies, sw.FULL["rate"])
        a_rc = a.p.wait(600)
        killed_at = time.time()
        marks["killed"] = time.perf_counter() - t0
        size_at_kill = path.stat().st_size
        a.stop()
        b.wait_line("ha: role=leader epoch=2", 600)
        leader_at = time.time()
        marks["promoted"] = time.perf_counter() - t0
        promoted = dict(w.split("=", 1) for w in b.wait_line(
            "ha: promoted epoch=2", 10).split()[2:6])
        t_post = time.perf_counter()
        posted_b = sw.post_arrivals(burl, bodies, sw.FULL["rate"])
        b_idle = _wait_idle_ha(sw, burl, path,
                               HA_SEEDED_ADMITTED + HA_ARRIVALS, 600)
        drain_s = time.perf_counter() - t_post
        marks["drained"] = time.perf_counter() - t0
        b_metrics = sw.get_text(burl, "/metrics")[0]
        capacity = sw.get_json(burl, "/capacity")
        cohorts = sw.get_json(burl, "/cohorts")
        b_rss = b.rss_kb()
        b_rc, b_last = b.stop()
        # The journal is final: its cold rebuild runs while R drains.
        rebuilder = start_cold_rebuild(path, work / "p30-cold.jsonl")
        procs.append(rebuilder)
        lines = path.read_bytes().count(b"\n")
        deadline = time.monotonic() + 600
        while True:
            st = sw.get_json(rurl, "/debug/readplane")
            env = st.get("staleness") or {}
            if (env.get("lagRecords") == 0 and env.get("position")
                    and env["position"]["offset"] == lines):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"the read replica did not drain: {env}")
            time.sleep(0.2)
        poller.stop()
        marks["read_replica_drained"] = time.perf_counter() - t0
        r_answers = {k: sw.get_json(rurl, f"/read/{k}")["answer"]
                     for k in ("pending", "quota")}
        r_metrics = sw.get_text(rurl, "/metrics")[0]
        r_rc, r_last = r.stop()
        marks["stopped"] = time.perf_counter() - t0
        cold = json.loads(rebuilder.wait_line('"digest"', 600))
        rebuilder.stop()
        marks["cold_rebuilt"] = time.perf_counter() - t0
    finally:
        if poller is not None:
            poller.halt.set()
        for proc in procs:
            proc.kill()
    before = _journal_prefix_state(sw, path, size_at_kill,
                                   work / "p30-kill.jsonl")
    final = check_arrivals_once(sw, path, "arrivals", HA_ARRIVALS)
    cold_s, cold_digest, cold_answers = (cold["s"], cold["digest"],
                                         cold["answers"])
    arrivals_before = sum(1 for k in before["admitted"]
                          if k.startswith("default/arrival-"))
    promo = b_last["promotion"] or {}
    timing = b_last["promotion_timing"] or {}
    cycles = b_last["cycles_on_device"]
    calls = dispatched(dict(on_device=cycles,
                            pipeline_stats=b_last["pipeline_stats"]))
    lat_a, lat_b = posted_a["latencies"], posted_b["latencies"]
    ages = [out["staleness"]["wallAgeSeconds"]
            for _t, _k, out, _s in poller.answers if out.get("staleness")]
    near = [t for t, _k, _o, _s in poller.answers
            if abs(t - killed_at) <= STALENESS_BOUND_S]
    read_s = [s for _t, _k, _o, s in poller.answers]
    acquired = float(promoted["acquired_at"])
    replay_s, verify_s = (float(promoted["replay_s"]),
                          float(promoted["verify_s"]))
    # The measurements first, then the gates.
    say(f"  boot s: A {a_boot:.3f} (serving {a_serving:.3f}, then its "
        f"promotion) B {b_boot:.3f} R {r_boot:.3f}; A journaled "
        f"{arrivals_before} arrivals admitted when it died (rc {a_rc}, "
        f"sigkill@admission:{kill_at})")
    say(f"  promotion s from A's death to B's role=leader line: "
        f"{leader_at - killed_at:.3f} = lease wait "
        f"{acquired - killed_at:.3f} + replay {replay_s:.3f} + verify "
        f"{verify_s:.3f} + attach "
        f"{leader_at - acquired - replay_s - verify_s:.3f}; report: "
        f"{promo.get('reason')} (checkpoint seq "
        f"{promo.get('checkpoint_seq')} epoch "
        f"{promo.get('checkpoint_epoch')}, partial_cycle="
        f"{promo.get('partial_cycle')}); timing {timing}")
    say(f"  POST to A p50_s={pct(lat_a, 0.5):.5f} p95_s={pct(lat_a, 0.95):.5f}"
        f" codes {sorted(set(posted_a['codes']))}; re-POST to B p50_s="
        f"{pct(lat_b, 0.5):.5f} p95_s={pct(lat_b, 0.95):.5f} codes "
        f"{ {c: posted_b['codes'].count(c) for c in set(posted_b['codes'])} }")
    say(f"  reads through the frontend (R only): {len(poller.answers)} "
        f"answers, {len(poller.errors)} errors, max staleness "
        f"{max(ages, default=None)} s (bound {STALENESS_BOUND_S}), "
        f"{len(near)} within {STALENESS_BOUND_S} s of the kill, query s "
        f"p50={pct(read_s, 0.5) if read_s else None} "
        f"p95={pct(read_s, 0.95) if read_s else None}; R "
        f"{r_last['rebuilds']} rebuilds, {r_last['queries']} queries")
    rebuild_n = sum(sw.metric_values(
        r_metrics, "readplane_rebuild_seconds_count").values())
    rebuild_sum = sum(sw.metric_values(
        r_metrics, "readplane_rebuild_seconds_sum").values())
    oldest = sorted(((out["staleness"]["wallAgeSeconds"], t - killed_at)
                     for t, _k, out, _s in poller.answers
                     if out.get("staleness")), reverse=True)[:3]
    say(f"  R: {rebuild_n:.0f} rebuilds, mean "
        f"{rebuild_sum / max(rebuild_n, 1):.3f} s; the oldest answers "
        f"(age s, s after the kill): "
        + ", ".join(f"({a:.3f}, {t:+.1f})" for a, t in oldest))
    say(f"  B: drain_s={drain_s:.3f} device_cycles={cycles} "
        f"wall_per_device_cycle_s={drain_s / max(cycles, 1):.5f} "
        f"pipeline_stats={b_last['pipeline_stats']} tailer_rebuilds="
        f"{b_last['tailer_rebuilds']} loop_s={b_last['loop_s']} "
        f"rss_kb={b_rss}; cold "
        f"rebuild on the CPU {cold_s:.3f} s, digest {cold_digest}, "
        f"canonical answer {cold['canonical_bytes']} bytes")
    say("  phase marks s: " + " ".join(f"{k}={v:.1f}"
                                        for k, v in marks.items()))
    say(f"  heads_launches={b_last['heads_launches']} (B, {cycles} device "
        f"cycles, {calls} dispatched calls) | {card}")
    if a_rc != -signal.SIGKILL or (b_rc, r_rc) != (0, 0):
        raise AssertionError(f"exit codes A={a_rc} B={b_rc} R={r_rc}")
    if not 30 <= arrivals_before <= 50:
        raise AssertionError(f"{arrivals_before} arrivals journaled "
                             f"admitted at the kill, not 30 to 50")
    if set(posted_a["codes"]) != {201} \
            or not set(posted_b["codes"]) <= {200, 201}:
        raise AssertionError(f"POST codes A {sorted(set(posted_a['codes']))}"
                             f" B {sorted(set(posted_b['codes']))}")
    if not (b_last["role"] == "leader" and b_last["epoch"] == 2
            and promo.get("verified") and promo["checkpoint_epoch"] == 1
            and promo["checkpoint_seq"] is not None):
        raise AssertionError(f"B's promotion: role {b_last['role']} epoch "
                             f"{b_last['epoch']} report {promo}")
    lost = before["admitted"] - final["admitted"]
    if lost or final["admitted_twice"]:
        raise AssertionError(f"admissions lost across the kill "
                             f"{sorted(lost)[:5]}, admitted twice "
                             f"{final['admitted_twice'][:5]}")
    check_usage(capacity, cohorts)
    if b_idle["stateDigest"] != cold_digest \
            or r_last["state_digest"] != cold_digest:
        raise AssertionError(f"digests: B {b_idle['stateDigest']}, R "
                             f"{r_last['state_digest']}, cold rebuild "
                             f"{cold_digest}")
    if (r_last["canonical_sha256"] != cold["canonical_sha256"]
            or r_last["canonical_bytes"] != cold["canonical_bytes"]
            or r_answers != cold_answers):
        raise AssertionError("the read replica's answer differs from the "
                             "cold rebuild's")
    served = [ln for text in (a_metrics, b_metrics)
              for ln in sw.metric_lines(text, "visibility_queries_total")]
    if served:
        raise AssertionError(f"the leaders served reads: {served[:4]}")
    if (poller.errors or len(ages) != len(poller.answers) or not ages
            or max(ages) > STALENESS_BOUND_S
            or not any(t < killed_at for t in near)
            or not any(t > killed_at for t in near)
            or any(out.get("routedTo") != rurl
                   for _t, _k, out, _s in poller.answers)):
        raise AssertionError("reads: a failed, unstamped or misrouted "
                             "answer, or one past the staleness bound")
    if not b_last["heads_launches"] == calls > 0:
        raise AssertionError(f"B's heads launches {b_last['heads_launches']}"
                             f", dispatched calls {calls}")
    return b_last["heads_launches"]


def compute_apps() -> list:
    """[(pid, process name)] that ``nvidia-smi --query-compute-apps``
    lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return [(int(pid), name.strip()) for pid, _, name in
            (line.partition(",") for line in out.splitlines())
            if pid.strip().isdigit()]


def sweep(sw, timeout: float = 30.0) -> list:
    """The processes this script left, killed: every child still
    registered with serve_world, every live process below this one or in
    a session a child of it led (``/proc``), and every compute process on
    the card that ``nvidia-smi`` lists but this one (waited for up to
    ``timeout`` seconds, as the card releases a killed process's
    context). Returns a line per survivor; empty when none."""
    import os

    found = [f"registered child: {' '.join(argv)}"
             for argv in sw.stop_all()]
    left = sw.survivors()
    found += [f"pid {pid}: {argv}" for pid, argv in left]
    sw.kill_survivors(left)
    deadline = time.monotonic() + timeout
    while True:
        others = other_compute_apps()
        if not others or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    found += [f"compute process on the card: pid {pid} {name}"
              for pid, name in others]
    return found


def other_compute_apps() -> list:
    """The card's compute processes but this one. In a container
    ``nvidia-smi`` may list processes of other pid namespaces under a
    pid that is not theirs (this one's context included, under pid 1
    on the H100 machines): then every entry but one is another's."""
    import os

    apps = compute_apps()
    if any(pid == os.getpid() for pid, _ in apps):
        return [(pid, name) for pid, name in apps if pid != os.getpid()]
    return apps[1:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kueue_tpu_torch.bench import serve_world as sw

    try:
        kind, kernels = run_phases()
    finally:
        found = sweep(sw)
        for line in found:
            print(f"chip_smoke: left running, killed: {line}",
                  file=sys.stderr)
    if found:
        return 1
    print(f"processes left: none (/proc below this pid and in the "
          f"sessions of its {len(sw._SESSIONS)} children; nvidia-smi "
          f"compute apps: {compute_apps()}, this process's context "
          f"among them)")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases() -> str:
    """Every phase, then the phase seconds and the card's line. Returns
    the card's kind and the kernels' summary."""
    import torch

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
    span("19-30 setup")
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
    span("27")
    print("[27] serving engine traced: cycle_latency, default loop")
    by_path["cycle_latency_traced"] = phase_traced_engine(heads, card)
    print(f"phase seconds: {spans_line()}")
    print(card)
    return kind, {"kernels": [
        dict(name="heads_segment_min", route="cuda",
             source="kueue_tpu_torch/csrc/heads.cu",
             replaces="kueue_tpu/ops/pallas_kernels.py:83",
             launches=sum(by_path.values()), launches_by_path=by_path,
             **heads_row),
        dict(name="leaf_fit_counts", route="cuda",
             source="kueue_tpu_torch/csrc/leaf.cu",
             replaces="kueue_tpu/ops/pallas_kernels.py:152",
             launches=leaf_launches, **leaf_row)]}


if __name__ == "__main__":
    sys.exit(main())
