"""Flight recorder: deterministic record/replay and fault injection for
the admission pipeline, the port of ``kueue_tpu/replay``.

It turns a live serving run into a regression test:

  * ``trace``     the versioned, checksummed trace framing (one JSON
                  frame per line, CRC-chained so truncation or tampering
                  anywhere invalidates the tail);
  * ``recorder``  FlightRecorder captures an engine's inputs (object
                  creations, submissions, clock ticks) and each cycle's
                  decision stream and phase timings;
  * ``replayer``  re-executes a trace through the real engine (host
                  path, device path, or differential both) and asserts
                  the decision stream is byte-identical, with per-cycle
                  phase attribution;
  * ``faults``    injects SIGKILL-mid-cycle, torn-journal-tail,
                  oracle-crash and delayed-verdict faults (and the rest
                  of its KINDS) under replay or live serving
                  (serve.py --fault).

Traces are interchangeable with the JAX package's in both directions.
"""

from kueue_tpu_torch.replay.faults import FaultPlan, arm_faults
from kueue_tpu_torch.replay.recorder import FlightRecorder
from kueue_tpu_torch.replay.replayer import ReplayReport, replay_trace
from kueue_tpu_torch.replay.trace import (
    TraceCorruption,
    TraceReader,
    TraceWriter,
    canonical_decisions,
    decision_digest,
)

__all__ = [
    "FaultPlan",
    "FlightRecorder",
    "ReplayReport",
    "TraceCorruption",
    "TraceReader",
    "TraceWriter",
    "arm_faults",
    "canonical_decisions",
    "decision_digest",
    "replay_trace",
]
