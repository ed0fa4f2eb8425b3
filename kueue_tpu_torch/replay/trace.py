"""Trace framing: versioned, checksummed JSONL.

The port of ``kueue_tpu/replay/trace.py``, frame for frame: each
package reads the other's traces. One JSON object ("frame") per line.
Frame kinds:

  header  {"f":"header","version":1,"schema":<api schema>,"label":...}
  input   {"f":"input","clock":c,"method":m,"args":[...],"kwargs":{..}}
  idle    {"f":"idle","n":k,"clock":c}        k coalesced idle cycles
  cycle   {"f":"cycle","seq":s,"clock":c,"mode":m,
           "decisions":[...],"digest":"%08x","phases":{...}}
  end     {"f":"end","frames":N,"digest":"%08x"}

Integrity: every frame carries ``crc`` = CRC-32 of its canonical JSON
(sans crc) chained from the previous frame's crc, so flipping a byte or
dropping a line invalidates every later frame and a reader can prove a
trace prefix is exactly what the recorder wrote. A torn final line
(crash mid-write) is tolerated and reported as ``truncated``; corruption
anywhere else raises TraceCorruption. The running ``digest`` chains the
per-cycle decision digests: two traces with equal digests carry
byte-identical decision streams.

Decision canonicalization is order-insensitive WITHIN a cycle (sorted by
workload key): the host path commits entries in nomination order while
the device path applies verdict slots in launch order, but the cycle's
semantic outcome (who got admitted with which flavors, counts and
topology, who got preempted) is path-invariant. Cycle ORDER remains
significant: the stream digest chains cycles in sequence.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Iterator, Optional

TRACE_VERSION = 1


class TraceCorruption(Exception):
    """The trace fails its frame CRC chain (tamper or mid-file
    corruption, distinct from a tolerated torn tail)."""


def _canon_bytes(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def frame_crc(frame: dict, prev_crc: int) -> int:
    body = {k: v for k, v in frame.items() if k != "crc"}
    return zlib.crc32(_canon_bytes(body), prev_crc)


def canonical_decisions(result) -> list:
    """The cycle's semantic decision record, path-invariant:
    [admitted, preempting], or [] when the cycle decided nothing.
    ``result`` is a CycleResult or None (idle).

    Only admissions and initiated preemptions are canonical: skipped and
    parked heads are not (the host path materializes them as entries,
    a device cycle reports only decided slots, and a cycle that decides
    nothing is an entry-less result on one path and an idle None on the
    other). Memoized per result object, since the flight recorder, the
    tracer and any other listener canonicalize the same (by then
    immutable) CycleResult."""
    if result is None:
        return []
    cached = getattr(result, "_canonical_decisions", None)
    if cached is not None:
        return cached
    from kueue_tpu_torch.scheduler.cycle import EntryStatus

    def topo(psa) -> Optional[list]:
        ta = getattr(psa, "topology_assignment", None)
        if ta is None:
            return None
        return [list(ta.levels),
                sorted([list(d.values), d.count] for d in ta.domains)]

    admitted = []
    preempting = []
    for e in list(result.entries) + list(result.inadmissible):
        if e.status == EntryStatus.ASSUMED:
            adm = e.obj.status.admission
            admitted.append([
                e.info.key, adm.cluster_queue,
                [[psa.name, sorted(psa.flavors.items()),
                  sorted(psa.resource_usage.items()), psa.count,
                  topo(psa)]
                 for psa in adm.pod_set_assignments]])
        elif e.status == EntryStatus.PREEMPTING:
            preempting.append([
                e.info.key,
                sorted(t.workload.key for t in e.preemption_targets)])
    decisions = ([] if not admitted and not preempting
                 else [sorted(admitted), sorted(preempting)])
    result._canonical_decisions = decisions
    return decisions


def decision_digest(decisions: list, prev: int = 0) -> int:
    return zlib.crc32(_canon_bytes(decisions), prev)


class TraceWriter:
    """Append frames with CRC chaining; flush per frame, fsync on cycle
    and end frames (the trace must survive the SIGKILL faults it exists
    to diagnose)."""

    def __init__(self, path: str, label: str = "", fsync: bool = True):
        from kueue_tpu_torch.api.conversion import SCHEMA_VERSION

        self.path = path
        self.fsync = fsync
        self._fh = open(path, "w", encoding="utf-8")
        self._crc = 0
        self._digest = 0
        self.frames = 0
        self.cycles = 0
        self._write({"f": "header", "version": TRACE_VERSION,
                     "schema": SCHEMA_VERSION, "label": label})

    def _write(self, frame: dict, sync: bool = False) -> None:
        self._crc = frame_crc(frame, self._crc)
        frame["crc"] = self._crc
        self._fh.write(json.dumps(frame, sort_keys=True,
                                  separators=(",", ":")) + "\n")
        self._fh.flush()
        if sync and self.fsync:
            os.fsync(self._fh.fileno())
        self.frames += 1

    def input(self, clock: float, method: str, args: list,
              kwargs: dict) -> None:
        frame: dict = {"f": "input", "clock": clock, "method": method,
                       "args": args}
        if kwargs:
            frame["kwargs"] = kwargs
        self._write(frame)

    def idle(self, n: int, clock: float) -> None:
        if n > 0:
            self._write({"f": "idle", "n": n, "clock": clock})

    def cycle(self, seq: int, clock: float, mode: str, decisions: list,
              phases: dict, verdict_digest: Optional[int] = None,
              cid: Optional[str] = None) -> None:
        self._digest = decision_digest(decisions, self._digest)
        frame = {"f": "cycle", "seq": seq, "clock": clock, "mode": mode,
                 "decisions": decisions,
                 "digest": f"{self._digest:08x}",
                 "phases": {k: round(v, 6) for k, v in phases.items()}}
        if verdict_digest is not None:
            frame["verdict"] = f"{verdict_digest:08x}"
        if cid is not None:
            # Joins this frame to the journal's cycle_trace record and
            # the tracer's span tree; outside the decision digest, so
            # traced and untraced recordings stay digest-identical.
            frame["cid"] = cid
        self._write(frame, sync=True)
        self.cycles += 1

    @property
    def digest(self) -> str:
        return f"{self._digest:08x}"

    def close(self) -> None:
        if self._fh.closed:
            return
        self._write({"f": "end", "frames": self.frames,
                     "digest": self.digest}, sync=True)
        self._fh.close()


class TraceReader:
    """Validate the CRC chain while iterating frames. ``truncated`` is
    set when the trace lacks its end frame (crash mid-record); a frame
    that fails its CRC raises TraceCorruption."""

    def __init__(self, path: str):
        self.path = path
        self.header: Optional[dict] = None
        self.truncated = False
        self.digest = ""
        self.frames = 0

    def __iter__(self) -> Iterator[dict]:
        crc = 0
        saw_end = False
        with open(self.path, encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                frame = json.loads(line)
            except json.JSONDecodeError:
                # Only a torn FINAL line is a crash artifact; a bad
                # line with valid frames after it is corruption.
                if any(rest.strip() for rest in lines[i + 1:]):
                    raise TraceCorruption(
                        f"{self.path}:{i + 1}: unparseable frame "
                        "followed by more frames") from None
                self.truncated = True
                break
            want = frame.get("crc")
            crc = frame_crc(frame, crc)
            if crc != want:
                raise TraceCorruption(
                    f"{self.path}:{i + 1}: frame CRC mismatch "
                    f"(got {want}, chain says {crc}): the trace was "
                    "modified or records were dropped")
            self.frames += 1
            kind = frame.get("f")
            if kind == "header":
                if frame.get("version") != TRACE_VERSION:
                    raise TraceCorruption(
                        f"unsupported trace version "
                        f"{frame.get('version')}")
                self.header = frame
                continue
            if kind == "end":
                self.digest = frame.get("digest", "")
                saw_end = True
                continue
            if kind == "cycle":
                self.digest = frame.get("digest", self.digest)
            yield frame
        if self.header is None:
            raise TraceCorruption(f"{self.path}: missing header frame")
        if not saw_end:
            self.truncated = True
