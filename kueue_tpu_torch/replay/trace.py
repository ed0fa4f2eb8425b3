"""The canonical decision record of a cycle and its digest.

A trimmed copy of ``kueue_tpu/replay/trace.py``: only
``canonical_decisions`` and ``decision_digest``, which the tracer's
correlation id (``obs/span.correlation_id``) is built from. The flight
recorder's trace writer and reader are not ported yet.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Optional


def _canon_bytes(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def canonical_decisions(result) -> list:
    """The cycle's semantic decision record, path-invariant:
    [admitted, preempting], or [] when the cycle decided nothing.
    ``result`` is a CycleResult or None (idle).

    Only admissions and initiated preemptions are canonical: skipped and
    parked heads are not (the host path materializes them as entries,
    a device cycle reports only decided slots). Memoized per result
    object, since the tracer and any other listener canonicalize the
    same (by then immutable) CycleResult."""
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
