"""The admitted-state digest: an order-canonical CRC over the engine's
applied admissions, the same for a live engine and a journal rebuild of
the same state.

The port of ``kueue_tpu/ha/digest.py``, trimmed to ``_canon_crc`` and
``admitted_state_digest``: a sealed checkpoint's header carries the
digest (``store/checkpoint.py``), and ``recover_engine(prove_genesis=
True)`` compares it with a genesis replay's. The decision chain
(``DigestChain``) belongs to HA, which the port does not have yet.
"""

from __future__ import annotations

import json
import zlib


def _canon_crc(obj) -> int:
    return zlib.crc32(json.dumps(obj, sort_keys=True,
                                 separators=(",", ":")).encode("utf-8"))


def admitted_state_digest(engine) -> str:
    """CRC-32 (hex) of the sorted (key, Admission) pairs of the
    engine's admitted, unfinished workloads, in serde JSON."""
    from kueue_tpu_torch.api.serde import to_jsonable

    rows = []
    for key in sorted(engine.workloads):
        wl = engine.workloads[key]
        if wl.is_finished or wl.status.admission is None:
            continue
        rows.append([key, to_jsonable(wl.status.admission)])
    return f"{_canon_crc(rows):08x}"
