"""kueue_tpu_torch.readplane: the journal-native global read plane.

The port of ``kueue_tpu/readplane/__init__.py``.

Stateless, staleness-bounded query replicas (CQRS read half): boot
from sealed checkpoints, tail the journal suffix, answer
position/quota/explain/pending queries and serve SSE watch streams
from a locally rebuilt engine — with every response stamped with the
journal position + wall age it answered from, and zero read traffic
ever reaching the admission leader.
"""

from kueue_tpu_torch.readplane.frontend import ReadFrontend
from kueue_tpu_torch.readplane.queries import (
    QUERY_KINDS,
    answer_query,
    canonical_answer,
)
from kueue_tpu_torch.readplane.replica import ReadReplica

__all__ = [
    "QUERY_KINDS",
    "ReadFrontend",
    "ReadReplica",
    "answer_query",
    "canonical_answer",
]
