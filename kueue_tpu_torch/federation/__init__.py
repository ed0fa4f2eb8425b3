"""Multi-cell federation (the port of ``kueue_tpu/federation``): a
dispatcher tier routing workloads across N
independent HA cells (each its own journal/lease/checkpoint/oracle
domain), with an at-least-once handoff protocol made exactly-once by
the workload-name dedup at each cell's front door (ha/replica.py).

The reference analog is the MultiKueue layer (admissionchecks/
multikueue + the workload dispatcher): one control plane nominates a
remote cluster, hands the workload off, and reconciles the remote
admission status back. Here the cells are HA cells (``serve --ha``) and the
correctness claim is a robustness claim: kill an entire cell
mid-admission and no workload is lost or admitted twice, globally
(bench/federation_world.py drives it under a seeded multi-fault chain).
"""

from kueue_tpu_torch.federation.cells import (  # noqa: F401
    CellBreaker,
    CellHandle,
    CellTransportError,
    HTTPCellTransport,
)
from kueue_tpu_torch.federation.dispatcher import (  # noqa: F401
    FederationDispatcher,
)
