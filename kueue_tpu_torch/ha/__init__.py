"""HA serving plane: journal-backed leader/follower failover.

The port of ``kueue_tpu/ha/__init__.py``; ``ladder`` (the degradation
ladder) is imported from its module.

The durability primitives (crash-safe journal, flight recorder, fault
injection, SSE) all terminate in one `serve` replica; this package is
the scale-out story. Arax's shape (PAPERS.md):
many client-facing frontends, one accelerator-backed decision cycle —
replicas coordinate through a journal-adjacent lease file, exactly one
leader runs admission cycles, followers tail the journal and absorb
read/SSE traffic, and promotion is replay-verified before the new
leader accepts a single write.

Modules:

  lease    fenced lease file (monotonic epoch = the fencing token)
  roles    the replica role state machine (follower/candidate/leader/
           fenced) with explicit legal transitions
  digest   decision-digest chain + admitted-state digest, journaled as
           ``ha_digest`` records inside the cycle's fsync boundary
  tailer   follower-side incremental journal tailing (replay lag,
           synthesized SSE events)
  shedder  token-bucket admission-rate control wired to SLO burn rates
  replica  HAReplica: the orchestrator serve.py runs in --ha mode
"""

from kueue_tpu_torch.ha.digest import DigestChain, admitted_state_digest
from kueue_tpu_torch.ha.lease import FencedLease, LeaseState
from kueue_tpu_torch.ha.replica import HAReplica
from kueue_tpu_torch.ha.roles import (
    CANDIDATE,
    FENCED,
    FOLLOWER,
    LEADER,
    RoleMachine,
    RoleTransitionError,
)
from kueue_tpu_torch.ha.shedder import AdmissionShedder, TokenBucket
from kueue_tpu_torch.ha.tailer import JournalTailer

__all__ = [
    "AdmissionShedder",
    "CANDIDATE",
    "DigestChain",
    "FENCED",
    "FOLLOWER",
    "FencedLease",
    "HAReplica",
    "JournalTailer",
    "LEADER",
    "LeaseState",
    "RoleMachine",
    "RoleTransitionError",
    "TokenBucket",
    "admitted_state_digest",
]
