"""Replica role state machine.

The port of ``kueue_tpu/ha/roles.py``, unchanged.

Roles and legal transitions (ARCHITECTURE.md "HA serving plane"):

    follower ──► candidate ──► leader
        ▲            │            │
        │            ▼            ▼
        └──────── follower      fenced   (terminal)
                                 ▲
    leader ──────────────────────┘  (lease stolen / digest mismatch)

  * follower   — tails the journal, serves reads/SSE, never writes
  * candidate  — won the lease; replaying the journal to head and
                 verifying the decision digest BEFORE accepting writes
  * leader     — runs admission cycles, renews the lease, journals
  * fenced     — terminal: the replica observed a newer epoch (or a
                 digest mismatch) and must never write again; it keeps
                 serving reads until restarted

Transitions are checked, not implicit: an illegal hop (e.g. follower →
leader without the candidate verification step) raises
RoleTransitionError — the state machine IS the protocol document.
"""

from __future__ import annotations

from typing import Callable, Optional

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"
FENCED = "fenced"

ROLES = (FOLLOWER, CANDIDATE, LEADER, FENCED)

# Promotion must pass through CANDIDATE (the replay-verification gate);
# FENCED is terminal; a candidate that loses the race or fails
# verification falls back to follower or fences.
_LEGAL = {
    (FOLLOWER, CANDIDATE),
    (CANDIDATE, LEADER),
    (CANDIDATE, FOLLOWER),
    (CANDIDATE, FENCED),
    (LEADER, FOLLOWER),
    (LEADER, FENCED),
}

# ha_role gauge encoding (stable across releases — dashboards key on it).
ROLE_CODES = {FOLLOWER: 0, LEADER: 1, CANDIDATE: 2, FENCED: 3}


class RoleTransitionError(Exception):
    """An illegal role hop: the caller skipped a protocol step."""


class RoleMachine:
    """Current role + transition log. ``listeners`` fire with
    (old, new, reason) after every successful transition."""

    def __init__(self, initial: str = FOLLOWER):
        if initial not in ROLES:
            raise ValueError(f"unknown role {initial!r}")
        self.role = initial
        self.listeners: list[Callable] = []
        # (old, new, reason) in order — the audit trail /debug/ha shows.
        self.transitions: list[tuple] = []

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    @property
    def is_fenced(self) -> bool:
        return self.role == FENCED

    def to(self, new: str, reason: str = "") -> None:
        if new not in ROLES:
            raise ValueError(f"unknown role {new!r}")
        old = self.role
        if old == new:
            return
        if (old, new) not in _LEGAL:
            raise RoleTransitionError(
                f"illegal role transition {old} -> {new}"
                f"{f' ({reason})' if reason else ''}")
        self.role = new
        self.transitions.append((old, new, reason))
        for fn in tuple(self.listeners):
            try:
                fn(old, new, reason)
            except Exception as e:  # noqa: BLE001 — observers must not
                import warnings      # unwind the control loop
                warnings.warn(f"role listener {fn!r} raised: {e!r}")

    def history(self, last: Optional[int] = None) -> list:
        rows = [{"from": o, "to": n, "reason": r}
                for o, n, r in self.transitions]
        return rows[-last:] if last else rows
