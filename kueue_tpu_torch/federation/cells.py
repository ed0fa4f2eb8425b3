"""Cell-facing plumbing for the federation dispatcher: the HTTP
transport to a cell's serving endpoint, and the per-cell health
machinery (probe backoff + circuit breaker).

The port of ``kueue_tpu/federation/cells.py``. Nothing here touches a
device: the dispatcher process resolves none.

The breaker mirrors the oracle supervisor's shape
(oracle/supervisor.py): CLOSED/OPEN/HALF_OPEN, demotion after
``threshold`` consecutive probe failures, cooldown measured in
dispatcher ticks with doubling capped at 8x, one half-open probe per
window. Probe pacing uses the same deterministic CRC jitter — every
dispatcher in a fleet decorrelates without a PRNG, and a replayed
dispatcher probes on the same schedule.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
import zlib
from typing import Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
_STATE_CODE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


def _jitter01(*parts) -> float:
    """Deterministic uniform-ish fraction in [0, 1): CRC-32 of the
    probe coordinates (the supervisor's jitter, not a PRNG — no hidden
    state, no draw-order coupling)."""
    raw = zlib.crc32(":".join(str(p) for p in parts).encode("utf-8"))
    return (raw & 0xFFFFFFFF) / 4294967296.0


class CellTransportError(Exception):
    """The cell is unreachable (connection refused/reset, timeout) —
    the ONLY signal that feeds the breaker. An HTTP-level refusal
    (503 not-leader, 429 shed) is a healthy cell saying no."""


class HTTPCellTransport:
    """urllib transport to one cell's serving endpoint (serve --ha)."""

    def __init__(self, base_url: str, timeout: float = 5.0,
                 auth_token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.auth_token = auth_token

    @property
    def events_url(self) -> str:
        return self.base_url + "/events"

    def _request(self, path: str, data: Optional[bytes] = None,
                 headers: Optional[dict] = None):
        hdrs = {"Content-Type": "application/json"}
        if self.auth_token:
            hdrs["Authorization"] = f"Bearer {self.auth_token}"
        hdrs.update(headers or {})
        req = urllib.request.Request(
            self.base_url + path, data=data, headers=hdrs,
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, json.loads(r.read() or b"null")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except ValueError:
                body = {}
            return e.code, body
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise CellTransportError(
                f"{self.base_url}{path}: {e}") from None

    def submit(self, wl_jsonable: dict,
               route_epoch: Optional[int] = None) -> dict:
        """POST /workloads with the fencing epoch. Returns the cell's
        verdict dict with ``code`` re-attached (the handler pops it
        into the HTTP status)."""
        headers = {}
        if route_epoch is not None:
            headers["X-Route-Epoch"] = str(int(route_epoch))
        code, body = self._request(
            "/workloads", data=json.dumps(wl_jsonable).encode(),
            headers=headers)
        body = body if isinstance(body, dict) else {}
        body["code"] = code
        return body

    def health(self) -> dict:
        """GET /debug/ha: role, epoch, state digest, shedder posture —
        the probe payload the router scores against."""
        _, body = self._request("/debug/ha")
        return body if isinstance(body, dict) else {}

    def workloads(self) -> list:
        """GET /workloads: the cell's registered workload list, used
        for admission confirmation and zombie reconciliation."""
        _, body = self._request("/workloads")
        return body if isinstance(body, list) else []

    def revoke(self, keys: list, epoch: int) -> dict:
        """POST /federation/revoke: fence + delete the given workload
        keys on the cell (zombie reconciliation)."""
        code, body = self._request(
            "/federation/revoke",
            data=json.dumps({"keys": list(keys),
                             "epoch": int(epoch)}).encode())
        body = body if isinstance(body, dict) else {}
        body["code"] = code
        return body


class CellBreaker:
    """Per-cell circuit breaker over health-probe outcomes, the
    supervisor's state machine re-keyed on dispatcher ticks."""

    def __init__(self, metrics=None, cell: str = "",
                 threshold: int = 3, cooldown_ticks: int = 8):
        self.metrics = metrics
        self.cell = cell
        self.threshold = max(1, int(threshold))
        self.cooldown_ticks = max(1, int(cooldown_ticks))
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opens = 0
        self.closes = 0
        self._cooldown = self.cooldown_ticks
        self._reopen_at: Optional[int] = None

    def allow_probe(self, tick: int) -> bool:
        """Gate in front of a probe attempt. False = stay demoted;
        True from OPEN means this probe is the half-open trial."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._reopen_at is not None and tick >= self._reopen_at:
                self._transition(HALF_OPEN, "probe window")
                return True
            return False
        return True  # HALF_OPEN: the probe itself

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != CLOSED:
            self.closes += 1
            self._cooldown = self.cooldown_ticks
            self._transition(CLOSED, "probe succeeded")

    def record_failure(self, tick: int) -> bool:
        """Returns True when this failure OPENS the breaker (the
        dispatcher drains the cell exactly once per open)."""
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._cooldown = min(self._cooldown * 2,
                                 self.cooldown_ticks * 8)
            self._reopen_at = tick + self._cooldown
            self._transition(OPEN, "probe failed")
            return False  # already drained when it first opened
        if (self.state == CLOSED
                and self.consecutive_failures >= self.threshold):
            self.opens += 1
            self._reopen_at = tick + self._cooldown
            self._transition(OPEN,
                             f"{self.consecutive_failures} consecutive "
                             f"probe failures")
            return True
        return False

    def _transition(self, to: str, reason: str) -> None:
        if to == self.state:
            return
        if self.metrics is not None:
            try:
                self.metrics.counter(
                    "federation_breaker_transitions_total").inc(
                    (self.cell, self.state, to))
                self.metrics.gauge(
                    "federation_cell_breaker_state").set(
                    (self.cell,), _STATE_CODE[to])
            except KeyError:
                pass
        self.state = to

    def status(self) -> dict:
        return {"state": self.state,
                "consecutiveFailures": self.consecutive_failures,
                "opens": self.opens, "closes": self.closes,
                "cooldownTicks": self._cooldown,
                "reopenAt": self._reopen_at}


class CellHandle:
    """One federated cell as the dispatcher sees it: transport +
    breaker + fencing epoch + the last probe's scoring inputs."""

    def __init__(self, name: str, transport, zone: str = "",
                 metrics=None, probe_interval_ticks: int = 2,
                 breaker_threshold: int = 3,
                 breaker_cooldown_ticks: int = 8):
        self.name = name
        self.zone = zone
        self.transport = transport
        self.metrics = metrics
        self.breaker = CellBreaker(
            metrics=metrics, cell=name, threshold=breaker_threshold,
            cooldown_ticks=breaker_cooldown_ticks)
        # Fencing epoch: bumped (and journaled) every time the cell's
        # breaker opens. Handoffs carry it; the cell refuses revoked
        # keys at stale epochs, so a zombie cannot double-admit.
        self.epoch = 1
        self.up = False          # probe succeeded AND role == leader
        self.last_probe: dict = {}
        self.last_probe_tick = -1
        self.probe_interval_ticks = max(1, int(probe_interval_ticks))
        self._next_probe = 0

    def probe_due(self, tick: int) -> bool:
        return tick >= self._next_probe and self.breaker.allow_probe(tick)

    def schedule_next_probe(self, tick: int, failed: bool) -> None:
        """Decorrelated-jitter pacing: healthy cells re-probe every
        interval +- jitter; a failing cell backs off toward the
        breaker's cooldown so a dead cell costs one connect timeout
        per window, not per tick."""
        base = self.probe_interval_ticks
        if failed:
            base = max(base, min(self.breaker._cooldown,
                                 self.breaker.cooldown_ticks * 8))
        span = max(1, int(base * (0.5 + _jitter01(self.name, tick))))
        self._next_probe = tick + span

    def status(self) -> dict:
        return {"name": self.name, "zone": self.zone,
                "epoch": self.epoch, "up": self.up,
                "breaker": self.breaker.status(),
                "lastProbeTick": self.last_probe_tick,
                "role": self.last_probe.get("role", ""),
                "stateDigest": self.last_probe.get("stateDigest", "")}
