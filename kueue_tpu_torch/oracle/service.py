"""The oracle serving boundary: the decision core in-process or as a
standalone sidecar process, snapshot arrays in, verdict arrays out.

The port of ``kueue_tpu/oracle/service.py``:

  * TorchExecutor: the two device programs a scheduling cycle needs
    (``oracle/batched.cycle_step`` and ``ops/preempt.classical_targets``)
    in-process on a device, behind the interface of the JAX package's
    ``LocalExecutor``.
  * OracleServer: a stateless sidecar (``python -m
    kueue_tpu_torch.oracle.service --port N``) serving both programs
    through a TorchExecutor over the socket boundary (``oracle/wire.py``
    frames, byte-compatible with the JAX package's).
  * RemoteExecutor: the engine-side client. It ships numpy copies of
    its inputs (tensors are moved to the host first) and raises
    RemoteOracleError on a transport failure, which the bridge's
    supervisor retries and the engine turns into a ``remote-error``
    host cycle. An error the sidecar's executor raised comes back as
    RemoteExecutorError, which is not retried and leaves
    ``schedule_once`` as a local executor's error does: a kernel that
    fails on the card never hands the scheduling to the host.

The sim nomination's flavor grid and the TAS planner run in the engine
process, as they do in the JAX package's deployment.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
from typing import Optional

import numpy as np
import torch

from kueue_tpu_torch.oracle import wire

from kueue_tpu_torch.device import resolve_device
from kueue_tpu_torch.oracle import batched
from kueue_tpu_torch.ops import preempt as pops
from kueue_tpu_torch.ops import quota as qops


class TorchExecutor:
    """In-process execution on ``device`` (CUDA unless the caller asks
    for the CPU). Takes numpy arrays or tensors, returns numpy arrays."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _tensors(self, tensors: dict) -> dict:
        return {k: torch.as_tensor(
            np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
            device=self.device) for k, v in tensors.items()}

    def cycle_step(self, tensors: dict, statics: dict):
        """``oracle/batched.cycle_step`` on keyword tensors; its 14
        outputs as numpy arrays."""
        out = batched.cycle_step(**self._tensors(tensors), **statics)
        return [o.cpu().numpy() for o in out]

    def classical_targets(self, tensors: dict, statics: dict,
                          derived=None):
        """``ops/preempt.classical_targets`` on the tensors the JAX
        executor takes (``statics``: depth, v_cap); ``derived`` is a
        ``quota.derive_world`` result for ``usage`` when the caller has
        one. Returns found, overflow, target mask, target count, variant
        and borrow level as numpy arrays."""
        t = self._tensors(tensors)
        if derived is None:
            derived = qops.derive_world(
                t["nominal"], t["lend_limit"], t["borrow_limit"], t["usage"],
                t["parent"], depth=statics["depth"])
        out = pops.classical_targets(
            t["slot_need"], t["slot_pri"], t["slot_ts"], t["slot_fr"],
            t["slot_req"], t["wcq_policy"], t["reclaim_policy"],
            t["bwc_forbidden"], t["bwc_threshold"], t["cq_has_parent"],
            t["adm_cq"], t["adm_pri"], t["adm_ts"], t["adm_qrt"],
            t["adm_uid"], t["adm_ev"], t["adm_usage"], derived["usage"],
            derived["subtree_quota"], t["lend_limit"], t["borrow_limit"],
            t["nominal"], t["ancestors"], t["height"], t["local_chain"],
            t["root_nodes"], t["root_of_cq"],
            slot_cq=t.get("slot_cq"), adm_rank=t.get("adm_rank"),
            adm_by_root=t.get("adm_by_root"),
            depth=statics["depth"], v_cap=statics["v_cap"])
        return [o.cpu().numpy() for o in out]


class RemoteOracleError(Exception):
    """Transport failure talking to the oracle service; the bridge falls
    back to the sequential path for the cycle."""


class RemoteExecutorError(RuntimeError):
    """The oracle service answered with an error: its executor failed
    (or the op is unknown to it). Not a transport failure, so it is not
    retried and propagates out of ``schedule_once``."""


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class RemoteExecutor:
    """Client side of the serving boundary: one persistent connection,
    reconnect-per-error, RemoteOracleError on transport failure and
    RemoteExecutorError on an error reply. Has no device: the caller encodes where it likes and the inputs cross as
    numpy arrays."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # Frame bytes sent and received, and calls answered.
        self.bytes_sent = 0
        self.bytes_received = 0
        self.calls = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout)
            except OSError as e:
                raise RemoteOracleError(str(e)) from e
        return self._sock

    def _call(self, op: str, tensors: dict, meta: dict):
        frame = wire.pack(op, tensors, meta)
        with self._lock:
            try:
                sock = self._connect()
                wire.send_msg(sock, frame)
                body = wire.recv_msg(sock)
            except (OSError, ConnectionError) as e:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                raise RemoteOracleError(str(e)) from e
            self.bytes_sent += len(frame)
            self.bytes_received += 4 + len(body)
            self.calls += 1
        rop, out_tensors, out_meta = wire.unpack(body)
        if rop == "error":
            raise RemoteExecutorError(
                out_meta.get("message", "remote error"))
        n = out_meta["n"]
        return [out_tensors[f"out{i}"] for i in range(n)]

    def cycle_step(self, tensors: dict, statics: dict):
        return self._call("cycle_step",
                          {k: _host_array(v) for k, v in tensors.items()},
                          statics)

    def classical_targets(self, tensors: dict, statics: dict,
                          derived=None):
        # The server re-derives the quota state from ``usage``.
        return self._call("classical_targets",
                          {k: _host_array(v) for k, v in tensors.items()},
                          statics)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class OracleServer:
    """The sidecar: serves ``cycle_step`` and ``classical_targets``
    through a TorchExecutor on ``device`` (CUDA unless the caller asks
    for the CPU). ``fault_after`` (``--fault crash-after:N``): hard-exit
    the process right after the Nth compute reply is sent, the
    sidecar-crash-mid-serving case; the engine surfaces
    RemoteOracleError, falls back to the host path for the cycle and
    reconnects once the sidecar is restarted. An executor error is
    answered with an ``error`` frame and the connection keeps
    serving."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 fault_after: Optional[int] = None, device=None):
        self.executor = TorchExecutor(device)
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self.fault_after = fault_after
        self.served = 0  # compute replies
        # Frame bytes received and sent for compute calls.
        self.bytes_in = 0
        self.bytes_out = 0
        self._served_lock = threading.Lock()

    def _count(self, n_in: int, n_out: int) -> bool:
        """Count one compute reply (before it is sent, so a client that
        has its reply sees it counted); True when it is the one after
        which the fault crashes the process."""
        with self._served_lock:
            self.served += 1
            self.bytes_in += n_in
            self.bytes_out += n_out
            return (self.fault_after is not None
                    and self.served >= self.fault_after)

    @staticmethod
    def _crash() -> None:
        # os._exit, not sys.exit: a real sidecar crash runs no finalizers
        # and leaves peers mid-read on the socket.
        os._exit(17)

    def serve_forever(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def close(self) -> None:
        self._listener.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    body = wire.recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                op = None
                try:
                    op, tensors, meta = wire.unpack(body)
                    if op == "ping":
                        reply = wire.pack("pong", {}, {"n": 0})
                    elif op in ("cycle_step", "classical_targets"):
                        outs = getattr(self.executor, op)(tensors, meta)
                        reply = wire.pack(
                            "ok", {f"out{i}": o
                                   for i, o in enumerate(outs)},
                            {"n": len(outs)})
                    else:
                        reply = wire.pack("error", {},
                                          {"message": f"unknown op {op}"})
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    reply = wire.pack("error", {}, {"message": repr(e)})
                crash = (op in ("cycle_step", "classical_targets")
                         and self._count(4 + len(body), len(reply)))
                try:
                    wire.send_msg(conn, reply)
                except (ConnectionError, OSError):
                    return
                if crash:
                    self._crash()


def parse_fault(spec: str) -> Optional[int]:
    """``crash-after:N`` -> N; empty -> None."""
    if not spec:
        return None
    kind, _, n = spec.partition(":")
    if kind != "crash-after" or not n.isdigit():
        raise SystemExit(f"unknown --fault {spec!r}")
    return int(n)


def main(argv=None) -> None:
    """The sidecar process. Prints ``oracle service listening on
    HOST:PORT`` once it accepts connections; on SIGTERM or SIGINT it
    prints one JSON line with its heads kernel launches, its compute
    replies and their frame bytes each way, and exits 0."""
    import argparse

    parser = argparse.ArgumentParser(
        description="kueue_tpu_torch oracle service")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7461)
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without CUDA) or cpu")
    parser.add_argument(
        "--fault", default="",
        help="fault injection, e.g. crash-after:3 (exit hard after the "
             "3rd compute reply)")
    args = parser.parse_args(argv)
    fault_after = parse_fault(args.fault)
    server = OracleServer(args.host, args.port, fault_after=fault_after,
                          device=args.device)

    def _stop(*_a):
        from kueue_tpu_torch.ops import heads

        print(json.dumps({"heads_launches": heads.launches,
                          "compute_replies": server.served,
                          "bytes_in": server.bytes_in,
                          "bytes_out": server.bytes_out}), flush=True)
        sys.stderr.flush()
        os._exit(0)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"oracle service listening on {server.address[0]}:"
          f"{server.address[1]} (device={server.executor.device})",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
