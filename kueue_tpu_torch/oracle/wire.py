"""Wire format of the oracle serving boundary: length-prefixed frames
carrying a JSON header and raw array bytes.

A copy of ``kueue_tpu/oracle/wire.py``: the frames are byte-identical
to the JAX package's for the same numpy inputs, so either package's
client talks to either package's server. A frame is a 4-byte big-endian
length followed by

    [4B header_len][header JSON][array bytes...]

The header carries the op name, the static keyword arguments and one
(name, dtype, shape, byte offset, length) entry per array; the payloads
are C-contiguous numpy buffers concatenated in header order. ``pack``
takes numpy arrays only: a caller holding tensors moves them to the host
first.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any

import numpy as np

_LEN = struct.Struct(">I")


def pack(op: str, tensors: dict[str, np.ndarray],
         meta: dict[str, Any]) -> bytes:
    entries = []
    blobs = []
    offset = 0
    for name, arr in tensors.items():
        if not isinstance(arr, np.ndarray):
            raise TypeError(f"{name}: wire.pack takes numpy arrays, got "
                            f"{type(arr).__name__}")
        arr = np.ascontiguousarray(arr)
        b = arr.tobytes()
        entries.append({"name": name, "dtype": str(arr.dtype),
                        "shape": list(arr.shape), "off": offset,
                        "len": len(b)})
        blobs.append(b)
        offset += len(b)
    header = json.dumps({"op": op, "meta": meta,
                         "tensors": entries}).encode("utf-8")
    body = _LEN.pack(len(header)) + header + b"".join(blobs)
    return _LEN.pack(len(body)) + body


def unpack(body: bytes):
    """(op, {name: numpy array}, meta) of one frame's body (the bytes
    after its length prefix)."""
    (hlen,) = _LEN.unpack_from(body, 0)
    header = json.loads(body[4:4 + hlen].decode("utf-8"))
    base = 4 + hlen
    tensors = {}
    for e in header["tensors"]:
        buf = body[base + e["off"]:base + e["off"] + e["len"]]
        tensors[e["name"]] = np.frombuffer(
            buf, dtype=np.dtype(e["dtype"])).reshape(e["shape"]).copy()
    return header["op"], tensors, header["meta"]


def send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(payload)


def recv_msg(sock: socket.socket) -> bytes:
    head = _recv_exact(sock, 4)
    (n,) = _LEN.unpack(head)
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)
