"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library is built at first use, never at import, into ``_build/`` inside
the package, keyed by a hash of the source and the flags, so a changed
source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signature of each library's entry point: (symbol, argtypes).
_ENTRY = {
    "heads": ("kueue_heads_segment_min",
              [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]),
    "leaf": ("kueue_leaf_fit_counts",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=tuple(_ENTRY)) -> dict:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together. Returns {name: seconds
    from the start until its nvcc finished, or 0.0 when it was cached}.
    The compiler's report (``-Xptxas -v``) goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    todo = [name for name in names if not library_path(name).exists()]
    nvcc = _nvcc() if todo else None
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


@functools.cache
def load(name: str):
    """The ctypes entry point of kernel library ``name``, built first
    if needed."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    symbol, argtypes = _ENTRY[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, device, *args) -> None:
    """Call kernel library ``name``'s entry point with ``args`` and the
    current stream of ``device``; raise if it returns a cudaError_t
    other than 0. The runtime launches on its current device, so the
    call enters ``device`` only when that is another one. The stream is
    read as the raw handle, as PyTorch's own generated kernel launchers
    read it, without building a ``torch.cuda.Stream`` object per call."""
    import torch

    fn = load(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
