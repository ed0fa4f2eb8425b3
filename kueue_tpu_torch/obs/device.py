"""Device-path named ranges: line host spans up with profiler traces.

The port of ``kueue_tpu/obs/device.py``. The oracle bridge's batched
phases (encode → device → apply → finalize) get
``torch.profiler.record_function`` ranges named
``kueue_tpu_torch.oracle.<phase>``, so a profiler capture
(``Engine.profiled`` / ``KUEUE_TPU_PROFILE``) shows the same phase names
the host span tree reports, with the kernels each phase launched inside
its range.

The bridge times its phases with sequential perf_counter marks rather
than nested ``with`` blocks, so the annotator mirrors that shape: a
``phase(name)`` call closes the previous range and opens the next, and
``close()`` ends the last one. Annotation is active only while a cycle
tracer has tracing on (hooks.CURRENT set); when off, every call is a
single flag check.
"""

from __future__ import annotations

from kueue_tpu_torch.obs import hooks

PREFIX = "kueue_tpu_torch.oracle."


class PhaseAnnotator:
    """Sequential phase ranges for the oracle bridge's cycle."""

    __slots__ = ("_cur", "_enabled")

    def __init__(self) -> None:
        # Latched at cycle start: a tracer that detaches mid-cycle must
        # not leave a dangling open range.
        self._enabled = hooks.CURRENT is not None
        self._cur = None

    def phase(self, name: str) -> None:
        """End the previous range (if any) and begin ``name``."""
        if not self._enabled:
            return
        import torch

        self._exit()
        self._cur = torch.profiler.record_function(PREFIX + name)
        self._cur.__enter__()

    def close(self) -> None:
        if self._enabled:
            self._exit()

    def _exit(self) -> None:
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None
