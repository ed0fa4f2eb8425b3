"""The PyTorch port stands alone: importing every module of
kueue_tpu_torch and chip_smoke.py loads neither JAX nor the JAX package
(kueue_tpu, kueue_tpu.*), and its entry points default to CUDA, raising
when CUDA is absent and the CPU was not asked for."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kueue_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import pkgutil, sys
import kueue_tpu_torch
for m in pkgutil.walk_packages(kueue_tpu_torch.__path__, "kueue_tpu_torch."):
    __import__(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "kueue_tpu") or m.startswith(("jax.", "kueue_tpu.")))
assert not bad, bad
for m in ("kueue_tpu_torch.oracle.batched",
          "kueue_tpu_torch.metrics.registry",
          "kueue_tpu_torch.cache.unadmitted",
          "kueue_tpu_torch.controllers.colapply",
          "kueue_tpu_torch.controllers.tas_nodes",
          "kueue_tpu_torch.tas.non_tas_usage",
          "kueue_tpu_torch.tas.ungater",
          "kueue_tpu_torch.tas.balanced",
          "kueue_tpu_torch.store.checkpoint",
          "kueue_tpu_torch.store.diskguard",
          "kueue_tpu_torch.ha.digest",
          "kueue_tpu_torch.ha.shedder",
          "kueue_tpu_torch.ha.ladder",
          "kueue_tpu_torch.utils.cel",
          "kueue_tpu_torch.utils.structlog",
          "kueue_tpu_torch.controllers.dra",
          "kueue_tpu_torch.obs",
          "kueue_tpu_torch.obs.hooks",
          "kueue_tpu_torch.obs.span",
          "kueue_tpu_torch.obs.tracer",
          "kueue_tpu_torch.obs.perf",
          "kueue_tpu_torch.obs.device",
          "kueue_tpu_torch.obs.slo",
          "kueue_tpu_torch.obs.watchdog",
          "kueue_tpu_torch.obs.explain",
          "kueue_tpu_torch.obs.perfetto",
          "kueue_tpu_torch.replay",
          "kueue_tpu_torch.replay.trace",
          "kueue_tpu_torch.replay.recorder",
          "kueue_tpu_torch.replay.replayer",
          "kueue_tpu_torch.replay.faults",
          "kueue_tpu_torch.bench.replay_world",
          "kueue_tpu_torch.visibility.fanout",
          "kueue_tpu_torch.visibility.flowcontrol",
          "kueue_tpu_torch.ha",
          "kueue_tpu_torch.ha.roles",
          "kueue_tpu_torch.ha.lease",
          "kueue_tpu_torch.ha.tailer",
          "kueue_tpu_torch.ha.replica",
          "kueue_tpu_torch.utils.leaderelection",
          "kueue_tpu_torch.readplane",
          "kueue_tpu_torch.readplane.queries",
          "kueue_tpu_torch.readplane.replica",
          "kueue_tpu_torch.readplane.frontend",
          "kueue_tpu_torch.visibility.dashboard"):
    assert m in sys.modules, m
print("isolated")
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
