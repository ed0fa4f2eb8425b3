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
          "kueue_tpu_torch.visibility.dashboard",
          "kueue_tpu_torch.utils.podtemplate",
          "kueue_tpu_torch.utils.limitrange",
          "kueue_tpu_torch.utils.expectations",
          "kueue_tpu_torch.utils.routine",
          "kueue_tpu_torch.webhooks",
          "kueue_tpu_torch.webhooks.validators",
          "kueue_tpu_torch.webhooks.jobwebhooks",
          "kueue_tpu_torch.controllers.jobframework",
          "kueue_tpu_torch.controllers.integrations",
          "kueue_tpu_torch.bench.job_worlds",
          "kueue_tpu_torch.config.api",
          "kueue_tpu_torch.controllers.podsready",
          "kueue_tpu_torch.controllers.status",
          "kueue_tpu_torch.controllers.booster",
          "kueue_tpu_torch.controllers.concurrentadmission",
          "kueue_tpu_torch.controllers.importer",
          "kueue_tpu_torch.controllers.populator",
          "kueue_tpu_torch.controllers.failurerecovery",
          "kueue_tpu_torch.bench.controller_worlds",
          "kueue_tpu_torch.controllers.multikueue",
          "kueue_tpu_torch.controllers.multikueue_cluster",
          "kueue_tpu_torch.controllers.multikueue_adapters",
          "kueue_tpu_torch.federation",
          "kueue_tpu_torch.federation.cells",
          "kueue_tpu_torch.federation.dispatcher",
          "kueue_tpu_torch.federation.aggregator",
          "kueue_tpu_torch.bench.multikueue_worlds",
          "kueue_tpu_torch.bench.federation_world",
          "kueue_tpu_torch.utils.parallelize",
          "kueue_tpu_torch.utils.cert",
          "kueue_tpu_torch.client",
          "kueue_tpu_torch.client.listers",
          "kueue_tpu_torch.client.informers",
          "kueue_tpu_torch.client.clientset",
          "kueue_tpu_torch.client.applyconfigurations",
          "kueue_tpu_torch.client.http_client",
          "kueue_tpu_torch.cli.kueuectl",
          "kueue_tpu_torch.bench.client_worlds"):
    assert m in sys.modules, m
print("isolated")
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


_RUN_PROBE = """
import sys
from kueue_tpu_torch.bench import controller_worlds as cw
from kueue_tpu_torch.bench import engine_worlds as ew
config = dict(n_cohorts=2, cqs_per_cohort=5, n_entries=200,
              imported_per_cq=1, unlabelled=2, cycles=2, arm="full")
r = cw.run(config, kit=ew.port_kit("cpu"))
assert r["cycles"] == 2 and r["imported"] > 0, r
from kueue_tpu_torch.bench import multikueue_worlds as mw
r = mw.run(dict(mw.SMALL["multikueue_world"], n_cohorts=2, n_entries=200,
                cycles=2, lost_at=1, delete_at=2), kit=ew.port_kit("cpu"))
assert r["manager"]["cycles"] == 2 and r["dispatched"] > 0, r["manager"]
import tempfile
from kueue_tpu_torch.bench import client_worlds as clw
with tempfile.TemporaryDirectory() as work:
    r = clw.run(dict(clw.SMALL["client_world"], n_workloads=600, cycles=6),
                kit=ew.port_kit("cpu"), work=work, device="cpu")
assert r["replay"]["rc"] == 0 and r["cqs_fanned"] > 0, r["replay"]
bad = sorted(m for m in sys.modules
             if m in ("jax", "kueue_tpu") or m.startswith(("jax.", "kueue_tpu.")))
assert not bad, bad
print("isolated")
"""


def test_port_world_runs_without_the_jax_package():
    """Driving a world (phase 32's, 33's and 35's, at a tiny size on
    the CPU) loads neither JAX nor the JAX package: a module found by
    name at run time would escape the import probe above."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _RUN_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
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
