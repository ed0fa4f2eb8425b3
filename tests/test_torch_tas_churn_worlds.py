"""The pod-slice-scale TAS engine runs (5,120-node forests: bench.py's
tas_large and tas_churn) at QUARTER size, the port's engine against the
JAX engine and the numbers pinned in
tests/test_torch_tas_engine_worlds.py, in every arm. Exact."""

import pytest

from kueue_tpu_torch.bench import tas_engine_worlds as tw
from test_torch_tas_engine_worlds import check_quarter, jax_kit  # noqa: F401


@pytest.mark.parametrize("name,path,feas", [
    (name, path, feas) for name in ("tas_large", "tas_churn")
    for path, feas in tw.ARMS[name]])
def test_quarter_runs_match_jax(jax_kit, name, path, feas):  # noqa: F811
    check_quarter(jax_kit, name, path, feas)
