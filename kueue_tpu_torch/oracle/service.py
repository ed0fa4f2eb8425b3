"""The oracle's executor in the port: the two device programs a
scheduling cycle needs, behind the interface of the JAX package's
``oracle/service.LocalExecutor``. There is no server and no remote
executor yet.
"""

from __future__ import annotations

import numpy as np
import torch

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
