"""kueue_tpu_torch: the batched admission oracle in PyTorch, for CUDA.

A port of ``kueue_tpu``'s device path (the batched drain: quota
derivation, per-ClusterQueue heads, flavor nomination, fused classical
preemption and the root-grouped commit, classical or fair-sharing; and
device TAS) to PyTorch tensors on an NVIDIA GPU. The heads segment-min
and the TAS leaf fit counts run as hand-written CUDA kernels
(``csrc/heads.cu``, ``csrc/leaf.cu``).

The package mirrors ``kueue_tpu``'s module paths and keeps its own
trimmed copies of the host code it needs (API types, snapshot, tensor
encoding, scenario generation). Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
