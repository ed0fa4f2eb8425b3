"""kueue_tpu_torch: the batched admission oracle in PyTorch, for CUDA.

A port of ``kueue_tpu``'s device path (the classical batched drain:
quota derivation, per-ClusterQueue heads, flavor nomination and the
root-grouped commit) to PyTorch tensors on an NVIDIA GPU. The heads
segment-min runs as a hand-written CUDA kernel (``csrc/heads.cu``).

The package mirrors ``kueue_tpu``'s module paths and keeps its own
trimmed copies of the host code it needs (API types, snapshot, tensor
encoding, scenario generation). Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
