"""Ops of the port (counterpart of ``ccvs_tpu/ops``), NHWC activations.

Two of them run hand-written CUDA kernels on CUDA tensors (``csrc/``):
:func:`ccvs_tpu_torch.ops.vq.vq_indices` (K1) and
:func:`ccvs_tpu_torch.ops.attention.flash_decode_attention` (K2). Everything
else is plain PyTorch, as it is plain XLA in the JAX package.
"""
