"""Ops of the port (counterpart of ``ccvs_tpu/ops``), NHWC activations.

Three of them run hand-written CUDA kernels on CUDA tensors (``csrc/``):
:func:`ccvs_tpu_torch.ops.vq.vq_indices` (K1),
:func:`ccvs_tpu_torch.ops.attention.flash_decode_attention` (K2) and
:class:`ccvs_tpu_torch.ops.int8_linear.Int8Linear` (K3, the int8 decode
step's products, one launch for those that share an input). Everything else is plain PyTorch, as it is plain XLA in the
JAX package.
"""
