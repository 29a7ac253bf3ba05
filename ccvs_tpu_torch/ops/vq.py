"""Vector-quantization codebook lookup (counterpart of ``ccvs_tpu/ops/vq.py``).

:func:`vq_indices` is the nearest-code search. On a CUDA tensor it launches
kernel K1 (``csrc/vq.cu``, the port of the Pallas kernel
``ccvs_tpu/ops/vq_pallas.py``); on a CPU tensor it runs
:func:`vq_indices_plain`, which computes the same function in plain PyTorch.
"""

import torch

from ccvs_tpu_torch.ops import native


def vq_indices_plain(z, codebook):
    """``argmin_k (||e_k||^2 - 2 z . e_k)`` in fp32, first index on ties.

    z: ``(N, D)``; codebook: ``(K, D)`` -> ``(N,)`` int32."""
    zf = z.float()
    cb = codebook.float()
    d = (cb * cb).sum(1)[None, :] - 2.0 * (zf @ cb.T)
    return d.argmin(1).to(torch.int32)


def vq_indices(z, codebook):
    """Nearest-code indices, z ``(N, D)``, codebook ``(K, D)`` -> ``(N,)``
    int32. CPU tensors take :func:`vq_indices_plain`; CUDA tensors launch K1
    (counted in ``vq_indices.launches``)."""
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return vq_indices_plain(z, codebook)
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"vq_indices: z on {z.device}, codebook on {codebook.device}")
    if z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"vq_indices: shapes {tuple(z.shape)} x {tuple(codebook.shape)}")
    n, d = z.shape
    k = codebook.shape[0]
    # the kernel reads fp32 like the Pallas kernel's in-kernel casts
    z = z.float().contiguous()
    codebook = codebook.float().contiguous()
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    if n == 0:
        return idx
    lib = native.library()
    splits = lib.ccvs_vq_splits(n, k)
    part_val = torch.empty(splits * n, dtype=torch.float32, device=z.device)
    part_idx = torch.empty(splits * n, dtype=torch.int32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.ccvs_vq_argmin(
        z.data_ptr(), codebook.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        idx.data_ptr(), n, k, d, splits, stream)
    vq_indices.launches += 1
    native.check(err, "ccvs_vq_argmin")
    return idx


vq_indices.launches = 0


def vq_lookup(z, codebook):
    """Nearest-codebook lookup in plain PyTorch (``ccvs_tpu.ops.vq.vq_lookup``).

    Returns ``(z_q, indices)``: ``z_q`` has z's shape and dtype, ``indices``
    (int64) z's leading shape."""
    idx = vq_indices_plain(z.reshape(-1, z.shape[-1]), codebook).long()
    z_q = codebook.index_select(0, idx).to(z.dtype)
    return z_q.reshape(z.shape), idx.reshape(z.shape[:-1])


def vq_lookup_auto(z, codebook):
    """:func:`vq_lookup` through :func:`vq_indices` (kernel K1 on CUDA). The
    gather ``z_q = codebook[idx]`` stays outside the kernel, as in the JAX
    package."""
    idx = vq_indices(z.reshape(-1, z.shape[-1]), codebook).long()
    z_q = codebook.index_select(0, idx).to(z.dtype)
    return z_q.reshape(z.shape), idx.reshape(z.shape[:-1])


def vq_embed(indices, codebook, mult=1):
    """Indices -> embeddings; with ``mult > 1`` consecutive positions along the
    second-to-last axis fold into the channel axis (``quantize.py:76-83``)."""
    z = codebook[indices]
    if mult > 1:
        s = list(z.shape)
        s[-1] *= mult
        s[-2] //= mult
        z = z.reshape(s)
    return z
