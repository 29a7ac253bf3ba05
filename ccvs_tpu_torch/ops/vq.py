"""Vector-quantization codebook lookup (counterpart of ``ccvs_tpu/ops/vq.py``).

:func:`vq_indices` is the nearest-code search. On a CUDA tensor it launches
kernel K1 (``csrc/vq.cu``, the port of the Pallas kernel
``ccvs_tpu/ops/vq_pallas.py``, on the tensor cores in 3xTF32); on a CPU tensor
it runs :func:`vq_indices_plain`, which computes the same function in plain
PyTorch. :func:`vq_indices_split_plain` mirrors the kernel's split arithmetic
for the tests.

Gradients follow the JAX package's contract (``ccvs_tpu/ops/vq_pallas.py``,
``_indices_nograd``): the indices carry none, so the search reads detached
tensors, and the codebook's gradient comes through the gather
``codebook.index_select(0, idx)`` outside the kernel; ``z``'s through the
straight-through value of :func:`vq_st`.
"""

import torch

from ccvs_tpu_torch.ops import native
from ccvs_tpu_torch.utils import profiling


def vq_indices_plain(z, codebook):
    """``argmin_k (||e_k||^2 - 2 z . e_k)`` in fp32, first index on ties.

    z: ``(N, D)``; codebook: ``(K, D)`` -> ``(N,)`` int32."""
    zf = z.float()
    cb = codebook.float()
    d = (cb * cb).sum(1)[None, :] - 2.0 * (zf @ cb.T)
    return d.argmin(1).to(torch.int32)


def _tf32_rna(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def vq_indices_split_plain(z, codebook):
    """K1's arithmetic in plain PyTorch: each fp32 operand split into TF32
    ``hi`` and ``lo``, the dot products as ``hi.hi + hi.lo + lo.hi``
    (3xTF32), then ``argmin_k (||e_k||^2 - 2 acc)`` with the first index on
    ties (the kernel's zero padding of the depth adds nothing). For tests:
    it shows on the CPU that the split keeps the indices of the fp32
    :func:`vq_indices_plain`."""
    zf, cb = z.float(), codebook.float()
    z_hi, c_hi = _tf32_rna(zf), _tf32_rna(cb)
    z_lo, c_lo = _tf32_rna(zf - z_hi), _tf32_rna(cb - c_hi)
    acc = z_hi @ c_hi.T + z_hi @ c_lo.T + z_lo @ c_hi.T
    d = (cb * cb).sum(1)[None, :] - 2.0 * acc
    return d.argmin(1).to(torch.int32)


def vq_indices(z, codebook):
    """Nearest-code indices, z ``(N, D)``, codebook ``(K, D)`` -> ``(N,)``
    int32. CPU tensors take :func:`vq_indices_plain`; CUDA tensors launch K1
    (counted in the tracer's ``k1.launches``): its pre-pass, the tensor-core
    search and the merge of the code splits, with their scratch allocated
    here. Integer indices carry no gradient: both inputs are read detached,
    so a ``z`` or codebook under autograd is neither copied nor traced."""
    z, codebook = z.detach(), codebook.detach()
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return vq_indices_plain(z, codebook)
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"vq_indices: z on {z.device}, codebook on {codebook.device}")
    if (z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]
            or codebook.shape[0] == 0):
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
    dp, kp = lib.ccvs_vq_padded_depth(d), lib.ccvs_vq_padded_codes(k)
    splits = lib.ccvs_vq_splits(n, k)
    # hi and lo halves of z and the codebook (depth zero-padded to dp), ||e||^2
    z_split = torch.empty(2, n, dp, dtype=torch.float32, device=z.device)
    cb_split = torch.empty(2, k, dp, dtype=torch.float32, device=z.device)
    e2 = torch.empty(kp, dtype=torch.float32, device=z.device)
    part_val = torch.empty(splits * n, dtype=torch.float32, device=z.device)
    part_idx = torch.empty(splits * n, dtype=torch.int32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.ccvs_vq_argmin(
        z.data_ptr(), codebook.data_ptr(), z_split.data_ptr(), cb_split.data_ptr(),
        e2.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(), idx.data_ptr(), n, k, d,
        splits, stream)
    profiling.count("k1.launches")
    native.check(err, "ccvs_vq_argmin")
    return idx


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


def vq_st(z, z_q):
    """Straight-through estimator: the value of ``z_q``, the gradient to ``z``."""
    return z + (z_q - z).detach()


def vq_loss(z, z_q, beta=0.25):
    """Codebook and commitment loss (``quantize.py:60-61``):
    ``mean((sg(z_q) - z)^2) + beta * mean((z_q - sg(z))^2)``."""
    return ((z_q.detach() - z) ** 2).mean() + beta * ((z_q - z.detach()) ** 2).mean()


def vq_perplexity(indices, n_e):
    """Codebook-usage perplexity ``exp(-sum p log(p + 1e-10))`` of the
    indices' histogram (``quantize.py:67-68``), fp32."""
    p = torch.bincount(indices.reshape(-1), minlength=n_e).float() / indices.numel()
    return torch.exp(-(p * torch.log(p + 1e-10)).sum())
