"""Single-token cached attention (counterpart of ``ccvs_tpu/ops/attention_pallas.py``).

:func:`flash_decode_attention` launches kernel K2 (``csrc/flash_decode.cu``)
on CUDA tensors and runs :func:`flash_decode_plain`, the same function in
plain PyTorch, on CPU tensors.
"""

import math

import torch

from ccvs_tpu_torch.ops import native

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_plain(q, k_cache, v_cache, pos):
    """What the Pallas kernel computes, in fp32 to the end: ``s = K q /
    sqrt(hd)``, positions ``> pos`` masked to -1e9, softmax, ``softmax . V``,
    cast to q's dtype.

    q: ``(B, nh, hd)``; caches ``(B, nh, L, hd)``; ``pos`` an int."""
    hd = q.shape[-1]
    scores = torch.einsum("bhld,bhd->bhl", k_cache.float(), q.float()) * (1.0 / math.sqrt(hd))
    live = torch.arange(k_cache.shape[2], device=q.device) <= pos
    scores = torch.where(live, scores, torch.full_like(scores, -1e9))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,bhld->bhd", att, v_cache.float()).to(q.dtype)


def flash_decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a KV cache; ``(B, nh, hd)`` in q's
    dtype. CPU tensors take :func:`flash_decode_plain`; CUDA tensors launch
    K2 (counted in ``flash_decode_attention.launches``)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda" or k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError(f"flash_decode_attention: q on {q.device}, caches on "
                         f"{k_cache.device} / {v_cache.device}")
    b, nh, hd = q.shape
    length = k_cache.shape[2]
    if (k_cache.shape != (b, nh, length, hd) or v_cache.shape != k_cache.shape
            or not (k_cache.dtype == v_cache.dtype == q.dtype)
            or q.dtype not in _DTYPE_CODE):
        raise ValueError(f"flash_decode_attention: q {tuple(q.shape)} {q.dtype}, "
                         f"caches {tuple(k_cache.shape)} {k_cache.dtype}")
    lib = native.library()
    if hd != lib.ccvs_flash_decode_head_dim() or not 0 <= pos < length:
        raise ValueError(f"flash_decode_attention: hd={hd} (the kernel is built for "
                         f"{lib.ccvs_flash_decode_head_dim()}), pos={pos}, L={length}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode_attention: inputs must be contiguous and 16-byte aligned")
    n_chunks = pos // lib.ccvs_flash_decode_chunk() + 1
    part = torch.empty(b * nh * n_chunks * (hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ccvs_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), part.data_ptr(),
        out.data_ptr(), b * nh, length, hd, int(pos), 1.0 / math.sqrt(hd),
        _DTYPE_CODE[q.dtype], stream)
    flash_decode_attention.launches += 1
    native.check(err, "ccvs_flash_decode")
    return out


flash_decode_attention.launches = 0
