"""Single-token cached attention (counterpart of ``ccvs_tpu/ops/attention_pallas.py``).

:func:`flash_decode_attention` launches kernel K2 (``csrc/flash_decode.cu``)
on CUDA tensors and runs :func:`flash_decode_plain`, the same function in
plain PyTorch, on CPU tensors. The position is an int or, as the Pallas
kernel's traced scalar, an int32 tensor of shape ``()`` or ``(1,)`` on q's
device, which the kernel reads at run time: a launch captured in a CUDA graph
then serves every position.
"""

import math

import torch

from ccvs_tpu_torch.ops import native
from ccvs_tpu_torch.utils import profiling

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CLUSTER = 8  # K2's CTAs per (batch, head): each owns L / 8 cache positions


def flash_decode_plain(q, k_cache, v_cache, pos):
    """What the Pallas kernel computes, in fp32 to the end: ``s = K q /
    sqrt(hd)``, positions ``> pos`` masked to -1e9, softmax, ``softmax . V``,
    cast to q's dtype.

    q: ``(B, nh, hd)``; caches ``(B, nh, L, hd)``; ``pos`` an int or an
    integer tensor of one element."""
    hd = q.shape[-1]
    scores = torch.einsum("bhld,bhd->bhl", k_cache.float(), q.float()) * (1.0 / math.sqrt(hd))
    if torch.is_tensor(pos):
        pos = pos.reshape(())
    live = torch.arange(k_cache.shape[2], device=q.device) <= pos
    scores = torch.where(live, scores, torch.full_like(scores, -1e9))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,bhld->bhd", att, v_cache.float()).to(q.dtype)


def flash_decode_split_plain(q, k_cache, v_cache, pos, tile_rows=None):
    """K2's arithmetic in plain PyTorch, for tests: the cache split into 8
    equal parts, each walked in tiles of ``tile_rows`` live rows with the
    online-softmax rescaling, each part reduced to fp32 (max, sum of
    exponentials, unnormalised output), the parts combined as the cluster's
    rank 0 combines them. A part with no live position is (-inf, 0, 0).
    ``tile_rows`` defaults to the kernel's: 16 KB of one row-tile."""
    b, nh, length, hd = k_cache.shape
    tile_rows = tile_rows or 16384 // (hd * k_cache.element_size())
    pos = min(int(pos), length - 1)
    span = length // CLUSTER
    qf = q.float()
    parts = []
    for rank in range(CLUSTER):
        p0 = rank * span
        n_live = max(0, min(span, pos + 1 - p0))
        m = torch.full((b, nh), -math.inf, device=q.device)
        l = torch.zeros(b, nh, device=q.device)
        o = torch.zeros(b, nh, hd, device=q.device)
        for t0 in range(0, n_live, tile_rows):
            rows = slice(p0 + t0, p0 + min(n_live, t0 + tile_rows))
            s = torch.einsum("bhld,bhd->bhl", k_cache[:, :, rows].float(), qf) * (1.0 / math.sqrt(hd))
            m_new = torch.maximum(m, s.amax(-1))  # finite: the tile has a live row
            alpha = torch.exp(m - m_new)  # 0 on the first tile
            e = torch.exp(s - m_new[..., None])
            l = l * alpha + e.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhl,bhld->bhd", e, v_cache[:, :, rows].float())
            m = m_new
        parts.append((m, l, o))
    m_all = torch.stack([p[0] for p in parts])
    m_max = m_all.amax(0)  # finite: part 0 holds position 0
    w = torch.where(m_all == -math.inf, torch.zeros_like(m_all), torch.exp(m_all - m_max))
    l_sum = sum(w[r] * parts[r][1] for r in range(CLUSTER))
    o_sum = sum(w[r][..., None] * parts[r][2] for r in range(CLUSTER))
    return (o_sum / l_sum[..., None]).to(q.dtype)


def _check_pos(pos, length, device):
    """A host int is range-checked; a device tensor is not read back (that
    would synchronise): the kernel clamps it to ``length - 1``."""
    if not torch.is_tensor(pos):
        if not 0 <= pos < length:
            raise ValueError(f"flash_decode_attention: pos={pos} outside [0, {length})")
        return None, int(pos)
    if pos.dtype != torch.int32 or pos.numel() != 1 or pos.ndim > 1 or pos.device != device:
        raise ValueError(f"flash_decode_attention: pos must be an int32 tensor of shape () or "
                         f"(1,) on {device}, got {pos.dtype} {tuple(pos.shape)} on {pos.device}")
    return pos.data_ptr(), 0


def flash_decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a KV cache; ``(B, nh, hd)`` in q's
    dtype. ``pos`` is an int or an int32 tensor of shape ``()`` or ``(1,)``
    on q's device. CPU tensors take :func:`flash_decode_plain`; CUDA tensors
    launch K2 once (counted in the tracer's ``k2.launches``)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda" or k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError(f"flash_decode_attention: q on {q.device}, caches on "
                         f"{k_cache.device} / {v_cache.device}")
    b, nh, hd = q.shape
    length = k_cache.shape[2]
    if (k_cache.shape != (b, nh, length, hd) or v_cache.shape != k_cache.shape
            or not (k_cache.dtype == v_cache.dtype == q.dtype)
            or q.dtype not in _DTYPE_CODE or length % CLUSTER):
        raise ValueError(f"flash_decode_attention: q {tuple(q.shape)} {q.dtype}, caches "
                         f"{tuple(k_cache.shape)} {k_cache.dtype} (L a multiple of {CLUSTER})")
    lib = native.library()
    if hd != lib.ccvs_flash_decode_head_dim():
        raise ValueError(f"flash_decode_attention: hd={hd}, the kernel is built for "
                         f"{lib.ccvs_flash_decode_head_dim()}")
    pos_dev, pos_host = _check_pos(pos, length, q.device)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode_attention: inputs must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ccvs_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_dev, pos_host,
        out.data_ptr(), b * nh, length, hd, 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype], stream)
    profiling.count("k2.launches")
    native.check(err, "ccvs_flash_decode")
    return out

