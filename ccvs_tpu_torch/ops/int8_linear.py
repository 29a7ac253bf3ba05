"""The int8 decode step's dense product (counterpart of ``_dot_int8`` in
``ccvs_tpu/nn/quantized.py``, an XLA ``dot_general`` there).

:func:`int8_linear` quantizes the rows of x to int8, multiplies them with an
int8 weight exactly in int32, scales the result and adds the bias. On CUDA
tensors it launches kernel K3 (``csrc/int8_linear.cu``) once per 8 rows; on
CPU tensors it runs :func:`int8_linear_plain`, the same function in plain
PyTorch, bit-equal to the kernel.
"""

import torch
import torch.nn.functional as F

from ccvs_tpu_torch.ops import native

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def div127(a):
    """``a / 127`` rounded once, as the JAX package divides. On CUDA a
    division by a Python number is a multiplication by its rounded
    reciprocal, which can be an ulp off; a tensor divisor is divided."""
    return a / torch.full_like(a, 127.0)


def quantize_rows(x):
    """``(B, D)`` -> (int8 ``(B, D)``, per-row fp32 scale ``(B, 1)``):
    ``s = max(max|x|, 1e-8) / 127``, ``round(x / s)`` half to even, clamped
    to [-127, 127]."""
    xf = x.float()
    scale = div127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_matmul(x8, w8):
    """Exact int32 ``x8 @ w8.T`` for int8 ``x8`` ``(B, I)`` and ``w8``
    ``(O, I)``: float64 on the CPU (exact for int8 operands: |sum| <= 127^2 I,
    far below 2^53, where fp32 is not: a 4096-wide sum reaches 6.6e7 > 2^24),
    ``torch._int_mm`` on CUDA (rows padded to 32 where there are fewer than
    17)."""
    if x8.device.type == "cpu":
        return (x8.double() @ w8.double().T).to(torch.int32)
    b = x8.shape[0]
    if b < _INT_MM_MIN_ROWS:
        x8 = F.pad(x8, (0, 0, 0, 32 - b))
    # w8.T is column-major, the layout cuBLASLt's int8 product takes
    return torch._int_mm(x8, w8.T)[:b]


def int8_linear_plain(x, w8, w_scale, bias=None):
    """What K3 computes, in plain PyTorch: x ``(B, I)`` quantized by rows,
    times ``w8`` ``(O, I)`` with scales ``w_scale`` ``(O,)``, plus ``bias``;
    fp32 ``(B, O)``."""
    x8, sx = quantize_rows(x)
    out = int8_matmul(x8, w8).float() * (sx * w_scale[None])
    return out if bias is None else out + bias.float()


def int8_linear(x, w8, w_scale, bias=None):
    """fp32 or bf16 x ``(B, I)`` through the int8 weight ``w8`` ``(O, I)``
    (scales ``w_scale`` fp32 ``(O,)``, optional ``bias`` ``(O,)``) -> fp32
    ``(B, O)``. CPU tensors take :func:`int8_linear_plain`; CUDA tensors
    launch K3 once per 8 rows (counted in ``int8_linear.launches``)."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, w8, w_scale, bias)
    tensors = (x, w8, w_scale) if bias is None else (x, w8, w_scale, bias)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("int8_linear: " + ", ".join(str(t.device) for t in tensors))
    b, inner = x.shape
    n_out = w8.shape[0]
    if (x.dtype not in _DTYPE_CODE or w8.dtype != torch.int8 or w8.shape != (n_out, inner)
            or w_scale.dtype != torch.float32 or w_scale.shape != (n_out,)
            or (bias is not None and (bias.dtype not in _DTYPE_CODE or bias.shape != (n_out,)))
            or inner % 16):
        raise ValueError(f"int8_linear: x {tuple(x.shape)} {x.dtype}, w8 {tuple(w8.shape)} "
                         f"{w8.dtype}, scale {tuple(w_scale.shape)} {w_scale.dtype}, bias "
                         f"{None if bias is None else (tuple(bias.shape), bias.dtype)} "
                         "(x fp32 or bf16, its width a multiple of 16)")
    if not all(t.is_contiguous() for t in tensors) or w8.data_ptr() % 16:
        raise ValueError("int8_linear: inputs must be contiguous, w8 16-byte aligned")
    lib = native.library()
    rows = lib.ccvs_int8_linear_max_rows()
    if rows * inner > 48 * 1024:
        rows = max(1, 48 * 1024 // inner)
    out = torch.empty(b, n_out, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    bias_code = 0 if bias is None else _DTYPE_CODE[bias.dtype]
    for r0 in range(0, b, rows):
        n = min(rows, b - r0)
        err = lib.ccvs_int8_linear(
            x[r0:].data_ptr(), _DTYPE_CODE[x.dtype], w8.data_ptr(), w_scale.data_ptr(),
            bias_ptr, bias_code, out[r0:].data_ptr(), n, inner, n_out, stream)
        int8_linear.launches += 1
        native.check(err, "ccvs_int8_linear")
    return out


int8_linear.launches = 0
