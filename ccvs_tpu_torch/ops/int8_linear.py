"""The int8 decode step's dense product (counterpart of ``_dot_int8`` in
``ccvs_tpu/nn/quantized.py``, an XLA ``dot_general`` there).

:class:`Int8Linear` holds one to three int8 weights that take the same
input (the decode step's q, k and v; or one product alone). Called with x, it
quantizes the rows of x to int8 once, multiplies them with each weight exactly
in int32, scales the results and adds the biases. On CUDA tensors that is one
launch of kernel K3 (``csrc/int8_linear.cu``) per 16 rows; on CPU tensors it
is the same function in plain PyTorch, bit-equal to the kernel. Everything
that depends only on the weights is checked once, when the object is built;
a call checks x and launches.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ccvs_tpu_torch.ops import native
from ccvs_tpu_torch.utils import profiling

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEGMENTS = 3


class K3Weights(ctypes.Structure):
    """The weight side of a K3 launch (``struct K3Weights`` in the source)."""
    _fields_ = [("w8", ctypes.c_void_p * 3), ("scale", ctypes.c_void_p * 3),
                ("bias", ctypes.c_void_p * 3), ("bias_dtype", ctypes.c_int),
                ("segments", ctypes.c_int), ("in_features", ctypes.c_int),
                ("n_out", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _kernel():
    """K3's entry point (argtypes declared) and its row limit, read once a
    process."""
    lib = native.library()
    return lib.ccvs_int8_linear, lib.ccvs_int8_linear_max_rows()


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


def _scaled(acc, sx, w_scale, bias):
    out = acc.float() * (sx * w_scale[None])
    return out if bias is None else out + bias.float()


def int8_linear_plain(x, w8, w_scale, bias=None):
    """What K3 computes, in plain PyTorch: x ``(B, I)`` quantized by rows,
    times ``w8`` ``(O, I)`` with scales ``w_scale`` ``(O,)``, plus ``bias``;
    fp32 ``(B, O)``."""
    x8, sx = quantize_rows(x)
    return _scaled(int8_matmul(x8, w8), sx, w_scale, bias)


class Int8Linear:
    """One to three int8 products that take the same input: ``w8s[s]``
    ``(O, I)`` int8 with fp32 scales ``scales[s]`` ``(O,)`` and ``biases[s]``
    ``(O,)`` (fp32, bf16 or None). Calling it with x ``(B, I)`` (fp32 or
    bf16) gives fp32 ``(B, O)`` for one weight and ``(S, B, O)`` for S.

    On CUDA the weights, scales and biases are checked here, once (device,
    dtype, shape, contiguity, 16-byte alignment), and each call checks only x
    and launches K3 once per 16 rows, each launch counted in
    the tracer's ``k3.launches``."""

    def __init__(self, w8s, scales, biases):
        n = len(w8s)
        if not 1 <= n <= MAX_SEGMENTS or len(scales) != n or len(biases) != n:
            raise ValueError(f"Int8Linear: 1-{MAX_SEGMENTS} weights, each with a scale and a "
                             f"bias (or None); got {len(w8s)}, {len(scales)}, {len(biases)}")
        self.w8s, self.scales, self.biases = tuple(w8s), tuple(scales), tuple(biases)
        self.out_features, self.in_features = w8s[0].shape
        self.device = w8s[0].device
        self._args = None
        if self.device.type == "cuda":
            self._check()
            self._args = K3Weights(
                (ctypes.c_void_p * 3)(*[w.data_ptr() for w in w8s]),
                (ctypes.c_void_p * 3)(*[s.data_ptr() for s in scales]),
                (ctypes.c_void_p * 3)(*[None if b is None else b.data_ptr() for b in biases]),
                max([_DTYPE_CODE[b.dtype] for b in biases if b is not None], default=0),
                n, self.in_features, self.out_features)
            self._args_ptr = ctypes.addressof(self._args)
            self._launch, self._max_rows = _kernel()
            # index -> cudaStream_t of PyTorch's current stream on that device
            self._stream = torch._C._cuda_getCurrentRawStream
            self._index = self.device.index

    def _check(self):
        o, i = self.out_features, self.in_features
        if len({b.dtype for b in self.biases if b is not None}) > 1:
            raise ValueError("Int8Linear: biases of one dtype")
        for w8, scale, bias in zip(self.w8s, self.scales, self.biases):
            tensors = (w8, scale) if bias is None else (w8, scale, bias)
            if any(t.device != self.device for t in tensors):
                raise ValueError("Int8Linear: " + ", ".join(str(t.device) for t in tensors))
            if (w8.dtype != torch.int8 or w8.shape != (o, i) or scale.dtype != torch.float32
                    or scale.shape != (o,) or (bias is not None and (
                        bias.dtype not in _DTYPE_CODE or bias.shape != (o,)))
                    or i % 16 or i == 0 or o % 8 or o == 0):
                raise ValueError(
                    f"Int8Linear: w8 {tuple(w8.shape)} {w8.dtype}, scale {tuple(scale.shape)} "
                    f"{scale.dtype}, bias "
                    f"{None if bias is None else (tuple(bias.shape), bias.dtype)} (int8 "
                    f"({o}, {i}) weights, fp32 scales, fp32 or bf16 biases, the width a "
                    "positive multiple of 16, the outputs of 8)")
            if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
                raise ValueError("Int8Linear: weights, scales and biases must be contiguous "
                                 "and 16-byte aligned")

    def plain(self, x):
        """The same products in plain PyTorch (on any device): x quantized
        once, then each weight's product as :func:`int8_linear_plain`."""
        x8, sx = quantize_rows(x)
        outs = [_scaled(int8_matmul(x8, w8), sx, s, b)
                for w8, s, b in zip(self.w8s, self.scales, self.biases)]
        return outs[0] if len(outs) == 1 else torch.stack(outs)

    def __call__(self, x):
        if x.device.type == "cpu":
            return self.plain(x)
        if (self._args is None or x.device != self.device or x.dtype not in _DTYPE_CODE
                or x.dim() != 2 or x.shape[1] != self.in_features or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"Int8Linear: x {tuple(x.shape)} {x.dtype} on {x.device} against "
                             f"weights ({self.out_features}, {self.in_features}) on "
                             f"{self.device} (x contiguous, fp32 or bf16, 16-byte aligned)")
        b, o, n = x.shape[0], self.out_features, len(self.w8s)
        out = torch.empty((b, o) if n == 1 else (n, b, o), dtype=torch.float32, device=x.device)
        stream = self._stream(self._index)
        xp, op, step = x.data_ptr(), out.data_ptr(), self._max_rows
        code, row_bytes = _DTYPE_CODE[x.dtype], self.in_features * x.element_size()
        for r0 in range(0, b, step):
            err = self._launch(self._args_ptr, xp + r0 * row_bytes, code, op + 4 * r0 * o,
                               b * o, min(step, b - r0), stream)
            profiling.count("k3.launches")
            if err:
                native.check(err, "ccvs_int8_linear")
        return out

