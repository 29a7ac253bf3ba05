"""int8 weights and activations in the cached decode step (counterpart of
``ccvs_tpu/nn/quantized.py``), behind ``TransformerConfig.serve_int8``.

The scheme is the JAX package's:

- weights: symmetric per-output-channel int8, ``w8 = round(w / s_w)`` with
  ``s_w = max|w| / 127`` per output channel, quantized once per ``generate``;
- activations: symmetric per-row int8, quantized at every product;
- products accumulated exactly in int32, scaled by ``s_x * s_w`` in fp32, the
  bias added in fp32; the residual stream and the LayerNorms in fp32.

Rounding is half to even in both packages (``torch.round``, ``jnp.round``),
so ``w8`` is bit-equal to the JAX package's. Weights are kept ``(out, in)``
like ``nn.Linear``'s (the JAX package's are ``(in, out)``).

The int8 product is not a Pallas kernel in the JAX package (a
``lax.dot_general``). Here each product, with the quantization of its
activations, the scaling and the bias, is one launch of kernel K3
(``ops/int8_linear.py``) on CUDA and its plain version on the CPU, which
accumulates exactly in float64 (fp32 would not be exact: a 4096-wide ``fc2``
sums up to 6.6e7 > 2^24). The attention of the step is kernel K2, with q
cast to the cache's dtype.
"""

import torch
import torch.nn.functional as F

from ccvs_tpu_torch.ops.attention import flash_decode_attention
from ccvs_tpu_torch.ops.int8_linear import div127, int8_linear, int8_matmul  # noqa: F401
from ccvs_tpu_torch.ops.int8_linear import quantize_rows as _quant_x  # noqa: F401


def _quant_w(w):
    """``(out, in)`` weight -> ``{"w8": int8 (out, in), "scale": fp32 (out,)}``."""
    w = w.float()
    scale = div127(w.abs().amax(dim=-1).clamp_min(1e-8))
    w8 = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return {"w8": w8.contiguous(), "scale": scale}


@torch.no_grad()
def quantize_gpt_int8(model):
    """Quantize the decode step's dense weights of ``model`` (a ``GPT``):
    per layer ``attn`` (``query``, ``key``, ``value``, ``proj``) and ``mlp``
    (``fc1``, ``fc2``), and the ``head``. Biases, LayerNorms and embeddings
    stay in the model."""
    layers = []
    for block in model.core.blocks:
        layers.append({
            "attn": {n: _quant_w(getattr(block.attn, n).weight)
                     for n in ("query", "key", "value", "proj")},
            "mlp": {n: _quant_w(getattr(block, n).weight) for n in ("fc1", "fc2")},
        })
    return {"layers": layers, "head": _quant_w(model.head.weight)}


def _dot_int8(x, qw, bias=None):
    """fp ``(B, I)`` times a quantized weight -> fp32 ``(B, O)`` (K3 on CUDA)."""
    return int8_linear(x, qw["w8"], qw["scale"], bias)


def _ln(x, weight, bias, eps=1e-5):
    """LayerNorm in fp32 (eps 1e-5), in the JAX package's order of operations:
    its output is rounded to int8 next, where one ulp can move a step."""
    xf = x.float()
    d = xf - xf.mean(-1, keepdim=True)
    xn = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    return xn * weight.float() + bias.float()


def decode_step_fn_int8(model, qparams, emb1, pos, cache):
    """int8 counterpart of :func:`ccvs_tpu_torch.nn.gpt.decode_step_fn`: the
    same cache layout and in-place write at ``pos`` (an int, or an int32
    tensor of shape ``(1,)`` on the device), logits ``(B, V)`` in the model's
    dtype."""
    cfg = model.cfg
    nh, hd = cfg.n_head, cfg.n_embd // cfg.n_head
    b = emb1.shape[0]
    at = pos if torch.is_tensor(pos) else slice(pos, pos + 1)
    x = emb1[:, 0].float()
    for layer, (block, q) in enumerate(zip(model.core.blocks, qparams["layers"])):
        ck, cv = cache[0][layer], cache[1][layer]
        attn, qa, qm = block.attn, q["attn"], q["mlp"]
        h = _ln(x, block.ln1.weight, block.ln1.bias)
        q1 = _dot_int8(h, qa["query"], attn.query.bias).reshape(b, nh, hd)
        ck[:, :, at] = _dot_int8(h, qa["key"], attn.key.bias).reshape(b, nh, 1, hd).to(ck.dtype)
        cv[:, :, at] = _dot_int8(h, qa["value"], attn.value.bias).reshape(b, nh, 1, hd).to(cv.dtype)
        y = flash_decode_attention(q1.to(ck.dtype), ck, cv, pos)
        x = x + _dot_int8(y.reshape(b, cfg.n_embd), qa["proj"], attn.proj.bias)
        h = _ln(x, block.ln2.weight, block.ln2.bias)
        h = F.gelu(_dot_int8(h, qm["fc1"], block.fc1.bias))
        x = x + _dot_int8(h, qm["fc2"], block.fc2.bias)
    xn = _ln(x, model.core.ln_f.weight, model.core.ln_f.bias)
    return _dot_int8(xn, qparams["head"]).to(model.dtype)
