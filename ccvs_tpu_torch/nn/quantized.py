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
``lax.dot_general``). Here the products, with the quantization of their
activations, the scaling and the bias, are launches of kernel K3
(``ops/int8_linear.py``) on CUDA and its plain version on the CPU, which
accumulates exactly in float64 (fp32 would not be exact: a 4096-wide ``fc2``
sums up to 6.6e7 > 2^24). q, k and v take the same input and are one launch,
which quantizes it once: 4 launches a layer and the head's, where the JAX
package makes 6 products a layer and the head's. The results are the same:
the quantization of an input does not depend on the weight it meets. The
attention of the step is kernel K2, with q cast to the cache's dtype.
"""

import torch
import torch.nn.functional as F

from ccvs_tpu_torch.ops.attention import flash_decode_attention
from ccvs_tpu_torch.ops.int8_linear import Int8Linear, div127, int8_matmul  # noqa: F401
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
    stay in the model. ``"products"`` holds the step's :class:`Int8Linear`
    products over these weights and the model's biases (per layer ``qkv``,
    ``proj``, ``fc1``, ``fc2``; the ``head``), checked once here."""
    layers, products = [], []
    for block in model.core.blocks:
        attn = block.attn
        q = {"attn": {n: _quant_w(getattr(attn, n).weight)
                      for n in ("query", "key", "value", "proj")},
             "mlp": {n: _quant_w(getattr(block, n).weight) for n in ("fc1", "fc2")}}
        layers.append(q)
        qa, qm = q["attn"], q["mlp"]
        qkv = ("query", "key", "value")
        products.append({
            "qkv": Int8Linear([qa[n]["w8"] for n in qkv], [qa[n]["scale"] for n in qkv],
                              [getattr(attn, n).bias for n in qkv]),
            "proj": _product(qa["proj"], attn.proj.bias),
            "fc1": _product(qm["fc1"], block.fc1.bias),
            "fc2": _product(qm["fc2"], block.fc2.bias)})
    head = _quant_w(model.head.weight)
    return {"layers": layers, "head": head,
            "products": {"layers": products, "head": _product(head, None)}}


def _product(qw, bias):
    return Int8Linear([qw["w8"]], [qw["scale"]], [bias])


def _dot_int8_shared(x, product):
    """fp ``(B, I)`` times the weights of ``product`` (an :class:`Int8Linear`,
    one to three weights that take x) -> fp32 ``(B, O)``, or ``(S, B, O)``
    for S weights: x quantized once, one K3 launch on CUDA."""
    return product(x)


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
    products = qparams["products"]
    for layer, (block, p) in enumerate(zip(model.core.blocks, products["layers"])):
        ck, cv = cache[0][layer], cache[1][layer]
        h = _ln(x, block.ln1.weight, block.ln1.bias)
        q1, k1, v1 = _dot_int8_shared(h, p["qkv"]).unbind(0)
        ck[:, :, at] = k1.reshape(b, nh, 1, hd).to(ck.dtype)
        cv[:, :, at] = v1.reshape(b, nh, 1, hd).to(cv.dtype)
        y = flash_decode_attention(q1.reshape(b, nh, hd).to(ck.dtype), ck, cv, pos)
        x = x + _dot_int8_shared(y.reshape(b, cfg.n_embd), p["proj"])
        h = _ln(x, block.ln2.weight, block.ln2.bias)
        h = F.gelu(_dot_int8_shared(h, p["fc1"]))
        x = x + _dot_int8_shared(h, p["fc2"])
    xn = _ln(x, model.core.ln_f.weight, model.core.ln_f.bias)
    return _dot_int8_shared(xn, products["head"]).to(model.dtype)
