"""Autoregressive latent transformer with a fixed-shape KV cache
(counterpart of ``ccvs_tpu/nn/gpt.py``), for the plain frame-token stream.

Parameter names follow the flax modules (``tok_emb``, ``s_emb``, ``t_emb``,
``core.blocks.<layer>.{ln1, attn.{query, key, value, proj}, ln2, fc1, fc2}``,
``core.ln_f``, ``head``); the JAX package stacks the blocks along a leading
layer axis, the port keeps one module per layer (see ``weights.py``).
Parameters are held in the model's dtype, except the final LayerNorm's, which
stay fp32 as the JAX package's one-time bf16 cast leaves them.

The KV cache is ``(k, v)`` of ``(n_layer, B, nh, L, hd)`` tensors, written in
place (the JAX package returns updated copies). The single-token attention
of the cached decode step is kernel K2
(:func:`ccvs_tpu_torch.ops.attention.flash_decode_attention`). The decode
step takes its position as an int32 tensor of shape ``(1,)`` on the device, as
the JAX package's takes a traced scalar: the cache write and K2 read it there,
so the host never names the position to the device.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccvs_tpu_torch.ops.attention import flash_decode_attention

@dataclass(frozen=True)
class Schedule:
    """Static layout of the token sequence: per position its spatial index
    (into ``s_emb``) and temporal index (into ``t_emb``). The JAX package's
    schedule also interleaves state tokens; the frame-only stream needs none."""

    s_idx: np.ndarray
    t_idx: np.ndarray

    @property
    def length(self) -> int:
        return len(self.s_idx)


def build_schedule(cfg, n_frames):
    """Layout of ``n_frames`` frames of ``cfg.size`` tokens."""
    return Schedule(s_idx=np.tile(np.arange(cfg.size, dtype=np.int32), n_frames),
                    t_idx=np.repeat(np.arange(n_frames, dtype=np.int32), cfg.size))


def _infer_schedule(cfg, n_frame_tokens):
    """Schedule of a ``n_frame_tokens``-token stream (last frame possibly cut)."""
    full = build_schedule(cfg, -(-n_frame_tokens // cfg.size))
    return Schedule(s_idx=full.s_idx[:n_frame_tokens], t_idx=full.t_idx[:n_frame_tokens])


def _dense(layer, x):
    # F.linear, not the module's call, which costs more host time: the
    # per-token decode loop is bound by the host
    return F.linear(x, layer.weight, layer.bias)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and returned in ``dtype`` (flax's
    ``LayerNorm(dtype=...)``), eps 1e-5; parameters in ``param_dtype``
    (default ``dtype``)."""

    def __init__(self, dim, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype or dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype or dtype))
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), 1e-5)
        return y.to(self.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        c = cfg.n_embd
        self.query, self.key, self.value, self.proj = (nn.Linear(c, c, dtype=dtype)
                                                       for _ in range(4))
        self.n_head, self.dtype = cfg.n_head, dtype

    def forward(self, x, cache=None, index=0):
        """x ``(B, t, C)``. With ``cache`` ``(ck, cv)`` of ``(B, nh, L, hd)``,
        the new keys and values are written at ``index`` (in place) and the
        queries attend to cache positions ``<= index + their offset``.
        ``index`` is an int, or for one token (``t == 1``) an int32 tensor of
        shape ``(1,)`` on the cache's device."""
        b, t, c = x.shape
        nh, hd, dt = self.n_head, c // self.n_head, self.dtype
        q = _dense(self.query, x).reshape(b, t, nh, hd)
        k = _dense(self.key, x).reshape(b, t, nh, hd)
        v = _dense(self.value, x).reshape(b, t, nh, hd)
        scale = 1.0 / math.sqrt(hd)
        if cache is not None:
            ck, cv = cache
            at = index if torch.is_tensor(index) else slice(index, index + t)
            ck[:, :, at] = k.transpose(1, 2).to(ck.dtype)
            cv[:, :, at] = v.transpose(1, 2).to(cv.dtype)
            if t == 1:
                y = flash_decode_attention(q[:, 0], ck, cv, index)[:, None]
            else:
                att = torch.einsum("bqhd,bhld->bhql", q, ck.to(dt)) * scale
                pos_q = index + torch.arange(t, device=x.device)[:, None]
                live = torch.arange(ck.shape[2], device=x.device)[None, :] <= pos_q
                att = att.masked_fill(~live, -1e9)
                att = torch.softmax(att.float(), dim=-1).to(dt)
                y = torch.einsum("bhql,bhld->bqhd", att, cv.to(dt))
        else:
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~causal, -1e9)
            att = torch.softmax(att.float(), dim=-1).to(dt)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return _dense(self.proj, y.reshape(b, t, c))


class Block(nn.Module):
    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(cfg.n_embd, dtype)
        self.attn = CausalSelfAttention(cfg, dtype)
        self.ln2 = LayerNorm(cfg.n_embd, dtype)
        self.fc1 = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, dtype=dtype)
        self.fc2 = nn.Linear(4 * cfg.n_embd, cfg.n_embd, dtype=dtype)

    def forward(self, x, cache=None, index=0):
        x = x + self.attn(self.ln1(x), cache=cache, index=index)
        return x + _dense(self.fc2, F.gelu(_dense(self.fc1, self.ln2(x))))


class GPTCore(nn.Module):
    """The blocks and the final LayerNorm."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, dtype) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, dtype, param_dtype=torch.float32)

    def forward(self, emb, cache=None, index=0):
        x = emb
        for layer, block in enumerate(self.blocks):
            x = block(x, None if cache is None else (cache[0][layer], cache[1][layer]), index)
        return self.ln_f(x)


def cache_to_layers(cache):
    """Stacked ``(n_layer, ...)`` cache -> tuples of per-layer views."""
    ck, cv = cache
    return tuple(ck[i] for i in range(ck.shape[0])), tuple(cv[i] for i in range(cv.shape[0]))


def decode_step_fn(model, emb1, pos, cache):
    """One cached decode step: ``emb1`` ``(B, 1, D)`` at absolute position
    ``pos`` -> logits ``(B, V)``. ``pos`` is an int32 tensor of shape ``(1,)``
    on the device (the serving loop's), or an int; every layer's cache write
    and K2 read it. The final LayerNorm runs in fp32 (its parameters are fp32
    in a bf16 model too), the head in the model's dtype."""
    x = emb1
    for layer, block in enumerate(model.core.blocks):
        x = block(x, (cache[0][layer], cache[1][layer]), pos)
    ln = model.core.ln_f
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + 1e-5) * ln.weight.float() + ln.bias.float()
    return _dense(model.head, xn.to(model.dtype))[:, 0]


class GPT(nn.Module):
    """Discrete-token GPT over the frame-token stream, with ``emb_mode="temporal"``
    positional embeddings (spatial ``s_emb`` + temporal ``t_emb``)."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.tok_emb = nn.Embedding(cfg.z_num, cfg.n_embd, dtype=dtype)
        self.s_emb = nn.Parameter(torch.zeros(1, cfg.size, cfg.n_embd, dtype=dtype))
        self.t_emb = nn.Parameter(torch.zeros(1, cfg.num_blocks, cfg.n_embd, dtype=dtype))
        self.core = GPTCore(cfg, dtype)
        self.head = nn.Linear(cfg.n_embd, cfg.z_num, bias=False, dtype=dtype)

    def reset_parameters(self, generator):
        """Seeded init: linear and embedding weights N(0, 0.02), biases and
        positional embeddings 0, LayerNorms 1 and 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()

    def _frame_pos_emb(self, s_idx, t_idx):
        return self.s_emb[0][s_idx] + self.t_emb[0][t_idx]

    def _tok(self, tokens):
        return F.embedding(tokens, self.tok_emb.weight)

    def forward(self, code, sched=None):
        """Full causal forward over frame tokens ``code`` ``(B, n)`` -> logits
        ``(B, n, V)``."""
        if sched is None:
            sched = _infer_schedule(self.cfg, code.shape[1])
        dev = code.device
        pe = self._frame_pos_emb(torch.as_tensor(sched.s_idx, device=dev).long(),
                                 torch.as_tensor(sched.t_idx, device=dev).long())
        x = self.core(self._tok(code) + pe[None])
        return self.head_apply(x)

    def init_cache(self, b, max_len, dtype=None):
        """Zero cache, its length rounded up to a multiple of 128."""
        cfg = self.cfg
        max_len = -(-max_len // 128) * 128
        shape = (cfg.n_layer, b, cfg.n_head, max_len, cfg.n_embd // cfg.n_head)
        dev = self.head.weight.device
        return (torch.zeros(shape, dtype=dtype or self.dtype, device=dev),
                torch.zeros(shape, dtype=dtype or self.dtype, device=dev))

    def prefill(self, emb, cache):
        """Run the whole (placeholder-padded) sequence once, filling the cache."""
        return self.head_apply(self.core(emb, cache=cache, index=0)), cache

    def decode_step(self, emb1, pos, cache):
        return decode_step_fn(self, emb1, pos, cache), cache

    def head_apply(self, x):
        return _dense(self.head, x)

    def embed_one(self, token, s_idx, t_idx):
        """Embedding of frame token(s) at schedule attributes: one position
        (ints, ``token`` ``(B,)``) or a whole buffer (index tensors ``(L,)``,
        ``token`` ``(B, L)``)."""
        return self._tok(token.clamp_max(self.cfg.z_num - 1)) + self._frame_pos_emb(s_idx, t_idx)
