"""Autoregressive latent transformer with a fixed-shape KV cache
(counterpart of ``ccvs_tpu/nn/gpt.py``): the frame-token stream, with state
tokens interleaved (or in front), and the ``[lbl][start][cond]`` prefix of
the class-conditional, unconditional and point-to-point modes.

Parameter names follow the flax modules (``tok_emb``, ``state_tok_emb``,
``start_tok_emb``, ``lbl_emb``, ``s_emb``, ``state_s_emb``, ``t_emb``,
``core.blocks.<layer>.{ln1, attn.{query, key, value, proj}, ln2, fc1, fc2}``,
``core.ln_f``, ``head``); the JAX package stacks the blocks along a leading
layer axis, the port keeps one module per layer (see ``weights.py``).
Parameters are held in ``param_dtype`` and cast to the compute ``dtype`` where
they are used (flax's ``param_dtype`` / ``dtype``): serving holds them in the
compute dtype, so the casts are skipped, except the final LayerNorm's, which
stay fp32 as the JAX package's one-time bf16 cast leaves them; training holds
fp32 master weights under bf16 compute.

In training mode (``module.train()``) attention-probability and residual
dropout (``attn_pdrop``, ``resid_pdrop``) and the MLP's residual noise
(``resid_noise``, scaled by the learnt ``noise_weight``) draw from the
``torch.Generator`` given to :meth:`GPT.forward`. With ``remat``, whenever
gradients are being recorded (the training step runs the GPT in eval mode,
without dropout, as the JAX package's does), each block is recomputed in the
backward pass (``torch.utils.checkpoint``), its random draws replayed from
the generator's state.

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
from torch.utils.checkpoint import checkpoint

from ccvs_tpu_torch.ops.attention import flash_decode_attention

KIND_FRAME = 0
KIND_STATE = 1


@dataclass(frozen=True)
class Schedule:
    """Static layout of the body (frame and state tokens), as numpy arrays:
    per position its ``kind`` (``KIND_FRAME`` or ``KIND_STATE``), spatial
    index ``s_idx`` (into ``s_emb`` or ``state_s_emb``) and temporal index
    ``t_idx`` (into ``t_emb``); ``frame_pos`` and ``state_pos`` are the
    positions of each stream's tokens in order."""

    kind: np.ndarray
    s_idx: np.ndarray
    t_idx: np.ndarray
    frame_pos: np.ndarray
    state_pos: np.ndarray

    @property
    def length(self) -> int:
        return len(self.kind)


def _schedule(kind, s_idx, t_idx):
    kind = np.asarray(kind, np.int32)
    return Schedule(kind=kind, s_idx=np.asarray(s_idx, np.int32),
                    t_idx=np.asarray(t_idx, np.int32),
                    frame_pos=np.nonzero(kind == KIND_FRAME)[0].astype(np.int32),
                    state_pos=np.nonzero(kind == KIND_STATE)[0].astype(np.int32))


def build_schedule(cfg, n_frames, n_state_frames=None):
    """Layout of ``n_frames`` frames: per frame ``state_size`` state tokens,
    then ``size`` frame tokens; with ``state_front`` all state tokens first.
    State tokens come for the first ``n_state_frames`` frames (default: all,
    up to ``num_blocks``)."""
    size, ss = cfg.size, cfg.state_size
    if n_state_frames is None:
        n_state_frames = min(n_frames, cfg.num_blocks) if ss > 0 else 0
    state = [(KIND_STATE, r, f) for f in range(n_state_frames) for r in range(ss)]
    frames = [[(KIND_FRAME, r, f) for r in range(size)] for f in range(n_frames)]
    if ss > 0 and cfg.state_front:
        rows = state + [x for frame in frames for x in frame]
    else:
        rows = []
        for f, frame in enumerate(frames):
            rows += state[f * ss:(f + 1) * ss] + frame
    return _schedule(*zip(*rows)) if rows else _schedule([], [], [])


def _infer_schedule(cfg, n_frame_tokens, n_state_tokens=0):
    """Schedule of a ``n_frame_tokens``-token frame stream (last frame
    possibly cut) beside ``n_state_tokens`` state tokens."""
    ss = cfg.state_size
    n_state_frames = min(n_state_tokens // ss, cfg.num_blocks) if ss > 0 else 0
    full = build_schedule(cfg, -(-n_frame_tokens // cfg.size), n_state_frames)
    # drop the frame positions past the stream's end
    is_frame = full.kind == KIND_FRAME
    keep = ~is_frame | (np.cumsum(is_frame) <= n_frame_tokens)
    return _schedule(full.kind[keep], full.s_idx[keep], full.t_idx[keep])


def _dense(layer, x):
    # F.linear, not the module's call, which costs more host time: the
    # per-token decode loop is bound by the host. Parameters held in another
    # dtype than x's (fp32 master weights) are cast at use.
    w, b = layer.weight, layer.bias
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
        b = None if b is None else b.to(x.dtype)
    return F.linear(x, w, b)


def _dropout(x, p, generator):
    """Inverted dropout (flax's ``Dropout``): each entry kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


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
    def __init__(self, cfg, dtype=torch.float32, param_dtype=None):
        super().__init__()
        c = cfg.n_embd
        self.query, self.key, self.value, self.proj = (
            nn.Linear(c, c, dtype=param_dtype or dtype) for _ in range(4))
        self.n_head, self.dtype = cfg.n_head, dtype
        self.attn_pdrop, self.resid_pdrop = cfg.attn_pdrop, cfg.resid_pdrop

    def forward(self, x, cache=None, index=0, generator=None):
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
            if self.training and self.attn_pdrop > 0:
                att = _dropout(att, self.attn_pdrop, generator)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v)
        y = _dense(self.proj, y.reshape(b, t, c))
        if self.training and self.resid_pdrop > 0:
            y = _dropout(y, self.resid_pdrop, generator)
        return y


class Block(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, param_dtype=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.ln1 = LayerNorm(cfg.n_embd, dtype, pdt)
        self.attn = CausalSelfAttention(cfg, dtype, pdt)
        self.ln2 = LayerNorm(cfg.n_embd, dtype, pdt)
        self.fc1 = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, dtype=pdt)
        self.fc2 = nn.Linear(4 * cfg.n_embd, cfg.n_embd, dtype=pdt)
        self.resid_pdrop, self.resid_noise = cfg.resid_pdrop, cfg.resid_noise
        if cfg.resid_noise:
            self.noise_weight = nn.Parameter(torch.ones(1, dtype=torch.float32))

    def forward(self, x, cache=None, index=0, generator=None):
        x = x + self.attn(self.ln1(x), cache=cache, index=index, generator=generator)
        h = _dense(self.fc1, self.ln2(x))
        if self.training and self.resid_noise:
            # one N(0, 1) draw per (batch, position), broadcast over channels
            noise = torch.randn((*h.shape[:2], 1), generator=generator, device=h.device,
                                dtype=h.dtype)
            h = h + self.noise_weight.to(h.dtype) * noise
        h = _dense(self.fc2, F.gelu(h))
        if self.training and self.resid_pdrop > 0:
            h = _dropout(h, self.resid_pdrop, generator)
        return x + h


class GPTCore(nn.Module):
    """The blocks and the final LayerNorm."""

    def __init__(self, cfg, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(Block(cfg, dtype, param_dtype) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, dtype, param_dtype=torch.float32)

    def forward(self, emb, cache=None, index=0, generator=None):
        x = emb
        remat = self.cfg.remat and torch.is_grad_enabled() and cache is None
        for layer, block in enumerate(self.blocks):
            if remat:
                x = _remat_block(block, x, generator)
            else:
                x = block(x, None if cache is None else (cache[0][layer], cache[1][layer]), index,
                          generator)
        return self.ln_f(x)


def _remat_block(block, x, generator):
    """``block(x)`` whose activations are recomputed in the backward pass.
    The recomputation replays the forward's random draws: it starts from the
    generator's state before the block, and leaves the generator where it
    found it (also when the checkpoint stops it early, once the tensors it
    needs are back), so later draws go on from the forward's end state."""
    if generator is None:
        return checkpoint(block, x, use_reentrant=False)
    start, end = generator.get_state(), []

    def run(x):
        now = generator.get_state()
        generator.set_state(start)
        try:
            y = block(x, generator=generator)
            end.append(generator.get_state())
        finally:
            generator.set_state(now)
        return y

    y = checkpoint(run, x, use_reentrant=False)
    generator.set_state(end[0])
    return y


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
    """Discrete-token GPT with ``emb_mode="temporal"`` positional embeddings
    (spatial ``s_emb`` + temporal ``t_emb``); state tokens have their own
    vocabulary and spatial embedding (``state_tok_emb``, ``state_s_emb``).
    The head spans both vocabularies."""

    def __init__(self, cfg, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, pdt = cfg.n_embd, param_dtype or dtype
        self.tok_emb = nn.Embedding(cfg.z_num, d, dtype=pdt)
        self.has_state = cfg.state_num > 0 and cfg.state_size > 0
        if self.has_state:
            self.state_tok_emb = nn.Embedding(cfg.state_num, d, dtype=pdt)
        if cfg.use_start_token:
            self.start_tok_emb = nn.Parameter(torch.zeros(1, d, dtype=pdt))
        if cfg.cat:
            self.lbl_emb = nn.Embedding(cfg.num_lbl, d, dtype=pdt)
        self.s_emb = nn.Parameter(torch.zeros(1, cfg.size, d, dtype=pdt))
        self.t_emb = nn.Parameter(torch.zeros(1, cfg.num_blocks, d, dtype=pdt))
        if cfg.state_size > 0:
            self.state_s_emb = nn.Parameter(torch.zeros(1, cfg.state_size, d, dtype=pdt))
        self.core = GPTCore(cfg, dtype, param_dtype)
        self.head = nn.Linear(d, max(cfg.z_num, cfg.state_num), bias=False, dtype=pdt)

    def reset_parameters(self, generator):
        """Seeded init: linear and embedding weights N(0, 0.02), the start
        token N(0, 1), biases and positional embeddings 0, LayerNorms 1 and 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
            if self.cfg.use_start_token:
                self.start_tok_emb.normal_(0.0, 1.0, generator=generator)

    # ---------------- embeddings ----------------

    def _c(self, x):
        """``x`` in the compute dtype (a no-op where the parameters are held in it)."""
        return x if x.dtype == self.dtype else x.to(self.dtype)

    def _frame_pos_emb(self, s_idx, t_idx, delta=None):
        """Frame-token positional embedding; ``delta`` ``(B,)`` shifts the
        temporal index per batch element (then ``(B, L, D)``)."""
        t = t_idx if delta is None else t_idx[None, :] + delta[:, None]
        return self._c(self.s_emb[0][s_idx] + self.t_emb[0][t])

    def _state_pos_emb(self, s_idx, t_idx):
        if torch.is_tensor(s_idx):
            # a buffer's frame positions have spatial indices past the state's;
            # their state embedding is computed and discarded
            s_idx = s_idx.clamp_max(self.cfg.state_size - 1)
        return self._c(self.state_s_emb[0][s_idx] + self.t_emb[0][t_idx])

    def _tok(self, tokens):
        return self._c(F.embedding(tokens, self.tok_emb.weight))

    def _state_tok(self, tokens):
        return self._c(F.embedding(tokens, self.state_tok_emb.weight))

    def _index(self, a):
        return torch.as_tensor(a, device=self.head.weight.device).long()

    def _body_emb(self, code, state_code, sched):
        """Merged body embedding: frame and state tokens interleaved by the
        schedule."""
        n = sched.length
        src = np.zeros(n, np.int64)  # each position's index into its stream
        src[sched.frame_pos] = np.arange(len(sched.frame_pos))
        src[sched.state_pos] = np.arange(len(sched.state_pos))
        s_idx, t_idx = self._index(sched.s_idx), self._index(sched.t_idx)
        frame_tok = code[:, self._index(np.clip(src, 0, code.shape[1] - 1))]
        emb = self._tok(frame_tok) + self._frame_pos_emb(s_idx, t_idx)[None]
        if state_code is not None and len(sched.state_pos) > 0:
            state_tok = state_code[:, self._index(np.clip(src, 0, state_code.shape[1] - 1))]
            se = self._state_tok(state_tok) + self._state_pos_emb(s_idx, t_idx)[None]
            is_state = self._index(sched.kind == KIND_STATE).bool()
            emb = torch.where(is_state[None, :, None], se, emb)
        return emb

    def _cond_emb(self, cond_code, delta=None):
        """Conditioning tokens: frame tokens of frames 0, 1, ... shifted by
        ``delta``."""
        lc = cond_code.shape[1]
        ar = torch.arange(lc, device=cond_code.device)
        pe = self._frame_pos_emb(ar % self.cfg.size, ar // self.cfg.size, delta)
        return self._tok(cond_code) + (pe[None] if delta is None else pe)

    def _prefix_emb(self, b, cond_code=None, delta=None, lbl=None):
        """The ``[lbl][start][cond]`` prefix ``(B, P, D)``, or None; the label
        ``lbl`` ``(B,)`` leads it in the class-conditional mode."""
        parts = []
        if self.cfg.cat and lbl is not None:
            parts.append(self._c(F.embedding(lbl, self.lbl_emb.weight))[:, None])
        if self.cfg.use_start_token:
            parts.append(self._c(self.start_tok_emb)[None].expand(b, 1, -1))
        if cond_code is not None and cond_code.shape[1] > 0:
            parts.append(self._cond_emb(cond_code, delta))
        return torch.cat(parts, dim=1) if parts else None

    def prefix_len(self, cond_code=None, lbl=None):
        return (int(self.cfg.cat and lbl is not None) + int(self.cfg.use_start_token)
                + (0 if cond_code is None else cond_code.shape[1]))

    def forward(self, code, state_code=None, cond_code=None, delta=None, lbl=None, sched=None,
                generator=None):
        """Full causal forward over the prefix and the body of frame tokens
        ``code`` ``(B, n)`` (and state tokens ``state_code``) -> logits from
        the label and start token (where there are) on, ``(B, P' + body, V)``.
        ``generator`` feeds dropout and residual noise in training mode."""
        if sched is None:
            sched = _infer_schedule(self.cfg, code.shape[1],
                                    0 if state_code is None else state_code.shape[1])
        emb = self._body_emb(code, state_code, sched)
        prefix = self._prefix_emb(code.shape[0], cond_code, delta, lbl)
        if prefix is not None:
            emb = torch.cat([prefix, emb], dim=1)
        t_cond = 0 if cond_code is None else cond_code.shape[1]
        return self.head_apply(self.core(emb, generator=generator))[:, t_cond:]

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

    def embed_one(self, token, s_idx, t_idx, kind=KIND_FRAME):
        """Embedding of body token(s) at schedule attributes: one position
        (``s_idx``, ``t_idx`` ints, ``token`` ``(B,)``) or a whole buffer
        (index arrays or tensors ``(L,)``, ``token`` ``(B, L)``). ``kind`` is
        one kind for every position, or an array ``(L,)`` of kinds. Each
        token is clamped to its stream's vocabulary before the lookup."""
        if not isinstance(s_idx, int):
            s_idx, t_idx = self._index(s_idx), self._index(t_idx)
        cfg = self.cfg

        def frame():
            return self._tok(token.clamp_max(cfg.z_num - 1)) + self._frame_pos_emb(s_idx, t_idx)

        def state():
            return (self._state_tok(token.clamp_max(cfg.state_num - 1))
                    + self._state_pos_emb(s_idx, t_idx))

        if not self.has_state:
            return frame()
        if np.ndim(kind) == 0:  # one kind, known on the host
            return state() if kind == KIND_STATE else frame()
        is_state = self._index(np.asarray(kind) == KIND_STATE).bool()
        return torch.where(is_state[:, None], state(), frame())
