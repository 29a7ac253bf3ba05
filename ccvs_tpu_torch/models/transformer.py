"""Latent-token transformer: KV-cached autoregressive generation with the
sliding window (counterpart of the generation part of
``ccvs_tpu/models/transformer.py``), over the frame stream with interleaved
state tokens and the ``[start][cond]`` prefix.

The JAX package scans its per-token decode step as one compiled program
(``_fill_jit``); here it is a Python loop whose tensors stay on the device:
nothing in the loop waits for the GPU. The schedule (each position's kind,
spatial and temporal index, and whether its token is given) is static
numpy, so the loop reads it on the host.
"""

from functools import partial

import numpy as np
import torch
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.gpt import GPT, KIND_STATE, build_schedule, cache_to_layers, decode_step_fn
from ccvs_tpu_torch.nn.quantized import decode_step_fn_int8, quantize_gpt_int8


def _sample_token(cfg, generator, logits, kind):
    """Sample tokens ``(B,)`` of the stream ``kind`` (a host int) from logits
    ``(B, V)``: the stream's temperature and vocabulary mask, its top-k
    threshold read from one ``topk`` of the larger k, then a categorical
    draw, or the argmax where the stream does not sample."""
    is_state = kind == KIND_STATE
    logits = logits.float() / (cfg.temperature_state if is_state else cfg.temperature)
    vocab = logits.shape[-1]
    n_valid = max(cfg.state_num, 1) if is_state else cfg.z_num
    if vocab > n_valid:
        logits = logits.masked_fill(torch.arange(vocab, device=logits.device) >= n_valid,
                                    float("-inf"))
    if cfg.top_k is not None or cfg.top_k_state is not None:
        kmax = min(max(k for k in (cfg.top_k, cfg.top_k_state, 1) if k is not None), vocab)
        k = (cfg.top_k_state or cfg.top_k or 1) if is_state else (cfg.top_k or 1)
        vals = torch.topk(logits, kmax, dim=-1).values
        thresh = vals[:, min(k, kmax) - 1:min(k, kmax)]
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    if not ((cfg.sample_state or cfg.sample) if is_state else cfg.sample):
        return logits.argmax(-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class TokenTransformer(nn.Module):
    def __init__(self, cfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):
            self.model = GPT(cfg, dtype=dtype)

    @property
    def device(self):
        return self.model.head.weight.device

    def init(self, seed=0):
        """Seeded random parameters; returns self."""
        self.model.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        return self

    @torch.no_grad()
    def generate(self, code, generator, state_code=None, cond_code=None, delta=None,
                 total_len=None):
        """Extend the given frame tokens ``code`` ``(B, n0)`` (and state
        tokens ``state_code``) autoregressively: fill one window, then slide
        it a ``z_chunk`` at a time until ``total_len`` tokens of the prefix
        and body are made (default: one window).

        ``cond_code`` ``(B, Lc)`` are the point-to-point prefix's tokens and
        ``delta`` ``(B,)`` their temporal shift, decremented at each slide.
        With ``cfg.serve_int8`` the decode step runs on int8 weights,
        quantized once here.

        Returns ``{"code": (B, n_frame_tokens), "state_code": (B,
        n_state_tokens) or None}``."""
        cfg = self.cfg
        b = code.shape[0]
        step_fn = decode_step_fn
        if cfg.serve_int8:
            step_fn = partial(decode_step_fn_int8, qparams=quantize_gpt_int8(self.model))
        if cfg.state_size > 0 and state_code is None:
            state_code = code.new_zeros(b, 0)
        n_cond = 0 if cond_code is None else cond_code.shape[1]
        cap = cfg.z_len - n_cond
        budget = (cap if total_len is None else total_len - n_cond)
        # in-window capacities of a full window's streams
        cap_sched = self._sched_for(cap)
        f_cap = int((cap_sched.frame_pos < cap).sum())
        s_cap = int((cap_sched.state_pos < cap).sum())

        fill = partial(self._fill, generator, step_fn, cond_code=cond_code)
        first = min(cap, budget)
        new_code, new_state = fill(code, state_code, delta=delta, length=first)
        code = new_code
        if state_code is None or new_state is None or new_state.shape[1] >= state_code.shape[1]:
            state_code = new_state  # sampled states grew; a longer given stream is kept
        cur, i = first, 1
        # the sliding window: drop the oldest frame, re-prefill, decode one chunk
        while cur < budget:
            add = min(cfg.z_chunk, budget - cur)
            if cond_code is not None and delta is not None:
                delta = delta - 1
            tmp_code = code[:, i * cfg.size:]
            tmp_state = None if state_code is None else state_code[:, i * cfg.state_size:]
            tmp_merged = min(tmp_code.shape[1], f_cap) + (
                0 if tmp_state is None else min(tmp_state.shape[1], s_cap))
            new_code, new_state = fill(tmp_code, tmp_state, delta=delta,
                                       length=min(cap, tmp_merged + add))
            code = torch.cat([code, new_code[:, tmp_code.shape[1]:]], dim=1)
            if state_code is not None and new_state.shape[1] > tmp_state.shape[1]:
                state_code = torch.cat([state_code, new_state[:, tmp_state.shape[1]:]], dim=1)
            cur += add
            i += 1
        return {"code": code, "state_code": state_code}

    def _sched_for(self, merged_len):
        """Schedule of enough frames for ``merged_len`` body tokens."""
        cfg = self.cfg
        per = cfg.tot_size if cfg.state_size > 0 else cfg.size
        n_frames = min(-(-merged_len // per), cfg.num_blocks)
        if n_frames * per < merged_len:  # a partial frame past the window's blocks
            n_frames = -(-merged_len // per)
        return build_schedule(cfg, n_frames)

    def _fill(self, generator, step_fn, code, state_code, cond_code, delta, length):
        """Prefill, then one cached decode step per position up to a body of
        ``length`` tokens. Given tokens (the frame stream's first ``n0`` and
        the state stream's) are never overwritten. Returns the frame and
        state streams of the body."""
        model = self.model
        b, n0 = code.shape
        n0_state = 0 if state_code is None else state_code.shape[1]
        if length <= 0:
            return code, state_code
        sched = self._sched_for(length)
        kind, s_idx, t_idx = sched.kind[:length], sched.s_idx[:length], sched.t_idx[:length]
        fpos = sched.frame_pos[sched.frame_pos < length]
        spos = sched.state_pos[sched.state_pos < length]
        dev = code.device
        merged = torch.zeros(b, length, dtype=torch.long, device=dev)
        given = np.zeros(length, bool)  # positions whose tokens are given
        for pos_given, stream in ((fpos[:n0], code), (spos[:n0_state], state_code)):
            if len(pos_given):
                merged[:, torch.as_tensor(pos_given, device=dev).long()] = \
                    stream[:, :len(pos_given)].long()
                given[pos_given] = True
        if given.all():
            return code, state_code
        start = int(np.nonzero(~given)[0][0])

        prefix_len = model.prefix_len(cond_code)
        cache = model.init_cache(b, prefix_len + length)
        emb = model.embed_one(merged, s_idx, t_idx, kind)
        prefix = model._prefix_emb(b, cond_code, delta)
        if prefix is not None:
            emb = torch.cat([prefix, emb], dim=1)
        logits_all, cache = model.prefill(emb, cache)
        cache = cache_to_layers(cache)
        # logits at prefix_len + start - 1 predict body[start] (behind a start
        # token and no context, the start token's; with no prefix and no
        # context, index -1 clamps to 0 as JAX's dynamic index does); later
        # placeholders are causally invisible and overwritten step by step
        logits = logits_all[:, max(prefix_len + start - 1, 0)]
        pos = torch.full((1,), prefix_len + start, dtype=torch.int32, device=dev)
        for j in range(start, length):
            if given[j]:
                tok = merged[:, j]
            else:
                tok = _sample_token(self.cfg, generator, logits, int(kind[j]))
                merged[:, j] = tok
            emb1 = model.embed_one(tok, int(s_idx[j]), int(t_idx[j]), int(kind[j]))[:, None]
            logits = step_fn(model, emb1=emb1, pos=pos, cache=cache)
            pos += 1
        out_state = None if state_code is None else merged[:, torch.as_tensor(spos, device=dev)]
        return merged[:, torch.as_tensor(fpos, device=dev)], out_state
