"""Latent-token transformer: KV-cached autoregressive generation
(counterpart of the generation part of ``ccvs_tpu/models/transformer.py``),
for the plain frame-token stream within one window.

The JAX package scans its per-token decode step as one compiled program
(``_fill_jit``); here it is a Python loop whose tensors stay on the device:
nothing in the loop waits for the GPU.
"""

import torch
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.gpt import GPT, build_schedule, cache_to_layers, decode_step_fn


def _sample_token(cfg, generator, logits):
    """Sample frame tokens ``(B,)`` from logits ``(B, V)``: temperature,
    vocabulary mask, top-k, then a categorical draw (or argmax when
    ``cfg.sample`` is off)."""
    logits = logits.float() / cfg.temperature
    vocab = logits.shape[-1]
    if vocab > cfg.z_num:
        logits = logits.masked_fill(torch.arange(vocab, device=logits.device) >= cfg.z_num,
                                    float("-inf"))
    if cfg.top_k is not None:
        thresh = torch.topk(logits, min(cfg.top_k, vocab), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    if not cfg.sample:
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
    def generate(self, code, generator, total_len=None):
        """Extend the context tokens ``code`` ``(B, n0)`` to ``total_len``
        frame tokens (default: the window, ``z_len``). Returns
        ``{"code": (B, total_len)}``."""
        cfg = self.cfg
        total_len = cfg.z_len if total_len is None else total_len
        if total_len > cfg.z_len:
            raise NotImplementedError(
                f"total_len {total_len} > z_len {cfg.z_len} needs the sliding window, "
                "which is not ported yet")
        return {"code": self._fill(self.model, generator, code, total_len)}

    def _sched_for(self, merged_len):
        size = self.cfg.size
        n_frames = min(-(-merged_len // size), self.cfg.num_blocks)
        if n_frames * size < merged_len:
            n_frames = -(-merged_len // size)
        return build_schedule(self.cfg, n_frames)

    def _fill(self, model, generator, code, length):
        """Prefill, then one cached decode step per token up to ``length``."""
        b, n0 = code.shape
        if n0 == 0:
            raise ValueError("generation needs at least one context token")
        if length <= n0:
            return code
        sched = self._sched_for(length)
        dev = code.device
        s_idx, t_idx = sched.s_idx[:length], sched.t_idx[:length]
        merged = torch.zeros(b, length, dtype=torch.long, device=dev)
        merged[:, :n0] = code
        start = n0  # frame-only stream: the merged buffer is the code stream

        cache = model.init_cache(b, length)
        emb = model.embed_one(merged, torch.as_tensor(s_idx, device=dev).long(),
                              torch.as_tensor(t_idx, device=dev).long())
        logits_all, cache = model.prefill(emb, cache)
        cache = cache_to_layers(cache)
        # logits at position start - 1 predict token `start`; placeholders
        # beyond it are causally invisible and overwritten step by step
        logits = logits_all[:, start - 1]
        for j in range(start, length):
            tok = _sample_token(self.cfg, generator, logits)
            merged[:, j] = tok
            emb1 = model.embed_one(tok, int(s_idx[j]), int(t_idx[j]))[:, None]
            logits = decode_step_fn(model, emb1, j, cache)
        return merged
