"""Latent-token transformer: the training loss, and KV-cached autoregressive
generation with the sliding window, beam search and the fixed-window chunk of
step-by-step generation (counterpart of ``ccvs_tpu/models/transformer.py``),
over the frame stream with interleaved state tokens and the
``[lbl][start][cond]`` prefix; and the continuous transformer, which
regresses the next latent vector and rolls out greedily.

The JAX package scans its per-token decode step as one compiled program
(``_fill_jit``, ``_fill_beam_jit``, ``_chunk_fill_jit``); here it is a Python
loop whose tensors stay on the device: nothing in the loop waits for the GPU.
The schedule (each position's kind, spatial and temporal index, and whether
its token is given) is static numpy, so the loop reads it on the host.
"""

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.gpt import (CGPT, GPT, KIND_FRAME, KIND_STATE, build_schedule,
                                   cache_to_layers, decode_step_fn)
from ccvs_tpu_torch.nn.quantized import decode_step_fn_int8, quantize_gpt_int8
from ccvs_tpu_torch.parallel.mesh import draw_rows
from ccvs_tpu_torch.utils import profiling


def _categorical(probs, generator, axis=None):
    """One draw from each row of ``probs`` ``(B, V)``: the argmax of ``probs``
    over Exp(1) noise, as ``torch.multinomial`` draws one sample (the same
    tokens from the same generator state), the noise drawn at the global
    batch's rows where a data axis ``axis`` splits the batch
    (``parallel.mesh.draw_rows``)."""
    q = draw_rows(axis, probs.shape[0], lambda n: torch.empty(
        (n, *probs.shape[1:]), dtype=probs.dtype, device=probs.device).exponential_(
            1.0, generator=generator))
    return (probs / q).argmax(-1)


def _sample_token(cfg, generator, logits, kind, axis=None):
    """Sample tokens ``(B,)`` of the stream ``kind`` (a host int) from logits
    ``(B, V)``: the stream's temperature and vocabulary mask, its top-k
    threshold read from one ``topk`` of the larger k, then a categorical
    draw (:func:`_categorical`, over the data axis ``axis``), or the argmax
    where the stream does not sample."""
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
    return _categorical(torch.softmax(logits, dim=-1), generator, axis)


def _top_k(x, k):
    """The ``k`` largest entries along the last axis, values and indices,
    ties to the lower index as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among ties, which ``-inf``-masked logits have)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mask_below_top_k(logits, k):
    """Logits under the ``k``-th largest of their row set to ``-inf``."""
    thresh = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[:, -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def _beam_logprobs(cfg, logits):
    """Log-probabilities of the frame vocabulary that beam search scores:
    the temperature and ``top_k`` mask, then ``log_softmax``."""
    lg = logits.float()[:, :cfg.z_num] / cfg.temperature
    if cfg.top_k is not None:
        lg = _mask_below_top_k(lg, cfg.top_k)
    return torch.log_softmax(lg, dim=-1)


def _beam_state_token(cfg, generator, logits, axis=None):
    """A state token for each hypothesis, outside the beam score: the state
    temperature, vocabulary and ``top_k_state`` (without the fallback to
    ``top_k`` of :func:`_sample_token`, as the JAX package's beam search)."""
    lg = logits.float() / cfg.temperature_state
    vocab = lg.shape[-1]
    lg = lg.masked_fill(torch.arange(vocab, device=lg.device) >= max(cfg.state_num, 1),
                        float("-inf"))
    if cfg.top_k_state is not None:
        lg = _mask_below_top_k(lg, cfg.top_k_state)
    if cfg.sample_state or cfg.sample:
        return _categorical(torch.softmax(lg, dim=-1), generator, axis)
    return lg.argmax(-1)


def _ce(logits, targets):
    """Mean cross-entropy of ``targets`` under ``logits``, computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


class TokenTransformer(nn.Module):
    """The GPT in compute ``dtype`` with parameters in ``param_dtype``
    (default ``dtype``). It starts in eval mode: dropout and residual noise
    act only after ``train()``."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):
            self.model = GPT(cfg, dtype=dtype, param_dtype=param_dtype)
        # parallel.mesh.DataAxis of a data-parallel generation: each batch is
        # this rank's block of the global batch, and every random draw is made
        # at the global batch's rows (what one process draws on it)
        self.data_axis = None
        self.eval()

    @property
    def device(self):
        return self.model.head.weight.device

    def init(self, seed=0):
        """Seeded random parameters; returns self."""
        self.model.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        return self

    def loss(self, code, state_code=None, cond_code=None, delta=None, lbl=None, generator=None):
        """Cross-entropy of the next token (``transformer_model.py:142-253``):
        the input is ``code[:, :-1]`` of ``code`` cut to ``z_len``; the
        targets are ``code`` where a start token or a label leads, else
        ``code[:, 1:]``. With state tokens, the logits of state targets are
        cut to ``state_num`` and scored against ``state_code[:, 1:]``, in
        the interleaved and the ``state_front`` schedule. Returns ``(loss,
        {"nll"[, "state_nll"]})``. ``generator`` feeds dropout and residual
        noise in training mode."""
        cfg = self.cfg
        code = code[:, :cfg.z_len]
        logits = self.model(code[:, :-1], state_code=state_code, cond_code=cond_code,
                            delta=delta, lbl=lbl, generator=generator)
        if state_code is not None and cfg.state_size > 0:
            pos = np.arange(logits.shape[1]) + 1  # each logit's target position
            if cfg.state_front:
                is_state = pos < cfg.state_size * cfg.num_blocks
            else:
                is_state = pos % cfg.tot_size < cfg.state_size
            state_i = torch.as_tensor(np.nonzero(is_state)[0], device=logits.device)
            frame_i = torch.as_tensor(np.nonzero(~is_state)[0], device=logits.device)
            nll = _ce(logits[:, frame_i], code)
            state_nll = _ce(logits[:, state_i, :cfg.state_num], state_code[:, 1:])
            return nll + state_nll, {"nll": nll, "state_nll": state_nll}
        tgt = code if (cfg.use_start_token or cfg.cat) else code[:, 1:]
        nll = _ce(logits[:, :tgt.shape[1]], tgt)
        return nll, {"nll": nll}

    @torch.no_grad()
    @profiling.spanned("tokens")
    def generate(self, code, generator, state_code=None, cond_code=None, delta=None, lbl=None,
                 total_len=None):
        """Extend the given frame tokens ``code`` ``(B, n0)`` (and state
        tokens ``state_code``) autoregressively: fill one window, then slide
        it a ``z_chunk`` at a time until ``total_len`` tokens of the prefix
        and body are made (default: one window).

        ``cond_code`` ``(B, Lc)`` are the point-to-point prefix's tokens and
        ``delta`` ``(B,)`` their temporal shift, decremented at each slide;
        ``lbl`` ``(B,)`` the class labels of the class-conditional mode. With
        ``cfg.beam_size > 1`` each window is filled by beam search. With
        ``cfg.serve_int8`` the decode step runs on int8 weights, quantized
        once here.

        Returns ``{"code": (B, n_frame_tokens), "state_code": (B,
        n_state_tokens) or None}``."""
        cfg = self.cfg
        b = code.shape[0]
        step_fn = self._step_fn()
        if cfg.state_size > 0 and state_code is None:
            state_code = code.new_zeros(b, 0)
        n_cond = 0 if cond_code is None else cond_code.shape[1]
        cap = cfg.z_len - n_cond
        budget = (cap if total_len is None else total_len - n_cond)
        # in-window capacities of a full window's streams
        cap_sched = self._sched_for(cap)
        f_cap = int((cap_sched.frame_pos < cap).sum())
        s_cap = int((cap_sched.state_pos < cap).sum())

        fill = partial(self._fill, generator, step_fn, cond_code=cond_code, lbl=lbl)
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

    @torch.no_grad()
    @profiling.spanned("tokens")
    def generate_chunk_fixed(self, merged, n, generator):
        """Extend a full-window token buffer ``merged`` ``(B, z_len)``, whose
        first ``n`` tokens are real, by one ``z_chunk`` at positions ``n ..
        n + z_chunk - 1``: a prefill of the whole window (the placeholders
        past ``n`` are causally invisible to the positions before them and
        overwritten as the loop reaches them), then ``z_chunk`` cached decode
        steps. The plain frame stream only: no label, start or cond prefix.
        Returns the extended buffer (``merged`` is not modified)."""
        cfg = self.cfg
        if cfg.use_start_token or cfg.cat or cfg.p2p:
            raise ValueError("generate_chunk_fixed: the plain frame stream only (no label, "
                             "start or cond prefix)")
        length = cfg.z_len
        if merged.shape[1] != length or not 1 <= n <= length - cfg.z_chunk:
            raise ValueError(f"generate_chunk_fixed: buffer {tuple(merged.shape)}, n={n} "
                             f"(a window of {length}, n in [1, {length - cfg.z_chunk}])")
        sched = self._sched_for(length)
        kind, s_idx, t_idx = sched.kind[:length], sched.s_idx[:length], sched.t_idx[:length]
        merged = merged.long().clone()
        logits, cache, pos = self._prefill(merged, kind, s_idx, t_idx, n)
        self._decode(generator, self._step_fn(), merged, np.zeros(length, bool),
                     range(n, n + cfg.z_chunk), kind, s_idx, t_idx, logits,
                     cache_to_layers(cache), pos)
        return merged

    def _step_fn(self):
        """The cached decode step: bf16 / fp32, or with ``cfg.serve_int8``
        the int8 one on weights quantized now."""
        if self.cfg.serve_int8:
            return partial(decode_step_fn_int8, qparams=quantize_gpt_int8(self.model))
        return decode_step_fn

    def _sched_for(self, merged_len):
        """Schedule of enough frames for ``merged_len`` body tokens."""
        cfg = self.cfg
        per = cfg.tot_size if cfg.state_size > 0 else cfg.size
        n_frames = min(-(-merged_len // per), cfg.num_blocks)
        if n_frames * per < merged_len:  # a partial frame past the window's blocks
            n_frames = -(-merged_len // per)
        return build_schedule(cfg, n_frames)

    def _fill(self, generator, step_fn, code, state_code, cond_code, delta, lbl, length):
        """Prefill, then one cached decode step per position up to a body of
        ``length`` tokens (by beam search with ``cfg.beam_size > 1``). Given
        tokens (the frame stream's first ``n0`` and the state stream's) are
        never overwritten. Returns the frame and state streams of the body."""
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

        if self.cfg.beam_size is not None and self.cfg.beam_size > 1:
            # the first generated frame position, where the hypotheses part
            free = np.nonzero((kind[start:] == KIND_FRAME) & ~given[start:])[0]
            beam_start = start + int(free[0]) if len(free) else -1
            hyps, log_p = self._fill_beam(generator, step_fn, merged, given, start, beam_start,
                                          kind, s_idx, t_idx, cond_code, delta, lbl)
            merged = hyps[torch.arange(b, device=dev), log_p.argmax(1)]
        else:
            logits, cache, pos = self._prefill(merged, kind, s_idx, t_idx, start, cond_code,
                                               delta, lbl)
            self._decode(generator, step_fn, merged, given, range(start, length), kind, s_idx,
                         t_idx, logits, cache_to_layers(cache), pos)
        out_state = None if state_code is None else merged[:, torch.as_tensor(spos, device=dev)]
        return merged[:, torch.as_tensor(fpos, device=dev)], out_state

    def _prefill(self, merged, kind, s_idx, t_idx, start, cond_code=None, delta=None, lbl=None):
        """Run the prefix and the body ``merged`` ``(B, L)`` once through a new
        cache; placeholders from ``start`` on are causally invisible to the
        positions before them. Returns the logits that predict ``body[start]``,
        the stacked cache and ``body[start]``'s absolute position, an int32
        tensor of shape ``(1,)`` on the device."""
        model = self.model
        b = merged.shape[0]
        prefix_len = model.prefix_len(cond_code, lbl)
        cache = model.init_cache(b, prefix_len + merged.shape[1])
        emb = model.embed_one(merged, s_idx, t_idx, kind)
        prefix = model._prefix_emb(b, cond_code, delta, lbl)
        if prefix is not None:
            emb = torch.cat([prefix, emb], dim=1)
        logits_all, cache = model.prefill(emb, cache)
        pos = torch.full((1,), prefix_len + start, dtype=torch.int32, device=merged.device)
        # logits at prefix_len + start - 1 predict body[start] (behind a start
        # token and no context, the start token's); with no prefix and nothing
        # given before body[0], index -1 reads the last position, as the JAX
        # package's dynamic index wraps it
        return logits_all[:, prefix_len + start - 1], cache, pos

    def _decode(self, generator, step_fn, merged, given, positions, kind, s_idx, t_idx, logits,
                cache, pos):
        """One cached decode step per position of ``positions``, from the
        logits and per-layer cache of :meth:`_prefill`: the position's token
        (given, or sampled into ``merged`` in place) goes through the step,
        and ``pos`` advances on the device."""
        model = self.model
        for j in positions:
            with profiling.span("tokens.step"):
                if given[j]:
                    tok = merged[:, j]
                else:
                    with profiling.span("tokens.sample"):
                        tok = _sample_token(self.cfg, generator, logits, int(kind[j]),
                                            self.data_axis)
                    merged[:, j] = tok
                emb1 = model.embed_one(tok, int(s_idx[j]), int(t_idx[j]), int(kind[j]))[:, None]
                logits = step_fn(model, emb1=emb1, pos=pos, cache=cache)
                pos += 1

    def _fill_beam(self, generator, step_fn, merged, given, start, beam_start, kind, s_idx, t_idx,
                   cond_code, delta, lbl):
        """Beam search over the body ``merged`` ``(B, L)`` from ``start``.

        The ``beam`` hypotheses of each batch element are folded into the
        batch (``B * beam``, element-major). At ``beam_start``, the first
        generated frame position, each element takes ``beam`` distinct tokens
        (Gumbel top-k, i.e. sampling without replacement; plain top-k when
        greedy or ``no_sample``). Later frame positions either sample one
        token per hypothesis (``sample``) and add its log-probability, or
        expand ``beam``^2 candidates, keep the best ``beam`` and reorder the
        hypotheses and the KV cache. State tokens and given tokens ride along
        outside the score.

        Returns the hypotheses ``(B, beam, L)`` and their summed
        log-probabilities ``(B, beam)``."""
        cfg, model = self.cfg, self.model
        beam = cfg.beam_size
        b, length = merged.shape
        bb, dev = b * beam, merged.device

        def rep(x):
            return None if x is None else x.repeat_interleave(beam, dim=0)

        merged = rep(merged)
        logits, cache, pos = self._prefill(merged, kind, s_idx, t_idx, start, rep(cond_code),
                                           rep(delta), rep(lbl))
        # a reorder gathers the whole cache into the second buffer and the two
        # swap: both stay contiguous, as K2 reads them (on the H100 the
        # contiguous gather of all rows took less time than a strided one of
        # the rows written so far at the rollout's mean position; PERF.md)
        caches = [cache, tuple(torch.empty_like(c) for c in cache)]
        layers = [cache_to_layers(c) for c in caches]
        cur = 0
        log_p = torch.zeros(bb, device=dev)
        first_row = torch.arange(b, device=dev)[:, None] * beam
        for j in range(start, length):
            with profiling.span("tokens.step"):
                parent = None
                if given[j]:
                    tok = merged[:, j]
                else:
                    with profiling.span("tokens.sample"):
                        if kind[j] == KIND_STATE:
                            tok = _beam_state_token(cfg, generator, logits, self.data_axis)
                        else:
                            tok, log_p, parent = self._beam_frame_token(
                                generator, logits, j == beam_start, log_p, first_row)
                if parent is not None:
                    merged = merged[parent]
                    for side in range(2):
                        torch.index_select(caches[cur][side], 1, parent,
                                           out=caches[1 - cur][side])
                    cur = 1 - cur
                merged[:, j] = tok
                emb1 = model.embed_one(tok, int(s_idx[j]), int(t_idx[j]), int(kind[j]))[:, None]
                logits = step_fn(model, emb1=emb1, pos=pos, cache=layers[cur])
                pos += 1
        return merged.reshape(b, beam, length), log_p.reshape(b, beam)

    def _beam_frame_token(self, generator, logits, first, log_p, first_row):
        """The tokens of one generated frame position of beam search, the
        hypotheses' summed log-probabilities after it, and the hypotheses
        (rows of ``B * beam``) they extend where the beam keeps the best
        ``beam`` of ``beam``^2 candidates (else None): at the ``first``
        generated position each element's ``beam`` distinct tokens, then one
        sampled token a hypothesis or the best candidates.
        ``first_row`` ``(B, 1)``: each element's first row."""
        cfg, beam = self.cfg, self.cfg.beam_size
        b, bb, dev = first_row.shape[0], log_p.shape[0], logits.device
        lp = _beam_logprobs(cfg, logits)  # (bb, z_num)
        if first:
            lp0 = lp[::beam]  # one row per element: its hypotheses are still clones
            score = lp0
            if cfg.sample and not cfg.no_sample:
                u = draw_rows(self.data_axis, b, lambda n: torch.rand(
                    (n, lp0.shape[1]), generator=generator, device=dev))
                score = lp0 - torch.log(-torch.log(u + 1e-20) + 1e-20)
            _, tok = _top_k(score, beam)  # (b, beam)
            return tok.reshape(bb), log_p + lp0.gather(1, tok).reshape(bb), None
        if cfg.sample:
            tok = _categorical(lp.exp(), generator, self.data_axis)
            return tok, log_p + lp.gather(1, tok[:, None])[:, 0], None
        vals, cand = _top_k(lp, beam)  # (bb, beam)
        total = (log_p[:, None] + vals).reshape(b, beam * beam)
        new_log_p, keep = _top_k(total, beam)  # (b, beam)
        tok = cand.reshape(b, beam * beam).gather(1, keep).reshape(bb)
        return tok, new_log_p.reshape(bb), (first_row + keep // beam).reshape(bb)


class ContinuousTransformer(nn.Module):
    """The continuous GPT (:class:`CGPT`) in compute ``dtype`` with
    parameters in ``param_dtype`` (default ``dtype``): the reference's
    ``is_continuous`` path (``transformer_model.py:147-159``), a regression
    of the next latent vector and its greedy rollout. It starts in eval
    mode."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):
            self.model = CGPT(cfg, dtype=dtype, param_dtype=param_dtype)
        # TokenTransformer's: the rollout is greedy, only a drawn class label
        # reads it (generate.py)
        self.data_axis = None
        self.eval()

    @property
    def device(self):
        return self.model.head.weight.device

    def init(self, seed=0):
        """Seeded random parameters; returns self."""
        self.model.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        return self

    def loss(self, code, generator=None):
        """Mean squared error of the next vector (``transformer_model.py:159``)
        for ``code`` ``(B, T, n_in)`` cut to ``z_len``; with several
        proposals, each position's best proposal's. Returns ``(mse, {"nll":
        mse})``."""
        cfg = self.cfg
        code = code[:, :cfg.z_len]
        pred = self.model(code[:, :-1], generator=generator)
        if cfg.n_proposals > 1:
            err = ((pred[1] - code[:, 1:, None]) ** 2).mean(-1)  # (B, T, P)
            mse = err.min(-1).values.mean()
        else:
            mse = ((pred - code[:, 1:]) ** 2).mean()
        return mse, {"nll": mse}

    @torch.no_grad()
    @profiling.spanned("tokens")
    def generate(self, code, total_len, normalize_pred=False):
        """Greedy rollout of ``code`` ``(B, n0, n_in)`` to ``total_len``
        vectors (``transformer_model.py:344-348``): one prefill over the
        zero-padded buffer, then one cached decode step a position (K2 in
        each layer on CUDA). Each prediction is the proposal of the largest
        logit, divided by its norm with ``normalize_pred``; the next input's
        embedding is ``x @ W + b + pos_emb[j - 1]``, in fp32 and then the
        compute dtype. The position advances on the device. Returns the
        buffer ``(B, total_len, n_in)``, or ``code`` when ``total_len <=
        n0``."""
        cfg, model = self.cfg, self.model
        b, n0, n_in = code.shape
        length = int(total_len)
        if length <= n0:
            return code
        buf = code.new_zeros(b, length, n_in)
        buf[:, :n0] = code

        def pick(out):
            """Head output at one position -> the prediction ``(B, n_in)``."""
            if cfg.n_proposals > 1:
                o = out.reshape(b, cfg.n_proposals, n_in + 1)
                best = o[..., 0].argmax(-1)
                pred = o[..., 1:].gather(1, best[:, None, None].expand(b, 1, n_in))[:, 0]
            else:
                pred = out
            if normalize_pred:
                pred = pred / torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
            return pred.to(buf.dtype)

        cache = model.init_cache(b, length)
        out, cache = model.prefill(model.embed(buf), cache)
        if cfg.n_proposals > 1:
            logits, props = out
            out = torch.cat([logits[..., None], props], dim=-1).reshape(b, length, -1)
        buf[:, n0] = pick(out[:, n0 - 1])
        if length <= n0 + 1:
            return buf
        layers = cache_to_layers(cache)
        w, bias = model.tok_emb.weight.float(), model.tok_emb.bias.float()
        pe = model.pos_emb[0].float()
        pos = torch.full((1,), n0, dtype=torch.int32, device=buf.device)
        for j in range(n0 + 1, length):
            with profiling.span("tokens.step"):
                emb1 = (F.linear(buf[:, j - 1:j].float(), w, bias) + pe[j - 1]).to(model.dtype)
                buf[:, j] = pick(decode_step_fn(model, emb1, pos, layers))
                pos += 1
        return buf
