"""Train states and optimizers (counterpart of ``ccvs_tpu/train/states.py``).

The frame autoencoder and its discriminators train with Adam, each with
the lazy-regularization ratio ``r = reg_every / (reg_every + 1)`` folded in
as ``lr * r`` and ``beta ** r`` (StyleGAN2's, ``quantized_video_model.py:
226-248``), optionally with a step decay after ``lr_decay_at`` updates
(optax's ``piecewise_constant_schedule``); the generator's EMA is updated
after each of its steps. The transformer trains with AdamW under optax's
warmup (and cosine) schedule, with weight decay on the dense kernels only:
every ``nn.Linear`` weight of the GPT, the head included (minGPT's split,
``transformer_model.py:85-139``). The state estimator and the STFT
autoencoder train with Adam.

``torch.optim.AdamW`` computes the same update as optax's ``adamw`` (and, with
weight decay 0, as ``adam``):
``p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with
``m_hat = m / (1 - b1^t)``, ``v_hat = v / (1 - b2^t)``, ``eps = 1e-8`` outside
the square root, and the decay decoupled from the moments and scaled by
the learning rate. optax reads its schedule at the count *before* the
update, so :class:`Optimizer` sets each group's ``lr`` from the number of
updates made so far: with ``lr_warmup_iter=1`` the first update has lr 0,
the moments advance and the weights do not move.
"""

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


def iteration_generator(seed, it, device=None):
    """The ``torch.Generator`` (on ``device``) of iteration ``it`` of a run
    seeded ``seed``, derived from the pair alone (the counterpart of the JAX
    package's ``fold_in(key, it)``): a run resumed at ``it`` draws what an
    uninterrupted run draws there."""
    s = int(np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(s)


def fold_in(generator, *data):
    """A ``torch.Generator`` on ``generator``'s device seeded from its seed
    and ``data`` (the counterpart of ``jax.random.fold_in``): a stream of its
    own for each ``data``, drawing nothing from ``generator``."""
    s = np.random.SeedSequence([generator.initial_seed(), *data])
    return torch.Generator(device=generator.device).manual_seed(
        int(s.generate_state(1, np.uint64)[0]) >> 1)


def linear_schedule(init_value, end_value, transition_steps):
    """optax's ``linear_schedule``: from ``init_value`` at count 0 to
    ``end_value`` at ``transition_steps``, then held."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0):
    """optax's ``warmup_cosine_decay_schedule``: linear warmup to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at count ``decay_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got {decay_steps} "
                         f"and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    span = decay_steps - warmup_steps

    def schedule(count):
        if count < warmup_steps:
            return warmup(count)
        c = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span)) + alpha)

    return schedule


class Optimizer:
    """``torch.optim.AdamW`` over parameter groups, each with its own
    schedule (``count -> lr``) and weight decay; ``count`` is the number of
    updates made. Parameters left out of every group are frozen (optax's
    ``set_to_zero``)."""

    def __init__(self, groups, b1, b2, eps=1e-8):
        """``groups``: ``[(params, schedule, weight_decay), ...]``."""
        groups = [(list(ps), sched, wd) for ps, sched, wd in groups]
        groups = [g for g in groups if g[0]]
        self.schedules = [sched for _, sched, _ in groups]
        # no parameters (an autoencoder trained without discriminators): no
        # optimizer, the count still advances
        self.opt = torch.optim.AdamW(
            [{"params": ps, "weight_decay": wd} for ps, _, wd in groups], lr=0.0,
            betas=(b1, b2), eps=eps) if groups else None
        self.count = 0

    def step(self):
        """One update from the parameters' ``.grad``; a parameter without a
        gradient gets a zero one, as ``jax.grad`` gives it (its moments still
        decay)."""
        if self.opt is not None:
            for group, sched in zip(self.opt.param_groups, self.schedules):
                group["lr"] = float(sched(self.count))
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            self.opt.step()
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "opt": self.opt.state_dict() if self.opt else {}}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        if self.opt is not None:
            self.opt.load_state_dict(state["opt"])


@dataclass
class SimpleTrainState:
    """The step count, the trained module (its parameters) and the optimizer."""

    step: int
    params: nn.Module
    opt: Optimizer

    def state_dict(self):
        return {"step": self.step, "params": self.params.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, state):
        self.step = int(state["step"])
        self.params.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt"])


def decay_mask(module):
    """Names of the parameters that decay: the weights of ``nn.Linear``
    (flax ``Dense`` kernels); embeddings, biases, LayerNorms, positional
    embeddings, ``start_tok_emb`` and ``noise_weight`` do not."""
    return {f"{name}.weight" if name else "weight"
            for name, m in module.named_modules() if isinstance(m, nn.Linear)}


def make_transformer_optimizer(cfg, n_iter, gpt):
    """AdamW over ``gpt``'s parameters with the decay mask and the warmup
    (``lr_warmup_iter``) and, with ``lr_decay``, cosine schedule to
    ``n_iter``. With ``finetune_head`` the head trains at the full lr and
    everything else at ``lr * finetune_f``, or is frozen when
    ``finetune_f`` is None."""
    warmup = max(cfg.lr_warmup_iter, 1)
    if cfg.lr_decay:
        sched = warmup_cosine_decay_schedule(0.0, cfg.lr, warmup, n_iter)
    else:
        sched = linear_schedule(0.0, cfg.lr, warmup)
    decayed = decay_mask(gpt)
    named = list(gpt.named_parameters())
    decay = [p for n, p in named if n in decayed]
    keep = [p for n, p in named if n not in decayed]
    wd = cfg.weight_decay
    if not cfg.finetune_head:
        return Optimizer([(decay, sched, wd), (keep, sched, 0.0)], cfg.beta1, cfg.beta2)
    head = {id(p) for p in gpt.head.parameters()}
    groups = [([p for _, p in named if id(p) in head], sched, wd)]  # the head decays whole
    f = cfg.finetune_f
    if f is not None:
        def rest_sched(count):
            return sched(count) * f

        groups += [([p for p in decay if id(p) not in head], rest_sched, wd),
                   ([p for p in keep if id(p) not in head], rest_sched, 0.0)]
    return Optimizer(groups, cfg.beta1, cfg.beta2)


def make_adam(params, lr, b1, b2, weight_decay=0.0):
    """optax's ``adam`` (or ``adamw`` with ``weight_decay``) at a constant lr."""
    return Optimizer([(params, lambda count: lr, weight_decay)], b1, b2)


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """optax's ``piecewise_constant_schedule``: ``init_value`` times every
    scale whose boundary the count has reached."""
    def schedule(count):
        v = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                v *= scale
        return v

    return schedule


def make_ae_optimizers(cfg, gen_params, disc_params):
    """``(opt_g, opt_d)``: Adam over the generator's and the discriminators'
    parameters with the lazy-regularization lr and beta ratios
    (``quantized_video_model.py:239-243``) and ``lr_decay_at`` (an int or a
    tuple of update counts, each multiplying the lr by ``lr_decay_mult``)."""
    g_ratio = cfg.g_reg_every / (cfg.g_reg_every + 1) if cfg.g_reg_every else 1.0
    d_ratio = cfg.d_reg_every / (cfg.d_reg_every + 1) if cfg.d_reg_every else 1.0
    pts = (cfg.lr_decay_at if isinstance(cfg.lr_decay_at, (tuple, list))
           else (cfg.lr_decay_at,) if cfg.lr_decay_at else ())

    def adam(params, ratio):
        sched = piecewise_constant_schedule(cfg.lr * ratio,
                                            {int(p): cfg.lr_decay_mult for p in pts})
        return Optimizer([(params, sched, 0.0)], cfg.beta1**ratio, cfg.beta2**ratio)

    return adam(gen_params, g_ratio), adam(disc_params, d_ratio)


@torch.no_grad()
def ema_update(ema, module, decay=0.999):
    """``ema <- ema * decay + params * (1 - decay)`` over the parameters of
    two modules of one structure (``QVidModel.accumulate``,
    ``quantized_video_model.py:951-964``)."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [p.detach() for p in module.parameters()], alpha=1.0 - decay)


@dataclass
class AETrainState:
    """The autoencoder's train state: the iteration count, the generator
    (the autoencoder), the discriminators (an ``nn.ModuleDict`` of ``di``,
    ``dv``, ``df``), both optimizers, the generator's EMA (a copy of it that
    takes no gradient), and the adaptive augmentation's probability
    ``ada_p`` and last statistic ``ada_rt`` (``mean(sign(D(real)))``), 0-d
    fp32 tensors on the generator's device that the D step updates there."""

    step: int
    gen: nn.Module
    disc: nn.Module
    opt_g: Optimizer
    opt_d: Optimizer
    ema: nn.Module
    ada_p: torch.Tensor
    ada_rt: torch.Tensor

    @staticmethod
    def create(cfg, gen, disc):
        ema = copy.deepcopy(gen).requires_grad_(False)
        opt_g, opt_d = make_ae_optimizers(cfg, gen.parameters(), disc.parameters())
        dev = next(gen.parameters()).device
        return AETrainState(0, gen, disc, opt_g, opt_d, ema,
                            torch.tensor(float(cfg.aug_p), device=dev),
                            torch.zeros((), device=dev))

    def state_dict(self):
        return {"step": self.step, "gen": self.gen.state_dict(), "disc": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "ema": self.ema.state_dict(), "ada_p": self.ada_p.clone(),
                "ada_rt": self.ada_rt.clone()}

    def load_state_dict(self, state):
        self.step = int(state["step"])
        self.gen.load_state_dict(state["gen"])
        self.disc.load_state_dict(state["disc"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.ema.load_state_dict(state["ema"])
        dev = self.ada_p.device
        self.ada_p = torch.as_tensor(state["ada_p"], dtype=torch.float32).to(dev).clone()
        self.ada_rt = torch.as_tensor(state["ada_rt"], dtype=torch.float32).to(dev).clone()
