"""Train states and optimizers of the latent-stage trainers (counterpart of
``ccvs_tpu/train/states.py``).

The transformer trains with AdamW under optax's warmup (and cosine)
schedule, with weight decay on the dense kernels only: every ``nn.Linear``
weight of the GPT, the head included (minGPT's split,
``transformer_model.py:85-139``). The state estimator trains with Adam.

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

import math
from dataclasses import dataclass

import torch
from torch import nn


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
        self.opt = torch.optim.AdamW([{"params": ps, "weight_decay": wd} for ps, _, wd in groups],
                                     lr=0.0, betas=(b1, b2), eps=eps)
        self.count = 0

    def step(self):
        """One update from the parameters' ``.grad``; a parameter without a
        gradient gets a zero one, as ``jax.grad`` gives it (its moments still
        decay)."""
        for group, sched in zip(self.opt.param_groups, self.schedules):
            group["lr"] = float(sched(self.count))
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.opt.step()
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state["count"])
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
