"""Train steps of the latent stage (counterpart of ``ccvs_tpu/train/steps.py``:
``make_transformer_step`` and ``make_simple_step``).

A step computes the loss and its gradients in eager PyTorch, records the
global gradient norm and applies one optimizer update to the parameters in
place. The JAX package's sharded variants (``state_shardings``, ``fsdp``,
``seq_parallel``) belong to the parallel layer, which is not ported: asking
for them raises.
"""

import torch

from ccvs_tpu_torch.train.states import SimpleTrainState, make_transformer_optimizer


def global_norm(grads):
    """optax's ``global_norm``: the square root of the sum of squares of
    every entry of every gradient."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _mb_loss(transformer, mb, generator):
    return transformer.loss(mb["code"], state_code=mb.get("state_code"),
                            cond_code=mb.get("cond_code"), delta=mb.get("delta"),
                            lbl=mb.get("vid_lbl"), generator=generator)


def make_transformer_step(transformer, cfg, n_iter, state_shardings=None):
    """``(init_state, step)`` for the latent transformer
    (``helpers/transformer_trainer.py:56-87``).

    ``init_state()`` builds the AdamW optimizer (``train/states.py``) over
    ``transformer``'s GPT. ``step(state, batch, generator=None)`` runs one
    update in training mode (``generator`` feeds dropout and residual noise)
    and returns ``(state, metrics)``: ``nll`` (and ``state_nll``) and
    ``gnorm``, the global gradient norm before the update, as device
    tensors. With ``cfg.grad_accum = n`` the batch is cut into ``n`` equal
    microbatches whose gradients are summed and then divided by ``n``: the
    full batch's update, with one microbatch's activations."""
    if state_shardings is not None or cfg.fsdp or cfg.seq_parallel:
        raise NotImplementedError("sharded transformer steps (state_shardings, fsdp, "
                                  "seq_parallel) come with the parallel layer")
    accum = max(1, cfg.grad_accum)

    def init_state():
        return SimpleTrainState(step=0, params=transformer,
                                opt=make_transformer_optimizer(cfg, n_iter, transformer.model))

    def step(state, batch, generator=None):
        model = state.params
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if accum == 1:
            loss, metrics = _mb_loss(model, batch, generator)
            loss.backward()
        else:
            b = batch["code"].shape[0]
            if b % accum:
                raise ValueError(f"grad_accum={accum} must divide the batch {b}")
            n = b // accum
            parts = []
            for i in range(accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, m = _mb_loss(model, mb, generator)
                loss.backward()
                parts.append({k: v.detach() for k, v in m.items()})
            for p in params:
                if p.grad is not None:
                    p.grad /= accum
            metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["gnorm"] = global_norm([p.grad for p in params if p.grad is not None])
        state.opt.step()
        state.step += 1
        return state, metrics

    return init_state, step


def make_simple_step(loss_fn, make_opt):
    """Generic ``(init_state, step)`` for the state-estimator trainer:
    ``loss_fn(module, batch) -> (loss, metrics)``, ``make_opt(module)`` its
    optimizer."""

    def init_state(module):
        return SimpleTrainState(step=0, params=module, opt=make_opt(module))

    def step(state, batch):
        model = state.params
        model.train()
        for p in model.parameters():
            p.grad = None
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return init_state, step
