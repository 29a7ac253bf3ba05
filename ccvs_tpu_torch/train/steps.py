"""Train steps (counterpart of ``ccvs_tpu/train/steps.py``): the frame
autoencoder's G, D and R1 steps, the latent transformer's step and the
generic step of the state and STFT trainers.

A step computes the loss and its gradients in eager PyTorch and applies one
optimizer update to the parameters in place; each gradient is taken with
respect to the parameters that step updates only (the autoencoder's G step
runs the discriminators without computing their parameters' gradients).

On a mesh (``parallel/mesh.py``) each step averages its gradients over the
data axis before the update, so every rank applies the update of the global
batch, and its metrics are the global batch's (the JAX package's GSPMD steps
do both implicitly). The transformer step also splits the GPT over the
mesh: its parameters and moments by FSDP (``cfg.fsdp``), its tokens by
sequence parallelism (``cfg.seq_parallel``); tensor parallelism splits the
weights before (``parallel/tp.py``, as the transformer trainer does).
"""

import torch
import torch.distributed as dist
from torch import nn

from ccvs_tpu_torch.parallel.fsdp import shard_fsdp, tp_split
from ccvs_tpu_torch.parallel.mesh import DataAxis, reduce_grads
from ccvs_tpu_torch.parallel.sp import seq_shard
from ccvs_tpu_torch.train.states import (AETrainState, SimpleTrainState, ema_update, fold_in,
                                         make_transformer_optimizer)
from ccvs_tpu_torch.utils import profiling


def global_norm(grads, splits=None):
    """optax's ``global_norm``: the square root of the sum of squares of
    every entry of every gradient. ``splits``: for each gradient, the
    process groups over which its entries are split (FSDP's DTensors: their
    local shard and their mesh's group; tensor parallelism's shards: its
    model axis), so that every entry counts once."""
    if splits is None:
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    from torch.distributed.tensor import DTensor

    sums = {}
    for g, groups in zip(grads, splits):
        if isinstance(g, DTensor):
            groups = (g.device_mesh.get_group(), *groups)
            g = g.to_local()
        sq = (g.float() ** 2).sum()
        sums[groups] = sq if groups not in sums else sums[groups] + sq
    total = None
    for groups, sq in sums.items():
        for group in groups:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _local(t):
    """A DTensor's local shard, else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _mb_loss(transformer, mb):
    return transformer.loss(mb["code"], state_code=mb.get("state_code"),
                            cond_code=mb.get("cond_code"), delta=mb.get("delta"),
                            lbl=mb.get("vid_lbl"))


def _update(params, loss, opt, axis=None):
    """Gradients of ``loss`` into ``params``' ``.grad`` (only those),
    averaged over the data axis ``axis`` where there is one, then one update
    of ``opt``."""
    for p in params:
        p.grad = None
    loss.backward(inputs=params)
    if axis is not None:
        axis.all_reduce_grads(params)
    opt.step()


def _detached(tree):
    return {k: None if v is None else v.detach() for k, v in tree.items()}


def make_ae_steps(losses, aug_fn=None, data_axis=None):
    """``(init_state, g_step, d_step, r1_step)`` of the frame autoencoder
    (``helpers/frame_autoencoder_trainer.py:49-79``) over the modules of
    ``losses`` (an :class:`~ccvs_tpu_torch.train.ae_losses.AELosses`).

    - ``init_state()``: an :class:`AETrainState` of ``losses.ae`` and an
      ``nn.ModuleDict`` of the discriminators, with both Adam optimizers and
      the EMA copy.
    - ``g_step(state, batch, mode, generator=None)``: one generator update
      on an image (``mode="img"``) or video batch, then the EMA; returns
      ``(state, metrics, fake)`` with ``g_loss``. ``generator`` draws the
      context-drop mask.
    - ``d_step(state, batch, fake, mode, generator=None)``: one
      discriminator update on ``batch`` and the G step's ``fake``; returns
      ``(state, metrics)`` with ``d_loss``.
    - ``r1_step(state, batch, mode, generator=None)``: one discriminator
      update on the lazy R1 penalty (``r1_img`` / ``r1_vid``).

    ``aug_fn(generator, img, p)`` is the adaptive augmentation
    (:func:`~ccvs_tpu_torch.train.ada.augment`); with it and
    ``cfg.use_aug``, the image discriminator sees augmented images at the
    reference's three places: the G step's fake (``quantized_video_model.py
    :418``), the D step's real and fake (``:639-640``) and R1's real
    (``:677``), at probability ``state.ada_p``. Each place draws from a
    stream of its own, derived from the step's ``generator`` (the JAX
    package's ``fold_in(rng, 1 | 2 | 3)`` and its salts), so the steps then
    need one. With ``aug_p = 0`` the image D step moves ``ada_p`` after its
    update (``modules/non_leaking.py:28-47``): by the sign of ``r_t =
    mean(sign(D(real))) - ada_target``, ``n / ada_length`` for n real
    images, clipped to [0, 1]; ``ada_rt`` and the metric ``rt_stat`` hold
    ``r_t``.

    ``state.step`` counts iterations and is advanced by the trainer: an
    iteration holds an image G step and, every ``vid_step_every``, a video
    one.

    ``data_axis`` (a ``parallel.mesh.DataAxis``): the batches are this
    rank's block of the global batch. The gradients and metrics are averaged
    over the axis, ``r_t`` is the global batch's, the discriminators' stddev
    groups and the steps' random draws (the context-drop mask, the
    augmentation) are the global batch's (``losses.data_axis`` and each
    discriminator's ``data_axis`` are set to it)."""
    cfg = losses.cfg
    ax = data_axis
    losses.data_axis = ax
    disc = nn.ModuleDict({k: m for k, m in (("di", losses.di), ("dv", losses.dv),
                                            ("df", losses.df)) if m is not None})
    for d in disc.values():
        d.data_axis = ax

    def _mean(metrics):
        return metrics if ax is None else ax.mean(metrics)

    def init_state():
        return AETrainState.create(cfg, losses.ae, disc)

    def _aug(state, generator, site):
        """The augmentation of one step, ``aug(x, salt=0)``, or None."""
        if not cfg.use_aug or aug_fn is None:
            return None
        if generator is None:
            raise ValueError("adaptive augmentation draws from the step's generator; pass one")
        gen = fold_in(generator, site)
        if ax is not None:
            return lambda x, salt=0: aug_fn(fold_in(gen, salt), x, state.ada_p,
                                            rows=ax.rows(x.shape[0]))
        return lambda x, salt=0: aug_fn(fold_in(gen, salt), x, state.ada_p)

    def g_step(state, batch, mode, generator=None):
        if mode == "img":
            loss, (metrics, fake) = losses.img_generator_loss(
                batch, generator, aug=_aug(state, generator, 1))
        else:
            loss, (metrics, fake) = losses.vid_generator_loss(batch, generator)
        _update(list(state.gen.parameters()), loss, state.opt_g, ax)
        if cfg.use_ema:
            ema_update(state.ema, state.gen, cfg.ema_decay)
        metrics["g_loss"] = loss
        return state, _mean(_detached(metrics)), _detached(fake)

    def d_step(state, batch, fake, mode, generator=None):
        real_score = None
        if mode == "img":
            loss, (metrics, real_score) = losses.img_discriminator_loss(
                batch["img"], fake["img"], fake.get("z"), aug=_aug(state, generator, 2))
        else:
            loss, metrics = losses.vid_discriminator_loss(batch["vid"], fake["vid"],
                                                          fake.get("z"), fake.get("unc_vid"))
        _update(list(state.disc.parameters()), loss, state.opt_d, ax)
        if cfg.use_aug and cfg.aug_p == 0 and real_score is not None:
            r_t = torch.sign(real_score.detach().float()).mean()
            n = real_score.shape[0]
            if ax is not None:  # the global batch's statistic
                r_t, n = ax.mean([r_t])[0], n * ax.size
            step = torch.sign(r_t - cfg.ada_target) * n / cfg.ada_length
            state.ada_p = torch.clamp(state.ada_p + step, 0.0, 1.0)
            state.ada_rt = r_t
            metrics["rt_stat"] = r_t
        metrics["d_loss"] = loss
        return state, _mean(_detached(metrics))

    def r1_step(state, batch, mode, generator=None):
        loss = (losses.img_r1_loss(batch["img"], aug=_aug(state, generator, 3)) if mode == "img"
                else losses.vid_r1_loss(batch["vid"]))
        _update(list(state.disc.parameters()), loss, state.opt_d, ax)
        return state, _mean({"r1_" + mode: loss.detach()})

    return init_state, g_step, d_step, r1_step


def make_transformer_step(transformer, cfg, n_iter, mesh=None):
    """``(init_state, step)`` for the latent transformer
    (``helpers/transformer_trainer.py:56-87``).

    ``init_state()`` builds the AdamW optimizer (``train/states.py``) over
    ``transformer``'s GPT. ``step(state, batch)`` runs one update and
    returns ``(state, metrics)``: ``nll`` (and ``state_nll``) and
    ``gnorm``, the global gradient norm before the update, as device
    tensors. With ``cfg.grad_accum = n`` the batch is cut into ``n`` equal
    microbatches whose gradients are summed and then divided by ``n``: the
    full batch's update, with one microbatch's activations.

    The GPT runs in eval mode, without ``attn_pdrop``, ``resid_pdrop`` and
    ``resid_noise``, as the JAX package's step runs it (``deterministic``,
    ``ccvs_tpu/train/steps.py``); the reference's minGPT applies them. The
    module keeps its training mode for callers that want them.

    ``mesh`` (``parallel/mesh.py``): the batch is this rank's block of the
    global batch and the update is the global batch's. ``init_state``
    first splits the GPT over the mesh, once: with ``cfg.seq_parallel`` on
    a model axis of more than one, the tokens (``parallel/sp.py``; the
    weights may be split over that axis already, ``parallel/tp.py``, as the
    transformer trainer does), then with ``cfg.fsdp`` the parameters and
    moments over ``data`` (``parallel/fsdp.py``). The JAX package's
    ``state_shardings`` argument has no counterpart: ``mesh`` and
    ``cfg.fsdp`` say the same. The gradients are averaged over ``data``
    (FSDP's reduce-scatter averages them), a token split's summed over
    ``model``, and ``gnorm`` counts every split entry once."""
    fsdp = cfg.fsdp
    if fsdp and mesh is None:
        raise ValueError("fsdp splits the GPT over a mesh's data axis: pass mesh=")
    n_model = 1 if mesh is None else mesh["model"].size()
    sp = cfg.seq_parallel and n_model > 1
    axis = DataAxis.of(mesh)
    accum = max(1, cfg.grad_accum)
    gpt = transformer.model

    def init_state():
        if sp:
            seq_shard(mesh, gpt)
        if fsdp:
            shard_fsdp(mesh, gpt)
        return SimpleTrainState(step=0, params=transformer,
                                opt=make_transformer_optimizer(cfg, n_iter, gpt))

    def backward(loss):
        # sequence parallelism: every model rank backpropagates its share of
        # the replicated loss, and the shares are summed below
        (loss / n_model if sp else loss).backward()

    @profiling.spanned("train.step", is_root=True)
    def step(state, batch):
        model = state.params
        model.eval()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if accum == 1:
            loss, metrics = _mb_loss(model, batch)
            backward(loss)
        else:
            b = batch["code"].shape[0]
            if b % accum:
                raise ValueError(f"grad_accum={accum} must divide the batch {b}")
            n = b // accum
            parts = []
            for i in range(accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, m = _mb_loss(model, mb)
                backward(loss)
                parts.append({k: v.detach() for k, v in m.items()})
            for p in params:
                if p.grad is not None:
                    p.grad /= accum
        if accum > 1:
            metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        named = [(n, p) for n, p in gpt.named_parameters() if p.grad is not None]
        if sp:
            # each model rank holds its tokens' share of a replicated weight's
            # gradient; a tensor-split weight's is whole
            shares = [p.grad for n, p in named if tp_split(gpt, n) is None]
            reduce_grads([_local(g) for g in shares], mesh["model"].get_group(), 1)
        if axis is not None and not fsdp:
            axis.all_reduce_grads([p for _, p in named])
        if axis is not None:
            metrics = axis.mean(metrics)
        splits = None
        if mesh is not None:
            splits = [(tp_split(gpt, n)[1],) if tp_split(gpt, n) else () for n, _ in named]
        metrics["gnorm"] = global_norm([p.grad for _, p in named], splits)
        with profiling.span("train.optimizer"):
            state.opt.step()
        state.step += 1
        return state, metrics

    return init_state, step


def make_simple_step(loss_fn, make_opt, data_axis=None):
    """Generic ``(init_state, step)`` for the state-estimator trainer:
    ``loss_fn(module, batch) -> (loss, metrics)``, ``make_opt(module)`` its
    optimizer; with ``data_axis`` the gradients and metrics are averaged
    over it."""

    def init_state(module):
        return SimpleTrainState(step=0, params=module, opt=make_opt(module))

    def step(state, batch):
        model = state.params
        model.train()
        for p in model.parameters():
            p.grad = None
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_axis is not None:
            data_axis.all_reduce_grads(list(model.parameters()))
            metrics = data_axis.mean(metrics)
        state.opt.step()
        state.step += 1
        return state, metrics

    return init_state, step
