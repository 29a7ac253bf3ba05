"""The latent stage of training in ccvs_tpu_torch against ccvs_tpu, on the CPU
in fp32: the quantizer's straight-through gradients, the state model's loss,
``TokenTransformer.loss`` in every conditioning form, AdamW steps with
optax's schedules, gradient accumulation and head finetuning, the state
step, the data copy, checkpoints and the flat-dict export, and both trainers
end to end.

The JAX sides run under ``jax.jit`` on seeded fp32 parameters
(``torch_parity.jax_params``); each form's compiled function is built once
per module.

Tolerances: losses and metrics within rtol 1e-5 (fp32 sums in another
order); gradients within rtol 1e-4 plus 1e-6 of the largest gradient entry
of the whole model (some gradients are zero but for rounding, as the key
bias's: a softmax ignores a constant added to a row's scores).
Parameters after Adam steps are held by :func:`assert_adam_close`, whose
docstring gives the reasoning."""

import copy
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ccvs_tpu import config as jcfg
from ccvs_tpu import data as jdata
from ccvs_tpu.models import StateModel as JStateModel
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.nn.quantizer import VectorQuantizer as JVQ
from ccvs_tpu.ops import vq as jvq
from ccvs_tpu.port.npz_params import flatten_params, unflatten_params
from ccvs_tpu.train import states as jstates
from ccvs_tpu.train import steps as jsteps
from ccvs_tpu_torch import data as tdata
from ccvs_tpu_torch.config import (AutoencoderConfig, Config, DataConfig, StateConfig,
                                   TransformerConfig)
from ccvs_tpu_torch.models import FrameAutoencoder, StateModel, TokenTransformer
from ccvs_tpu_torch.nn.gpt import decode_step_fn
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer
from ccvs_tpu_torch.ops import vq as tvq
from ccvs_tpu_torch.train import states as tstates
from ccvs_tpu_torch.train import steps as tsteps
from ccvs_tpu_torch.train.state_trainer import StateEstimatorTrainer
from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from ccvs_tpu_torch.weights import _translate, export_params, load_params
from torch_parity import (REPO, fast_jit, few_threads, jax_params, load_into, port_config,
                          set_fp32, to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

# three frames of 4x4 tokens fill every form's window (num_blocks 3)
BASE = jcfg.TransformerConfig(
    z_num=32, z_len=48, z_chunk=16, num_blocks=3, cond_len=16, n_layer=2, n_head=2, n_embd=32,
    z_shape=(4, 4), emb_mode="temporal", lr=1e-3)
STATE = dict(state=True, state_num=8, state_size=2)
FORMS = {
    "plain": BASE,
    "state": dataclasses.replace(BASE, z_len=54, **STATE),
    "state_front": dataclasses.replace(BASE, z_len=54, state_front=True, **STATE),
    "p2p": dataclasses.replace(BASE, p2p=True),
    "unconditional": dataclasses.replace(BASE, use_start_token=True, cond_len=0),
    "cat": dataclasses.replace(BASE, cat=True, num_lbl=5),
}
SCFG = jcfg.StateConfig(z_size=16, z_shape=(4, 4), state_hsize=8, state_size=2, state_num=8)
B = 4


def close(got, want, rtol=1e-4, rel_atol=1e-6, what="", scale=None):
    """``got`` within ``rtol`` of ``want`` plus ``rel_atol`` of ``scale``
    (default: ``want``'s largest entry)."""
    got, want = to_np(got), to_np(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel_atol * max(scale, 1e-30),
                               err_msg=what)


def largest(tensors):
    return max(float(np.abs(to_np(t)).max()) for t in tensors)


def port_grads(module, jgrads):
    """JAX gradients translated onto ``module``'s parameter names."""
    holder = load_params(copy.deepcopy(module), flatten_params(jgrads, dtype=None))
    return {n: p.detach() for n, p in holder.named_parameters()}


def assert_grads_close(module, jgrads):
    want = port_grads(module, jgrads)
    scale = largest(want.values())
    for name, p in module.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(got, want[name], what=name, scale=scale)


def assert_adam_close(got, want, start, grad, lr, steps, scale):
    """Parameters after ``steps`` Adam updates from ``start``, the port's
    (``got``) against the JAX package's (``want``). Adam divides the first
    moment by the root of the second, so an entry whose gradient is near
    zero (``grad``, the first step's, below 1e-3 of ``scale``, the model's
    largest gradient entry) moves by up to ``lr`` a step in a direction
    that rounding decides; such entries are held to ``|got - want| <= lr *
    steps``. Elsewhere the updates (``got - start`` and ``want - start``)
    agree within rtol 1e-3, plus two fp32 spacings of the parameter a step
    for the rounding of the parameters themselves."""
    got, want, start, grad = (to_np(x).astype(np.float64) for x in (got, want, start, grad))
    near_zero = np.abs(grad) <= 1e-3 * scale
    err = np.abs(got - want)
    ulps = 2 * steps * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    bound = np.where(near_zero, lr * steps, 1e-3 * np.abs(want - start) + ulps)
    worst = float((err - bound).max())
    assert worst <= 0, f"update differs by {worst:.3g} beyond its bound"


def tokens(cfg, seed, n_frames=3):
    rng = np.random.RandomState(seed)
    out = {"code": rng.randint(0, cfg.z_num, (B, n_frames * cfg.size)).astype(np.int32)}
    if cfg.state:
        out["state_code"] = rng.randint(0, cfg.state_num,
                                        (B, n_frames * cfg.state_size)).astype(np.int32)
    if cfg.p2p:
        out["cond_code"] = out["code"][:, -cfg.z_chunk:]
        out["code"] = out["code"][:, :-cfg.z_chunk]
        out["delta"] = rng.randint(0, 2, (B,)).astype(np.int32)
    if cfg.cat:
        out["vid_lbl"] = rng.randint(0, cfg.num_lbl, (B,)).astype(np.int32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def port_transformer(cfg, params):
    tr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu")
    load_into(tr.model, params)
    return tr


@pytest.fixture(scope="module")
def gpts():
    out = {}
    for i, (name, cfg) in enumerate(FORMS.items()):
        jtr = JTT(cfg, dtype=F32)
        out[name] = (jtr, jax_params(lambda k: jtr.init(k, batch=2), seed=20 + i))
    return out


# ---------------- the quantizer ----------------


def test_vq_ops_match_ccvs_tpu():
    rng = np.random.RandomState(0)
    z, z_q = rng.randn(2, 8, 4).astype(np.float32), rng.randn(2, 8, 4).astype(np.float32)
    idx = rng.randint(0, 16, (2, 8))
    close(tvq.vq_st(torch.tensor(z), torch.tensor(z_q)), jvq.vq_st(z, z_q), rtol=1e-6)
    close(tvq.vq_perplexity(torch.tensor(idx), 16), jvq.vq_perplexity(jnp.asarray(idx), 16),
          rtol=1e-6)
    want, (gz, gq) = jax.value_and_grad(lambda a, b: jvq.vq_loss(a, b, 0.25), (0, 1))(z, z_q)
    tz, tq = torch.tensor(z, requires_grad=True), torch.tensor(z_q, requires_grad=True)
    got = tvq.vq_loss(tz, tq, 0.25)
    got.backward()
    close(got, want, rtol=1e-6)
    close(tz.grad, gz)
    close(tq.grad, gq)


@pytest.mark.parametrize("n_e,e_dim,mult,normalize", [(16, 4, 1, False), (16, 8, 2, False),
                                                      (16, 4, 1, True), (8, 1, 1, False)])
def test_quantizer_gradients_match_ccvs_tpu(n_e, e_dim, mult, normalize):
    """``z``'s gradient comes through the straight-through value, the
    codebook's through the gather, and the indices carry none, as
    ``jax.grad`` of the JAX package's quantizer gives them."""
    rng = np.random.RandomState(n_e + e_dim + mult)
    z = rng.randn(3, 5, e_dim).astype(np.float32)
    w = rng.randn(3, 5, e_dim).astype(np.float32)
    jq = JVQ(n_e, e_dim, beta=0.25, mult=mult, normalize=normalize)
    params = {"embedding": jnp.asarray(rng.randn(n_e, e_dim // mult).astype(np.float32))}

    def jloss(p, z):
        z_q, loss, (perp, idx) = jq.apply({"params": p}, z)
        return jnp.sum(w * z_q) + loss, (loss, perp, idx)

    (_, (jl, jperp, jidx)), (gp, gz) = fast_jit(
        jax.value_and_grad(jloss, (0, 1), has_aux=True))(params, z)
    tq = VectorQuantizer(n_e, e_dim, beta=0.25, mult=mult, normalize=normalize)
    with torch.no_grad():
        tq.embedding.copy_(torch.tensor(np.asarray(params["embedding"])))
    tz = torch.tensor(z, requires_grad=True)
    z_q, loss, (perp, idx) = tq(tz)
    ((torch.tensor(w) * z_q).sum() + loss).backward()
    assert torch.equal(idx, torch.tensor(np.asarray(jidx)).long())
    close(loss, jl, rtol=1e-5)
    close(perp, jperp, rtol=1e-6)
    close(tz.grad, gz)
    close(tq.embedding.grad, gp["embedding"])
    # serving's value is the straight-through one, without a graph to the indices
    sq, sidx = tq.quantize(tz)
    assert torch.equal(sq, z_q) and torch.equal(sidx, idx)


def test_vq_indices_of_a_tensor_under_autograd_carry_no_graph():
    z = torch.randn(6, 4, requires_grad=True)
    cb = torch.randn(8, 4, requires_grad=True)
    idx = tvq.vq_indices(z, cb)
    assert idx.grad_fn is None and not idx.requires_grad
    assert torch.equal(idx, tvq.vq_indices_plain(z.detach(), cb.detach()))


def test_state_model_loss_matches_ccvs_tpu():
    jsm = JStateModel(SCFG)
    params = jax_params(jsm.init, seed=3)
    params["quantizer"]["embedding"] = jnp.asarray(
        np.random.RandomState(4).uniform(0, 1, (SCFG.state_num, 1)).astype(np.float32))
    rng = np.random.RandomState(5)
    z = rng.randn(6, 4, 4, 16).astype(np.float32)
    target = rng.uniform(0, 1, (6, 2)).astype(np.float32)
    (jl, jm), jg = fast_jit(jax.value_and_grad(jsm.loss, has_aux=True))(params, z, target)
    tsm = load_into(StateModel(port_config(SCFG), device="cpu"), params)
    loss, m = tsm.loss(torch.tensor(z), torch.tensor(target))
    loss.backward()
    close(loss, jl, rtol=1e-5)
    for k in ("state_reg", "state_quant", "state_perp"):
        close(m[k], jm[k], rtol=1e-5, what=k)
    assert_grads_close(tsm, jg)
    assert float(tsm.quantizer.embedding.grad.abs().max()) > 0


# ---------------- the transformer loss ----------------


@pytest.mark.parametrize("form", list(FORMS))
def test_transformer_loss_and_gradients_match_ccvs_tpu(gpts, form):
    cfg = FORMS[form]
    jtr, params = gpts[form]
    batch = tokens(cfg, seed=7)

    def jloss(p, b):
        return jtr.loss(p, b["code"], state_code=b.get("state_code"),
                        cond_code=b.get("cond_code"), delta=b.get("delta"), lbl=b.get("vid_lbl"))

    (jl, jm), jg = fast_jit(jax.value_and_grad(jloss, has_aux=True))(params, jax_batch(batch))
    tr = port_transformer(cfg, params)
    b = torch_batch(batch)
    loss, m = tr.loss(b["code"], state_code=b.get("state_code"), cond_code=b.get("cond_code"),
                      delta=b.get("delta"), lbl=b.get("vid_lbl"))
    loss.backward()
    assert set(m) == set(jm)
    close(loss, jl, rtol=1e-5)
    for k in m:
        close(m[k], jm[k], rtol=1e-5, what=k)
    assert_grads_close(tr.model, jg)


def test_fp32_master_weights_under_bf16_compute():
    """With bf16 compute, fp32 parameters take AdamW's ~lr steps; bf16
    parameters at the init scale (spacing ~1.2e-4 near 0.02) swallow most
    of them. Serving's bf16 model keeps bf16 parameters."""
    cfg = port_config(dataclasses.replace(BASE, lr=1e-5))
    batch = torch_batch(tokens(BASE, seed=8))
    moved = {}
    for pdt in (torch.float32, torch.bfloat16):
        tr = TokenTransformer(cfg, dtype=torch.bfloat16, device="cpu", param_dtype=pdt).init(0)
        w0 = tr.model.core.blocks[0].fc1.weight.detach().clone()
        init, step = tsteps.make_transformer_step(tr, cfg, 10)
        state = init()
        for _ in range(2):  # the first update has lr 0
            state, m = step(state, batch)
        assert m["nll"].dtype == torch.float32 and torch.isfinite(m["gnorm"])
        moved[pdt] = float((tr.model.core.blocks[0].fc1.weight != w0).float().mean())
    assert moved[torch.float32] > 0.99, moved
    assert moved[torch.bfloat16] < 0.5, moved
    serve = TokenTransformer(cfg, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for n, p in serve.named_parameters() if "ln_f" not in n} == {torch.bfloat16}


# ---------------- the transformer step ----------------


STEP_FORMS = {
    "constant": dict(),
    "cosine": dict(lr_decay=True),
    "grad_accum": dict(grad_accum=2),
    "finetune_frozen": dict(finetune_head=True, finetune_f=None),
    "finetune_0.1": dict(finetune_head=True, finetune_f=0.1),
    # the JAX step runs the GPT deterministic: dropout does not act in it
    "resid_pdrop_0.1": dict(resid_pdrop=0.1, attn_pdrop=0.1),
}
N_ITER = 4


@pytest.mark.parametrize("form", list(STEP_FORMS))
def test_transformer_step_matches_ccvs_tpu(gpts, form):
    """Three AdamW steps against ``make_transformer_step``: ``nll`` and
    ``gnorm`` each step, the parameters after each, the first update exactly
    zero (optax's schedule at count 0)."""
    cfg = dataclasses.replace(BASE, **STEP_FORMS[form])
    jtr, params = JTT(cfg, dtype=F32), gpts["plain"][1]
    jinit, jstep = jsteps.make_transformer_step(jtr, cfg, N_ITER)
    jstate = jinit(params)
    tr = port_transformer(cfg, params)
    tinit, tstep = tsteps.make_transformer_step(tr, port_config(cfg), N_ITER)
    tstate = tinit()
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    grad1 = None
    for i in range(3):
        batch = tokens(cfg, seed=30 + i)
        jstate, jm = jstep(jstate, jax_batch(batch))
        tstate, tm = tstep(tstate, torch_batch(batch))
        assert tstate.step == int(jstate.step) == i + 1
        close(tm["nll"], jm["nll"], rtol=1e-5, what=f"nll {i}")
        close(tm["gnorm"], jm["gnorm"], rtol=1e-5, what=f"gnorm {i}")
        if i == 0:
            grad1 = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
            scale = largest(grad1.values())
            for n, p in tr.model.named_parameters():
                assert torch.equal(p, start[n]), f"{n} moved at lr 0"
        want = port_grads(tr.model, jstate.params)
        for n, p in tr.model.named_parameters():
            assert_adam_close(p, want[n], start[n], grad1[n], cfg.lr, i + 1, scale)
    if cfg.finetune_head and cfg.finetune_f is None:
        for n, p in tr.model.named_parameters():
            assert torch.equal(p, start[n]) == (n != "head.weight"), n


def test_grad_accum_gives_the_full_batch_update(gpts):
    params = gpts["plain"][1]
    batch = torch_batch(tokens(BASE, seed=40))
    out = {}
    for accum in (1, 2):
        cfg = port_config(dataclasses.replace(BASE, grad_accum=accum))
        tr = port_transformer(BASE, params)
        init, step = tsteps.make_transformer_step(tr, cfg, N_ITER)
        state = init()
        for i in range(2):
            state, m = step(state, batch)
            if i == 0:
                grad1 = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
        out[accum] = m, {n: p.detach() for n, p in tr.model.named_parameters()}, grad1
    for k in ("nll", "gnorm"):
        close(out[2][0][k], out[1][0][k], rtol=1e-5, what=k)
    start = {n: p.detach() for n, p in port_transformer(BASE, params).model.named_parameters()}
    grad1 = out[1][2]
    scale = largest(grad1.values())
    for n, p in out[1][1].items():
        assert_adam_close(out[2][1][n], p, start[n], grad1[n], BASE.lr, 1, scale)


def test_decay_mask_matches_ccvs_tpu(gpts):
    """The decayed parameters are the JAX mask's ``True`` leaves (Dense
    kernels, ``states.py:75-78``), name for name through the weight
    translation."""
    for form in ("state", "unconditional", "cat"):
        params = gpts[form][1]
        jmask = jax.tree_util.tree_map_with_path(
            lambda path, _: getattr(path[-1], "key", None) == "kernel", params)
        tr = port_transformer(FORMS[form], params)
        targets = dict(tr.model.named_parameters())
        values = flatten_params(params, dtype=None)
        want = {name for key, on in flatten_params(jmask, dtype=None).items() if on
                for name, _ in _translate(key, values[key], targets)}
        assert tstates.decay_mask(tr.model) == want
        assert "head.weight" in want and not any("emb" in n for n in want)


def test_schedules_match_optax():
    import optax

    for sched, want in ((tstates.linear_schedule(0.0, 1e-3, 3), optax.linear_schedule(0.0, 1e-3, 3)),
                        (tstates.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10),
                         optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10))):
        for count in range(12):
            # optax computes in fp32
            assert sched(count) == pytest.approx(float(want(count)), rel=1e-5, abs=1e-12)
    assert tstates.linear_schedule(0.0, 1e-3, 1)(0) == 0.0


# ---------------- dropout, residual noise, remat ----------------


def test_dropout_and_noise_act_only_in_training_mode(gpts):
    params = gpts["plain"][1]
    noisy = port_config(dataclasses.replace(BASE, attn_pdrop=0.3, resid_pdrop=0.3,
                                            resid_noise=True))
    tr = TokenTransformer(noisy, dtype=torch.float32, device="cpu")
    flat = flatten_params(params, dtype=None)
    flat["core/blocks/block/noise_weight"] = np.full((BASE.n_layer, 1), 0.5, np.float32)
    load_params(tr.model, flat)
    ref = port_transformer(BASE, params)
    code = torch_batch(tokens(BASE, seed=9))["code"][:, :-1]
    assert not tr.training
    assert torch.equal(tr.model(code), ref.model(code))
    tr.train()
    g = torch.Generator().manual_seed(0)
    a = tr.model(code, generator=g)
    b = tr.model(code, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert float((a - ref.model(code)).abs().max()) > 1e-2
    assert float((tr.model(code, generator=g) - a).abs().max()) > 1e-2


@pytest.mark.parametrize("draws", [False, True])
def test_remat_gives_the_same_gradients(gpts, draws):
    params = gpts["plain"][1]
    extra = dict(attn_pdrop=0.2, resid_pdrop=0.2) if draws else {}
    grads = {}
    for remat in (False, True):
        cfg = port_config(dataclasses.replace(BASE, remat=remat, **extra))
        tr = TokenTransformer(cfg, dtype=torch.float32, device="cpu")
        load_into(tr.model, params)
        tr.train()
        g = torch.Generator().manual_seed(1)
        loss, _ = tr.loss(torch_batch(tokens(BASE, seed=11))["code"], generator=g)
        loss.backward()
        # the generator leaves the step where the forward left it
        grads[remat] = {n: p.grad for n, p in tr.model.named_parameters()}, g.get_state()
    assert torch.equal(grads[False][1], grads[True][1])
    for n, gr in grads[False][0].items():
        close(grads[True][0][n], gr, rtol=1e-6, what=n)


def test_decode_step_calls_per_layer_do_not_grow():
    """The parameter-dtype repair casts only where the dtypes differ: a bf16
    decode step dispatches 82 PyTorch operations a layer on the CPU, as
    before the repair."""

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for n_layer in (1, 2):
        cfg = TransformerConfig(z_num=64, z_len=64, num_blocks=4, n_layer=n_layer, n_head=2,
                                n_embd=128, z_shape=(4, 4))
        tr = TokenTransformer(cfg, dtype=torch.bfloat16, device="cpu").init(0)
        cache = tr.model.init_cache(2, 64)
        emb = torch.zeros(2, 1, 128, dtype=torch.bfloat16)
        Count.n = 0
        with torch.no_grad(), Count():
            decode_step_fn(tr.model, emb, torch.tensor([5], dtype=torch.int32), cache)
        counts.append(Count.n)
    assert counts[1] - counts[0] == 82


# ---------------- the state step ----------------


def test_state_step_matches_ccvs_tpu():
    jsm = JStateModel(SCFG)
    params = jax_params(jsm.init, seed=12)
    params["quantizer"]["embedding"] = jnp.asarray(
        np.random.RandomState(13).uniform(0, 1, (SCFG.state_num, 1)).astype(np.float32))
    s = SCFG
    jinit, jstep = jsteps.make_simple_step(
        lambda p, b: jsm.loss(p, b["z"], b["state"]),
        jstates.make_adam(s.lr, s.beta1, s.beta2, s.weight_decay))
    jstate = jinit(params)
    tsm = load_into(StateModel(port_config(SCFG), device="cpu"), params)
    tinit, tstep = tsteps.make_simple_step(
        lambda m, b: m.loss(b["z"], b["state"]),
        lambda m: tstates.make_adam(m.parameters(), s.lr, s.beta1, s.beta2, s.weight_decay))
    tstate = tinit(tsm)
    start = {n: p.detach().clone() for n, p in tsm.named_parameters()}
    rng = np.random.RandomState(14)
    for i in range(3):
        batch = {"z": rng.randn(6, 4, 4, 16).astype(np.float32),
                 "state": rng.uniform(0, 1, (6, 2)).astype(np.float32)}
        jstate, jm = jstep(jstate, jax_batch(batch))
        tstate, tm = tstep(tstate, {k: torch.tensor(v) for k, v in batch.items()})
        if i == 0:
            grad1 = {n: p.grad.clone() for n, p in tsm.named_parameters()}
            scale = largest(grad1.values())
        for k in jm:
            close(tm[k], jm[k], rtol=1e-5, what=f"{k} {i}")
        want = port_grads(tsm, jstate.params)
        for n, p in tsm.named_parameters():
            assert_adam_close(p, want[n], start[n], grad1[n], s.lr, i + 1, scale)


# ---------------- data, checkpoints, export ----------------


DATA = jcfg.DataConfig(dataset="synthetic", max_dim=16, true_dim=32, vid_len=3,
                       batch_size_img=4, batch_size_vid=2, n_consecutive_img=2, img_out_of_n=8,
                       load_elastic_view=True, elastic_corruption=True, elastic_alpha=1.0,
                       elastic_sigma=0.2, distort_first=True, num_workers=2, load_state=True)


@pytest.mark.parametrize("load_vid,over", [(True, {}), (False, {}),
                                           (False, dict(n_consecutive_img=1,
                                                        load_elastic_view=False))])
def test_dataset_copy_gives_the_same_arrays(load_vid, over):
    dcfg = dataclasses.replace(DATA, **over)
    jds = jdata.create_dataset(dcfg, phase="valid", load_vid=load_vid)
    tds = tdata.create_dataset(port_config(dcfg), phase="valid", load_vid=load_vid)
    assert len(jds) == len(tds)
    for i in (0, 5):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    jl = jdata.PrefetchLoader(jds, 4, shuffle=False, num_workers=2, host_shard=None)
    tl = tdata.PrefetchLoader(tds, 4, shuffle=False, num_workers=2, host_shard=None)
    a, b = next(iter(jl)), next(iter(tl))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_checkpoint_manager_round_trip_and_resolution(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    for step in (2, 4):
        ck.save("m", step, {"step": step, "w": torch.full((3,), float(step))}, latest=True)
    ck.save("m", 3, {"step": 3, "w": torch.zeros(3)}, best=True)
    ck.save("m", 5, {"step": 5, "w": torch.ones(3)})
    assert sorted(os.listdir(tmp_path)) == ["m_00000005.pt", "m_best_00000003.pt",
                                            "m_latest_00000004.pt"]
    assert ck.load("m", "latest")["step"] == 4 and ck.step_of("m") == 4
    assert ck.load("m", "best")["step"] == 3
    assert torch.equal(ck.load("m", 5)["w"], torch.ones(3))
    ck.record_best("m", 3, 0.25)
    assert ck.best_metric("m") == 0.25 and ck.best_metric("x") == float("inf")
    with pytest.raises(FileNotFoundError):
        ck.load("x", "latest")


def test_gpt_export_loads_into_ccvs_tpu(gpts):
    """The port's flat-dict export rebuilds the JAX package's tree
    (``unflatten_params``), and ``GPT.apply`` on it gives the port's logits
    within 1e-5."""
    for form in ("state", "p2p", "cat"):
        cfg = FORMS[form]
        jtr, params = gpts[form]
        tr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu").init(seed=3)
        flat = export_params(tr.model)
        want = flatten_params(params, dtype=None)
        assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in want.items()}
        tree = jax.tree_util.tree_map(jnp.asarray, unflatten_params(flat))
        b = tokens(cfg, seed=15)
        kw = {k: b[k] for k in ("state_code", "cond_code", "delta") if k in b}
        if cfg.cat:
            kw["lbl"] = b["vid_lbl"]
        jl = fast_jit(lambda p, c, kw: jtr.model.apply({"params": p}, c, **kw))(
            tree, b["code"], {k: jnp.asarray(v) for k, v in kw.items()})
        tk = {k: torch.as_tensor(v).long() for k, v in kw.items()}
        with torch.no_grad():
            tl = tr.model(torch.as_tensor(b["code"]).long(), **tk)
        close(tl, jl, rtol=1e-5, rel_atol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_mirror_keys_are_ccvs_tpu_keys():
    """``chip_smoke.py`` (on a machine without JAX) checks the trainer's npz
    mirror against a committed key list; that list is the JAX package's
    tree of the same configuration."""
    cs = _chip_smoke()
    jtr = JTT(port_config_back(cs.small_train_config().gpt), dtype=F32)
    shapes = jax.eval_shape(lambda k: jtr.init(k, batch=1), jax.random.PRNGKey(0))
    want = flatten_params(jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes),
                          dtype=None)
    assert {k: tuple(v.shape) for k, v in want.items()} == cs.MIRROR_KEYS


def port_config_back(cfg):
    """The ccvs_tpu TransformerConfig of a port's one (shared fields)."""
    names = {f.name for f in dataclasses.fields(jcfg.TransformerConfig)}
    return jcfg.TransformerConfig(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg) if f.name in names})


# ---------------- the trainers ----------------


def _train_config(tmp_path):
    ae = AutoencoderConfig(necf=8, necf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
                           max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3))
    gpt = TransformerConfig(z_num=32, z_len=32, z_chunk=16, num_blocks=2, cond_len=16, n_layer=2,
                            n_head=2, n_embd=32, z_shape=(4, 4), lr=1e-3)
    data = DataConfig(dataset="synthetic", max_dim=8, true_dim=32, vid_len=2, batch_size_vid=2,
                      batch_size_img=4, num_workers=2, load_state=True)
    state = StateConfig(z_size=16, z_shape=(4, 4), state_hsize=8, state_size=2, state_num=8)
    return Config(name="tiny", data=data, ae=ae, gpt=gpt, state=state, save_path=str(tmp_path),
                  n_iter=3, save_latest_freq=2, log_freq=None, n_iter_eval=2,
                  npz_mirror=str(tmp_path / "mirror.npz"))


def _metrics(tmp_path, name):
    with open(tmp_path / "logs" / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_transformer_trainer_runs_and_resumes(tmp_path):
    cfg = _train_config(tmp_path)
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(seed=0)
    state = TransformerTrainer(cfg, ae, dtype=torch.float32, device="cpu").run(n_iter=3)
    assert state.step == 3
    keys = {k for d in _metrics(tmp_path, "tiny") for k in d}
    assert {"transformer/nll", "transformer/gnorm"} <= keys
    ck = CheckpointManager(str(tmp_path / "checkpoints" / "tiny"))
    assert ck.step_of("transformer") == 3
    saved = ck.load("transformer", "latest")
    assert saved["step"] == 3 and saved["opt"]["count"] == 3
    with np.load(cfg.npz_mirror) as z:
        assert set(z.files) == {"gpt/" + k for k in export_params(state.params.model)}
    trainer = TransformerTrainer(cfg, ae, dtype=torch.float32, device="cpu")
    resumed = trainer.run(n_iter=5, resume=True)
    assert resumed.step == 5 and not trainer.preempted
    assert max(d["step"] for d in _metrics(tmp_path, "tiny")) == 4
    # layout conditioning builds now (tests/test_torch_layouts.py holds it)
    TransformerTrainer(cfg.replace(gpt=dataclasses.replace(cfg.gpt, layout=True)), ae,
                       device="cpu")


def test_trainer_encode_is_the_autoencoders(tmp_path):
    """The trainer's encode, the frozen encoder over ``ENCODE_FRAMES`` frames
    a pass and one nearest-code search, gives ``ae.encode``'s codes, also
    with conditioning on states (through the state model) and on a blurred
    clip."""
    from ccvs_tpu_torch.train import transformer_trainer as tt

    cfg = _train_config(tmp_path)
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(seed=0)
    vid = torch.rand(3, 15, 8, 8, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    assert 45 > tt.ENCODE_FRAMES
    want = ae.encode(vid)["code"]
    for over in ({}, dict(z_len=36, state=True, state_num=8, state_size=2),
                 dict(deblurring=True, blur_sigma=2, state_num=32, state_size=16)):
        gcfg = dataclasses.replace(cfg.gpt, **over)
        sm = StateModel(cfg.state, device="cpu").init(seed=2) if gcfg.state else None
        out = TransformerTrainer(cfg.replace(gpt=gcfg), ae, state_model=sm, device="cpu") \
            .encode_batch({"vid": vid})
        assert torch.equal(out["code"], want.reshape(3, -1))
        if gcfg.state:
            assert torch.equal(out["state_code"], sm.encode(z=ae.embed_code(want)))
        if gcfg.deblurring:
            blurred = ae.encode(tt.blur_video(vid, 2))["code"]
            assert torch.equal(out["state_code"], blurred.reshape(3, -1))


def test_transformer_trainer_checkpoints_on_sigterm(tmp_path):
    """SIGTERM during a step: the step ends, a latest checkpoint is written
    at the next iteration and the run stops with ``preempted`` set."""
    import signal

    cfg = _train_config(tmp_path).replace(n_iter=5, npz_mirror="")
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(seed=0)
    trainer = TransformerTrainer(cfg, ae, dtype=torch.float32, device="cpu")
    step = trainer.step

    def step_then_signal(state, batch):
        out = step(state, batch)
        if out[0].step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.step = step_then_signal
    state = trainer.run()
    assert trainer.preempted and state.step == 2
    ck = CheckpointManager(str(tmp_path / "checkpoints" / "tiny"))
    assert ck.step_of("transformer") == 2 and ck.load("transformer", "latest")["step"] == 2


def test_state_trainer_runs_and_resumes(tmp_path):
    cfg = _train_config(tmp_path).replace(name="st")
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(seed=0)
    state = StateEstimatorTrainer(cfg, ae, device="cpu").run(n_iter=3)
    assert state.step == 3
    keys = {k for d in _metrics(tmp_path, "st") for k in d}
    assert {"state/state_reg", "state/state_quant", "state/state_perp",
            "state/eval_mse"} <= keys
    ck = CheckpointManager(str(tmp_path / "checkpoints" / "st"))
    assert ck.step_of("state", "best") == 2 and ck.best_metric("state") < float("inf")
    trainer = StateEstimatorTrainer(cfg, ae, device="cpu")
    saved = ck.load("state", "latest")
    resumed = trainer.run(n_iter=4, resume=True)
    assert resumed.step == 4 and saved["step"] == 3
