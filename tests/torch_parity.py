"""Shared set-up of the ccvs_tpu_torch parity tests: small configurations of
both packages and the transfer of ccvs_tpu parameters into the port."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import config as jcfg
from ccvs_tpu.port.npz_params import flatten_params
from ccvs_tpu_torch import config as tcfg
from ccvs_tpu_torch.weights import load_params

# four resolutions: the finest runs the stride-2 correlation, the two coarsest
# the 1x1 projection before it (feature width > 16)
AE = jcfg.AutoencoderConfig(
    necf=16, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64, z_shape=(4, 4), max_dim=32,
    inter_p=0.75, skip_memory=3, skip_context=(1, 2, 3),
)
GPT = jcfg.TransformerConfig(
    z_num=64, z_len=48, z_chunk=16, num_blocks=3, cond_len=16, n_layer=2, n_head=4,
    n_embd=64, z_shape=(4, 4), emb_mode="temporal", top_k=1,
)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# trained Kinetics-600 weights (trees ae_gen and gpt) and their config: 64 px,
# 16384 codes, skip_memory 4, GPT 8 x 512 with cond_len 320
KINETICS_NPZ = os.path.join(REPO, "runs_r5", "mid_weights_kinetics_fp16.npz")
KINETICS_CONFIG = os.path.join(REPO, "runs_r5", "r5_kinetics_eval_config.json")


def kinetics_trained():
    """The ccvs_tpu config of the trained Kinetics-600 weights and the npz's
    path; skips the test where the npz is absent (it is kept out of copies
    of the repo that leave the weights behind)."""
    if not os.path.exists(KINETICS_NPZ):
        pytest.skip(f"trained weights {os.path.relpath(KINETICS_NPZ, REPO)} not present")
    return jcfg.Config.load(KINETICS_CONFIG), KINETICS_NPZ


def smooth_clip(batch, frames, size, seed=0):
    """A clip of drifting colour gratings in [-1, 1], ``(B, T, size, size, 3)``
    fp32: smooth content with motion, nearer to a video than uniform noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    vid = np.zeros((batch, frames, size, size, 3), np.float32)
    for b in range(batch):
        for c in range(3):
            fx, fy, phase, speed = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6.3), \
                rng.uniform(-1, 1)
            for t in range(frames):
                vid[b, t, :, :, c] = 0.8 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase + t * speed)
    return vid


def port_config(cfg):
    """The port's counterpart of a ccvs_tpu config dataclass (shared fields)."""
    cls = {jcfg.AutoencoderConfig: tcfg.AutoencoderConfig,
           jcfg.TransformerConfig: tcfg.TransformerConfig,
           jcfg.StateConfig: tcfg.StateConfig,
           jcfg.StftConfig: tcfg.StftConfig,
           jcfg.DataConfig: tcfg.DataConfig}[type(cfg)]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                  if f.name in names})


def load_into(module, params):
    """Copy a ccvs_tpu param tree (fp32) into a port module."""
    return load_params(module, flatten_params(params, dtype=None))


def _leaf_value(path, shape, rng):
    names = [str(getattr(k, "key", k)) for k in path]
    leaf, where = names[-1], "/".join(names)
    if leaf == "embedding" and "quantizer" in where:
        return rng.uniform(-1.0 / shape[0], 1.0 / shape[0], shape)
    if leaf == "weight":  # equalized convs scale at run time
        return rng.normal(0.0, 0.02 if "upsample" in where else 1.0, shape)
    if leaf == "kernel":  # flax Dense (in, out)
        return rng.normal(0.0, shape[-2] ** -0.5, shape)
    if leaf == "scale":
        return 1.0 + rng.normal(0.0, 0.1, shape)
    return rng.normal(0.0, 0.1 if leaf in ("bias", "s_emb", "t_emb") else 1.0, shape)


def jax_params(init, seed=0):
    """A ccvs_tpu param tree of ``init``'s structure, filled from a numpy seed
    (biases and positional embeddings non-zero). Only ``init``'s shapes are
    traced: compiling a flax init costs seconds per module on the CPU."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(_leaf_value(path, s.shape, rng).astype(s.dtype)), shapes)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def set_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return jnp.float32


# XLA's CPU backend at optimization level 0 and without its expensive LLVM
# passes: the JAX references of the autoencoder's training compile in about
# two thirds of the time, and compute the same functions (rounding aside)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with :data:`FAST_COMPILE` at its first call;
    later calls must pass arguments of the same shapes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE))
        return compiled[0](*args)

    return call


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for a module's PyTorch work, then the previous
    count: the tier-1 run puts six test processes on the CPU's cores, and a
    process's default of one OpenMP thread a core oversubscribes them, which
    slows the many small operations of a small model's backward pass
    several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

