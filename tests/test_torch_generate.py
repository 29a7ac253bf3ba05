"""The ccvs_tpu_torch serving slice end to end against ccvs_tpu, on the CPU in
fp32: encode -> greedy token generation -> doubly-AR decode, plus the
package's import isolation and device rules."""

import dataclasses
import glob
from functools import partial
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import config as jcfg
from ccvs_tpu.config import Config as JConfig
from ccvs_tpu.generate import VideoGenerator as JGen
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu_torch import config as tcfg
from ccvs_tpu_torch.config import Config
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from torch_parity import (AE, GPT, REPO, fast_jit, few_threads, jax_params, load_into,  # noqa: F401
                          port_config, set_fp32, to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")
T = 3  # frames: 3 x 16 tokens fill the 48-token window, as 16 x 64 fill 1024 at full size


@pytest.fixture(scope="module")
def pair():
    # serve_fused: the JAX encode and rollout each run as one compiled
    # program (same graph as the eager path, far less compile time here)
    jae = JAE(dataclasses.replace(AE, serve_fused=True), dtype=F32)
    jtr = JTT(GPT, dtype=F32)
    params = {"ae": jax_params(jae.init, seed=0),
              "gpt": jax_params(lambda k: jtr.init(k, batch=2), seed=1)}
    tae = load_into(FrameAutoencoder(port_config(AE), dtype=torch.float32, device="cpu"),
                    params["ae"])
    ttr = TokenTransformer(port_config(GPT), dtype=torch.float32, device="cpu")
    load_into(ttr.model, params["gpt"])
    return jae, jtr, params, tae, ttr


def test_generate_greedy_matches_ccvs_tpu(pair):
    """top_k=1: the sampling is greedy in both packages, so no random stream
    is involved. Tokens equal; fake and rec within 1e-3."""
    jae, jtr, params, tae, ttr = pair
    vid = np.random.RandomState(0).uniform(-1, 1, (2, T, 32, 32, 3)).astype(np.float32)
    jgen = JGen(JConfig(ae=jae.cfg, gpt=GPT), jae, jtr)
    want = jgen.generate(params, jax.random.PRNGKey(0), jnp.asarray(vid), rec=True,
                         n_ctx_frames=1)
    size = AE.tokens_per_frame
    ctx_code = jae.get_jit_encode()(params["ae"], jnp.asarray(vid))["code"].reshape(2, -1)[:, :size]
    want_code = jtr.generate(params["gpt"], jax.random.PRNGKey(0), ctx_code,
                             total_len=T * size)["code"]

    gen = VideoGenerator(Config(ae=tae.cfg, gpt=ttr.cfg), tae, ttr)
    got = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0), rec=True,
                       n_ctx_frames=1)
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(want_code))
    for key in ("fake", "rec"):
        assert got[key].shape == (2, T, 32, 32, 3)
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_ctx", [0, 1])
def test_decode_video_bucketing_invariance(pair, n_ctx, monkeypatch):
    """Each frame decodes against the last ``min(curr, M)`` FIFO slots, as
    the earlier ones are all invalid: the video equals the whole-FIFO decode."""
    _, _, _, tae, _ = pair
    codes = torch.from_numpy(np.random.RandomState(1).randint(0, AE.z_num, (2, T, 16)))
    vid = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, 1, 32, 32, 3))
                           .astype(np.float32))
    sliced = tae.decode_video(codes, ctx_frames=vid[:, :n_ctx], n_ctx=n_ctx)
    slots = []

    def whole_fifo(fifo, curr, z_t, kb=None):
        slots.append(kb)
        return FrameAutoencoder._decode_step_fn(tae, fifo, curr, z_t)

    monkeypatch.setattr(tae, "_decode_step_fn", whole_fifo)
    full = tae.decode_video(codes, ctx_frames=vid[:, :n_ctx], n_ctx=n_ctx)
    assert slots == [min(c, AE.skip_memory) for c in range(n_ctx, T)]
    np.testing.assert_allclose(to_np(sliced), to_np(full), rtol=1e-5, atol=1e-5)


def test_generate_bf16_is_finite(pair):
    """The serving dtype on the CPU: bf16 parameters (the GPT's final
    LayerNorm and the codebook fp32), finite output of the right shape."""
    _, _, _, tae, ttr = pair
    ae = FrameAutoencoder(tae.cfg, dtype=torch.bfloat16, device="cpu")
    ae.load_state_dict(tae.state_dict())
    tr = TokenTransformer(ttr.cfg, dtype=torch.bfloat16, device="cpu")
    tr.load_state_dict(ttr.state_dict())
    assert ae.decoder.block0.conv.weight.dtype == torch.bfloat16
    assert ae.quantizer.embedding.dtype == torch.float32
    assert tr.model.core.blocks[0].fc1.weight.dtype == torch.bfloat16
    assert tr.model.core.ln_f.weight.dtype == torch.float32
    vid = torch.rand(1, T, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    out = VideoGenerator(Config(ae=ae.cfg, gpt=tr.cfg), ae, tr).generate(
        vid, torch.Generator().manual_seed(0), rec=False, n_ctx_frames=1)
    assert out["fake"].shape == (1, T, 32, 32, 3) and out["fake"].dtype == torch.bfloat16
    assert bool(torch.isfinite(out["fake"]).all())


def test_bf16_decode_is_no_further_from_fp32_than_the_jax_packages_bf16(pair):
    """``decode_video`` of the same tokens and context with the same
    weights: the port's bf16 output is no further (mean absolute
    difference) from the JAX package's fp32 output than the JAX package's
    own bf16 output is, with a margin of 1.25x. The two packages round in
    different places (the port samples ``grid_sample`` in fp32 where the JAX
    package lerps in bf16, PyTorch's bf16 convolutions accumulate in fp32),
    so their bf16 errors differ by some tens of percent either way; the
    margin allows that and still fails a port that loses precision the JAX
    package keeps (a bf16 error twice the reference's)."""
    jae, _, params, tae, _ = pair
    rng = np.random.RandomState(5)
    codes = rng.randint(0, AE.z_num, (2, T, AE.tokens_per_frame))
    ctx = rng.uniform(-1, 1, (2, 1, 32, 32, 3)).astype(np.float32)
    jax_out = {}
    for dtype in (F32, jnp.bfloat16):
        decode = fast_jit(partial(JAE(AE, dtype=dtype).decode_video, n_ctx=1))
        jax_out[dtype] = np.asarray(decode(params["ae"], jnp.asarray(codes), jnp.asarray(ctx)),
                                    np.float32)
    want, jax_bf16 = jax_out[F32], jax_out[jnp.bfloat16]
    ae = FrameAutoencoder(tae.cfg, dtype=torch.bfloat16, device="cpu")
    ae.load_state_dict(tae.state_dict())
    port_bf16 = to_np(ae.decode_video(torch.from_numpy(codes), ctx_frames=torch.from_numpy(ctx),
                                      n_ctx=1).float())
    err_jax = float(np.abs(jax_bf16 - want).mean())
    err_port = float(np.abs(port_bf16 - want).mean())
    print(f"mean |bf16 - JAX fp32|: port {err_port:.3g}, JAX {err_jax:.3g}")
    assert 0 < err_jax and err_port <= 1.25 * err_jax, (err_port, err_jax)


def test_jax_only_config_fields_are_the_jax_defaults():
    """``JAX_ONLY_DEFAULTS`` names exactly the fields of ``ccvs_tpu/config.py``
    that the port's config lacks, group by group, at their JAX defaults."""
    groups = {"data": (jcfg.DataConfig, tcfg.DataConfig),
              "ae": (jcfg.AutoencoderConfig, tcfg.AutoencoderConfig),
              "gpt": (jcfg.TransformerConfig, tcfg.TransformerConfig),
              "state": (jcfg.StateConfig, tcfg.StateConfig),
              "stft": (jcfg.StftConfig, tcfg.StftConfig),
              "config": (jcfg.Config, tcfg.Config)}
    for group, (jax_cls, port_cls) in groups.items():
        have = {f.name for f in dataclasses.fields(port_cls)}
        want = {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(jax_cls) if f.name not in have}
        assert tcfg.JAX_ONLY_DEFAULTS.get(group, {}) == want, group
    assert set(tcfg.JAX_ONLY_DEFAULTS) <= set(groups)


def test_a_config_the_port_cannot_honour_raises(tmp_path):
    """A JAX ``bairhd_config`` with ``serve_fused`` set (the JAX package's
    one-jit decode) raises through ``Config.load`` and ``cli.py
    --load-config``; the JAX presets and the repository's saved eval configs
    (which drop only ``async_ckpt`` at its default) load."""
    from ccvs_tpu_torch import cli

    cfg = jcfg.bairhd_config()
    bad = cfg.replace(ae=dataclasses.replace(cfg.ae, serve_fused=True))
    path = tmp_path / "serve_fused.json"
    path.write_text(bad.to_json())
    with pytest.raises(ValueError, match="serve_fused"):
        Config.load(str(path))
    with pytest.raises(ValueError, match="serve_fused"):
        cli.main(["train-ae", "--load-config", str(path), "--device", "cpu"])
    unknown = tmp_path / "unknown.json"
    unknown.write_text(cfg.to_json().replace('"async_ckpt"', '"no_such_field"'))
    with pytest.raises(ValueError, match="no_such_field"):
        Config.load(str(unknown))
    assert Config.from_json(cfg.to_json()) == tcfg.bairhd_config()
    saved = sorted(glob.glob(os.path.join(REPO, "runs_r5", "r5_*_eval_config.json")))
    assert saved
    for f in saved:
        Config.load(f)


@pytest.mark.parametrize("preset", ["bairhd_config", "kinetics_config", "ucf101_config",
                                    "bairhd_state_config", "bairhd_p2p_config",
                                    "bairhd_unc_config", "kinetics_p2p_config",
                                    "drums_config"])
def test_presets_match_ccvs_tpu(preset):
    """The port's presets equal the JAX package's on every field the port
    has (``port_config`` keeps the shared ones); the data group whole, and
    ``PRESETS`` / ``get_config`` name the same presets."""
    want, got = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    assert got.name == want.name
    assert got.data == port_config(want.data)
    assert dataclasses.asdict(got.data) == dataclasses.asdict(want.data)
    assert got.ae == port_config(want.ae)
    assert got.gpt == port_config(want.gpt)
    assert got.state == port_config(want.state)
    assert got.stft == port_config(want.stft)
    for name in ("cat", "num_lbl", "stft", "deblurring", "blur_sigma", "no_sample",
                 "beam_size"):
        assert getattr(got.gpt, name) == getattr(want.gpt, name)
    assert tcfg.PRESETS.keys() == jcfg.PRESETS.keys()
    key = next(k for k, f in jcfg.PRESETS.items() if f is getattr(jcfg, preset))
    assert tcfg.get_config(key, name="x") == dataclasses.replace(got, name="x")


def test_port_imports_neither_jax_nor_ccvs_tpu():
    code = (
        "import importlib, pkgutil, sys, ccvs_tpu_torch\n"
        "for m in pkgutil.walk_packages(ccvs_tpu_torch.__path__, 'ccvs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ccvs_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('ccvs_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_default_to_cuda():
    """Without a device argument the models go to CUDA, and without a GPU
    that is an error, not a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameAutoencoder(port_config(AE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenTransformer(port_config(GPT))
