"""The ccvs_tpu_torch serving slice end to end against ccvs_tpu, on the CPU in
fp32: encode -> greedy token generation -> doubly-AR decode, plus the
package's import isolation and device rules."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu.config import Config as JConfig
from ccvs_tpu.generate import VideoGenerator as JGen
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu_torch.config import Config
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from torch_parity import AE, GPT, jax_params, load_into, port_config, set_fp32, to_np

F32 = set_fp32()
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
