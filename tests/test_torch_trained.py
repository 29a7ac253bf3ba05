"""ccvs_tpu_torch against ccvs_tpu on the trained Kinetics-600 weights
(``runs_r5/mid_weights_kinetics_fp16.npz``), on the CPU in fp32: the encode,
the doubly-AR decode with two context frames past a full FIFO, and the GPT
logits over the context tokens and one frame. Skips where the npz is absent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.port.npz_params import unflatten_params
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.weights import load_npz
from torch_parity import (few_threads, kinetics_trained, port_config, set_fp32,  # noqa: F401
                          smooth_clip, to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")
T, N_CTX = 7, 2  # skip_memory 4: the FIFO is full from frame 4


@pytest.fixture(scope="module")
def trained():
    cfg, path = kinetics_trained()
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    j = {"ae": (JAE(cfg.ae, dtype=F32), unflatten_params(flat, "ae_gen")),
         "gpt": (JTT(cfg.gpt, dtype=F32), unflatten_params(flat, "gpt"))}
    tae = load_npz(FrameAutoencoder(port_config(cfg.ae), dtype=torch.float32, device="cpu"),
                   path, prefix="ae_gen")
    ttr = TokenTransformer(port_config(cfg.gpt), dtype=torch.float32, device="cpu")
    load_npz(ttr.model, path, prefix="gpt")
    vid = smooth_clip(1, T, cfg.ae.max_dim)
    jae, pae = j["ae"]
    code = np.array(jae.get_jit_encode()(pae, jnp.asarray(vid))["code"])
    return cfg, j, tae, ttr, vid, code


def test_trained_encode_codes_equal(trained):
    """16384 trained codes: the port's encode picks JAX's code at every
    token of the clip."""
    _, _, tae, _, vid, code = trained
    got = tae.encode(torch.from_numpy(vid))["code"]
    assert got.shape == (1, T, 64)
    np.testing.assert_array_equal(to_np(got), code)


def test_trained_decode_video_full_fifo(trained):
    """Two context frames, then five frames decoded autoregressively; from
    frame 4 all four FIFO slots are valid. Each frame within 5e-5 of JAX's
    (fp32; the convolutions sum in different orders)."""
    _, j, tae, _, vid, code = trained
    jae, pae = j["ae"]
    want = np.asarray(jae.get_jit_decode_video()(
        pae, jnp.asarray(code), jnp.asarray(vid[:, :N_CTX]), n_ctx=N_CTX, use_scan=True))
    got = to_np(tae.decode_video(torch.from_numpy(code), ctx_frames=torch.from_numpy(vid[:, :N_CTX]),
                                 n_ctx=N_CTX))
    assert got.shape == want.shape == (1, T, 64, 64, 3)
    for t in range(T):
        np.testing.assert_allclose(got[:, t], want[:, t], rtol=0, atol=5e-5, err_msg=f"frame {t}")


def test_trained_gpt_logits(trained):
    """The 320 context tokens (5 frames) and one more frame: logits within
    rtol 1e-5, atol 1e-5 of JAX's (fp32)."""
    cfg, j, _, ttr, _, code = trained
    jtr, pgpt = j["gpt"]
    n = cfg.gpt.cond_len + 64
    tokens = code.reshape(1, -1)[:, :n]
    want = np.asarray(jax.jit(jtr.model.apply)({"params": pgpt}, jnp.asarray(tokens)))
    got = to_np(ttr.model(torch.from_numpy(tokens)))
    assert got.shape == want.shape == (1, n, cfg.gpt.z_num)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
