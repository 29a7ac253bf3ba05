"""ccvs_tpu_torch's CUDA kernels against their plain PyTorch versions, on a
card (marker ``gpu``; each test skips without one).

This file imports neither JAX nor ccvs_tpu, so it runs on a GPU machine that
has only PyTorch:
``python3 -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider``.
"""

import pytest
import torch

from ccvs_tpu_torch.config import AutoencoderConfig, Config, TransformerConfig
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.ops.attention import flash_decode_attention, flash_decode_plain
from ccvs_tpu_torch.ops.vq import vq_indices, vq_indices_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", [(2048, 1024, 512), (77, 1000, 40), (2048, 16384, 256)])
def test_vq_kernel_matches_plain(cuda, n, k, d):
    """K1 on the card: indices equal to the plain version's, near-ties aside."""
    g = torch.Generator(device=cuda).manual_seed(0)
    z = torch.randn(n, d, device=cuda, generator=g)
    cb = torch.randn(k, d, device=cuda, generator=g)
    cb[k - 1] = cb[3]  # an exact tie: the smaller index wins
    z[0] = cb[3]
    before = vq_indices.launches
    idx = vq_indices(z, cb)
    assert idx.is_cuda and vq_indices.launches == before + 1
    ref = vq_indices_plain(z, cb)
    assert int(idx[0]) == 3
    diff = (idx != ref).nonzero().flatten()
    if len(diff):
        zd, cd = z[diff].double(), cb.double()
        d_k = ((zd - cd[idx[diff].long()]) ** 2).sum(1)
        d_p = ((zd - cd[ref[diff].long()]) ** 2).sum(1)
        assert bool(((d_k - d_p).abs() / d_p < 1e-5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel,tol", [(torch.bfloat16, 2**-7, 2e-2),
                                           (torch.float32, 0.0, 1e-5)])
def test_flash_decode_kernel_matches_plain(cuda, dtype, rel, tol):
    """Against the fp32 plain version: bf16 within 2e-2 and, element by
    element, within its output rounding (2^-7 relative) plus 1e-3; fp32
    within 1e-5 (the summation order)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 16, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 16, 1024, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 16, 1024, 64, device=cuda, generator=g).to(dtype)
    for pos in (0, 63, 64, 511, 1023):
        before = flash_decode_attention.launches
        out = flash_decode_attention(q, k, v, pos)
        assert out.is_cuda and out.dtype == dtype
        assert flash_decode_attention.launches == before + 1
        ref = flash_decode_plain(q.float(), k.float(), v.float(), pos)
        err = (out.float() - ref).abs()
        assert float(err.max()) <= tol
        if rel:
            assert bool((err <= rel * ref.abs() + 1e-3).all())


@pytest.mark.gpu
def test_generate_on_gpu_matches_cpu(cuda):
    """A small fp32 config, greedy: the kernels' path (GPU) against the plain
    versions' path (CPU), from the same seeded weights."""
    cfg = Config(
        ae=AutoencoderConfig(necf=16, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64,
                             z_shape=(4, 4), max_dim=32, skip_memory=3, skip_context=(1, 2, 3)),
        gpt=TransformerConfig(z_num=64, z_len=64, num_blocks=4, cond_len=16, n_layer=2,
                              n_head=2, n_embd=128, z_shape=(4, 4), top_k=1))
    vid = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    outs = {}
    for dev in ("cuda", "cpu"):
        ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device=dev).init(seed=0)
        tr = TokenTransformer(cfg.gpt, dtype=torch.float32, device=dev).init(seed=1)
        if dev == "cpu":  # the same weights as on the card
            ae.load_state_dict(outs["cuda"][1])
            tr.load_state_dict(outs["cuda"][2])
        out = VideoGenerator(cfg, ae, tr).generate(
            vid.to(dev), torch.Generator(device=dev).manual_seed(0), rec=False, n_ctx_frames=1)
        outs[dev] = (out, ae.state_dict(), tr.state_dict())
    got, want = outs["cuda"][0], outs["cpu"][0]
    assert got["fake"].is_cuda
    assert torch.equal(got["code"].cpu(), want["code"])
    assert float((got["fake"].cpu() - want["fake"]).abs().max()) <= 1e-3
