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
from ccvs_tpu_torch.models import ContinuousTransformer, FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.nn.quantized import int8_matmul
from ccvs_tpu_torch.ops.attention import flash_decode_attention, flash_decode_plain
from ccvs_tpu_torch.ops.int8_linear import Int8Linear, int8_linear_plain
from ccvs_tpu_torch.ops.vq import vq_indices, vq_indices_plain
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer
from ccvs_tpu_torch.train.steps import make_transformer_step
from ccvs_tpu_torch.utils import profiling


def launches(kernel):
    """The tracer's count of ``kernel``'s launches (``k1``, ``k2``, ``k3``)."""
    return profiling.counters().get(f"{kernel}.launches", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", [(2048, 1024, 512), (77, 1000, 40), (2048, 16384, 256),
                                   (640, 16384, 256), (128, 1024, 512), (64, 128, 1),
                                   (3072, 16384, 256), (5760, 1024, 512), (1440, 1024, 16),
                                   (128, 1024, 16), (16384, 1024, 512), (6144, 1024, 512),
                                   (192, 128, 1), (1536, 1024, 512), (1024, 1024, 512),
                                   (3072, 1024, 256)])
def test_vq_kernel_matches_plain(cuda, n, k, d):
    """K1 on the card: indices equal to the plain version's, near-ties aside.
    The shapes of the rollouts: BAIR's encode (2048) and context re-encode
    (128, also one re-encoded frame of step-by-step generation),
    Kinetics-600's (2048 and 640, and 3072 for 24 frames), the state
    quantizer's scalar codebook (depth 1, 128 codes), the drums encode of 45
    frames (5760) and its audio quantizer (depth 16, padded to 32 by the
    pre-pass; 1440 rows, and 128), a ragged one, and training's: the
    full-width BAIR step's encode of 16 clips of 16 frames (16384), the
    state step's of 96 images (6144) and its quantizer of 96 x 2 states
    (192 rows, depth 1), and the autoencoder's image G step (24 images:
    1536; with z_mult 2, 3072 rows of 256) and video G step (4 clips of 4
    frames: 1024)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    z = torch.randn(n, d, device=cuda, generator=g)
    cb = torch.randn(k, d, device=cuda, generator=g)
    cb[k - 1] = cb[3]  # an exact tie: the smaller index wins
    z[0] = cb[3]
    before = launches("k1")
    idx = vq_indices(z, cb)
    assert idx.is_cuda and launches("k1") == before + 1
    ref = vq_indices_plain(z, cb)
    assert int(idx[0]) == 3
    diff = (idx != ref).nonzero().flatten()
    if len(diff):
        zd, cd = z[diff].double(), cb.double()
        d_k = ((zd - cd[idx[diff].long()]) ** 2).sum(1)
        d_p = ((zd - cd[ref[diff].long()]) ** 2).sum(1)
        assert bool(((d_k - d_p).abs() / d_p < 1e-5).all())


@pytest.mark.gpu
def test_vq_kernel_near_tie(cuda):
    """Codes 3 and 5 differ only in the last bits of a few elements, and the
    first 128 rows lie near them (code 3 plus noise of 0.1, a distance of
    ~2.6 against ~7.7 to any other code): the kernel picks code 3 or 5, what
    the fp32 plain version picks or one no further than 1e-5 relative; the
    exact duplicate code 9 = code 3 never wins over the smaller index."""
    g = torch.Generator(device=cuda).manual_seed(3)
    z = torch.randn(256, 256, device=cuda, generator=g)
    cb = torch.randn(1024, 256, device=cuda, generator=g) * 0.1
    bits = cb[3].clone().view(torch.int32)
    bits[:8] += torch.arange(1, 9, dtype=torch.int32, device=cuda)  # 1-8 ulp
    cb[5] = bits.view(torch.float32)
    cb[9] = cb[3]
    z[:128] = cb[3] + 0.1 * torch.randn(128, 256, device=cuda, generator=g)
    idx = vq_indices(z, cb)
    ref = vq_indices_plain(z, cb)
    assert set(idx[:128].tolist()) <= {3, 5} and 9 not in idx.tolist()
    diff = (idx != ref).nonzero().flatten()
    if len(diff):
        zd, cd = z[diff].double(), cb.double()
        d_k = ((zd - cd[idx[diff].long()]) ** 2).sum(1)
        d_p = ((zd - cd[ref[diff].long()]) ** 2).sum(1)
        assert bool(((d_k - d_p).abs() / d_p < 1e-5).all())


@pytest.mark.gpu
def test_vq_kernel_scratch_from_wrapper(cuda, monkeypatch):
    """K1 allocates nothing itself: its pre-pass scratch (TF32 halves of z
    and the codebook, depth padded to 64, and ||e||^2 padded to 1024 codes),
    the splits' partial results and the output come from the wrapper's
    ``torch.empty`` on the card."""
    g = torch.Generator(device=cuda).manual_seed(4)
    z = torch.randn(77, 40, device=cuda, generator=g)
    cb = torch.randn(1000, 40, device=cuda, generator=g)
    vq_indices(z, cb)  # build the library outside the recording
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype, t.device.type))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    idx = vq_indices(z, cb)
    monkeypatch.undo()
    assert torch.equal(idx, vq_indices_plain(z, cb))
    shapes = [m[0] for m in made]
    assert {(2, 77, 64), (2, 1000, 64), (1024,), (77,)} <= set(shapes), shapes
    assert all(dev == "cuda" for _, _, dev in made)
    parts = [m for m in made if m[0] not in {(2, 77, 64), (2, 1000, 64), (1024,), (77,)}]
    assert sorted(str(m[1]) for m in parts) == ["torch.float32", "torch.int32"], parts


def _check_against_plain(out, q, k, v, pos, rel, tol):
    ref = flash_decode_plain(q.float(), k.float(), v.float(), pos)
    assert out.is_cuda and out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - ref).abs()
    assert float(err.max()) <= tol, (pos, float(err.max()))
    if rel:
        assert bool((err <= rel * ref.abs() + 1e-3).all()), pos


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
        before = launches("k2")
        out = flash_decode_attention(q, k, v, pos)
        assert launches("k2") == before + 1
        _check_against_plain(out, q, k, v, pos, rel, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("length", [128, 1024, 2048, 1152, 1280])
@pytest.mark.parametrize("dtype,rel,tol", [(torch.bfloat16, 2**-7, 2e-2),
                                           (torch.float32, 0.0, 1e-5)])
def test_flash_decode_kernel_device_pos(cuda, dtype, rel, tol, length):
    """``pos`` as an int32 device tensor of shape (1,) or (): one launch per
    call, the plain version's result (tolerances as above) on both sides of
    each CTA's part and at the ends, and ``pos >= L`` clamped to ``L - 1``.
    L 2048 (the layout rollout's window of 16 frames of 128 tokens) walks
    two tiles per CTA in bf16, L 1024 two in fp32; L 1152 (the
    state and unconditional caches) a full tile and a ragged one of 16 rows
    in bf16, L 1280 (the Kinetics-600 window) one of 32."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 16, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 16, length, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 16, length, 64, device=cuda, generator=g).to(dtype)
    span = length // 8
    for i, pos in enumerate((0, 1, span - 1, span, length // 2 + 3, length - 1, length, length + 5)):
        p = torch.full((1,) if i % 2 else (), pos, dtype=torch.int32, device=cuda)
        before = launches("k2")
        out = flash_decode_attention(q, k, v, p)
        assert launches("k2") == before + 1
        _check_against_plain(out, q, k, v, pos, rel, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel,tol", [(torch.bfloat16, 2**-7, 2e-2),
                                           (torch.float32, 0.0, 1e-5)])
def test_flash_decode_cuda_graph_replay(cuda, dtype, rel, tol):
    """One launch captured in a CUDA graph serves every position: the
    position tensor is rewritten between replays."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 16, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 16, 1024, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 16, 1024, 64, device=cuda, generator=g).to(dtype)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    flash_decode_attention(q, k, v, pos)  # build and configure outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode_attention(q, k, v, pos)
    before = launches("k2")
    for p in (0, 63, 511, 1023):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        _check_against_plain(out, q, k, v, p, rel, tol)
    assert launches("k2") == before  # replays do not pass the wrapper


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel,tol", [(torch.bfloat16, 2**-7, 2e-2),
                                           (torch.float32, 0.0, 1e-5)])
def test_flash_decode_after_cache_reorder(cuda, dtype, rel, tol):
    """Beam search's batch (2 clips x 4 hypotheses) after a pruning step's
    reorder, a gather of whole batch rows into a second buffer: K2 on the
    reordered caches gives the reordered rows of its output on the old ones,
    exactly, and the plain version's result, launched directly and replayed
    from a CUDA graph captured on the second buffer before the reorder."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(8, 16, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(8, 16, 1024, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(8, 16, 1024, 64, device=cuda, generator=g).to(dtype)
    k2, v2 = torch.empty_like(k), torch.empty_like(v)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    flash_decode_attention(q, k, v, pos)  # build and configure outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = flash_decode_attention(q, k2, v2, pos)
    for p, parent in ((0, [1, 1, 0, 3, 6, 4, 4, 4]), (511, [0, 2, 2, 2, 5, 7, 4, 6]),
                      (1023, [3, 2, 1, 0, 7, 7, 7, 7])):
        pos.fill_(p)
        parent = torch.tensor(parent, device=cuda)
        before = flash_decode_attention(q, k, v, pos)
        torch.index_select(k, 0, parent, out=k2)
        torch.index_select(v, 0, parent, out=v2)
        assert torch.equal(flash_decode_attention(q[parent], k2, v2, pos), before[parent])
        _check_against_plain(flash_decode_attention(q, k2, v2, pos), q, k2, v2, p, rel, tol)
        graph.replay()
        torch.cuda.synchronize()
        _check_against_plain(replayed, q, k2, v2, p, rel, tol)


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


@pytest.mark.gpu
@pytest.mark.parametrize("proposals,normalize", [(1, False), (3, True)])
def test_continuous_generate_on_gpu_matches_cpu(cuda, proposals, normalize):
    """``ContinuousTransformer.generate`` in fp32 through K2 (GPU) against
    the plain attention (CPU), from the same seeded weights: the rollout
    within 1e-4 of its largest entry, K2 once a layer a decode step."""
    cfg = TransformerConfig(z_len=128, n_layer=2, n_head=2, n_embd=128, n_in=16,
                            n_proposals=proposals)
    ct = ContinuousTransformer(cfg, dtype=torch.float32, device=cuda).init(seed=3)
    with torch.no_grad():  # non-zero positional embeddings
        ct.model.pos_emb.normal_(0.0, 0.02, generator=torch.Generator(device=cuda).manual_seed(4))
    code = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(5))
    before = launches("k2")
    got = ct.generate(code.to(cuda), 40, normalize_pred=normalize)
    assert launches("k2") - before == 2 * (40 - 9 - 1)
    cpu = ContinuousTransformer(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in ct.state_dict().items()})
    want = cpu.generate(code, 40, normalize_pred=normalize)
    assert got.is_cuda and got.shape == want.shape == (2, 40, 16)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.gpu
def test_layout_generate_on_gpu_matches_cpu(cuda):
    """Layout-conditioned generation, greedy, from the same seeded weights:
    the layout codebook's search (K1, 4 launches: the clip's and its
    layouts' encodes, the context frame's and its layout's re-encodes) and
    K2 with layout tokens as the control stream (2 layers x 2 frames of 16
    frame and 16 layout tokens) on the card; tokens, layout tokens and the
    decoded layouts equal to the CPU's, frames within 1e-3."""
    cfg = Config(
        ae=AutoencoderConfig(necf=8, necf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
                             max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3),
                             use_layout=True, layout_size=2, same_decoder_layout=True),
        gpt=TransformerConfig(z_num=32, z_len=96, z_chunk=32, num_blocks=3, cond_len=16,
                              n_layer=2, n_head=2, n_embd=128, z_shape=(4, 4), top_k=1,
                              top_k_state=1, sample_state=True, layout=True, state_num=32,
                              state_size=16))
    g = torch.Generator().manual_seed(5)
    vid = torch.rand(2, 3, 8, 8, 3, generator=g) * 2 - 1
    lay = (vid.mean(-1) > 0).long()
    outs = {}
    for dev in ("cpu", "cuda"):
        ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device=dev)
        tr = TokenTransformer(cfg.gpt, dtype=torch.float32, device=dev)
        if dev == "cpu":
            ae.init(seed=0)
            tr.init(seed=1)
        else:  # the CPU's weights
            ae.load_state_dict(outs["cpu"][1])
            tr.load_state_dict(outs["cpu"][2])
        k1, k2 = launches("k1"), launches("k2")
        out = VideoGenerator(cfg, ae, tr).generate(
            vid.to(dev), torch.Generator(device=dev).manual_seed(0), rec=False,
            layout=lay.to(dev))
        outs[dev] = (out, ae.state_dict(), tr.state_dict(),
                     (launches("k1") - k1, launches("k2") - k2))
    got, want = outs["cuda"][0], outs["cpu"][0]
    assert outs["cuda"][3] == (4, 2 * 2 * 32)
    for k in ("code", "state_code", "fake_layout"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert float((got["fake"].cpu() - want["fake"]).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inner,out", [(2, 1024, 1024), (2, 4096, 1024), (2, 1024, 16384),
                                            (32, 1024, 4096)])
def test_int8_matmul_on_card_is_exact(cuda, rows, inner, out):
    """The int8 product of the int8 decode step on the card (``_int_mm``,
    rows padded past 16) equals the CPU's exact one, also where sums pass
    2^24 (all 127: 127^2 x 4096 = 6.6e7)."""
    g = torch.Generator().manual_seed(5)
    x8 = torch.randint(-127, 128, (rows, inner), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (out, inner), generator=g, dtype=torch.int8)
    x8[0], w8[0] = 127, 127
    want = int8_matmul(x8, w8)
    got = int8_matmul(x8.to(cuda), w8.to(cuda))
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (rows, out)
    assert torch.equal(got.cpu(), want)
    assert int(want[0, 0]) == 127 * 127 * inner


def _int8_input(rows, inner, g):
    """x with exact halves after scaling (row 0, scale 1), a row of ones with
    one half, and past two rows an all-zero row (scale 1e-8 / 127)."""
    x = torch.randn(rows, inner, generator=g)
    x[0, :4] = torch.tensor([127.0, 0.5, 2.5, -1.5])
    x[0, 4:] = x[0, 4:].clamp(-1, 1)
    if rows > 1:
        x[1] = 1.0
        x[1, 0] = 0.5
    if rows > 2:
        x[-1] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inner,out,dtype,with_bias", [
    (2, 1024, 1024, torch.float32, True), (2, 1024, 4096, torch.float32, True),
    (2, 4096, 1024, torch.float32, True), (2, 1024, 1024, torch.bfloat16, True),
    (2, 1024, 16384, torch.float32, False), (11, 1024, 512, torch.float32, True),
    (1, 1024, 1024, torch.float32, True), (8, 1024, 4096, torch.float32, True),
    (16, 1024, 4096, torch.float32, True), (16, 4096, 1024, torch.float32, True),
    (16, 1024, 1024, torch.bfloat16, True), (17, 1024, 1024, torch.float32, True)])
def test_int8_linear_kernel_matches_plain(cuda, rows, inner, out, dtype, with_bias):
    """K3 on the card bit-equal to its plain version on the CPU: the decode
    step's products (q/k/v/proj, fc1, fc2, the bf16 attention output into
    proj, the head), exact halves in x, an odd sum past 2^24, an all-zero
    row, 1, 8, 11 and 16 rows in one launch (fc2 at 16 rows holds 64 KB of
    int8 x, past the 48 KB of static shared memory) and 17 in two."""
    g = torch.Generator().manual_seed(7)
    x = _int8_input(rows, inner, g).to(dtype)
    w8 = torch.randint(-127, 128, (out, inner), generator=g, dtype=torch.int8)
    w8[0] = 127
    scale = torch.rand(out, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(out, generator=g).to(dtype) if with_bias else None
    want = int8_linear_plain(x, w8, scale, bias)
    lin = Int8Linear([w8.to(cuda)], [scale.to(cuda)], [None if bias is None else bias.to(cuda)])
    before = launches("k3")
    got = lin(x.to(cuda))
    assert launches("k3") - before == -(-rows // 16)
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == (rows, out)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inner,dtype", [(2, 1024, torch.float32),
                                              (16, 1024, torch.float32),
                                              (8, 1024, torch.bfloat16),
                                              (16, 1040, torch.float32),
                                              (2, 1040, torch.bfloat16)])
def test_int8_qkv_kernel_matches_three_plain_products(cuda, rows, inner, dtype):
    """q, k and v as one K3 launch on the same x (one quantization, three
    weights, scales, biases and outputs by pointer) bit-equal to three
    separate plain products on the CPU, with x's quantization shared by a
    cluster of 8 CTAs (width 1024) and of 4 (1040, an odd multiple of 16)."""
    g = torch.Generator().manual_seed(8)
    x = _int8_input(rows, inner, g).to(dtype)
    w8s = [torch.randint(-127, 128, (1024, inner), generator=g, dtype=torch.int8)
           for _ in range(3)]
    scales = [torch.rand(1024, generator=g) * 1e-3 + 1e-4 for _ in range(3)]
    biases = [torch.randn(1024, generator=g).to(dtype) for _ in range(3)]
    qkv = Int8Linear([w.to(cuda) for w in w8s], [s.to(cuda) for s in scales],
                     [b.to(cuda) for b in biases])
    before = launches("k3")
    got = qkv(x.to(cuda))
    assert launches("k3") - before == 1
    assert got.is_cuda and got.shape == (3, rows, 1024)
    for i in range(3):
        assert torch.equal(got[i].cpu(), int8_linear_plain(x, w8s[i], scales[i], biases[i]))


@pytest.mark.gpu
def test_int8_linear_refuses_what_the_kernel_does_not_take(cuda):
    """A CUDA x reaches K3 or raises: a weight off the 16-column grid, x on
    another device or of another width, a bad dtype; never the plain path."""
    w8 = torch.zeros(64, 1024, dtype=torch.int8, device=cuda)
    scale = torch.ones(64, device=cuda)
    lin = Int8Linear([w8], [scale], [None])
    for x in (torch.zeros(2, 512, device=cuda), torch.zeros(2, 1024, device=cuda).half(),
              torch.zeros(2, 2048, device=cuda)[:, ::2]):
        with pytest.raises(ValueError):
            lin(x)
    with pytest.raises(ValueError):
        Int8Linear([w8[:, :1000].contiguous()], [scale], [None])
    with pytest.raises(ValueError):
        Int8Linear([w8.float()], [scale], [None])
    cpu = Int8Linear([w8.cpu()], [scale.cpu()], [None])
    with pytest.raises(ValueError):
        cpu(torch.zeros(2, 1024, device=cuda))


@pytest.mark.gpu
def test_serve_int8_at_batch_16_launches_once_a_product(cuda):
    """``serve_int8`` at batch 16: one K3 launch a product (q/k/v one, proj,
    fc1, fc2 a layer, and the head) in each decode step, and greedy tokens
    equal to the CPU's from the same weights."""
    cfg = TransformerConfig(z_num=64, z_len=64, num_blocks=4, cond_len=16, n_layer=2, n_head=2,
                            n_embd=128, z_shape=(4, 4), top_k=1, serve_int8=True)
    code = torch.randint(0, 64, (16, 16), generator=torch.Generator().manual_seed(9))
    outs = {}
    for dev in ("cuda", "cpu"):
        tr = TokenTransformer(cfg, dtype=torch.float32, device=dev).init(seed=1)
        if dev == "cpu":
            tr.load_state_dict(outs["cuda"][1])
        profiling.reset()
        out = tr.generate(code.to(dev), torch.Generator(device=dev).manual_seed(0), total_len=48)
        outs[dev] = (out, tr.state_dict(), launches("k3"), launches("k2"))
    steps = outs["cuda"][3] // cfg.n_layer
    assert steps == 32 and outs["cuda"][2] == (4 * cfg.n_layer + 1) * steps
    assert outs["cpu"][2:] == (0, 0)
    assert torch.equal(outs["cuda"][0]["code"].cpu(), outs["cpu"][0]["code"])


@pytest.mark.gpu
def test_vq_gradient_contract_on_card(cuda):
    """Through K1 the quantizer gives ``z`` the straight-through gradient
    and the codebook its gradient through the gather, equal to the CPU's
    (the plain search) on the same inputs."""
    g = torch.Generator().manual_seed(4)
    z = torch.randn(192, 1, generator=g).abs()
    w = torch.randn(192, 1, generator=g)
    cb = torch.rand(128, 1, generator=g)
    grads = {}
    for dev in ("cpu", cuda):
        q = VectorQuantizer(128, 1).to(dev)
        with torch.no_grad():
            q.embedding.copy_(cb)
        zz = z.clone().to(dev).requires_grad_(True)
        before = launches("k1")
        z_q, loss, (_, idx) = q(zz)
        ((w.to(dev) * z_q).sum() + loss).backward()
        assert launches("k1") == before + (dev != "cpu")
        grads[str(dev)] = idx.cpu(), zz.grad.cpu(), q.embedding.grad.cpu()
    for a, b in zip(grads["cpu"], grads["cuda"]):
        assert torch.allclose(a.double(), b.double(), rtol=1e-6, atol=1e-9)
    assert float(grads["cuda"][2].abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1536, 1024])
def test_vq_codebook_gradient_at_ae_training_shapes(cuda, n):
    """The autoencoder's G steps quantize (n, 512) latents against 1024
    codes through K1 (n = 1536 for 24 images, 1024 for 4 clips of 4
    frames): the indices are the plain search's, and the codebook's
    gradient (the VQ loss and a weighted sum of ``z_q``) equals the plain
    search's on the CPU, within rtol 1e-5 (the gather's backward adds in
    another order on the card)."""
    g = torch.Generator().manual_seed(n)
    z = torch.randn(n, 512, generator=g)
    w = torch.randn(n, 512, generator=g)
    cb = torch.randn(1024, 512, generator=g) * 0.5
    out = {}
    for dev in ("cpu", cuda):
        q = VectorQuantizer(1024, 512).to(dev)
        with torch.no_grad():
            q.embedding.copy_(cb)
        before = launches("k1")
        z_q, loss, (_, idx) = q(z.to(dev).requires_grad_(True))
        ((w.to(dev) * z_q).sum() + loss).backward()
        assert launches("k1") == before + (dev != "cpu")
        out[str(dev)] = idx.cpu(), q.embedding.grad.cpu()
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    want = out["cpu"][1]
    assert float(want.abs().max()) > 0
    assert torch.allclose(out["cuda"][1], want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


@pytest.mark.gpu
def test_transformer_step_on_card_matches_cpu(cuda):
    """One fp32 AdamW step (the second, at lr > 0) of a small GPT on the
    card against the same step on the CPU: the loss and gradient norm within
    rtol 1e-5, the parameters within 2 lr of each other (an Adam update is
    lr * m / sqrt(v), whose sign rounding decides where the gradient is near
    zero) and within rtol 1e-3 of the CPU's update elsewhere."""
    cfg = TransformerConfig(z_num=64, z_len=64, num_blocks=4, n_layer=2, n_head=2, n_embd=128,
                            z_shape=(4, 4), lr=1e-3)
    code = torch.randint(0, 64, (4, 64), generator=torch.Generator().manual_seed(5))
    out = {}
    init_cpu = TokenTransformer(cfg, dtype=torch.float32, device="cpu").init(seed=0)
    for dev in ("cpu", cuda):
        # one set of weights for both (the two devices' generators differ)
        tr = TokenTransformer(cfg, dtype=torch.float32, device=dev)
        tr.load_state_dict(init_cpu.state_dict())
        start = {n: p.detach().clone() for n, p in tr.named_parameters()}
        init, step = make_transformer_step(tr, cfg, 10)
        state = init()
        for _ in range(2):
            state, m = step(state, {"code": code.to(dev)})
        grad = {n: p.grad.cpu() for n, p in tr.named_parameters()}
        out[str(dev)] = m, {n: p.detach().cpu() for n, p in tr.named_parameters()}, start, grad
    (mc, pc, start, grad), (mg, pg, _, _) = out["cpu"], out["cuda"]
    for k in ("nll", "gnorm"):
        assert torch.allclose(mg[k].cpu(), mc[k], rtol=1e-5), k
    scale = max(float(g.abs().max()) for g in grad.values())
    for n, p in pc.items():
        near_zero = grad[n].abs() <= 1e-3 * scale
        bound = torch.where(near_zero, torch.full_like(p, 2 * cfg.lr),
                            1e-3 * (p - start[n].cpu()).abs() + 4 * torch.finfo(p.dtype).eps * p.abs())
        assert bool(((pg[n] - p).abs() <= bound).all()), n
