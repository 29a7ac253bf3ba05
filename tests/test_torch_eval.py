"""ccvs_tpu_torch's eval package against ccvs_tpu's, on the CPU in fp32: PSNR
and SSIM, I3D at full width (seeded filters and randomised batch-norm
statistics carried across from flax), TF "SAME" padding, the fallback
embedder, the embeddings with their 224 px resize, the Fréchet distance,
``fvd_from_videos``, LPIPS (uniform and calibrated) and ``video_metrics``.

The JAX sides run their own jitted functions; the weights go across through
``ccvs_tpu_torch/weights.py`` or a shared VGG npz. Tolerances: PSNR and SSIM
1e-9 (both fp64), the embeddings rtol / atol 1e-4 of the largest entry (fp32
convolutions summed in another order), LPIPS 1e-5 relative, FVD 1e-3
relative (a difference of covariances of a few videos, through ``sqrtm``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu.eval import fvd as jfvd
from ccvs_tpu.eval import metrics as jmet
from ccvs_tpu.nn import vgg as jvgg
from ccvs_tpu.port.npz_params import flatten_params
from ccvs_tpu_torch.eval import fvd as tfvd
from ccvs_tpu_torch.eval import metrics as tmet
from ccvs_tpu_torch.nn import vgg as tvgg
from ccvs_tpu_torch.weights import load_params
from torch_parity import fast_jit, few_threads, set_fp32

set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


# ---------------- PSNR and SSIM ----------------


@pytest.mark.parametrize("shape", [(24, 20, 3), (17, 9, 1), (16, 16)])
def test_psnr_and_ssim_match_ccvs_tpu(shape):
    rng = np.random.RandomState(sum(shape))
    a = rng.rand(*shape)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    assert abs(tmet.ssim(a, b) - jmet.ssim(a, b)) < 1e-9
    assert abs(tmet.psnr(a, b) - jmet.psnr(a, b)) < 1e-9
    assert tmet.psnr(a, a) == jmet.psnr(a, a) == math.inf
    assert abs(tmet.ssim(a, a) - 1.0) < 1e-12


# ---------------- I3D ----------------


def _i3d_variables(seed):
    """flax I3D variables at full width from a numpy seed: kernels N(0,
    1/fan_in), batch-norm scales, biases and running statistics all moved
    off their identity values, so a misplaced statistic shows."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jfvd.I3D().init(k, jnp.zeros((1, 8, 32, 32, 3))),
                            jax.random.PRNGKey(0))

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, s.shape)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, s.shape)
        else:  # bn bias and running mean
            v = rng.normal(0, 0.5 if leaf == "mean" else 0.1, s.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def i3d(tmp_path_factory):
    """The JAX I3D's variables, saved as ``export_i3d`` saves them, and the
    port's embedder of that npz."""
    variables = _i3d_variables(0)
    path = tmp_path_factory.mktemp("i3d") / "i3d.npz"
    tree = jax.tree_util.tree_map(np.asarray, variables)
    np.savez(path, variables=np.array(tree, dtype=object))
    return variables, tfvd.make_i3d_embedder(str(path), device="cpu")


@pytest.mark.parametrize("shape", [(2, 8, 32, 32, 3), (1, 7, 29, 33, 3)])
def test_i3d_matches_ccvs_tpu(i3d, shape):
    """Full width (1024-d), an even and an odd size: the "SAME" pads of
    every stride-2 conv and pool differ between them."""
    variables, embed = i3d
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    want = fast_jit(jfvd.I3D().apply)(variables, jnp.asarray(x))
    got = embed(x)
    assert got.shape == (shape[0], 1024)
    _close(got, want, 1e-4)


def test_same_padding_is_tfs():
    """The pads that TF's "SAME" gives at the protocol's shapes
    (16 x 224 x 224 clips), against the symmetric pads of ``F.conv3d``."""
    cases = [((16, 224, 224), (7, 7, 7), (2, 2, 2), [(2, 3)] * 3),  # the stem
             ((8, 112, 112), (1, 3, 3), (1, 2, 2), [(0, 0), (0, 1), (0, 1)]),
             ((8, 28, 28), (3, 3, 3), (2, 2, 2), [(0, 1)] * 3),
             ((4, 14, 14), (2, 2, 2), (2, 2, 2), [(0, 0)] * 3),
             ((4, 14, 14), (3, 3, 3), (1, 1, 1), [(1, 1)] * 3),  # branch 3's pool
             ((7, 29, 33), (7, 7, 7), (2, 2, 2), [(3, 3)] * 3),
             ((8, 28, 27), (3, 3, 3), (2, 2, 2), [(0, 1), (0, 1), (1, 1)])]
    for size, k, s, pads in cases:
        x = torch.zeros(1, 1, *size)
        got = tfvd.same_pad(x, k, s).shape[2:]
        assert tuple(got) == tuple(n + lo + hi for n, (lo, hi) in zip(size, pads)), (size, k, s)


# ---------------- fallback embedder, embeddings, FVD ----------------


@pytest.fixture(scope="module")
def fallback():
    """The JAX fallback embedder and the port's net with its variables."""
    jembed = jfvd.make_fallback_embedder()
    fn = jembed.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    net = load_params(tfvd.FallbackNet(), flatten_params(cells["variables"], dtype=None))
    return jembed, tfvd.Embedder(net, torch.device("cpu"))


def test_fallback_embedder_matches_ccvs_tpu(fallback):
    jembed, embed = fallback
    x = np.random.RandomState(2).uniform(-1, 1, (2, 5, 21, 18, 3)).astype(np.float32)
    _close(embed(x), jembed(jnp.asarray(x)), 1e-4)
    seeded = tfvd.make_fallback_embedder(seed=3, device="cpu")
    again = tfvd.make_fallback_embedder(seed=3, device="cpu")
    assert torch.equal(seeded(x), again(x)) and seeded(x).shape == (2, 256)


@pytest.mark.parametrize("size", [64, 256])
def test_embeddings_from_videos_resize_match_ccvs_tpu(fallback, size):
    """The 224 px protocol resize (bilinear; antialiased when it shrinks)
    on the embedder's device, three videos in batches of 2."""
    jembed, embed = fallback
    vids = np.random.RandomState(size).uniform(-1, 1, (3, 4, size, size, 3)).astype(np.float32)
    want = jfvd.embeddings_from_videos(vids, jembed, batch=2)
    got = tfvd.embeddings_from_videos(vids, embed, batch=2)
    assert got.shape == want.shape == (3, 256) and got.dtype == np.float32
    _close(got, want, 1e-4)


def test_frechet_distance_matches_ccvs_tpu():
    rng = np.random.RandomState(3)
    a, b = rng.randn(40, 8), rng.randn(40, 8) * 1.3 + 0.2
    assert tfvd.frechet_distance(a, b) == pytest.approx(jfvd.frechet_distance(a, b), rel=1e-12)
    assert abs(tfvd.frechet_distance(a, a)) < 1e-6


def test_fvd_from_videos_keys_chunks_and_missing_path(capsys):
    """The keys, the full-set distance and the chunk statistics against the
    JAX package's on one embedder (the colour means of each clip, so that
    ``sqrtm`` works on well-conditioned 3 x 3 covariances; the networks are
    held above); the random fallback and its warning by default; a missing
    ``i3d_npz`` raises."""
    rng = np.random.RandomState(4)
    real = rng.uniform(-1, 1, (6, 4, 16, 16, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.3, real.shape) + 0.1, -1, 1).astype(np.float32)
    for chunk in (3, 8):
        for calibrated in (False, True):
            want = jfvd.fvd_from_videos(real, fake, embed=lambda x: x.mean(axis=(1, 2, 3)),
                                        chunk=chunk, resize=None, calibrated=calibrated)
            got = tfvd.fvd_from_videos(real, fake, embed=lambda x: x.mean(dim=(1, 2, 3)),
                                       chunk=chunk, resize=None, calibrated=calibrated)
            assert got.keys() == want.keys()
            for k, v in want.items():
                if isinstance(v, float):
                    assert got[k] == pytest.approx(v, rel=1e-4), k
                else:
                    assert got[k] == v, k
    assert set(got) == {"fvd", "fallback_embedder", "fvd_chunk_note"}
    capsys.readouterr()
    out = tfvd.fvd_from_videos(real[:3], fake[:3], resize=16, device="cpu")
    assert set(out) == {"fvd_uncalibrated", "fallback_embedder"} and out["fallback_embedder"]
    assert "RANDOM embedder" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="i3d-npz"):
        tfvd.fvd_from_videos(real, fake, i3d_npz="/nonexistent/i3d.npz")
    with pytest.raises(FileNotFoundError, match="i3d-npz"):
        tfvd.make_i3d_embedder("/nonexistent/i3d.npz", device="cpu")


# ---------------- LPIPS and video_metrics ----------------


@pytest.fixture(scope="module")
def vgg_npzs(tmp_path_factory):
    """A VGG19 npz and a VGG16 npz with five ``lin`` channel weights (the
    ``export_lpips`` format), torchvision's keys, seeded He filters."""
    d = tmp_path_factory.mktemp("vgg")
    rng = np.random.RandomState(6)
    paths = {}
    for kind, arch in (("vgg19", "vgg19"), ("vgg16_lins", "vgg16")):
        arrays = {}
        for i, (op, cin, cout) in enumerate(jvgg._layer_plan(arch)):
            if op == "conv":
                arrays[f"features.{i}.weight"] = rng.normal(
                    0, (2 / (9 * cin)) ** 0.5, (cout, cin, 3, 3)).astype(np.float32)
                arrays[f"features.{i}.bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
        if kind == "vgg16_lins":
            for k, c in enumerate((64, 128, 256, 512, 512)):
                arrays[f"lin{k}"] = rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
        paths[kind] = str(d / f"{kind}.npz")
        np.savez(paths[kind], **arrays)
    return paths


@pytest.mark.parametrize("kind", ["vgg19", "vgg16_lins"])
def test_lpips_matches_ccvs_tpu(vgg_npzs, kind):
    """Two 16 px frames (enlarged to 176 px by repetition) and, uniform
    weights, a 161 px one (not enlarged). Each shape compiles a JAX VGG
    program (~6 s here); ``test_video_metrics_match_ccvs_tpu`` reuses them."""
    path = vgg_npzs[kind]
    jl = jmet._get_lpips(path)
    tl = tmet._get_lpips(path, device="cpu")
    assert tl.calibrated == jl.calibrated == (kind == "vgg16_lins")
    assert tl.arch == jl.arch == kind[:5]
    rng = np.random.RandomState(8)
    for shape in ((2, 16, 16, 3), (1, 161, 161, 3))[:2 if kind == "vgg19" else 1]:
        a = rng.uniform(-1, 1, shape).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)
        _close(tl(a, b), jl(a, b), 1e-5, what=str(shape))


def test_lpips_fallback_and_weights(vgg_npzs, capsys):
    lp = tmet.LPIPS(device="cpu")
    assert not lp.calibrated and lp.arch == "vgg19"
    assert "LPIPS uses fixed random filters" in capsys.readouterr().err
    x = np.random.RandomState(9).uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32)
    assert float(tmet.LPIPS(device="cpu")(x, -x)[0]) == float(lp(x, -x)[0]) > 0
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tmet.LPIPS("/nonexistent/vgg.npz", device="cpu")
    vgg, lins = tvgg.load_vgg_npz(vgg_npzs["vgg16_lins"])
    assert vgg.arch == "vgg16" and [t.shape[0] for t in lins] == [64, 128, 256, 512, 512]
    assert tvgg.load_vgg_npz(vgg_npzs["vgg19"])[1] is None


@pytest.mark.parametrize("per_timestep", [None, 1])
def test_video_metrics_match_ccvs_tpu(vgg_npzs, per_timestep):
    """Two clips of two frames: every frame at 16 px, with uniform and with
    calibrated weights; frame 1 alone at 161 px, uniform weights."""
    rng = np.random.RandomState(10)
    size = 16 if per_timestep is None else 161
    real = rng.uniform(0, 1, (2, 2, size, size, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.1, real.shape), 0, 1).astype(np.float32)
    kinds = ("vgg19", "vgg16_lins") if per_timestep is None else ("vgg19",)
    for kind in kinds:
        path = vgg_npzs[kind]
        want = jmet.video_metrics(real, fake, per_timestep=per_timestep, vgg_npz=path)
        got = tmet.video_metrics(real, fake, per_timestep=per_timestep, vgg_npz=path,
                                 device="cpu")
        assert got.keys() == want.keys(), kind
        assert abs(got["psnr"] - want["psnr"]) < 1e-9 and abs(got["ssim"] - want["ssim"]) < 1e-9
        key = "lpips" if kind == "vgg16_lins" else "lpips_uncalibrated"
        assert got[key] == pytest.approx(want[key], rel=1e-5)
        assert got["lpips_fallback_weights"] == want["lpips_fallback_weights"]
