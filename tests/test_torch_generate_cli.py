"""Generation from the command line and its scoring, ccvs_tpu_torch against
ccvs_tpu on the CPU: the video writers and ``save_batch`` byte for byte on
the same arrays, and ``cli.py generate`` then ``eval-all`` on a tiny
BAIR-layout set (the file names of the JAX package's ``save_batch``, its
``eval-all`` keys, PSNR and SSIM equal to its functions on the files).
The JAX side runs no CLI and compiles nothing."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ccvs_tpu import cli as jcli
from ccvs_tpu.eval import fvd as jfvd
from ccvs_tpu.eval import metrics as jmet
from ccvs_tpu.generate import VideoGenerator as JGen
from ccvs_tpu.utils import video_io as jio
from ccvs_tpu_torch import cli
from ccvs_tpu_torch.config import AutoencoderConfig, Config, DataConfig, TransformerConfig
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.utils import video_io as tio
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from torch_parity import few_threads

pytestmark = pytest.mark.usefixtures("few_threads")


def _files(root):
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_writers_match_ccvs_tpu(tmp_path):
    """AVI, GIF and PNG frames byte-equal; ``to_uint8`` equal (truncation,
    the ImageNet branch, a bf16 tensor against its fp32 values);
    ``draw_cross`` equal at a corner and inside; the AVI reads back."""
    rng = np.random.RandomState(0)
    vid = rng.uniform(-1.2, 1.2, (3, 12, 10, 3)).astype(np.float32)
    for norm in (False, True):
        np.testing.assert_array_equal(tio.to_uint8(vid, imagenet_norm=norm),
                                      jio.to_uint8(vid, imagenet_norm=norm))
    bf16 = torch.from_numpy(vid).to(torch.bfloat16)
    np.testing.assert_array_equal(tio.to_uint8(bf16), jio.to_uint8(bf16.float().numpy()))
    u8 = jio.to_uint8(vid)
    for (x, y) in ((0, 0), (4, 5), (9, 11)):
        np.testing.assert_array_equal(tio.draw_cross(u8[0], x, y), jio.draw_cross(u8[0], x, y))
    for pkg, io in (("jax", jio), ("port", tio)):
        io.write_video(str(tmp_path / pkg / "v.avi"), u8, fps=4)
        io.write_gif(str(tmp_path / pkg / "v.gif"), u8, fps=5)
        io.write_frames(str(tmp_path / pkg / "frames"), u8)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    back = tio.read_video(str(tmp_path / "port" / "v.avi"))
    assert back.shape == u8.shape
    np.testing.assert_array_equal(back, jio.read_video(str(tmp_path / "jax" / "v.avi")))
    seg = np.random.RandomState(3).randint(0, 40, (2, 4, 4))
    np.testing.assert_array_equal(tio.layout_to_uint8(seg), jio.layout_to_uint8(seg))


def test_save_batch_matches_ccvs_tpu(tmp_path):
    """real, fake and rec AVIs, the state-marked copies, the dataset's ids
    and the category suffixes: the same files, byte for byte, from the same
    arrays (the port's as tensors); the colour-mapped layouts too."""
    rng = np.random.RandomState(1)
    real = rng.uniform(-1, 1, (2, 3, 16, 16, 3)).astype(np.float32)
    out = {k: rng.uniform(-1, 1, real.shape).astype(np.float32) for k in ("fake", "rec")}
    out["state"] = rng.uniform(0, 1, (2, 3, 2)).astype(np.float32)
    out["fake_state"] = rng.uniform(0, 1.2, (2, 3, 2)).astype(np.float32)
    for kw in (dict(), dict(vid_ids=np.array([7, 123]), cats=["push", "drum"])):
        jdir, tdir = tmp_path / "jax" / str(len(kw)), tmp_path / "port" / str(len(kw))
        JGen.save_batch(None, str(jdir), 3, 2, real, out, fps=4, **kw)
        VideoGenerator.save_batch(str(tdir), 3, 2, torch.from_numpy(real),
                                  {k: torch.from_numpy(v) for k, v in out.items()}, fps=4, **kw)
        want = _files(jdir)
        assert len(want) == 10 and _files(tdir) == want
    assert "real/vid_00006.avi" in _files(tmp_path / "port" / "0")
    assert "fake_state/vid_00123_drum.avi" in _files(tmp_path / "port" / "2")
    lay = {"real_layout": rng.randint(0, 19, (2, 3, 16, 16)),
           "fake_layout": rng.normal(0, 1, (2, 3, 16, 16, 5)).astype(np.float32)}
    JGen.save_batch(None, str(tmp_path / "jl"), 0, 2, real, lay)
    VideoGenerator.save_batch(str(tmp_path / "tl"), 0, 2, torch.from_numpy(real),
                              {k: torch.from_numpy(v) for k, v in lay.items()})
    assert len(_files(tmp_path / "jl")) == 6 and _files(tmp_path / "tl") == _files(tmp_path / "jl")


def _bair_set(root, n_clips, n_frames, size, seed=0):
    """A BAIR-layout valid split of moving squares:
    ``original_frames_256/test/<clip>/<frame>.png``."""
    rng = np.random.RandomState(seed)
    for c in range(n_clips):
        d = os.path.join(root, "original_frames_256", "test", f"{c:04d}")
        os.makedirs(d)
        x0, y0 = rng.randint(0, size // 2, 2)
        color = rng.randint(64, 255, 3)
        for t in range(n_frames):
            f = np.full((size, size, 3), 32, np.uint8)
            f[y0 + t:y0 + t + size // 4, x0 + t:x0 + t + size // 4] = color
            Image.fromarray(f).save(os.path.join(d, f"{t:02d}.png"))


def _tiny_run(tmp_path):
    """A tiny config on a BAIR-layout set, its seeded autoencoder checkpoint
    (with ``config.json``) and GPT checkpoint, as the trainers write them."""
    ae = AutoencoderConfig(
        necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32,
        z_shape=(8, 8), max_dim=16, inter_p=0.5, skip_memory=2, skip_context=(1, 2))
    gpt = TransformerConfig(z_num=32, z_len=128, z_chunk=64, num_blocks=2, cond_len=64,
                            n_layer=2, n_head=2, n_embd=32, z_shape=(8, 8), top_k=1)
    data = DataConfig(dataset="bairhd", dataroot=str(tmp_path / "bair"), max_dim=16,
                      true_dim=16, vid_len=2, batch_size_vid=2, num_workers=1)
    cfg = Config(name="tiny", data=data, ae=ae, gpt=gpt, save_path=str(tmp_path))
    _bair_set(data.dataroot, 5, 3, 16)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(cfg.to_json())
    ae_dir, gpt_dir = tmp_path / "ae", tmp_path / "gpt"
    m = FrameAutoencoder(ae, dtype=torch.float32, device="cpu").init(seed=0)
    CheckpointManager(str(ae_dir)).save("qvid", 1, {"gen": m.state_dict(), "ema": m.state_dict()},
                                        latest=True)
    (ae_dir / "config.json").write_text(cfg.to_json())
    tr = TokenTransformer(gpt, dtype=torch.float32, device="cpu").init(seed=1)
    CheckpointManager(str(gpt_dir)).save("transformer", 1, {"params": tr.state_dict()},
                                         latest=True)
    return cfg, ["--load-config", str(cfg_path), "--ae-ckpt", str(ae_dir), "--gpt-ckpt",
                 str(gpt_dir)]


def test_cli_generate_then_eval_all(tmp_path, capsys):
    """``generate --device cpu`` over 2 batches (the 4 clips of 2 full
    batches; the fifth is dropped) writes what the JAX package's
    ``save_batch`` names; ``eval-all --rec`` prints the JAX package's keys
    (its FVD keys from ``fvd_from_videos``, its metrics keys from
    ``video_metrics``), with PSNR and SSIM its functions' on the files
    within 1e-9. Without ``--device`` it needs the GPU; ``--fused`` and
    multi-device flags are refused."""
    cfg, flags = _tiny_run(tmp_path)
    cli.main(["generate", *flags, "--n-batches", "2", "--device", "cpu", "--dtype", "float32"])
    results = tmp_path / "results" / "tiny"
    jdir = tmp_path / "jax_names"
    zeros = np.zeros((2, 2, 16, 16, 3), np.float32)
    for i in range(2):
        JGen.save_batch(None, str(jdir), i, 2, zeros, {"fake": zeros, "rec": zeros})
    assert sorted(_files(results)) == sorted(_files(jdir))
    assert len(_files(results)) == 12

    capsys.readouterr()
    dirs = {k: str(results / k) for k in ("real", "fake", "rec")}
    got = cli.main(["eval-all", "--real", dirs["real"], "--fake", dirs["fake"], "--rec",
                    dirs["rec"], "--chunk", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got

    class NoVGG:  # the JAX metrics' keys, without compiling its VGG
        calibrated = False

        def __call__(self, a, b):
            return np.zeros(len(a))

    real = jcli._load_dir(dirs["real"], unit=True)
    for name in ("fake", "rec"):
        other = jcli._load_dir(dirs[name], unit=True)
        want_fvd = jfvd.fvd_from_videos(real * 2 - 1, other * 2 - 1,
                                        embed=lambda x: x.mean(axis=(1, 2, 3)), chunk=2,
                                        resize=None, calibrated=False)
        orig = jmet._get_lpips
        jmet._get_lpips = lambda vgg_npz=None: NoVGG()
        try:
            want_metrics = jmet.video_metrics(real, other)
        finally:
            jmet._get_lpips = orig
        assert got[f"fvd_{name}_vs_real"].keys() == want_fvd.keys()
        metrics = got[f"metrics_{name}_vs_real"]
        assert metrics.keys() == want_metrics.keys()
        frames = [(real[i, t], other[i, t]) for i in range(len(real)) for t in range(2)]
        assert abs(metrics["psnr"] - np.mean([jmet.psnr(a, b) for a, b in frames])) < 1e-9
        assert abs(metrics["ssim"] - np.mean([jmet.ssim(a, b) for a, b in frames])) < 1e-9
    assert set(got) == {"fvd_fake_vs_real", "metrics_fake_vs_real", "fvd_rec_vs_real",
                        "metrics_rec_vs_real"}

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["eval-metrics", "--real", dirs["real"], "--fake", dirs["fake"]])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["generate", *flags, "--n-batches", "1"])
    for bad in (["--fused"], ["--n-devices", "2"], ["--model-parallel", "2"], ["--distributed"]):
        with pytest.raises(SystemExit, match="fused|parallel"):
            cli.main(["generate", *flags, "--device", "cpu", *bad])


def test_cli_generate_rec_only_and_from_image(tmp_path):
    """``--rec-only`` writes no fake clips; ``--gen-from-img --down-size``
    continues the image loader's frames, with no reconstructions."""
    cfg, flags = _tiny_run(tmp_path)
    base = ["generate", *flags, "--n-batches", "1", "--device", "cpu", "--dtype", "float32"]
    cli.main(base + ["--name", "reconly", "--rec-only"])
    res = tmp_path / "results" / "reconly"
    assert sorted(os.listdir(res)) == ["real", "rec"]
    cli.main(base + ["--name", "img", "--gen-from-img", "--down-size", "8"])
    res = tmp_path / "results" / "img"
    assert sorted(os.listdir(res)) == ["fake", "real"]
    assert sorted(os.listdir(res / "fake")) == ["vid_00000.avi", "vid_00001.avi"]
    assert tio.read_video(str(res / "fake" / "vid_00000.avi")).shape == (2, 16, 16, 3)
