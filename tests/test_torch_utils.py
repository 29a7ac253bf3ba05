"""The port's utilities against ccvs_tpu's, on the CPU: the media half of
``utils/logging.py`` (through a ``tensorboardX`` stand-in), the asynchronous
``CheckpointManager`` (the cases of ``tests/test_checkpoint_async.py``),
``utils/profiling.py``, the weight exporters (``port/export_*.py``) on
synthetic state dicts with the sources' key names, and ``Config.async_ckpt``."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from ccvs_tpu.utils import logging as jlog
from ccvs_tpu_torch.utils import logging as tlog
from ccvs_tpu_torch.utils import profiling
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

# ---------------------------------------------------------------- logging


def test_flow_to_rgb_and_normalize_img_equal_the_jax_package_s():
    rng = np.random.RandomState(0)
    flow = (rng.randn(9, 11, 2) * 3).astype(np.float32)
    assert np.array_equal(tlog.flow_to_rgb(flow), jlog.flow_to_rgb(flow))
    assert np.array_equal(tlog.flow_to_rgb(torch.from_numpy(flow)), jlog.flow_to_rgb(flow))
    assert np.array_equal(tlog.flow_to_rgb(np.zeros((3, 3, 2), np.float32)),
                          jlog.flow_to_rgb(np.zeros((3, 3, 2), np.float32)))
    x = (rng.randn(2, 5, 5, 3) * 1.5).astype(np.float32)
    for kw in ({}, {"span": (0, 1)}, {"imagenet_norm": True}):
        assert np.array_equal(tlog.normalize_img(x, **kw), jlog.normalize_img(x, **kw))
        assert np.array_equal(tlog.normalize_img(torch.from_numpy(x), **kw),
                              jlog.normalize_img(x, **kw))


class _Writer:
    """A ``tensorboardX.SummaryWriter`` stand-in recording its calls."""

    def __init__(self, log_path):
        self.calls = []
        self.closed = False

    def add_scalar(self, tag, v, step):
        self.calls.append(("scalar", tag, v, step, {}))

    def add_image(self, tag, img, step, **kw):
        self.calls.append(("image", tag, np.array(img), step, kw))

    def add_video(self, tag, vid, step, **kw):
        self.calls.append(("video", tag, np.array(vid), step, kw))

    def close(self):
        self.closed = True


@pytest.fixture
def tensorboard_stub(monkeypatch):
    mod = types.ModuleType("tensorboardX")
    mod.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "tensorboardX", mod)


def _media(logger, as_tensor):
    rng = np.random.RandomState(1)

    def arr(*shape, scale=1.0):
        a = (rng.randn(*shape) * scale).astype(np.float32)
        return torch.from_numpy(a) if as_tensor else a

    logger.log_scalar("s", 1.5, 3)
    logger.log_img("img", arr(5, 4, 6, 3), 2, 3, normalize=True)
    logger.log_img("gray", arr(3, 4, 4, 1), 3, 4)
    logger.log_vid("vid", arr(2, 4, 6, 6, 3), 5, normalize=True, cond_frames=2)
    logger.log_flow("flow", arr(3, 5, 5, 2, scale=2.0), 2, 6)
    segs = rng.randint(0, 30, (2, 4, 4))
    logger.log_seg("seg", torch.from_numpy(segs) if as_tensor else segs, 30, 2, 7)
    logger.log_img("empty", np.zeros((0, 4, 4, 3), np.float32), 2, 8)


def test_media_calls_reach_tensorboard_as_the_jax_logger_s(tmp_path, tensorboard_stub):
    """The same media (images, a gray grid, a video with synthesized-frame
    borders, flows, segmentations), given as tensors to the port and as
    arrays to the JAX ``Logger``: the writer gets the same tags, steps,
    keyword arguments and arrays, bit for bit; ``metrics.jsonl`` gets the
    scalar; ``close`` closes the writer."""
    loggers = {}
    for name, mod, as_tensor in (("jax", jlog, False), ("port", tlog, True)):
        lg = mod.Logger(str(tmp_path / name), imagenet_norm=False, log_fps=6)
        _media(lg, as_tensor)
        loggers[name] = lg
    want, got = loggers["jax"].writer.calls, loggers["port"].writer.calls
    assert [c[:2] for c in got] == [c[:2] for c in want]
    assert [c[1] for c in got] == ["s", "img", "gray", "vid", "flow", "seg"]
    for g, w in zip(got, want):
        assert g[3] == w[3] and g[4] == w[4], g[1]
        if g[0] == "scalar":
            assert g[2] == w[2]
        else:
            assert g[2].dtype == w[2].dtype and np.array_equal(g[2], w[2]), g[1]
    writer = loggers["port"].writer
    loggers["port"].close()
    assert writer.closed
    line = json.loads(open(tmp_path / "port" / "metrics.jsonl").read().splitlines()[0])
    assert line["step"] == 3 and line["s"] == 1.5


def test_media_calls_return_without_a_writer_or_off_the_main_rank(tmp_path, tensorboard_stub):
    off = tlog.Logger(str(tmp_path / "off"), is_main=False)
    assert off.writer is None and not os.path.exists(tmp_path / "off")
    none = tlog.Logger(str(tmp_path / "none"), use_tensorboard=False)
    for lg in (off, none):
        _media(lg, True)
        lg.close()
    assert "s" in open(tmp_path / "none" / "metrics.jsonl").read()


def test_ae_trainer_logs_images_and_profiles_a_window(tmp_path, tensorboard_stub):
    """A tiny AE trainer's ``run(profile_dir=...)`` over 11 iterations: the
    ``fake_img`` / ``real_img`` grids every ``log_freq``, and a Chrome trace
    of the window from iteration 10 on (to the run's end)."""
    import dataclasses

    import torch_ranks as R
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer

    cfg = R.trainer_cfg(str(tmp_path)).replace(log_freq=5, n_iter=11)
    cfg = cfg.replace(ae=dataclasses.replace(cfg.ae, use_dv=False))
    tr = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    calls = []
    orig = tlog.Logger.log_img

    def spy(self, name, imgs, nrow, step, **kw):
        calls.append((name, step, tuple(imgs.shape)))
        return orig(self, name, imgs, nrow, step, **kw)

    tlog.Logger.log_img = spy
    try:
        tr.run(profile_dir=str(tmp_path / "prof"))
    finally:
        tlog.Logger.log_img = orig
    assert [c[:2] for c in calls] == [(f"qvid_generator/{k}_img", it) for it in (0, 5, 10)
                                      for k in ("fake", "real")]
    traces = os.listdir(tmp_path / "prof")
    assert traces == ["ae_iters_10_10.json"]
    trace = json.load(open(tmp_path / "prof" / traces[0]))
    assert trace["traceEvents"]


# ---------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace_with_step_regions(tmp_path):
    with profiling.trace(str(tmp_path), "steps") as prof:
        for step in range(2):
            with profiling.step_annotation("train", step):
                torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"train#0", "train#1"} <= names
    events = json.load(open(tmp_path / "steps.json"))["traceEvents"]
    assert any(e.get("name") == "train#1" for e in events)
    with profiling.trace(None) as none:
        assert none is None


def test_timer_reports_every_sync_every_ticks():
    t = profiling.Timer(sync_every=3)
    assert t.tick() is None and t.tick(torch.ones(2)) is None
    rate = t.tick({"loss": torch.ones(())})
    assert rate is not None and rate > 0
    assert t.tick() is None
    profiling.device_sync(torch.nn.Linear(2, 2))
    profiling.device_sync()


# ---------------------------------------------------------------- checkpoints


def _tree(val, n=64):
    return {"w": torch.full((n, n), float(val)), "b": torch.full((n,), float(val)),
            "step": int(val), "opt": {"m": torch.full((4,), float(val), dtype=torch.float64)}}


def test_async_save_copies_before_returning(tmp_path):
    """The tensors are copied to the host inside ``save``: updating them in
    place at once (as the next step does) does not reach the file."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    tree = _tree(3.0, n=256)
    ckpt.save("m", 1, tree, latest=True)
    tree["w"].fill_(9.0)
    tree["b"].add_(6.0)
    tree["opt"]["m"][:] = 9.0
    ckpt.wait()
    out = ckpt.load("m", "latest")
    assert float(out["w"].max()) == 3.0 and float(out["b"].max()) == 3.0
    assert float(out["opt"]["m"].max()) == 3.0 and out["step"] == 3


def test_async_save_of_a_module_s_state_dict(tmp_path):
    """A module's ``state_dict()`` (tensors sharing the parameters' memory),
    saved asynchronously while the parameters move on."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    lin = torch.nn.Linear(32, 32)
    want = {k: v.clone() for k, v in lin.state_dict().items()}
    ckpt.save("m", 1, lin.state_dict(), latest=True)
    with torch.no_grad():
        lin.weight.mul_(0.0)
    ckpt.wait()
    out = ckpt.load("m", "latest", target=torch.nn.Linear(32, 32))
    for k, v in out.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_async_rolling_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save("m", 1, _tree(1.0), latest=True)
    ckpt.save("m", 2, _tree(2.0), latest=True)  # joins the write in flight
    ckpt.wait()
    assert ckpt.step_of("m", "latest") == 2
    assert float(ckpt.load("m", "latest")["w"].max()) == 2.0


def test_async_rolling_never_without_a_complete_latest(tmp_path):
    """While a latest write is in flight the previous latest stays, and a
    half-written file (``*.tmp``) never resolves; once durable, one latest."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save("m", 1, _tree(1.0), latest=True)
    ckpt.wait()
    big = {"w": torch.ones(2048, 2048), "step": 2}
    ckpt.save("m", 2, big, latest=True)
    assert ckpt.step_of("m", "latest") >= 1
    ckpt.wait()
    assert ckpt.step_of("m", "latest") == 2
    assert len(ckpt._find("m", "latest")) == 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_async_load_joins_the_write_in_flight(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save("m", 5, _tree(5.0), latest=True)
    assert ckpt.load("m", "latest")["step"] == 5


def test_async_npz_mirror_after_the_durable_latest(tmp_path):
    """The fp16 npz mirror is written after each durable latest, from what
    ``extract`` gave inside ``save``; a failed write raises at the join."""
    npz = str(tmp_path / "w.npz")
    live = {"a": np.full((3,), 1.0, np.float32)}
    ckpt = CheckpointManager(str(tmp_path), async_save=True,
                             npz_mirror=(npz, lambda tree: {"gpt": live}))
    ckpt.save("m", 1, _tree(1.0), latest=True)
    live["a"][:] = 7.0
    ckpt.wait()
    with np.load(npz) as z:
        assert z["gpt/a"].dtype == np.float16 and z["gpt/a"].max() == 1.0
    bad = CheckpointManager(str(tmp_path / "bad"), async_save=True)
    bad.save("m", 1, {"x": lambda: 0}, latest=True)  # not picklable
    with pytest.raises(Exception):
        bad.wait()
    bad.wait()  # the error is raised once


def test_config_async_ckpt_and_the_cli_flag():
    """``Config.async_ckpt`` is the port's own field now: a JAX config with
    it set loads, and ``--async-ckpt`` sets it."""
    import argparse

    from ccvs_tpu import config as jcfg
    from ccvs_tpu_torch import cli
    from ccvs_tpu_torch.config import Config, JAX_ONLY_DEFAULTS

    assert "config" not in JAX_ONLY_DEFAULTS
    assert Config.from_json(jcfg.bairhd_config().replace(async_ckpt=True).to_json()).async_ckpt
    p = argparse.ArgumentParser()
    cli._add_common(p)
    args = p.parse_args(["--async-ckpt", "--fsdp", "--seq-parallel"])
    cfg = cli._config(args)
    assert cfg.async_ckpt and cfg.gpt.fsdp and cfg.gpt.seq_parallel


# ---------------------------------------------------------------- exporters


def _vgg_sd(arch, seed):
    from ccvs_tpu.nn.vgg import _layer_plan

    g = torch.Generator().manual_seed(seed)
    sd, i = {}, 0
    for kind, cin, cout in _layer_plan(arch):
        if kind == "conv":
            sd[f"features.{i}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * 0.05
            sd[f"features.{i}.bias"] = torch.randn(cout, generator=g) * 0.01
        i += 1
    sd["classifier.0.weight"] = torch.randn(8, 8, generator=g)  # left out by the tools
    return sd


@pytest.fixture
def torchvision_stub(monkeypatch):
    tv = types.ModuleType("torchvision")
    tv.models = types.SimpleNamespace(
        vgg19=lambda weights=None: types.SimpleNamespace(state_dict=lambda: _vgg_sd("vgg19", 0)),
        vgg16=lambda weights=None: types.SimpleNamespace(state_dict=lambda: _vgg_sd("vgg16", 1)))
    monkeypatch.setitem(sys.modules, "torchvision", tv)


def _npz_equal(a, b):
    with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if x[k].dtype == object:
                _tree_equal(x[k].item(), y[k].item())
            else:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        return sorted(x.files)


def _tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)


def test_export_vgg_matches_the_jax_tool(tmp_path, torchvision_stub):
    from ccvs_tpu.port import export_vgg as jexp
    from ccvs_tpu_torch.nn.vgg import load_vgg_npz
    from ccvs_tpu_torch.port import export_vgg as texp

    jexp.main(str(tmp_path / "j.npz"))
    texp.main(str(tmp_path / "t.npz"))
    keys = _npz_equal(tmp_path / "t.npz", tmp_path / "j.npz")
    assert keys and all(k.startswith("features.") for k in keys)
    vgg, lins = load_vgg_npz(str(tmp_path / "t.npz"))
    assert lins is None
    assert torch.equal(vgg.conv0.weight, _vgg_sd("vgg19", 0)["features.0.weight"])


def test_export_lpips_matches_the_jax_tool(tmp_path, torchvision_stub):
    from ccvs_tpu.port import export_lpips as jexp
    from ccvs_tpu_torch.nn.vgg import load_vgg_npz
    from ccvs_tpu_torch.port import export_lpips as texp

    g = torch.Generator().manual_seed(2)
    lin = {f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
           for k, c in enumerate((64, 128, 256, 512, 512))}
    torch.save(lin, tmp_path / "lin.pth")
    jexp.main(str(tmp_path / "lin.pth"), str(tmp_path / "j.npz"))
    texp.main(str(tmp_path / "lin.pth"), str(tmp_path / "t.npz"))
    keys = _npz_equal(tmp_path / "t.npz", tmp_path / "j.npz")
    assert {f"lin{k}" for k in range(5)} <= set(keys)
    _, lins = load_vgg_npz(str(tmp_path / "t.npz"))
    assert torch.equal(lins[4], lin["lin4.model.1.weight"].reshape(-1))
    with pytest.raises(ValueError, match="lin0..lin4"):
        texp.translate_lin({"lin0.model.1.weight": torch.ones(1, 3, 1, 1)})


def test_export_i3d_matches_the_jax_tool(tmp_path):
    """A pytorch-i3d state dict (stem, a Mixed block's branches, the logits
    head the tool drops): the same ``variables`` tree in both npz files,
    which the port's ``load_i3d`` reads."""
    from ccvs_tpu.port import export_i3d as jexp
    from ccvs_tpu_torch.eval.fvd import load_i3d
    from ccvs_tpu_torch.port import export_i3d as texp

    g = torch.Generator().manual_seed(3)
    sd = {}
    for ep, cin, cout, k in (("Conv3d_1a_7x7", 3, 8, 7), ("Mixed_3b.b0", 8, 4, 1),
                             ("Mixed_3b.b1a", 8, 4, 1), ("Mixed_3b.b1b", 4, 6, 3),
                             ("Mixed_3b.b3b", 8, 2, 1)):
        sd[f"{ep}.conv3d.weight"] = torch.randn(cout, cin, k, k, k, generator=g)
        sd[f"{ep}.bn.weight"] = torch.rand(cout, generator=g)
        sd[f"{ep}.bn.bias"] = torch.randn(cout, generator=g)
        sd[f"{ep}.bn.running_mean"] = torch.randn(cout, generator=g)
        sd[f"{ep}.bn.running_var"] = torch.rand(cout, generator=g)
        sd[f"{ep}.bn.num_batches_tracked"] = torch.tensor(5)
    sd["logits.conv3d.weight"] = torch.randn(4, 8, 1, 1, 1, generator=g)
    torch.save(sd, tmp_path / "rgb.pt")
    jexp.main(str(tmp_path / "rgb.pt"), str(tmp_path / "j.npz"))
    texp.main(str(tmp_path / "rgb.pt"), str(tmp_path / "t.npz"))
    assert _npz_equal(tmp_path / "t.npz", tmp_path / "j.npz") == ["variables"]
    flat = load_i3d(str(tmp_path / "t.npz"))
    assert np.array_equal(flat["params/Conv3d_1a/conv3d/kernel"],
                          sd["Conv3d_1a_7x7.conv3d.weight"].numpy().transpose(2, 3, 4, 1, 0))
    assert np.array_equal(flat["batch_stats/Mixed_3b/Branch_1b/bn/var"],
                          sd["Mixed_3b.b1b.bn.running_var"].numpy())
    assert not any(k.startswith("params/logits") for k in flat)


def test_fvd_points_to_the_port_s_exporter():
    """The FVD warning and docstring name ``ccvs_tpu_torch.port.export_i3d``
    and no module of ``ccvs_tpu``."""
    import re

    from ccvs_tpu_torch.eval import fvd

    for text in (fvd._UNCAL_WARNING, fvd.__doc__):
        assert "ccvs_tpu_torch.port.export_i3d" in text
        assert not re.search(r"\bccvs_tpu\.", text)
