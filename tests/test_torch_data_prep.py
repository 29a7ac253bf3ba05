"""The port's data tools (``ccvs_tpu_torch/data/prep.py``, ``data/native.py``)
against ccvs_tpu's on the CPU: the same synthetic raw trees through both
packages' functions give byte-equal files; ``download_kinetics`` with
stand-in fetchers (nothing touches the network); the native loader built
from ``native/loader.cpp`` decodes what the JAX package's bindings decode
(skipped where ``libjpeg`` or a compiler is missing)."""

import gzip
import os
import pickle
import sys

import numpy as np
import pytest
from PIL import Image

from ccvs_tpu.data import clips as jclips
from ccvs_tpu.data import native as jnative
from ccvs_tpu.data import prep as jprep
from ccvs_tpu.utils import video_io as jvio
from ccvs_tpu_torch.data import native as tnative
from ccvs_tpu_torch.data import prep as tprep
from ccvs_tpu_torch.utils import video_io as tvio


def _tree_bytes(root):
    out = {}
    for r, _, files in os.walk(root):
        for f in files:
            p = os.path.join(r, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _raw_bairhd(root, trajs=(0, 1, 2, 3), frames=30, width=1000, height=24):
    """The softmotion layout ``preprocess_bairhd`` reads: one JPEG a frame,
    wide enough for the crop ``x[157:967]``; frame 7 of trajectory 1 left
    out (the tools skip a missing frame)."""
    rng = np.random.RandomState(0)
    for k in trajs:
        d = os.path.join(root, "softmotion_0511", "aux1", f"traj_group{k // 1000}",
                         f"traj{k}", "images")
        os.makedirs(d)
        for i in range(frames):
            if (k, i) == (1, 7):
                continue
            a = (rng.rand(height, width, 3) * 255).astype(np.uint8)
            Image.fromarray(a).save(os.path.join(d, f"aux1_full_cropped_im{i}_{k * 7 + i}.jpg"))


def test_preprocess_bairhd_writes_the_jax_package_s_files(tmp_path):
    """``preprocess_bairhd`` at dim 16 over 3 train and 1 test trajectories:
    the same PNG files, byte for byte."""
    for name in ("jax", "port"):
        _raw_bairhd(str(tmp_path / name))
    kw = dict(dim=16, num_workers=2, train_range=(0, 3), test_range=(3, 4))
    jprep.preprocess_bairhd(str(tmp_path / "jax"), **kw)
    tprep.preprocess_bairhd(str(tmp_path / "port"), **kw)
    want = _tree_bytes(tmp_path / "jax" / "original_frames_16")
    got = _tree_bytes(tmp_path / "port" / "original_frames_16")
    assert len(want) == 3 * 30 + 30 - 1 and got == want
    assert "train/00001/07.png" not in got
    frame = np.asarray(Image.open(tmp_path / "port" / "original_frames_16" / "test" / "00003" /
                                  "00.png"))
    assert frame.shape == (16, 16, 3)


def test_prep_main_runs_bairhd(tmp_path, monkeypatch):
    """``python -m ccvs_tpu_torch.data.prep bairhd ...`` calls
    ``preprocess_bairhd`` with its flags."""
    monkeypatch.setattr(tprep, "preprocess_bairhd",
                        lambda root, dim, workers: calls.append((root, dim, workers)))
    calls = []
    monkeypatch.setattr(sys, "argv", ["prep", "bairhd", "--data-root", str(tmp_path),
                                      "--dim", "32", "--num-workers", "3"])
    tprep.main()
    assert calls == [(str(tmp_path), 32, 3)]


def _clips(root, n=3):
    """Small MJPEG AVIs of 5, 9 and 13 frames (the port's writer; the same
    bytes as the JAX package's)."""
    os.makedirs(root, exist_ok=True)
    paths = []
    rng = np.random.RandomState(1)
    for v in range(n):
        frames = (rng.rand(5 + 4 * v, 20, 28, 3) * 255).astype(np.uint8)
        p = os.path.join(root, f"clip{v}.avi")
        tvio.write_video(p, frames, fps=5)
        with open(p, "rb") as f:
            jp = p + ".jax"
            jvio.write_video(jp, frames, fps=5)
            with open(jp, "rb") as g:
                assert f.read() == g.read()
        os.remove(jp)
        paths.append(p)
    return paths


def test_folds_and_metadata_match_the_jax_package(tmp_path):
    """``compute_folds``: the same fold pickles, byte for byte.
    ``compute_metadata``: the same clip index (video ids, starts, clip
    length); the gzip files differ in their header's time stamp and in the
    pickled class's module, so the indexes are compared loaded."""
    paths = _clips(str(tmp_path / "videos"))
    jprep.compute_folds(paths, str(tmp_path / "jf"), 2, seed=3)
    tprep.compute_folds(paths, str(tmp_path / "tf"), 2, seed=3)
    assert _tree_bytes(tmp_path / "tf") == _tree_bytes(tmp_path / "jf")
    with open(tmp_path / "tf" / "fold_1.pkl", "rb") as f:
        assert len(pickle.load(f)) == 1
    jprep.compute_metadata(paths, str(tmp_path / "j.pkl.gz"), clip_len=4, skip=2)
    tprep.compute_metadata(paths, str(tmp_path / "t.pkl.gz"), clip_len=4, skip=2)
    want = jclips.load_index(str(tmp_path / "j.pkl.gz"))
    with gzip.open(tmp_path / "t.pkl.gz", "rb") as f:
        got = pickle.load(f)
    assert type(got).__module__ == "ccvs_tpu_torch.data.clips"
    np.testing.assert_array_equal(got.video_ids, want.video_ids)
    np.testing.assert_array_equal(got.starts, want.starts)
    assert got.clip_len == want.clip_len == 4 and len(got) == 1 + 3 + 5


def test_preprocess_videos_and_annotate_states(tmp_path):
    """``preprocess_videos`` (resize 16, square crop, trim to 6 frames) with
    the AVI reader as the decoder, and ``annotate_states``: the same files,
    byte for byte."""
    _clips(str(tmp_path / "src" / "a"))
    kw = dict(resize=16, max_frames=6, num_workers=2)
    jprep.preprocess_videos(str(tmp_path / "src"), str(tmp_path / "jv"), jvio.read_video, **kw)
    tprep.preprocess_videos(str(tmp_path / "src"), str(tmp_path / "tv"), tvio.read_video, **kw)
    got, want = _tree_bytes(tmp_path / "tv"), _tree_bytes(tmp_path / "jv")
    assert sorted(got) == ["a/clip0.avi", "a/clip1.avi", "a/clip2.avi"] and got == want
    assert tvio.read_video(str(tmp_path / "tv" / "a" / "clip2.avi")).shape == (6, 16, 16, 3)

    frames = tmp_path / "frames"
    frames.mkdir()
    lines = []
    for i in range(3):
        p = frames / f"{i}.png"
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(p)
        lines.append(f"{p} {0.1 * i + 0.05} {0.9 - 0.2 * i}")
    states = tmp_path / "states.txt"
    states.write_text("\n".join(lines) + "\n")
    jprep.annotate_states(str(frames), str(states), str(tmp_path / "ja"), dim=64)
    tprep.annotate_states(str(frames), str(states), str(tmp_path / "ta"), dim=64)
    assert _tree_bytes(tmp_path / "ta") == _tree_bytes(tmp_path / "ja")
    assert sorted(os.listdir(tmp_path / "ta")) == ["0_3_57.png", "1_9_44.png", "2_16_32.png"]


CSV = ("label,youtube_id,time_start,time_end,split,is_cc\n"
       "jump,aaa,2,5,train,0\njump,bbb,0,3,train,0\nrun,ccc,1,2,val,0\n"
       "run,ccc,3,4,val,0\n")


def _fetchers(log):
    def fetch(vid, path):
        log.append(vid)
        with open(path, "wb") as f:
            f.write(b"trunc")
        if vid == "bbb":
            raise KeyError("unavailable")
        with open(path, "wb") as f:
            f.write(b"raw" + vid.encode())

    def trim(src, dst, start, dur):
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read() + f"|{start:g}+{dur:g}".encode())
        return True

    return fetch, trim


@pytest.mark.parametrize("trim", [True, False])
def test_download_kinetics_with_stand_in_fetchers(tmp_path, trim):
    """The CSV's clips through both packages' ``download_kinetics`` with the
    same stand-in fetcher (one video unavailable, two segments of one
    video) and trimmer: the same counts, the same files, one fetch per
    video, the scratch directory gone; a second run finds them cached."""
    csv = tmp_path / "links.csv"
    csv.write_text(CSV)
    out = {}
    for name, mod in (("jax", jprep), ("port", tprep)):
        log = []
        fetch, trim_fn = _fetchers(log)
        counts = mod.download_kinetics(str(csv), str(tmp_path / name), trim=trim, num_jobs=2,
                                       fetch_fn=fetch, trim_fn=trim_fn)
        out[name] = (counts, sorted(log), _tree_bytes(tmp_path / name))
        assert not (tmp_path / name / ".tmp_download").exists()
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"ok": 3, "failed": 1}
    assert out["port"][1] == ["aaa", "bbb", "ccc"]
    fetch, trim_fn = _fetchers([])
    again = tprep.download_kinetics(str(csv), str(tmp_path / "port"), trim=trim,
                                    fetch_fn=fetch, trim_fn=trim_fn)
    assert again == {"cached": 3, "failed": 1}


def test_download_kinetics_failed_trims_publish_nothing(tmp_path):
    """A trim that fails after a partial write, or raises, publishes no file
    and counts the clip failed (``tests/test_data.py``'s cases)."""
    csv = tmp_path / "links.csv"
    csv.write_text("label,youtube_id,time_start,time_end\njump,aaa,2,5\n")
    fetch, _ = _fetchers([])

    def bad(src, dst, start, dur):
        with open(dst, "wb") as g:
            g.write(b"PARTIAL")
        return False

    def raising(src, dst, start, dur):
        raise FileNotFoundError("ffmpeg")

    for trim_fn in (bad, raising):
        counts = tprep.download_kinetics(str(csv), str(tmp_path / "v"), trim=True,
                                         fetch_fn=fetch, trim_fn=trim_fn)
        assert counts == {"failed": 1}
        assert not (tmp_path / "v" / "jump" / "aaa_2_3.mp4").exists()
    with pytest.raises(ValueError, match="missing columns"):
        bad_csv = tmp_path / "bad.csv"
        bad_csv.write_text("label,time_start\nx,1\n")
        tprep.download_kinetics(str(bad_csv), str(tmp_path / "w"), fetch_fn=fetch)


def _need_native():
    if not tnative.available():
        pytest.skip(f"the native loader did not build here: {tnative.build_log[:200]}")
    if not jnative.available():
        pytest.skip("the JAX package's native loader is not loadable here")


def test_native_loader_is_built_from_the_source(tmp_path):
    """The port builds ``native/loader.cpp`` into its git-ignored build
    directory (never the committed binary, never ``CCVS_TPU_NATIVE_LIB``)."""
    _need_native()
    assert tnative.LIB_PATH.endswith(os.path.join("ccvs_tpu_torch", "_build",
                                                  "libccvs_loader.so"))
    assert os.path.getmtime(tnative.LIB_PATH) >= os.path.getmtime(tnative.SOURCE)
    assert tnative.build() == tnative.LIB_PATH  # up to date: not rebuilt


def test_native_decodes_what_the_jax_bindings_decode(tmp_path):
    """``decode_jpeg_batch`` (resized to 12 x 20, 3 threads),
    ``avi_frame_count`` and ``avi_decode_frames``: equal to the JAX
    package's bindings; a missing file gives None / -1."""
    _need_native()
    rng = np.random.RandomState(2)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"{i}.jpg")
        Image.fromarray((rng.rand(30, 40, 3) * 255).astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    got = tnative.decode_jpeg_batch(paths, 12, 20, n_threads=3)
    want = jnative.decode_jpeg_batch(paths, 12, 20, n_threads=3)
    assert got.shape == (5, 12, 20, 3) and np.array_equal(got, want)
    assert tnative.decode_jpeg_batch(paths + [str(tmp_path / "none.jpg")], 12, 20) is None
    avi = _clips(str(tmp_path / "v"), n=2)[1]
    assert tnative.avi_frame_count(avi) == jnative.avi_frame_count(avi) == 9
    assert tnative.avi_frame_count(str(tmp_path / "none.avi")) == -1
    got = tnative.avi_decode_frames(avi, [0, 4, 8], 16, 16, n_threads=2)
    want = jnative.avi_decode_frames(avi, [0, 4, 8], 16, 16, n_threads=2)
    assert got.shape == (3, 16, 16, 3) and np.array_equal(got, want)


def test_native_unavailable_falls_back(tmp_path, monkeypatch):
    """Without a library (here: no source), ``available()`` is False, the
    bindings return None / -1, and ``compute_metadata`` counts the frames
    with the AVI reader."""
    monkeypatch.setattr(tnative, "SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(tnative, "LIB_PATH", str(tmp_path / "lib.so"))
    tnative._load.cache_clear()
    try:
        assert not tnative.available()
        assert tnative.decode_jpeg_batch(["x.jpg"], 4, 4) is None
        assert tnative.avi_frame_count("x.avi") == -1
        assert tnative.avi_decode_frames("x.avi", [0], 4, 4) is None
        paths = _clips(str(tmp_path / "v"), n=2)
        tprep.compute_metadata(paths, str(tmp_path / "m.pkl.gz"), clip_len=4, skip=4)
        with gzip.open(tmp_path / "m.pkl.gz", "rb") as f:
            assert len(pickle.load(f)) == 1 + 2
    finally:
        tnative._load.cache_clear()
