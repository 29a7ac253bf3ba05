"""Offline dataset preparation (counterpart of ``ccvs_tpu/data/prep.py``,
the same functions and the same output files, byte for byte).

Ports of the reference's one-shot prep scripts (`data/scripts/`):

- :func:`preprocess_bairhd`  <- `preprocess_bairhd.py`: BAIR "softmotion"
  HD trajectories -> cropped / resized / v-flipped per-video frame folders.
- :func:`preprocess_videos`  <- `preprocess_kinetics.py`: resize, square-crop
  and trim raw videos into our MJPEG-AVI container (pluggable decoder — this
  image ships no mp4 codec; pass a decode_fn backed by ffmpeg/PyAV offline).
- :func:`compute_folds` / :func:`compute_metadata` <-
  `compute_folds_kinetics.py` / `compute_metadata_kinetics.py`: fold splits +
  precomputed clip indices (the VideoClips-metadata equivalent).
- :func:`annotate_states` <- `annotate_bairhd.py`: writes the
  ``annotated_frames`` naming scheme (``{id}_{x}_{y}.png``) from a state file
  (the reference's interactive clicker is replaced by a batch tool; states
  may come from any annotation UI).

Usage: ``python -m ccvs_tpu_torch.data.prep bairhd --data-root datasets/bairhd``.
"""

import argparse
import os
import pickle
import random
import shutil
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Callable, List, Optional, Sequence

import numpy as np
from PIL import Image

from ccvs_tpu_torch.data.clips import build_clip_index, save_index
from ccvs_tpu_torch.utils import video_io


def _crop_resize_flip(im: Image.Image, dim: int) -> np.ndarray:
    """BAIR HD frame op (`preprocess_bairhd.py:29-34`): crop x[157:967],
    resize to dim^2, vertical flip."""
    arr = np.asarray(im.convert("RGB"))
    arr = arr[:, 157:967]
    im = Image.fromarray(arr).resize((dim, dim), Image.BILINEAR)
    return np.asarray(im.transpose(Image.FLIP_TOP_BOTTOM))


def preprocess_bairhd(data_root: str, dim: int = 256, num_workers: int = 8,
                      train_range=(0, 43264), test_range=(44120, 44376)):
    data_dir = os.path.join(data_root, "softmotion_0511")

    def process(k, out_root):
        group = k // 1000
        frames_dir = os.path.join(data_dir, f"aux1/traj_group{group}/traj{k}/images")
        out_dir = os.path.join(out_root, f"{k:05d}")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(30):
            paths = glob(os.path.join(frames_dir, f"aux1_full_cropped_im{i}_*.jpg"))
            if len(paths) != 1:
                continue
            frame = _crop_resize_flip(Image.open(paths[0]), dim)
            Image.fromarray(frame).save(os.path.join(out_dir, f"{i:02d}.png"))

    for phase, (k0, k1) in (("train", train_range), ("test", test_range)):
        out_root = os.path.join(data_root, f"original_frames_{dim}", phase)
        os.makedirs(out_root, exist_ok=True)
        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(lambda k: process(k, out_root), range(k0, k1)))
        print(f"bairhd {phase}: {k1 - k0} trajectories -> {out_root}")


def preprocess_videos(src_folder: str, out_folder: str, decode_fn: Callable,
                      resize: Optional[int] = 256, square_crop: bool = True,
                      max_frames: Optional[int] = 300, fps: int = 25,
                      num_workers: int = 8, quality: int = 92):
    """Raw videos -> resized/cropped MJPEG-AVI (`preprocess_kinetics.py:20-50`).

    ``decode_fn(path) -> (T, H, W, 3) uint8`` supplies the source decoder
    (e.g. PyAV/ffmpeg offline, or `ccvs_tpu_torch.utils.video_io.read_video` for
    already-MJPEG sources).
    """
    os.makedirs(out_folder, exist_ok=True)
    files = []
    for r, _, fn in os.walk(src_folder):
        files += [os.path.join(r, f) for f in fn if f.lower().endswith((".mp4", ".avi", ".webm"))]

    def process(path):
        rel = os.path.relpath(path, src_folder)
        out = os.path.join(out_folder, os.path.splitext(rel)[0] + ".avi")
        if os.path.exists(out):
            return
        os.makedirs(os.path.dirname(out), exist_ok=True)
        vid = decode_fn(path)
        if max_frames:
            vid = vid[:max_frames]
        frames = []
        for f in vid:
            im = Image.fromarray(f)
            if resize:
                w, h = im.size
                s = resize / min(w, h)
                im = im.resize((round(w * s), round(h * s)), Image.BILINEAR)
            if square_crop:
                w, h = im.size
                s = min(w, h)
                l, t = (w - s) // 2, (h - s) // 2
                im = im.crop((l, t, l + s, t + s))
            frames.append(np.asarray(im))
        video_io.write_video(out, np.stack(frames), fps=fps, quality=quality)

    with ThreadPoolExecutor(num_workers) as pool:
        list(pool.map(process, files))
    print(f"preprocessed {len(files)} videos -> {out_folder}")


def compute_folds(video_paths: Sequence[str], out_dir: str, num_folds: int,
                  seed: int = 0):
    """Split a video list into folds (`compute_folds_kinetics.py`)."""
    paths = list(video_paths)
    random.Random(seed).shuffle(paths)
    os.makedirs(out_dir, exist_ok=True)
    for f in range(num_folds):
        fold = paths[f::num_folds]
        with open(os.path.join(out_dir, f"fold_{f}.pkl"), "wb") as fh:
            pickle.dump(fold, fh)
    print(f"{len(paths)} videos -> {num_folds} folds in {out_dir}")


def compute_metadata(video_paths: Sequence[str], out_path: str, clip_len: int = 16,
                     skip: int = 16):
    """Precompute the clip index (`compute_metadata_kinetics.py` /
    torchvision VideoClips equivalent)."""
    from ccvs_tpu_torch.data import native

    counts = []
    for p in video_paths:
        n = native.avi_frame_count(p) if native.available() else len(video_io.read_video(p))
        counts.append(max(0, n))
    index = build_clip_index(counts, clip_len, skip)
    save_index(out_path, index)
    print(f"{len(video_paths)} videos, {len(index)} clips -> {out_path}")


def annotate_states(frames_dir: str, states_file: str, out_dir: str, dim: int = 256):
    """Write `annotated_frames` with filename-encoded states
    (`{id}_{x}_{y}.png`, reference `bairhd_dataset.py:36-40`).

    ``states_file``: text file with lines ``frame_path x y`` (x, y in [0, 1]).
    """
    os.makedirs(out_dir, exist_ok=True)
    with open(states_file) as f:
        for i, line in enumerate(f):
            path, x, y = line.split()
            xi, yi = int(float(x) * dim), int(float(y) * dim)
            shutil.copy(path, os.path.join(out_dir, f"{i}_{xi}_{yi}.png"))
    print(f"annotated frames -> {out_dir}")


def download_kinetics(
    input_csv: str,
    output_dir: str,
    trim: bool = False,
    num_jobs: int = 1,
    fetch_fn: Optional[Callable[[str, str], None]] = None,
    trim_fn: Optional[Callable[[str, str, float, float], bool]] = None,
):
    """Kinetics clip downloader (`data/scripts/download_kinetics.py:22-129`).

    CSV columns ``label, youtube_id, time_start, time_end, split, is_cc``;
    one folder per label, videos saved as ``{id}_{start}_{dur}.mp4``, existing
    files skipped, optional trim to the [start, end] action window.

    ``fetch_fn(youtube_id, out_path)`` / ``trim_fn(src, dst, start, dur)``
    are injectable: the defaults use ``pytube`` and a PATH ``ffmpeg``, neither
    of which exists in a zero-egress image — callers there supply their own
    (and the unit tests do).
    """
    import csv
    import threading

    if fetch_fn is None:
        try:
            import pytube  # noqa: F401  (not shipped in this image)
        except ImportError as e:
            raise RuntimeError(
                "download_kinetics needs `pytube` (or pass fetch_fn=): "
                "this environment has no network egress"
            ) from e

        def fetch_fn(vid_id, out_path):
            pytube.YouTube("https://www.youtube.com/watch?v=" + vid_id) \
                .streams.filter(subtype="mp4").first() \
                .download(os.path.dirname(out_path), os.path.basename(out_path))

    if trim_fn is None:
        def trim_fn(src, dst, start, dur):
            import subprocess

            r = subprocess.run(
                ["ffmpeg", "-i", src, "-ss", str(start), "-t", str(dur),
                 "-c:v", "libx264", "-c:a", "copy", "-threads", "1", dst],
                capture_output=True,
            )
            return r.returncode == 0

    with open(input_csv) as f:
        rows = list(csv.DictReader(f))
    need = {"label", "youtube_id", "time_start", "time_end"}
    missing = need - set(rows[0].keys() if rows else need)
    if missing:
        raise ValueError(f"input csv missing columns: {sorted(missing)}")

    # Dot-prefixed scratch dir: a CSV label can never collide with it
    # (labels become plain subdirs of output_dir).
    tmp_dir = os.path.join(output_dir, ".tmp_download")
    os.makedirs(tmp_dir, exist_ok=True)
    for name in {r["label"] for r in rows}:
        os.makedirs(os.path.join(output_dir, name), exist_ok=True)

    # One lock per youtube_id, created up front (a lazily-populated dict
    # could hand two racing threads two different locks): several CSV rows
    # (segments) can share a source video, and two threads must not
    # race-fetch the same raw path.
    fetch_locks = {r["youtube_id"]: threading.Lock() for r in rows}

    def one(row):
        vid, label = row["youtube_id"], row["label"]
        start = float(row["time_start"])
        dur = float(row["time_end"]) - start
        final = os.path.join(output_dir, label, f"{vid}_{start:g}_{dur:g}.mp4")
        if os.path.exists(final):
            return "cached"
        # Every write below goes to a scratch path first and is published by
        # an atomic rename: a fetch/trim that dies mid-write can't leave a
        # partial file that a rerun (or a sibling row) mistakes for a
        # complete one.
        raw = os.path.join(tmp_dir, vid + ".mp4")
        with fetch_locks[vid]:
            if not os.path.exists(raw):
                part = raw + ".part"
                try:
                    fetch_fn(vid, part)
                except Exception as e:  # unavailable / private videos happen
                    print(f"unavailable: {vid} ({e})")
                    if os.path.exists(part):
                        os.unlink(part)
                    return "failed"
                os.replace(part, raw)
        if trim:
            cut = os.path.join(tmp_dir, f"{vid}_{start:g}_{dur:g}.cut.mp4")
            try:
                ok = trim_fn(raw, cut, start, dur)
            except Exception as e:  # a bad clip must not abort the batch
                print(f"trim failed: {vid} ({e})")
                ok = False
            if not ok or not os.path.exists(cut):
                if ok:
                    print(f"trim failed: {vid}")
                if os.path.exists(cut):
                    os.unlink(cut)
                return "failed"
            os.replace(cut, final)
        else:
            # COPY the raw into place (link when possible) instead of moving
            # it: other rows (segments) of the same youtube_id still need the
            # shared raw download. Publish by atomic rename, serialized by
            # the per-id lock so two segments can't race the same .pub path.
            with fetch_locks[vid]:
                pub = raw + ".pub"
                try:
                    os.link(raw, pub)
                except OSError:
                    shutil.copyfile(raw, pub)
                os.replace(pub, final)
        return "ok"

    with ThreadPoolExecutor(max_workers=max(1, num_jobs)) as ex:
        counts = {}
        for st in ex.map(one, rows):
            counts[st] = counts.get(st, 0) + 1
    shutil.rmtree(tmp_dir, ignore_errors=True)
    print(f"download_kinetics: {counts} of {len(rows)} clips -> {output_dir}")
    return counts


def main():
    p = argparse.ArgumentParser(prog="ccvs_tpu_torch.data.prep")
    sub = p.add_subparsers(dest="task", required=True)
    b = sub.add_parser("bairhd")
    b.add_argument("--data-root", required=True)
    b.add_argument("--dim", type=int, default=256)
    b.add_argument("--num-workers", type=int, default=8)
    v = sub.add_parser("videos")
    v.add_argument("--src", required=True)
    v.add_argument("--out", required=True)
    v.add_argument("--resize", type=int, default=256)
    f = sub.add_parser("folds")
    f.add_argument("--video-dir", required=True)
    f.add_argument("--out-dir", required=True)
    f.add_argument("--num-folds", type=int, required=True)
    m = sub.add_parser("metadata")
    m.add_argument("--video-dir", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--clip-len", type=int, default=16)
    a = sub.add_parser("annotate")
    a.add_argument("--frames-dir", required=True)
    a.add_argument("--states-file", required=True)
    a.add_argument("--out-dir", required=True)
    d = sub.add_parser("download-kinetics")
    d.add_argument("--input-csv", required=True)
    d.add_argument("--output-dir", required=True)
    d.add_argument("--trim", action="store_true")
    d.add_argument("--num-jobs", type=int, default=1)
    args = p.parse_args()

    if args.task == "bairhd":
        preprocess_bairhd(args.data_root, args.dim, args.num_workers)
    elif args.task == "videos":
        preprocess_videos(args.src, args.out, video_io.read_video, resize=args.resize)
    elif args.task == "folds":
        from ccvs_tpu_torch.data.base import scan_files, VID_EXTENSIONS

        compute_folds(scan_files(args.video_dir, VID_EXTENSIONS), args.out_dir, args.num_folds)
    elif args.task == "metadata":
        from ccvs_tpu_torch.data.base import scan_files, VID_EXTENSIONS

        compute_metadata(scan_files(args.video_dir, VID_EXTENSIONS), args.out, args.clip_len)
    elif args.task == "annotate":
        annotate_states(args.frames_dir, args.states_file, args.out_dir)
    elif args.task == "download-kinetics":
        download_kinetics(args.input_csv, args.output_dir, trim=args.trim,
                          num_jobs=args.num_jobs)


if __name__ == "__main__":
    main()
