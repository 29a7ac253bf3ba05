"""Base video dataset + per-dataset subclasses. The port's own copy of
``ccvs_tpu/data/base.py``: the same arrays for the same config and index.

Re-implements the reference data layer (`data/base_dataset.py`,
`data/*_dataset.py`, `data/__init__.py`) without torch/torchvision:

- Frame-folder videos (BAIR) via PIL; video files via our MJPEG-AVI reader
  (`ccvs_tpu_torch.utils.video_io`) or ``.npz`` clips — the prep scripts convert
  mp4 datasets into one of these container formats offline (this image ships
  no mp4 codec, and neither decode path belongs in the training job anyway).
- Four loading quadrants {from_vid, load_vid} x {img, vid}, clip subsampling
  (`load_vid_len`/`max_vid_step`), p2p end-frame selection + `delta_length`,
  elastic-view augmentation hook, state/STFT loading.
- `group_collate` concatenates consecutive-image groups along batch
  (reference `custom_collate_fn`, `data/__init__.py:59-67`).

All arrays NHWC float32 in [-1, 1] (or imagenet-normalized).
"""

import os
import pickle
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image, ImageFile

# tolerate truncated files mid-crawl: large-scale video-frame corpora always
# contain a few (reference sets the same flag, `data/base_dataset.py:8-9`)
ImageFile.LOAD_TRUNCATED_IMAGES = True

from ccvs_tpu_torch.config import DataConfig
from ccvs_tpu_torch.data.elastic import ElasticParams, get_augmentation
from ccvs_tpu_torch.utils import video_io

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tiff", ".webp")
VID_EXTENSIONS = (".avi", ".mp4", ".npz", ".npy")

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def scan_files(root: str, extensions) -> List[str]:
    out = []
    for r, _, fnames in sorted(os.walk(root, followlinks=True)):
        for f in sorted(fnames):
            if f.lower().endswith(extensions):
                out.append(os.path.join(r, f))
    return out


def load_frame(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def load_seg(path: str) -> np.ndarray:
    """Palette/gray segmentation PNG -> (H, W) int class ids
    (reference `load_seg_path`, `base_dataset.py:197-199`)."""
    im = Image.open(path)
    if im.mode not in ("P", "L", "I"):
        im = im.convert("L")
    return np.asarray(im, np.int64)


def load_video_file(path: str) -> np.ndarray:
    """(T, H, W, 3) uint8 from .avi (MJPEG) / .npz / .npy."""
    if path.endswith(".avi") or path.endswith(".mp4"):
        return video_io.read_video(path)
    if path.endswith(".npz"):
        return np.load(path)["frames"]
    return np.load(path)


class BaseVideoDataset:
    """Common loading logic (reference `data/base_dataset.py:20-385`)."""

    def __init__(self, cfg: DataConfig, phase: str = "train", from_vid: bool = False,
                 load_vid: bool = False, fold: Optional[int] = None):
        self.cfg = cfg
        self.phase = phase
        self.from_vid = from_vid
        self.load_vid = load_vid
        self.fold = fold
        self.data = self.get_data(cfg, phase=phase, from_vid=from_vid)
        if load_vid:
            key = "vid_frame_paths" if not from_vid else "vid_paths"
            self.size = len(self.data[key])
        else:
            key = "vid_frame_paths" if (cfg.n_consecutive_img > 1 and not from_vid) else (
                "frame_paths" if not from_vid else "vid_paths")
            self.size = len(self.data[key])
        self.elastic = ElasticParams(
            alpha=cfg.elastic_alpha,
            sigma=cfg.elastic_sigma,
            min_zoom=cfg.elastic_min_zoom,
            max_zoom=cfg.elastic_max_zoom,
            corruption=cfg.elastic_corruption,
            mean_corruption=cfg.elastic_mean_corruption,
            blur=cfg.blur_first,
            invert=cfg.distort_first,
        )

    # -------- subclass hook --------

    def get_data(self, cfg, phase="train", from_vid=False) -> Dict:
        raise NotImplementedError

    def __len__(self):
        return self.size

    # -------- transforms --------

    def _aug_params(self, rng):
        cfg = self.cfg
        h_flip = (not cfg.no_h_flip) and self.phase == "train" and rng.rand() < 0.5
        v_flip = (not cfg.no_v_flip) and self.phase == "train" and rng.rand() < 0.5
        zoom = 1.0
        top = left = 0.0
        if self.phase == "train" and (cfg.min_zoom != 1.0 or cfg.max_zoom != 1.0):
            zoom = cfg.min_zoom + rng.rand() * (cfg.max_zoom - cfg.min_zoom)
            top, left = rng.rand(), rng.rand()
        return {"h_flip": h_flip, "v_flip": v_flip, "zoom": zoom, "top": top, "left": left}

    def _transform(self, img: np.ndarray, p, dim: Optional[int] = None,
                   is_seg: bool = False) -> np.ndarray:
        """uint8 HWC -> float32 [-1,1] (or imagenet), resized to training dim
        (reference `get_transform`, `base_dataset.py:341-386`). With
        ``is_seg``, nearest resampling and raw int64 class ids out."""
        cfg = self.cfg
        dim = dim or cfg.max_dim
        im = Image.fromarray(img.astype(np.uint8) if is_seg else img)
        method = Image.NEAREST if is_seg else Image.BILINEAR
        if cfg.resize_center_crop_img:
            s = cfg.resize_center_crop_img
            w, h = im.size
            scale = s / min(w, h)
            im = im.resize((round(w * scale), round(h * scale)), method)
            w, h = im.size
            l, t = (w - s) // 2, (h - s) // 2
            im = im.crop((l, t, l + s, t + s))
        if p["zoom"] != 1.0:
            w, h = im.size
            cw, ch = int(w / p["zoom"]), int(h / p["zoom"])
            l = int(p["left"] * (w - cw))
            t = int(p["top"] * (h - ch))
            im = im.crop((l, t, l + cw, t + ch))
        w, h = im.size
        tgt_w = int(dim * cfg.aspect_ratio)
        if (w, h) != (tgt_w, dim):
            im = im.resize((tgt_w, dim), method)
        if p["h_flip"]:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        if p["v_flip"]:
            im = im.transpose(Image.FLIP_TOP_BOTTOM)
        if is_seg:
            return np.asarray(im, np.int64)
        x = np.asarray(im, np.float32) / 255.0
        if cfg.imagenet_norm:
            return (x - _IMAGENET_MEAN) / _IMAGENET_STD
        return x * 2.0 - 1.0

    # -------- item loading --------

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(random.randrange(2**31)) if self.phase == "train" else np.random.RandomState(index)
        p = self._aug_params(rng)
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {}

        if self.load_vid:
            frames, extra = self._load_clip(index, rng)
            lay_frames = extra.pop("_layout_frames", None)
            out.update(extra)
            out["vid"] = np.stack([self._transform(f, p) for f in frames])
            if lay_frames is not None:
                out["layout"] = np.stack(
                    [self._transform(l, p, is_seg=True) for l in lay_frames]
                )  # (T, H, W), `base_dataset.py:270-273`
        else:
            out.update(self._load_img_group(index, rng, p))
        return out

    def _subsample(self, n_avail: int, rng) -> List[int]:
        """`load_vid_len`/`max_vid_step` random subsampling
        (`base_dataset.py:211-216`)."""
        cfg = self.cfg
        vid_len = cfg.vid_len if cfg.p2p_len is None else cfg.p2p_len
        if cfg.load_vid_len is None or self.phase != "train":
            return list(range(min(vid_len, n_avail)))
        step = min(max(1, int(rng.rand() * (cfg.load_vid_len - 1) / (vid_len - 1))), cfg.max_vid_step)
        start = int(rng.rand() * (cfg.load_vid_len - (vid_len - 1) * step))
        return list(range(start, start + step * (vid_len - 1) + 1, step))

    def _p2p_select(self, idxs: List[int], rng) -> (List[int], int):
        """p2p end-frame selection + delta (`base_dataset.py:217-221`)."""
        cfg = self.cfg
        i0 = rng.randint(0, cfg.p2p_len - cfg.vid_len + 1)
        i_end = rng.randint(i0 + cfg.vid_len - 1, cfg.p2p_len)
        sel = idxs[i0 : i0 + cfg.vid_len - 1] + [idxs[i_end]]
        return sel, i_end - i0

    def _load_clip(self, index, rng):
        cfg = self.cfg
        extra = {}
        if self.from_vid:
            path = self.data["vid_paths"][index]
            vid = load_video_file(path)
            n_load = cfg.load_vid_len or (cfg.p2p_len or cfg.vid_len)
            start0 = rng.randint(0, max(1, len(vid) - n_load + 1)) if self.phase == "train" else 0
            vid = vid[start0 : start0 + n_load]
            idxs = self._subsample(len(vid), rng)
            if cfg.p2p_len is not None:
                idxs, delta = self._p2p_select(idxs, rng)
                extra["delta_length"] = np.asarray(delta, np.int32)
            frames = [vid[i] for i in idxs]
            if "stft_paths" in self.data and cfg.p2p_len is None:
                with open(self.data["stft_paths"][index], "rb") as f:
                    stft = pickle.load(f)
                stft = np.asarray(stft, np.float32)[[start0 + i for i in idxs]]
                stft = stft * 2.0 - 1.0
                stft = _resize_stft(stft)  # (T, 64, 16, 1)
                extra["stft"] = stft
            if "vid_labels" in self.data:
                extra["vid_lbl"] = np.asarray(self.data["vid_labels"][index], np.int32)
            if "vid_id" in self.data:
                extra["vid_id"] = np.asarray(self.data["vid_id"][index], np.int32)
        else:
            paths = self.data["vid_frame_paths"][index]
            n_load = cfg.load_vid_len if (cfg.load_vid_len is not None and self.phase == "train") else (
                cfg.p2p_len if (cfg.p2p_len is not None and self.phase == "train") else cfg.vid_len)
            i0 = rng.randint(0, len(paths) - n_load * cfg.one_every_n + 1) if self.phase == "train" else 0
            paths = paths[i0 : i0 + n_load * cfg.one_every_n : cfg.one_every_n]
            idxs = self._subsample(len(paths), rng)
            if cfg.p2p_len is not None and self.phase == "train":
                idxs, delta = self._p2p_select(idxs, rng)
                extra["delta_length"] = np.asarray(delta, np.int32)
            frames = [load_frame(paths[i]) for i in idxs]
            if "vid_layout_paths" in self.data:
                # per-frame segmentations with the same clip indices
                # (`base_dataset.py:245-273`); transform applied by the caller
                lp = self.data["vid_layout_paths"][index]
                lp = lp[i0 : i0 + n_load * cfg.one_every_n : cfg.one_every_n]
                extra["_layout_frames"] = [load_seg(lp[i]) for i in idxs]
            if "vid_frame_states" in self.data and cfg.load_vid_len is None and cfg.p2p_len is None:
                st = np.asarray(self.data["vid_frame_states"][index], np.float32)
                extra["state"] = st[i0 : i0 + cfg.vid_len * cfg.one_every_n : cfg.one_every_n]
        return frames, extra

    def _load_img_group(self, index, rng, p):
        """Image groups [context, others..., distorted?]
        (`base_dataset.py:287-328`)."""
        cfg = self.cfg
        out = {}
        raw_lay = None
        n = cfg.n_consecutive_img
        if self.from_vid:
            vid = load_video_file(self.data["vid_paths"][index])
            sel = rng.choice(len(vid), size=max(n, 1), replace=False)
            raw = [vid[i] for i in sorted(sel)]
        elif n > 1 or cfg.load_elastic_view:
            paths = self.data["vid_frame_paths"][index]
            i0 = rng.randint(0, len(paths) - cfg.img_out_of_n + 1)
            window = paths[i0 : i0 + cfg.img_out_of_n]
            img_idx = rng.choice(cfg.img_out_of_n, size=n, replace=False)
            raw = [load_frame(window[i]) for i in img_idx]
            if "vid_layout_paths" in self.data:
                lwin = self.data["vid_layout_paths"][index][i0 : i0 + cfg.img_out_of_n]
                raw_lay = [load_seg(lwin[i]) for i in img_idx]
        else:
            raw = [load_frame(self.data["frame_paths"][index])]
            if "frame_states" in self.data:
                out["state"] = np.asarray(self.data["frame_states"][index], np.float32)

        imgs = [self._transform(f, p) for f in raw]
        lays = [self._transform(l, p, is_seg=True) for l in raw_lay] if raw_lay is not None else None
        if cfg.load_elastic_view:
            # frame 0 is replaced by its elastic context view; a distorted
            # view is appended (reference `base_dataset.py:305-315`)
            full = self._transform(raw[0], p, dim=raw[0].shape[0])
            full_lay = (
                self._transform(raw_lay[0], p, dim=raw[0].shape[0], is_seg=True)
                if raw_lay is not None else None
            )
            aug = get_augmentation(full, cfg.max_dim, self.elastic, rng, layout=full_lay)
            ctx, dist, flow, mask = aug[:4]
            imgs[0] = ctx
            imgs.append(dist)
            out["flow_img"] = flow
            out["mask_img"] = mask
            if lays is not None:
                # same elastic views for the layout (`base_dataset.py:313-315`)
                lays[0] = aug[4]
                lays.append(aug[5])
        out["img"] = np.stack(imgs) if len(imgs) > 1 else imgs[0]
        if lays is not None:
            out["layout"] = np.stack(lays)  # (G, H, W), the loss contract
        if "vid_labels" in self.data:
            out["vid_lbl"] = np.asarray(self.data["vid_labels"][index], np.int32)
        return out


def _resize_stft(stft: np.ndarray) -> np.ndarray:
    """(T, F, S) -> (T, 64, 16, 1) bilinear (`base_dataset.py:223-231`)."""
    out = np.zeros((stft.shape[0], 64, 16), np.float32)
    for i in range(stft.shape[0]):
        im = Image.fromarray(stft[i].astype(np.float32), mode="F")
        out[i] = np.asarray(im.resize((16, 64), Image.BILINEAR))
    return out[..., None]


# ---------------- subclasses ----------------


class BairhdDataset(BaseVideoDataset):
    """BAIR robot pushing: frame folders + filename-encoded arm states
    (`data/bairhd_dataset.py`)."""

    def get_data(self, cfg, phase="train", from_vid=False):
        phase = "test" if phase == "valid" else phase
        root = cfg.dataroot
        if cfg.load_state:
            frame_paths = scan_files(os.path.join(root, "annotated_frames"), IMG_EXTENSIONS)
            sel = (lambda p: self._id(p) % 5 != 0) if phase == "train" else (lambda p: self._id(p) % 5 == 0)
            frame_paths = [p for p in frame_paths if sel(p)]
            return {"frame_paths": frame_paths,
                    "frame_states": [self._state(p) for p in frame_paths]}
        frame_paths = scan_files(os.path.join(root, "original_frames_256", phase), IMG_EXTENSIONS)
        dic = {}
        for p in frame_paths:
            dic.setdefault(os.path.dirname(p), []).append(p)
        return {"frame_paths": frame_paths, "vid_frame_paths": list(dic.values())}

    @staticmethod
    def _id(path):
        return int(os.path.basename(path).split("_")[0])

    @staticmethod
    def _state(path):
        x, y = os.path.basename(path).split(".")[0].split("_")[1:3]
        return [int(x) / 256, int(y) / 256]


class Ucf101Dataset(BaseVideoDataset):
    def get_data(self, cfg, phase="train", from_vid=False):
        return {"vid_paths": scan_files(os.path.join(cfg.dataroot, "videos"), VID_EXTENSIONS)}


class DrumsDataset(BaseVideoDataset):
    def get_data(self, cfg, phase="train", from_vid=False):
        phase = "test" if phase == "valid" else "train"
        root = os.path.join(cfg.dataroot, "AudioSet_Dataset", phase)
        vid_paths = scan_files(os.path.join(root, "mp4"), VID_EXTENSIONS)
        stft_paths = [
            p.replace("/mp4/", "/stft_pickle/").rsplit(".", 1)[0] + ".pickle"
            for p in vid_paths
        ]
        vid_id = [int(os.path.basename(p).split(".")[0]) for p in vid_paths]
        return {"vid_paths": vid_paths, "stft_paths": stft_paths, "vid_id": vid_id}


class Kinetics600Dataset(BaseVideoDataset):
    """Preprocessed-fold kinetics (`data/kinetics600_dataset.py`): videos are
    prepared offline into per-fold directories."""

    def get_data(self, cfg, phase="train", from_vid=False):
        phase = "val" if phase == "valid" else phase
        fold = f"fold_{self.fold}" if getattr(self, "fold", None) is not None else ""
        root = os.path.join(cfg.dataroot, "preprocessed", phase, fold)
        vid_paths = scan_files(root, VID_EXTENSIONS)
        data = {"vid_paths": vid_paths}
        if cfg.categories:
            labels = []
            for p in vid_paths:
                lbl = os.path.basename(os.path.dirname(p))
                labels.append(cfg.categories.index(lbl) if lbl in cfg.categories else 0)
            data["vid_labels"] = labels
        return data


class SyntheticDataset(BaseVideoDataset):
    """Procedural moving-squares dataset for tests/benchmarks (no disk)."""

    def get_data(self, cfg, phase="train", from_vid=False):
        n = self.n_videos
        return {
            "vid_frame_paths": [[None]] * n,
            "frame_paths": [None] * n,
            "vid_paths": [None] * n,
        }

    def __init__(self, cfg, phase="train", from_vid=False, load_vid=False, fold=None,
                 n_videos=32, n_frames=30):
        self.n_videos = n_videos
        self.n_frames = n_frames
        super().__init__(cfg, phase, from_vid, load_vid, fold)
        self.size = n_videos

    def _frames(self, index, with_layouts=False, with_states=False):
        """Procedural frames (+ optional layouts / square-center states).

        Everything is returned, never stashed on ``self`` — __getitem__ runs
        concurrently on PrefetchLoader worker threads."""
        cfg = self.cfg
        d = cfg.true_dim
        rng = np.random.RandomState(index)
        x0, y0 = rng.randint(0, d - 16, 2)
        vx, vy = rng.randint(-3, 4, 2)
        color = rng.randint(64, 255, 3)
        frames, layouts, states = [], [], []
        for t in range(self.n_frames):
            f = np.full((d, d, 3), 32, np.uint8)
            x = int(np.clip(x0 + vx * t, 0, d - 16))
            y = int(np.clip(y0 + vy * t, 0, d - 16))
            f[y : y + 16, x : x + 16] = color
            frames.append(f)
            # square center in [0,1]^2 — the BAIR arm-state analog
            states.append(np.asarray([(x + 8) / d, (y + 8) / d], np.float32))
            if with_layouts:
                l = np.zeros((d, d), np.int64)
                l[y : y + 16, x : x + 16] = 1
                layouts.append(l)
        out = [frames]
        if with_layouts:
            out.append(layouts)
        if with_states:
            out.append(states)
        return out[0] if len(out) == 1 else tuple(out)

    def __getitem__(self, index):
        rng = np.random.RandomState(index + (0 if self.phase != "train" else random.randrange(2**31)))
        p = self._aug_params(rng)
        cfg = self.cfg
        res = self._frames(index % self.n_videos, with_layouts=cfg.load_layout,
                           with_states=True)
        if cfg.load_layout:
            frames, layouts, states = res
        else:
            frames, states = res
            layouts = None
        out = {}
        if self.load_vid:
            idxs = self._subsample(len(frames), rng)
            if cfg.p2p_len is not None and self.phase == "train":
                idxs, delta = self._p2p_select(idxs, rng)
                out["delta_length"] = np.asarray(delta, np.int32)
            out["vid"] = np.stack([self._transform(frames[i], p) for i in idxs])
            if cfg.load_state:
                out["state"] = np.stack([states[i] for i in idxs])
            if layouts is not None:
                out["layout"] = np.stack(
                    [self._transform(layouts[i], p, is_seg=True) for i in idxs]
                )
        else:
            n = cfg.n_consecutive_img
            sel = rng.choice(min(cfg.img_out_of_n, len(frames)), size=n, replace=False)
            raw = [frames[i] for i in sel]
            imgs = [self._transform(f, p) for f in raw]
            raw_lay = [layouts[i] for i in sel] if layouts is not None else None
            lays = (
                [self._transform(l, p, is_seg=True) for l in raw_lay]
                if raw_lay is not None else None
            )
            if cfg.load_elastic_view:
                full = self._transform(raw[0], p, dim=raw[0].shape[0])
                full_lay = (
                    self._transform(raw_lay[0], p, dim=raw[0].shape[0], is_seg=True)
                    if raw_lay is not None else None
                )
                aug = get_augmentation(full, cfg.max_dim, self.elastic, rng, layout=full_lay)
                ctx, dist, flow, mask = aug[:4]
                imgs[0] = ctx
                imgs.append(dist)
                out["flow_img"] = flow
                out["mask_img"] = mask
                if lays is not None:
                    lays[0] = aug[4]
                    lays.append(aug[5])
            out["img"] = np.stack(imgs) if len(imgs) > 1 else imgs[0]
            if cfg.load_state and n == 1 and not cfg.load_elastic_view:
                out["state"] = states[int(sel[0])]
            if lays is not None:
                out["layout"] = np.stack(lays)  # (G, H, W), the loss contract
        return out


DATASETS = {
    "bairhd": BairhdDataset,
    "ucf101": Ucf101Dataset,
    "drums": DrumsDataset,
    "kinetics600": Kinetics600Dataset,
    "synthetic": SyntheticDataset,
}


def create_dataset(cfg: DataConfig, phase="train", from_vid=None, load_vid=False,
                   fold=None, **kw) -> BaseVideoDataset:
    """Name -> class factory (`data/__init__.py:10-56`)."""
    cls = DATASETS[cfg.dataset]
    if from_vid is None:
        from_vid = cfg.from_vid
    return cls(cfg, phase=phase, from_vid=from_vid, load_vid=load_vid, fold=fold, **kw)


def group_collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate image groups along batch; stack everything else
    (`data/__init__.py:59-67`). Layouts follow their quadrant: image-group
    items ((G, H, W) next to a (G, H, W, 3) img) concatenate like the images;
    video items ((T, H, W) next to a vid) stack into (B, T, H, W)."""
    out = {}
    img_quadrant = "img" in items[0]
    for key in items[0]:
        vals = [it[key] for it in items]
        if key in ("img", "mask_img", "flow_img") and vals[0].ndim == 4:
            out[key] = np.concatenate(vals, axis=0)
        elif key == "layout" and img_quadrant:
            out[key] = np.concatenate(vals, axis=0)
        else:
            out[key] = np.stack(vals, axis=0)
    return out
