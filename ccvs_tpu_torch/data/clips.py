"""Clip indexing: the VideoClips-equivalent for deterministic sharded loading.
The port's own copy of ``ccvs_tpu/data/clips.py``, unchanged.

Replaces torchvision `VideoClips` (used at reference `data/base_dataset.py:
46-70`) with a pure index over per-video frame counts: clip c of video v
covers frames [start, start + clip_len) with a configurable inter-clip skip.
Deterministic order -> per-host sharding is a stride over the index.
"""

import gzip
import os
import pickle
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class ClipIndex:
    video_ids: np.ndarray  # (n_clips,)
    starts: np.ndarray  # (n_clips,)
    clip_len: int

    def __len__(self):
        return len(self.video_ids)

    def __getitem__(self, i) -> Tuple[int, int]:
        return int(self.video_ids[i]), int(self.starts[i])


def build_clip_index(frame_counts: Sequence[int], clip_len: int, skip: int = 1) -> ClipIndex:
    """All clips of ``clip_len`` frames with stride ``skip`` between clip
    starts (reference `--vid_skip`)."""
    vids, starts = [], []
    for v, n in enumerate(frame_counts):
        for s in range(0, n - clip_len + 1, skip):
            vids.append(v)
            starts.append(s)
    return ClipIndex(np.asarray(vids, np.int64), np.asarray(starts, np.int64), clip_len)


def shard_index(index: ClipIndex, host_id: int, n_hosts: int) -> ClipIndex:
    """Per-host shard (replaces DistributedSampler, `tools/engine.py:87`)."""
    sel = np.arange(host_id, len(index), n_hosts)
    return ClipIndex(index.video_ids[sel], index.starts[sel], index.clip_len)


def save_index(path: str, index: ClipIndex):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with gzip.open(path, "wb") as f:
        pickle.dump(index, f)


def load_index(path: str) -> ClipIndex:
    with gzip.open(path, "rb") as f:
        return pickle.load(f)
