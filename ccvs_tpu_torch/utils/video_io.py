"""Reading the MJPEG AVI clips that ``ccvs_tpu/utils/video_io.py`` writes
(the reading part of it, which the datasets use)."""

import io
import struct

import numpy as np


def read_video(path: str) -> np.ndarray:
    """Read an MJPEG AVI -> (T, H, W, 3) uint8."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    frames = []
    pos = 0
    while True:
        pos = data.find(b"00dc", pos)
        if pos < 0:
            break
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        payload = data[pos + 8 : pos + 8 + size]
        if payload[:2] == b"\xff\xd8":  # JPEG SOI (skip idx1 entries)
            frames.append(np.asarray(Image.open(io.BytesIO(payload)).convert("RGB")))
        pos += 8 + size
    return np.stack(frames)
