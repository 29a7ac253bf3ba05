"""Video files without external codecs (counterpart of
``ccvs_tpu/utils/video_io.py``): an MJPEG AVI writer (a RIFF container of
per-frame JPEGs through PIL) and its reader, GIF and PNG-folder writers,
and the float-to-uint8 conversion of the generated clips.

The writers take numpy uint8 frames. :func:`to_uint8` takes a video as a
numpy array or a torch tensor (any dtype, any device): it moves it once to
the host as fp32 and then runs the JAX package's arithmetic, so both
packages write the same bytes for the same float input.
"""

import io
import os
import struct

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int = 92) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_video(path: str, frames: np.ndarray, fps: int = 4, quality: int = 92):
    """Write ``(T, H, W, 3)`` uint8 frames as an MJPEG AVI."""
    assert frames.dtype == np.uint8 and frames.ndim == 4 and frames.shape[-1] == 3
    t, h, w, _ = frames.shape
    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        pad = b"\x00" if len(data) % 2 else b""
        return fourcc + struct.pack("<I", len(data)) + data + pad

    def lst(fourcc: bytes, data: bytes) -> bytes:
        return chunk(b"LIST", fourcc + data)

    # microseconds a frame, max bytes a second, padding, AVIF_HASINDEX, total
    # frames, initial frames, streams, suggested buffer, width, height, reserved
    avih = struct.pack("<14I", int(1e6 / fps), max_size * fps, 0, 0x10, t, 0, 1, max_size,
                       w, h, 0, 0, 0, 0)
    strh = (
        b"vids"
        + b"MJPG"
        # flags, priority, language, initialFrames, scale, rate, start,
        # length, suggestedBuffer, quality, sampleSize
        + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, t, max_size, 0xFFFFFFFF, 0)
        + struct.pack("<4H", 0, 0, w, h)  # rcFrame
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_chunks, offsets = [], []
    off = 4  # after the 'movi' fourcc
    for j in jpegs:
        c = chunk(b"00dc", j)
        offsets.append((off, len(j)))
        off += len(c)
        movi_chunks.append(c)
    movi = lst(b"movi", b"".join(movi_chunks))
    idx1 = chunk(b"idx1", b"".join(b"00dc" + struct.pack("<III", 0x10, o, n)
                                   for o, n in offsets))

    riff_payload = b"AVI " + hdrl + movi + idx1
    data = b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


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


def write_gif(path: str, frames: np.ndarray, fps: int = 4):
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)


def write_frames(path: str, frames: np.ndarray):
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(path, f"frame_{i:04d}.png"))


def to_host_f32(vid) -> np.ndarray:
    """A video (numpy array, or torch tensor of any dtype on any device) as
    an fp32 numpy array on the host; bf16 widens exactly."""
    if hasattr(vid, "detach"):
        vid = vid.detach().float().cpu().numpy()
    return np.asarray(vid, np.float32)


def to_uint8(vid, span=(-1.0, 1.0), imagenet_norm=False) -> np.ndarray:
    """A float video in ``span`` (or ImageNet-normalised) -> uint8,
    truncating as the reference's ``save_video_batch`` does."""
    vid = to_host_f32(vid)
    if imagenet_norm:
        vid = vid * np.array([0.229, 0.224, 0.225]) + np.array([0.485, 0.456, 0.406])
        vid = np.clip(vid, 0, 1)
    else:
        vid = np.clip(vid, span[0], span[1])
        vid = (vid - span[0]) / (span[1] - span[0])
    return (vid * 255).astype(np.uint8)


# the 19-class urban-scene colour map of the reference's layout videos
LAYOUT_COLORMAP = np.array(
    [[128, 64, 128], [244, 35, 232], [230, 150, 140], [70, 70, 70], [102, 102, 156],
     [153, 153, 153], [250, 170, 30], [220, 220, 0], [107, 142, 135], [152, 251, 152],
     [230, 150, 140], [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70],
     [0, 60, 100], [0, 80, 100], [0, 0, 230], [119, 11, 32]], np.float32,
) / 255.0


def layout_to_uint8(seg: np.ndarray) -> np.ndarray:
    """An integer segmentation video -> uint8 RGB through
    :data:`LAYOUT_COLORMAP` (class ``c`` takes colour ``c % 19``), as the
    reference's ``save_video_batch`` does for layouts
    (``helpers/generator.py:287-298``)."""
    s = np.asarray(seg).astype(int)
    return (LAYOUT_COLORMAP[s % len(LAYOUT_COLORMAP)] * 255).astype(np.uint8)


def draw_cross(img: np.ndarray, x: int, y: int) -> np.ndarray:
    """A copy of ``img`` with the white cross of a state marker at ``(x, y)``
    (black diagonal neighbours)."""
    h, w = img.shape[:2]
    img = img.copy()
    img[y, x] = 255
    for dx, dy, val in [(-1, 0, 255), (1, 0, 255), (0, -1, 255), (0, 1, 255),
                        (-1, -1, 0), (-1, 1, 0), (1, -1, 0), (1, 1, 0)]:
        yy, xx = y + dy, x + dx
        if 0 <= yy < h and 0 <= xx < w:
            img[yy, xx] = val
    return img
