"""ctypes bindings of the native C++ loader (counterpart of
``ccvs_tpu/data/native.py``): threaded JPEG decode with a bilinear resize,
and MJPEG-AVI frame extraction, outside the Python GIL.

The library is built from the repository's ``native/loader.cpp`` at first
use, with the flags of ``native/Makefile``, into ``ccvs_tpu_torch/_build/``
(git-ignored), and rebuilt when the source is newer. Where it cannot be
built (no compiler, no ``libjpeg`` headers) :func:`available` is False and
the callers take their PIL path.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "loader.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libccvs_loader.so")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LD_FLAGS = ("-ljpeg", "-lpthread")


def build(force=False) -> Optional[str]:
    """Compile ``native/loader.cpp`` into :data:`LIB_PATH` (skipped when the
    library is newer than the source). Returns the library's path, or None
    when there is no source or the compiler fails; :data:`build_log` then
    holds why (after a build, which libjpeg the linker took)."""
    global build_log
    if not os.path.exists(SOURCE):
        build_log = f"no source {SOURCE}"
        return None
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return LIB_PATH
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        build_log = "no C++ compiler"
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # the directory the linker finds libjpeg in, searched at load time too:
    # it need not be on the loader's path
    found = subprocess.run([cxx, "-print-file-name=libjpeg.so"], capture_output=True,
                           text=True).stdout.strip()
    rpath = ([f"-Wl,-rpath,{os.path.dirname(os.path.realpath(found))}"]
             if os.path.isabs(found) else [])
    build_log = f"libjpeg for the linker: {found} -> {os.path.realpath(found)}"
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = os.path.join(tmp_dir, "lib.so")
        r = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS, *rpath],
                           capture_output=True, text=True)
        if r.returncode != 0:
            build_log = r.stdout + r.stderr
            return None
        os.replace(tmp, LIB_PATH)  # a reader never sees a half-written library
    return LIB_PATH


build_log = ""


@functools.lru_cache(maxsize=None)
def _load():
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        global build_log
        build_log = f"{e} ({build_log})"
        return None
    lib.ccvs_decode_jpeg_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.ccvs_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.ccvs_avi_frame_count.argtypes = [ctypes.c_char_p]
    lib.ccvs_avi_decode_frames.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    return lib


def available() -> bool:
    return _load() is not None


def decode_jpeg_batch(paths: Sequence[str], height: int, width: int,
                      n_threads: int = 8) -> Optional[np.ndarray]:
    """Decode and resize a batch of JPEG files -> ``(N, H, W, 3)`` uint8, or
    None (no library, or a file that failed)."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    r = lib.ccvs_decode_jpeg_batch(arr, n, height, width,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return out if r == 0 else None


def avi_frame_count(path: str) -> int:
    """Frames of an MJPEG AVI, or -1 (no library, or not such a file)."""
    lib = _load()
    if lib is None:
        return -1
    return lib.ccvs_avi_frame_count(path.encode())


def avi_decode_frames(path: str, indices: Sequence[int], height: int, width: int,
                      n_threads: int = 8) -> Optional[np.ndarray]:
    """Decode the frames ``indices`` of an MJPEG AVI -> ``(N, H, W, 3)``
    uint8, or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(indices)
    out = np.empty((n, height, width, 3), np.uint8)
    idx = (ctypes.c_int * n)(*indices)
    r = lib.ccvs_avi_decode_frames(path.encode(), idx, n, height, width,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return out if r == 0 else None
