"""Build and load the hand-written CUDA kernels (``ccvs_tpu_torch/csrc``).

All ``.cu`` sources are compiled by one ``nvcc`` call for ``sm_90a`` into one
shared library with a plain C interface, which is loaded with ``ctypes``. No
source includes PyTorch's headers, so the build takes seconds rather than
minutes. The library is built at first use into ``ccvs_tpu_torch/_build/``
(git-ignored), never while a module is imported, and rebuilt when a source is
newer than it.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libccvs_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (all return an int but ccvs_error_string)
SIGNATURES = {
    # z, cb, part_val, part_idx, idx, n, k, d, splits, stream
    "ccvs_vq_argmin": (_p, _p, _p, _p, _p, _i, _i, _i, _i, _p),
    "ccvs_vq_splits": (_i, _i),
    # q, k, v, part, out, bh, len, hd, pos, scale, dtype, stream
    "ccvs_flash_decode": (_p, _p, _p, _p, _p, _i, _i, _i, _i, _f, _i, _p),
    "ccvs_flash_decode_chunk": (),
    "ccvs_flash_decode_head_dim": (),
    "ccvs_error_string": (_i,),
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(force=False):
    """Compile every ``csrc/*.cu`` into :data:`LIB_PATH` with one ``nvcc``
    call. Returns the compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel), or ``""`` when the library is up to date."""
    srcs = _sources()
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s) for s in srcs)):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a reader never sees a half-written library
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built first if needed), argtypes declared."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_char_p if name == "ccvs_error_string" else ctypes.c_int
    return lib


def check(err, name):
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError()``)."""
    if err != 0:
        msg = library().ccvs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
