"""Build and load the hand-written CUDA kernels (``ccvs_tpu_torch/csrc``).

Each ``.cu`` source is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``. No source includes
PyTorch's headers, so the build takes seconds rather than minutes. The
library is built at first use into ``ccvs_tpu_torch/_build/`` (git-ignored),
never while a module is imported, and rebuilt when a source is newer than it.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (all return an int but ccvs_error_string)
SIGNATURES = {
    # z, cb, z_split, cb_split, e2, part_val, part_idx, idx, n, k, d, splits, stream
    "ccvs_vq_argmin": (_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _p),
    "ccvs_vq_splits": (_i, _i),
    "ccvs_vq_padded_depth": (_i,),
    "ccvs_vq_padded_codes": (_i,),
    # q, k, v, pos_dev, pos_host, out, bh, len, hd, scale, dtype, stream
    "ccvs_flash_decode": (_p, _p, _p, _p, _i, _p, _i, _i, _i, _f, _i, _p),
    "ccvs_flash_decode_head_dim": (),
    # weights (struct K3Weights *), x, x_dtype, out, out_seg_stride, rows, stream
    "ccvs_int8_linear": (_p, _p, _i, _p, ctypes.c_longlong, _i, _p),
    "ccvs_int8_linear_max_rows": (),
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
    """Compile every ``csrc/*.cu`` (one ``nvcc`` process each, in parallel)
    and link them into :data:`LIB_PATH`. Returns the compilers' output
    (``-Xptxas -v``: registers, shared memory and spills per kernel), or
    ``""`` when the library is up to date."""
    srcs = _sources()
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s) for s in srcs)):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [os.path.join(tmp_dir, os.path.basename(src) + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        tmp = os.path.join(tmp_dir, "lib.so")
        # -ldl: K1 looks up cuTensorMapEncodeTiled in libcuda.so.1 with dlopen
        link_cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs, "-ldl"]
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        link = subprocess.run(link_cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{' '.join(link_cmd)}\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: a reader never sees a half-written library
    return "".join(outs) + link.stdout + link.stderr


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
