#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 ccvs_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the compared numbers
and their limits are also the last lines of standard error.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout, set
# before torch is imported; transformers, if anything loads it, keeps off JAX
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path[0] = ROOT  # the checkout, in place of this script's folder

from ccvs_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
