"""PyTorch + CUDA port of ``ccvs_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``nn/``, ``models/``,
``generate.py``). Public tensors keep the JAX layouts: NHWC activations,
``(B, T, H, W, 3)`` videos, ``(B, nh, L, hd)`` KV caches. Entry points run on
CUDA unless given ``device="cpu"``. The two Pallas kernels of the JAX package
are hand-written CUDA here (``csrc/``), built with ``nvcc`` at first use.
"""
