#!/usr/bin/env python3
"""Drive the ccvs_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its wall time:

0. device: the card's name and power limit, torch and CUDA versions;
1. build: the three CUDA kernels (``ccvs_tpu_torch/csrc``), one ``nvcc``
   process per source, started together, with the registers, shared memory
   and spills of each kernel;
2. kernels: each kernel against its plain PyTorch version at the serving
   and training paths' shapes (K2 with its position an int32 on the device, with caches of
   1024 rows at positions 0, 63, 64, 511 and 1023, of 1152 at 0, 1023, 1055
   and 1151, of 1280 at 0, 1151 and 1279, each also captured once in a CUDA
   graph and replayed at those positions; K2 at beam search's batch of 8
   after a cache reorder, also replayed; K3 bit-equal to the CPU's at the
   int8 decode step's products at B 2, q/k/v as one launch at B 2, 8 and
   16, fc1 and fc2 at B 8 and 16), then timed (CUDA events, L2 flushed,
   median; K1 at the encode shapes of the rollouts, one re-encoded frame's,
   the state quantizer's and the drums audio quantizer's (depth 16), the
   training steps' (phases 10 and 11), K2 at
   positions 63, 511, 1023, 1151 and 1279 and at batch 8, the beam's cache
   reorder, K3 at each product) beside
   its plain version, a PyTorch library call that the port never makes
   (K3: ``torch._int_mm`` alone and the bf16 step's ``F.linear``), and its
   bound (K1's against both the fp32 CUDA cores and its own three TF32
   tensor-core products); K3 also one decode step's 97 launches back to
   back against the bf16 step's 145 ``F.linear`` (one layer and the head
   first checked at the rollout's dtypes), and the host's µs a call;
3. rollout: ``VideoGenerator.generate`` on the full-width BAIR-256 config in
   bf16 from a seeded init, batch 2, 16 frames, 1 context frame: one warm-up
   (its stages timed one by one) and one timed run, with every kernel's
   launch count set to 0 just before the timed run and read just after;
4. kinetics: the same on the full-width Kinetics-600 config (64x64, 16384
   codes, 5 context frames, a 24-layer GPT over a 1280-token window), batch
   2, 24 frames: the window fills at frame 20 and slides 4 chunks of 64;
5. profile: the device's busy share and largest kernels per stage, on parts
   of the BAIR rollout (``torch.profiler``), with the token stage early and
   late in the window;
6. reference: small fp32 configurations generated greedily on the GPU and on
   the CPU (where the kernels' plain versions run) must agree: frame
   continuation, state-conditioned, point-to-point, unconditional, audio,
   class-label, deblurring, beam-search and step-by-step tokens equal and
   videos within 1e-3; int8 held to the CPU product by product
   along the GPU's tokens (each product bit-equal on the same input, each
   product's input within 1e-4 of its row's max), its video within 1e-3;
7. modes: the full-width BAIR-256 state-conditioned, point-to-point,
   unconditional and int8 rollouts, 4 frames each (``MODE_LEN``), each run once with its launches counted
   as in phase 3 and its output checked (states in [0, 1] and the context
   frame's state tokens kept; the real end frame last, the end frame's
   prefix and delta moving the first frame's tokens and its features the
   decode; int8: K3 97 launches a decode step, its ms a step beside phase
   3's, int8 logits of one decode step within 8 % of the bf16 step's);
8. drums: the full-width audio-conditioned drums rollout (128x128, 24 of
   the preset's 45 frames from 15, a seeded spectrogram's audio tokens
   given, the window slides 8 times: 576 decode steps), the audio tokens given back
   unaltered and another spectrogram shown to move the tokens;
9. serving: on full-width BAIR-256 at 4 frames, step-by-step generation
   (each frame's tokens its re-encode's), greedy beam search of 4 (the
   result the best hypothesis, the scores those of a full forward),
   ``generate_from_image`` with ``down_size`` 64, then deblurring (the
   blurred clip's tokens given back) and drawn class labels (a label shown
   to move the tokens); each run once with its launches counted as in
   phase 3;
10. train: (a) small fp32 configurations, 3 steps of the transformer step
   (plain, state-interleaved, point-to-point, ``grad_accum=2``) and of the
   state step on the card against the CPU (metrics within 1e-4, parameters
   within the Adam bound of :func:`adam_close`, the first update zero);
   (b) the full-width BAIR-256 transformer step (24 x 1024 GPT, fp32
   parameters, bf16 compute, 16 clips of 16 frames encoded by the bf16
   autoencoder), 2 warm-up and 10 timed steps on one batch, K1 once a step,
   with seconds a step, tokens a second, the encode / GPT split (CUDA
   events) and peak memory; (c) the full-width state step (96 images, K1
   twice, the state quantizer's indices the plain search's and the
   codebook's gradient that of the gather alone);
   (d) both trainers' ``run`` and resume, the checkpoint's state equal to
   the trainer's, the npz mirror holding the JAX package's GPT tree;
11. autoencoder training: (a) a small fp32 configuration (``AE_CFG`` of
   ``tests/test_train.py`` at 16 px with VGG, both discriminators, the
   feature discriminator and the unconditional head), three iterations of
   the six steps (G, D, R1 for images and video) free-running on the card,
   each step repeated on the CPU from the card's state: metrics within
   1e-4, each parameter's gradient within 1e-3 of its own largest entry
   or 1e-6 of the step's (1e-3 in the G steps), the card's parameters and
   second moments Adam's of its own gradients within fp32 rounding
   (:func:`adam_b0_update`), its EMA that of its new parameters, K1's
   indices those of the plain search; two planted faults (an update's
   sign, a gradient's sign) shown to fail the check;
   (b) full-width BAIR-256 (24 images, 4 clips of 4 frames, fp32 parameters
   under bf16 compute, seeded VGG19, EMA), 2 warm-up and 5 timed
   iterations, one with R1, K1 exactly 2 launches an iteration and 1 for
   the eval; seconds an iteration, the split by step (CUDA events), the
   dataset's host time a batch, the trainer's 8-thread loaders alone and
   feeding 6 iterations, peak memory, a profile of an iteration and of R1;
   (c) ``FrameAutoencoderTrainer.run`` with its eval, resume and npz mirror
   (the JAX ``ae_gen`` keys), ``StftAutoencoderTrainer.run`` and resume,
   ``cli.py train-ae`` then ``train-transformer --ae-ckpt``;
12. generate and score: (a) a small fp32 configuration through ``cli.py
   generate`` on the card and on the CPU, greedily (the same files, the
   real clips byte for byte, the decoded frames within a few uint8 levels),
   the eval functions on the card against the CPU (I3D and the fallback
   embedder within 1e-4 of the largest entry, PSNR and SSIM within 1e-9,
   LPIPS within 1e-5 relative), ``eval-all`` printing the JAX package's
   keys, and a planted fault (symmetric padding in the I3D stem) caught;
   (b) full-width BAIR-256 as ``bairhd_config()`` has it: ``cli.py generate
   --n-batches 1`` on a 16-clip valid set at 256 px (batch 16, with
   reconstructions; K1 exactly 3 launches, K2 24 a decode step), the
   rollout and the writing of 48 AVIs timed apart, ``eval-all --rec`` by
   pass, the port's I3D at 224 px in clips a second with its FVD, LPIPS in
   frame pairs a second, SSIM's and PSNR's time, peak memory and the host's
   stages (JPEG, scipy);
13. ADA and layouts: (a) ADA's warp, colour matrix and ``augment`` card
   against CPU on the same draws, R1's derivatives through the warp, a
   planted fault (the down pass's sym6 unflipped), the small autoencoder's
   three ADA iterations held to the CPU step by step with ``ada_p`` against
   the controller's rule, the small layout rollout and greedy
   ``generate(layout=...)``; (b) ADA at full BAIR-256 width (3 timed
   iterations, one with R1, K1 2 an iteration) and
   ``runs_r5/r5_bair_eval_config.json`` as it is; (c) the full-width layout
   rollout (4 frames of 64 frame and 64 layout tokens in a 2048-token
   window; K1 4, K2 24 x 384), a layout transformer step on 2 clips (K1 2)
   and an autoencoder iteration with layouts (K1 4);
14. GPT variants and reference checkpoints: (a) small fp32 configurations
   on the card against the CPU: the video rollout with ``emb_mode`` None
   (with state tokens) and "spatio-temporal" (tokens equal, videos within
   1e-3), a GPT on a 2 x 4 latent grid (logits within 1e-4, tokens equal)
   and a planted fault there (``h_emb`` and ``w_emb`` traded) caught,
   ``ContinuousTransformer`` with 1 and 3 proposals (rollout with and
   without ``normalize_pred``, loss and gradients within 1e-4 of the
   largest entry), ``nll_vMF`` and its gradient within 1e-5; (b) full-width
   BAIR-256 with "spatio-temporal" from ``qvid_e`` / ``qvid_q`` / ``qvid_g``
   / ``transformer_t`` state dicts in the reference's keys, drawn on the
   card, loaded through ``port_pytorch`` (every tensor equal to its
   source) and served: a 2-frame warm-up and one timed 4-frame rollout (K1
   2, K2 24 x 192), its time a decode step beside phase 3's; (c) the full-width transformer step with
   ``emb_mode`` None (1 warm-up, 3 timed steps, K1 once a step); (d)
   ``ContinuousTransformer`` at the BAIR trunk's width (24 x 16 x 1024,
   512-d inputs, 4 proposals): loss, backward and AdamW on 16 x 1024
   vectors (1 warm-up, 3 timed), then the bf16 rollout of 2 sequences from
   64 vectors to 1024 with ``normalize_pred`` (K2 exactly 24 x 959: the
   prefill gives the first new vector); (e) the autoencoder with ``z_mult``
   2 and ``normalize_out``: the encoder in fp32 on the preset's corrupted
   image batch, card against CPU from the same weights (NaN at the same
   positions, only where the latent is 0 before the division; the rest
   within fp32 tolerance), then 24 plain images: K1 at (3072, 256) x (1024,
   256) against the plain search and one image G step (K1 once);
15. autoencoder options: (a) small fp32 decoders under each option set of
   ``AE_OPTION_SETS`` (k = 3 smooth contexts, a partial mask),
   ``deform_conv3x3`` with its input and offset gradients, and
   ``decode_video`` with ``keep_first`` (``n_first`` 2, pinned) and with
   ``skip_mode`` "dec", card against CPU within 1e-5 of the largest entry,
   a planted fault (the deformable conv's ky and kx taps swapped) caught,
   and the image G step under set A held to the CPU step by step for 2
   iterations; (b) full-width BAIR-256 with set A (deformable conv, masked
   flow, tradeoff, skip-RGB, ``tanh``): a 4-frame rollout (K1 2, K2 24 x
   192), its decode stage alone, and an AE iteration with R1 at 24 images
   and 4 clips (K1 2), each step timed; (c) set B (``no_corr``,
   ``skip_mode`` "dec", ``keep_first`` with ``n_first`` 2, the tiled-x
   convs): the rollout, its decode stage a frame beside set A's, the
   preset's and phase 3's, and a 17-frame decode that pins the FIFO; (d)
   ``aspect_ratio`` 2 (256 x 512, ``z_shape`` (8, 16), ``no_proj``): K1 at
   (3072, 512) x (1024, 512) against the plain search, one image G step (K1
   once) and one image D step at 24 images, timed, with the peak memory;
16. data, utilities and the parallel layer: (a) a raw BAIR-HD tree in the
   softmotion layout (17 trajectories of 30 JPEGs) through
   ``preprocess_bairhd`` at dim 256, ``compute_folds`` /
   ``compute_metadata`` on AVIs of the prepared frames, the native loader
   built from ``native/loader.cpp`` (or why not) and its
   ``decode_jpeg_batch`` of 256 JPEGs of 256x256 on 8 threads timed
   against PIL, the prepared tree through the BAIR dataset and
   ``PrefetchLoader``; (b) ``init_distributed`` over NCCL at world size 1
   and ``make_mesh(1)``: phase 10 (b)'s full-width transformer step fed by
   (a)'s loader, unwrapped once, then through DP and FSDP (the first
   step's ``nll`` and ``gnorm`` those of the unwrapped step from the same
   state, 3 timed steps each, K1 exactly once a step, seconds and peak
   beside phase 10 (b)'s; FSDP's parameters DTensors split over ``data``),
   a small fp32 configuration unwrapped / DP / FSDP within 1e-6 of the
   largest entry, and a DP autoencoder iteration with and without R1 at
   phase 11 (b)'s batch beside it (K1 2 an iteration); (c) the dry run
   (``run_tiny_multichip_step``) at world 1, then two processes on the one
   card over gloo, the card's tensors in the collectives, whose tiny DP
   step equals one process's; (d) on the DP trainer, ``trace()`` around
   three steps (its largest kernels; K1's three launches of each of its
   kernels), an async save of the whole GPT state while the next step runs
   (that step beside one without a save in flight; the loaded state
   bit-equal to the saved one) and ``sync_triggered`` at world 1.

Phase 0 prints the card's name and power limit; the last three lines are the
kernels' JSON record, the card line again, and the result line ``{"ok":
true, "device": {...}}``. Any failure raises and exits non-zero without a
result line. Without a CUDA device the script fails at once.

Modes for fault 4 (PERF.md §7), each printing JSON lines:
``python3 chip_smoke.py trace-kink [SEED]`` runs phase 11 (a) at data seed
SEED (default 6) and traces its worst video G step's worst gradient entry to
the kinks where the card and the CPU decide differently (:func:`trace_kink`);
``trace-ops``, ``ae-seeds`` and ``conditioning`` (:func:`trace_ops`,
:func:`ae_seeds`, :func:`conditioning`); ``kink-conditioning [SEED
[DRAWS]]`` compares the decisions of the CPU's unperturbed pass of that step
with its passes under one rounding of the parameters
(:func:`kink_conditioning`).
"""

import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import torch

from ccvs_bench import common
from ccvs_bench.counts import kernels
from ccvs_bench.tracer import DeviceTrace
from ccvs_tpu_torch.utils import profiling

# peaks beside the benchmark's (ccvs_bench/counts/kernels.py: HBM, TF32, bf16)
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_INT8_PER_S = 1979e12    # H100 SXM int8 on the tensor cores, dense
CARD = torch.device("cuda")
BATCH, VID_LEN = 2, 16
# frames of the rollouts that drive one mode each (phases 7, 9, 13 (c),
# 14 (b) and 15; 8 until phase 16 came) and of the drums clip (phase 8,
# from 45): depth cut to keep the script within half its time limit;
# phases 3 and 4 roll out at full depth
MODE_LEN, DRUMS_LEN = 4, 24
ROLLOUT_S = {}  # the wall time of each rollout of run_path, by name
DECODE_S = {}  # phase_rollout's warm-up decode stage, seconds a generated frame, by name
KINETICS_LEN = 24  # frames: past the 20 of the 1280-token window, so it slides
TRAIN_REF = {}  # phase 10 (b)'s and 11 (b)'s seconds and peaks, beside phase 16's


def log(*parts):
    print(*parts, flush=True)


def phase(name):
    """Context manager printing the phase's wall time when it ends."""

    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            log(f"== phase {name}")

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                log(f"== phase {name}: {time.perf_counter() - self.t0:.1f} s")

    return _Phase()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=25, warmup=3, flush_l2=True):
    """Median device time of ``fn`` in ms, with the 50 MB L2 cache flushed
    before each timed launch (callers on the serving path find it cold)
    unless ``flush_l2`` is False.

    A 1 GiB write (~0.3 ms of device work) precedes each timed launch either
    way, so the host has queued the start event, ``fn``'s launches and the
    end event before the device reaches them: the events time the device's
    work, not the host's enqueue. Without the flush, ``fn`` runs once more
    after that write, so its inputs are back in L2."""
    import torch

    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        flush.zero_()
        if not flush_l2:
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops, peak_ops):
    """The least time of ``n_ops`` operations at ``peak_ops`` and ``n_bytes``
    at the HBM peak (``ccvs_bench/counts/kernels.py bound_s``) in ms, and
    which of the two sets it."""
    t = kernels.bound_s(n_ops, n_bytes, peak_ops)
    return 1e3 * t, ("bytes" if t == n_bytes / kernels.PEAK_HBM else "operations")


def kernel_launches(kernel):
    """The tracer's count of ``kernel``'s launches (``k1``, ``k2``, ``k3``)
    since its last ``profiling.reset()``."""
    return profiling.counters().get(f"{kernel}.launches", 0)


def check_vq(z, cb):
    """K1 against its plain version; returns (near-tie count, max distance gap)."""
    import torch
    from ccvs_tpu_torch.ops.vq import vq_indices, vq_indices_plain

    idx = vq_indices(z, cb)
    ref = vq_indices_plain(z, cb)
    torch.cuda.synchronize()
    assert idx.is_cuda and idx.shape == (z.shape[0],) and idx.dtype == torch.int32
    diff = (idx != ref).nonzero().flatten()
    gap = 0.0
    if len(diff):
        zd, cd = z[diff].double(), cb.double()
        d_k = ((zd - cd[idx[diff].long()]) ** 2).sum(1)
        d_p = ((zd - cd[ref[diff].long()]) ** 2).sum(1)
        rel = (d_k - d_p).abs() / d_p.abs().clamp_min(1e-30)
        if not bool((rel < 1e-5).all()):
            raise AssertionError(f"vq_indices: {len(diff)} rows differ, worst relative "
                                 f"distance gap {float(rel.max()):.3g} (>= 1e-5)")
        gap = float((d_k - d_p).abs().max())
    return len(diff), gap


def check_flash_decode(out, q, kc, vc, pos, what):
    """K2's output against the fp32 plain version: within 2e-2, and element
    by element within 2^-7 |ref| + 1e-3 (bf16 output rounding is 2^-8
    relative). Returns the max abs error."""
    import torch
    from ccvs_tpu_torch.ops.attention import flash_decode_plain

    ref = flash_decode_plain(q.float(), kc.float(), vc.float(), pos)
    torch.cuda.synchronize()
    assert out.is_cuda and out.dtype == q.dtype and out.shape == q.shape
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    excess = float((diff - 2**-7 * ref.abs()).max())
    log(f"K2 flash_decode {what}: max abs error {err:.3g} (max |ref| "
        f"{float(ref.abs().max()):.3g}) against the fp32 plain version; worst error "
        f"over 2^-7 |ref| {excess:.3g}")
    if not err <= 2e-2:
        raise AssertionError(f"flash_decode {what}: max abs error {err} > 2e-2")
    if not excess <= 1e-3:
        raise AssertionError(f"flash_decode {what}: error exceeds 2^-7 |ref| + 1e-3 "
                             f"by {excess - 1e-3:.3g}")
    return err


def phase_kernels(records):
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.ops.attention import flash_decode_attention, flash_decode_plain
    from ccvs_tpu_torch.ops.vq import vq_indices, vq_indices_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    # K1 at the rollouts' shapes: the encode of 2 x 16 frames x 64 tokens and
    # the context re-encode (BAIR: 1024 codes of 512; Kinetics-600: 16384 of
    # 256, and 2 x 24 frames), the state quantizer's 2 x 16 frames x 2
    # coordinates against 128 scalar codes, one frame's re-encode (step by
    # step), the drums encode of 2 x 45 frames and its 15 context frames, the
    # drums audio quantizer's 2 x 45 frames x 16 latents of depth 16 against
    # 1024 codes, and training's (phase 10): the BAIR step's encode of 16 x
    # 16 frames, the state step's of 96 images and its quantizer of 96 x 2
    # states, and the autoencoder's (phase 11): the image G step's 24 images
    # and the video G step's 4 clips of 4 frames; timed but for the context
    # re-encodes. The layout quantizer (phase 13) runs at shapes of this list:
    # the layout rollout's (2048, 512) and its context's (128, 512), the AE
    # iteration's (1536, 512) and (1024, 512), the transformer step's 2 clips
    # (2048, 512), all against a codebook of 1024; phase 14's image G step
    # with z_mult 2 splits each of its 1536 latents in two: (3072, 256);
    # phase 15 (d)'s image G step at aspect_ratio 2 has 24 latents of 8 x 16
    # positions: (3072, 512)
    shapes = []
    for n, d, k, timed in ((2048, 512, 1024, True), (128, 512, 1024, True),
                           (2048, 256, 16384, True), (640, 256, 16384, False),
                           (3072, 256, 16384, True), (64, 1, 128, True),
                           (5760, 512, 1024, True), (1920, 512, 1024, False),
                           (1440, 16, 1024, True), (16384, 512, 1024, True),
                           (6144, 512, 1024, True), (192, 1, 128, True),
                           (1536, 512, 1024, True), (1024, 512, 1024, True),
                           (3072, 256, 1024, True), (3072, 512, 1024, True)):
        z = torch.randn(n, d, device="cuda", generator=g)
        cb = torch.randn(k, d, device="cuda", generator=g) * 0.1
        ties, gap = check_vq(z, cb)
        what = (f"K1 vq_argmin z ({n}, {d}) x codebook ({k}, {d}) fp32: indices equal but "
                f"{ties} near-ties (max distance gap {gap:.3g})")
        if not timed:
            log(what)
            continue
        ms = time_ms(lambda: vq_indices(z, cb))
        plain = time_ms(lambda: vq_indices_plain(z, cb))
        lib = time_ms(lambda: torch.cdist(z, cb).argmin(1))
        flops, n_bytes = kernels.k1_work(n, k, d)
        fp32, _ = bound_ms(n_bytes, flops, PEAK_FP32_PER_S)
        bnd, by = bound_ms(n_bytes, flops, kernels.PEAK_TF32)
        log(f"{what}; kernel {ms:.4f} ms, plain {plain:.4f} ms, cdist+argmin {lib:.4f} ms; "
            f"bound {bnd:.4f} ms at the TF32 peak, the algorithm's 2nkd once ({by}; "
            f"{100 * bnd / ms:.1f}% of it), {fp32:.4f} ms on the fp32 CUDA cores, bytes alone "
            f"{n_bytes / kernels.PEAK_HBM * 1e3:.4f} ms")
        shapes.append({"n": n, "k": k, "d": d, "max_abs_err": gap, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                       "bound_fp32_cuda_cores_ms": fp32})
    # the record's numbers are the BAIR shape's; "shapes" has both
    records["vq_argmin"] = {
        "name": "vq_argmin", "route": "cuda", "source": "ccvs_tpu_torch/csrc/vq.cu",
        "replaces": "ccvs_tpu/ops/vq_pallas.py:59", "launches": None,
        **{key: shapes[0][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "bound_fp32_cuda_cores_ms")},
        "shapes": shapes, "launches_by_rollout": {}}

    # K2 at the GPT decode shape: q (2, 16, 64), caches (2, 16, L, 64), bf16,
    # the position an int32 on the device, as the decode step gives it. L 1024
    # is the BAIR, p2p and int8 rollouts' cache, 1152 the state and
    # unconditional ones' (one full 16 KB tile and a ragged one of 16 rows a
    # CTA), 1280 the Kinetics-600 window's (a full tile and 32 rows)
    # B 16 at L 1024 is the rollout of ``cli.py generate`` (phase 12): a valid
    # batch of 16 clips; L 2048 the layout rollout's window (phase 13: 16
    # frames of 64 frame and 64 layout tokens)
    nh, hd = 16, 64
    pos_t = torch.zeros(1, dtype=torch.int32, device="cuda")
    worst, shapes = 0.0, []
    for b, length, checked, timed in ((2, 1024, (0, 63, 64, 511, 1023), (63, 511, 1023)),
                                      (2, 1152, (0, 1023, 1055, 1151), (1151,)),
                                      (2, 1280, (0, 1151, 1279), (1279,)),
                                      (16, 1024, (0, 511, 1023), (1023,)),
                                      (2, 2048, (0, 1023, 1151, 2047), (2047,))):
        q = torch.randn(b, nh, hd, device="cuda", generator=g).bfloat16()
        kc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
        vc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
        for pos in checked:
            pos_t.fill_(pos)
            out = flash_decode_attention(q, kc, vc, pos_t)
            worst = max(worst, check_flash_decode(out, q, kc, vc, pos,
                                                  f"B={b} L={length} pos={pos}"))
        # one launch captured in a CUDA graph serves every position
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = flash_decode_attention(q, kc, vc, pos_t)
        for pos in checked:
            pos_t.fill_(pos)
            graph.replay()
            worst = max(worst, check_flash_decode(out, q, kc, vc, pos,
                                                  f"B={b} L={length} CUDA-graph replay "
                                                  f"pos={pos}"))
        for pos in timed:
            pos_t.fill_(pos)
            ms = time_ms(lambda: flash_decode_attention(q, kc, vc, pos_t))
            plain = time_ms(lambda: flash_decode_plain(q, kc, vc, pos_t))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc[:, :, :pos + 1], vc[:, :, :pos + 1]))
            live = pos + 1
            bnd, by = bound_ms(2 * (2 * b * nh * hd + 2 * b * nh * live * hd),
                               4 * b * nh * live * hd, PEAK_FP32_PER_S)
            log(f"K2 flash_decode B={b} L={length} pos={pos} bf16: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}; "
                f"{100 * bnd / ms:.1f}% of it)")
            shapes.append({"batch": b, "length": length, "pos": pos, "ms": ms,
                           "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
                           "bound_by": by})
        if length == 1024 and b == 2:
            # what the timer shows for any launch, and K2 with its inputs in L2
            floor = time_ms(lambda: pos_t.fill_(pos))
            warm = time_ms(lambda: flash_decode_attention(q, kc, vc, pos_t), flush_l2=False)
            log(f"K2 flash_decode pos={pos} bf16 with the caches in L2: {warm:.4f} ms; the same "
                f"timer around a one-element fill_ launch: {floor:.4f} ms")
    worst = max(worst, phase_beam_attention(g, pos_t, shapes))
    # the record's numbers are those at L 1024, pos 1023; "shapes" has all
    at_1023 = next(r for r in shapes if r["pos"] == 1023)
    records["flash_decode"] = {
        "name": "flash_decode", "route": "cuda", "source": "ccvs_tpu_torch/csrc/flash_decode.cu",
        "replaces": "ccvs_tpu/ops/attention_pallas.py:64", "launches": None,
        "max_abs_err": worst, **{key: at_1023[key] for key in ("ms", "plain_ms", "bound_ms",
                                                               "bound_by", "library_ms")},
        "shapes": shapes, "launches_by_rollout": {}}
    phase_int8_linear(records)


def phase_beam_attention(g, pos_t, shapes):
    """K2 at beam search's batch: 2 clips x 4 hypotheses, L 1024, bf16. The
    caches are reordered as a pruning step reorders them (a gather of whole
    batch rows into the second buffer); K2 on the reordered caches must give
    the rows of its output on the old ones in the new order, exactly, and
    agree with the plain version, launched directly and replayed from a
    CUDA graph captured before the reorder. Timed at pos 1023 beside SDPA,
    and a step's reorder of the 24 layers' k and v (one ``index_select``
    each) beside its bytes bound. Returns the max abs error."""
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.ops.attention import flash_decode_attention, flash_decode_plain

    b, nh, hd, length, n_layer = 8, 16, 64, 1024, 24
    q = torch.randn(b, nh, hd, device="cuda", generator=g).bfloat16()
    kc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
    vc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
    kr, vr = torch.empty_like(kc), torch.empty_like(vc)
    parent = torch.tensor([1, 1, 0, 3, 6, 4, 4, 4], device="cuda")  # rows kept, per clip
    worst = 0.0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = flash_decode_attention(q, kr, vr, pos_t)
    for pos in (0, 511, 1023):
        pos_t.fill_(pos)
        before = flash_decode_attention(q, kc, vc, pos_t)
        torch.index_select(kc, 0, parent, out=kr)
        torch.index_select(vc, 0, parent, out=vr)
        out = flash_decode_attention(q, kr, vr, pos_t)
        qp = q[parent]
        if not torch.equal(flash_decode_attention(qp, kr, vr, pos_t), before[parent]):
            raise AssertionError(f"flash_decode B=8 pos={pos}: the reordered caches do not "
                                 "give the reordered output")
        worst = max(worst, check_flash_decode(out, q, kr, vr, pos,
                                              f"B=8 L={length} pos={pos} after a cache reorder"))
        graph.replay()
        worst = max(worst, check_flash_decode(replayed, q, kr, vr, pos,
                                              f"B=8 L={length} CUDA-graph replay pos={pos} "
                                              "after a cache reorder"))
    pos = 1023
    pos_t.fill_(pos)
    ms = time_ms(lambda: flash_decode_attention(q, kr, vr, pos_t))
    plain = time_ms(lambda: flash_decode_plain(q, kr, vr, pos_t))
    lib = time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr))
    bnd, by = bound_ms(2 * (2 * b * nh * hd + 2 * b * nh * length * hd),
                       4 * b * nh * length * hd, PEAK_FP32_PER_S)
    log(f"K2 flash_decode B=8 (2 clips x beam 4) L={length} pos={pos} bf16: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}; "
        f"{100 * bnd / ms:.1f}% of it)")
    shapes.append({"batch": b, "length": length, "pos": pos, "ms": ms, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": bnd, "bound_by": by})
    # the reorder of a beam step, k and v of every layer: whole, as the port
    # gathers them, and the rows written so far at pos 512, their mean over
    # a 1024-token rollout (a strided gather, which the port does not make)
    kl = torch.zeros(n_layer, b, nh, length, hd, dtype=torch.bfloat16, device="cuda")
    vl, kl2, vl2 = (torch.zeros_like(kl) for _ in range(3))
    for rows in (length, length // 2):
        ms = time_ms(lambda: [torch.index_select(src[:, :, :, :rows], 1, parent,
                                                 out=dst[:, :, :, :rows])
                              for src, dst in ((kl, kl2), (vl, vl2))])
        n_bytes = 2 * 2 * kl[:, :, :, :rows].numel() * kl.element_size()
        log(f"beam cache reorder, rows [0, {rows}) of 24 layers x k and v of "
            f"{tuple(kl.shape[1:])} bf16 ({n_bytes / 2 / 1e9:.2f} GB gathered): {ms:.4f} ms, "
            f"bytes bound {n_bytes / kernels.PEAK_HBM * 1e3:.4f} ms")
    del kl, vl, kl2, vl2
    return worst


K3_SHAPES = {"q/k/v": (1024, 1024), "proj": (1024, 1024), "fc1": (1024, 4096),
             "fc2": (4096, 1024), "head": (1024, 1024)}  # the BAIR-256 step's (in, out)
K3_LAYERS = 24  # the BAIR-256 GPT's


def k3_product(g, rows, product, segments=1, dtype=None, with_bias=True, bias_dtype=None):
    """x and one K3 launch (an ``Int8Linear``) at one of the BAIR-256 decode
    step's products, seeded, on the card; x has exact halves after scaling.
    The biases are in x's dtype unless ``bias_dtype`` is given."""
    import torch
    from ccvs_tpu_torch.ops.int8_linear import Int8Linear

    inner, out = K3_SHAPES[product]
    dtype = dtype or torch.float32
    x = torch.randn(rows, inner, device="cuda", generator=g).to(dtype)
    x[min(1, rows - 1), :3] = torch.tensor([127.0, 0.5, -2.5])
    w8s = [torch.randint(-127, 128, (out, inner), device="cuda", generator=g, dtype=torch.int8)
           for _ in range(segments)]
    scales = [torch.rand(out, device="cuda", generator=g) * 1e-3 + 1e-4 for _ in range(segments)]
    biases = [torch.randn(out, device="cuda", generator=g).to(bias_dtype or dtype)
              if with_bias else None for _ in range(segments)]
    return x, Int8Linear(w8s, scales, biases)


def k3_check(x, lin, what):
    """K3 on the card bit-equal to the plain version on the CPU, weight by
    weight."""
    import torch
    from ccvs_tpu_torch.ops.int8_linear import int8_linear_plain

    got = lin(x).cpu().reshape(len(lin.w8s), x.shape[0], -1)
    for i, (w8, scale, bias) in enumerate(zip(lin.w8s, lin.scales, lin.biases)):
        want = int8_linear_plain(x.cpu(), w8.cpu(), scale.cpu(),
                                 None if bias is None else bias.cpu())
        if not torch.equal(got[i], want):
            raise AssertionError(f"K3 {what}, weight {i}: differs from the CPU's plain version "
                                 f"by {float((got[i] - want).abs().max())}")


def k3_times(g, x, lin):
    """K3's time (L2 flushed) beside its bytes bound, its plain version on
    the card, ``torch._int_mm`` alone on int8 operands of the same shape and
    bf16 ``F.linear`` (the weights stacked into one call where K3 takes
    several)."""
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.ops.int8_linear import int8_matmul

    rows, inner = x.shape
    n, out = len(lin.w8s), lin.out_features
    ms = time_ms(lambda: lin(x))
    plain = time_ms(lambda: lin.plain(x))
    x8 = torch.randint(-127, 128, (rows, inner), device="cuda", generator=g, dtype=torch.int8)
    w_all = torch.cat(lin.w8s)
    int_mm = time_ms(lambda: int8_matmul(x8, w_all))
    wb = (torch.randn(n * out, inner, device="cuda", generator=g) * 0.02).bfloat16()
    xb = x.bfloat16()
    bb = None if lin.biases[0] is None else torch.cat(lin.biases).bfloat16()
    lin_ms = time_ms(lambda: F.linear(xb, wb, bb))
    n_bytes = (x.element_size() * x.numel() + n * (out * inner + 4 * out + 4 * rows * out)
               + sum(b.element_size() * out for b in lin.biases if b is not None))
    bnd, by = bound_ms(n_bytes, 2 * rows * inner * out * n, PEAK_INT8_PER_S)
    return {"ms": ms, "plain_ms": plain, "int_mm_ms": int_mm, "bf16_linear_ms": lin_ms,
            "bound_ms": bnd, "bound_by": by}


def events_ms(fn, iters=5):
    """The median of ``iters`` runs of ``fn`` (after one more), each under
    one event pair after a device sleep long enough for the host to queue
    all of ``fn``'s launches: their device time back to back."""
    import torch

    times = []
    for _ in range(iters + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues every launch meanwhile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def k3_step_back_to_back(g, rows, iters=5, trace=False):
    """One BAIR-256 decode step's products back to back, as the rollout
    launches them: K3 over 24 layers' distinct weights (q/k/v fused, proj,
    fc1, fc2; and the head: 97 launches, 289 MB of int8, past the 50 MB L2)
    and the bf16 step's 145 ``F.linear`` (578 MB), each timed by
    :func:`events_ms`. The first layer's products and the head are first
    held bit-equal to the CPU at the rollout's dtypes (fp32 x, bf16 x into
    proj; the bf16 model's biases). With ``trace``, also the kernels' own
    device time (profiler). Returns (K3 ms a launch, bf16 ms a launch, K3 ms
    the step's products, bf16 ms the step's products)."""
    import torch
    import torch.nn.functional as F

    calls, lins = [], []
    inputs = {"h": torch.randn(rows, 1024, device="cuda", generator=g),
              "y": torch.randn(rows, 1024, device="cuda", generator=g).bfloat16(),
              "h4": torch.randn(rows, 4096, device="cuda", generator=g)}
    for _ in range(K3_LAYERS):
        for product, segments, xin in (("q/k/v", 3, "h"), ("proj", 1, "y"), ("fc1", 1, "h"),
                                       ("fc2", 1, "h4")):
            # the bf16 model's biases, as in the rollout
            _, lin = k3_product(g, 1, product, segments,
                                torch.bfloat16 if xin == "y" else torch.float32,
                                bias_dtype=torch.bfloat16)
            calls.append((lin, inputs[xin]))
    _, head = k3_product(g, 1, "head", with_bias=False)
    calls.append((head, inputs["h"]))
    for (lin, x), what in zip(calls[:4] + calls[-1:], ("q/k/v", "proj", "fc1", "fc2", "head")):
        k3_check(x, lin, f"{what} B {rows} at the rollout's dtypes")
    xb = inputs["h"].bfloat16()
    xb4 = inputs["h4"].bfloat16()
    for lin, x in calls:
        wb = (torch.randn(len(lin.w8s) * lin.out_features, lin.in_features, device="cuda",
                          generator=g) * 0.02).bfloat16()
        for w in wb.split(lin.out_features):
            lins.append((w.contiguous(), None if lin.biases[0] is None else
                         torch.randn(lin.out_features, device="cuda", generator=g).bfloat16(),
                         xb4 if lin.in_features == 4096 else xb))
        del wb

    run_k3 = lambda: [lin(x) for lin, x in calls]  # noqa: E731
    run_bf16 = lambda: [F.linear(x, w, b) for w, b, x in lins]  # noqa: E731
    k3, bf16 = events_ms(run_k3, iters), events_ms(run_bf16, iters)
    # the kernels' own device time, without the gaps between them (profiler)
    for what, fn in (("K3", run_k3), ("bf16 F.linear", run_bf16)) if trace else ():
        _, busy, by_name, count = device_profile(fn)
        top = ", ".join(f"{name[:60]} {1e6 * t / count[name]:.2f} µs x {count[name]}"
                        for name, t in by_name[:3])
        log(f"  {what} B {rows} traced: {1e3 * busy:.4f} ms in kernels; {top}")
    return k3 / len(calls), bf16 / len(lins), k3, bf16


def host_us(fn, n=1000):
    """The host's µs a call over ``n`` calls, synchronised once at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def k3_ab():
    """``python3 chip_smoke.py k3-ab``: K3 one weight a call, its arguments
    checked at each (as every tree of the port since K3 can call it), at the
    BAIR-256 decode step's products at B 2, 8 and 16 (L2 flushed), one decode
    step's 145 products back to back on 24 layers' weights at B 2, the
    host's µs a call (fc1, B 2), and the int8 and bf16 BAIR-256 rollouts at
    ``MODE_LEN`` frames (ms a decode step all in, median of 3 after one
    warm-up). Prints one ``k3-ab:`` JSON line. Copied into the root of an
    earlier tree and run there, it measures that tree's K3 and rollouts on
    the same card."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.ops import int8_linear as k3_module

    if hasattr(k3_module, "Int8Linear"):
        def k3(x, w8, scale, bias):
            return k3_module.Int8Linear([w8], [scale], [bias])(x)
    else:  # the trees before Int8Linear
        k3 = k3_module.int8_linear
    g = torch.Generator(device="cuda").manual_seed(6)

    def weights(product, dtype=torch.float32):
        inner, out = K3_SHAPES[product]
        return (torch.randint(-127, 128, (out, inner), device="cuda", generator=g,
                              dtype=torch.int8),
                torch.rand(out, device="cuda", generator=g) * 1e-3 + 1e-4,
                torch.randn(out, device="cuda", generator=g).to(dtype))

    res = {"card": card_line(), "products": {}}
    for product in K3_SHAPES:
        for rows in (2, 8, 16):
            w8, scale, bias = weights(product)
            x = torch.randn(rows, w8.shape[1], device="cuda", generator=g)
            if not torch.equal(k3(x, w8, scale, bias).cpu(), k3_module.int8_linear_plain(
                    x.cpu(), w8.cpu(), scale.cpu(), bias.cpu())):
                raise AssertionError(f"k3-ab: {product} B {rows} differs from the plain version")
            res["products"][f"{product} B {rows}"] = time_ms(lambda: k3(x, w8, scale, bias))
    calls = []
    h, h4 = (torch.randn(2, n, device="cuda", generator=g) for n in (1024, 4096))
    y = torch.randn(2, 1024, device="cuda", generator=g).bfloat16()
    for _ in range(K3_LAYERS):
        for product, x in (("q/k/v", h), ("q/k/v", h), ("q/k/v", h), ("proj", y), ("fc1", h),
                           ("fc2", h4)):
            calls.append((x, *weights(product, torch.bfloat16)))
    w8, scale, _ = weights("head")
    calls.append((h, w8, scale, None))
    res["step_145_ms"] = events_ms(lambda: [k3(*call) for call in calls])
    res["step_ms_a_launch"] = res["step_145_ms"] / len(calls)
    w8, scale, bias = weights("fc1")
    x = torch.randn(2, 1024, device="cuda", generator=g)
    res["host_us"] = host_us(lambda: k3(x, w8, scale, bias))
    wb, xb, bb = w8.bfloat16(), x.bfloat16(), bias.bfloat16()
    res["bf16_linear_host_us"] = host_us(lambda: F.linear(xb, wb, bb))
    del calls
    torch.cuda.empty_cache()
    base = bairhd_config()
    steps = (MODE_LEN - 1) * base.gpt.size
    res["rollout_ms_a_step"] = {}
    for cfg in (dataclasses.replace(base, name="bairhd_int8",
                                    gpt=dataclasses.replace(base.gpt, serve_int8=True)), base):
        _, _, gen = build_models(cfg)
        vid = clip(cfg, MODE_LEN)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate(vid, torch.Generator(device="cuda").manual_seed(4), rec=False,
                         n_ctx_frames=1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res["rollout_ms_a_step"][cfg.name] = 1e3 * statistics.median(times[1:]) / steps
        del gen
        torch.cuda.empty_cache()
    ms = res["rollout_ms_a_step"]
    res["int8_over_bf16"] = ms["bairhd_int8"] / ms[base.name]
    log("k3-ab: " + json.dumps(res))


def phase_int8_linear(records):
    """K3 (the int8 decode step's products with their activation
    quantization, scaling and bias) bit-equal to its plain version on the
    CPU and timed at the BAIR-256 decode step's shapes: the five products at
    B 2, q/k/v as one launch at B 2, 8 and 16, fc1 and fc2 at B 8 and 16;
    each beside its bytes bound, its plain version on the card (the
    ``torch._int_mm`` route), ``torch._int_mm`` alone and bf16 ``F.linear``.
    Then one decode step's products back to back on 24 layers' weights (K3
    against bf16 ``F.linear``, B 2 and 16; one layer and the head checked at
    the rollout's dtypes), and the host's µs a call."""
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.ops.int8_linear import Int8Linear, div127

    g = torch.Generator(device="cuda").manual_seed(6)
    # on the card a division by a Python number is a multiplication by the
    # rounded reciprocal: the scales the port divides out as the CPU does
    a = torch.rand(2**20, device="cuda", generator=g) * 4
    off = int(((a / 127.0) != div127(a)).sum())
    log(f"int8 scales: a / 127.0 on the card differs from a / 127 rounded once in {off} of "
        f"{a.numel()} fp32 values in [0, 4)")
    shapes = []
    cases = [("q/k/v", 2, 1, torch.float32), ("proj", 2, 1, torch.bfloat16),
             ("fc1", 2, 1, torch.float32), ("fc2", 2, 1, torch.float32),
             ("head", 2, 1, torch.float32), ("q/k/v", 2, 3, torch.float32),
             ("q/k/v", 8, 3, torch.float32), ("q/k/v", 16, 3, torch.float32),
             ("fc1", 8, 1, torch.float32), ("fc1", 16, 1, torch.float32),
             ("fc2", 8, 1, torch.float32), ("fc2", 16, 1, torch.float32)]
    for product, rows, segments, dtype in cases:
        x, lin = k3_product(g, rows, product, segments, dtype, with_bias=product != "head")
        name = f"{product}{' fused' if segments > 1 else ''} B {rows}"
        k3_check(x, lin, name)
        t = k3_times(g, x, lin)
        inner, out = K3_SHAPES[product]
        log(f"K3 int8_linear {name}: x ({rows}, {inner}) {str(dtype)[6:]} x {segments} w8 "
            f"({out}, {inner}), bit-equal to the CPU; kernel {t['ms']:.4f} ms, plain (_int_mm "
            f"route) {t['plain_ms']:.4f} ms, _int_mm alone {t['int_mm_ms']:.4f} ms, bf16 "
            f"F.linear {t['bf16_linear_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.1f}% of it)")
        shapes.append({"shape": name, "in": inner, "out": out, "rows": rows,
                       "segments": segments, **t})
    step = {}
    for rows in (2, 16):
        k3, bf16, k3_all, bf16_all = k3_step_back_to_back(g, rows, trace=rows == 2)
        step[rows] = {"k3_ms_a_launch": k3, "bf16_ms_a_launch": bf16,
                      "k3_ms_a_step": k3_all, "bf16_ms_a_step": bf16_all}
        log(f"K3 one decode step back to back, B {rows}: 97 launches {k3_all:.4f} ms = "
            f"{k3:.5f} ms a launch; bf16 F.linear 145 launches {bf16_all:.4f} ms = "
            f"{bf16:.5f} ms a launch")
    torch.cuda.empty_cache()
    x, fc1 = k3_product(g, 2, "fc1")
    xq, qkv = k3_product(g, 2, "q/k/v", 3)
    w8, scale, bias = fc1.w8s[0], fc1.scales[0], fc1.biases[0]
    wb, xb, bb = w8.bfloat16(), x.bfloat16(), bias.bfloat16()
    host = {"thin": host_us(lambda: fc1(x)), "qkv_thin": host_us(lambda: qkv(xq)),
            "checked": host_us(lambda: Int8Linear([w8], [scale], [bias])(x)),
            "bf16_linear": host_us(lambda: F.linear(xb, wb, bb))}
    log(f"K3 host µs a call (1000 calls, one synchronize; fc1 B 2): the decode step's "
        f"Int8Linear {host['thin']:.2f}, its fused q/k/v {host['qkv_thin']:.2f}, an Int8Linear "
        f"built and checked at every call {host['checked']:.2f}; bf16 F.linear "
        f"{host['bf16_linear']:.2f}")
    # the record's numbers are fc1's at B 2, the largest weight of the rollout's
    fc1_b2 = next(r for r in shapes if r["shape"] == "fc1 B 2")
    records["int8_linear"] = {
        "name": "int8_linear", "route": "cuda", "source": "ccvs_tpu_torch/csrc/int8_linear.cu",
        "replaces": "ccvs_tpu/nn/quantized.py:66", "launches": None, "max_abs_err": 0.0,
        **{key: fc1_b2[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "shapes": shapes, "step_back_to_back": step,
        "host_us": host, "launches_by_rollout": {}}


def phase_k3(card):
    """Phase 2's K3 part, then the BAIR-256 int8 rollout (``serve_int8``)
    and the bf16 one at ``MODE_LEN`` frames, launches counted as in phase 7."""
    import dataclasses

    from ccvs_tpu_torch.config import bairhd_config

    records = {key: {"launches": None, "launches_by_rollout": {}}
               for key in ("vq_argmin", "flash_decode")}
    with phase("2 K3"):
        phase_int8_linear(records)
    base = bairhd_config()
    steps = (MODE_LEN - 1) * base.gpt.size
    for cfg in (dataclasses.replace(base, name="bairhd_int8",
                                    gpt=dataclasses.replace(base.gpt, serve_int8=True)), base):
        with phase(f"7 {cfg.name} at {MODE_LEN} frames"):
            _, _, gen = build_models(cfg)
            vid = clip(cfg, MODE_LEN)
            run_path(records, card, cfg, gen, vid, 1, 2, steps, name=cfg.name + " warm-up")
            _, dt = run_path(records, card, cfg, gen, vid, 1, 2, steps)
            log(f"{cfg.name}: {1e3 * dt / steps:.2f} ms a decode step all in")
            del gen


def build_models(cfg):
    """The port's models of ``cfg`` in bf16 on the card from seeded inits (the
    state or STFT model, in fp32 as the JAX package keeps them, where ``cfg``
    conditions on states or audio)."""
    import torch
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, StateModel, StftModel, TokenTransformer

    t0 = time.perf_counter()
    ae = FrameAutoencoder(cfg.ae, dtype=torch.bfloat16).init(seed=0)
    tr = TokenTransformer(cfg.gpt, dtype=torch.bfloat16).init(seed=1)
    sm = StateModel(cfg.state).init(seed=7) if cfg.gpt.state and not cfg.gpt.stft else None
    stft = StftModel(cfg.stft).init(seed=8) if cfg.gpt.stft else None
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (ae, tr, sm, stft) if m is not None
                   for p in m.parameters())
    log(f"{cfg.name} init: {n_params / 1e6:.1f} M parameters in {time.perf_counter() - t0:.1f} s")
    return ae, tr, VideoGenerator(cfg, ae, tr, state_model=sm, stft_model=stft)


def clip(cfg, vid_len):
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    return torch.rand(BATCH, vid_len, cfg.ae.max_dim, cfg.ae.max_dim, 3, device="cuda",
                      generator=g) * 2 - 1


def run_path(records, card, cfg, gen, vid, n_ctx, k1, k2_steps, run=None, name=None, **kw):
    """One ``generate`` (``kw`` its further arguments), or ``run(generator)``
    in its place, on the card with every kernel's count set to 0 just before
    it and read just after: K1 must have launched ``k1`` times, K2 once a
    layer in each of ``k2_steps`` decode steps, and K3 (with ``serve_int8``)
    once a product in each of them (q/k/v as one, proj, fc1, fc2 a layer,
    and the head), else never. ``vid`` has the shape of the clip that comes out. The rollout is
    recorded as ``name`` (default ``cfg.name``). Returns the output and its
    wall time."""
    import torch

    name = name or cfg.name
    vid_len = vid.shape[1]
    n_layer = cfg.gpt.n_layer
    want = {"vq_argmin": k1, "flash_decode": n_layer * k2_steps,
            "int8_linear": (4 * n_layer + 1) * k2_steps if cfg.gpt.serve_int8 else 0}
    counted = {"vq_argmin": "k1", "flash_decode": "k2", "int8_linear": "k3"}
    if run is None:
        def run(g):
            return gen.generate(vid, g, rec=False, n_ctx_frames=n_ctx, **kw)
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run(torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {key: kernel_launches(k) for key, k in counted.items()}
    ROLLOUT_S[name] = dt

    fake = out["fake"]
    assert fake.is_cuda, "fake video is not on the GPU"
    assert fake.shape == (BATCH, vid_len, cfg.ae.max_dim, cfg.ae.max_dim, 3), fake.shape
    assert bool(torch.isfinite(fake).all()), "fake video has non-finite values"
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want} (K1 {k1}; "
                             f"{k2_steps} decode steps of {n_layer} layers)")
    for key, n in launches.items():
        if records[key]["launches"] is None and n:  # the first rollout that ran it
            records[key]["launches"] = n
        records[key]["launches_by_rollout"][name] = n
    # generated frames: past the context, and before the real end frame in p2p
    frames = BATCH * (vid_len - n_ctx - int(cfg.gpt.p2p))
    log(f"{name} rollout: {dt:.3f} s for {frames} generated frames = {frames / dt:.4f} "
        f"frames/s (batch {BATCH}, {vid_len} frames, {n_ctx} context), {k2_steps} decode "
        f"steps ({1e3 * dt / max(k2_steps, 1):.2f} ms each, all in), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, on {card}")
    return out, dt


def decode_ops_per_layer(tr, code):
    """PyTorch operations dispatched by one layer of one decode step (the
    step's host cost is ~25 eager calls a layer; K2 goes through ctypes and
    is not among them)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    model = tr.model
    with torch.no_grad():
        cache = model.init_cache(BATCH, 128)
        emb1 = model.embed_one(code[:, 0], 0, 0)[:, None]
        pos = torch.zeros(1, dtype=torch.int32, device="cuda")
        block = model.core.blocks[0]
        block(emb1, (cache[0][0], cache[1][0]), pos)
        with Count():
            block(emb1, (cache[0][0], cache[1][0]), pos)
    return Count.n


def decode_step_ms(tr, steps=200):
    """Host ms a full-width decode step at batch 2 and 16 over the window's
    cache from position 512, eager and replayed from the step's CUDA graph
    (``DecodeGraph``, as the rollout replays it): ``steps`` steps after 20
    of warm-up, one synchronize at the end; K2 counted 24 a step in both."""
    import torch

    from ccvs_tpu_torch.models.transformer import DecodeGraph
    from ccvs_tpu_torch.nn.gpt import cache_to_layers, decode_step_fn

    model, n_layer = tr.model, tr.cfg.n_layer
    with torch.no_grad():
        for b in (2, 16):
            graph = DecodeGraph(model, decode_step_fn, b, tr.cfg.z_len)
            layers = cache_to_layers(graph.cache)
            emb = torch.randn(b, 1, tr.cfg.n_embd, device="cuda").to(model.dtype)
            pos = torch.zeros(1, dtype=torch.int32, device="cuda")

            def eager():
                decode_step_fn(model, emb, pos, layers)
                pos.add_(1)

            ms = {}
            for name, step in (("eager", eager), ("graphed", lambda: graph.replay(emb))):
                for n in (20, steps):
                    pos.fill_(512)
                    graph.pos.fill_(512)
                    profiling.reset()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        step()
                    ms[name] = 1e3 * (common.synced(CARD) - t0) / n
                    if kernel_launches("k2") != n_layer * n:
                        raise AssertionError(f"{name} decode step: K2 {kernel_launches('k2')} "
                                             f"launches in {n} steps of {n_layer} layers")
            log(f"decode step at batch {b} from position 512 ({steps} steps): eager "
                f"{ms['eager']:.3f} ms, graphed {ms['graphed']:.3f} ms "
                f"({ms['eager'] / ms['graphed']:.2f}x)")
            del graph


def phase_rollout(records, card, cfg, n_ctx, vid_len=VID_LEN, k1=2, k2_steps=None):
    """Warm-up with its stages timed, then one timed ``generate`` with every
    kernel's launch count read around it (default K2 steps: the tokens past
    the context, all in one window); returns the models, the clip and the
    warm-up's tokens."""
    import torch

    ae, tr, gen = build_models(cfg)
    vid = clip(cfg, vid_len)
    size = cfg.ae.tokens_per_frame
    # warm-up: the calls generate() makes, one by one, each timed
    stages = {}
    t0 = time.perf_counter()
    enc = ae.encode(vid)
    stages["encode"] = common.synced(CARD) - t0
    t0 = time.perf_counter()
    ctx_code = enc["code"].reshape(BATCH, -1)[:, :n_ctx * size]
    code = tr.generate(ctx_code, torch.Generator(device="cuda").manual_seed(3),
                       total_len=vid_len * size)["code"]
    stages["tokens"] = common.synced(CARD) - t0
    t0 = time.perf_counter()
    ae.decode_video(code.reshape(BATCH, vid_len, size), ctx_frames=vid[:, :n_ctx], n_ctx=n_ctx)
    stages["decode"] = common.synced(CARD) - t0
    DECODE_S[cfg.name] = stages["decode"] / (vid_len - n_ctx)
    log(f"{cfg.name} warm-up rollout by stage: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; total {sum(stages.values()):.3f} s")
    # K1: the encode of the clip and the re-encode of its context frames
    run_path(records, card, cfg, gen, vid, n_ctx, k1,
             (vid_len - n_ctx) * size if k2_steps is None else k2_steps)
    return ae, tr, vid, code


def check_p2p(cfg, gen, vid, out):
    """What point-to-point changes, at the width of ``cfg`` (``generate()``
    itself appends the real end frame, so the last frame shows nothing):
    the end frame's token prefix and its ``delta`` reach the sampling (the
    first generated frame, sampled from one seed, changes when ``delta`` is
    one less or each prefix token is another; run after the rollout, with
    seeded positional embeddings), and the end frame's features
    reach the decode (the rollout's first generated frame is the decode with
    them, nearer than the decode without them)."""
    import torch

    ae, tr = gen.ae, gen.transformer
    b, t = vid.shape[:2]
    size = cfg.ae.tokens_per_frame
    enc = ae.encode(vid)
    code_all = enc["code"].reshape(b, -1)
    ctx = code_all[:, :size]
    # the seeded init zeroes the positional embeddings, as the JAX package's
    # does, and then no delta could show: give them seeded values first
    g = torch.Generator(device=vid.device).manual_seed(9)
    with torch.no_grad():
        for emb in (tr.model.s_emb, tr.model.t_emb):
            emb.copy_(torch.randn(emb.shape, generator=g, device=vid.device) * 0.02)
    first = {}
    end = code_all[:, -size:]
    # a seeded random autoencoder maps noise frames to nearly one code, so
    # another frame's tokens are no other prefix: each token moved by one is
    for name, cond, delta in (("end frame, delta T-1", end, t - 1),
                              ("end frame, delta T-2", end, t - 2),
                              ("tokens + 1, delta T-1", (end + 1) % cfg.gpt.z_num, t - 1)):
        first[name] = tr.generate(
            ctx, torch.Generator(device=vid.device).manual_seed(8), cond_code=cond,
            delta=torch.full((b,), delta, dtype=torch.long, device=vid.device),
            total_len=3 * size)["code"][:, size:2 * size]
    ref = first.pop("end frame, delta T-1")
    moved = {name: float((c != ref).float().mean()) for name, c in first.items()}
    if not all(moved.values()):
        raise AssertionError(f"p2p: the first generated frame does not follow the prefix: {moved}")
    codes = out["code"][:, :2 * size].reshape(b, 2, size)
    inter = [f[:, -1] for f in enc["inter"]]
    err = {}
    for name, cond_inter in (("with", inter), ("without", None)):
        dec = ae.decode_video(codes, ctx_frames=vid[:, :1], n_ctx=1, cond_inter=cond_inter)
        err[name] = float((dec[:, 1].float() - out["fake"][:, 1].float()).abs().max())
    log(f"{cfg.name}: first generated frame's tokens changed in {moved} of places (the prefix "
        f"and delta reach the sampling); its pixels differ from a decode with the end frame's "
        f"features by {err['with']:.3g}, without them by {err['without']:.3g}")
    if not err["with"] < err["without"]:
        raise AssertionError(f"p2p: the rollout's decode does not use the end frame's features "
                             f"({err})")


def phase_modes(records, card):
    """The controllable BAIR-256 modes at full width, each run once on the
    card (no warm-up), its launches asserted and its output checked."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import (bairhd_config, bairhd_p2p_config, bairhd_state_config,
                                       bairhd_unc_config)
    from ccvs_tpu_torch.nn.gpt import cache_to_layers, decode_step_fn
    from ccvs_tpu_torch.nn.quantized import decode_step_fn_int8, quantize_gpt_int8

    size = 64  # tokens a frame in every BAIR preset
    # state: 2 state tokens before each frame's 64 (a 1056-token window);
    # (MODE_LEN - 1) x 66 decode steps past the context frame's 66 tokens. K1: the encode,
    # the state quantizer, the context re-encode
    cfg = bairhd_state_config()
    _, _, gen = build_models(cfg)
    vid = clip(cfg, MODE_LEN)
    out, _ = run_path(records, card, cfg, gen, vid, 1, 3, (MODE_LEN - 1) * (size + 2))
    fs = out["fake_state"]
    if fs.shape != (BATCH, MODE_LEN, 2) or not bool(((fs >= 0) & (fs <= 1)).all()):
        raise AssertionError(f"fake_state: shape {tuple(fs.shape)}, range "
                             f"[{float(fs.min())}, {float(fs.max())}] (expected [0, 1])")
    real = gen.state_model.encode(state=out["state"])
    if not torch.equal(out["state_code"][:, :2], real[:, :2]):
        raise AssertionError("state: the context frame's state tokens were not kept")
    log(f"{cfg.name}: fake_state {tuple(fs.shape)} in [{float(fs.min()):.4f}, "
        f"{float(fs.max()):.4f}], the context frame's state tokens kept")
    del gen

    # p2p: the end frame's 64 tokens are a prefix; (MODE_LEN - 2) x 64 decode steps past the
    # context frame, before the real end frame
    cfg = bairhd_p2p_config()
    _, _, gen = build_models(cfg)
    vid = clip(cfg, MODE_LEN)
    out, _ = run_path(records, card, cfg, gen, vid, 1, 2, (MODE_LEN - 2) * size)
    if not torch.equal(out["fake"][:, -1], vid[:, -1].to(out["fake"].dtype)):
        raise AssertionError("p2p: the last frame is not the real end frame")
    log(f"{cfg.name}: the last frame is the real end frame")
    check_p2p(cfg, gen, vid, out)
    del gen

    # unconditional: a start token and no context frame; 256 decode steps
    cfg = bairhd_unc_config()
    _, _, gen = build_models(cfg)
    run_path(records, card, cfg, gen, clip(cfg, MODE_LEN), 0, 1, MODE_LEN * size)
    del gen

    # int8: bairhd with serve_int8; 192 decode steps
    base = bairhd_config()
    cfg = dataclasses.replace(base, name="bairhd_int8",
                              gpt=dataclasses.replace(base.gpt, serve_int8=True))
    ae, tr, gen = build_models(cfg)
    vid = clip(cfg, MODE_LEN)
    out, dt = run_path(records, card, cfg, gen, vid, 1, 2, (MODE_LEN - 1) * size)
    int8_ms = 1e3 * dt / ((MODE_LEN - 1) * size)
    bf16_ms = 1e3 * ROLLOUT_S["bairhd"] / ((VID_LEN - 1) * size) if "bairhd" in ROLLOUT_S else None
    records["int8_linear"]["rollout_ms_a_step"] = {"int8": int8_ms, "bf16 (phase 3)": bf16_ms}
    log(f"{cfg.name}: {int8_ms:.2f} ms a decode step all in (K3 {4 * cfg.gpt.n_layer + 1} "
        f"launches a step); phase 3's bf16 rollout "
        + ("not run" if bf16_ms is None else f"{bf16_ms:.2f} ms a step ({int8_ms / bf16_ms:.3f}x)"))
    # one decode step at the rollout's last position (255 tokens cached),
    # int8 against bf16
    model = tr.model
    code = out["code"]
    pos = MODE_LEN * size - 1
    with torch.no_grad():
        cache = model.init_cache(BATCH, pos + 1)
        s_idx = torch.arange(pos, device="cuda") % size
        model.prefill(model.embed_one(code[:, :pos], s_idx, torch.arange(pos, device="cuda") // size),
                      cache)
        cache = cache_to_layers(cache)
        emb1 = model.embed_one(code[:, pos], pos % size, pos // size)[:, None]
        pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
        ref = decode_step_fn(model, emb1, pos_t, cache).float()
        got = decode_step_fn_int8(model, quantize_gpt_int8(model), emb1, pos_t, cache).float()
    rel = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-6))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"{cfg.name}: one decode step at position {pos}: int8 logits within {rel:.4f} of the "
        f"bf16 step's (max |diff| / max |ref|, limit 0.08); argmax agreement {agree:.2f}")
    if not rel < 0.08:
        raise AssertionError(f"int8 decode step: {rel} >= 0.08 of the bf16 step's logits")


def spectrogram(vid_len, seed):
    """Seeded spectrogram patches in [-1, 1], one a frame, ``(B, T, 64, 16, 1)``:
    a level and a drifting grating each, so that patches differ."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (BATCH, vid_len, 1, 1, 1)
    ff = torch.linspace(0, 1, 64, device="cuda")[:, None, None]
    tt = torch.linspace(0, 1, 16, device="cuda")[None, :, None]
    f, w, ph, lvl = (lo + (hi - lo) * torch.rand(shape, device="cuda", generator=g)
                     for lo, hi in ((0.5, 6), (0.5, 6), (0, 6.3), (-0.6, 0.6)))
    return (lvl + 0.4 * torch.sin(2 * torch.pi * (f * ff + w * tt) + ph)).clamp(-1, 1)


def phase_drums(records, card):
    """The audio-conditioned drums preset at full width: ``DRUMS_LEN`` (24)
    of its 45 frames, continued from 15 with a seeded spectrogram's audio
    tokens as the whole given state stream. The window (16 frames of 16
    audio + 64 frame tokens) fills at frame 16 (64 decode steps past 1216
    given tokens), then slides 8 times, each a re-prefill of 1216 given
    tokens and 64 decode steps: 576 steps. K1: the frame encode, the audio
    encode and the context re-encode."""
    import torch
    from ccvs_tpu_torch.config import drums_config

    cfg = drums_config()
    vid_len, n_ctx, size = DRUMS_LEN, cfg.gpt.cond_len // 64, 64
    _, tr, gen = build_models(cfg)
    sm = gen.stft_model
    # a seeded codebook far from the latents maps every patch to one code:
    # draw it from the encoded latents of another seeded spectrogram, as
    # long as the preset's clip
    with torch.no_grad():
        lat = sm.encoder(spectrogram(cfg.data.vid_len, 11)).reshape(-1, cfg.stft.stft_size).float()
        pick = torch.randperm(len(lat), generator=torch.Generator().manual_seed(12))
        sm.quantizer.embedding.copy_(lat[pick[:cfg.stft.stft_num].to(lat.device)])
    vid, spec = clip(cfg, vid_len), spectrogram(vid_len, 13)
    windows = 1 + (vid_len - 16)  # the fill, then one slide a frame
    out, _ = run_path(records, card, cfg, gen, vid, n_ctx, 3, windows * size, stft=spec)
    audio = sm.encode(spec)
    if not torch.equal(out["state_code"], audio):
        raise AssertionError("drums: the given audio tokens did not come back unaltered")
    # another spectrogram moves the tokens of the first generated frame
    ctx = out["code"][:, :n_ctx * size]
    first = [tr.generate(ctx, torch.Generator(device="cuda").manual_seed(14), state_code=a,
                         total_len=cfg.gpt.z_len)["code"][:, n_ctx * size:]
             for a in (audio, sm.encode(spectrogram(vid_len, 15)))]
    moved = float((first[0] != first[1]).float().mean())
    log(f"drums: {len(audio.unique())} distinct audio tokens of {audio.numel()}, given back "
        f"unaltered; another spectrogram changes {100 * moved:.1f}% of the first generated "
        "frame's tokens")
    if not moved:
        raise AssertionError("drums: the audio tokens do not reach the sampling")


def phase_serving(records, card):
    """The rest of serving on full-width BAIR-256, bf16, batch 2, each run
    once with its launches counted, 4 frames each (``MODE_LEN``):
    step-by-step generation, ``generate_from_image`` with ``down_size`` 64,
    greedy beam search of 4 hypotheses, then deblurring and class labels as
    ``bairhd_config`` overrides."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config

    base = bairhd_config()
    size = 64
    steps = (MODE_LEN - 1) * size  # 192: 3 frames past the context frame
    ae, tr, gen = build_models(base)
    vid = clip(base, MODE_LEN)

    # step by step: 7 chunks (a 1024-token prefill and 64 steps each), each
    # frame decoded and re-encoded: K1 1 + 7
    out, _ = run_path(records, card, base, gen, vid, 1, 1 + MODE_LEN - 1, steps,
                      run=lambda g: gen.generate_step_by_step(vid, g, n_ctx_frames=1),
                      name="bairhd_step_by_step")
    # each frame re-encoded alone, as the loop encodes it (a batch of 30
    # frames takes other bf16 convolution algorithms)
    reenc = torch.cat([ae.encode(out["fake"][:, i])["code"] for i in range(1, MODE_LEN)], dim=1)
    if not torch.equal(out["code"][:, size:], reenc):
        raise AssertionError("step by step: a generated frame's tokens are not its re-encode's")
    batched = ae.encode(out["fake"][:, 1:])["code"].reshape(BATCH, -1)
    log(f"bairhd_step_by_step: every generated frame's tokens are those of its re-encode; "
        f"re-encoding the {BATCH * (MODE_LEN - 1)} frames as one batch changes "
        f"{100 * float((batched != reenc).float().mean()):.2f}% of them (bf16)")

    # generate_from_image: one 256x256 frame, degraded to 64x64 and back,
    # continued to MODE_LEN frames: K1 2 (the clip's encode, the context re-encode)
    img = vid[:, 0]
    run_path(records, card, base, gen, vid, 1, 2, steps,
             run=lambda g: gen.generate_from_image(img, g, vid_len=MODE_LEN, down_size=64),
             name="bairhd_from_image_down64")
    del gen, tr

    # greedy beam search, 4 hypotheses a clip: K2 at batch 8; every frame
    # position prunes 16 candidates to 4 and reorders the caches
    cfg = dataclasses.replace(base, name="bairhd_beam4", gpt=dataclasses.replace(
        base.gpt, beam_size=4, sample=False, no_sample=True))
    _, tr, gen = build_models(cfg)
    beams = []
    fill_beam = tr._fill_beam

    def record(*args):
        beams.append(fill_beam(*args))
        return beams[-1]

    tr._fill_beam = record
    out, dt = run_path(records, card, cfg, gen, vid, 1, 2, steps)
    del tr._fill_beam
    (hyps, log_p), = beams
    best = log_p.argmax(1)
    if not torch.equal(out["code"], hyps[torch.arange(BATCH), best]):
        raise AssertionError("beam: the result is not the best-scored hypothesis")
    # each hypothesis' score against a full forward of its tokens
    flat = hyps.reshape(-1, hyps.shape[-1])
    with torch.no_grad():
        logits = tr.model(flat[:, :-1])[:, size - 1:].float() / cfg.gpt.temperature
        thresh = logits.topk(cfg.gpt.top_k, dim=-1).values[..., -1:]
        lp = torch.log_softmax(logits.masked_fill(logits < thresh, float("-inf")), -1)
    score = lp.gather(2, flat[:, size:, None])[..., 0].sum(1).reshape(log_p.shape)
    rel = float(((score - log_p).abs() / log_p.abs()).max())
    log(f"bairhd_beam4: the result is hypothesis {best.tolist()}, the best of the summed "
        f"log-probabilities {[[round(v, 3) for v in row] for row in log_p.tolist()]}; a full "
        f"bf16 forward of each hypothesis gives its score within {rel:.2e} (relative, limit 1e-2)")
    if not rel < 1e-2:
        raise AssertionError(f"beam: the tracked scores differ from the hypotheses' by {rel}")
    del gen, tr, hyps

    # deblurring: the blurred clip's 64 tokens a frame are the given state
    # stream before each frame's 64 (8 frames would fill the 1024-token
    # window); decode steps from the first generated frame's tokens, at 192,
    # to 128 a frame. K1: the clip's encode, the blurred clip's, the blurred
    # context's
    cfg = dataclasses.replace(base, name="bairhd_deblur", gpt=dataclasses.replace(
        base.gpt, deblurring=True, state_size=64, state_num=1024, blur_sigma=10))
    ae, _, gen = build_models(cfg)
    short = vid[:, :MODE_LEN]
    out, _ = run_path(records, card, cfg, gen, short, 1, 3, (2 * MODE_LEN - 3) * size)
    if not torch.equal(out["state_code"], ae.encode(out["blur"])["code"].reshape(BATCH, -1)):
        raise AssertionError("deblurring: the blurred clip's tokens did not come back unaltered")
    log(f"bairhd_deblur: the blurred clip's tokens given back unaltered; blur moved the frames "
        f"by {float((out['blur'] - short).abs().mean()):.4f} on average")
    del gen

    # class labels (101, UCF-101's classes), drawn at random: a label before
    # the body, MODE_LEN - 1 frames of 64 decode steps
    cfg = dataclasses.replace(base, name="bairhd_cat101", gpt=dataclasses.replace(
        base.gpt, cat=True, num_lbl=101))
    _, tr, gen = build_models(cfg)
    out, _ = run_path(records, card, cfg, gen, short, 1, 2, (MODE_LEN - 1) * size)
    lbl = out["vid_lbl"]
    if not bool(((lbl >= 0) & (lbl < 101)).all()):
        raise AssertionError(f"class labels: drawn labels {lbl.tolist()} out of range")
    first = [tr.generate(out["code"][:, :size], torch.Generator(device="cuda").manual_seed(16),
                         lbl=l, total_len=2 * size)["code"][:, size:]
             for l in (lbl, (lbl + 1) % 101)]
    moved = float((first[0] != first[1]).float().mean())
    log(f"bairhd_cat101: labels {lbl.tolist()}; the next label changes {100 * moved:.1f}% of "
        "the first generated frame's tokens")
    if not moved:
        raise AssertionError("class labels: the label does not reach the sampling")


def device_profile(fn):
    """``fn()`` timed without the profiler, then traced
    (``ccvs_bench/tracer.py``): (wall s, device busy s (the union of the
    device operations' intervals), device time by kernel name, largest
    first, launches by kernel name)."""
    t0 = time.perf_counter()
    fn()
    wall = common.synced(CARD) - t0
    with DeviceTrace() as trace:
        fn()
    by_name = trace.by_name()
    return (wall, trace.busy_s, sorted(((k, t) for k, (t, _) in by_name.items()),
                                       key=lambda kv: -kv[1]),
            {k: n for k, (_, n) in by_name.items()})


def phase_profile(ae, tr, vid, code):
    """Device busy share and the largest kernels of each stage, on parts of
    the rollout: the 16-frame encode, 64 token decode steps early (positions
    64-127, after a 64-token prefill) and late (positions 960-1023, after a
    960-token prefill, where K2 reads the whole cache), a 4-frame decode."""
    import torch

    size = ae.cfg.tokens_per_frame
    n_ctx = 1  # the BAIR rollout's
    late = (VID_LEN - 1) * size
    work = {
        "encode (2 x 16 frames)": lambda: ae.encode(vid),
        "tokens early (prefill 64 + 64 decode steps at positions 64-127)": lambda: tr.generate(
            code[:, :n_ctx * size], torch.Generator(device="cuda").manual_seed(5),
            total_len=(n_ctx + 1) * size),
        f"tokens late (prefill {late} + 64 decode steps at positions {late}-{late + size - 1})":
            lambda: tr.generate(code[:, :late], torch.Generator(device="cuda").manual_seed(6),
                                total_len=late + size),
        "decode (4 frames, 1 context)": lambda: ae.decode_video(
            code[:, :4 * size].reshape(BATCH, 4, size), ctx_frames=vid[:, :n_ctx], n_ctx=n_ctx),
    }
    for name, fn in work.items():
        wall, busy, kernels, count = device_profile(fn)
        if not kernels:
            log(f"profile {name}: wall {wall:.4f} s; device time not measured "
                "(the profiler recorded no device events)")
            continue
        log(f"profile {name}: wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}% of wall, idle {100 * (1 - busy / wall):.1f}%)")
        for kname, t in kernels[:6]:
            log(f"    {100 * t / busy:5.1f}%  {t * 1e3:9.3f} ms  {kname[:110]}")
        k2 = [(t, count[kname]) for kname, t in kernels if "flash_decode" in kname]
        if k2:
            t, n = sum(t for t, _ in k2), sum(n for _, n in k2)
            log(f"    K2 flash_decode: {100 * t / busy:.1f}% of device time, {n} launches, "
                f"{t / n * 1e6:.2f} us each")


INT8_INPUT_TOL = 1e-4  # of a row's largest magnitude; an int8 step is 1/127 of it


def int8_lockstep(models, code, n0):
    """The int8 decode step on the card held to the CPU's along the GPU's
    greedy tokens ``code`` from ``n0`` given ones, product by product. Both
    devices quantize the same weights (``w8`` and scales bit-equal); the CPU
    starts from the card's cache after the prefill and steps in lockstep,
    each of its products replaced by the card's. Then:

    - each product on the card (K3) is bit-equal to the CPU's plain int8
      product of the card's own input: the same int8 activations, int32
      sums, scaling and bias;
    - each product's input on the card (the LayerNorms, K2's attention, the
      GELU, the residual stream) is within ``INT8_INPUT_TOL`` of its row's
      largest magnitude of the CPU's own input from the same state;
    - each GPU token is the argmax of the card's logits.

    Returns (products checked, the worst input difference)."""
    import torch
    from ccvs_tpu_torch.nn import quantized
    from ccvs_tpu_torch.nn.gpt import cache_to_layers

    gm, cm = models["cuda"][1].model, models["cpu"][1].model
    qg, qc = quantized.quantize_gpt_int8(gm), quantized.quantize_gpt_int8(cm)

    def leaves(q):
        return [t for layer in q["layers"] for group in layer.values() for w in group.values()
                for t in w.values()] + list(q["head"].values())

    if not all(torch.equal(a.cpu(), b) for a, b in zip(leaves(qg), leaves(qc))):
        raise AssertionError("reference int8: w8 or scales differ between the card and the CPU")
    dot = quantized._dot_int8_shared
    products, state = [], {"n": 0, "card": 0, "worst": 0.0}

    def on_card(x, product):
        out = dot(x, product)
        products.append((x, out))
        state["card"] += len(product.w8s)
        return out

    def on_cpu(x, product):
        if not products:
            raise AssertionError("reference int8: the CPU made more products than the card")
        xg, og = (t.cpu() for t in products.pop(0))
        want = dot(xg, product)
        if not torch.equal(og, want):  # each weight of a shared-input launch
            raise AssertionError(f"reference int8: product {state['n']} on the card differs "
                                 "from the CPU's int8 product of the same input")
        ref = x.float()
        diff = (xg.float() - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
        state["n"] += len(product.w8s)
        state["worst"] = max(state["worst"], float(diff.max()))
        return og

    size, length, dev = gm.cfg.size, code.shape[1], code.device
    ar = torch.arange(length, device=dev)
    buf = torch.zeros_like(code)  # the prefill of generate(): zeros past the given tokens
    buf[:, :n0] = code[:, :n0]
    try:
        with torch.no_grad():
            first, cache = gm.prefill(gm.embed_one(buf, ar % size, ar // size),
                                      gm.init_cache(code.shape[0], length))
            cache_g = cache_to_layers(cache)
            cache_c = tuple(tuple(t.cpu() for t in side) for side in cache_g)
            logits = first[:, n0 - 1]
            for j in range(n0, length):
                if not torch.equal(logits.argmax(-1), code[:, j]):
                    raise AssertionError(f"reference int8: token {j} is not the argmax of the "
                                         "card's logits")
                if j == length - 1:
                    break
                tok = code[:, j]
                pos = torch.full((1,), j, dtype=torch.int32, device=dev)
                quantized._dot_int8_shared = on_card
                logits = quantized.decode_step_fn_int8(
                    gm, qg, gm.embed_one(tok, j % size, j // size)[:, None], pos, cache_g)
                quantized._dot_int8_shared = on_cpu
                quantized.decode_step_fn_int8(
                    cm, qc, cm.embed_one(tok.cpu(), j % size, j // size)[:, None], j, cache_c)
                quantized._dot_int8_shared = dot
                if products or state["n"] != state["card"]:
                    raise AssertionError("reference int8: the devices made different products")
    finally:
        quantized._dot_int8_shared = dot
    if not state["worst"] <= INT8_INPUT_TOL:
        raise AssertionError(f"reference int8: a product's input differs by {state['worst']} of "
                             f"its row's max between the card and the CPU (> {INT8_INPUT_TOL})")
    return state["n"], state["worst"]


def phase_reference():
    """Small fp32 configs, greedy: the GPU path (kernels) against the CPU path
    (the kernels' plain versions, which the CPU tests hold against ccvs_tpu),
    for frame continuation and the state, p2p, unconditional, int8, audio
    (STFT), class-label, deblurring and beam-search modes, and step-by-step
    generation."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import (AutoencoderConfig, Config, StateConfig, StftConfig,
                                       TransformerConfig)
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, StateModel, StftModel, TokenTransformer

    ae_cfg = AutoencoderConfig(necf=16, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64,
                               z_shape=(4, 4), max_dim=32, skip_memory=3,
                               skip_context=(1, 2, 3))
    base = TransformerConfig(z_num=64, z_len=64, z_chunk=16, num_blocks=4, cond_len=16,
                             n_layer=2, n_head=2, n_embd=128, z_shape=(4, 4), top_k=1,
                             top_k_state=1)
    state_cfg = StateConfig(z_size=16, z_shape=(4, 4), state_hsize=8, state_size=2, state_num=8)
    stft_cfg = StftConfig(stft_size=16, stft_shape=(8, 2), stft_hsize=16, stft_num=64)
    # a frame's 16 tokens after its 16 audio (or blurred-frame) tokens
    stream = dict(z_len=128, z_chunk=32, state_num=64, state_size=16)
    vid = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    spec = torch.rand(2, 4, 64, 16, 1, generator=torch.Generator().manual_seed(6)) * 2 - 1
    modes = {  # name: (transformer config, context frames, generate() arguments)
        "frame": (base, 1, {}),
        "state": (dataclasses.replace(base, z_len=72, z_chunk=18, state=True, state_num=8,
                                      state_size=2, sample_state=True), 1, {}),
        "p2p": (dataclasses.replace(base, p2p=True), 1, {}),
        "unconditional": (dataclasses.replace(base, use_start_token=True, cond_len=0), 0, {}),
        "int8": (dataclasses.replace(base, serve_int8=True), 1, {}),
        "audio": (dataclasses.replace(base, stft=True, **stream), 1, {"stft": spec}),
        "class labels": (dataclasses.replace(base, cat=True, num_lbl=7), 1,
                         {"vid_lbl": torch.tensor([3, 5])}),
        "deblurring": (dataclasses.replace(base, deblurring=True, blur_sigma=2, **stream), 1,
                       {}),
        "beam": (dataclasses.replace(base, beam_size=3, top_k=5, sample=False, no_sample=True),
                 1, {}),
        "step by step": (base, 1, None),
    }
    # one set of weights for both devices (the two generators' streams differ)
    ae_cpu = FrameAutoencoder(ae_cfg, dtype=torch.float32, device="cpu").init(seed=0)
    sm_cpu = StateModel(state_cfg, device="cpu").init(seed=2)
    stft_cpu = StftModel(stft_cfg, device="cpu").init(seed=3)
    for name, (gpt_cfg, n_ctx, kw) in modes.items():
        cfg = Config(ae=ae_cfg, gpt=gpt_cfg, state=state_cfg, stft=stft_cfg)
        tr_cpu = TokenTransformer(gpt_cfg, dtype=torch.float32, device="cpu").init(seed=1)
        outs, models = {}, {}
        for dev in ("cuda", "cpu"):
            ae = FrameAutoencoder(ae_cfg, dtype=torch.float32, device=dev)
            ae.load_state_dict(ae_cpu.state_dict())
            tr = TokenTransformer(gpt_cfg, dtype=torch.float32, device=dev)
            tr.load_state_dict(tr_cpu.state_dict())
            sm = stft = None
            if gpt_cfg.state:
                sm = StateModel(state_cfg, device=dev)
                sm.load_state_dict(sm_cpu.state_dict())
            if gpt_cfg.stft:
                stft = StftModel(stft_cfg, device=dev)
                stft.load_state_dict(stft_cpu.state_dict())
            gen = VideoGenerator(cfg, ae, tr, state_model=sm, stft_model=stft)
            g = torch.Generator(device=dev).manual_seed(0)
            if kw is None:
                outs[dev] = gen.generate_step_by_step(vid.to(dev), g, n_ctx_frames=n_ctx)
            else:
                outs[dev] = gen.generate(vid.to(dev), g, rec=True, n_ctx_frames=n_ctx,
                                         **{k: v.to(dev) for k, v in kw.items()})
            models[dev] = ae, tr
        gpu, cpu = outs["cuda"], outs["cpu"]
        assert gpu["fake"].is_cuda
        if gpt_cfg.serve_int8:
            # int8 rounds every activation, so an ulp of fp32 difference
            # upstream can move one int8 step and tip a greedy choice: the
            # step is held to the CPU's product by product instead, along
            # the GPU's tokens, and the CPU decodes those tokens
            n, worst = int8_lockstep(models, gpu["code"], n_ctx * gpt_cfg.size)
            same = int((gpu["code"].cpu() == cpu["code"]).all(-1).sum())
            log(f"reference int8: {n} products on the card bit-equal to the CPU's of the same "
                f"input; inputs within {worst:.3g} of their row's max of the CPU's (tolerance "
                f"{INT8_INPUT_TOL}); free-running greedy tokens equal in {same} of 2 clips")
            ae = models["cpu"][0]
            cpu["code"] = gpu["code"].cpu()
            cpu["fake"] = ae.decode_video(cpu["code"].reshape(2, -1, gpt_cfg.size),
                                          ctx_frames=vid[:, :n_ctx], n_ctx=n_ctx)
        for key in ("code", "state_code"):
            if key in cpu and not torch.equal(gpu[key].cpu(), cpu[key]):
                raise AssertionError(f"reference {name}: greedy {key} differs between the GPU "
                                     "and the CPU path")
        for key in ("fake", "rec", "state", "fake_state", "blur"):
            if key not in cpu:
                continue
            err = float((gpu[key].cpu() - cpu[key]).abs().max())
            log(f"reference {name}: {key} max abs difference GPU vs CPU {err:.3g} "
                "(tolerance 1e-3)")
            if not err <= 1e-3:
                raise AssertionError(f"reference {name} {key}: GPU and CPU differ by {err} > 1e-3")


# ---------------- phase 10: training ----------------


def small_train_config(**gpt):
    """Phase 10's small configuration: phase 6's autoencoder widths at 64 px
    (8x8 tokens a frame), a 2-layer GPT of width 128 with 2 heads over 4
    frames, batches of 4 clips of 4 frames (8 images for the state step)."""
    import dataclasses

    from ccvs_tpu_torch.config import (AutoencoderConfig, Config, DataConfig, StateConfig,
                                       TransformerConfig)

    ae = AutoencoderConfig(necf=16, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64, z_shape=(8, 8),
                           max_dim=64, skip_memory=3, skip_context=(1, 2, 3))
    g = TransformerConfig(z_num=64, z_len=256, z_chunk=64, num_blocks=4, cond_len=64, n_layer=2,
                          n_head=2, n_embd=128, z_shape=(8, 8), lr=1e-3)
    data = DataConfig(dataset="synthetic", max_dim=64, true_dim=64, vid_len=4, batch_size_vid=4,
                      batch_size_img=8, num_workers=2, load_state=True)
    state = StateConfig(z_size=16, z_shape=(8, 8), state_hsize=8, state_size=2, state_num=8)
    return Config(name="train_small", data=data, ae=ae, gpt=dataclasses.replace(g, **gpt),
                  state=state, n_iter=4, save_latest_freq=2, log_freq=None, n_iter_eval=2)


# the JAX package's GPT tree of small_train_config() (key: shape), as the
# trainer's npz mirror must hold it; tests/test_torch_train.py derives it
# from ccvs_tpu
MIRROR_KEYS = {
    "core/blocks/block/attn/key/bias": (2, 128),
    "core/blocks/block/attn/key/kernel": (2, 128, 128),
    "core/blocks/block/attn/proj/bias": (2, 128),
    "core/blocks/block/attn/proj/kernel": (2, 128, 128),
    "core/blocks/block/attn/query/bias": (2, 128),
    "core/blocks/block/attn/query/kernel": (2, 128, 128),
    "core/blocks/block/attn/value/bias": (2, 128),
    "core/blocks/block/attn/value/kernel": (2, 128, 128),
    "core/blocks/block/fc1/bias": (2, 512),
    "core/blocks/block/fc1/kernel": (2, 128, 512),
    "core/blocks/block/fc2/bias": (2, 128),
    "core/blocks/block/fc2/kernel": (2, 512, 128),
    "core/blocks/block/ln1/bias": (2, 128),
    "core/blocks/block/ln1/scale": (2, 128),
    "core/blocks/block/ln2/bias": (2, 128),
    "core/blocks/block/ln2/scale": (2, 128),
    "core/ln_f/bias": (128,),
    "core/ln_f/scale": (128,),
    "head/kernel": (128, 64),
    "s_emb": (1, 64, 128),
    "t_emb": (1, 4, 128),
    "tok_emb/embedding": (64, 128),
}


def adam_close(got, want, start, grad, lr, steps, scale):
    """Largest excess of ``|got - want|`` over its bound, for parameters
    after ``steps`` Adam updates from ``start`` on two devices. Adam divides
    the first moment by the root of the second, so where the gradient is
    near zero (``grad``, the first step's, within 1e-3 of ``scale``, the
    model's largest gradient entry) rounding decides the update's sign and
    an entry may move by up to ``lr`` a step either way: there the bound is
    ``lr * steps``. Elsewhere the updates agree within rtol 1e-3 plus two
    fp32 spacings of the parameter a step."""
    import torch

    got, want, start, grad = (t.detach().double().cpu() for t in (got, want, start, grad))
    near_zero = grad.abs() <= 1e-3 * scale
    ulps = 2 * steps * torch.finfo(torch.float32).eps * want.abs()
    bound = torch.where(near_zero, torch.full_like(want, lr * steps),
                        1e-3 * (want - start).abs() + ulps)
    return float(((got - want).abs() - bound).max())


def _train_data(cfg, phase_name, n, load_vid=True):
    """``n`` consecutive batches of ``cfg.data``'s dataset, collated."""
    from ccvs_tpu_torch.data import create_dataset, group_collate

    ds = create_dataset(cfg.data, phase=phase_name, load_vid=load_vid)
    b = cfg.data.batch_size_vid if load_vid else cfg.data.batch_size_img
    return [group_collate([ds[i * b + j] for j in range(b)]) for i in range(n)]


def _trainer_pair(cfg, state_trainer=False):
    """The same seeded trainer on the card and on the CPU (fp32):
    ``[(device, trainer, train state)]``, the card's first."""
    import torch
    from ccvs_tpu_torch.models import FrameAutoencoder, StateModel
    from ccvs_tpu_torch.train.state_trainer import StateEstimatorTrainer
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    ae_cpu = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(seed=0)
    sm_cpu = StateModel(cfg.state, device="cpu").init(seed=2)
    out = []
    for dev in ("cuda", "cpu"):
        ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device=dev)
        ae.load_state_dict(ae_cpu.state_dict())
        if state_trainer:
            tr = StateEstimatorTrainer(cfg, ae, device=dev)
            tr.model.load_state_dict(sm_cpu.state_dict())
            out.append((dev, tr, tr.init_state(tr.model)))
            continue
        sm = None
        if cfg.gpt.state:
            sm = StateModel(cfg.state, device=dev)
            sm.load_state_dict(sm_cpu.state_dict())
        tr = TransformerTrainer(cfg, ae, state_model=sm, dtype=torch.float32, device=dev)
        if out:
            tr.transformer.load_state_dict(out[0][1].transformer.state_dict())
        else:
            tr.transformer.init(seed=1)
        out.append((dev, tr, tr.init_state()))
    return out


def _parity(name, pair, batches, run_step, lr, warmup):
    """Three steps of ``run_step(trainer, state, batch)`` on each device:
    the metrics within rtol 1e-4 (fp32 sums in another order), the
    parameters by :func:`adam_close` at ``lr``; with ``warmup`` the first
    update exactly zero (optax's warmup schedule at count 0)."""
    import torch

    res = []
    for dev, tr, state in pair:
        module = state.params
        start = {n: p.detach().clone() for n, p in module.named_parameters()}
        metrics, grad1 = [], None
        for i, batch in enumerate(batches):
            state, m = run_step(tr, state, batch, dev)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grad1 = {n: p.grad.detach().clone() for n, p in module.named_parameters()}
                if warmup:
                    moved = [n for n, p in module.named_parameters() if not torch.equal(p, start[n])]
                    if moved:
                        raise AssertionError(f"train {name} on {dev}: the first update (lr 0) "
                                             f"moved {moved[:3]}")
        res.append((metrics, dict(module.named_parameters()), start, grad1))
    (mg, pg, start, _), (mc, pc, _, grad1) = res
    worst_m = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-12) for g, c in zip(mg, mc) for k in c)
    if not worst_m <= 1e-4:
        raise AssertionError(f"train {name}: metrics GPU {mg} vs CPU {mc}")
    scale = max(float(g.abs().max()) for g in grad1.values())
    worst_p = max(adam_close(pg[n], pc[n], start[n], grad1[n], lr, len(batches), scale)
                  for n in pc)
    if not worst_p <= 0:
        raise AssertionError(f"train {name}: parameters GPU vs CPU beyond the Adam bound by "
                             f"{worst_p:.3g}")
    log(f"train {name}: 3 steps GPU vs CPU, metrics within {worst_m:.3g} relative "
        f"(tolerance 1e-4), parameters within the Adam bound (margin {-worst_p:.3g}); "
        f"nll / loss by step {[round(m.get('nll', m.get('state_reg', 0.0)), 5) for m in mg]}")


def _transformer_step(tr, state, batch, dev):
    from ccvs_tpu_torch.train.ae_trainer import to_device

    return tr.step(state, tr.encode_batch(to_device(batch, dev)))


def _state_step(tr, state, batch, dev):
    from ccvs_tpu_torch.train.ae_trainer import to_device

    return tr.step(state, to_device(batch, dev))


def phase_train_reference():
    """(a) Small fp32 configurations: the transformer step in the plain,
    state-interleaved, point-to-point and ``grad_accum=2`` forms, and the
    state step, each 3 steps on the card against the CPU."""
    import dataclasses

    forms = {"plain": {}, "state": dict(z_len=264, state=True, state_num=8, state_size=2),
             "p2p": dict(p2p=True), "grad_accum=2": dict(grad_accum=2)}
    for name, over in forms.items():
        cfg = small_train_config(**over)
        if cfg.gpt.p2p:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, p2p_len=cfg.data.vid_len))
        _parity(name, _trainer_pair(cfg), _train_data(cfg, "train", 3), _transformer_step,
                cfg.gpt.lr, warmup=True)
    cfg = small_train_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, n_consecutive_img=1))
    _parity("state step", _trainer_pair(cfg, state_trainer=True),
            _train_data(cfg, "train", 3, load_vid=False), _state_step, cfg.state.lr,
            warmup=False)


def phase_train_bairhd(records, card):
    """(b) The full-width BAIR-256 transformer step: a 24 x 1024 GPT with
    fp32 parameters under bf16 compute, on batches of 16 clips of 16
    frames encoded by the bf16 autoencoder; 2 warm-up and 10 timed steps on
    one fixed batch, K1 once a step."""
    import dataclasses
    import math

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.train.ae_trainer import to_device
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    base = bairhd_config()
    cfg = base.replace(name="train_bairhd", data=dataclasses.replace(base.data, dataset="synthetic"))
    torch.cuda.empty_cache()  # the serving phases' cached blocks
    t0 = time.perf_counter()
    batch = to_device(_train_data(cfg, "train", 1)[0], "cuda")
    t_data = time.perf_counter() - t0
    ae = FrameAutoencoder(cfg.ae, dtype=torch.bfloat16).init(seed=0)
    tr = TransformerTrainer(cfg, ae)
    tr.transformer.init(seed=1)
    state = tr.init_state()
    n_params = sum(p.numel() for p in tr.transformer.parameters())
    b, t = batch["vid"].shape[:2]
    n_tokens = b * (t * cfg.gpt.size - 1)
    log(f"train bairhd: {n_params / 1e6:.1f} M GPT parameters in fp32, bf16 compute; batch "
        f"{tuple(batch['vid'].shape)} (made in {t_data:.2f} s), {n_tokens} input tokens a step")
    torch.cuda.reset_peak_memory_stats()
    losses, wall = [], []
    spans = common.Spans(True)
    for i in range(12):
        if i == 2:
            profiling.reset()
            t_timed = time.perf_counter()
        w0 = time.perf_counter()
        with spans.span("encode"):
            tokens = tr.encode_batch(batch)
        with spans.span("step"):
            state, m = tr.step(state, tokens)
        losses.append(float(m["nll"]))  # waits for the step
        wall.append(time.perf_counter() - w0)
    dt = common.synced(CARD) - t_timed
    enc_ms, step_ms = spans.ms()["encode"], spans.ms()["step"]
    launches = kernel_launches("k1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != 10:
        raise AssertionError(f"train bairhd: K1 launched {launches} times in 10 steps, expected 10")
    records["vq_argmin"]["launches_by_rollout"]["train_bairhd (10 steps)"] = launches
    TRAIN_REF["transformer"] = (dt / 10, peak)
    enc, stp = statistics.median(enc_ms[2:]), statistics.median(step_ms[2:])
    log(f"train bairhd: {dt / 10:.4f} s a step over 10 steps ({n_tokens * 10 / dt:.0f} tokens/s); "
        f"median encode {enc:.2f} ms (CUDA events), GPT step {stp:.2f} ms; peak memory "
        f"{peak:.2f} GiB; remat {cfg.gpt.remat}; K1 {launches} launches; on {card}")
    log(f"train bairhd: nll by step {[round(x, 4) for x in losses]}; host wall by step "
        f"{[round(x, 3) for x in wall]} s")
    # at init the head's rows are N(0, 0.02) and the final LayerNorm's output
    # has norm sqrt(n_embd), so a position's logits are iid N(0, s^2), s =
    # 0.02 sqrt(n_embd): the cross-entropy is ln V + s^2 / 2 less the target's
    # logit, N(0, s^2) for one distinct (input, target) pair; a random
    # autoencoder gives a batch of few distinct codes, so hold the loss to
    # 3 s of ln V + s^2 / 2
    s_init = 0.02 * math.sqrt(cfg.gpt.n_embd)
    expect = math.log(cfg.gpt.z_num) + s_init**2 / 2
    log(f"train bairhd: loss at step 0 {losses[0]:.4f}; ln {cfg.gpt.z_num} = "
        f"{math.log(cfg.gpt.z_num):.4f}, the init's expectation ln V + s^2 / 2 = {expect:.4f} "
        f"(s = {s_init:.3f}); distinct codes in the batch "
        f"{int(tr.encode_batch(batch)['code'].unique().numel())}")
    if not abs(losses[0] - expect) <= 3 * s_init:
        raise AssertionError(f"train bairhd: loss at step 0 {losses[0]}, not within 3 s = "
                             f"{3 * s_init:.3f} of {expect:.4f}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"train bairhd: loss {losses[-1]} after the 10 timed steps not "
                             f"below step 1's {losses[1]}")
    # the AdamW update alone, once more from the last step's gradients
    spans = common.Spans(True)
    with spans.span("adamw"):
        state.opt.step()
    # fp32 parameter, gradient and both moments read, parameter and moments
    # written: 28 bytes a parameter
    adam_bound, _ = bound_ms(28 * n_params, 0, PEAK_FP32_PER_S)
    log(f"train bairhd: the AdamW update alone {spans.ms()['adamw'][0]:.2f} ms (CUDA events); "
        f"bytes bound {adam_bound:.2f} ms ({28 * n_params / 1e9:.2f} GB)")
    box = [state]

    def one_step():
        box[0], _ = tr.step(box[0], tr.encode_batch(batch))

    wall, busy, kernels, _ = device_profile(one_step)
    if not kernels:
        log(f"train bairhd profile: wall {wall:.4f} s; device time not measured")
        return
    log(f"train bairhd profile, one step: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}% of wall)")
    for kname, t in kernels[:8]:
        log(f"    {100 * t / busy:5.1f}%  {t * 1e3:9.3f} ms  {kname[:110]}")


def phase_train_state(records, card):
    """(c) The full-width state step: 96 images of 256x256 through the fp32
    BAIR autoencoder, K1 twice a step (the encode, and the state quantizer
    under autograd); the codebook's gradient equal to the plain search's."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.ops.vq import vq_indices, vq_loss
    from ccvs_tpu_torch.train.ae_trainer import to_device
    from ccvs_tpu_torch.train.state_trainer import StateEstimatorTrainer

    base = bairhd_config()
    cfg = base.replace(name="train_state", data=dataclasses.replace(
        base.data, dataset="synthetic", load_state=True, n_consecutive_img=1,
        load_elastic_view=False))
    batches = [to_device(x, "cuda") for x in _train_data(cfg, "train", 2, load_vid=False)]
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32).init(seed=0)
    tr = StateEstimatorTrainer(cfg, ae)
    tr.model.init(seed=2)
    state = tr.init_state(tr.model)
    state, _ = tr.step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    profiling.reset()
    t0 = time.perf_counter()
    state, m = tr.step(state, batches[1])
    dt = common.synced(CARD) - t0
    if kernel_launches("k1") != 2:
        raise AssertionError(f"train state: K1 launched {kernel_launches('k1')} times a step, "
                             "expected 2")
    records["vq_argmin"]["launches_by_rollout"]["train_state (1 step)"] = kernel_launches("k1")
    # the state quantizer through K1: its indices the plain search's (a
    # near-tie aside, as check_vq allows), and the codebook's gradient that
    # of the gather alone, 2 beta (e_k - z_i) / N summed over the rows i
    # that chose code k, computed in float64 on the CPU from K1's indices
    q = state.params.quantizer
    sf = batches[1]["state"][..., None]
    z = sf.reshape(-1, 1)
    ties, _ = check_vq(z, q.embedding.detach())
    q.embedding.grad = None
    idx = vq_indices(z, q.embedding).long()
    vq_loss(sf, q.embedding.index_select(0, idx).reshape(sf.shape), q.beta).backward()
    got = q.embedding.grad.double().cpu()
    e, zc, ic = q.embedding.detach().double().cpu(), z.double().cpu(), idx.cpu()
    want = torch.zeros_like(e).index_add_(0, ic, 2 * q.beta * (e[ic] - zc) / z.numel())
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not scale > 0 or not err <= 1e-5 * scale:
        raise AssertionError(f"train state: codebook gradient through K1 differs from the "
                             f"gather's by {err} (largest {scale}; tolerance 1e-5 of it)")
    log(f"train state: {tuple(batches[1]['img'].shape)} images, {dt:.4f} s a step, K1 2 "
        f"launches; the quantizer's indices the plain search's ({ties} near-ties); codebook "
        f"gradient nonzero (largest {scale:.3g}), within {err:.3g} of the gather's alone; "
        f"state_reg {float(m['state_reg']):.5f}, state_perp {float(m['state_perp']):.3f}; "
        f"on {card}")


def phase_train_runs():
    """(d) ``TransformerTrainer.run`` and ``StateEstimatorTrainer.run`` on the
    small configuration in a temporary directory: a latest checkpoint whose
    resumed state (step, parameters, Adam moments) equals the trainer's, a
    resumed run continuing the step count, the npz mirror in the JAX
    package's layout."""
    import tempfile

    import numpy as np
    import torch
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.train.state_trainer import StateEstimatorTrainer
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = small_train_config().replace(save_path=tmp, npz_mirror=os.path.join(tmp, "m.npz"))
        ae = FrameAutoencoder(cfg.ae, dtype=torch.float32).init(seed=0)
        ran = TransformerTrainer(cfg, ae).run(n_iter=3)
        fresh = TransformerTrainer(cfg, ae)
        ck = CheckpointManager(os.path.join(tmp, "checkpoints", cfg.name))
        loaded = ck.load("transformer", "latest", target=fresh.init_state())
        moments = [(s["exp_avg"], s["exp_avg_sq"]) for s in ran.opt.opt.state.values()]
        moments2 = [(s["exp_avg"], s["exp_avg_sq"]) for s in loaded.opt.opt.state.values()]
        if not (loaded.step == ran.step == 3 and loaded.opt.count == 3
                and same(loaded.params.parameters(), ran.params.parameters())
                and all(same(a, b) for a, b in zip(moments, moments2))):
            raise AssertionError("train run: the resumed state differs from the saved one")
        resumed = TransformerTrainer(cfg, ae)
        if resumed.run(n_iter=5, resume=True).step != 5:
            raise AssertionError("train run: the resumed run did not reach step 5")
        with np.load(cfg.npz_mirror) as z:
            keys = {k[len("gpt/"):]: tuple(z[k].shape) for k in z.files}
            dtypes = {str(z[k].dtype) for k in z.files}
        if keys != MIRROR_KEYS or dtypes != {"float16"}:
            raise AssertionError(f"train run: npz mirror keys {sorted(keys)} ({dtypes}) are not "
                                 "the JAX package's tree")
        st = StateEstimatorTrainer(cfg.replace(name="state_small"), ae)
        first = st.run(n_iter=3)
        again = StateEstimatorTrainer(cfg.replace(name="state_small"), ae).run(n_iter=4,
                                                                               resume=True)
        if first.step != 3 or again.step != 4:
            raise AssertionError("train run: the state trainer did not run and resume")
    log(f"train run: TransformerTrainer ran 3 steps, its latest checkpoint resumed equal (step, "
        f"parameters, {len(moments)} Adam moment pairs) and continued to 5; the npz mirror "
        f"holds the JAX tree's {len(MIRROR_KEYS)} keys in fp16; StateEstimatorTrainer ran 3 "
        f"and resumed to 4")


def phase_train(records, card):
    # SyntheticDataset draws a training item's augmentation seed from
    # Python's generator: seeded, every run sees the same batches
    random.seed(0)
    phase_train_reference()
    phase_train_bairhd(records, card)
    phase_train_state(records, card)
    phase_train_runs()


# ---------------- phase 11: the autoencoder's training ----------------


def small_ae_config(**over):
    """Phase 11's small configuration: ``tests/test_train.py``'s ``AE_CFG``
    at 16 px (VGG19's fourth pooling needs 16 px), VGG on images and videos,
    the feature discriminator, the unconditional head and backwarp
    consistency on; image batches of 2 groups of 3, clips of 3 frames."""
    import dataclasses

    from ccvs_tpu_torch.config import AutoencoderConfig, Config, DataConfig

    ae = AutoencoderConfig(
        necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(8, 8),
        max_dim=16, inter_p=0.5, skip_memory=2, skip_context=(1, 2), use_di=True, use_dv=True,
        use_df=True, use_unc_gen=True, use_vgg_img=True, use_vgg_vid=True,
        use_direct_recovery_img=True, use_direct_recovery_vid=True,
        use_backwarp_consistency_img=True, slide_inter=True, n_consecutive_img=2, vid_len=3,
        load_elastic_view=True, elastic_corruption=True, use_elastic_flow_recovery=True,
        d_reg_every=2, stddev_group=2)
    data = DataConfig(dataset="synthetic", max_dim=16, true_dim=32, vid_len=3, batch_size_img=6,
                      batch_size_vid=4, n_consecutive_img=2, img_out_of_n=8, num_workers=2,
                      load_elastic_view=True, elastic_corruption=True, elastic_alpha=1.0,
                      elastic_sigma=0.2)
    return Config(name="ae_small", data=data, ae=dataclasses.replace(ae, **over), n_iter=3,
                  save_latest_freq=2, log_freq=None)


# the JAX package's ae_gen tree of small_ae_config() (key: shape), as the AE
# trainer's npz mirror must hold it; a CPU test derives it from the JAX
# package (tests/test_torch_ae_trainer.py)
AE_MIRROR_KEYS = {
    "decoder/block0/conv/bias": (16,),
    "decoder/block0/conv/weight": (16, 16, 1, 1),
    "decoder/block1/conv1/conv/bias": (16,),
    "decoder/block1/conv1/conv/weight": (16, 16, 3, 3),
    "decoder/block1/conv2/conv/bias": (8,),
    "decoder/block1/conv2/conv/weight": (8, 16, 3, 3),
    "decoder/block1/skip/conv/weight": (8, 16, 1, 1),
    "decoder/block2/conv/bias": (3,),
    "decoder/block2/conv/weight": (3, 8, 1, 1),
    "decoder/inter_block0/matching/convs0/conv/bias": (128,),
    "decoder/inter_block0/matching/convs0/conv/weight": (128, 49, 3, 3),
    "decoder/inter_block0/matching/convs1/conv/bias": (64,),
    "decoder/inter_block0/matching/convs1/conv/weight": (64, 128, 3, 3),
    "decoder/inter_block0/matching/convs2/conv/bias": (32,),
    "decoder/inter_block0/matching/convs2/conv/weight": (32, 64, 3, 3),
    "decoder/inter_block0/matching/flow_head/conv/bias": (2,),
    "decoder/inter_block0/matching/flow_head/conv/weight": (2, 32, 3, 3),
    "decoder/inter_block0/matching/occ_head/conv/bias": (1,),
    "decoder/inter_block0/matching/occ_head/conv/weight": (1, 32, 3, 3),
    "decoder/inter_block0/subpixel/convs0/conv/bias": (128,),
    "decoder/inter_block0/subpixel/convs0/conv/weight": (128, 19, 3, 3),
    "decoder/inter_block0/subpixel/convs1/conv/bias": (64,),
    "decoder/inter_block0/subpixel/convs1/conv/weight": (64, 128, 3, 3),
    "decoder/inter_block0/subpixel/convs2/conv/bias": (32,),
    "decoder/inter_block0/subpixel/convs2/conv/weight": (32, 64, 3, 3),
    "decoder/inter_block0/subpixel/flow_head/conv/bias": (2,),
    "decoder/inter_block0/subpixel/flow_head/conv/weight": (2, 32, 3, 3),
    "decoder/inter_block0/subpixel/occ_head/conv/bias": (1,),
    "decoder/inter_block0/subpixel/occ_head/conv/weight": (1, 32, 3, 3),
    "decoder/inter_block1/matching/convs0/conv/bias": (128,),
    "decoder/inter_block1/matching/convs0/conv/weight": (128, 49, 3, 3),
    "decoder/inter_block1/matching/convs1/conv/bias": (64,),
    "decoder/inter_block1/matching/convs1/conv/weight": (64, 128, 3, 3),
    "decoder/inter_block1/matching/convs2/conv/bias": (32,),
    "decoder/inter_block1/matching/convs2/conv/weight": (32, 64, 3, 3),
    "decoder/inter_block1/matching/flow_head/conv/bias": (2,),
    "decoder/inter_block1/matching/flow_head/conv/weight": (2, 32, 3, 3),
    "decoder/inter_block1/matching/occ_head/conv/bias": (1,),
    "decoder/inter_block1/matching/occ_head/conv/weight": (1, 32, 3, 3),
    "decoder/inter_block1/matching/upsample_flow/weight": (2, 1, 4, 4),
    "decoder/inter_block1/matching/upsample_occ/weight": (1, 1, 4, 4),
    "decoder/inter_block1/subpixel/convs0/conv/bias": (128,),
    "decoder/inter_block1/subpixel/convs0/conv/weight": (128, 11, 3, 3),
    "decoder/inter_block1/subpixel/convs1/conv/bias": (64,),
    "decoder/inter_block1/subpixel/convs1/conv/weight": (64, 128, 3, 3),
    "decoder/inter_block1/subpixel/convs2/conv/bias": (32,),
    "decoder/inter_block1/subpixel/convs2/conv/weight": (32, 64, 3, 3),
    "decoder/inter_block1/subpixel/flow_head/conv/bias": (2,),
    "decoder/inter_block1/subpixel/flow_head/conv/weight": (2, 32, 3, 3),
    "decoder/inter_block1/subpixel/occ_head/conv/bias": (1,),
    "decoder/inter_block1/subpixel/occ_head/conv/weight": (1, 32, 3, 3),
    "encoder/block0/conv/bias": (8,),
    "encoder/block0/conv/weight": (8, 3, 1, 1),
    "encoder/block1/conv1/conv/bias": (8,),
    "encoder/block1/conv1/conv/weight": (8, 8, 3, 3),
    "encoder/block1/conv2/conv/bias": (16,),
    "encoder/block1/conv2/conv/weight": (16, 8, 3, 3),
    "encoder/block1/skip/conv/weight": (16, 8, 1, 1),
    "encoder/block2/conv/bias": (16,),
    "encoder/block2/conv/weight": (16, 16, 1, 1),
    "quantizer/embedding": (32, 16),
}


AE_STEPS = [("g", "img"), ("d", "img"), ("r1", "img"), ("g", "vid"), ("d", "vid"), ("r1", "vid")]


GRAD_TOL = 1e-3  # of each parameter's own largest gradient entry, card against CPU
# or, where larger, a floor of the step's largest entry: in the D and R1 steps a
# few fp32 roundings of the largest terms; in the G steps 1e-3. These run the
# decoders' warps (grid_sample's bilinear derivative jumps where a sample crosses
# a pixel centre), leaky ReLUs and VGG's max-pools: where rounding puts an entry
# on the other side of such a kink on the two devices, its share of a gradient
# changes by a finite step, and one entry can move a bias's gradient by ~1e-3
# of the step's largest
GRAD_FLOOR = {("g", "img"): 1e-3, ("g", "vid"): 1e-3}
GRAD_FLOOR_DEFAULT = 1e-6


def adam_b0_update(p0, v0, grad, group, t):
    """One update of Adam with ``beta1 = 0`` and no weight decay (the
    autoencoder's optimizers) in float64: the parameters and second moment
    it makes of ``p0``, ``v0`` and ``grad`` at ``group``'s lr, beta2 and eps
    and update count ``t``, and the bound on an fp32 implementation's
    parameters: two fp32 spacings of the parameter and eight of the update."""
    import torch

    p0, v0, g = (x.detach().double().cpu() for x in (p0, v0, grad))
    b2 = group["betas"][1]
    v = b2 * v0 + (1 - b2) * g * g
    upd = group["lr"] * g / ((v / (1 - b2**t)).sqrt() + group["eps"])
    e32 = torch.finfo(torch.float32).eps
    return p0 - upd, v, 2 * e32 * p0.abs() + 8 * e32 * upd.abs()


def _excess(got, want, bound):
    return float(((got.detach().double().cpu() - want.detach().double().cpu()).abs()
                  - bound).max())


def _ae_batches(cfg, n, kinds=("img", "vid")):
    """``n`` batches of each kind in ``kinds`` of ``cfg.data``'s dataset:
    image groups (``batch_size_img`` images) and clips of ``ae.vid_len``
    frames (``batch_size_vid``); a list of ``(img, vid)`` pairs, None for a
    kind left out."""
    import dataclasses

    from ccvs_tpu_torch.data import create_dataset, group_collate

    group = cfg.data.n_consecutive_img + (1 if cfg.data.load_elastic_view else 0)
    sizes = {"img": cfg.data.batch_size_img // group, "vid": cfg.data.batch_size_vid}
    ds = {"img": create_dataset(cfg.data, phase="train", load_vid=False),
          "vid": create_dataset(dataclasses.replace(cfg.data, vid_len=cfg.ae.vid_len),
                                phase="train", load_vid=True)}
    return [tuple(group_collate([ds[k][i * sizes[k] + j] for j in range(sizes[k])])
                  if k in kinds else None for k in ("img", "vid")) for i in range(n)]


def _ae_step(tr, state, kind, mode, batch, fake, generator=None):
    if kind == "g":
        state, m, fake = tr.g_step(state, batch, mode, generator)
        return state, m, fake, state.gen, state.opt_g
    if kind == "d":
        state, m = tr.d_step(state, batch, fake, mode, generator)
    else:
        state, m = tr.r1_step(state, batch, mode, generator)
    return state, m, fake, state.disc, state.opt_d


def ada_cpu_draws(generator, img, p):
    """ADA with the numbers drawn on the CPU from a generator seeded as
    ``generator`` and moved to ``img``'s device: the card and the CPU then
    augment alike (a ``torch.Generator`` draws other numbers on the card)."""
    import torch
    from ccvs_tpu_torch.train import ada

    g = torch.Generator().manual_seed(generator.initial_seed())
    b = img.shape[0]
    draws = tuple({k: v.to(img.device) for k, v in d.items()}
                  for d in (ada.draw_affine(g, b), ada.draw_color(g, b)))
    return ada.augment(None, img, p, draws=draws)


def ada_rule(acfg, p, r_t, n):
    """The D step's controller on the host: ``p`` moved by the sign of
    ``r_t - ada_target`` (``r_t = mean(sign(D(real)))``), ``n / ada_length``
    for ``n`` real images, clipped to [0, 1]."""
    step = (r_t > acfg.ada_target) - (r_t < acfg.ada_target)
    return min(max(p + step * n / acfg.ada_length, 0.0), 1.0)


def n_real_images(losses, batch_size):
    """The image discriminator's real images in a batch: those that are no
    corrupted contexts."""
    return len(losses.corr_split(batch_size)[0]) if losses.cfg.elastic_corruption else batch_size


def _ae_step_check(step):
    """The worst of one step held against the CPU (``step``: the metrics,
    the card's parameters, gradients, second moments and EMA before and
    after, the CPU's gradients, optimizer group and count, the gradient
    floor): the metrics' relative difference; each parameter's gradient
    difference over its tolerance, ``GRAD_TOL`` of its own largest CPU
    entry or, where larger, the floor of the step's largest, as ``(ratio,
    name)``, and
    over the step's largest entry alone (``grad_err``); the excess of the
    card's
    parameters and second moments over what :func:`adam_b0_update` makes of
    the card's own gradients at the CPU's lr, beta2 and count, and of the
    card's EMA over the EMA of its new parameters (``ema_decay``), each as
    ``(excess, name)``; a check passes when the ratio is at most 1 and the
    excesses at most 0."""
    import torch

    cm, gm = step["metrics"]
    m_err = max(abs(float(gm[k]) - float(v)) / max(abs(float(v)), 1e-12) for k, v in cm.items())
    grads, grad_err, update = (0.0, ""), (0.0, ""), (-float("inf"), "")
    tiny = torch.finfo(torch.float32).tiny
    scale = max(float(g.abs().max()) for g in step["cgrad"].values())
    for n, cg in step["cgrad"].items():
        gg = step["ggrad"][n].detach().double().cpu()
        cg = cg.detach().double().cpu()
        diff = float((gg - cg).abs().max())
        tol = max(GRAD_TOL * float(cg.abs().max()), step["floor"] * scale)
        grads = max(grads, (diff / tol if tol else (0.0 if diff == 0 else float("inf")), n))
        grad_err = max(grad_err, (diff / scale, n))
        p0, v0 = step["before"][n]
        want, v, bound = adam_b0_update(p0, v0, gg, step["group"], step["count"])
        update = max(update, (_excess(step["after"][n], want, bound), n),
                     (_excess(step["v"][n], v, 4 * torch.finfo(torch.float32).eps * v + tiny),
                      "exp_avg_sq." + n))
    ema = (-float("inf"), "")
    if step["ema"] is not None:
        d, e32 = step["ema_decay"], torch.finfo(torch.float32).eps
        for n, (e0, e1) in step["ema"].items():
            e0 = e0.detach().double().cpu()
            want = d * e0 + (1 - d) * step["after"][n].detach().double().cpu()
            ema = max(ema, (_excess(e1, want, 2 * e32 * (want.abs() + e0.abs())), "ema." + n))
    return {"metrics": m_err, "grads": grads, "grad_err": grad_err, "update": update,
            "ema": ema}


def _ae_step_passes(res):
    return (res["metrics"] <= 1e-4 and res["grads"][0] <= 1 and res["update"][0] <= 0
            and res["ema"][0] <= 0)


def phase_ae_reference(on_step=None, after_build=None, cfg=None, label="train ae small",
                       steps=AE_STEPS, iters=3):
    """(a) The small fp32 configuration: three iterations of the six steps
    (G, D, R1 for images and for video; R1 every 2) free-running on the
    card; each step also run on the CPU from the card's state before it
    (parameters, EMA, optimizer states, and the G step's fake for the D
    step) and held to it by :func:`_ae_step_check`: the metrics within 1e-4
    relative, each parameter's gradient within ``GRAD_TOL`` of its own
    largest entry or ``GRAD_FLOOR`` of the step's, the card's parameters
    and second moments those of Adam on its own gradients within fp32
    rounding, its EMA that of its new parameters; K1's indices of every G
    step held to the plain search's by :func:`check_vq`. Two faults are
    then planted in the last step and shown to fail the check: the sign of
    the update of the parameter with the smallest gradient flipped, and
    the sign of its gradient flipped (with the update that follows).
    ``on_step(when, it, kind, mode, state_or_step, batch_or_result)``, when
    given, sees each step "before" it runs (the card's state and the CPU
    batch) and "after" (the step's record and its check); ``after_build()``,
    when given, runs once the trainers are built.

    ``cfg`` (default :func:`small_ae_config`) with ``use_aug`` runs the steps
    with ADA on both devices alike (:func:`ada_cpu_draws`, each iteration's
    generator seeded from ``(seed, it)`` on each device), holds the card's
    ``ada_p`` after each image D step to the CPU's and to the controller's
    rule (:func:`ada_rule`), and takes the G steps' gradient floor in the
    image D and R1 steps too: they run the augmentation's bilinear warp.
    ``steps`` and ``iters`` (default: the six steps, 3 iterations) choose
    the steps and the iterations held."""
    import copy

    import torch
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device
    from ccvs_tpu_torch.train.states import iteration_generator
    from ccvs_tpu_torch.train.steps import make_ae_steps

    cfg = cfg or small_ae_config()
    use_aug = cfg.ae.use_aug
    cpu = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    cpu.init_params()
    gpu = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cuda")
    gpu.losses.vgg.load_state_dict(cpu.losses.vgg.state_dict())
    if use_aug:
        for tr in (cpu, gpu):
            tr.init_state, tr.g_step, tr.d_step, tr.r1_step = make_ae_steps(
                tr.losses, aug_fn=ada_cpu_draws)
    if after_build is not None:
        after_build()
    floors = {**GRAD_FLOOR, **({("d", "img"): 1e-3, ("r1", "img"): 1e-3} if use_aug else {})}
    ada_p = []
    cstate, gstate = cpu.init_state(), gpu.init_state()
    gstate.load_state_dict(cstate.state_dict())
    ties = []

    def check_k1(module, args):  # on the card, before the step's K1 launch
        z = args[0].detach()
        ties.append(check_vq(z.reshape(-1, z.shape[-1]), module.embedding.detach())[0])

    hook = gpu.ae.quantizer.register_forward_pre_hook(check_k1)
    worst = {"metrics": 0.0, "grads": (0.0, ""), "grad_err": (0.0, ""),
             "update": (-float("inf"), ""), "ema": (-float("inf"), "")}
    keys, g_losses, n_steps = set(), [], 0
    for it, (bi, bv) in enumerate(_ae_batches(cfg, iters)):
        batch = {dev: {"img": to_device(bi, dev), "vid": to_device(bv, dev)}
                 for dev in ("cpu", "cuda")}
        gens = {dev: iteration_generator(cfg.seed, it, dev) if use_aug else None
                for dev in ("cpu", "cuda")}
        fake = {}
        for kind, mode in steps:
            if kind == "r1" and it % cfg.ae.d_reg_every:
                continue
            cstate.load_state_dict(copy.deepcopy(gstate.state_dict()))
            gmod, gopt = (gstate.gen, gstate.opt_g) if kind == "g" else (gstate.disc, gstate.opt_d)
            before = {}
            for n, p in gmod.named_parameters():
                v0 = gopt.opt.state.get(p, {}).get("exp_avg_sq")
                before[n] = (p.detach().clone(),
                             torch.zeros_like(p) if v0 is None else v0.detach().clone())
            ema0 = ({n: e.detach().clone() for n, e in gstate.ema.named_parameters()}
                    if kind == "g" else None)
            cfake = None if kind == "g" else {k: None if v is None else v.cpu()
                                              for k, v in fake[mode].items()}
            if on_step is not None:
                on_step("before", it, kind, mode, gstate, batch["cpu"][mode])
            p0 = float(gstate.ada_p)
            gstate, gm, gfake, gmod, gopt = _ae_step(gpu, gstate, kind, mode,
                                                     batch["cuda"][mode], fake.get(mode),
                                                     gens["cuda"])
            cstate, cm, _, cmod, copt = _ae_step(cpu, cstate, kind, mode, batch["cpu"][mode],
                                                 cfake, gens["cpu"])
            fake[mode] = gfake
            if use_aug and (kind, mode) == ("d", "img"):
                # the rule on the card's own scores: D of its augmented reals
                want = ada_rule(cfg.ae, p0, float(gm["rt_stat"]),
                                n_real_images(gpu.losses, bi["img"].shape[0]))
                got = (float(gstate.ada_p), float(cstate.ada_p))
                if abs(got[0] - want) > 1e-7 or got[0] != got[1]:
                    raise AssertionError(f"{label}: ada_p after the D step of iteration {it}: "
                                         f"card {got[0]}, CPU {got[1]}, the rule {want}")
                ada_p.append(got[0])
            step = {
                "metrics": (cm, gm), "group": copt.opt.param_groups[0], "count": copt.count,
                "cgrad": {n: p.grad for n, p in cmod.named_parameters()},
                "ggrad": {n: p.grad for n, p in gmod.named_parameters()},
                "before": before, "after": dict(gmod.named_parameters()),
                "v": {n: gopt.opt.state[p]["exp_avg_sq"] for n, p in gmod.named_parameters()},
                "ema": None, "ema_decay": cfg.ae.ema_decay,
                "floor": floors.get((kind, mode), GRAD_FLOOR_DEFAULT)}
            if ema0 is not None:
                step["ema"] = {n: (ema0[n], e) for n, e in gstate.ema.named_parameters()}
            res = _ae_step_check(step)
            if on_step is not None:
                on_step("after", it, kind, mode, step, res)
            n_steps += 1
            keys |= set(cm)
            if "g_loss" in cm:
                g_losses.append(round(float(cm["g_loss"]), 5))
            for k in worst:
                worst[k] = max(worst[k], res[k])
            log(f"    {label} {it} {kind} {mode}: metrics within {res['metrics']:.3g} "
                f"relative, gradients at {res['grads'][0]:.3g} of their tolerance "
                f"({res['grads'][1]}), within {res['grad_err'][0]:.3g} of the step's largest "
                f"({res['grad_err'][1]}); excess of the update {res['update'][0]:.3g} "
                f"({res['update'][1]}), of the EMA {res['ema'][0]:.3g}")
    hook.remove()
    if not _ae_step_passes(worst):
        raise AssertionError(f"{label}: the card differs from the CPU beyond the "
                             f"tolerances: {worst}")
    n_g = iters * sum(kind == "g" for kind, _ in steps)
    if len(ties) != n_g:
        raise AssertionError(f"{label}: K1 checked {len(ties)} times, expected {n_g}")
    # planted faults in the last step, on its parameter of smallest gradient:
    # its update's sign flipped; its gradient's sign flipped, with the
    # update and second moment that Adam makes of it
    name = min((float(g.abs().max()), n) for n, g in step["cgrad"].items()
               if float(g.abs().max()) > 0)[1]
    p0, v0 = step["before"][name]
    flipped = dict(step, after={**step["after"], name: 2 * p0 - step["after"][name].detach()})
    g = -step["ggrad"][name].detach()
    p, v, _ = adam_b0_update(p0, v0, g, step["group"], step["count"])
    negated = dict(step, ggrad={**step["ggrad"], name: g}, after={**step["after"], name: p},
                   v={**step["v"], name: v})
    caught = [_ae_step_check(s) for s in (flipped, negated)]
    if any(_ae_step_passes(r) for r in caught):
        raise AssertionError(f"{label}: a planted fault in {name} passed the check")
    log(f"{label}: {iters} iterations ({n_steps} steps) free-running on the card, each step "
        f"held to the CPU's from the card's state: metrics within {worst['metrics']:.3g} "
        f"relative (tolerance 1e-4), gradients at most {worst['grads'][0]:.3g} of their "
        f"tolerance ({worst['grads'][1]}; {GRAD_TOL} of their own largest entry or "
        f"{GRAD_FLOOR_DEFAULT} of the step's, {GRAD_FLOOR[('g', 'vid')]} in the G steps), "
        f"within {worst['grad_err'][0]:.3g} of the step's largest entry "
        f"({worst['grad_err'][1]}), parameters and second "
        f"moments Adam's of the card's gradients (largest excess over fp32 rounding "
        f"{worst['update'][0]:.3g}), EMA that of the new parameters (excess "
        f"{worst['ema'][0]:.3g}); K1's indices the plain search's in all {n_g} G steps "
        f"({sum(ties)} near-ties); terms {sorted(keys)}")
    if use_aug:
        log(f"{label}: ada_p after each image D step {ada_p}, the card's equal to the CPU's "
            f"and to the controller's rule")
    log(f"{label}: planted faults in {name} (largest gradient "
        f"{float(step['cgrad'][name].abs().max()):.3g}) caught: its update's sign flipped "
        f"(excess {caught[0]['update'][0]:.3g}), its gradient's sign flipped ("
        f"{caught[1]['grads'][0]:.3g} of its tolerance)")
    log(f"{label}: g_loss by G step {g_losses}")
    return ada_p


def phase_ae_bairhd(records, card):
    """(b) Full-width BAIR-256: ``bairhd_config()`` with synthetic data at
    the reference's per-GPU batch (24 images: 8 groups of [corrupted context,
    next frame, distorted view]; 4 clips of 4 frames), fp32 parameters under
    bf16 compute, seeded VGG19, both discriminators, EMA. 2 warm-up and 5
    timed iterations on one fixed batch pair, the fifth an R1 iteration;
    K1 exactly 2 launches an iteration and 1 for the eval's
    reconstruction; then the trainer's loaders (:func:`ae_loader_fed`) and
    profiles of an iteration and of R1."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device

    base = bairhd_config()
    cfg = base.replace(name="train_ae_bairhd", data=dataclasses.replace(
        base.data, dataset="synthetic", batch_size_img=24, batch_size_vid=4))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (bi, _), = _ae_batches(cfg, 1, kinds=("img",))
    t_img = time.perf_counter() - t0
    t0 = time.perf_counter()
    (_, bv), = _ae_batches(cfg, 1, kinds=("vid",))
    t_vid = time.perf_counter() - t0
    tr = FrameAutoencoderTrainer(cfg)
    tr.init_params()
    state = tr.init_state()
    n_gen = sum(p.numel() for p in state.gen.parameters())
    n_disc = sum(p.numel() for p in state.disc.parameters())
    img, vid = to_device(bi, "cuda"), to_device(bv, "cuda")
    log(f"train ae bairhd: {n_gen / 1e6:.1f} M generator and {n_disc / 1e6:.1f} M discriminator "
        f"parameters in fp32, bf16 compute, remat {cfg.ae.remat}; image batch "
        f"{tuple(img['img'].shape)}, video batch {tuple(vid['vid'].shape)}; the dataset's host "
        f"time for one batch of each kind (one thread): images {t_img:.3f} s, clips "
        f"{t_vid:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    # iteration numbers: R1 runs when it % 16 == 0, in the last timed one only
    its = [1, 2, 3, 4, 5, 6, 16]
    split, wall, losses = [], [], []
    for i, it in enumerate(its):
        if i == 2:
            profiling.reset()
            t_timed = time.perf_counter()
        spans, fake, ms = common.Spans(True), {}, {}
        w0 = time.perf_counter()
        for kind, mode in AE_STEPS:
            if kind == "r1" and it % cfg.ae.d_reg_every:
                continue
            with spans.span(f"{kind} {mode}"):
                state, m, fake[mode], _, _ = _ae_step(tr, state, kind, mode,
                                                      img if mode == "img" else vid,
                                                      fake.get(mode))
            ms.update(m)
        state.step = it + 1
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - w0)
        split.append({name: t[0] for name, t in spans.ms().items()})
        losses.append({k: float(v) for k, v in ms.items()})
    dt = common.synced(CARD) - t_timed
    launches = kernel_launches("k1")
    _, psnr = tr.rec_eval(state.ema, img["img"][:16])
    torch.cuda.synchronize()
    launches_eval = kernel_launches("k1") - launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != 2 * 5 or launches_eval != 1:
        raise AssertionError(f"train ae bairhd: K1 launched {launches} times in 5 iterations "
                             f"(expected 10) and {launches_eval} in the eval (expected 1)")
    records["vq_argmin"]["launches_by_rollout"]["train_ae_bairhd (5 iterations + 1 eval)"] = (
        launches + launches_eval)
    for m in losses:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"train ae bairhd: non-finite {bad}")
    if not math.isfinite(float(psnr)):
        raise AssertionError(f"train ae bairhd: eval PSNR {float(psnr)}")
    plain = [w for w, it in zip(wall[2:], its[2:]) if it % 16]
    TRAIN_REF["ae"] = (statistics.median(plain), wall[-1], peak)
    state = ae_loader_fed(tr, state, statistics.median(plain))
    log(f"train ae bairhd: {dt / 5:.4f} s an iteration over 5 timed iterations (one with R1); "
        f"without R1 median {statistics.median(plain):.4f} s, with R1 {wall[-1]:.4f} s "
        f"(host clock, synchronized); peak memory {peak:.2f} GiB; K1 {launches} launches in 5 "
        f"iterations + {launches_eval} in the eval; EMA rec PSNR {float(psnr):.3f} dB; "
        f"on {card}")
    for name in split[-1]:
        vals = [s[name] for s, it in zip(split[2:], its[2:]) if name in s]
        log(f"    {name}: median {statistics.median(vals):9.2f} ms (CUDA events, "
            f"{len(vals)} iterations)")
    log(f"train ae bairhd: losses of the last iteration "
        f"{ {k: round(v, 4) for k, v in losses[-1].items()} }")
    box = [state]

    def one_iteration():
        box[0], _, _, _ = tr.iteration(box[0], 7, img, vid)

    wall1, busy, kernels, _ = device_profile(one_iteration)
    if not kernels:
        log(f"train ae bairhd profile: wall {wall1:.4f} s; device time not measured")
        return
    log(f"train ae bairhd profile, one iteration without R1: wall {wall1:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall1:.1f}% of wall)")
    for kname, t in kernels[:10]:
        log(f"    {100 * t / busy:5.1f}%  {t * 1e3:9.3f} ms  {kname[:110]}")

    def one_r1():
        box[0], _ = tr.r1_step(box[0], img, "img")

    wall1, busy, kernels, count = device_profile(one_r1)
    log(f"train ae bairhd profile, the image R1 step: wall {wall1:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall1:.1f}% of wall)")
    for kname, t in kernels[:8]:
        log(f"    {100 * t / busy:5.1f}%  {t * 1e3:9.3f} ms  {count[kname]:5d}x  {kname[:100]}")
    convs = r1_convolutions(one_r1)
    log(f"train ae bairhd: the image R1 step dispatches {sum(convs.values())} convolutions: "
        + ", ".join(f"{n} {kind}" for kind, n in convs.most_common()))


def ae_loader_fed(tr, state, fixed_s):
    """The trainer's own loaders (``make_loaders``: ``num_workers`` threads
    each, 2 batches prefetched): one epoch of each alone, its batches' host
    seconds as they arrive, then 6 iterations without R1 fed by them (the
    image loader's epoch of 4 batches restarts once), each against
    ``fixed_s``, the median second an iteration on a fixed batch."""
    import torch
    from ccvs_tpu_torch.train.ae_trainer import cycle_loader, to_device

    img_loader, vid_loader = tr.make_loaders()
    for name, loader in (("image", img_loader), ("clip", vid_loader)):
        times, t0 = [], time.perf_counter()
        for _ in loader:
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        log(f"train ae bairhd loader: one epoch of {len(times)} {name} batches at "
            f"{loader.num_workers} threads: the first {times[0]:.3f} s, then median "
            f"{statistics.median(times[1:]):.3f} s a batch (max {max(times[1:]):.3f} s)")
    img_it, vid_it = cycle_loader(img_loader), cycle_loader(vid_loader)
    fed = []
    for it in range(17, 23):
        w0 = time.perf_counter()
        img, vid = to_device(next(img_it), "cuda"), to_device(next(vid_it), "cuda")
        state, _, _, _ = tr.iteration(state, it, img, vid)
        torch.cuda.synchronize()
        fed.append(time.perf_counter() - w0)
    img_it.close()
    vid_it.close()
    log(f"train ae bairhd loader: 6 iterations without R1 fed by the loaders: median "
        f"{statistics.median(fed):.4f} s, max {max(fed):.4f} s, against {fixed_s:.4f} s on a "
        f"fixed batch (host clock, synchronized; each {[round(x, 4) for x in fed]})")
    return state


def r1_convolutions(fn):
    """The convolutions ``fn()`` dispatches, by kind: a depthwise blur
    (``groups`` = channels), the weight gradient of one such group (an
    input of one item whose channels are the batch, fp32), others by dtype."""
    import collections

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    kinds = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops.aten.convolution.default:
                x, w, groups = args[0], args[1], args[-1]
                if groups > 1:
                    kinds["depthwise (grouped)"] += 1
                elif x.shape[0] == 1:
                    kinds[f"per-group, {x.dtype} (batch as channels)"] += 1
                else:
                    kinds[f"other {x.dtype}"] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return kinds


def phase_ae_runs():
    """(c) ``FrameAutoencoderTrainer.run`` with the eval, its resume and npz
    mirror (the JAX package's ``ae_gen`` keys); ``StftAutoencoderTrainer.run``
    on seeded spectrogram batches and its resume; ``cli.py train-ae`` then
    ``train-transformer --ae-ckpt`` at the small configuration."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from ccvs_tpu_torch import cli
    from ccvs_tpu_torch.config import StftConfig, TransformerConfig
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer
    from ccvs_tpu_torch.train.state_trainer import StftAutoencoderTrainer
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        cfg = small_ae_config().replace(save_path=tmp, npz_mirror=os.path.join(tmp, "m.npz"))
        tr = FrameAutoencoderTrainer(cfg)
        ran = tr.run(n_iter=3, eval_every=2)
        fresh = FrameAutoencoderTrainer(cfg)
        loaded = CheckpointManager(os.path.join(tmp, "checkpoints", cfg.name)).load(
            "qvid", "latest", target=fresh.init_state())
        same = all(torch.equal(a, b) for a, b in zip(loaded.ema.parameters(),
                                                      ran.ema.parameters()))
        if not (loaded.step == ran.step == 3 and same):
            raise AssertionError("train ae run: the resumed state differs from the saved one")
        if FrameAutoencoderTrainer(cfg).run(n_iter=4, resume=True).step != 4:
            raise AssertionError("train ae run: the resumed run did not reach step 4")
        with np.load(cfg.npz_mirror) as z:
            keys = {k[len("ae_gen/"):]: tuple(z[k].shape) for k in z.files}
        if keys != AE_MIRROR_KEYS:
            raise AssertionError(f"train ae run: npz mirror keys {sorted(keys)} are not the JAX "
                                 "package's ae_gen tree")
        with open(os.path.join(tmp, "logs", cfg.name, "metrics.jsonl")) as f:
            psnr = [d["qvid_eval/rec_psnr"] for d in map(json.loads, f)
                    if "qvid_eval/rec_psnr" in d]
        if len(psnr) != 2 or not all(math.isfinite(x) for x in psnr):
            raise AssertionError(f"train ae run: eval PSNRs {psnr}, expected 2 finite ones")
        scfg = cfg.replace(name="stft_small", stft=StftConfig(stft_num=32), n_iter_eval=1)
        rng = np.random.RandomState(0)
        spec = [{"stft": rng.uniform(-1, 1, (2, 3, 64, 16, 1)).astype(np.float32)}
                for _ in range(4)]
        st = StftAutoencoderTrainer(scfg)
        st.make_loader = lambda: spec
        first = st.run(n_iter=3)
        st2 = StftAutoencoderTrainer(scfg)
        st2.make_loader = lambda: spec
        if first.step != 3 or st2.run(n_iter=4, resume=True).step != 4:
            raise AssertionError("train ae run: the STFT trainer did not run and resume")
        gpt = TransformerConfig(z_num=32, z_len=128, z_chunk=64, num_blocks=2, cond_len=64,
                                n_layer=2, n_head=2, n_embd=32, z_shape=(8, 8))
        ccfg = cfg.replace(name="cli_ae", n_iter=2, npz_mirror="", gpt=gpt,
                           data=dataclasses.replace(cfg.data, vid_len=2))
        path = os.path.join(tmp, "cli_config.json")
        with open(path, "w") as f:
            f.write(ccfg.to_json())
        cli.main(["train-ae", "--load-config", path])
        cli.main(["train-transformer", "--load-config", path, "--name", "cli_gpt",
                  "--ae-ckpt", os.path.join(tmp, "checkpoints", "cli_ae")])
        if CheckpointManager(os.path.join(tmp, "checkpoints", "cli_gpt")).step_of(
                "transformer") != 2:
            raise AssertionError("train ae run: cli train-transformer did not take 2 steps")
    log(f"train ae run: FrameAutoencoderTrainer ran 3 iterations (rec PSNR at "
        f"{[round(x, 3) for x in psnr]} dB), its latest checkpoint "
        f"resumed equal and continued to 4; the npz mirror holds the JAX ae_gen tree's "
        f"{len(AE_MIRROR_KEYS)} keys; StftAutoencoderTrainer ran 3 and resumed to 4; cli "
        f"train-ae then train-transformer --ae-ckpt ran 2 iterations each")


def phase_ae_train(records, card):
    random.seed(0)
    phase_ae_reference()
    phase_ae_bairhd(records, card)
    phase_ae_runs()


# ---------------- phase 12: generate and score ----------------


def write_bair_set(root, n_clips, n_frames, size, seed=0):
    """A BAIR-layout valid split of moving squares,
    ``original_frames_256/test/<clip>/<frame>.png``, ``n_clips`` clips of
    ``n_frames`` frames at ``size`` px."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    side = max(2, size // 4)
    for c in range(n_clips):
        d = os.path.join(root, "original_frames_256", "test", f"{c:04d}")
        os.makedirs(d)
        x0, y0 = rng.randint(0, size - side, 2)
        vx, vy = rng.randint(-(size // 32) - 1, size // 32 + 2, 2)
        color = rng.randint(64, 255, 3)
        for t in range(n_frames):
            f = np.full((size, size, 3), 32, np.uint8)
            x, y = (int(np.clip(p + v * t, 0, size - side)) for p, v in ((x0, vx), (y0, vy)))
            f[y:y + side, x:x + side] = color
            Image.fromarray(f).save(os.path.join(d, f"{t:02d}.png"))


def seeded_checkpoints(root, cfg, dtype, device):
    """Run directories of a seeded autoencoder (``qvid``: ``gen`` and
    ``ema``, with the run's ``config.json``) and GPT (``transformer``), as
    the trainers write them, through the port's ``CheckpointManager``."""
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    ae_dir, gpt_dir = os.path.join(root, "ae"), os.path.join(root, "gpt")
    sd = FrameAutoencoder(cfg.ae, dtype=dtype, device=device).init(seed=0).state_dict()
    CheckpointManager(ae_dir).save("qvid", 1, {"gen": sd, "ema": sd}, latest=True)
    with open(os.path.join(ae_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    tr = TokenTransformer(cfg.gpt, dtype=dtype, device=device).init(seed=1)
    CheckpointManager(gpt_dir).save("transformer", 1, {"params": tr.state_dict()}, latest=True)
    return ae_dir, gpt_dir


def small_generate_config(root):
    """Phase 12 (a)'s configuration: phase 11's autoencoder widths at 16 px,
    a 2-layer GPT of head size 64 (K2's), greedy; clips of 3 frames from a
    BAIR-layout set, batches of 4."""
    from ccvs_tpu_torch.config import AutoencoderConfig, Config, DataConfig, TransformerConfig

    ae = AutoencoderConfig(necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16,
                           z_num=32, z_shape=(8, 8), max_dim=16, inter_p=0.5, skip_memory=2,
                           skip_context=(1, 2))
    gpt = TransformerConfig(z_num=32, z_len=192, z_chunk=64, num_blocks=3, cond_len=64,
                            n_layer=2, n_head=2, n_embd=128, z_shape=(8, 8), top_k=1)
    data = DataConfig(dataset="bairhd", dataroot=os.path.join(root, "bair"), max_dim=16,
                      true_dim=16, vid_len=3, batch_size_vid=4, num_workers=2)
    return Config(name="small", data=data, ae=ae, gpt=gpt, save_path=root)


def _rel_files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


# eval-all's JSON: the JAX package's keys (tests/test_torch_generate_cli.py
# holds them to its fvd_from_videos and video_metrics)
EVAL_ALL_KEYS = {
    "fvd": {"fvd_uncalibrated", "fallback_embedder", "fvd_uncalibrated_mean",
            "fvd_uncalibrated_std"},
    "metrics": {"psnr", "ssim", "lpips_uncalibrated", "lpips_fallback_weights"},
}
JPEG_MAX_LEVELS, JPEG_MEAN_LEVELS = 12, 0.5


def check_eval_all(out, passes, chunk_note=False):
    fvd_keys = set(EVAL_ALL_KEYS["fvd"])
    if chunk_note:
        fvd_keys = {"fvd_uncalibrated", "fallback_embedder", "fvd_uncalibrated_chunk_note"}
    want = {f"{kind}_{p}_vs_real" for p in passes for kind in ("fvd", "metrics")}
    if set(out) != want:
        raise AssertionError(f"eval-all printed {sorted(out)}, expected {sorted(want)}")
    for p in passes:
        for kind, keys in (("fvd", fvd_keys), ("metrics", EVAL_ALL_KEYS["metrics"])):
            got = out[f"{kind}_{p}_vs_real"]
            if set(got) != keys:
                raise AssertionError(f"eval-all {kind}_{p}: keys {sorted(got)}, expected "
                                     f"{sorted(keys)}")
            for k, v in got.items():
                if isinstance(v, float) and not math.isfinite(v):
                    raise AssertionError(f"eval-all {kind}_{p}: {k} = {v}")


def phase_generate_reference():
    """(a) The small fp32 configuration through ``cli.py generate`` on the
    card and on the CPU, greedily: the same files, the real clips byte for
    byte, the decoded fake and reconstructed frames within
    ``JPEG_MAX_LEVELS`` (any pixel) and ``JPEG_MEAN_LEVELS`` (a frame's mean)
    uint8 levels: the card's and the CPU's fp32 videos differ by about 1e-5,
    which flips the truncating uint8 conversion by one level where a value
    lies that near a level, and one level moved in a pixel can move the
    rounding of a quantised JPEG coefficient of its 8x8 block (quality 92's
    steps are 1-6 levels). Then the eval functions on the card against the
    CPU over the card's files: I3D (seeded, made on the CPU and copied) and
    the fallback embeddings within 1e-4 of the largest entry, PSNR and SSIM
    within 1e-9, LPIPS within 1e-5 relative (a seeded VGG19 through an npz);
    ``eval-all`` on the card printing the JAX package's keys; and a planted
    fault, the I3D stem padded symmetrically (3, 3) instead of TF's (2, 3),
    shown to fail the embedding check."""
    import copy
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch import cli
    from ccvs_tpu_torch.device import resolve_device
    from ccvs_tpu_torch.eval import fvd, metrics
    from ccvs_tpu_torch.nn.vgg import make_vgg
    from ccvs_tpu_torch.utils.video_io import read_video

    with tempfile.TemporaryDirectory() as root:
        cfg = small_generate_config(root)
        write_bair_set(cfg.data.dataroot, 8, 3, 16)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        ae_dir, gpt_dir = seeded_checkpoints(root, cfg, torch.float32, "cpu")
        flags = ["--load-config", cfg_path, "--ae-ckpt", ae_dir, "--gpt-ckpt", gpt_dir,
                 "--n-batches", "2", "--dtype", "float32"]
        res = {dev: cli.main(["generate", *flags, "--device", dev, "--name", dev])
               for dev in ("cuda", "cpu")}
        files = {dev: _rel_files(r["path"]) for dev, r in res.items()}
        if files["cuda"] != files["cpu"] or len(files["cuda"]) != 24:
            raise AssertionError(f"generate small: files differ: {files}")
        worst = {"max": 0, "mean": 0.0}
        for rel in files["cuda"]:
            a, b = (read_video(os.path.join(res[dev]["path"], rel)).astype(np.int16)
                    for dev in ("cuda", "cpu"))
            d = np.abs(a - b)
            if rel.startswith("real") and d.any():
                raise AssertionError(f"generate small: {rel} differs on the card")
            worst["max"] = max(worst["max"], int(d.max()))
            worst["mean"] = max(worst["mean"], float(d.reshape(len(d), -1).mean(1).max()))
        if worst["max"] > JPEG_MAX_LEVELS or worst["mean"] > JPEG_MEAN_LEVELS:
            raise AssertionError(f"generate small: decoded frames differ by {worst} levels")
        log(f"generate small: card and CPU wrote the same {len(files['cuda'])} files, the real "
            f"clips byte for byte, fake and rec frames within {worst['max']} levels (a frame's "
            f"mean within {worst['mean']:.4f}; tolerance {JPEG_MAX_LEVELS} / "
            f"{JPEG_MEAN_LEVELS})")

        dirs = {k: os.path.join(res["cuda"]["path"], k) for k in ("real", "fake", "rec")}
        fake = cli._load_dir(dirs["fake"])
        card = resolve_device("cuda")
        i3d_cpu = fvd.make_i3d_embedder(seed=0, device="cpu")
        errs, want = {}, {}
        for name, cpu_e in (("i3d", i3d_cpu), ("fallback", fvd.make_fallback_embedder(
                device="cpu"))):
            want[name] = fvd.embeddings_from_videos(fake, cpu_e)
            got = fvd.embeddings_from_videos(fake, fvd.Embedder(copy.deepcopy(cpu_e.net), card))
            errs[name] = float(np.abs(got - want[name]).max() / np.abs(want[name]).max())
        stem = fvd.Embedder(copy.deepcopy(i3d_cpu.net), card)
        u = stem.net.Conv3d_1a
        u.forward = lambda x: torch.relu(u.bn(F.conv3d(x, u.conv3d.weight, None, u.stride,
                                                       padding=3)))
        planted = float(np.abs(fvd.embeddings_from_videos(fake, stem) - want["i3d"]).max()
                        / np.abs(want["i3d"]).max())
        vgg = make_vgg(None, seed=0, device="cpu", context="phase 12's LPIPS")
        vgg_npz = os.path.join(root, "vgg19.npz")
        np.savez(vgg_npz, **{f"features.{n[4:]}.{k}": getattr(m, k).detach().numpy()
                             for n, m in vgg.named_children() for k in ("weight", "bias")})
        real_u, fake_u = cli._load_dir(dirs["real"], unit=True), cli._load_dir(dirs["fake"],
                                                                                unit=True)
        m = {dev: metrics.video_metrics(real_u, fake_u, vgg_npz=vgg_npz, device=dev)
             for dev in ("cuda", "cpu")}
        errs["psnr"] = abs(m["cuda"]["psnr"] - m["cpu"]["psnr"])
        errs["ssim"] = abs(m["cuda"]["ssim"] - m["cpu"]["ssim"])
        errs["lpips"] = abs(m["cuda"]["lpips_uncalibrated"] / m["cpu"]["lpips_uncalibrated"] - 1)
        bounds = {"i3d": 1e-4, "fallback": 1e-4, "psnr": 1e-9, "ssim": 1e-9, "lpips": 1e-5}
        bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
        if bad:
            raise AssertionError(f"eval small: the card differs from the CPU: {bad} (bounds "
                                 f"{bounds})")
        if not planted > bounds["i3d"]:
            raise AssertionError(f"eval small: the planted fault (symmetric stem padding) "
                                 f"passed: {planted:.3g} of the largest entry")
        out = cli.main(["eval-all", "--real", dirs["real"], "--fake", dirs["fake"], "--rec",
                        dirs["rec"], "--chunk", "4", "--device", "cuda"])
        check_eval_all(out, ("fake", "rec"))
        log(f"eval small, card against CPU: I3D (1024-d) within {errs['i3d']:.3g} and the "
            f"fallback within {errs['fallback']:.3g} of the largest entry, PSNR "
            f"{m['cuda']['psnr']:.6f} within {errs['psnr']:.3g}, SSIM {m['cuda']['ssim']:.6f} "
            f"within {errs['ssim']:.3g}, LPIPS within {errs['lpips']:.3g} relative; "
            f"the planted fault (symmetric stem padding) off by {planted:.3g} of the largest "
            f"entry: caught; eval-all printed the JAX package's keys")


def phase_generate_bairhd(records, card):
    """(b) Full-width BAIR-256, ``bairhd_config()`` as it is: seeded bf16
    checkpoints and a 16-clip valid set of 16 frames at 256 px; ``cli.py
    generate --n-batches 1`` (one batch of 16, with reconstructions) with
    K1's and K2's launches counted around it, the rollout and the writing
    of its 48 AVIs timed apart; ``eval-all --rec`` by pass (the fallback
    embedder, seeded VGG19); the port's I3D at 224 px on the 16 real and 16
    fake clips, with its FVD; LPIPS in frames a second, SSIM's and PSNR's
    time, the peak memory; the host's stages: JPEG decoding, scipy."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from ccvs_tpu_torch import cli
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.eval import fvd, metrics

    cfg = bairhd_config()
    b, t = cfg.data.batch_size_vid * cfg.data.batch_size_valid_mult, cfg.data.vid_len
    size = cfg.ae.tokens_per_frame
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        bair = os.path.join(root, "bair")
        write_bair_set(bair, b, t, 256)
        ae_dir, gpt_dir = seeded_checkpoints(root, cfg, torch.bfloat16, "cuda")
        torch.cuda.empty_cache()
        log(f"generate bairhd set-up: {b} clips of {t} PNG frames at 256 px and seeded bf16 "
            f"checkpoints in {time.perf_counter() - t0:.1f} s")
        counted = {"vq_argmin": "k1", "flash_decode": "k2", "int8_linear": "k3"}
        # K1: the clips' encode and the context frame's re-encode in the fake
        # and the rec decode; K2: a launch a layer in each decode step
        want = {"vq_argmin": 3, "flash_decode": cfg.gpt.n_layer * (t - 1) * size,
                "int8_linear": 0}
        profiling.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = cli.main(["generate", "--preset", "bairhd", "--dataroot", bair, "--save-path",
                        root, "--ae-ckpt", ae_dir, "--gpt-ckpt", gpt_dir, "--n-batches", "1"])
        wall = time.perf_counter() - t0
        launches = {key: kernel_launches(k) for key, k in counted.items()}
        if launches != want:
            raise AssertionError(f"generate bairhd: launches {launches}, expected {want}")
        name = f"bairhd cli generate (batch {b}, rec)"
        for key, n in launches.items():
            records[key]["launches_by_rollout"][name] = n
        files = _rel_files(res["path"])
        if len(files) != 3 * b:
            raise AssertionError(f"generate bairhd: {len(files)} files, expected {3 * b}")
        gen_s, write_s = res["seconds"]["generate"][0], res["seconds"]["write"][0]
        frames = b * (t - 1)
        log(f"generate bairhd (cli.py, batch {b}, {t} frames, 1 context, bf16): rollout with "
            f"reconstructions {gen_s:.3f} s = {frames / gen_s:.4f} generated frames/s "
            f"({1e3 * gen_s / ((t - 1) * size):.2f} ms a decode step all in), writing "
            f"{len(files)} AVIs ({len(files) * t} JPEG frames, host) {write_s:.3f} s, command "
            f"{wall:.3f} s with loading; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, on "
            f"{card}")

        dirs = {k: os.path.join(res["path"], k) for k in ("real", "fake", "rec")}
        torch.cuda.reset_peak_memory_stats()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            out = cli.main(["eval-all", "--real", dirs["real"], "--fake", dirs["fake"], "--rec",
                            dirs["rec"], "--chunk", "16"])
        wall = time.perf_counter() - t0
        check_eval_all(out, ("fake", "rec"), chunk_note=False)
        passes = json.loads(next(line for line in err.getvalue().splitlines()
                                 if line.startswith("eval-all seconds: "))[18:])
        log(f"eval-all bairhd ({b} clips a pass, fallback embedder, seeded VGG19): "
            f"{wall:.3f} s, by pass (s) " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items())
            + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"fake: {out['fvd_fake_vs_real']['fvd_uncalibrated']:.4f} FVD (uncalibrated), "
            f"PSNR {out['metrics_fake_vs_real']['psnr']:.4f}, SSIM "
            f"{out['metrics_fake_vs_real']['ssim']:.4f}; rec: PSNR "
            f"{out['metrics_rec_vs_real']['psnr']:.4f}")

        t0 = time.perf_counter()
        real, fake = cli._load_dir(dirs["real"]), cli._load_dir(dirs["fake"])
        decode_s = time.perf_counter() - t0
        i3d = fvd.make_i3d_embedder(seed=0)
        fvd.embeddings_from_videos(real[:2], i3d)  # cuDNN's first-call choices
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        emb = [fvd.embeddings_from_videos(v, i3d) for v in (real, fake)]
        i3d_s = common.synced(CARD) - t0
        t0 = time.perf_counter()
        fvd_i3d = fvd.frechet_distance(*emb)
        scipy_s = time.perf_counter() - t0
        log(f"I3D bairhd (seeded filters, 224 px, batches of 16): {2 * b} clips of {t} frames "
            f"in {i3d_s:.3f} s = {2 * b / i3d_s:.2f} clips/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; FVD (uncalibrated) "
            f"{fvd_i3d:.4f}, the Frechet distance of 1024-d embeddings on the host (numpy, "
            f"scipy sqrtm) {scipy_s:.3f} s; decoding the {2 * b * t} JPEG frames of two "
            f"directories on the host {decode_s:.3f} s")

        lp = metrics.LPIPS(device="cuda")
        r, f_ = (torch.from_numpy(x).to(lp.device) for x in (real, fake))
        lp.distance(r[0], f_[0])
        t0 = time.perf_counter()
        for i in range(b):
            lp.distance(r[i], f_[i])
        lpips_s = common.synced(CARD) - t0
        ru, fu = ((x.double() + 1) / 2 for x in (r, f_))
        metrics.ssim_frames(ru[0], fu[0])
        t0 = time.perf_counter()
        for i in range(b):
            metrics.ssim_frames(ru[i], fu[i])
        ssim_s = common.synced(CARD) - t0
        t0 = time.perf_counter()
        for i in range(b):
            metrics.psnr_frames(ru[i], fu[i])
        psnr_s = common.synced(CARD) - t0
        log(f"LPIPS bairhd (VGG19, 256 px, a clip of {t} frames a call): {b * t} frame pairs "
            f"in {lpips_s:.3f} s = {b * t / lpips_s:.1f} pairs/s; SSIM (fp64, 7x7) "
            f"{ssim_s:.3f} s, PSNR {psnr_s:.3f} s for the same frames, on the card")
        del r, f_, ru, fu
        torch.cuda.empty_cache()


def phase_generate(records, card):
    phase_generate_reference()
    phase_generate_bairhd(records, card)


# ---------------- phase 13: ADA and layouts ----------------


def ada_checks():
    """(a) ADA's pieces on the card against the CPU in fp32, on the same
    draws: the warp (``apply_affine``), the colour matrix and ``augment``
    within 1e-5; R1 through the augmentation for a small discriminator
    ``D(x) = sum(softplus(aug(x) * v))``: the input gradient and the
    gradient of its squared norm with respect to ``v`` (a second
    derivative through the warp) within 1e-4 of their largest entry (sums
    in no fixed order on the card); a planted fault, the downsampling's
    wavelet left unflipped, caught."""
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.train import ada

    g = torch.Generator().manual_seed(11)
    b, h, w = 4, 32, 24
    img = torch.rand(b, h, w, 3, generator=g) * 2 - 1
    v = torch.randn(1, h, w, 3, generator=g)
    draws = (ada.draw_affine(g, b), ada.draw_color(g, b))

    def on(dev):
        return tuple({k: x.to(dev) for k, x in d.items()} for d in draws)

    def run(dev):
        d = on(dev)
        G = torch.linalg.inv(ada.build_affine(d[0], 0.8, h, w))
        C = ada.build_color(d[1], 0.8)
        x = img.to(dev).requires_grad_()
        vv = v.to(dev).requires_grad_()
        score = F.softplus(ada.augment(None, x, 0.8, draws=d) * vv).sum()
        (gx,) = torch.autograd.grad(score, x, create_graph=True)
        (gv,) = torch.autograd.grad((gx ** 2).sum(), vv)
        return {"apply_affine": ada.apply_affine(img.to(dev), G),
                "apply_color": ada.apply_color(img.to(dev), C),
                "augment": ada.augment(None, img.to(dev), 0.8, draws=d),
                "r1 input gradient": gx, "r1 second derivative": gv}

    cpu, card = run("cpu"), run("cuda")
    errs = {k: float((card[k].detach().double().cpu() - cpu[k].detach().double()).abs().max()
                     / cpu[k].detach().abs().max()) for k in cpu}
    # the derivatives are sums, in no fixed order on the card, of the
    # transposed bilinear sample's scattered weights and the 12-tap passes'
    bounds = {k: 1e-4 if k.startswith("r1") else 1e-5 for k in errs}
    bad = {k: e for k, e in errs.items() if not e <= bounds[k]}
    if bad:
        raise AssertionError(f"ada: on the card off the CPU's by {bad} of the largest entry "
                             f"(bounds {bounds})")
    # planted fault: the downsampling pass with the wavelet unflipped
    orig = ada.upfirdn2d

    def unflipped(x, k, up=1, down=1, pad=(0, 0)):
        return orig(x, torch.flip(k, (0, 1)) if down != 1 else k, up, down, pad)

    ada.upfirdn2d = unflipped
    try:
        bad = ada.augment(None, img.cuda(), 0.8, draws=on("cuda")).double().cpu()
    finally:
        ada.upfirdn2d = orig
    planted = float((bad - cpu["augment"].double()).abs().max()
                    / cpu["augment"].abs().max())
    if planted <= 1e-5:
        raise AssertionError(f"ada: the planted fault (unflipped sym6) passed ({planted:.3g})")
    log(f"ada small: card against CPU on the same draws, of the largest entry: "
        + ", ".join(f"{k} {e:.3g} (bound {bounds[k]})" for k, e in errs.items())
        + f"; the planted fault (the down pass's sym6 unflipped) off by "
        f"{planted:.3g}: caught")


def small_layout_config():
    """Phase 13 (a)'s layout configuration: phase 6's autoencoder widths at
    8 px with the shared-decoder layout twins (2 classes), a 2-layer GPT
    with K2's head size (2 heads of 64) whose control stream is 16 layout
    tokens a frame, greedy (``top_k`` 1 for frames and layouts)."""
    from ccvs_tpu_torch.config import AutoencoderConfig, Config, TransformerConfig

    ae = AutoencoderConfig(
        necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
        max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3), use_layout=True,
        layout_size=2, same_decoder_layout=True)
    gpt = TransformerConfig(
        z_num=32, z_len=96, z_chunk=32, num_blocks=3, cond_len=16, n_layer=2, n_head=2,
        n_embd=128, z_shape=(4, 4), top_k=1, top_k_state=1, sample_state=True, layout=True,
        state_num=32, state_size=16)
    return Config(name="layout_small", ae=ae, gpt=gpt)


def layout_checks():
    """(a) The layout twins on the card against the CPU in fp32, from one
    seeded init made on the CPU: ``decode_video_layout`` on given tokens
    (re-encoding its own layouts, and with the given layouts' features),
    frames within 1e-3 and layouts equal; greedy ``generate(layout=...)``
    with the rec rollout: frame and layout tokens equal, ``fake`` and
    ``rec`` within 1e-3, ``fake_layout`` and ``rec_layout`` equal."""
    import torch
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer

    cfg = small_layout_config()
    models = {}
    for dev in ("cpu", "cuda"):
        ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device=dev)
        tr = TokenTransformer(cfg.gpt, dtype=torch.float32, device=dev)
        models[dev] = (ae, tr, VideoGenerator(cfg, ae, tr))
    models["cpu"][0].init(seed=0)
    models["cpu"][1].init(seed=1)
    for i in range(2):
        models["cuda"][i].load_state_dict(models["cpu"][i].state_dict())
    g = torch.Generator().manual_seed(12)
    vid = torch.rand(2, 3, 8, 8, 3, generator=g) * 2 - 1
    lay = (vid.mean(-1) > 0).long()
    codes, lcodes = torch.randint(0, 32, (2, 3, 16), generator=g), torch.randint(0, 32, (2, 3, 16),
                                                                                 generator=g)
    out = {}
    for dev, (ae, tr, gen) in models.items():
        interl = [f[:, 1:] for f in ae.encode_layout(lay.to(dev))["inter"]]
        out[dev] = {"free": ae.decode_video_layout(codes.to(dev), lcodes.to(dev),
                                                   vid[:, :1].to(dev), lay[:, :1].to(dev)),
                    "given": ae.decode_video_layout(codes.to(dev), lcodes.to(dev),
                                                    vid[:, :1].to(dev), lay[:, :1].to(dev),
                                                    interl_gen=interl),
                    "gen": gen.generate(vid.to(dev), torch.Generator(device=dev).manual_seed(0),
                                        layout=lay.to(dev))}
    err = 0.0
    for k in ("free", "given"):
        (cv, cl), (gv, gl) = out["cpu"][k], out["cuda"][k]
        err = max(err, float((gv.cpu() - cv).abs().max()))
        if not torch.equal(gl.float().argmax(-1).cpu(), cl.argmax(-1)):
            raise AssertionError(f"layout small: decode_video_layout ({k}) layouts differ")
    c, d = out["cpu"]["gen"], out["cuda"]["gen"]
    for k in ("code", "state_code", "fake_layout", "rec_layout"):
        if not torch.equal(d[k].cpu(), c[k]):
            raise AssertionError(f"layout small: generate's {k} differs on the card")
    for k in ("fake", "rec"):
        err = max(err, float((d[k].cpu() - c[k]).abs().max()))
    if not err <= 1e-3:
        raise AssertionError(f"layout small: frames off the CPU's by {err:.3g} (bound 1e-3)")
    log(f"layout small: decode_video_layout (re-encoded and given layouts) and greedy "
        f"generate(layout=...) with its rec rollout on the card as on the CPU: tokens, layout "
        f"tokens and decoded layouts equal, frames within {err:.3g} (bound 1e-3)")


def phase_ada_reference():
    """(a) One ADA configuration of phase 11 (a): the small autoencoder with
    the adaptive probability raised each image D step (a target below any
    statistic; 4 real images of ``ada_length`` 10: 0.4, 0.8, then 1), three
    iterations held step by step to the CPU (:func:`phase_ae_reference`)."""
    p = phase_ae_reference(cfg=small_ae_config(use_aug=True, aug_p=0.0, ada_target=-1.5,
                                               ada_length=10), label="train ada small")
    if p != [0.4, 0.8, 1.0] and [round(x, 6) for x in p] != [0.4, 0.8, 1.0]:
        raise AssertionError(f"train ada small: ada_p {p}, expected 0.4, 0.8, 1.0")


def _ada_iterations(tr, state, img, vid, its):
    """``tr.iteration``'s steps one by one at iterations ``its`` (each with
    its ``(seed, it)`` generator): per iteration the wall time (host,
    synchronized), the split by step (CUDA events), the losses, and
    ``(ada_p before the image D step, after it, rt_stat)``."""
    import torch
    from ccvs_tpu_torch.train.states import iteration_generator

    acfg = tr.cfg.ae
    rows = []
    for it in its:
        gen = iteration_generator(tr.cfg.seed, it, "cuda")
        fake, ms, spans = {}, {}, common.Spans(True)
        w0 = time.perf_counter()
        for kind, mode in AE_STEPS:
            if kind == "r1" and it % acfg.d_reg_every:
                continue
            p0 = float(state.ada_p) if (kind, mode) == ("d", "img") else None
            with spans.span(f"{kind} {mode}"):
                state, m, fake[mode], _, _ = _ae_step(tr, state, kind, mode,
                                                      img if mode == "img" else vid,
                                                      fake.get(mode), gen)
            ms.update(m)
            if p0 is not None:
                ada = (p0, float(state.ada_p), float(m["rt_stat"]))
        state.step = it + 1
        torch.cuda.synchronize()
        rows.append({"it": it, "wall": time.perf_counter() - w0, "ada": ada,
                     "split": {k: t[0] for k, t in spans.ms().items()},
                     "losses": {k: float(v) for k, v in ms.items()}})
    return state, rows


def _check_ada_rows(label, tr, rows, n_real):
    for r in rows:
        p0, p1, r_t = r["ada"]
        want = ada_rule(tr.cfg.ae, p0, r_t, n_real)
        if abs(p1 - want) > 1e-7:
            raise AssertionError(f"{label}: ada_p {p0} -> {p1} at iteration {r['it']} (r_t "
                                 f"{r_t}), the rule gives {want}")
        bad = [k for k, v in r["losses"].items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{label}: non-finite {bad} at iteration {r['it']}")


def phase_ada_bairhd(records, card):
    """(b) ADA at full BAIR-256 width: phase 11 (b)'s configuration with
    ``use_aug`` and the adaptive probability, 2 warm-up and 3 timed
    iterations (the last with R1) on one fixed batch pair; K1 exactly 2
    launches an iteration, ``ada_p`` after each D step the controller's
    rule of the card's own statistic. Then the repo's trained configuration
    ``runs_r5/r5_bair_eval_config.json`` as it is (64 px, the video
    discriminator, ADA, its batch of 24 images and 4 clips), 3 iterations
    (the first with R1)."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import Config, bairhd_config
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device

    base = bairhd_config()
    cfg = base.replace(name="train_ada_bairhd",
                       data=dataclasses.replace(base.data, dataset="synthetic", batch_size_img=24,
                                                batch_size_vid=4),
                       ae=dataclasses.replace(base.ae, use_aug=True, aug_p=0.0))
    torch.cuda.empty_cache()
    (bi, bv), = _ae_batches(cfg, 1)
    tr = FrameAutoencoderTrainer(cfg)
    tr.init_params()
    state = tr.init_state()
    img, vid = to_device(bi, "cuda"), to_device(bv, "cuda")
    n_real = n_real_images(tr.losses, img["img"].shape[0])
    torch.cuda.reset_peak_memory_stats()
    state, warm = _ada_iterations(tr, state, img, vid, [1, 2])
    profiling.reset()
    state, rows = _ada_iterations(tr, state, img, vid, [3, 4, 16])
    launches = kernel_launches("k1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != 2 * 3:
        raise AssertionError(f"train ada bairhd: K1 launched {launches} times in 3 iterations "
                             "(expected 6)")
    records["vq_argmin"]["launches_by_rollout"]["train_ada_bairhd (3 iterations)"] = launches
    _check_ada_rows("train ada bairhd", tr, warm + rows, n_real)
    plain = statistics.median([r["wall"] for r in rows if r["it"] % 16])
    log(f"train ada bairhd: ADA (adaptive p) at full BAIR-256 width, 24 images and 4 clips of 4 "
        f"frames: without R1 median {plain:.4f} s an iteration, with R1 {rows[-1]['wall']:.4f} s "
        f"(host clock, synchronized; phase 11 (b) without ADA: 1.3138 / 1.8508 s, PR 10); peak "
        f"memory {peak:.2f} GiB; K1 {launches} launches in 3 iterations; ada_p after each D "
        f"step {[round(r['ada'][1], 6) for r in warm + rows]} (rt_stat "
        f"{[r['ada'][2] for r in warm + rows]}, {n_real} real images, the rule's); on {card}")
    for name in rows[-1]["split"]:
        vals = [r["split"][name] for r in rows if name in r["split"]]
        log(f"    {name}: median {statistics.median(vals):9.2f} ms (CUDA events, {len(vals)} "
            "iterations)")
    del tr, state, img, vid
    torch.cuda.empty_cache()

    cfg = Config.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs_r5",
                                   "r5_bair_eval_config.json"))
    t0 = time.perf_counter()
    (bi, bv), = _ae_batches(cfg, 1)
    tr = FrameAutoencoderTrainer(cfg)
    tr.init_params()
    state = tr.init_state()
    img, vid = to_device(bi, "cuda"), to_device(bv, "cuda")
    profiling.reset()
    state, rows = _ada_iterations(tr, state, img, vid, [0, 1, 2])
    if kernel_launches("k1") != 2 * 3:
        raise AssertionError(f"train ada r5_bair: K1 launched {kernel_launches('k1')} times in 3 "
                             "iterations (expected 6)")
    _check_ada_rows("train ada r5_bair", tr, rows, n_real_images(tr.losses, img["img"].shape[0]))
    log(f"train ada r5_bair: runs_r5/r5_bair_eval_config.json as it is ({cfg.ae.max_dim} px, "
        f"use_dv {cfg.ae.use_dv}, ADA aug_p {cfg.ae.aug_p}, image batch "
        f"{tuple(img['img'].shape)}, clips {tuple(vid['vid'].shape)}): iterations "
        f"{[round(r['wall'], 4) for r in rows]} s (the first with R1 and the first calls; set-up "
        f"{time.perf_counter() - t0 - sum(r['wall'] for r in rows):.1f} s), ada_p "
        f"{[round(r['ada'][1], 8) for r in rows]}, K1 6 launches")


def bairhd_layout_config():
    """Phase 13 (c)'s configuration: ``bairhd_config()`` with the autoencoder's
    shared-decoder layout twins over the synthetic moving squares' 2
    classes, and layout tokens (64 a frame, the layout codebook's 1024) as
    the GPT's control stream: its window holds 16 frames of 128 tokens."""
    import dataclasses

    from ccvs_tpu_torch.config import bairhd_config

    base = bairhd_config("bairhd_layout")
    return base.replace(
        ae=dataclasses.replace(base.ae, use_layout=True, same_decoder_layout=True, layout_size=2),
        gpt=dataclasses.replace(base.gpt, layout=True, state_num=1024, state_size=64,
                                z_len=2048, z_chunk=128, sample_state=True),
        data=dataclasses.replace(base.data, dataset="synthetic", load_layout=True,
                                 batch_size_img=24, batch_size_vid=4))


def phase_layout_bairhd(records, card):
    """(c) Layouts at full BAIR-256 width (:func:`bairhd_layout_config`):
    one rollout at batch 2, ``MODE_LEN`` (4) frames from 1 context frame,
    bf16, sampled layouts past the context (a 2-frame warm-up, then the run
    timed with its launches counted: K1 4, K2 24 x 384); one transformer step on
    2 clips of 16 frames with their layout tokens (K1 2: the frames' and
    the layouts' encodes); one autoencoder iteration with layouts at 24
    images and 4 clips (K1 4: the image and layout quantizers of both G
    steps), each after one warm-up."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.data import create_dataset, group_collate
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    cfg = bairhd_layout_config()
    torch.cuda.empty_cache()
    ae, tr, gen = build_models(cfg)
    ds = create_dataset(cfg.data, phase="valid", load_vid=True)
    batch = to_device(group_collate([ds[0], ds[1]]), "cuda")
    vid, lay = batch["vid"], batch["layout"]
    assert vid.shape == (BATCH, VID_LEN, 256, 256, 3) and lay.shape == (BATCH, VID_LEN, 256, 256)
    t0 = time.perf_counter()
    gen.generate(vid[:, :2], torch.Generator(device="cuda").manual_seed(3), rec=False,
                 layout=lay[:, :2])
    warm = common.synced(CARD) - t0
    tpf = cfg.ae.tokens_per_frame + cfg.gpt.state_size
    steps = (MODE_LEN - 1) * tpf
    out, dt = run_path(records, card, cfg, gen, vid[:, :MODE_LEN], 1, 4, steps,
                       layout=lay[:, :MODE_LEN], name="bairhd_layout")
    fl = out["fake_layout"]
    if fl.shape != lay[:, :MODE_LEN].shape or not bool(((fl == 0) | (fl == 1)).all()):
        raise AssertionError(f"bairhd_layout: fake_layout {tuple(fl.shape)} not 2-class maps")
    if not torch.equal(out["state_code"][:, :cfg.gpt.state_size],
                       ae.encode_layout(lay[:, :1])["code"].reshape(BATCH, -1)):
        raise AssertionError("bairhd_layout: the context frame's layout tokens were not kept")
    log(f"bairhd_layout: 2-frame warm-up {warm:.3f} s; the timed rollout's {steps} decode steps "
        f"{1e3 * dt / steps:.2f} ms each; fake_layout's squares cover "
        f"{100 * float(fl.float().mean()):.2f} % (the real layouts' "
        f"{100 * float(lay[:, :MODE_LEN].float().mean()):.2f} %)")

    # one transformer step on layout tokens: 2 clips (a window of 2048
    # tokens holds 4x the attention of the 1024-token step of phase 10)
    tt = TransformerTrainer(cfg, ae)
    tstate = tt.init_state()
    for i in range(2):
        profiling.reset()
        t0 = time.perf_counter()
        tb = tt.encode_batch({"vid": vid, "layout": lay})
        tstate, m = tt.step(tstate, tb)
        dt = common.synced(CARD) - t0
        if kernel_launches("k1") != 2:
            raise AssertionError(f"layout transformer step: K1 launched {kernel_launches('k1')} "
                                 "times (expected 2)")
    if not all(math.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"layout transformer step: non-finite metrics {m}")
    n_tok = BATCH * (VID_LEN * tpf - 1)
    records["vq_argmin"]["launches_by_rollout"]["layout transformer step"] = 2
    log(f"layout transformer step: 2 clips x 16 frames x 128 tokens, one step {dt:.4f} s "
        f"(after one warm-up) = {n_tok / dt:.0f} tokens/s; nll {float(m['nll']):.4f}, "
        f"state_nll (layouts) {float(m['state_nll']):.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 2 launches")
    del ae, tr, gen, tt, tstate, tb
    torch.cuda.empty_cache()

    (bi, bv), = _ae_batches(cfg, 1)
    atr = FrameAutoencoderTrainer(cfg)
    atr.init_params()
    astate = atr.init_state()
    img, vid = to_device(bi, "cuda"), to_device(bv, "cuda")
    assert img["layout"].shape == (24, 256, 256) and vid["layout"].shape == (4, 4, 256, 256)
    torch.cuda.reset_peak_memory_stats()
    for it in (1, 2):
        profiling.reset()
        t0 = time.perf_counter()
        astate, gm, dm, _ = atr.iteration(astate, it, img, vid)
        dt = common.synced(CARD) - t0
        if kernel_launches("k1") != 4:
            raise AssertionError(f"layout AE iteration: K1 launched {kernel_launches('k1')} times "
                                 "(expected 4)")
    terms = {k: round(float(v), 4) for k, v in gm.items() if "layout" in k}
    if set(terms) != {"layout_quant_img", "layout_img", "layout_quant_vid", "layout_vid"} or \
            not all(math.isfinite(v) for v in terms.values()):
        raise AssertionError(f"layout AE iteration: layout terms {terms}")
    records["vq_argmin"]["launches_by_rollout"]["layout AE iteration"] = 4
    log(f"layout AE iteration: 24 images and 4 clips of 4 frames with layouts, one iteration "
        f"without R1 {dt:.4f} s (after one warm-up); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 4 launches; layout terms "
        f"{terms}; on {card}")


def phase_ada_layouts(records, card):
    random.seed(0)
    ada_checks()
    phase_ada_reference()
    layout_checks()
    phase_ada_bairhd(records, card)
    phase_layout_bairhd(records, card)


# ---------------- phase 14: GPT variants and reference checkpoints ----------------

POS_EMB = ("s_emb", "h_emb", "w_emb", "t_emb", "pos_emb", "state_s_emb", "state_pos_emb")


def randomize_pos_emb(model, seed, std=0.1):
    """Seeded values in the positional embeddings, which the seeded init
    zeroes as the JAX package's does: otherwise no ``emb_mode`` could show."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in POS_EMB:
                p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


def _pair(make, cpu_module, dev):
    """``make(dev)`` holding ``cpu_module``'s parameters."""
    m = make(dev)
    m.load_state_dict(cpu_module.state_dict())
    return m


def _rel_err(got, want):
    return float((got.detach().cpu() - want.detach()).abs().max()) / max(
        float(want.detach().abs().max()), 1e-30)


def check_tokens_and_logits(tr_gpu, tr_cpu, code, label):
    """A full forward's logits on the card within 1e-4 of the CPU's largest
    entry, and greedy ``generate`` tokens equal."""
    import torch

    with torch.no_grad():
        err = _rel_err(tr_gpu.model(code.to("cuda")), tr_cpu.model(code))
    got = tr_gpu.generate(code[:, :8].to("cuda"), torch.Generator(device="cuda").manual_seed(0),
                          total_len=tr_gpu.cfg.z_len)["code"]
    want = tr_cpu.generate(code[:, :8], torch.Generator().manual_seed(0),
                           total_len=tr_cpu.cfg.z_len)["code"]
    same = torch.equal(got.cpu(), want)
    log(f"variants {label}: logits card vs CPU {err:.3g} of the largest (tolerance 1e-4), greedy "
        f"tokens equal: {same}")
    if not (err <= 1e-4 and same):
        raise AssertionError(f"variants {label}: logits {err:.3g} of the largest, tokens equal "
                             f"{same}")


def variants_reference():
    """(a) Small fp32 configurations on the card against the CPU: the video
    rollout with ``emb_mode`` None (with state tokens) and
    "spatio-temporal", the GPT on a 2 x 4 grid with a planted fault (rows
    and columns traded), the continuous transformer's rollout, loss and
    gradients, and ``nll_vMF``."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import AutoencoderConfig, Config, StateConfig, TransformerConfig
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import (ContinuousTransformer, FrameAutoencoder, StateModel,
                                       TokenTransformer)
    from ccvs_tpu_torch.ops.misc import nll_vMF

    f32 = torch.float32
    ae_cfg = AutoencoderConfig(necf=16, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64,
                               z_shape=(4, 4), max_dim=32, skip_memory=3,
                               skip_context=(1, 2, 3))
    base = TransformerConfig(z_num=64, z_len=64, z_chunk=16, num_blocks=4, cond_len=16,
                             n_layer=2, n_head=2, n_embd=128, z_shape=(4, 4), top_k=1,
                             top_k_state=1)
    state_cfg = StateConfig(z_size=16, z_shape=(4, 4), state_hsize=8, state_size=2, state_num=8)
    vid = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    ae_cpu = FrameAutoencoder(ae_cfg, dtype=f32, device="cpu").init(seed=0)
    sm_cpu = StateModel(state_cfg, device="cpu").init(seed=2)
    for name, gpt_cfg in (
            ("emb_mode None with states", dataclasses.replace(
                base, emb_mode=None, z_len=72, z_chunk=18, state=True, state_num=8,
                state_size=2, sample_state=True)),
            ("spatio-temporal", dataclasses.replace(base, emb_mode="spatio-temporal"))):
        tr_cpu = TokenTransformer(gpt_cfg, dtype=f32, device="cpu").init(seed=1)
        randomize_pos_emb(tr_cpu.model, 3)
        outs = {}
        for dev in ("cuda", "cpu"):
            ae = _pair(lambda d: FrameAutoencoder(ae_cfg, dtype=f32, device=d), ae_cpu, dev)
            tr = _pair(lambda d: TokenTransformer(gpt_cfg, dtype=f32, device=d), tr_cpu, dev)
            sm = (_pair(lambda d: StateModel(state_cfg, device=d), sm_cpu, dev)
                  if gpt_cfg.state else None)
            gen = VideoGenerator(Config(ae=ae_cfg, gpt=gpt_cfg, state=state_cfg), ae, tr,
                                 state_model=sm)
            outs[dev] = gen.generate(vid.to(dev), torch.Generator(device=dev).manual_seed(0),
                                     rec=False, n_ctx_frames=1)
        gpu, cpu = outs["cuda"], outs["cpu"]
        for key in ("code", "state_code"):
            if key in cpu and not torch.equal(gpu[key].cpu(), cpu[key]):
                raise AssertionError(f"variants {name}: greedy {key} differs between the card "
                                     "and the CPU")
        err = float((gpu["fake"].cpu() - cpu["fake"]).abs().max())
        log(f"variants {name}: tokens equal on the card and the CPU, video max abs difference "
            f"{err:.3g} (tolerance 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"variants {name}: video differs by {err} > 1e-3")

    # a 2 x 4 latent grid: trading rows and columns (h_emb indexed by s % h,
    # w_emb by s // h) moves the logits, and the check must catch it
    cfg = dataclasses.replace(base, emb_mode="spatio-temporal", z_shape=(2, 4), z_len=32,
                              z_chunk=8)
    tr_cpu = TokenTransformer(cfg, dtype=f32, device="cpu").init(seed=4)
    randomize_pos_emb(tr_cpu.model, 6)
    tr_gpu = _pair(lambda d: TokenTransformer(cfg, dtype=f32, device=d), tr_cpu, "cuda")
    code = torch.randint(0, 64, (2, 24), generator=torch.Generator().manual_seed(7))
    check_tokens_and_logits(tr_gpu, tr_cpu, code, "spatio-temporal on a 2 x 4 grid")
    m = tr_gpu.model
    h = cfg.z_shape[0]

    def traded(s_idx, t_idx, delta=None):
        t = t_idx if delta is None else t_idx[None, :] + delta[:, None]
        return m._c(m.h_emb[0][s_idx % h] + m.w_emb[0][s_idx // h] + m.t_emb[0][t])

    m._frame_pos_emb = traded
    try:
        check_tokens_and_logits(tr_gpu, tr_cpu, code, "planted fault (h_emb and w_emb traded)")
        caught = False
    except AssertionError as e:
        caught = True
        log(f"variants: the planted fault is caught: {e}")
    finally:
        del m._frame_pos_emb
    if not caught:
        raise AssertionError("variants: trading h_emb and w_emb was not caught")

    g = torch.Generator().manual_seed(8)
    code = torch.randn(2, 100, 16, generator=g)
    for proposals in (1, 3):
        ccfg = TransformerConfig(z_len=128, n_layer=2, n_head=2, n_embd=128, n_in=16,
                                 n_proposals=proposals)
        cpu = ContinuousTransformer(ccfg, dtype=f32, device="cpu").init(seed=5)
        randomize_pos_emb(cpu.model, 9)
        gpu = _pair(lambda d: ContinuousTransformer(ccfg, dtype=f32, device=d), cpu, "cuda")
        for normalize in (False, True):
            err = _rel_err(gpu.generate(code[:, :9].to("cuda"), 40, normalize_pred=normalize),
                           cpu.generate(code[:, :9], 40, normalize_pred=normalize))
            log(f"variants continuous, {proposals} proposals, normalize_pred {normalize}: "
                f"rollout card vs CPU {err:.3g} of the largest (tolerance 1e-4)")
            if not err <= 1e-4:
                raise AssertionError(f"variants continuous {proposals} {normalize}: {err}")
        losses, grads = {}, {}
        for dev, ct in (("cuda", gpu), ("cpu", cpu)):
            loss, _ = ct.loss(code.to(dev))
            grads[dev] = torch.autograd.grad(loss, list(ct.model.parameters()))
            losses[dev] = float(loss.detach())
        scale = max(float(gr.abs().max()) for gr in grads["cpu"])
        gerr = max(float((a.cpu() - b).abs().max()) for a, b in zip(grads["cuda"], grads["cpu"]))
        lerr = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        log(f"variants continuous, {proposals} proposals: loss {losses['cuda']:.6f} card, "
            f"relative difference {lerr:.3g}; gradients within {gerr / scale:.3g} of the largest "
            f"entry (tolerance 1e-4 each)")
        if not (lerr <= 1e-4 and gerr <= 1e-4 * scale):
            raise AssertionError(f"variants continuous {proposals}: loss {lerr}, gradients "
                                 f"{gerr / scale}")

    # 32 dimensions: at 512, fp32 ive(255, kappa) underflows to 0 for such
    # kappa in both packages
    pred = torch.randn(64, 32, generator=g) * 3
    tgt = torch.nn.functional.normalize(torch.randn(64, 32, generator=g), dim=-1)
    vals, grads = {}, {}
    for dev in ("cuda", "cpu"):
        p = pred.to(dev).requires_grad_()
        v = nll_vMF(p, tgt.to(dev))
        v.backward()
        vals[dev], grads[dev] = float(v.detach()), p.grad.cpu()
    verr = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    gerr = _rel_err(grads["cuda"], grads["cpu"])
    log(f"variants nll_vMF: {vals['cuda']:.6f} on the card, relative difference {verr:.3g}; "
        f"gradient {gerr:.3g} of the largest (tolerance 1e-5 each)")
    if not (verr <= 1e-5 and gerr <= 1e-5):
        raise AssertionError(f"variants nll_vMF: value {verr}, gradient {gerr}")


def reference_key(group, name):
    """The reference's state-dict key of the port's parameter ``name`` of
    the network saved as ``group`` (``qvid_e``, ``qvid_g``, ``qvid_q`` or
    ``transformer_t``): the inverse of ``port_pytorch``'s translation. Both
    hold torch layouts, so the tensors are the same."""
    import re

    if group == "qvid_q":
        return "embedding.weight"
    if group == "transformer_t":
        name = re.sub(r"^core\.blocks\.", "blocks.", name).replace("core.ln_f.", "ln_f.")
        return name.replace(".fc1.", ".mlp.0.").replace(".fc2.", ".mlp.3.")
    # the encoder's downsampling convs sit after a Blur (index 1)
    down = group == "qvid_e" and re.search(r"\.(conv2|skip)\.conv\.", name)
    name = name.replace(".conv.", ".1." if down else ".0.")
    name = re.sub(r"inter_block(\d+)", r"inter_blocks.\1", name)
    name = re.sub(r"(^|\.)block(\d+)", r"\1blocks.\2", name)
    return re.sub(r"convs(\d)", r"convs.\1", name)


def phase_reference_checkpoint(records, card):
    """(b) Full-width BAIR-256 with ``emb_mode="spatio-temporal"`` from a
    checkpoint in the reference's own keys: ``qvid_e``, ``qvid_q``,
    ``qvid_g`` and ``transformer_t`` state dicts drawn N(0, 0.02) on the
    card from a seeded generator (the shapes of the port's modules), loaded
    through ``port_pytorch`` into bf16 models, every loaded tensor its
    source's (the GPT's Linear weights through the Dense kernels' transpose
    and back), then served: a 2-frame warm-up and one timed rollout of
    ``MODE_LEN`` (4) frames, launches as in phase 3."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
    from ccvs_tpu_torch.port import port_pytorch as pp

    base = bairhd_config()
    cfg = base.replace(name="bairhd_reference_ckpt",
                       gpt=dataclasses.replace(base.gpt, emb_mode="spatio-temporal"))
    torch.cuda.empty_cache()
    ae = FrameAutoencoder(cfg.ae, dtype=torch.bfloat16)
    tr = TokenTransformer(cfg.gpt, dtype=torch.bfloat16)
    nets = {"qvid_e": ae.encoder, "qvid_q": ae.quantizer, "qvid_g": ae.decoder,
            "transformer_t": tr.model}
    g = torch.Generator(device="cuda").manual_seed(11)
    sds = {group: {reference_key(group, n): torch.randn(p.shape, generator=g, device="cuda") * 0.02
                   for n, p in net.named_parameters()} for group, net in nets.items()}
    t0 = time.perf_counter()
    pp.load_ported(ae, pp.port_autoencoder(cfg.ae, sds))
    pp.load_ported(tr.model, pp.port_gpt(cfg.gpt, sds["transformer_t"]))
    t_load = common.synced(CARD) - t0
    n = 0
    for group, net in nets.items():
        for name, p in net.named_parameters():
            src = sds[group][reference_key(group, name)]
            if not torch.equal(p.detach(), src.to(p.dtype)):
                raise AssertionError(f"reference checkpoint: {group} {reference_key(group, name)}"
                                     f" -> {name} is not its source")
            n += p.numel()
    log(f"reference checkpoint: {sum(len(sd) for sd in sds.values())} tensors ({n / 1e6:.1f} M "
        f"values) of {list(sds)} loaded through port_pytorch in {t_load:.2f} s, each equal to "
        "its source in the module's dtype")
    del sds
    gen = VideoGenerator(cfg, ae, tr)
    vid = clip(cfg, MODE_LEN)
    # the warm-up: 2 frames (64 decode steps), every shape of the rollout's calls
    t0 = time.perf_counter()
    gen.generate(vid[:, :2], torch.Generator(device="cuda").manual_seed(3), rec=False,
                 n_ctx_frames=1)
    log(f"reference checkpoint warm-up rollout (2 frames): {common.synced(CARD) - t0:.3f} s")
    steps = (MODE_LEN - 1) * cfg.gpt.size
    _, dt = run_path(records, card, cfg, gen, vid, 1, 2, steps)
    if "bairhd" in ROLLOUT_S:
        ref = ROLLOUT_S["bairhd"] / ((VID_LEN - 1) * cfg.gpt.size)
        log(f"reference checkpoint rollout: {dt / steps / ref:.3f}x phase 3's time a decode "
            f"step ({1e3 * ref:.2f} ms, emb_mode temporal, seeded init) in this run")


def phase_train_emb_none(records, card):
    """(c) The full-width BAIR-256 transformer step with ``emb_mode`` None (one
    ``pos_emb`` over 16 frames), 16 clips of 16 frames: 1 warm-up and 3
    timed steps, K1 once a step."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.train.ae_trainer import to_device
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    base = bairhd_config()
    cfg = base.replace(name="train_bairhd_emb_none",
                       data=dataclasses.replace(base.data, dataset="synthetic"),
                       gpt=dataclasses.replace(base.gpt, emb_mode=None))
    torch.cuda.empty_cache()
    batch = to_device(_train_data(cfg, "train", 1)[0], "cuda")
    tr = TransformerTrainer(cfg, FrameAutoencoder(cfg.ae, dtype=torch.bfloat16).init(seed=0))
    tr.transformer.init(seed=1)
    randomize_pos_emb(tr.transformer.model, 10, std=0.02)
    state = tr.init_state()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(4):
        if i == 1:
            profiling.reset()
            t0 = time.perf_counter()
        state, m = tr.step(state, tr.encode_batch(batch))
        losses.append(float(m["nll"]))
    dt = common.synced(CARD) - t0
    launches = kernel_launches("k1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train emb_mode None: K1 {launches} launches in 3 steps (expected "
                             f"3), losses {losses}")
    records["vq_argmin"]["launches_by_rollout"]["train_bairhd_emb_none (3 steps)"] = launches
    log(f"train emb_mode None: {dt / 3:.4f} s a step over 3 steps (16 x 1023 input tokens), "
        f"peak memory {peak:.2f} GiB, K1 {launches} launches, nll by step "
        f"{[round(x, 4) for x in losses]}; on {card}")


def phase_continuous_bairhd(records, card):
    """(d) ``ContinuousTransformer`` at the BAIR trunk's width (24 x 16 x
    1024, ``z_len`` 1024, 512-d inputs, 4 proposals): the loss, its
    backward and AdamW on 16 sequences of 1024 unit vectors (fp32
    parameters, bf16 compute), 1 warm-up and 3 timed steps; then the bf16
    rollout of 2 sequences from 64 vectors to 1024 with ``normalize_pred``:
    one prefill and 959 decode steps, K2 in each layer of each."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.models import ContinuousTransformer
    from ccvs_tpu_torch.train.states import make_transformer_optimizer

    cfg = dataclasses.replace(bairhd_config().gpt, n_in=512, n_proposals=4, z_len=1024)
    torch.cuda.empty_cache()
    ct = ContinuousTransformer(cfg, dtype=torch.bfloat16, param_dtype=torch.float32).init(seed=12)
    randomize_pos_emb(ct.model, 13, std=0.02)
    opt = make_transformer_optimizer(cfg, 100, ct.model)
    g = torch.Generator(device="cuda").manual_seed(14)
    code = F.normalize(torch.randn(16, cfg.z_len, cfg.n_in, generator=g, device="cuda"), dim=-1)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(4):
        if i == 1:
            t0 = time.perf_counter()
        ct.model.zero_grad(set_to_none=True)
        loss, _ = ct.loss(code)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    dt = common.synced(CARD) - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"continuous bairhd: losses {losses}")
    n_params = sum(p.numel() for p in ct.parameters())
    log(f"continuous bairhd: {n_params / 1e6:.1f} M parameters; loss + backward + AdamW "
        f"{dt / 3:.4f} s a step over 3 steps (16 x 1023 inputs), peak memory {peak:.2f} GiB, "
        f"best-proposal MSE by step {[round(x, 5) for x in losses]}; on {card}")
    serve = ContinuousTransformer(cfg, dtype=torch.bfloat16)
    serve.load_state_dict(ct.state_dict())
    del ct, opt
    n0, steps = 64, cfg.z_len - 64 - 1
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.generate(code[:2, :n0], cfg.z_len, normalize_pred=True)
    dt = common.synced(CARD) - t0
    launches = kernel_launches("k2")
    if launches != cfg.n_layer * steps or kernel_launches("k1"):
        raise AssertionError(f"continuous bairhd: K2 {launches} launches (expected "
                             f"{cfg.n_layer} x {steps}), K1 {kernel_launches('k1')}")
    norms = out[:, n0:].norm(dim=-1)
    if not (out.shape == (2, cfg.z_len, cfg.n_in) and bool(torch.isfinite(out).all())
            and torch.equal(out[:, :n0], code[:2, :n0])
            and float((norms - 1).abs().max()) <= 1e-2):
        raise AssertionError(f"continuous bairhd: rollout {tuple(out.shape)}, norms "
                             f"{float(norms.min())}-{float(norms.max())}")
    records["flash_decode"]["launches_by_rollout"]["continuous_bairhd"] = launches
    log(f"continuous bairhd rollout: {dt:.3f} s for {cfg.z_len - n0} vectors (batch 2, 1 prefill"
        f" + {steps} decode steps: {1e3 * dt / steps:.2f} ms a step, all in), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K2 {launches} launches; norms "
        f"{float(norms.min()):.4f}-{float(norms.max()):.4f} (bf16); on {card}")


def phase_z_mult_ae(records, card):
    """(e) The autoencoder with ``z_mult`` 2 and ``normalize_out`` at full
    BAIR-256 width (fp32 parameters; bf16 compute in training).

    First the preset's image batch (8 groups of [corrupted context, next
    frame, distorted view], drawn after ``random.seed(cfg.seed)``) through
    the trainer's encoder in fp32, on the card and on the CPU from the same
    weights. The latents before the division must agree within 1e-4 of
    the largest. On each device a latent may be NaN only where its latent
    before the division is exactly 0: the corruption zero-fills regions,
    the seeded init's biases are 0, and ``normalize_out`` divides a zero
    latent by its zero norm, as the JAX package does (ROADMAP queue 3).
    Whether such a latent stays exactly 0 depends on the convolution
    algorithm: where one device's is 0 the other's may be rounding-sized,
    and then one side is NaN and the other a unit vector that rounding
    points; the first check bounds the other side's latent there. Where
    neither is 0, each normalized latent must be within ``2 |a - b| / |b|
    + 1e-5`` of the CPU's, the bound of ``a / |a|`` against ``b / |b|``
    (a latent of norm 2e-8 is a direction rounding sets).

    Then an extra check on 24 plain images (no elastic view, corruption or
    flow recovery): K1 on their latents, (3072, 256) x (1024, 256), gives
    the plain search's indices, and one image G step launches K1 once with
    finite metrics. It runs on plain images because on the preset's batch
    the step's ``quant_img`` is NaN wherever a latent is, in both
    packages."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.nn.encoder import SkipEncoder
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device

    base = bairhd_config()
    ae_cfg = dataclasses.replace(base.ae, z_mult=2, normalize_out=True)
    data = dataclasses.replace(base.data, dataset="synthetic", batch_size_img=24,
                               batch_size_vid=4)
    preset = base.replace(name="train_ae_z_mult", ae=ae_cfg, data=data)
    cfg = preset.replace(
        ae=dataclasses.replace(ae_cfg, load_elastic_view=False, elastic_corruption=False,
                               use_elastic_flow_recovery=False),
        data=dataclasses.replace(data, load_elastic_view=False, elastic_corruption=False))
    torch.cuda.empty_cache()
    tr = FrameAutoencoderTrainer(cfg)
    tr.init_params()
    state = tr.init_state()
    ae = tr.losses.ae

    random.seed(preset.seed)
    (bi, _), = _ae_batches(preset, 1, kinds=("img",))
    out = {}
    for dev in ("cuda", "cpu"):
        enc = SkipEncoder(ae_cfg, dtype=torch.float32).to(dev)
        enc.load_state_dict(ae.encoder.state_dict())
        raw = {}
        enc.get_submodule(f"block{ae_cfg.num_resolutions}").register_forward_hook(
            lambda m, i, o: raw.update(z=o))
        with torch.no_grad():
            z, _ = enc(to_device(bi, dev)["img"].float())
        out[dev] = (z.double().cpu(), raw["z"].double().cpu())
    (zg, rg), (zc, rc) = out["cuda"], out["cpu"]
    nan_g, nan_c = torch.isnan(zg).any(-1), torch.isnan(zc).any(-1)
    norm_g, norm_c = rg.norm(dim=-1), rc.norm(dim=-1)
    zero_g, zero_c = norm_g == 0, norm_c == 0
    raw_err = float((rg - rc).abs().max() / rc.abs().max())
    ok = ~(zero_g | zero_c)
    ratio = float(((zg - zc).norm(dim=-1)[ok]
                   / (2 * (rg - rc).norm(dim=-1)[ok] / norm_c[ok] + 1e-5)).max())
    across = torch.cat([norm_g[zero_c & ~zero_g], norm_c[zero_g & ~zero_c]])
    log(f"z_mult ae: the preset's image batch (elastic corruption, {tuple(zc.shape)}) in fp32, "
        f"card against CPU: NaN latents at {int(nan_g.sum())} (card) / {int(nan_c.sum())} (CPU) "
        f"of {nan_c.numel()} positions, latents of norm 0 before the division "
        f"{int(zero_g.sum())} / {int(zero_c.sum())}; where one side's is 0 the other's norm is "
        f"{[float(f'{v:.3g}') for v in across.tolist()]} (largest norm "
        f"{float(norm_c.max()):.3g}); latents before the division within {raw_err:.3g} of the "
        f"largest entry (bound 1e-4), normalized ones at {ratio:.3g} of their bound; smallest "
        f"nonzero norm {float(norm_c[~zero_c].min()):.3g}")
    if not (torch.equal(nan_g, zero_g) and torch.equal(nan_c, zero_c)):
        raise AssertionError("z_mult ae: a NaN latent that is not 0 / 0")
    if not (raw_err < 1e-4 and ratio <= 1):
        raise AssertionError(f"z_mult ae: card against CPU {raw_err} (bound 1e-4), normalized "
                             f"{ratio} of its bound")

    (bi, _), = _ae_batches(cfg, 1, kinds=("img",))
    img = to_device(bi, "cuda")
    with torch.no_grad():
        z, _ = ae.encoder(img["img"].to(ae.dtype))
    zf = z.float().reshape(-1, cfg.ae.z_size // 2)
    norms = z.float().norm(dim=-1)
    ties, gap = check_vq(zf, ae.quantizer.embedding.detach())
    log(f"z_mult ae: K1 at {tuple(zf.shape)} x {tuple(ae.quantizer.embedding.shape)} on the "
        f"latents of {img['img'].shape[0]} plain images: indices the plain search's but {ties} "
        f"near-ties (max distance gap {gap:.3g}); latent norms {float(norms.min()):.4f}-"
        f"{float(norms.max()):.4f}")
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("z_mult ae: non-finite latents")
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m, _, _, _ = _ae_step(tr, state, "g", "img", img, None)
    dt = common.synced(CARD) - t0
    bad = [k for k, v in m.items() if not math.isfinite(float(v))]
    if kernel_launches("k1") != 1 or bad:
        raise AssertionError(f"z_mult ae: K1 {kernel_launches('k1')} launches (expected 1), "
                             f"non-finite {bad}")
    records["vq_argmin"]["launches_by_rollout"]["train_ae_z_mult (1 image G step)"] = 1
    log(f"z_mult ae: the image G step {dt:.4f} s (first call), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, quant_img "
        f"{float(m['quant_img']):.5f}, rec_img {float(m['rec_img']):.5f}; on {card}")


def phase_gpt_variants(records, card):
    variants_reference()
    phase_reference_checkpoint(records, card)
    phase_train_emb_none(records, card)
    phase_continuous_bairhd(records, card)
    phase_z_mult_ae(records, card)


# ---------------- phase 15: the autoencoder's options ----------------


# the decoder's option sets held card against CPU in (a), as
# tests/test_torch_ae_options.py holds them against the JAX package
AE_OPTION_SETS = {
    "deform": dict(use_deformed_conv=True),
    "masked": dict(use_masked_flow=True),
    "tradeoff": dict(use_tradeoff=True),
    "deform_masked_tradeoff": dict(use_deformed_conv=True, use_masked_flow=True,
                                   use_tradeoff=True),
    "no_corr": dict(no_corr=True),
    "no_proj": dict(no_proj=True),
    "skip_rgb_tanh": dict(skip_rgb=True, skip_tanh=True),
    "no_inter": dict(use_inter=False),
    "tiled_x": dict(shared_x_split=False),
}
# (b) and (c)'s full-width option sets
SET_A = dict(use_deformed_conv=True, use_masked_flow=True, use_tradeoff=True, skip_rgb=True,
             skip_tanh=True)
SET_B = dict(no_corr=True, skip_mode="dec", keep_first=True, n_first=2, shared_x_split=False)
OPTIONS_TOL = 1e-5  # (a): card against CPU, of each output's largest entry
OPTIONS_BATCH = (24, 4)  # images and clips of (b)'s iteration and (d)'s steps: phase 11 (b)'s


def options_small_config(**over):
    """(a)'s decoder configuration: four resolutions at 32 px (the finest
    runs the stride-2 correlation), every context width a multiple of 32
    (``inter_p`` 1.0, multipliers (1, 1, 2, 2)), a 3-slot FIFO."""
    from ccvs_tpu_torch.config import AutoencoderConfig

    return AutoencoderConfig(necf=32, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64,
                             z_shape=(4, 4), max_dim=32, inter_p=1.0, skip_memory=3,
                             skip_context=(1, 2, 3), **over)


def smooth_features(g, batch, h, w, c):
    """``(B, h, w, c)`` random plane waves of 0.5-2 periods a frame,
    amplitude 0.5, drawn on the CPU from ``g``: spatially smooth, as an
    encoder's features are (on white noise one fp32 rounding of a flow moves
    the decoded frame by ~1e-5 of its largest entry on any device)."""
    import torch

    yy = torch.linspace(0, 1, h)[:, None, None]
    xx = torch.linspace(0, 1, w)[None, :, None]
    fy, fx = (torch.rand(batch, 1, 1, c, generator=g) * 1.5 + 0.5 for _ in range(2))
    phase = torch.rand(batch, 1, 1, c, generator=g) * 2 * math.pi
    return 0.5 * torch.sin(2 * math.pi * (fy * yy + fx * xx) + phase)


def _worst_rel(got, want):
    """The largest error over matching tensors, each relative to its CPU
    tensor's largest entry."""
    pairs = [(got, want)] if not isinstance(want, (list, tuple)) else zip(got, want)
    out = 0.0
    for g, w in pairs:
        if isinstance(w, (list, tuple)):
            out = max(out, _worst_rel(g, w))
        elif w is not None:
            out = max(out, _rel_err(g, w))
    return out


def _swapped_taps(x, flow, weight, bias=None):
    """A planted fault: ``deform_conv3x3`` with its ky and kx taps swapped."""
    from ccvs_tpu_torch.ops.deform import deform_conv3x3

    return deform_conv3x3(x, flow, weight.transpose(2, 3), bias)


def _decoder_pair_error(cpu, gpu, inputs, plant=False):
    """The card's decoder outputs against the CPU's (:func:`_worst_rel`);
    with ``plant``, the card's decoder runs :func:`_swapped_taps`."""
    import torch
    import ccvs_tpu_torch.nn.decoder as decoder_mod

    z, ctx, mask = inputs
    with torch.no_grad():
        want = cpu(z, ctx, ctx_mask=mask, return_all=True, inter_pre_warping=False)
        kept = decoder_mod.deform_conv3x3
        if plant:
            decoder_mod.deform_conv3x3 = _swapped_taps
        try:
            got = gpu(z.to("cuda"), [c.to("cuda") for c in ctx], ctx_mask=mask.to("cuda"),
                      return_all=True, inter_pre_warping=False)
        finally:
            decoder_mod.deform_conv3x3 = kept
    return _worst_rel(got, want)


def options_reference():
    """(a) Small fp32 configurations (:func:`options_small_config`) on the
    card against the CPU from the same weights, each output within
    ``OPTIONS_TOL`` of its largest entry: ``SkipDecoder`` under each option
    set of ``AE_OPTION_SETS`` (k = 3 smooth contexts, a partial
    ``ctx_mask``; the frame, every resolution's flows and occlusion logits,
    the fused features); ``deform_conv3x3``'s value and its input and offset
    gradients; ``decode_video`` of 7 frames from 1 with ``keep_first``
    (``n_first`` 2: the FIFO full and pinned for the last three frames) and
    with ``skip_mode`` "dec". A planted fault (``deform_conv3x3``'s ky and
    kx taps swapped in the card's decoder) must fail the check. Then the
    image G step with set A's options (phase 11 (a)'s 16 px autoencoder at
    widths of 64 and 32) held to the CPU step by step for 2 iterations, as
    phase 11 (a) holds it."""
    import copy

    import torch
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.nn.decoder import SkipDecoder
    from ccvs_tpu_torch.nn.layers import init_equalized
    from ccvs_tpu_torch.ops.deform import deform_conv3x3

    f32 = torch.float32
    g = torch.Generator().manual_seed(15)
    mask = torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 0.0]])
    errs = {}
    for name, over in AE_OPTION_SETS.items():
        cfg = options_small_config(**over)
        cpu = init_equalized(SkipDecoder(cfg), g)
        gpu = copy.deepcopy(cpu).to("cuda")
        ctx = [torch.stack([smooth_features(g, 2, 32 >> r, 32 >> r, c) for _ in range(3)], 1)
               for r, c in enumerate(cfg.inter_sizes_enc)]
        inputs = (torch.randn(2, 4, 4, 16, generator=g), ctx, mask)
        errs[name] = _decoder_pair_error(cpu, gpu, inputs)
        if name == "deform":
            planted = _decoder_pair_error(cpu, gpu, inputs, plant=True)
    log("options ae: SkipDecoder card vs CPU, of each output's largest entry: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tolerance {OPTIONS_TOL})")
    log(f"options ae: planted fault (deform_conv3x3's ky and kx taps swapped on the card) "
        f"{planted:.3g} of the largest entry: caught {planted > OPTIONS_TOL}")
    if max(errs.values()) > OPTIONS_TOL or not planted > OPTIONS_TOL:
        raise AssertionError(f"options ae: decoder card vs CPU {errs}, planted fault {planted}")

    x = torch.randn(2, 16, 24, 32, generator=g)
    flow = torch.randn(2, 16, 24, 2, generator=g) * 1.5
    w = torch.randn(32, 32, 3, 3, generator=g) * (2 / (32 * 9)) ** 0.5
    b = torch.randn(32, generator=g)
    cot = torch.randn(2, 16, 24, 32, generator=g)
    res = {}
    for dev in ("cuda", "cpu"):
        args = [t.to(dev).requires_grad_() for t in (x, flow, w, b)]
        out = deform_conv3x3(*args)
        res[dev] = [out, *torch.autograd.grad((out * cot.to(dev)).sum(), args[:2])]
    derr = [_rel_err(a, c) for a, c in zip(res["cuda"], res["cpu"])]
    log(f"options ae: deform_conv3x3 (2, 16, 24, 32), offsets N(0, 1.5^2) px, card vs CPU: "
        f"value {derr[0]:.3g}, input gradient {derr[1]:.3g}, offset gradient {derr[2]:.3g} "
        f"of their largest entries (tolerance {OPTIONS_TOL})")
    if max(derr) > OPTIONS_TOL:
        raise AssertionError(f"options ae: deform_conv3x3 card vs CPU {derr}")

    codes = torch.randint(0, 64, (2, 7, 16), generator=g)
    frames = torch.rand(2, 1, 32, 32, 3, generator=g) * 2 - 1
    for name, over in (("keep_first n_first 2", dict(keep_first=True, n_first=2)),
                       ('skip_mode "dec"', dict(skip_mode="dec"))):
        cfg = options_small_config(**over)
        cpu = FrameAutoencoder(cfg, dtype=f32, device="cpu").init(seed=3)
        gpu = _pair(lambda d: FrameAutoencoder(cfg, dtype=f32, device=d), cpu, "cuda")
        err = _rel_err(gpu.decode_video(codes.to("cuda"), frames.to("cuda"), n_ctx=1),
                       cpu.decode_video(codes, frames, n_ctx=1))
        log(f"options ae: decode_video with {name}, 7 frames from 1, card vs CPU {err:.3g} of "
            f"the largest entry (tolerance {OPTIONS_TOL})")
        if err > OPTIONS_TOL:
            raise AssertionError(f"options ae: decode_video with {name}: {err}")

    phase_ae_reference(cfg=small_ae_config(necf=32, inter_p=1.0, **SET_A),
                       label="options ae image G step (set A)", steps=[("g", "img")], iters=2)


def _options_config(name, **over):
    import dataclasses

    from ccvs_tpu_torch.config import bairhd_config

    base = bairhd_config()
    return base.replace(name=name, ae=dataclasses.replace(base.ae, **over))


def _options_rollout(records, card, cfg):
    """A 2-frame warm-up and one ``MODE_LEN`` (4) frame rollout of ``cfg``
    (bf16, batch 2, 1 context frame; K1 2, K2 24 a decode step), then the
    decode stage of its tokens alone; returns the models, the clip, the
    tokens and the decode stage's seconds."""
    import torch

    torch.cuda.empty_cache()
    ae, tr, gen = build_models(cfg)
    vid = clip(cfg, MODE_LEN)
    t0 = time.perf_counter()
    gen.generate(vid[:, :2], torch.Generator(device="cuda").manual_seed(3), rec=False,
                 n_ctx_frames=1)
    warm = common.synced(CARD) - t0
    steps = (MODE_LEN - 1) * cfg.gpt.size
    out, dt = run_path(records, card, cfg, gen, vid, 1, 2, steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    code = out["code"].reshape(BATCH, MODE_LEN, -1)
    t0 = time.perf_counter()
    ae.decode_video(code, ctx_frames=vid[:, :1], n_ctx=1)
    t_dec = common.synced(CARD) - t0
    ref = ""
    if "bairhd" in ROLLOUT_S:
        ref = (f"; {dt / steps / (ROLLOUT_S['bairhd'] / ((VID_LEN - 1) * cfg.gpt.size)):.3f}x "
               f"phase 3's time a decode step")
    log(f"{cfg.name}: 2-frame warm-up {warm:.3f} s; the rollout {dt:.3f} s, "
        f"{1e3 * dt / steps:.2f} ms a decode step{ref}; its decode stage alone (7 frames) "
        f"{t_dec:.3f} s = {1e3 * t_dec / (MODE_LEN - 1):.1f} ms a frame; peak memory "
        f"{peak:.2f} GiB; on {card}")
    return ae, vid, code, t_dec


def _options_iteration(cfg, card):
    """Phase 11 (b)'s batch (24 images, 4 clips of 4 frames) through one
    warm-up iteration and one with R1 of ``cfg``'s trainer, each step timed
    with CUDA events; K1 exactly 2 launches an iteration."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device

    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset="synthetic",
                                               batch_size_img=OPTIONS_BATCH[0],
                                               batch_size_vid=OPTIONS_BATCH[1]))
    torch.cuda.empty_cache()
    (bi, bv), = _ae_batches(cfg, 1)
    tr = FrameAutoencoderTrainer(cfg)
    tr.init_params()
    state = tr.init_state()
    img, vid = to_device(bi, "cuda"), to_device(bv, "cuda")
    torch.cuda.reset_peak_memory_stats()
    for it in (1, 16):  # R1 runs at it % 16 == 0
        profiling.reset()
        spans, fake, ms = common.Spans(True), {}, {}
        w0 = time.perf_counter()
        for kind, mode in AE_STEPS:
            if kind == "r1" and it % cfg.ae.d_reg_every:
                continue
            with spans.span(f"{kind} {mode}"):
                state, m, fake[mode], _, _ = _ae_step(tr, state, kind, mode,
                                                      img if mode == "img" else vid,
                                                      fake.get(mode))
            ms.update(m)
        wall = common.synced(CARD) - w0
        if kernel_launches("k1") != 2:
            raise AssertionError(f"{cfg.name} AE iteration: K1 launched {kernel_launches('k1')} "
                                 "times (expected 2)")
    bad = [k for k, v in ms.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"{cfg.name} AE iteration: non-finite {bad}")
    log(f"{cfg.name} AE iteration with R1 ({img['img'].shape[0]} images, "
        f"{vid['vid'].shape[0]} clips of {vid['vid'].shape[1]} frames, after one warm-up "
        f"iteration): {wall:.4f} s (host clock, synchronized); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 2 launches; by step (CUDA "
        "events): " + ", ".join(f"{n} {t[0]:.2f} ms" for n, t in spans.ms().items())
        + f"; on {card}")
    return 2


def options_set_a(records, card):
    """(b) Full-width BAIR-256 with set A (deformable conv, masked flow,
    tradeoff features, skip-RGB and ``tanh``) on seeded weights: the
    rollout (:func:`_options_rollout`), then an AE iteration with R1."""
    cfg = _options_config("bairhd_options_a", **SET_A)
    _, vid, code, t_dec = _options_rollout(records, card, cfg)
    records["vq_argmin"]["launches_by_rollout"]["bairhd_options_a AE iteration with R1"] = (
        _options_iteration(cfg, card))
    return vid, code, t_dec


def options_set_b(records, card, vid, code, t_dec_a):
    """(c) Full width with set B (no correlation, ``skip_mode`` "dec",
    ``keep_first`` with ``n_first`` 2, the tiled-x convs): the rollout,
    whose decode stage re-encodes no frame; its decode stage a frame beside
    phase 3's, set A's and the preset's on (b)'s tokens; then a decode of
    17 frames from 1 (the 15-slot FIFO full and pinned for the last frame)
    with finite frames."""
    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.models import FrameAutoencoder

    cfg = _options_config("bairhd_options_b", **SET_B)
    ae, _, _, t_dec = _options_rollout(records, card, cfg)
    preset = FrameAutoencoder(bairhd_config().ae, dtype=torch.bfloat16).init(seed=0)
    t0 = time.perf_counter()
    preset.decode_video(code, ctx_frames=vid[:, :1], n_ctx=1)
    t_pre = common.synced(CARD) - t0
    del preset
    per = {"set B": t_dec, "set A": t_dec_a, "the preset on set A's tokens": t_pre}
    log("options ae: the decode stage a generated frame (7 frames, batch 2, host clock): "
        + ", ".join(f"{k} {1e3 * v / (MODE_LEN - 1):.1f} ms" for k, v in per.items())
        + (f", phase 3's warm-up {1e3 * DECODE_S['bairhd']:.1f} ms (15 frames)"
           if "bairhd" in DECODE_S else ""))
    n = 17
    g = torch.Generator(device="cuda").manual_seed(5)
    codes = torch.randint(0, cfg.ae.z_num, (BATCH, n, cfg.ae.tokens_per_frame), device="cuda",
                          generator=g)
    frames = clip(cfg, 1)
    t0 = time.perf_counter()
    out = ae.decode_video(codes, ctx_frames=frames, n_ctx=1)
    dt = common.synced(CARD) - t0
    if out.shape != (BATCH, n, *frames.shape[2:]) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bairhd_options_b: the 17-frame decode {tuple(out.shape)} is not "
                             "finite frames")
    log(f"bairhd_options_b: decode_video of {n} frames from 1 (the 15th push pins the FIFO's "
        f"first 2 slots, so the last frame decodes against the pinned FIFO) "
        f"{dt:.3f} s = {1e3 * dt / (n - 1):.1f} ms a frame; on {card}")


def options_aspect_ratio(records, card):
    """(d) Full width at ``aspect_ratio`` 2: 256 x 512 frames, ``z_shape``
    (8, 16), ``no_proj``, the preset's image batch (8 groups of [corrupted
    context, next frame, distorted view], synthetic at 256 x 512). K1 on the
    encoder's latents, (3072, 512) x (1024, 512), against the plain search;
    one image G step (K1 once) and one image D step, each timed (first
    calls, CUDA events), and the peak memory."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device

    base = bairhd_config()
    h, w = base.ae.z_shape
    cfg = base.replace(
        name="bairhd_aspect_2",
        ae=dataclasses.replace(base.ae, aspect_ratio=2.0, z_shape=(h, 2 * w), no_proj=True),
        data=dataclasses.replace(base.data, dataset="synthetic", aspect_ratio=2.0,
                                 batch_size_img=OPTIONS_BATCH[0]))
    torch.cuda.empty_cache()
    (bi, _), = _ae_batches(cfg, 1, kinds=("img",))
    tr = FrameAutoencoderTrainer(cfg)
    tr.init_params()
    state = tr.init_state()
    img = to_device(bi, "cuda")
    hw = (cfg.ae.max_dim, 2 * cfg.ae.max_dim)
    assert img["img"].shape == (OPTIONS_BATCH[0], *hw, 3), img["img"].shape
    ae = tr.losses.ae
    with torch.no_grad():
        z, _ = ae.encoder(img["img"].to(ae.dtype))
    zf = z.float().reshape(-1, cfg.ae.z_size)
    ties, gap = check_vq(zf, ae.quantizer.embedding.detach())
    log(f"bairhd_aspect_2: K1 at {tuple(zf.shape)} x {tuple(ae.quantizer.embedding.shape)} on "
        f"the latents of {OPTIONS_BATCH[0]} images of {hw[0]} x {hw[1]}: indices the plain "
        f"search's but {ties} near-ties (max distance gap {gap:.3g})")
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    spans = common.Spans(True)
    fake = None
    for kind in ("g", "d"):
        with spans.span(kind):
            state, m, fake, _, _ = _ae_step(tr, state, kind, "img", img, fake)
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"bairhd_aspect_2: image {kind.upper()} step non-finite {bad}")
    if kernel_launches("k1") != 1:
        raise AssertionError(f"bairhd_aspect_2: K1 launched {kernel_launches('k1')} times "
                             "(expected 1)")
    records["vq_argmin"]["launches_by_rollout"]["bairhd_aspect_2 (1 image G step)"] = 1
    times = {kind: t[0] for kind, t in spans.ms().items()}
    log(f"bairhd_aspect_2: the image G step {times['g']:.2f} ms, the image D step "
        f"{times['d']:.2f} ms (CUDA events, first calls); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; discriminator fc1 input "
        f"{tr.di.fc1.weight.shape[1]}; on {card}")


def phase_ae_options(records, card):
    random.seed(0)
    options_reference()
    vid, code, t_dec = options_set_a(records, card)
    options_set_b(records, card, vid, code, t_dec)
    options_aspect_ratio(records, card)


# ---------------- tracing a gradient difference to its kinks ----------------


class KinkTrace:
    """Records, in call order, the discrete decisions of a forward pass of
    the autoencoder's losses: the sign of each leaky ReLU's and ReLU's input,
    each max-pool's argmax, each bilinear sample's cell (the floor of its
    unnormalised coordinates) and each quantizer's code indices. With
    ``forced`` (another pass's record) the decisions of ``kinds`` are taken
    from it instead, and the pass computes the continuation of each function
    past the kink: the other branch of a ReLU, the value at the other
    argmax, the bilinear weights of the other cell (which then fall just
    outside [0, 1]), the other code."""

    KINDS = ("leaky_relu", "relu", "max_pool", "grid_sample", "vq")

    def __init__(self, forced=None, kinds=()):
        self.seen, self.sites, self.forced, self.kinds = [], [], forced, set(kinds)

    def _decide(self, kind, natural):
        i = len(self.seen)
        self.seen.append((kind, natural.detach().cpu()))
        # where the decision was taken: the innermost caller in the port
        frame = sys._getframe(2)
        while frame is not None and "ccvs_tpu_torch" not in frame.f_code.co_filename:
            frame = frame.f_back
        self.sites.append("?" if frame is None else
                          f"{os.path.relpath(frame.f_code.co_filename)}:{frame.f_lineno}")
        if self.forced is not None and kind in self.kinds:
            k, d = self.forced[i]
            assert k == kind and d.shape == natural.shape, (i, k, kind)
            return d.to(natural.device), True
        return natural, False

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        from ccvs_tpu_torch.nn import decoder, layers, quantizer
        from ccvs_tpu_torch.ops import fused_act

        orig = {"relu": torch.relu, "max_pool2d": F.max_pool2d, "grid_sample": F.grid_sample,
                "vq": quantizer.vq_lookup_auto}

        def leaky_relu(x, negative_slope=0.2):
            m, _ = self._decide("leaky_relu", x >= 0)
            return torch.where(m, x, x * negative_slope)

        def relu(x):
            m, forced = self._decide("relu", x > 0)
            return torch.where(m, x, torch.zeros_like(x)) if forced else orig["relu"](x)

        def max_pool2d(x, kernel_size, *args, **kw):
            out, idx = orig["max_pool2d"](x, kernel_size, *args, return_indices=True, **kw)
            idx, forced = self._decide("max_pool", idx)
            if not forced:
                return out
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        def grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=False):
            h, w = inp.shape[-2:]
            ix = ((grid[..., 0] + 1) * w - 1) / 2
            iy = ((grid[..., 1] + 1) * h - 1) / 2
            cell, forced = self._decide("grid_sample",
                                        torch.stack([ix.floor(), iy.floor()], -1).long())
            if not forced:
                return orig["grid_sample"](inp, grid, mode=mode, padding_mode=padding_mode,
                                           align_corners=align_corners)
            n, c = inp.shape[:2]
            x0, y0 = cell[..., 0], cell[..., 1]
            wx1, wy1 = ix - x0.to(ix.dtype), iy - y0.to(iy.dtype)
            out = 0
            for dx, wx in ((0, 1 - wx1), (1, wx1)):
                for dy, wy in ((0, 1 - wy1), (1, wy1)):
                    xs, ys = x0 + dx, y0 + dy
                    valid = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)).to(inp.dtype)
                    flat = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).flatten(1)
                    vals = inp.flatten(2).gather(2, flat[:, None].expand(n, c, -1))
                    out = out + vals.view(n, c, *x0.shape[1:]) * (wx * wy * valid)[:, None]
            return out

        def vq_lookup_auto(z, codebook):
            z_q, idx = orig["vq"](z, codebook)
            idx, forced = self._decide("vq", idx)
            if not forced:
                return z_q, idx
            return codebook.index_select(0, idx.flatten()).to(z.dtype).reshape(z.shape), idx

        self._saved = [(fused_act, "leaky_relu", fused_act.leaky_relu),
                       (layers, "leaky_relu", layers.leaky_relu),
                       (decoder, "leaky_relu", decoder.leaky_relu),
                       (torch, "relu", torch.relu), (F, "max_pool2d", F.max_pool2d),
                       (F, "grid_sample", F.grid_sample),
                       (quantizer, "vq_lookup_auto", quantizer.vq_lookup_auto)]
        for mod, name, fn in ((fused_act, "leaky_relu", leaky_relu),
                              (layers, "leaky_relu", leaky_relu),
                              (decoder, "leaky_relu", leaky_relu), (torch, "relu", relu),
                              (F, "max_pool2d", max_pool2d), (F, "grid_sample", grid_sample),
                              (quantizer, "vq_lookup_auto", vq_lookup_auto)):
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _g_vid_gradient(tr, state_sd, batch, device, trace, float64=False):
    """The video G step's loss gradient with respect to the autoencoder's
    parameters, from the train state ``state_sd``, under ``trace``. With
    ``float64`` every tensor, parameters included, is float64 (``.float()``
    returns float64 while it runs)."""
    import copy

    import torch

    state = tr.init_state()
    state.load_state_dict(copy.deepcopy(state_sd))
    if float64:
        for m in (state.gen, state.disc, tr.losses.vgg):
            m.double()
    b = {k: v.to(device) for k, v in batch.items()}
    if float64:
        b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
    params = dict(state.gen.named_parameters())
    to_float = torch.Tensor.float
    if float64:
        torch.Tensor.float = lambda self, *a, **kw: self.double()
    try:
        with trace:
            loss, _ = tr.losses.vid_generator_loss(b, None)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    finally:
        torch.Tensor.float = to_float
    return {n: (torch.zeros_like(p) if g is None else g).detach().double().cpu()
            for (n, p), g in zip(params.items(), grads)}


def trace_kink(seed=6, card="cuda"):
    """Phase 11 (a) at data seed ``seed`` (Python's ``random``, which draws
    the synthetic clips' augmentation), then its worst video G step's worst
    gradient entry traced: the step repeated from the card's saved inputs
    (its train state before the step and its batch) on the card and on the
    CPU in fp32, each pass's decisions recorded (:class:`KinkTrace`), and the
    entry recomputed on the CPU in float64 with every decision free, forced
    to the card's, forced to the CPU's, and forced to the CPU's but for one
    kind of kink at a time. The card and the CPU fall on opposite sides of
    kinks where their decisions differ; those kinks explain the difference
    when float64 with the card's decisions gives the card's value and with
    the CPU's the CPU's. Prints the result as one JSON line, ``trace: {...}``."""
    import torch
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer

    random.seed(seed)
    snaps, worst = {}, {"err": -1.0}

    def on_step(when, it, kind, mode, a, b):
        if (kind, mode) != ("g", "vid"):
            return
        if when == "before":
            snaps[it] = (_to_cpu(a.state_dict()), _to_cpu(b))
            return
        err, name = b["grad_err"]
        if err > worst["err"]:
            diff = (a["ggrad"][name].detach().double().cpu()
                    - a["cgrad"][name].detach().double().cpu()).abs()
            index = int(diff.argmax())
            worst.update(err=err, name=name, it=it, index=index, snap=snaps[it],
                         phase=[float(a[k][name].flatten()[index]) for k in ("ggrad", "cgrad")])

    try:
        phase_ae_reference(on_step)
        log(f"trace: phase 11 (a) passes at data seed {seed}")
    except AssertionError as e:
        log(f"trace: phase 11 (a) at data seed {seed} fails: {e}")
    name, index, (state_sd, batch) = worst["name"], worst["index"], worst["snap"]
    cfg = small_ae_config()
    trainers = {dev: FrameAutoencoderTrainer(cfg, dtype=torch.float32, device=dev)
                for dev in (card, "cpu")}
    tr64 = FrameAutoencoderTrainer(cfg, dtype=torch.float64, device="cpu")
    # the seeded VGG is drawn on each device's generator: all take the CPU's,
    # as phase 11 (a) does (the train state does not hold it)
    for tr in (trainers[card], tr64):
        tr.losses.vgg.load_state_dict(trainers["cpu"].losses.vgg.state_dict())
    runs = {}
    for dev, tr in trainers.items():
        trace = KinkTrace()
        runs[dev] = (_g_vid_gradient(tr, state_sd, batch, dev, trace), trace.seen)
    rec = {dev: runs[dev][1] for dev in runs}
    scale = float(max(g.abs().max() for g in runs["cpu"][0].values()))

    def entry(grads):
        return float(grads[name].flatten()[index])

    g_card, g_cpu = entry(runs[card][0]), entry(runs["cpu"][0])
    flips, _ = decisions_differing(rec[card], rec["cpu"])
    f64 = forced_float64(tr64, state_sd, batch, entry, {"card": rec[card], "cpu": rec["cpu"]})
    # one kind at a time from the card, the rest from the CPU
    by_kind = forced_by_kind(tr64, state_sd, batch, entry, rec[card], rec["cpu"], flips)
    gap = abs(g_card - g_cpu)
    kink = (gap > 0 and abs(f64["card"] - g_card) <= 0.1 * gap
            and abs(f64["cpu"] - g_cpu) <= 0.1 * gap)
    out = {"seed": seed, "iteration": worst["it"], "parameter": name, "index": index,
           "card_in_phase": worst["phase"][0], "cpu_in_phase": worst["phase"][1],
           "card": g_card, "cpu": g_cpu, "step_largest": scale, "gap_over_largest": gap / scale,
           "float64_free": f64["free"], "float64_card_decisions": f64["card"],
           "float64_cpu_decisions": f64["cpu"],
           "float64_card_decisions_of_one_kind": by_kind,
           "decisions_differing": {k: v for k, v in flips.items()},
           "explained_by_kinks": kink}
    log("trace: " + json.dumps(out))
    return out


def decisions_differing(rec_a, rec_b, sites=None):
    """Per kind of :class:`KinkTrace` decision, ``[differing, total]`` between
    two records of the same pass; and with ``sites`` (the calls' places), per
    kind the first call whose decisions differ: its index, place and the
    number differing there."""
    flips, first = {k: [0, 0] for k in KinkTrace.KINDS}, {}
    for i, ((k, a), (_, b)) in enumerate(zip(rec_a, rec_b)):
        d = (a != b).reshape(a.shape[0], -1) if k != "grid_sample" else (a != b).any(-1)
        flips[k][0] += int(d.sum())
        flips[k][1] += d.numel()
        if sites is not None and int(d.sum()) and k not in first:
            first[k] = {"call": i, "at": sites[i], "differing": int(d.sum())}
    return flips, first


def forced_float64(tr64, state_sd, batch, entry, records):
    """``entry`` of the float64 gradient from ``state_sd`` with every
    decision free, and with all decisions forced to each of ``records``
    (label -> record)."""
    out = {"free": entry(_g_vid_gradient(tr64, state_sd, batch, "cpu", KinkTrace(),
                                         float64=True))}
    for label, rec in records.items():
        out[label] = entry(_g_vid_gradient(tr64, state_sd, batch, "cpu",
                                           KinkTrace(rec, KinkTrace.KINDS), float64=True))
    return out


def forced_by_kind(tr64, state_sd, batch, entry, rec_one, rec_rest, flips):
    """``entry`` of the float64 gradient with ``rec_one``'s decisions of one
    kind and ``rec_rest``'s of the others, for each kind where they differ."""
    by_kind = {}
    for k in KinkTrace.KINDS:
        if flips[k][0]:
            mixed = [(kk, a if kk == k else b) for (kk, a), (_, b) in zip(rec_one, rec_rest)]
            by_kind[k] = entry(_g_vid_gradient(tr64, state_sd, batch, "cpu",
                                               KinkTrace(mixed, KinkTrace.KINDS), float64=True))
    return by_kind


FP32_FLAGS = ("torch.backends.fp32_precision", "torch.backends.cudnn.fp32_precision",
              "torch.backends.cudnn.conv.fp32_precision",
              "torch.backends.cuda.matmul.fp32_precision", "torch.backends.cudnn.allow_tf32",
              "torch.backends.cuda.matmul.allow_tf32", "torch.backends.cudnn.deterministic",
              "torch.backends.cudnn.benchmark")


def fp32_flags():
    """PyTorch's fp32 precision settings, by name (None where this PyTorch
    has no such attribute)."""
    import functools

    import torch

    out = {}
    for name in FP32_FLAGS:
        try:
            out[name] = functools.reduce(getattr, name.split(".")[1:], torch)
        except AttributeError:
            out[name] = None
    return out


def fp32_setting(name):
    """Applies one of the fp32 settings fault 4's trace compares: ``port``
    (what ``resolve_device`` sets), ``ieee`` (cuDNN's convolutions and the
    matrix products asked for IEEE fp32 by the per-operation precision
    settings), ``deterministic`` (``port`` with cuDNN restricted to
    deterministic algorithms, no benchmarking), ``nocudnn`` (``port`` with
    cuDNN off: PyTorch's own CUDA convolutions)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = name == "deterministic"
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled = name != "nocudnn"
    if name == "ieee":
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"


def conv_precision_probe():
    """One fp32 convolution, its input and weight gradients and one fp32
    matrix product on the card under each of :func:`fp32_setting`'s
    settings, against float64 on the CPU: the largest error over the
    largest entry. TF32 keeps 10 mantissa bits (~5e-4 a rounding), IEEE
    fp32 23."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 32, 32, generator=g)
    w = torch.randn(64, 64, 3, 3, generator=g)
    dy = torch.randn(8, 64, 32, 32, generator=g)
    a, b = torch.randn(512, 512, generator=g), torch.randn(512, 512, generator=g)

    def run(dev, dtype):
        xx = x.to(dev, dtype).requires_grad_()
        ww = w.to(dev, dtype).requires_grad_()
        y = F.conv2d(xx, ww, padding=1)
        gx, gw = torch.autograd.grad(y, (xx, ww), dy.to(dev, dtype))
        return [t.detach().double().cpu() for t in (y, gx, gw, a.to(dev, dtype) @ b.to(dev, dtype))]

    log(f"fault4 probe: torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
        f"{torch.backends.cudnn.version()}, {card_line()}")
    ref = run("cpu", torch.float64)

    def errs(got):
        return [float((u - r).abs().max() / r.abs().max()) for u, r in zip(got, ref)]

    out = {"cpu": errs(run("cpu", torch.float32))}
    for name in ("port", "ieee", "deterministic", "nocudnn"):
        fp32_setting(name)
        out[name] = errs(run("cuda", torch.float32))
        out[name + " flags"] = fp32_flags()
    fp32_setting("port")
    for k, v in out.items():
        if not k.endswith("flags"):
            log(f"fault4 probe {k}: conv {v[0]:.3g}, its input gradient {v[1]:.3g}, its weight "
                f"gradient {v[2]:.3g}, matmul {v[3]:.3g} (largest error over largest entry "
                "against float64)")
        else:
            log(f"fault4 probe {k}: {v}")
    return out


def trace_ops(seed=6, setting="port", card="cuda"):
    """Fault 4's trace, operation by operation: phase 11 (a) at data seed
    ``seed`` records the card's state and batch before iteration 0's video G
    step; that step's loss and gradient are then run once more on the card
    under ``setting`` (:func:`fp32_setting`), recording every PyTorch
    operation's inputs and outputs (a ``TorchDispatchMode``); each operation
    is replayed on the CPU from the card's inputs in fp32 and in float64.
    Per operation, the card's and the CPU's largest error over the largest
    entry of the float64 result; printed: the operations in order of the
    card's error, and the first whose card error exceeds 1e-5 and 20 times
    the CPU's."""
    import collections

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer

    random.seed(seed)
    snap = {}

    def on_step(when, it, kind, mode, a, b):
        if when == "before" and (it, kind, mode) == (0, "g", "vid"):
            snap["sd"], snap["batch"] = _to_cpu(a.state_dict()), _to_cpu(b)

    try:
        phase_ae_reference(on_step)
    except AssertionError as e:
        log(f"fault4 trace: phase 11 (a) at data seed {seed} fails: {str(e)[:300]}")
    cfg = small_ae_config()
    cpu = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    tr = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device=card)
    tr.losses.vgg.load_state_dict(cpu.losses.vgg.state_dict())
    fp32_setting(setting)
    state = tr.init_state()
    state.load_state_dict(snap["sd"])
    batch = {k: v.to(card) for k, v in snap["batch"].items()}
    records = []

    def host(t):
        return t.detach().cpu().clone() if torch.is_tensor(t) else t

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            before = (tree_map(host, args), tree_map(host, kwargs))
            out = func(*args, **kwargs)
            records.append((func, *before, tree_map(host, out)))
            return out

    params = list(state.gen.parameters())
    with Record():
        loss, _ = tr.losses.vid_generator_loss(batch, None)
        torch.autograd.grad(loss, params, allow_unused=True)
    fp32_setting("port")

    def floats(tree):
        return [t for t in (tree if isinstance(tree, (list, tuple)) else [tree])
                if torch.is_tensor(t) and t.is_floating_point()]

    def widen(t):
        return t.double() if torch.is_tensor(t) and t.dtype == torch.float32 else t

    # per operation: count, the card's and the CPU's largest error over the
    # largest entry, and over each entry's own size (floored at 1e-3 of the
    # largest entry)
    by_op = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
    first = first_entry = None
    for i, (func, args, kwargs, out) in enumerate(records):
        outs = floats(out)
        if not outs or not any(torch.is_tensor(t) and t.is_floating_point()
                               for t in torch.utils._pytree.tree_leaves((args, kwargs))):
            continue
        try:
            c32 = floats(func(*tree_map(host, args), **tree_map(host, kwargs)))
            c64 = floats(func(*tree_map(widen, args), **tree_map(widen, kwargs)))
        except (RuntimeError, TypeError, NotImplementedError):
            continue
        if len(c32) != len(outs) or len(c64) != len(outs):
            continue
        e_card = e_cpu = r_card = r_cpu = 0.0
        for o, a, r in zip(outs, c32, c64):
            if o.shape != r.shape or r.numel() == 0:
                continue
            a, r = a.cpu(), r.cpu()
            scale = float(r.abs().max()) or 1.0
            own = r.abs().clamp_min(1e-3 * scale)
            e_card = max(e_card, float((o.double() - r).abs().max()) / scale)
            e_cpu = max(e_cpu, float((a.double() - r).abs().max()) / scale)
            r_card = max(r_card, float(((o.double() - r).abs() / own).max()))
            r_cpu = max(r_cpu, float(((a.double() - r).abs() / own).max()))
        rec = by_op[str(func)]
        rec[0] += 1
        rec[1:] = [max(x, y) for x, y in zip(rec[1:], (e_card, e_cpu, r_card, r_cpu))]
        shapes = [(tuple(t.shape), str(t.dtype)) for t in torch.utils._pytree.tree_leaves(args)
                  if torch.is_tensor(t)]
        others = [a for a in torch.utils._pytree.tree_leaves(args) if not torch.is_tensor(a)]
        if first is None and e_card > 1e-5 and e_card > 20 * e_cpu:
            first = {"index": i, "op": str(func), "card": e_card, "cpu": e_cpu,
                     "inputs": shapes, "args": str(others)[:200]}
        if first_entry is None and r_card > 1e-4 and r_card > 20 * r_cpu:
            first_entry = {"index": i, "op": str(func), "card": r_card, "cpu": r_cpu,
                           "inputs": shapes, "args": str(others)[:200]}
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1][3])
    log(f"fault4 trace at seed {seed}, setting {setting}: {len(records)} operations recorded on "
        f"the card in iteration 0's video G step (loss and gradient), replayed on the CPU")
    for op, (n, e_card, e_cpu, r_card, r_cpu) in ranked[:15]:
        log(f"    {op:48s} {n:5d}x  card {e_card:.3g}  cpu {e_cpu:.3g} of the largest entry; "
            f"card {r_card:.3g}  cpu {r_cpu:.3g} of each entry")
    log("fault4 trace: first operation off fp32 on the card (of the largest entry): "
        + json.dumps(first))
    log("fault4 trace: first operation off fp32 on the card (of each entry): "
        + json.dumps(first_entry))
    return first, first_entry


def conditioning(seed=6, draws=6, card="cuda"):
    """How far rounding alone moves phase 11 (a)'s worst video G step
    gradient at data seed ``seed``: from the card's saved inputs of
    iteration 0's video G step, the gradient on the card and on the CPU in
    fp32, in float64, and in float64 and CPU fp32 from the same inputs
    with every generator parameter multiplied by ``1 + 6e-8 n`` (``n``
    standard normal: one fp32 rounding's size), ``draws`` times. Prints, for
    each, the largest difference from float64 over the step's largest
    entry and the entry that :func:`trace_kink` traced
    (``decoder.block1.conv2.conv.bias[4]``), as one ``conditioning:`` JSON
    line."""
    import contextlib

    snap = g_vid_snapshot(seed, "conditioning")
    trs, tr64 = _g_vid_trainers(card)
    none = contextlib.nullcontext()

    def grad(tr, dev, sd, f64=False):
        return _g_vid_gradient(tr, sd, snap["batch"], dev, none, float64=f64)

    ref = grad(tr64, "cpu", snap["sd"], True)
    scale = max(float(g.abs().max()) for g in ref.values())
    name, index = "decoder.block1.conv2.conv.bias", 4

    def gap(g):
        worst = max((float((g[n] - ref[n]).abs().max()), n) for n in ref)
        return {"worst": worst[0] / scale, "at": worst[1],
                "entry": float(g[name].flatten()[index] - ref[name].flatten()[index]) / scale}

    out = {"seed": seed, "step_largest": scale, "entry_float64": float(ref[name].flatten()[index]),
           "card_fp32": gap(grad(trs[card], card, snap["sd"])),
           "cpu_fp32": gap(grad(trs["cpu"], "cpu", snap["sd"])), "perturbed": []}
    for d in range(draws):
        sd = perturbed(snap["sd"], d)
        out["perturbed"].append({"float64": gap(grad(tr64, "cpu", sd, True)),
                                 "cpu_fp32": gap(grad(trs["cpu"], "cpu", sd))})
    log("conditioning: " + json.dumps(out))
    return out


def g_vid_snapshot(seed, label):
    """The card's inputs of iteration 0's video G step of phase 11 (a) at data
    seed ``seed``: ``{"sd": train state, "batch": batch}`` on the CPU."""
    random.seed(seed)
    snap = {}

    def on_step(when, it, kind, mode, a, b):
        if when == "before" and (it, kind, mode) == (0, "g", "vid"):
            snap["sd"], snap["batch"] = _to_cpu(a.state_dict()), _to_cpu(b)

    try:
        phase_ae_reference(on_step)
    except AssertionError as e:
        log(f"{label}: phase 11 (a) at data seed {seed} fails: {str(e)[:200]}")
    return snap


def _g_vid_trainers(card):
    """Phase 11 (a)'s trainers in fp32 on the card and the CPU and in
    float64 on the CPU, all with the CPU's seeded VGG."""
    import torch
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer

    cfg = small_ae_config()
    trs = {dev: FrameAutoencoderTrainer(cfg, dtype=torch.float32, device=dev)
           for dev in (card, "cpu")}
    tr64 = FrameAutoencoderTrainer(cfg, dtype=torch.float64, device="cpu")
    for tr in (trs[card], tr64):
        tr.losses.vgg.load_state_dict(trs["cpu"].losses.vgg.state_dict())
    return trs, tr64


def perturbed(state_sd, draw):
    """``state_sd`` with every floating generator parameter multiplied by
    ``1 + 6e-8 n``, n standard normal from seed ``draw``: one fp32
    rounding's size."""
    import copy

    import torch

    g = torch.Generator().manual_seed(draw)
    sd = copy.deepcopy(state_sd)
    for k, v in sd["gen"].items():
        if v.is_floating_point():
            sd["gen"][k] = v * (1 + 6e-8 * torch.randn(v.shape, generator=g))
    return sd


def kink_conditioning(seed=6, draws=6, card="cuda"):
    """Fault 4's next step: the decisions that flip between two CPU fp32
    passes of phase 11 (a)'s iteration-0 video G step at data seed ``seed``
    whose inputs differ by one fp32 rounding. From the card's saved inputs,
    the CPU runs unperturbed and, for each draw ``d`` < ``draws``, with the
    parameters of :func:`perturbed` (the draws of :func:`conditioning`),
    each pass's decisions recorded with their places (:class:`KinkTrace`).
    Per draw: the traced entry (``decoder.block1.conv2.conv.bias[4]``) in
    both passes over the step's largest, the decisions that differ by kind
    and the first of each by place, and float64 from the perturbed
    parameters with all of the unperturbed pass's decisions, all of the
    perturbed pass's, and the perturbed pass's of one kind at a time. Prints
    one ``kink-conditioning:`` JSON line."""
    snap = g_vid_snapshot(seed, "kink-conditioning")
    trs, tr64 = _g_vid_trainers(card)
    name, index = "decoder.block1.conv2.conv.bias", 4

    def entry(grads):
        return float(grads[name].flatten()[index])

    def traced(sd):
        trace = KinkTrace()
        grads = _g_vid_gradient(trs["cpu"], sd, snap["batch"], "cpu", trace)
        return grads, trace

    g0, t0 = traced(snap["sd"])
    scale = max(float(g.abs().max()) for g in g0.values())
    out = {"seed": seed, "step_largest": scale, "unperturbed_cpu": entry(g0) / scale,
           "card": entry(_g_vid_gradient(trs[card], snap["sd"], snap["batch"], card,
                                         KinkTrace())) / scale, "draws": []}
    for d in range(draws):
        sd = perturbed(snap["sd"], d)
        g1, t1 = traced(sd)
        flips, first = decisions_differing(t0.seen, t1.seen, t1.sites)
        row = {"draw": d, "perturbed_cpu": entry(g1) / scale,
               "decisions_differing": {k: v for k, v in flips.items() if v[0]},
               "first_differing": first}
        if any(v[0] for v in flips.values()):
            f64 = forced_float64(tr64, sd, snap["batch"], entry,
                                 {"unperturbed": t0.seen, "perturbed": t1.seen})
            row["float64"] = {k: v / scale for k, v in f64.items()}
            row["float64_perturbed_decisions_of_one_kind"] = {
                k: v / scale for k, v in forced_by_kind(tr64, sd, snap["batch"], entry, t1.seen,
                                                        t0.seen, flips).items()}
        out["draws"].append(row)
        log(f"kink-conditioning draw {d}: " + json.dumps(row))
    log("kink-conditioning: " + json.dumps(out))
    return out


def ae_seeds(seeds, setting=None):
    """Phase 11 (a) at each data seed in ``seeds``, with the fp32 setting
    ``setting`` of :func:`fp32_setting` applied once the trainers are built
    (None: as the trainers set it); prints one line a seed and raises if
    any fails."""
    failed = []
    for seed in seeds:
        random.seed(seed)
        t0 = time.perf_counter()
        try:
            phase_ae_reference(after_build=None if setting is None
                               else (lambda: fp32_setting(setting)))
            log(f"ae-seeds: phase 11 (a) passes at data seed {seed}, setting {setting} "
                f"({time.perf_counter() - t0:.1f} s)")
        except AssertionError as e:
            failed.append(seed)
            log(f"ae-seeds: phase 11 (a) FAILS at data seed {seed}, setting {setting}: "
                f"{str(e)[:400]}")
    if failed:
        raise AssertionError(f"phase 11 (a) failed at data seeds {failed}")


def _to_cpu(tree):
    """A copy of a nested state dict with every tensor on the CPU."""
    import copy

    import torch

    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return copy.deepcopy(tree)


# ---------------------------------------------------------------- phase 16

PHASE16_TIMED = 3  # timed full-width transformer steps of DP and of FSDP


def write_raw_bairhd(root, n_traj, n_frames=30, width=1024, height=256, seed=0):
    """A raw BAIR-HD tree in the softmotion layout that ``preprocess_bairhd``
    reads (``softmotion_0511/aux1/traj_group0/traj{k}/images/
    aux1_full_cropped_im{i}_*.jpg``): ``n_traj`` trajectories of ``n_frames``
    JPEGs, wide enough for the crop ``x[157:967]``, a square moving over a
    colour gradient."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    for k in range(n_traj):
        d = os.path.join(root, "softmotion_0511", "aux1", f"traj_group{k // 1000}", f"traj{k}",
                         "images")
        os.makedirs(d, exist_ok=True)
        base = np.stack([xx * 255 // width, yy * 255 // height,
                         np.full_like(xx, 40 * (k % 6))], -1).astype(np.uint8)
        x0, y0 = rng.randint(200, 700), rng.randint(10, height - 70)
        vx, vy = rng.randint(-8, 9), rng.randint(-3, 4)
        for i in range(n_frames):
            f = base.copy()
            x, y = x0 + vx * i, int(np.clip(y0 + vy * i, 0, height - 60))
            f[y:y + 60, x:x + 60] = (230, 60, 30)
            Image.fromarray(f).save(os.path.join(d, f"aux1_full_cropped_im{i}_{k}{i:02d}.jpg"),
                                    quality=92)


def phase_data_tools(card, root):
    """(a) Data: a raw BAIR-HD tree of 17 trajectories through
    ``preprocess_bairhd`` at dim 256 (16 train, 1 test), ``compute_folds`` /
    ``compute_metadata`` on AVIs of 4 prepared trajectories, the native
    loader's ``decode_jpeg_batch`` of 256 frames of 256x256 (8 threads)
    against PIL, and the prepared tree through the BAIR dataset and
    ``PrefetchLoader``. Returns ``(cfg, loader)``."""
    import dataclasses
    import glob
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.data import PrefetchLoader, create_dataset, native, prep
    from ccvs_tpu_torch.data.clips import load_index
    from ccvs_tpu_torch.utils import video_io

    n_train, n_test = 16, 1
    t0 = time.perf_counter()
    write_raw_bairhd(root, n_train + n_test)
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep.preprocess_bairhd(root, dim=256, num_workers=8, train_range=(0, n_train),
                           test_range=(n_train, n_train + n_test))
    t_prep = time.perf_counter() - t0
    out = os.path.join(root, "original_frames_256")
    pngs = sorted(glob.glob(os.path.join(out, "*", "*", "*.png")))
    if len(pngs) != (n_train + n_test) * 30:
        raise AssertionError(f"data: preprocess_bairhd wrote {len(pngs)} frames, expected "
                             f"{(n_train + n_test) * 30}")
    if np.asarray(Image.open(pngs[0])).shape != (256, 256, 3):
        raise AssertionError("data: a prepared frame is not 256x256x3")
    log(f"data: raw tree of {n_train + n_test} x 30 JPEGs (1024 x 256) written in {t_raw:.2f} s; "
        f"preprocess_bairhd at dim 256, 8 workers: {len(pngs)} frames in {t_prep:.2f} s = "
        f"{len(pngs) / t_prep:.1f} frames/s")
    avis = []
    for k in range(4):
        frames = np.stack([np.asarray(Image.open(p)) for p in
                           sorted(glob.glob(os.path.join(out, "train", f"{k:05d}", "*.png")))])
        avis.append(os.path.join(root, "avi", f"{k:05d}.avi"))
        os.makedirs(os.path.dirname(avis[-1]), exist_ok=True)
        video_io.write_video(avis[-1], frames, fps=4)
    prep.compute_folds(avis, os.path.join(root, "folds"), 2)
    prep.compute_metadata(avis, os.path.join(root, "metadata.pkl.gz"), clip_len=16, skip=4)
    index = load_index(os.path.join(root, "metadata.pkl.gz"))
    if len(index) != 4 * ((30 - 16) // 4 + 1):
        raise AssertionError(f"data: compute_metadata indexed {len(index)} clips, expected 16")

    jpgs = []
    os.makedirs(os.path.join(root, "jpg"))
    for i, p in enumerate(pngs[:256]):
        jpgs.append(os.path.join(root, "jpg", f"{i:03d}.jpg"))
        Image.open(p).save(jpgs[-1], quality=92)

    def pil(path):
        return np.asarray(Image.open(path).convert("RGB"))

    t0 = time.perf_counter()
    ref = np.stack([pil(p) for p in jpgs])
    fps_pil = len(jpgs) / (time.perf_counter() - t0)
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        list(pool.map(pil, jpgs))
        fps_pil8 = len(jpgs) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    built = native.available()
    t_build = time.perf_counter() - t0
    if built:
        native.decode_jpeg_batch(jpgs[:8], 256, 256, n_threads=8)
        t0 = time.perf_counter()
        arr = native.decode_jpeg_batch(jpgs, 256, 256, n_threads=8)
        fps_native = len(jpgs) / (time.perf_counter() - t0)
        diff = float(np.abs(arr.astype(np.int16) - ref.astype(np.int16)).mean())
        if arr.shape != ref.shape or diff > 2.0:
            raise AssertionError(f"data: the native decode differs from PIL's by {diff} levels")
        log(f"data: native loader built from native/loader.cpp into {native.LIB_PATH} "
            f"({t_build:.2f} s); decode_jpeg_batch of {len(jpgs)} JPEGs of 256x256, 8 threads: "
            f"{fps_native:.0f} frames/s; PIL {fps_pil:.0f} frames/s on one thread, "
            f"{fps_pil8:.0f} on 8; mean |native - PIL| {diff:.3f} levels; host of {card}")
    else:
        log(f"data: native loader not built ({native.build_log.strip()[-300:]}); PIL "
            f"{fps_pil:.0f} frames/s on one thread, {fps_pil8:.0f} on 8")

    base = bairhd_config()
    cfg = base.replace(name="phase16", data=dataclasses.replace(base.data, dataroot=root,
                                                                num_workers=8))
    ds = create_dataset(cfg.data, phase="train", load_vid=True)
    if len(ds) != n_train:
        raise AssertionError(f"data: the BAIR dataset found {len(ds)} clips, expected {n_train}")
    loader = PrefetchLoader(ds, cfg.data.batch_size_vid, num_workers=8, seed=0, host_shard=None)
    t0 = time.perf_counter()
    batch = next(iter(loader))
    t_batch = time.perf_counter() - t0
    if batch["vid"].shape != (16, 16, 256, 256, 3):
        raise AssertionError(f"data: a loader batch is {batch['vid'].shape}")
    log(f"data: the BAIR dataset's PrefetchLoader (8 threads): a batch of 16 clips x 16 frames "
        f"in {t_batch:.3f} s = {256 / t_batch:.0f} frames/s (cold, from the prepared PNGs)")
    return cfg, loader


def _tiny_dp_step(mesh, dev):
    """The dry run's tiny GPT (``train/dryrun.py``): one data-parallel step
    on this rank's rows of a seeded global batch of 4; ``(nll, gnorm, whole
    parameters after it)``."""
    import torch
    from ccvs_tpu_torch.models.transformer import TokenTransformer
    from ccvs_tpu_torch.parallel.mesh import shard_batch
    from ccvs_tpu_torch.train.dryrun import GPT_CFG
    from ccvs_tpu_torch.train.steps import make_transformer_step

    code = torch.randint(0, GPT_CFG.z_num, (4, GPT_CFG.z_len),
                         generator=torch.Generator().manual_seed(0))
    tr = TokenTransformer(GPT_CFG, dtype=torch.float32, device=dev).init(0)
    init, step = make_transformer_step(tr, GPT_CFG, n_iter=10, mesh=mesh)
    state = init()
    for _ in range(2):  # the first update has lr 0
        rows = code if mesh is None else shard_batch(mesh, code)
        state, m = step(state, {"code": rows.to(dev)})
    return (float(m["nll"]), float(m["gnorm"]),
            {k: v.detach().cpu() for k, v in tr.model.named_parameters()})


def _gloo_rank(rank, port, out_dir):
    """A rank of the two-process gloo group on the one card (phase 16 (c))."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        res = _tiny_dp_step(mesh, "cuda")
    except BaseException as e:  # noqa: BLE001 - reported by the parent, which fails
        import traceback

        res = {"error": f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def gloo_on_one_card():
    """(c) Two processes on the one card over gloo, the card's tensors in
    the collectives: the tiny DP step of 2 x 2 rows against the one-process
    step on all 4. Returns the ranks' results and the reference."""
    import multiprocessing as mp
    import tempfile

    import torch
    from ccvs_tpu_torch.parallel.mesh import _free_port

    ref = _tiny_dp_step(None, "cuda")
    out_dir = tempfile.mkdtemp(prefix="phase16_gloo_")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, out_dir)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise AssertionError(f"parallel: {len(hung)} gloo ranks on the card hung past 240 s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(2)], ref


def _small_parallel_parity(mesh, device="cuda"):
    """A small fp32 configuration (phase 10 (a)'s) on the card: one
    transformer step unwrapped, through DP and through FSDP on ``mesh``,
    from the same seeded state and batch; the largest difference of
    ``nll``, ``gnorm`` and each gradient, relative to its largest entry."""
    import dataclasses

    import torch
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.parallel.fsdp import full_tensor
    from ccvs_tpu_torch.train.ae_trainer import to_device
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    cfg = small_train_config()
    batch = to_device(_train_data(cfg, "train", 1)[0], device)
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device=device).init(seed=0)
    out = {}
    for name, c, m in (("plain", cfg, None), ("dp", cfg, mesh),
                       ("fsdp", cfg.replace(gpt=dataclasses.replace(cfg.gpt, fsdp=True)), mesh)):
        tr = TransformerTrainer(c, ae, dtype=torch.float32, device=device, mesh=m)
        tr.transformer.init(seed=1)
        state, met = tr.step(tr.init_state(), tr.encode_batch(batch))
        out[name] = ({k: float(met[k]) for k in ("nll", "gnorm")},
                     {n: full_tensor(p.grad).float() for n, p in
                      tr.transformer.model.named_parameters()})
    worst = 0.0
    for name in ("dp", "fsdp"):
        (m0, g0), (m1, g1) = out["plain"], out[name]
        scale = max(float(g.abs().max()) for g in g0.values())
        worst = max([worst] + [abs(m1[k] - m0[k]) / abs(m0[k]) for k in m0]
                    + [float((g1[n] - g0[n]).abs().max()) / scale for n in g0])
    return worst


def phase_parallel(records, card):
    """Phase 16: data, utilities and the parallel layer (see the module's
    docstring)."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from ccvs_tpu_torch.models import FrameAutoencoder
    from ccvs_tpu_torch.parallel.fsdp import local_fraction
    from ccvs_tpu_torch.parallel.mesh import _free_port, init_distributed, make_mesh
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, cycle_loader, to_device
    from ccvs_tpu_torch.train.dryrun import run_tiny_multichip_step
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    work = tempfile.mkdtemp(prefix="phase16_")
    t_a = time.perf_counter()
    cfg, loader = phase_data_tools(card, os.path.join(work, "bairhd"))
    log(f"phase 16 (a): {time.perf_counter() - t_a:.1f} s")

    # (b) the process group of one process on the card, as torchrun gives it
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    dev = init_distributed()
    mesh = make_mesh(1)
    log(f"parallel: process group {dist.get_backend()} of {dist.get_world_size()} on {dev}, "
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    try:
        t_ae = time.perf_counter()
        base = cfg.replace(name="phase16_ae", data=dataclasses.replace(
            cfg.data, dataset="synthetic", batch_size_img=24, batch_size_vid=4))
        (bi, bv), = _ae_batches(base, 1)
        img, vid = to_device(bi, "cuda"), to_device(bv, "cuda")
        atr = FrameAutoencoderTrainer(base, mesh=mesh)
        atr.init_params()
        astate = atr.init_state()
        live = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        astate, *_ = atr.iteration(astate, 1, img, vid)
        secs = {}
        profiling.reset()
        for it_n in (2, 16):  # 16: R1 (d_reg_every 16)
            t0 = time.perf_counter()
            astate, gm, dm, _ = atr.iteration(astate, it_n, img, vid)
            float(gm["g_loss"])
            secs[it_n] = common.synced(CARD) - t0
        launches = kernel_launches("k1")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != 4 or "r1_img" not in gm:
            raise AssertionError(f"parallel ae: K1 {launches} in 2 iterations (expected 4), "
                                 f"metrics {sorted(gm)}")
        bad = [k for k, v in {**gm, **dm}.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"parallel ae: non-finite {bad}")
        records["vq_argmin"]["launches_by_rollout"]["phase16_ae (2 iterations)"] = launches
        rp, rr, rpk = TRAIN_REF.get("ae", (float("nan"),) * 3)
        log(f"parallel ae: a DP iteration at 24 images and 4 clips {secs[2]:.4f} s, with R1 "
            f"{secs[16]:.4f} s (phase 11 (b): {rp:.4f} / {rr:.4f} s); peak {peak:.2f} GiB "
            f"(phase 11 (b): {rpk:.2f}; {live:.2f} GiB allocated before the iterations); K1 "
            f"{launches} launches; on {card}")
        del atr, astate, img, vid
        _release()
        log(f"phase 16 (b), autoencoder: {time.perf_counter() - t_ae:.1f} s")

        t_b = time.perf_counter()
        torch.cuda.empty_cache()
        it = iter(cycle_loader(loader))
        t0 = time.perf_counter()
        batches = [to_device(next(it), "cuda") for _ in range(PHASE16_TIMED + 1)]
        t_feed = (time.perf_counter() - t0) / len(batches)
        ae = FrameAutoencoder(cfg.ae, dtype=torch.bfloat16).init(seed=0)

        def fresh(c, m):
            tr = TransformerTrainer(c, ae, mesh=m)
            tr.transformer.init(seed=1)
            return tr, tr.init_state()

        tr, state = fresh(cfg, None)
        state, m = tr.step(state, tr.encode_batch(batches[0]))
        ref = {k: float(m[k]) for k in ("nll", "gnorm")}
        del tr, state, m
        _release()
        ref_s, ref_peak = TRAIN_REF.get("transformer", (float("nan"), float("nan")))
        for name, c in (("dp", cfg),
                        ("fsdp", cfg.replace(gpt=dataclasses.replace(cfg.gpt, fsdp=True)))):
            tr, state = fresh(c, mesh)
            live = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            state, m = tr.step(state, tr.encode_batch(batches[0]))
            first = {k: float(m[k]) for k in ("nll", "gnorm")}
            rel = {k: abs(first[k] - ref[k]) / abs(ref[k]) for k in ref}
            # bf16 compute: the same operations on the same state, the
            # gradient all-reduce aside (phase 10 (a)'s relative 1e-4 is for
            # fp32; allow 1e-3 for bf16 atomics)
            if max(rel.values()) > 1e-3:
                raise AssertionError(f"parallel {name}: first step {first} against the "
                                     f"unwrapped step's {ref}")
            profiling.reset()
            t0 = time.perf_counter()
            for b in batches[1:]:
                state, m = tr.step(state, tr.encode_batch(b))
                nll = float(m["nll"])
            dt = (common.synced(CARD) - t0) / PHASE16_TIMED
            launches = kernel_launches("k1")
            peak = torch.cuda.max_memory_allocated() / 2**30
            if launches != PHASE16_TIMED:
                raise AssertionError(f"parallel {name}: K1 launched {launches} times in "
                                     f"{PHASE16_TIMED} steps, expected {PHASE16_TIMED}")
            records["vq_argmin"]["launches_by_rollout"][
                f"phase16_{name} ({PHASE16_TIMED} steps)"] = launches
            extra = ""
            if name == "fsdp":
                params = list(tr.transformer.parameters())
                if not all(isinstance(p, DTensor) and p.placements[0].is_shard() for p in params):
                    raise AssertionError("parallel fsdp: a parameter is not split over data")
                extra = (f"; every parameter a DTensor split on dim 0 over a data axis of 1 "
                         f"(local share {local_fraction(params[0]):.2f})")
            log(f"parallel {name}: full-width BAIR-256 transformer step fed by the prepared "
                f"set, {dt:.4f} s a step over {PHASE16_TIMED} ({dt / ref_s:.3f}x phase 10 (b)'s "
                f"{ref_s:.4f} s), peak {peak:.2f} GiB (phase 10 (b): {ref_peak:.2f}; "
                f"{live:.2f} GiB allocated before the steps); first "
                f"step nll {first['nll']:.5f} / gnorm {first['gnorm']:.5f} against the "
                f"unwrapped step's {ref['nll']:.5f} / {ref['gnorm']:.5f} (relative "
                f"{rel['nll']:.2e} / {rel['gnorm']:.2e}); last nll {nll:.4f}; K1 {launches} "
                f"launches{extra}; {t_feed:.3f} s a batch from the loader to the card; on {card}")
            if name == "dp":
                state = phase_parallel_utilities(tr, state, batches, work, card)
            del tr, state, m
            _release()
        del batches
        _release()
        worst = _small_parallel_parity(mesh)
        if not worst <= 1e-6:
            raise AssertionError(f"parallel: the small fp32 step through DP / FSDP differs from "
                                 f"the unwrapped one by {worst:.3g} of the largest entry")
        log(f"parallel: small fp32 configuration, one step unwrapped / DP / FSDP on the card: "
            f"nll, gnorm and every gradient within {worst:.3g} of the largest entry "
            f"(tolerance 1e-6)")
        log(f"phase 16 (b), transformer: {time.perf_counter() - t_b:.1f} s")

        # (c) the dry run at world 1, then two gloo processes on the card
        t_c = time.perf_counter()
        line = run_tiny_multichip_step(mesh)
        log(f"parallel: {line}")
        ranks, (nll1, gn1, p1) = gloo_on_one_card()
        errors = [r["error"] for r in ranks if isinstance(r, dict) and "error" in r]
        if errors:
            raise AssertionError("parallel: two gloo processes on the card failed: "
                                 + " | ".join(errors))
        worst = 0.0
        for nll2, gn2, p2 in ranks:
            scale = max(float(v.abs().max()) for v in p1.values())
            worst = max([worst, abs(nll2 - nll1) / abs(nll1), abs(gn2 - gn1) / abs(gn1)]
                        + [float((p2[k] - p1[k]).abs().max()) / scale for k in p1])
        if not worst <= 1e-5:
            raise AssertionError(f"parallel: gloo DP-2 on the card differs from one process by "
                                 f"{worst:.3g}")
        log(f"parallel: 2 processes on the one card over gloo (CUDA tensors in the "
            f"collectives), the tiny DP step of 2 x 2 rows against one process on 4: nll, gnorm "
            f"and parameters within {worst:.3g} (tolerance 1e-5); {time.perf_counter() - t_c:.1f} s")
    finally:
        dist.destroy_process_group()


def phase_parallel_utilities(tr, state, batches, work, card):
    """(d) On the DP trainer: ``trace()`` around three steps (the largest
    kernels, K1's among the trace's), an async save of the whole GPT state
    while the next step runs (that step's seconds beside one without a save
    in flight; the loaded state bit-equal to the saved one), and
    ``sync_triggered`` at world 1. Returns the state."""
    import torch
    from torch.autograd import DeviceType
    from ccvs_tpu_torch.utils import profiling
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
    from ccvs_tpu_torch.utils.preemption import PreemptionGuard

    tdir = os.path.join(work, "trace")
    with profiling.trace(tdir, "three_steps") as prof:
        for b in batches[1:4]:
            state, m = tr.step(state, tr.encode_batch(b))
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    size = os.path.getsize(os.path.join(tdir, "three_steps.json"))
    # K1's three kernels (vq.cu's anonymous namespace prefixes their names)
    k1 = [(i, n, t) for i, (n, t) in enumerate(top) if "vq_" in n]
    if not top:
        raise AssertionError("utilities: the trace of three steps holds no device kernel")
    if len(k1) != 3 or any(count[n] != 3 for _, n, _ in k1):
        raise AssertionError(f"utilities: K1's kernels in the trace of three steps: "
                             f"{[(n[:60], count[n]) for _, n, _ in k1]}, expected 3 of 3 launches")
    log(f"utilities: trace() of 3 steps -> a Chrome trace of {size / 2**20:.1f} MiB; device "
        f"time {sum(by_name.values()):.1f} ms; largest kernels:")
    for n, t in top[:8]:
        log(f"    {t:9.2f} ms  {count[n]:5d}x  {n[:100]}")
    log("    K1: " + ", ".join(f"{n} {t:.3f} ms ({count[n]}x, rank {i + 1} of {len(top)})"
                             for i, n, t in k1))

    sd = state.state_dict()
    snap = _device_clone(sd)  # what the save must write, kept on the card
    ckpt = CheckpointManager(os.path.join(work, "ckpt"), async_save=True)

    def step_s(b):
        t0 = time.perf_counter()
        s, m = tr.step(state, tr.encode_batch(b))
        float(m["nll"])
        return s, common.synced(CARD) - t0

    t0 = time.perf_counter()
    ckpt.save("transformer", 1, sd, latest=True)
    t_copy = time.perf_counter() - t0
    state, t_overlap = step_s(batches[0])
    t0 = time.perf_counter()
    ckpt.wait()
    t_wait = time.perf_counter() - t0
    state, t_plain = step_s(batches[1])
    t0 = time.perf_counter()
    loaded = ckpt.load("transformer", "latest")
    t_load = time.perf_counter() - t0

    def equal(a, b):
        if torch.is_tensor(a):
            return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(equal(a[k], b[k])
                                                                       for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return a == b

    if not equal(snap, loaded):
        raise AssertionError("utilities: the loaded checkpoint is not the saved state")
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(snap))
    log(f"utilities: async save of the full GPT state ({n_bytes / 2**30:.2f} GiB: parameters "
        f"and AdamW moments): the copy to the host inside save {t_copy:.3f} s; the next step "
        f"with the write in flight {t_overlap:.4f} s against {t_plain:.4f} s without "
        f"({t_overlap / t_plain:.3f}x); the join after it {t_wait:.3f} s; the load "
        f"{t_load:.3f} s, every tensor bit-equal to the saved state; on {card}")
    guard = PreemptionGuard()
    before = guard.sync_triggered()
    guard.trigger()
    log(f"utilities: sync_triggered at world 1: {before} before a trigger, "
        f"{guard.sync_triggered()} after (no collective at one process)")
    del snap, loaded
    return state


def _release():
    """Free what the objects just deleted held on the card (FSDP's hooks
    keep reference cycles that only the garbage collector breaks)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _device_clone(tree):
    import torch

    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _device_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_device_clone(v) for v in tree)
    return tree


def _tensors(tree):
    import torch

    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    records = {}
    with phase("0 device"):
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
        from ccvs_tpu_torch.device import resolve_device

        resolve_device()
    with phase("1 build"):
        from ccvs_tpu_torch.ops import native

        t0 = time.perf_counter()
        report = native.build(force=True)
        native.library()
        log(f"built {native.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log("  " + line.strip())
    with phase("2 kernels"):
        phase_kernels(records)
    from ccvs_tpu_torch.config import bairhd_config, kinetics_config

    with phase("3 rollout"):
        models = phase_rollout(records, card, bairhd_config(), n_ctx=1)
        log(f"decode step: {decode_ops_per_layer(models[1], models[3])} PyTorch operations a "
            "layer on the card (bf16 parameters, compute and cache)")
        decode_step_ms(models[1])
    with phase("4 kinetics"):
        # 24 frames, 5 context frames (cond_len 320 / 64 tokens a frame): 960
        # decode steps fill the 1280-token window, then it slides 4 chunks of 64
        phase_rollout(records, card, kinetics_config(), n_ctx=5, vid_len=KINETICS_LEN,
                      k2_steps=(1280 - 320) + (KINETICS_LEN - 20) * 64)
    with phase("5 profile"):
        phase_profile(*models)
    del models
    with phase("6 reference"):
        phase_reference()
    with phase("7 modes"):
        phase_modes(records, card)
    with phase("8 drums"):
        phase_drums(records, card)
    with phase("9 serving"):
        phase_serving(records, card)
    with phase("10 train"):
        phase_train(records, card)
    with phase("11 autoencoder training"):
        phase_ae_train(records, card)
    with phase("12 generate and score"):
        phase_generate(records, card)
    with phase("13 ADA and layouts"):
        phase_ada_layouts(records, card)
    with phase("14 GPT variants and reference checkpoints"):
        phase_gpt_variants(records, card)
    with phase("15 autoencoder options"):
        phase_ae_options(records, card)
    with phase("16 data, utilities and the parallel layer"):
        phase_parallel(records, card)
    log(json.dumps({"kernels": list(records.values())}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["trace-kink"]:
        # python3 chip_smoke.py trace-kink [SEED]: fault 4's trace, see trace_kink
        trace_kink(int(sys.argv[2]) if len(sys.argv) > 2 else 6)
    elif sys.argv[1:2] == ["trace-ops"]:
        # python3 chip_smoke.py trace-ops [SEED [SETTING]]: see conv_precision_probe, trace_ops
        conv_precision_probe()
        trace_ops(int(sys.argv[2]) if len(sys.argv) > 2 else 6,
                  sys.argv[3] if len(sys.argv) > 3 else "port")
    elif sys.argv[1:2] == ["kink-conditioning"]:
        # python3 chip_smoke.py kink-conditioning [SEED [DRAWS]]: see kink_conditioning
        kink_conditioning(int(sys.argv[2]) if len(sys.argv) > 2 else 6,
                          int(sys.argv[3]) if len(sys.argv) > 3 else 6)
    elif sys.argv[1:2] == ["conditioning"]:
        # python3 chip_smoke.py conditioning [SEED]: see conditioning
        conditioning(int(sys.argv[2]) if len(sys.argv) > 2 else 6)
    elif sys.argv[1:2] == ["phase16"]:
        # python3 chip_smoke.py phase16: phases 0, 1 and 16 alone (no kernels
        # record; phases 10 (b) and 11 (b), which it is set beside, not run)
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        with phase("1 build"):
            from ccvs_tpu_torch.ops import native

            native.build(force=True)
        with phase("16 data, utilities and the parallel layer"):
            phase_parallel({"vq_argmin": {"launches_by_rollout": {}}}, card_line())
    elif sys.argv[1:2] in (["k3"], ["k3-ab"]):
        # python3 chip_smoke.py k3: phases 0, 1 and 2's K3 part, then the
        # int8 and bf16 BAIR-256 rollouts at MODE_LEN frames; k3-ab: see k3_ab
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        log(f"card: {card_line()}")
        from ccvs_tpu_torch.ops import native

        with phase("1 build"):
            for line in native.build(force=True).splitlines():
                if "int8" in line or "registers" in line or "spill" in line:
                    log("  " + line.strip())
        if sys.argv[1] == "k3-ab":
            k3_ab()
        else:
            phase_k3(card_line())
    elif sys.argv[1:2] == ["ae-seeds"]:
        # python3 chip_smoke.py ae-seeds [--setting NAME] SEED...: see ae_seeds
        args = sys.argv[2:]
        setting = None
        if args[:1] == ["--setting"]:
            setting, args = args[1], args[2:]
        ae_seeds([int(s) for s in args], setting)
    else:
        main()
