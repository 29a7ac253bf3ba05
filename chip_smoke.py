#!/usr/bin/env python3
"""Drive the ccvs_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its wall time:

0. device: the card's name and power limit, torch and CUDA versions;
1. build: both CUDA kernels (``ccvs_tpu_torch/csrc``), one ``nvcc`` process
   per source, started together, with the registers, shared memory and spills
   of each kernel;
2. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes (K2 with its position an int32 on the device, at positions
   0, 63, 64, 511 and 1023, and once captured in a CUDA graph and replayed at
   positions 0, 63, 511 and 1023), then timed (CUDA events, L2 flushed,
   median; K1 at the encode shapes of both rollouts, K2 at positions 63, 511
   and 1023) beside its plain version, a PyTorch library call that the port
   never makes, and its bound (K1's against both the fp32 CUDA cores and its
   own three TF32 tensor-core products);
3. rollout: ``VideoGenerator.generate`` on the full-width BAIR-256 config in
   bf16 from a seeded init, batch 2, 16 frames, 1 context frame: one warm-up
   (its stages timed one by one) and one timed run, with every kernel's
   launch count read around the timed run;
4. kinetics: the same on the full-width Kinetics-600 config (64x64, 16384
   codes, 5 context frames, a 24-layer GPT over a 1280-token window), batch
   2, 16 frames;
5. profile: the device's busy share and largest kernels per stage, on parts
   of the BAIR rollout (``torch.profiler``), with the token stage early and
   late in the window;
6. reference: a small fp32 configuration generated greedily on the GPU and on
   the CPU (where the kernels' plain versions run) must agree.

The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without a result line. Without a CUDA device the script fails at once.
"""

import json
import statistics
import subprocess
import time

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_TF32_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense
BATCH, VID_LEN = 2, 16


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


def _synced_since(t0):
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() - t0


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    # 256); timed at the encode shapes
    shapes = []
    for n, d, k, timed in ((2048, 512, 1024, True), (128, 512, 1024, False),
                           (2048, 256, 16384, True), (640, 256, 16384, False)):
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
        n_bytes = 4 * (n * d + k * d + n)
        fp32, _ = bound_ms(n_bytes, 2 * n * k * d, PEAK_FP32_PER_S)
        bnd, by = bound_ms(n_bytes, 3 * 2 * n * k * d, PEAK_TF32_PER_S)  # three TF32 products
        log(f"{what}; kernel {ms:.4f} ms, plain {plain:.4f} ms, cdist+argmin {lib:.4f} ms; "
            f"bound {bnd:.4f} ms on the tensor cores in 3xTF32 ({by}; {100 * bnd / ms:.1f}% of "
            f"it), {fp32:.4f} ms on the fp32 CUDA cores, bytes alone "
            f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms")
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

    # K2 at the GPT decode shape: q (2, 16, 64), caches (2, 16, 1024, 64), bf16,
    # the position an int32 on the device, as the decode step gives it
    b, nh, length, hd = 2, 16, 1024, 64
    q = torch.randn(b, nh, hd, device="cuda", generator=g).bfloat16()
    kc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
    vc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
    pos_t = torch.zeros(1, dtype=torch.int32, device="cuda")
    worst = 0.0
    for pos in (0, 63, 64, 511, 1023):
        pos_t.fill_(pos)
        out = flash_decode_attention(q, kc, vc, pos_t)
        worst = max(worst, check_flash_decode(out, q, kc, vc, pos, f"pos={pos}"))
    # one launch captured in a CUDA graph serves every position
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode_attention(q, kc, vc, pos_t)
    for pos in (0, 63, 511, 1023):
        pos_t.fill_(pos)
        graph.replay()
        worst = max(worst, check_flash_decode(out, q, kc, vc, pos, f"CUDA-graph replay pos={pos}"))
    for pos in (63, 511, 1023):  # the range the rollout sweeps
        pos_t.fill_(pos)
        ms = time_ms(lambda: flash_decode_attention(q, kc, vc, pos_t))
        plain = time_ms(lambda: flash_decode_plain(q, kc, vc, pos_t))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc[:, :, :pos + 1], vc[:, :, :pos + 1]))
        live = pos + 1
        bnd, by = bound_ms(2 * (2 * b * nh * hd + 2 * b * nh * live * hd),
                           4 * b * nh * live * hd, PEAK_FP32_PER_S)
        log(f"K2 flash_decode pos={pos} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}; {100 * bnd / ms:.1f}% of it)")
    # what the timer shows for any launch, and K2 with its inputs in L2
    floor = time_ms(lambda: pos_t.fill_(pos))
    warm = time_ms(lambda: flash_decode_attention(q, kc, vc, pos_t), flush_l2=False)
    log(f"K2 flash_decode pos={pos} bf16 with the caches in L2: {warm:.4f} ms; the same timer "
        f"around a one-element fill_ launch: {floor:.4f} ms")
    records["flash_decode"] = {
        "name": "flash_decode", "route": "cuda", "source": "ccvs_tpu_torch/csrc/flash_decode.cu",
        "replaces": "ccvs_tpu/ops/attention_pallas.py:64", "launches": None,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
        "bound_by": by, "library_ms": lib, "launches_by_rollout": {}}


def phase_rollout(records, card, cfg, n_ctx):
    """Warm-up with its stages timed, then one timed ``generate`` with every
    kernel's launch count read around it; returns the models, the clip and
    the warm-up's tokens."""
    import torch
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
    from ccvs_tpu_torch.ops.attention import flash_decode_attention
    from ccvs_tpu_torch.ops.vq import vq_indices

    t0 = time.perf_counter()
    ae = FrameAutoencoder(cfg.ae, dtype=torch.bfloat16).init(seed=0)
    tr = TokenTransformer(cfg.gpt, dtype=torch.bfloat16).init(seed=1)
    gen = VideoGenerator(cfg, ae, tr)
    g = torch.Generator(device="cuda").manual_seed(2)
    vid = torch.rand(BATCH, VID_LEN, cfg.ae.max_dim, cfg.ae.max_dim, 3, device="cuda",
                     generator=g) * 2 - 1
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ae.parameters()) + sum(p.numel() for p in tr.parameters())
    log(f"{cfg.name} init: {n_params / 1e6:.1f} M parameters in {time.perf_counter() - t0:.1f} s")

    # warm-up: the calls generate() makes, one by one, each timed
    size = cfg.ae.tokens_per_frame
    stages = {}
    t0 = time.perf_counter()
    enc = ae.encode(vid)
    stages["encode"] = _synced_since(t0)
    t0 = time.perf_counter()
    ctx_code = enc["code"].reshape(BATCH, -1)[:, :n_ctx * size]
    code = tr.generate(ctx_code, torch.Generator(device="cuda").manual_seed(3),
                       total_len=VID_LEN * size)["code"]
    stages["tokens"] = _synced_since(t0)
    t0 = time.perf_counter()
    ae.decode_video(code.reshape(BATCH, VID_LEN, size), ctx_frames=vid[:, :n_ctx], n_ctx=n_ctx)
    stages["decode"] = _synced_since(t0)
    log(f"{cfg.name} warm-up rollout by stage: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; total {sum(stages.values()):.3f} s")

    vq_indices.launches = 0
    flash_decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = gen.generate(vid, torch.Generator(device="cuda").manual_seed(4), rec=False,
                       n_ctx_frames=n_ctx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"vq_argmin": vq_indices.launches, "flash_decode": flash_decode_attention.launches}

    fake = out["fake"]
    assert fake.is_cuda, "fake video is not on the GPU"
    assert fake.shape == (BATCH, VID_LEN, cfg.ae.max_dim, cfg.ae.max_dim, 3), fake.shape
    assert bool(torch.isfinite(fake).all()), "fake video has non-finite values"
    decode_steps = (VID_LEN - n_ctx) * size
    # K1: the encode of the clip and the re-encode of its context frames
    assert launches["vq_argmin"] == 2, launches
    assert launches["flash_decode"] == cfg.gpt.n_layer * decode_steps, (
        f"flash_decode launched {launches['flash_decode']} times, expected "
        f"{cfg.gpt.n_layer} layers x {decode_steps} decode steps")
    for name, n in launches.items():
        if records[name]["launches"] is None:  # the record's count is the first rollout's
            records[name]["launches"] = n
        records[name]["launches_by_rollout"][cfg.name] = n
    frames = BATCH * (VID_LEN - n_ctx)
    log(f"{cfg.name} rollout: {dt:.3f} s for {frames} generated frames = {frames / dt:.4f} "
        f"frames/s (batch {BATCH}, {VID_LEN} frames, {n_ctx} context), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, on {card}")
    return ae, tr, vid, code


def device_profile(fn):
    """``fn()`` timed without the profiler, then traced: (wall s, device busy
    s, device time by kernel name, largest first, launches by kernel name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    wall = _synced_since(t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
            count[e.name] = count.get(e.name, 0) + 1
    return wall, sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1]), count


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


def phase_reference():
    """Small fp32 config, greedy: the GPU path (kernels) against the CPU path
    (the kernels' plain versions, which the CPU tests hold against ccvs_tpu)."""
    import torch
    from ccvs_tpu_torch.config import AutoencoderConfig, Config, TransformerConfig
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer

    ae_cfg = AutoencoderConfig(necf=16, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64,
                               z_shape=(4, 4), max_dim=32, skip_memory=3,
                               skip_context=(1, 2, 3))
    gpt_cfg = TransformerConfig(z_num=64, z_len=64, num_blocks=4, cond_len=16, n_layer=2,
                                n_head=2, n_embd=128, z_shape=(4, 4), top_k=1)
    cfg = Config(ae=ae_cfg, gpt=gpt_cfg)
    vid = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    # one set of weights for both devices (the two generators' streams differ)
    ae_cpu = FrameAutoencoder(ae_cfg, dtype=torch.float32, device="cpu").init(seed=0)
    tr_cpu = TokenTransformer(gpt_cfg, dtype=torch.float32, device="cpu").init(seed=1)
    outs = {}
    for dev in ("cuda", "cpu"):
        ae = FrameAutoencoder(ae_cfg, dtype=torch.float32, device=dev)
        ae.load_state_dict(ae_cpu.state_dict())
        tr = TokenTransformer(gpt_cfg, dtype=torch.float32, device=dev)
        tr.load_state_dict(tr_cpu.state_dict())
        gen = VideoGenerator(cfg, ae, tr)
        outs[dev] = gen.generate(vid.to(dev), torch.Generator(device=dev).manual_seed(0),
                                 rec=True, n_ctx_frames=1)
    gpu, cpu = outs["cuda"], outs["cpu"]
    assert gpu["fake"].is_cuda
    if not torch.equal(gpu["code"].cpu(), cpu["code"]):
        raise AssertionError("greedy tokens differ between the GPU and the CPU path")
    for key in ("fake", "rec"):
        err = float((gpu[key].cpu() - cpu[key]).abs().max())
        log(f"reference: {key} max abs difference GPU vs CPU {err:.3g} (tolerance 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"{key}: GPU and CPU differ by {err} > 1e-3")


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
    with phase("4 kinetics"):
        # 5 context frames: cond_len 320 / 64 tokens a frame
        phase_rollout(records, card, kinetics_config(), n_ctx=5)
    with phase("5 profile"):
        phase_profile(*models)
    with phase("6 reference"):
        phase_reference()
    log(json.dumps({"kernels": list(records.values())}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
