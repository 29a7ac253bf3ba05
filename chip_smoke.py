#!/usr/bin/env python3
"""Drive the ccvs_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its wall time:

0. device: the card's name and power limit, torch and CUDA versions;
1. build: both CUDA kernels (``ccvs_tpu_torch/csrc``) in one ``nvcc`` call,
   with the registers, shared memory and spills of each kernel;
2. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes, then timed (CUDA events, L2 flushed, median) beside its plain
   version, a PyTorch library call that the port never makes, and its bound;
3. rollout: ``VideoGenerator.generate`` on the full-width BAIR-256 config in
   bf16 from a seeded init, batch 2, 16 frames, 1 context frame: one warm-up
   (its stages timed one by one) and one timed run, with every kernel's
   launch count read around the timed run;
4. profile: the device's busy share and largest kernels per stage, on parts
   of the rollout (``torch.profiler``);
5. reference: a small fp32 configuration generated greedily on the GPU and on
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
BATCH, VID_LEN, N_CTX = 2, 16, 1


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


def time_ms(fn, iters=25, warmup=3):
    """Median device time of ``fn`` in ms, with the 50 MB L2 cache flushed
    before each timed launch (callers on the serving path find it cold).

    The flush writes 1 GiB (~0.3 ms of device work), so the host has queued
    the start event, ``fn``'s launches and the end event before the device
    reaches them: the events time the device's work, not the host's enqueue."""
    import torch

    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        flush.zero_()
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


def phase_kernels(records):
    import torch
    import torch.nn.functional as F
    from ccvs_tpu_torch.ops.attention import flash_decode_attention, flash_decode_plain
    from ccvs_tpu_torch.ops.vq import vq_indices, vq_indices_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    # K1 at the BAIR shape (z of 2 x 16 frames x 64 tokens) and the Kinetics one
    for n, d, k, main in ((2048, 512, 1024, True), (2048, 256, 16384, False)):
        z = torch.randn(n, d, device="cuda", generator=g)
        cb = torch.randn(k, d, device="cuda", generator=g) * 0.1
        ties, gap = check_vq(z, cb)
        ms = time_ms(lambda: vq_indices(z, cb))
        plain = time_ms(lambda: vq_indices_plain(z, cb))
        lib = time_ms(lambda: torch.cdist(z, cb).argmin(1))
        bnd, by = bound_ms(4 * (n * d + k * d + n), 2 * n * k * d, PEAK_FP32_PER_S)
        log(f"K1 vq_argmin z ({n}, {d}) x codebook ({k}, {d}) fp32: indices equal but "
            f"{ties} near-ties (max distance gap {gap:.3g}); kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, cdist+argmin {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        if main:
            records["vq_argmin"] = {
                "name": "vq_argmin", "route": "cuda", "source": "ccvs_tpu_torch/csrc/vq.cu",
                "replaces": "ccvs_tpu/ops/vq_pallas.py:59", "launches": None,
                "max_abs_err": gap, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                "bound_by": by, "library_ms": lib}

    # K2 at the GPT decode shape: q (2, 16, 64), caches (2, 16, 1024, 64), bf16
    b, nh, length, hd = 2, 16, 1024, 64
    q = torch.randn(b, nh, hd, device="cuda", generator=g).bfloat16()
    kc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
    vc = torch.randn(b, nh, length, hd, device="cuda", generator=g).bfloat16()
    worst = 0.0
    for pos in (0, 63, 511, 1023):
        out = flash_decode_attention(q, kc, vc, pos)
        ref = flash_decode_plain(q.float(), kc.float(), vc.float(), pos)
        torch.cuda.synchronize()
        assert out.is_cuda and out.dtype == torch.bfloat16 and out.shape == q.shape
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        # bf16 output rounding: 2^-8 relative; allow 2^-7 relative + 1e-3 per element
        excess = float((diff - 2**-7 * ref.abs()).max())
        log(f"K2 flash_decode pos={pos}: max abs error {err:.3g} (max |ref| "
            f"{float(ref.abs().max()):.3g}) against the fp32 plain version; worst error "
            f"over 2^-7 |ref| {excess:.3g}")
        if not err <= 2e-2:
            raise AssertionError(f"flash_decode pos={pos}: max abs error {err} > 2e-2")
        if not excess <= 1e-3:
            raise AssertionError(f"flash_decode pos={pos}: error exceeds 2^-7 |ref| + 1e-3 "
                                 f"by {excess - 1e-3:.3g}")
        worst = max(worst, err)
    pos = length - 1
    ms = time_ms(lambda: flash_decode_attention(q, kc, vc, pos))
    plain = time_ms(lambda: flash_decode_plain(q, kc, vc, pos))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc[:, :, :pos + 1], vc[:, :, :pos + 1]))
    live = pos + 1
    bnd, by = bound_ms(2 * (2 * b * nh * hd + 2 * b * nh * live * hd), 4 * b * nh * live * hd,
                       PEAK_FP32_PER_S)
    log(f"K2 flash_decode pos={pos} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
    records["flash_decode"] = {
        "name": "flash_decode", "route": "cuda", "source": "ccvs_tpu_torch/csrc/flash_decode.cu",
        "replaces": "ccvs_tpu/ops/attention_pallas.py:64", "launches": None,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
        "bound_by": by, "library_ms": lib}


def phase_rollout(records, card):
    import torch
    from ccvs_tpu_torch.config import bairhd_config
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
    from ccvs_tpu_torch.ops.attention import flash_decode_attention
    from ccvs_tpu_torch.ops.vq import vq_indices

    cfg = bairhd_config()
    t0 = time.perf_counter()
    ae = FrameAutoencoder(cfg.ae, dtype=torch.bfloat16).init(seed=0)
    tr = TokenTransformer(cfg.gpt, dtype=torch.bfloat16).init(seed=1)
    gen = VideoGenerator(cfg, ae, tr)
    g = torch.Generator(device="cuda").manual_seed(2)
    vid = torch.rand(BATCH, VID_LEN, cfg.ae.max_dim, cfg.ae.max_dim, 3, device="cuda",
                     generator=g) * 2 - 1
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ae.parameters()) + sum(p.numel() for p in tr.parameters())
    log(f"init: {n_params / 1e6:.1f} M parameters in {time.perf_counter() - t0:.1f} s")

    # warm-up: the calls generate() makes, one by one, each timed
    size = cfg.ae.tokens_per_frame
    stages = {}
    t0 = time.perf_counter()
    enc = ae.encode(vid)
    stages["encode"] = _synced_since(t0)
    t0 = time.perf_counter()
    ctx_code = enc["code"].reshape(BATCH, -1)[:, :N_CTX * size]
    code = tr.generate(ctx_code, torch.Generator(device="cuda").manual_seed(3),
                       total_len=VID_LEN * size)["code"]
    stages["tokens"] = _synced_since(t0)
    t0 = time.perf_counter()
    ae.decode_video(code.reshape(BATCH, VID_LEN, size), ctx_frames=vid[:, :N_CTX], n_ctx=N_CTX)
    stages["decode"] = _synced_since(t0)
    log("warm-up rollout by stage: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; total {sum(stages.values()):.3f} s")

    vq_indices.launches = 0
    flash_decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = gen.generate(vid, torch.Generator(device="cuda").manual_seed(4), rec=False,
                       n_ctx_frames=N_CTX)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"vq_argmin": vq_indices.launches, "flash_decode": flash_decode_attention.launches}

    fake = out["fake"]
    assert fake.is_cuda, "fake video is not on the GPU"
    assert fake.shape == (BATCH, VID_LEN, cfg.ae.max_dim, cfg.ae.max_dim, 3), fake.shape
    assert bool(torch.isfinite(fake).all()), "fake video has non-finite values"
    decode_steps = (VID_LEN - N_CTX) * size
    assert launches["vq_argmin"] >= 1, launches
    assert launches["flash_decode"] == cfg.gpt.n_layer * decode_steps, (
        f"flash_decode launched {launches['flash_decode']} times, expected "
        f"{cfg.gpt.n_layer} layers x {decode_steps} decode steps")
    for name, n in launches.items():
        records[name]["launches"] = n
    frames = BATCH * (VID_LEN - N_CTX)
    log(f"rollout: {dt:.3f} s for {frames} generated frames = {frames / dt:.4f} frames/s "
        f"(batch {BATCH}, {VID_LEN} frames, {N_CTX} context), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, on {card}")
    return ae, tr, vid, code


def device_profile(fn):
    """``fn()`` timed without the profiler, then traced: (wall s, device busy
    s, device time by kernel name, largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    wall = _synced_since(t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    return wall, sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])


def phase_profile(ae, tr, vid, code):
    """Device busy share and the largest kernels of each stage, on parts of
    the rollout: the 16-frame encode, 64 token decode steps, a 4-frame decode."""
    import torch

    size = ae.cfg.tokens_per_frame
    work = {
        "encode (2 x 16 frames)": lambda: ae.encode(vid),
        "tokens (prefill + 64 decode steps)": lambda: tr.generate(
            code[:, :N_CTX * size], torch.Generator(device="cuda").manual_seed(5),
            total_len=(N_CTX + 1) * size),
        "decode (4 frames, 1 context)": lambda: ae.decode_video(
            code[:, :4 * size].reshape(BATCH, 4, size), ctx_frames=vid[:, :N_CTX], n_ctx=N_CTX),
    }
    for name, fn in work.items():
        wall, busy, kernels = device_profile(fn)
        if not kernels:
            log(f"profile {name}: wall {wall:.4f} s; device time not measured "
                "(the profiler recorded no device events)")
            continue
        log(f"profile {name}: wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}% of wall, idle {100 * (1 - busy / wall):.1f}%)")
        for kname, t in kernels[:6]:
            log(f"    {100 * t / busy:5.1f}%  {t * 1e3:9.3f} ms  {kname[:110]}")


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
    with phase("3 rollout"):
        models = phase_rollout(records, card)
    with phase("4 profile"):
        phase_profile(*models)
    with phase("5 reference"):
        phase_reference()
    log(json.dumps({"kernels": list(records.values())}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
