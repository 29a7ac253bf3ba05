"""Command-line entry points of the port (counterpart of ``ccvs_tpu/cli.py``).

Usage::

    python -m ccvs_tpu_torch.cli train-ae --preset bairhd [--n-iter N] [--resume]
    python -m ccvs_tpu_torch.cli train-transformer --preset bairhd --ae-ckpt DIR
    python -m ccvs_tpu_torch.cli train-state --preset bairhd_state --ae-ckpt DIR
    python -m ccvs_tpu_torch.cli train-stft --preset drums
    python -m ccvs_tpu_torch.cli generate --preset bairhd --ae-ckpt DIR --gpt-ckpt DIR
    python -m ccvs_tpu_torch.cli eval-fvd --real DIR --fake DIR
    python -m ccvs_tpu_torch.cli eval-metrics --real DIR --fake DIR
    python -m ccvs_tpu_torch.cli eval-all --real DIR --fake DIR [--rec DIR]

``--ae-ckpt`` is the run directory of a ``train-ae`` run (its checkpoints
and ``config.json``); the frozen autoencoder takes its EMA weights unless
``--ae-raw``. ``generate`` writes ``real/``, ``fake/`` and ``rec/`` AVIs
under ``<save_path>/results/<name>/``; the ``eval-*`` commands score such
directories and print one JSON line. Everything runs on the GPU unless
``--device cpu``. A trainer stopped by SIGTERM or SIGINT writes its latest
checkpoint and exits with 75, so that a wrapper can resume it.

Several GPUs: one process a GPU under ``torchrun`` with ``--distributed``
(``parallel/mesh.py``), e.g.::

    torchrun --nproc-per-node 4 -m ccvs_tpu_torch.cli train-ae --preset bairhd --distributed
    torchrun --nproc-per-node 4 -m ccvs_tpu_torch.cli train-transformer ... --distributed --fsdp
    torchrun --nproc-per-node 4 -m ccvs_tpu_torch.cli train-transformer ... --distributed \
        --model-parallel 2 [--seq-parallel]

The batch is split over the mesh's data axis, ``--model-parallel`` splits
the GPT's weights over its model axis (tensor parallelism; with
``--seq-parallel`` the tokens too), ``--fsdp`` splits the GPT's parameters
and moments over the data axis. ``generate`` on a mesh writes each process's clips,
named by their global index. ``--fused`` (the JAX package's one-program
decode) has no counterpart and is refused.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _add_common(p):
    p.add_argument("--preset", default="bairhd", help="config preset name")
    p.add_argument("--load-config", default=None,
                   help="a saved config.json; overrides --preset")
    p.add_argument("--name", default=None)
    p.add_argument("--save-path", default=None)
    p.add_argument("--n-iter", type=int, default=None)
    p.add_argument("--dataroot", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--vgg-npz", default=None, help="VGG weights (torchvision keys)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="compute dtype of the autoencoder and the GPT")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="transformer training: microbatches an optimizer update")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT): one process a device")
    p.add_argument("--n-devices", type=int, default=None,
                   help="devices of the mesh (default: the world's processes)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="the mesh's model axis: the GPT split over it in transformer training")
    p.add_argument("--seq-parallel", action="store_true",
                   help="transformer training: split the token axis over the model axis too")
    p.add_argument("--fsdp", action="store_true",
                   help="transformer training: split the GPT's parameters and AdamW moments "
                        "over the data axis")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints on a background thread")


def _add_generate(p):
    p.add_argument("--gpt-ckpt", required=True, help="train-transformer run directory")
    p.add_argument("--gpt-which", default="latest")
    p.add_argument("--state-ckpt", default=None, help="train-state run directory (its best)")
    p.add_argument("--stft-ckpt", default=None, help="train-stft run directory (its best)")
    p.add_argument("--n-batches", type=int, default=640)
    p.add_argument("--rec-only", action="store_true", help="reconstructions only, no tokens")
    p.add_argument("--keep-state", action="store_true",
                   help="condition on the whole estimated state stream instead of sampling it")
    p.add_argument("--include-id", action="store_true",
                   help="name the videos by the dataset's vid_id")
    p.add_argument("--serve-int8", action="store_true", help="int8 weights in the decode step")
    p.add_argument("--step-by-step", action="store_true",
                   help="decode and re-encode each frame before its successor's tokens")
    p.add_argument("--gen-from-img", action="store_true",
                   help="each clip from its first frame (the image loader's) alone")
    p.add_argument("--down-size", type=int, default=None,
                   help="degrade the inputs to this size before encoding")
    p.add_argument("--custom-state", action="store_true",
                   help="a square path of states from each clip's estimated first state")
    p.add_argument("--fold", type=int, default=None, help="valid data fold to generate from")
    # the JAX package's one-program decode, which the port does not have: refused
    p.add_argument("--fused", action="store_true", help=argparse.SUPPRESS)


def _config(args):
    from ccvs_tpu_torch.config import Config, get_config

    if args.load_config:
        cfg = Config.load(args.load_config)
    else:
        cfg = get_config(args.preset).replace(save_path="./runs")
    over = {k: v for k, v in (("save_path", args.save_path), ("seed", args.seed),
                              ("name", args.name), ("n_iter", args.n_iter)) if v is not None}
    if over:
        cfg = cfg.replace(**over)
    if args.dataroot:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataroot=args.dataroot))
    if args.grad_accum:
        cfg = cfg.replace(gpt=dataclasses.replace(cfg.gpt, grad_accum=args.grad_accum))
    if getattr(args, "async_ckpt", False):
        cfg = cfg.replace(async_ckpt=True)
    gpt = {k: True for k in ("seq_parallel", "fsdp") if getattr(args, k, False)}
    if gpt:
        cfg = cfg.replace(gpt=dataclasses.replace(cfg.gpt, **gpt))
    return cfg


def _mesh(args):
    """The ``("data", "model")`` mesh of the flags, or None (one process, no
    flags): ``--distributed`` joins torchrun's process group first (the
    counterpart of ``jax.distributed.initialize()``)."""
    import torch.distributed as dist

    if not (args.distributed or args.model_parallel > 1 or (args.n_devices or 0) > 1):
        return None
    from ccvs_tpu_torch.parallel.mesh import init_distributed, make_mesh

    try:
        if args.distributed:
            init_distributed(args.device)
        elif not dist.is_initialized():
            raise RuntimeError(f"--n-devices {args.n_devices} / --model-parallel "
                               f"{args.model_parallel} without --distributed: one process "
                               "drives one device; start one a device under torchrun")
        return make_mesh(args.n_devices, model_parallel=args.model_parallel,
                         device=args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"data-parallel run: {e}")


def _load_module(module, ckpt_dir, label, which="latest"):
    """``module`` with the parameters of a simple trainer's checkpoint."""
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    module.load_state_dict(CheckpointManager(ckpt_dir).load(label, which)["params"])
    return module


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ccvs_tpu_torch")
    sub = parser.add_subparsers(dest="task", required=True)
    for task in ("train-ae", "train-transformer", "train-state", "train-stft", "generate"):
        p = sub.add_parser(task)
        _add_common(p)
        if task in ("train-transformer", "train-state", "generate"):
            p.add_argument("--ae-ckpt", required=True)
            p.add_argument("--ae-which", default="latest")
            p.add_argument("--ae-raw", action="store_true",
                           help="the raw generator's weights instead of the EMA's (a short "
                                "run's 0.999 EMA is still mostly its init)")
        if task == "train-transformer":
            p.add_argument("--state-ckpt", default=None,
                           help="train-state run directory, for state conditioning")
            p.add_argument("--stft-ckpt", default=None,
                           help="train-stft run directory, for audio conditioning")
        if task == "generate":
            _add_generate(p)
    for task in ("eval-fvd", "eval-metrics", "eval-all"):
        p = sub.add_parser(task)
        p.add_argument("--real", required=True)
        p.add_argument("--fake", required=True)
        p.add_argument("--i3d-npz", default=None, help="I3D variables (export_i3d)")
        p.add_argument("--vgg-npz", default=None, help="LPIPS VGG (export_lpips or export_vgg)")
        p.add_argument("--chunk", type=int, default=256)
        p.add_argument("--idx", type=int, default=None, help="score this frame alone")
        p.add_argument("--device", default=None, help="default: the current CUDA device")
        if task == "eval-all":
            p.add_argument("--rec", default=None,
                           help="reconstruction directory: adds the rec-vs-real passes")
    args = parser.parse_args(argv)
    if args.task == "generate":
        return _generate(args)
    if args.task.startswith("eval-"):
        return _evaluate(args)
    cfg = _config(args)
    dtype = getattr(torch, args.dtype)
    mesh = _mesh(args)

    if args.task == "train-ae":
        from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer

        tr = FrameAutoencoderTrainer(cfg, vgg_npz=args.vgg_npz, dtype=dtype, device=args.device,
                                     mesh=mesh)
    elif args.task == "train-stft":
        from ccvs_tpu_torch.train.state_trainer import StftAutoencoderTrainer

        tr = StftAutoencoderTrainer(cfg, vgg_npz=args.vgg_npz, device=args.device, mesh=mesh)
    else:
        from ccvs_tpu_torch.train.ae_trainer import load_ae_checkpoint, trainer_device

        device = trainer_device(args.device, mesh)
        ae = load_ae_checkpoint(args.ae_ckpt, args.ae_which, raw=args.ae_raw, dtype=dtype,
                                device=device)
        if args.task == "train-state":
            from ccvs_tpu_torch.train.state_trainer import StateEstimatorTrainer

            tr = StateEstimatorTrainer(cfg, ae, device=device, mesh=mesh)
        else:
            from ccvs_tpu_torch.models import StateModel, StftModel
            from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

            state_model = stft_model = None
            if args.state_ckpt:
                state_model = _load_module(StateModel(cfg.state, device=device),
                                           args.state_ckpt, "state")
            if args.stft_ckpt:
                stft_model = _load_module(StftModel(cfg.stft, device=device),
                                          args.stft_ckpt, "stft")
            if cfg.gpt.state and state_model is None and stft_model is None:
                raise SystemExit("a state-conditioned GPT needs --state-ckpt (or --stft-ckpt)")
            tr = TransformerTrainer(cfg, ae, state_model=state_model, stft_model=stft_model,
                                    dtype=dtype, device=device, mesh=mesh)
    tr.run(resume=args.resume)
    if tr.preempted:
        sys.exit(75)


def _load_dir(path, unit=False):
    """The ``.avi`` / ``.mp4`` clips of ``path`` in name order, ``(N, T, H, W,
    3)`` fp32 in [0, 1] with ``unit``, else in [-1, 1]."""
    from ccvs_tpu_torch.utils.video_io import read_video

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.endswith((".avi", ".mp4")))
    vids = np.stack([read_video(f) for f in files]).astype(np.float32) / 255.0
    return vids if unit else vids * 2 - 1


def _evaluate(args):
    """``eval-fvd``, ``eval-metrics`` and ``eval-all``: one JSON line on
    stdout; ``eval-all`` also prints each pass's seconds on stderr."""
    from ccvs_tpu_torch.device import resolve_device
    from ccvs_tpu_torch.eval import fvd as fvd_mod
    from ccvs_tpu_torch.eval.metrics import video_metrics

    device = resolve_device(args.device)
    if args.task == "eval-fvd":
        real, fake = _load_dir(args.real), _load_dir(args.fake)
        n = min(len(real), len(fake))
        out = fvd_mod.fvd_from_videos(real[:n], fake[:n], i3d_npz=args.i3d_npz,
                                      chunk=args.chunk, device=device)
    elif args.task == "eval-metrics":
        real, fake = _load_dir(args.real, unit=True), _load_dir(args.fake, unit=True)
        n = min(len(real), len(fake))
        out = video_metrics(real[:n], fake[:n], per_timestep=args.idx, vgg_npz=args.vgg_npz,
                            device=device)
    else:
        # one process scores every pass with one embedder and one LPIPS VGG
        times = {}
        t0 = time.perf_counter()
        real, fake = _load_dir(args.real, unit=True), _load_dir(args.fake, unit=True)
        rec = _load_dir(args.rec, unit=True) if args.rec else None
        times["load"] = time.perf_counter() - t0
        if args.i3d_npz:
            embed, calib = fvd_mod.make_i3d_embedder(args.i3d_npz, device=device), True
        else:
            print(fvd_mod._UNCAL_WARNING, file=sys.stderr)
            embed, calib = fvd_mod.make_fallback_embedder(device=device), False
        out = {}
        passes = [("fake", fake)] + ([("rec", rec)] if rec is not None else [])
        for name, other in passes:
            m = min(len(real), len(other))
            t0 = time.perf_counter()
            out[f"fvd_{name}_vs_real"] = fvd_mod.fvd_from_videos(
                real[:m] * 2 - 1, other[:m] * 2 - 1, embed=embed, chunk=args.chunk,
                calibrated=calib)
            times[f"fvd_{name}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out[f"metrics_{name}_vs_real"] = video_metrics(
                real[:m], other[:m], per_timestep=args.idx, vgg_npz=args.vgg_npz, device=device)
            times[f"metrics_{name}"] = time.perf_counter() - t0
        print("eval-all seconds: " + json.dumps(times), file=sys.stderr)
    print(json.dumps(out))
    return out


def _generate(args):
    """``generate``: batches of the valid split through
    :class:`~ccvs_tpu_torch.generate.VideoGenerator`, written as AVIs.
    Returns the results directory and each batch's seconds of generation
    and of writing."""
    from ccvs_tpu_torch.data import PrefetchLoader, create_dataset
    from ccvs_tpu_torch.generate import VideoGenerator
    from ccvs_tpu_torch.models import StateModel, StftModel, TokenTransformer
    from ccvs_tpu_torch.parallel.mesh import DataAxis, host_local_rows
    from ccvs_tpu_torch.train.ae_trainer import host_shard, load_ae_checkpoint, trainer_device

    if args.fused:
        raise SystemExit("--fused (the JAX package's one-program decode) has no counterpart in "
                         "the port; run without it")
    cfg = _config(args)
    if args.serve_int8:
        cfg = cfg.replace(gpt=dataclasses.replace(cfg.gpt, serve_int8=True))
    # data-parallel generation: each process generates its block of every
    # batch and writes those clips, named by their global index
    mesh = _mesh(args)
    gen_batch = cfg.data.batch_size_vid * cfg.data.batch_size_valid_mult
    n_data = 1 if mesh is None else mesh["data"].size()
    if gen_batch % n_data:
        raise SystemExit(f"the data axis {n_data} must divide batch_size_vid x "
                         f"batch_size_valid_mult = {gen_batch}")
    device = trainer_device(args.device, mesh)
    dtype = getattr(torch, args.dtype)

    ae = load_ae_checkpoint(args.ae_ckpt, args.ae_which, raw=args.ae_raw, dtype=dtype,
                            device=device)
    tr = _load_module(TokenTransformer(cfg.gpt, dtype=dtype, device=device), args.gpt_ckpt,
                      "transformer", args.gpt_which)
    state_model = stft_model = None
    if args.state_ckpt:
        state_model = _load_module(StateModel(cfg.state, device=device), args.state_ckpt,
                                   "state", "best")
    if args.stft_ckpt:
        stft_model = _load_module(StftModel(cfg.stft, device=device), args.stft_ckpt, "stft",
                                  "best")
    gen = VideoGenerator(cfg, ae, tr, state_model, stft_model)
    ds = create_dataset(cfg.data, phase="valid", load_vid=not args.gen_from_img, fold=args.fold)
    loader = PrefetchLoader(ds, gen_batch, shuffle=cfg.data.shuffle_valid,
                            num_workers=cfg.data.num_workers, drop_last=True,
                            host_shard=host_shard(mesh) if mesh is not None else None)
    result_path = os.path.join(cfg.save_path, "results", cfg.name)
    # one stream for every batch, the same on every data rank: each draw is
    # made at the global batch's rows and a rank keeps its own, so N processes
    # write what one process writes (it is not the JAX package's stream)
    tr.data_axis = DataAxis.of(mesh)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    seconds = {"generate": [], "write": []}
    it = iter(loader)
    for i in range(args.n_batches):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        if args.gen_from_img and "img" in batch:
            img = batch.pop("img")  # the image loader's frame is a 1-frame context
            batch["vid"] = img[:, None] if img.ndim == 4 else img[:, :1]
        dev = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
               for k in ("vid", "stft", "vid_lbl", "layout") if k in batch}
        if "vid_lbl" in dev:
            dev["vid_lbl"] = dev["vid_lbl"].long()
        vid = dev["vid"]
        t0 = time.perf_counter()
        if args.step_by_step:
            out = gen.generate_step_by_step(vid, generator)
        elif args.gen_from_img:
            out = gen.generate_from_image(vid[:, 0], generator, vid_len=cfg.data.vid_len,
                                          down_size=args.down_size)
        else:
            custom = None
            if args.custom_state and state_model is not None:
                custom = gen.custom_square_state(vid)
            out = gen.generate(vid, generator, stft=dev.get("stft"), vid_lbl=dev.get("vid_lbl"),
                               layout=dev.get("layout"), rec=True, fake=not args.rec_only,
                               keep_state=args.keep_state, custom_state=custom,
                               down_size=args.down_size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_gen = time.perf_counter() - t0
        cats = None  # category suffixes of class-conditional runs
        if cfg.gpt.cat and cfg.data.categories:
            lbl = batch.get("vid_lbl", out.get("vid_lbl"))
            if lbl is not None:
                lbl = lbl.cpu().numpy() if isinstance(lbl, torch.Tensor) else np.asarray(lbl)
                cats = [cfg.data.categories[int(x)] for x in lbl]
        t0 = time.perf_counter()
        ids = batch.get("vid_id") if args.include_id else None
        if mesh is not None and ids is None:
            vid, row_ids = host_local_rows(vid, mesh)
            ids = gen_batch * i + row_ids
        gen.save_batch(result_path, i, gen_batch, vid, out, fps=cfg.data.fps,
                       imagenet_norm=cfg.data.imagenet_norm, vid_ids=ids, cats=cats)
        seconds["generate"].append(t_gen)
        seconds["write"].append(time.perf_counter() - t0)
        print(f"batch {i}: generated in {t_gen:.3f} s, written in {seconds['write'][-1]:.3f} s",
              flush=True)
    print(f"wrote results to {result_path}")
    return {"path": result_path, "seconds": seconds}


if __name__ == "__main__":
    main()
