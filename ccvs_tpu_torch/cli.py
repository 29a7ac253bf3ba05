"""Command-line entry points of the port's trainers (counterpart of the
``train-*`` subcommands of ``ccvs_tpu/cli.py``).

Usage::

    python -m ccvs_tpu_torch.cli train-ae --preset bairhd [--n-iter N] [--resume]
    python -m ccvs_tpu_torch.cli train-transformer --preset bairhd --ae-ckpt DIR
    python -m ccvs_tpu_torch.cli train-state --preset bairhd_state --ae-ckpt DIR
    python -m ccvs_tpu_torch.cli train-stft --preset drums

``--ae-ckpt`` is the run directory of a ``train-ae`` run (its checkpoints
and ``config.json``); the frozen autoencoder takes its EMA weights unless
``--ae-raw``. Everything runs on the GPU unless ``--device cpu``. A trainer
stopped by SIGTERM or SIGINT writes its latest checkpoint and exits with 75,
so that a wrapper can resume it. Multi-device training (the JAX package's
mesh, ``--distributed``, ``--fsdp``, ``--seq-parallel``) comes with the
parallel layer; generation and evaluation come with their slices.
"""

import argparse
import dataclasses
import sys

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
    return cfg


def _load_module(module, ckpt_dir, label, which="latest"):
    """``module`` with the parameters of a simple trainer's checkpoint."""
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    module.load_state_dict(CheckpointManager(ckpt_dir).load(label, which)["params"])
    return module


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ccvs_tpu_torch")
    sub = parser.add_subparsers(dest="task", required=True)
    for task in ("train-ae", "train-transformer", "train-state", "train-stft"):
        p = sub.add_parser(task)
        _add_common(p)
        if task in ("train-transformer", "train-state"):
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
    args = parser.parse_args(argv)
    cfg = _config(args)
    dtype = getattr(torch, args.dtype)

    if args.task == "train-ae":
        from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer

        tr = FrameAutoencoderTrainer(cfg, vgg_npz=args.vgg_npz, dtype=dtype, device=args.device)
    elif args.task == "train-stft":
        from ccvs_tpu_torch.train.state_trainer import StftAutoencoderTrainer

        tr = StftAutoencoderTrainer(cfg, vgg_npz=args.vgg_npz, device=args.device)
    else:
        from ccvs_tpu_torch.device import resolve_device
        from ccvs_tpu_torch.train.ae_trainer import load_ae_checkpoint

        device = resolve_device(args.device)
        ae = load_ae_checkpoint(args.ae_ckpt, args.ae_which, raw=args.ae_raw, dtype=dtype,
                                device=device)
        if args.task == "train-state":
            from ccvs_tpu_torch.train.state_trainer import StateEstimatorTrainer

            tr = StateEstimatorTrainer(cfg, ae, device=device)
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
                                    dtype=dtype, device=device)
    tr.run(resume=args.resume)
    if tr.preempted:
        sys.exit(75)


if __name__ == "__main__":
    main()
