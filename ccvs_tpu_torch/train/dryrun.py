"""Multi-device dry run (counterpart of ``ccvs_tpu/train/dryrun.py``): the
training steps on tiny shapes over a device mesh, one process a device.

- one data-parallel autoencoder iteration on 8x8 images: the image and
  video G and D steps and the image R1 step;
- one data-parallel transformer step;
- the same step under FSDP: its ``nll`` within 1e-3 of the data-parallel
  one, its parameters still split afterwards;
- with at least 4 processes, on a model axis of 2: the transformer step
  under tensor and under sequence parallelism (the same ``nll`` within
  1e-3), and a GPipe pipeline of the GPT core within 1e-4 of the core.

Run::

    torchrun --nproc-per-node N -m ccvs_tpu_torch.train.dryrun [--device cpu]
"""

import argparse
import copy
import dataclasses

import numpy as np
import torch

from ccvs_tpu_torch.config import AutoencoderConfig, TransformerConfig
from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
from ccvs_tpu_torch.models.transformer import TokenTransformer
from ccvs_tpu_torch.nn.discriminators import ImageDiscriminator, VideoDiscriminator
from ccvs_tpu_torch.nn.gpt import GPTCore
from ccvs_tpu_torch.nn.layers import init_equalized
from ccvs_tpu_torch.parallel.fsdp import local_fraction
from ccvs_tpu_torch.parallel.mesh import (DataAxis, init_distributed, make_mesh, mesh_device,
                                          shard_batch)
from ccvs_tpu_torch.parallel.pp import pipeline_core, shard_stage_params
from ccvs_tpu_torch.parallel.tp import shard_gpt_params
from ccvs_tpu_torch.train.ae_losses import AELosses
from ccvs_tpu_torch.train.steps import make_ae_steps, make_transformer_step

AE_CFG = AutoencoderConfig(
    necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2),
    z_size=16, z_num=32, z_shape=(4, 4), max_dim=8,
    inter_p=0.5, skip_memory=2, skip_context=(1, 2),
    use_di=True, use_dv=True, use_vgg_img=False, use_vgg_vid=False,
    use_direct_recovery_img=True, use_direct_recovery_vid=True,
    slide_inter=True, n_consecutive_img=2, vid_len=3,
    load_elastic_view=False, elastic_corruption=False, d_reg_every=2,
    stddev_group=2,
)
GPT_CFG = TransformerConfig(
    z_num=32, z_len=32, z_chunk=16, num_blocks=2, cond_len=16,
    n_layer=2, n_head=2, n_embd=32, z_shape=(4, 4), emb_mode="temporal",
)


def _global(seed, shape, low=-1.0, high=1.0):
    """A seeded global batch (the same on every rank), fp32 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * (high - low) + low


def _transformer_nll(cfg, mesh, code, dev, tp=False):
    tr = TokenTransformer(cfg, dtype=torch.float32, device=dev).init(0)
    if tp:
        shard_gpt_params(mesh, tr.model)
    init, step = make_transformer_step(tr, cfg, n_iter=10, mesh=mesh)
    state, m = step(init(), {"code": shard_batch(mesh, code).to(dev)})
    return float(m["nll"]), tr


def run_tiny_multichip_step(mesh) -> str:
    """The dry run over ``mesh`` (``parallel.mesh.make_mesh``); returns (and
    prints) its ``dryrun_multichip ok: ...`` line."""
    dev = mesh_device(mesh)
    n_data = mesh["data"].size()
    world = n_data * mesh["model"].size()

    ae = FrameAutoencoder(AE_CFG, dtype=torch.float32, device=dev)
    ae.init(0)
    with dev:
        di = ImageDiscriminator(AE_CFG)
        dv = VideoDiscriminator(AE_CFG, AE_CFG.vid_len)
    g = torch.Generator(device=dev).manual_seed(1)
    init_equalized(di, g)
    init_equalized(dv, g)
    init_state, g_step, d_step, r1_step = make_ae_steps(AELosses(AE_CFG, ae, di, dv),
                                                        data_axis=DataAxis.of(mesh))
    state = init_state()
    bsz = 2 * n_data
    img = {"img": shard_batch(mesh, _global(0, (bsz * 2, 8, 8, 3))).to(dev)}
    vid = {"vid": shard_batch(mesh, _global(1, (bsz, AE_CFG.vid_len, 8, 8, 3))).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(1)
    state, gm, fake = g_step(state, img, "img", gen)
    state, dm = d_step(state, img, fake, "img", gen)
    state, rm = r1_step(state, img, "img", gen)
    state, gmv, fakev = g_step(state, vid, "vid", gen)
    state, dmv = d_step(state, vid, fakev, "vid", gen)
    for v in (gm["g_loss"], dm["d_loss"], rm["r1_img"], gmv["g_loss"], dmv["d_loss"]):
        assert torch.isfinite(v), "dryrun: a loss of the autoencoder's steps is not finite"

    code = torch.randint(0, GPT_CFG.z_num, (n_data * 2, GPT_CFG.z_len),
                         generator=torch.Generator().manual_seed(0))
    nll, _ = _transformer_nll(GPT_CFG, mesh, code, dev)
    assert np.isfinite(nll)
    nll_fsdp, tr = _transformer_nll(dataclasses.replace(GPT_CFG, fsdp=True), mesh, code, dev)
    assert abs(nll_fsdp - nll) < 1e-3, (nll_fsdp, nll)
    biggest = max(tr.parameters(), key=lambda p: p.numel())
    assert local_fraction(biggest) <= 1.0 / n_data + 1e-9 and hasattr(biggest, "placements"), \
        "fsdp dryrun: the parameters did not stay split"

    line = (f"dryrun_multichip ok: mesh={{'data': {n_data}, 'model': {mesh['model'].size()}}} "
            f"g={float(gm['g_loss']):.3f} d={float(dm['d_loss']):.3f} "
            f"gv={float(gmv['g_loss']):.3f} nll={nll:.3f} nll_fsdp={nll_fsdp:.3f}")
    if world % 2 == 0 and world >= 4:
        mesh_tp = make_mesh(world, model_parallel=2)
        code_tp = torch.randint(0, GPT_CFG.z_num, (mesh_tp["data"].size() * 2, GPT_CFG.z_len),
                                generator=torch.Generator().manual_seed(1))
        nll_tp, _ = _transformer_nll(GPT_CFG, mesh_tp, code_tp, dev, tp=True)
        nll_sp, _ = _transformer_nll(dataclasses.replace(GPT_CFG, seq_parallel=True), mesh_tp,
                                     code_tp, dev)
        assert np.isfinite(nll_tp) and abs(nll_sp - nll_tp) < 1e-3, (nll_sp, nll_tp)

        core = GPTCore(GPT_CFG).to(dev)
        emb = shard_batch(mesh_tp, _global(2, (2 * mesh_tp["data"].size(), 8, GPT_CFG.n_embd)))
        emb = emb.to(dev)
        with torch.no_grad():
            gp = torch.Generator(device=dev).manual_seed(3)
            for p in core.parameters():
                p.normal_(0.0, 0.1, generator=gp)
            ref = core(emb)
            staged = copy.deepcopy(core)
            shard_stage_params(mesh_tp, staged)
            out = pipeline_core(staged, emb, mesh_tp, n_micro=2)
        err = float((out - ref).abs().max())
        assert err < 1e-4, err
        line += f" nll_dpxtp={nll_tp:.3f} nll_dpxsp={nll_sp:.3f} pp2=ok (tp=sp=pp=2)"
    print(line, flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(prog="ccvs_tpu_torch.train.dryrun")
    p.add_argument("--device", default=None, help="cpu: gloo on the CPU (default: NCCL, GPUs)")
    args = p.parse_args(argv)
    import torch.distributed as dist

    init_distributed(args.device)
    try:
        run_tiny_multichip_step(make_mesh(device=args.device))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
