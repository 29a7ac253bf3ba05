"""Fully sharded data parallelism of the GPT over a mesh's ``data`` axis
(counterpart of ``ccvs_tpu/parallel/fsdp.py``; ``TransformerConfig.fsdp``).

FSDP2 (``torch.distributed.fsdp.fully_shard``) on each GPT block and at the
root: every parameter becomes a DTensor split on its dim 0 over ``data``
(the JAX package splits each large leaf on its largest free divisible
dimension), AdamW's moments follow their parameters, each block's
parameters are all-gathered for its forward and backward and the gradients
reduce-scattered (averaged over ``data``). The optimizer is built on the
split parameters, after :func:`shard_fsdp`.
"""

import torch

from ccvs_tpu_torch.parallel.tp import mesh_split


def fsdp_param_specs(model):
    """``{parameter name: split dim}`` of :func:`shard_fsdp`: dim 0 of every
    parameter of ``model`` (FSDP2 pads the last shard where dim 0 does not
    divide)."""
    return {name: 0 for name, _ in model.named_parameters()}


def shard_fsdp(mesh, model):
    """``fully_shard`` each block of ``model``'s (a ``GPT``) core and the
    whole model over ``mesh``'s data axis, in place (once; a second call
    changes nothing). The blocks are the units of the all-gathers; a block's
    gathered parameters are freed after its forward and gathered again for
    its backward (ZeRO-3)."""
    from torch.distributed.fsdp import fully_shard

    split = mesh_split(mesh, model)
    if split.fsdp:
        return model
    sub = mesh["data"]
    for block in model.core.blocks:
        fully_shard(block, mesh=sub, reshard_after_forward=True)
    fully_shard(model, mesh=sub, reshard_after_forward=True)
    split.fsdp = True
    return model


def local_fraction(p) -> float:
    """The share of ``p``'s entries this rank holds (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        return p.to_local().numel() / max(1, p.numel())
    return 1.0


def tp_split(model, name):
    """``(dim, group)`` of ``model``'s parameter ``name`` where tensor
    parallelism splits it (``parallel/tp.py``), else None. ``model`` is
    the GPT (any other module has no split)."""
    split = getattr(getattr(model, "core", None), "mesh_split", None)
    dim = None if split is None else split.tp_dim(name)
    return None if dim is None else (dim, split.group)


def full_tensor(t, tp=None):
    """The whole of ``t``, a parameter's value or optimizer state: a
    DTensor's full tensor, then, where ``tp`` ``(dim, group)`` says so, the
    all-gather of the tensor-parallel shards along ``dim``. A collective:
    every rank of the groups calls it."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    if tp is None or t.dim() == 0:
        return t
    dim, group = tp
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def split_like(full, p, tp=None):
    """This rank's part of the whole tensor ``full`` in the layout of the
    parameter ``p`` (the reverse of :func:`full_tensor`)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    if full.dim() == 0:
        return full
    if tp is not None:
        dim, group = tp
        full = full.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)]
    if isinstance(p, DTensor):
        return distribute_tensor(full.to(p.device), p.device_mesh, p.placements)
    return full.clone()


def _named_state(tstate):
    """``{state-dict name: (parameter, tp split)}`` of a ``SimpleTrainState``
    of a ``TokenTransformer``."""
    gpt = tstate.params.model
    return {f"model.{n}": (p, tp_split(gpt, n)) for n, p in gpt.named_parameters()}


def _opt_params(opt, named):
    by_id = {id(p): tp for p, tp in named.values()}
    return [] if opt.opt is None else [(p, by_id.get(id(p))) for g in opt.opt.param_groups
                                      for p in g["params"]]


def full_train_state(tstate):
    """``tstate.state_dict()`` (a ``SimpleTrainState`` of a GPT split over a
    mesh) with every split tensor made whole: the checkpoint that one
    process writes. A collective."""
    named = _named_state(tstate)
    sd = tstate.state_dict()
    sd["params"] = {k: full_tensor(v, named[k][1] if k in named else None)
                    for k, v in sd["params"].items()}
    plist = _opt_params(tstate.opt, named)
    opt = dict(sd["opt"])
    if opt.get("opt"):
        inner = dict(opt["opt"])
        inner["state"] = {i: {k: full_tensor(v, plist[i][1]) if torch.is_tensor(v) else v
                              for k, v in st.items()} for i, st in inner["state"].items()}
        opt["opt"] = inner
    sd["opt"] = opt
    return sd


def load_full_train_state(tstate, tree):
    """Load a one-process checkpoint ``tree`` into ``tstate``, whose GPT is
    split over a mesh: each rank takes its part of every tensor."""
    named = _named_state(tstate)
    plist = _opt_params(tstate.opt, named)
    tree = dict(tree)
    tree["params"] = {k: split_like(v, *named[k]) if k in named else v
                      for k, v in tree["params"].items()}
    opt = dict(tree["opt"])
    if opt.get("opt"):
        inner = dict(opt["opt"])
        inner["state"] = {i: {k: split_like(v.to(plist[i][0].device), *plist[i])
                              if torch.is_tensor(v) else v for k, v in st.items()}
                          for i, st in inner["state"].items()}
        opt["opt"] = inner
    tree["opt"] = opt
    tstate.load_state_dict(tree)
    return tstate
