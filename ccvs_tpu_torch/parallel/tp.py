"""Tensor parallelism of the GPT over a mesh's ``model`` axis (counterpart of
``ccvs_tpu/parallel/tp.py``): Megatron's head and MLP split, and
:class:`MeshSplit`, the one object that says how a GPT is split over a mesh.

``query`` / ``key`` / ``value`` / ``fc1`` are split on their output (each
rank holds ``n_head / n`` heads and ``4 D / n`` hidden units), ``proj`` /
``fc2`` on their input, so each attention and each MLP ends in one
all-reduce of partial sums (done in fp32); their biases are added once,
after it. The inputs of the split layers pass an operator that is the
identity forward and all-reduces the gradient backward (Megatron's ``f``),
the all-reduces are the identity backward (``g``), so every rank holds the
gradient of its own shards and the same gradient of everything replicated.
With sequence parallelism (``parallel/sp.py``) the blocks' activations are
split over the tokens as well (Megatron-SP): the ``f`` / ``g`` pairs become
an all-gather of the tokens before the split layers and a reduce-scatter of
the partial sums back to this rank's tokens.

The GPT calls its linears through ``nn/gpt.py _dense``, which reads the
weights straight into ``F.linear`` and bypasses the modules' forward hooks,
where ``parallelize_module``'s styles act. So the weights are split by hand,
in place (each keeps its name), and ``Block.forward`` itself calls its
``mesh_split`` around the split layers: :meth:`MeshSplit.enter` before the
projections, :meth:`MeshSplit.exit` for ``proj`` and ``fc2``,
:meth:`MeshSplit.keys` before attention. The blocks are still called as
modules, so FSDP's hooks (``parallel/fsdp.py``) wrap them. Only the blocks
of a model split over its model axis hold a split: the cached decode of
every other model runs as before, and a split model refuses a cache.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ccvs_tpu_torch.nn.gpt import _dense
from ccvs_tpu_torch.parallel.mesh import all_gather_cat, reduce_scatter


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """Sum of the model ranks' partial ``x``, computed in fp32."""
    return _ReduceFromModel.apply(x.float(), group).to(x.dtype)


def _tp_dim(name):
    """The dim :func:`shard_gpt_params` splits the GPT's parameter ``name``
    along, or None (replicated)."""
    parts = name.split(".")
    if "blocks" not in parts:
        return None
    layer, leaf = parts[-2], parts[-1]
    if layer in ("query", "key", "value", "fc1"):
        return 0
    if layer in ("proj", "fc2") and leaf == "weight":
        return 1
    return None


def gpt_param_specs(model):
    """``{parameter name: split dim}`` of the GPT's split parameters (names of
    ``model.named_parameters()``): the ``query`` / ``key`` / ``value`` /
    ``fc1`` weights and biases on dim 0 (their output), the ``proj`` /
    ``fc2`` weights on dim 1 (their input). Every other parameter is
    replicated."""
    return {n: d for n, _ in model.named_parameters() if (d := _tp_dim(n)) is not None}


class MeshSplit:
    """How a GPT is split over a mesh: ``tp``, its block weights over the
    model axis (:func:`shard_gpt_params`); ``seq``, its tokens over that axis
    (``parallel/sp.py``); ``fsdp``, its parameters over the data axis
    (``parallel/fsdp.py``). One object: the core's ``mesh_split`` and, once
    the weights or the tokens are split, each block's, whose forward calls
    the methods below."""

    def __init__(self, mesh):
        sub = mesh["model"]
        self.group, self.rank, self.size = sub.get_group(), sub.get_local_rank(), sub.size()
        self.tp = self.seq = self.fsdp = False

    def tp_dim(self, name):
        """The dim the weights' split cuts parameter ``name`` along, or None."""
        return _tp_dim(name) if self.tp else None

    def check(self, block, cache):
        """Refuse what a block split over the model axis cannot run."""
        if cache is not None:
            raise NotImplementedError("a GPT split over a mesh's model axis runs cache-free "
                                      "(training); serve from its whole checkpoint")
        if block.training and (block.resid_pdrop > 0 or block.attn.attn_pdrop > 0
                               or block.resid_noise):
            raise NotImplementedError("dropout and residual noise in a GPT split over a "
                                      "mesh's model axis")

    def enter(self, h):
        """A LayerNorm's output ``h`` as the split layers after it take it:
        with split weights, every token (gathered where the tokens are
        split, else through Megatron's ``f``); else ``h``."""
        if not self.tp:
            return h
        return all_gather_cat(h, self.group, dim=1) if self.seq else copy_to_model(h, self.group)

    def exit(self, layer, y):
        """``layer`` (``proj`` or ``fc2``) of ``y``: with split weights, the
        partial products summed over the model axis in fp32 (reduce-scattered
        back to this rank's tokens where the tokens are split), then the
        bias."""
        if not self.tp:
            return _dense(layer, y)
        y = F.linear(y, layer.weight.to(y.dtype))
        if self.seq:
            y = reduce_scatter(y.float(), self.group, dim=1).to(y.dtype)
        else:
            y = reduce_from_model(y, self.group)
        return y + layer.bias.to(y.dtype)

    def keys(self, k, v):
        """``(k, v, q_offset)`` that attention reads: with the tokens split
        and the weights whole, every rank's keys and values and the position
        of this rank's first query; else ``k``, ``v`` and 0."""
        if self.seq and not self.tp:
            off = self.rank * k.shape[1]
            return all_gather_cat(k, self.group, dim=1), all_gather_cat(v, self.group, dim=1), off
        return k, v, 0

    def core_forward(self, core, emb, generator=None):
        """``GPTCore``'s cache-free forward with the tokens split: this
        rank's ``T / n`` tokens through the blocks (the sequence padded at
        its end to a multiple of ``n``; causal attention never looks at the
        padding), the whole sequence after the final LayerNorm."""
        t = emb.shape[1]
        tl = -(-t // self.size)
        if tl * self.size != t:
            emb = F.pad(emb, (0, 0, 0, tl * self.size - t))
        x = core.run_blocks(emb[:, self.rank * tl:(self.rank + 1) * tl], generator=generator)
        return all_gather_cat(core.ln_f(x), self.group, dim=1)[:, :t]


def mesh_split(mesh, model):
    """The :class:`MeshSplit` of ``model`` (a ``GPT`` / ``CGPT``) over
    ``mesh``, made on the first call."""
    core = model.core
    if core.mesh_split is None:
        core.mesh_split = MeshSplit(mesh)
    return core.mesh_split


def shard_gpt_params(mesh, model):
    """Split ``model``'s (a ``GPT`` / ``CGPT``) block weights over ``mesh``'s
    model axis in place; its blocks then run the split layers through the
    split's collectives. Call it before FSDP and before the optimizer is
    built."""
    split = mesh_split(mesh, model)
    n, r = split.size, split.rank
    if model.cfg.n_head % n:
        raise ValueError(f"tensor parallelism {n} must divide n_head {model.cfg.n_head}")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in gpt_param_specs(model).items():
            params[name].data = params[name].data.chunk(n, dim)[r].clone()
    split.tp = True
    for block in model.core.blocks:
        block.mesh_split = split
    return model
