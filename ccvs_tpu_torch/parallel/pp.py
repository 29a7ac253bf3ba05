"""Pipeline parallelism of the GPT's block stack over a mesh's ``model`` axis
(counterpart of ``ccvs_tpu/parallel/pp.py``; scaling headroom, like TP and
SP: the reference is data-parallel only).

A GPipe schedule: stage ``s`` of ``S`` holds blocks ``[s L / S, (s + 1) L /
S)``; the batch is cut into ``n_micro`` microbatches, and at tick ``t``
stage 0 takes microbatch ``t``, every stage runs its blocks on what it
holds, and the activations move one stage on. After ``n_micro + S - 1``
ticks the last stage has produced every microbatch (the other ticks compute
the bubble, whose results are dropped). The move is an all-gather over
``model`` of which each stage keeps its predecessor's entry (the JAX
package's ``ppermute``), differentiable, so the backward pass runs the
pipeline in reverse. The last stage's outputs are broadcast to every stage:
the result, and what the caller computes from it, is replicated over
``model``; each stage ends with the gradients of its own blocks and the
input's gradient.
"""

import torch
import torch.distributed as dist

from ccvs_tpu_torch.parallel.mesh import all_gather_cat
from ccvs_tpu_torch.parallel.tp import copy_to_model


def stage_block_specs(n_layer, n_stages):
    """``[range(first, end)]``: the block indices of each stage."""
    if n_layer % n_stages:
        raise ValueError(f"{n_stages} stages must divide {n_layer} layers")
    k = n_layer // n_stages
    return [range(s * k, (s + 1) * k) for s in range(n_stages)]


def shard_stage_params(mesh, core):
    """Keep only this stage's blocks of ``core`` (a ``GPTCore``) on its
    device: the others move to the ``meta`` device (no storage). Returns
    this stage's block indices."""
    sub = mesh["model"]
    mine = stage_block_specs(len(core.blocks), sub.size())[sub.get_local_rank()]
    for i, block in enumerate(core.blocks):
        if i not in mine:
            block.to("meta")
    return mine


class _FromLastStage(torch.autograd.Function):
    """Broadcast from ``src`` forward; backward, the gradient stays on
    ``src`` (every rank computes the same loss of the replicated result, so
    ``src``'s gradient is the whole gradient)."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.is_src = dist.get_rank() == src
        y = x.contiguous().clone()
        dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None


def pipeline_blocks(core, emb, mesh, n_micro):
    """GPipe forward of ``core``'s blocks: ``emb`` ``(B, T, D)``, the same
    on every stage, -> ``(B, T, D)`` on every stage. Differentiable; the
    blocks run cache-free, as in training."""
    sub = mesh["model"]
    group, s, n_st = sub.get_group(), sub.get_local_rank(), sub.size()
    mine = stage_block_specs(len(core.blocks), n_st)[s]
    b = emb.shape[0]
    if b % n_micro:
        raise ValueError(f"{n_micro} microbatches must divide the batch {b}")
    xs = copy_to_model(emb, group).reshape(n_micro, b // n_micro, *emb.shape[1:])
    first = torch.tensor(s == 0, device=emb.device)
    carry = torch.zeros_like(xs[0])
    outs = []
    for tick in range(n_micro + n_st - 1):
        a = torch.where(first, xs[min(tick, n_micro - 1)], carry)
        for i in mine:
            a = core.blocks[i](a)
        outs.append(a)
        # stage s takes stage s - 1's output for the next tick
        carry = all_gather_cat(a[None], group)[(s - 1) % n_st]
    last = torch.stack(outs[n_st - 1:])
    src = dist.get_global_rank(group, n_st - 1)
    return _FromLastStage.apply(last, src, group).reshape(emb.shape)


def pipeline_core(core, emb, mesh, n_micro):
    """:func:`pipeline_blocks` and the final LayerNorm: ``GPTCore``'s
    cache-free forward, pipelined."""
    return core.ln_f(pipeline_blocks(core, emb, mesh, n_micro))
