"""Sequence parallelism of the GPT's training forward over a mesh's
``model`` axis (counterpart of ``ccvs_tpu/parallel/sp.py``, the
Megatron-SP analog; ``TransformerConfig.seq_parallel``).

The token axis of every block activation is split over ``model``: each rank
runs the LayerNorms, the projections, the MLP and the residuals of its
``T / n`` positions (the sequence is padded at its end to a multiple of
``n``; causal attention never looks at the padding), and all-gathers the
keys and values for attention. The final LayerNorm's output is gathered back
to the whole sequence, so the head and the loss see what one device sees.
The parameters are replicated over ``model``; each rank's gradient holds
the contributions of its positions, so a step sums the gradients over
``model`` and backpropagates the loss divided by ``n`` (the gathers' backward
sums the ``n`` ranks' equal gradients of the replicated output). Where the
blocks' weights are split over ``model`` too (``parallel/tp.py``: the JAX
trainer's TP x SP) the blocks gather the tokens instead, and only the
replicated parameters' gradients are summed. The collectives are
``parallel/tp.py``'s :class:`~ccvs_tpu_torch.parallel.tp.MeshSplit`'s.
Cached decode, one token at a time, is never split.
"""

from ccvs_tpu_torch.parallel.tp import mesh_split


def seq_shard(mesh, model):
    """Split the tokens of ``model``'s (a ``GPT`` / ``CGPT``) cache-free
    forward over ``mesh``'s model axis, in place (once; a second call
    changes nothing). Returns the split size ``n`` (the step divides the
    loss it backpropagates by it)."""
    split = mesh_split(mesh, model)
    split.seq = True
    for block in model.core.blocks:
        block.mesh_split = split
    return split.size
