"""VQ bottleneck (counterpart of ``ccvs_tpu/nn/quantizer.py``).

Serving only: the commitment loss and perplexity come with the training slice.
"""

import torch
from torch import nn

from ccvs_tpu_torch.ops.vq import vq_embed, vq_lookup_auto


class VectorQuantizer(nn.Module):
    def __init__(self, n_e, e_dim):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_e, e_dim))

    def forward(self, z):
        """Quantize channel-last latents ``(..., e_dim)`` -> ``(z_q, indices)``
        (nearest-code search through kernel K1 on CUDA)."""
        z_q, idx = vq_lookup_auto(z, self.embedding)
        # the straight-through value z + (z_q - z), as the JAX package computes it
        return z + (z_q.to(z.dtype) - z), idx

    def embed_code(self, code):
        """Indices -> embeddings."""
        return vq_embed(code, self.embedding)
