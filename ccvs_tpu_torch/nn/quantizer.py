"""VQ bottleneck (counterpart of ``ccvs_tpu/nn/quantizer.py``).

The nearest-code search is kernel K1 on CUDA (``ops/vq.py vq_indices``); its
indices carry no gradient, the codebook's gradient comes through the gather
and ``z``'s through the straight-through value ``z + sg(z_q - z)``.
"""

import torch
from torch import nn

from ccvs_tpu_torch.ops.vq import vq_embed, vq_lookup_auto, vq_loss, vq_perplexity, vq_st


class VectorQuantizer(nn.Module):
    """``n_e`` codes; ``e_dim`` channels a position, split into ``mult``
    sub-vectors of ``e_dim // mult`` that are quantized each on its own."""

    def __init__(self, n_e, e_dim, beta=0.25, mult=1, normalize=False):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.mult, self.normalize = n_e, e_dim, beta, mult, normalize
        self.embedding = nn.Parameter(torch.empty(n_e, e_dim // mult))

    def _lookup(self, z):
        """``(zf, z_q, indices)``: ``z`` split by ``mult``, its nearest codes
        (normalized with ``normalize``) and their indices."""
        zf = z.reshape(*z.shape[:-1], self.mult, self.e_dim // self.mult) if self.mult > 1 else z
        z_q, idx = vq_lookup_auto(zf, self.embedding)
        if self.normalize:
            z_q = z_q / torch.linalg.vector_norm(z_q.float(), dim=-1, keepdim=True).to(z_q.dtype)
        return zf, z_q, idx

    def _merge(self, z_q, z):
        return z_q.reshape(*z.shape[:-1], self.e_dim) if self.mult > 1 else z_q

    def quantize(self, z):
        """Serving: channel-last latents ``(..., e_dim)`` -> the
        straight-through value and the indices, without the loss and the
        perplexity."""
        zf, z_q, idx = self._lookup(z)
        return self._merge(vq_st(zf, z_q.to(zf.dtype)), z), idx

    def forward(self, z):
        """Training: ``(z_q, loss, (perplexity, indices))``, the JAX package's
        return. ``loss`` is the codebook and commitment loss in fp32 with
        ``beta``."""
        zf, z_q, idx = self._lookup(z)
        loss = vq_loss(zf.float(), z_q.float(), self.beta)
        z_q = self._merge(vq_st(zf, z_q.to(zf.dtype)), z)
        return z_q, loss, (vq_perplexity(idx, self.n_e), idx)

    def embed_code(self, code):
        """Indices -> embeddings."""
        return vq_embed(code, self.embedding, self.mult)
