"""Model wrappers of the port (counterpart of ``ccvs_tpu/models``)."""

from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
from ccvs_tpu_torch.models.transformer import TokenTransformer

__all__ = ["FrameAutoencoder", "TokenTransformer"]
