"""Model wrappers of the port (counterpart of ``ccvs_tpu/models``)."""

from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
from ccvs_tpu_torch.models.state_model import StateModel
from ccvs_tpu_torch.models.stft_model import StftModel
from ccvs_tpu_torch.models.transformer import ContinuousTransformer, TokenTransformer

__all__ = ["ContinuousTransformer", "FrameAutoencoder", "StateModel", "StftModel",
           "TokenTransformer"]
