"""Configuration of the port: its own copy of the parts of
``ccvs_tpu/config.py`` that the serving path reads (the autoencoder and
transformer groups and the BAIR-256 preset, ``config.py:470-540`` there).

Fields keep the JAX package's names and defaults. Only the fields the serving
path reads are here: the options no preset sets (``no_corr``, ``skip_rgb``,
``keep_first``, ...), the conditioning modes (state, p2p, class labels,
audio, layouts), int8 serving and the training options come with the slices
that need them.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AutoencoderConfig:
    """Frame autoencoder (reference ``options.py:157-266``, prefix ``q_``)."""

    necf: int = 128
    necf_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    z_size: int = 512
    z_num: int = 1024
    z_shape: Tuple[int, int] = (8, 8)
    max_dim: int = 256
    # context ("inter") features: this share of the channels at each resolution
    inter_p: float = 0.75
    skip_context: Tuple[int, ...] = tuple(range(1, 16))
    skip_memory: int = 15

    @property
    def num_resolutions(self) -> int:
        return len(self.necf_mult)

    @property
    def enc_channels(self) -> Tuple[int, ...]:
        return tuple(self.necf * m for m in self.necf_mult)

    @property
    def inter_sizes_enc(self) -> Tuple[int, ...]:
        return tuple(int(self.inter_p * c) for c in self.enc_channels)

    @property
    def dec_channels(self) -> Tuple[int, ...]:
        return tuple(self.necf * m for m in reversed(self.necf_mult))

    @property
    def inter_sizes_dec(self) -> Tuple[int, ...]:
        return tuple(int(self.inter_p * c) for c in self.dec_channels)

    @property
    def tokens_per_frame(self) -> int:
        return self.z_shape[0] * self.z_shape[1]


@dataclass(frozen=True)
class TransformerConfig:
    """Latent transformer (reference ``options.py:268-347``, prefix ``x_``),
    with ``emb_mode="temporal"`` positional embeddings."""

    z_num: int = 1024  # vocabulary
    z_len: int = 1024  # window capacity in tokens
    num_blocks: int = 16
    cond_len: int = 64
    n_layer: int = 24
    n_head: int = 16
    n_embd: int = 1024
    z_shape: Tuple[int, int] = (8, 8)

    # sampling
    sample: bool = True
    temperature: float = 1.0
    top_k: Optional[int] = 100

    @property
    def size(self) -> int:
        return self.z_shape[0] * self.z_shape[1]


@dataclass(frozen=True)
class Config:
    name: str = "experiment"
    ae: AutoencoderConfig = field(default_factory=AutoencoderConfig)
    gpt: TransformerConfig = field(default_factory=TransformerConfig)


def _bair_ae() -> AutoencoderConfig:
    # scripts/bairhd/train_frame_autoencoder.sh
    return AutoencoderConfig(
        necf=128,
        necf_mult=(1, 1, 2, 2, 4, 4),
        z_size=512,
        z_num=1024,
        z_shape=(8, 8),
        max_dim=256,
        inter_p=0.75,
        skip_context=tuple(range(1, 16)),
        skip_memory=15,
    )


def bairhd_config(name: str = "bairhd") -> Config:
    """BAIR robot pushing at 256x256 (scripts/bairhd/*.sh)."""
    return Config(
        name=name,
        ae=_bair_ae(),
        gpt=TransformerConfig(
            z_num=1024,
            z_len=1024,
            cond_len=64,
            n_layer=24,
            n_head=16,
            n_embd=1024,
            z_shape=(8, 8),
            num_blocks=16,
            top_k=100,
        ),
    )
