"""Configuration of the port: its own copy of the parts of
``ccvs_tpu/config.py`` that the serving paths read (the autoencoder,
transformer and state groups, and the BAIR-256, Kinetics-600 and UCF-101
presets with their state-conditioned, point-to-point and unconditional
variants, ``config.py:470-640`` there).

Fields keep the JAX package's names and defaults. Only the fields the serving
paths read are here: the options no preset sets (``no_corr``, ``skip_rgb``,
``keep_first``, ...), the class-label, audio, deblurring and layout modes,
beam search and the training options come with the slices that need them.
"""

import dataclasses
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
    z_chunk: int = 64  # tokens added per slide of the window
    num_blocks: int = 16
    cond_len: int = 64
    n_layer: int = 24
    n_head: int = 16
    n_embd: int = 1024
    z_shape: Tuple[int, int] = (8, 8)

    # conditioning modes
    p2p: bool = False  # the end frame's tokens are a prefix ("point to point")
    state: bool = False
    state_front: bool = False  # all state tokens before the frame tokens
    state_num: int = 0  # state vocabulary
    state_size: int = 0  # state tokens per frame
    use_start_token: bool = False

    # sampling
    sample: bool = True
    temperature: float = 1.0
    top_k: Optional[int] = 100
    sample_state: bool = False
    temperature_state: float = 1.0
    top_k_state: Optional[int] = None

    # int8 weights and activations in the decode step (nn/quantized.py)
    serve_int8: bool = False

    @property
    def size(self) -> int:
        return self.z_shape[0] * self.z_shape[1]

    @property
    def tot_size(self) -> int:
        return self.size + self.state_size


@dataclass(frozen=True)
class StateConfig:
    """State estimator (reference ``options.py:349-372``, prefix ``s_``)."""

    z_size: int = 512
    z_shape: Tuple[int, int] = (8, 8)
    state_hsize: int = 128
    state_size: int = 2
    state_num: int = 128


@dataclass(frozen=True)
class Config:
    name: str = "experiment"
    ae: AutoencoderConfig = field(default_factory=AutoencoderConfig)
    gpt: TransformerConfig = field(default_factory=TransformerConfig)
    state: StateConfig = field(default_factory=StateConfig)


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
        state=StateConfig(state_size=2, state_num=128),
    )


def bairhd_state_config() -> Config:
    """State-conditioned BAIR (scripts/bairhd/train_transformer_state.sh): two
    state tokens (the arm's x and y) before each frame's 64."""
    c = bairhd_config("bairhd_state")
    return dataclasses.replace(c, gpt=dataclasses.replace(
        c.gpt, z_len=1056, z_chunk=66, state=True, state_num=128, state_size=2,
        sample_state=True, top_k_state=10))


def bairhd_p2p_config() -> Config:
    """Point-to-point BAIR (scripts/bairhd/train_transformer_p2p.sh): the end
    frame's tokens are a prefix of the window."""
    c = bairhd_config("bairhd_p2p")
    return dataclasses.replace(c, gpt=dataclasses.replace(c.gpt, p2p=True))


def bairhd_unc_config() -> Config:
    """Unconditional BAIR (scripts/bairhd/train_transformer_unc.sh): a start
    token and no context frame."""
    c = bairhd_config("bairhd_unc")
    return dataclasses.replace(c, gpt=dataclasses.replace(c.gpt, use_start_token=True,
                                                          cond_len=0))


def kinetics_config() -> Config:
    """Kinetics-600 prediction at 64x64 (scripts/kinetics/*.sh): 16-frame
    clips continued from 5 context frames (``cond_len`` 320 = 5 x 64)."""
    return Config(
        name="kinetics600",
        ae=AutoencoderConfig(
            necf=64,
            necf_mult=(1, 2, 4, 8),
            z_size=256,
            z_num=16384,
            z_shape=(8, 8),
            max_dim=64,
            inter_p=0.75,
            skip_context=tuple(range(1, 16)),
            skip_memory=15,
        ),
        gpt=TransformerConfig(
            z_num=16384,
            z_len=1280,
            cond_len=320,
            n_layer=24,
            n_head=16,
            n_embd=1024,
            num_blocks=20,
            top_k=100,
        ),
    )


def kinetics_p2p_config() -> Config:
    """Point-to-point Kinetics-600 (scripts/kinetics/save_videos_p2p.sh:
    --x_p2p --p2p_len 16 --x_z_len 1024 --x_z_chunk 64)."""
    c = kinetics_config()
    return dataclasses.replace(c, name="kinetics600_p2p", gpt=dataclasses.replace(
        c.gpt, p2p=True, z_len=1024, num_blocks=16, cond_len=64))


def ucf101_config() -> Config:
    """UCF-101 at 256x256 (scripts/ucf101/*.sh): BAIR-256's model; the
    presets differ only in their data, which the port does not read."""
    return bairhd_config("ucf101")
