"""Configuration of the port: its own copy of the parts of
``ccvs_tpu/config.py`` that the serving paths and the trainers read (the
data, autoencoder, transformer, state and STFT groups, and every preset:
BAIR-256 with its state-conditioned, point-to-point and unconditional
variants, Kinetics-600, UCF-101 and the audio-conditioned drums,
``config.py:470-696`` there).

Fields keep the JAX package's names and defaults. Only the fields the port
reads are here, and the data group whole; :data:`JAX_ONLY_DEFAULTS` lists
the others, which load only at the JAX package's defaults.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Base and data options (reference ``options.py:34-155``), copied whole;
    serving reads ``vid_len`` (:meth:`VideoGenerator.generate_from_image`)."""

    name: str = "experiment"
    dataset: str = "bairhd"
    dataroot: str = "datasets/bairhd"
    phase: str = "train"

    # resolution
    max_dim: int = 256
    true_dim: int = 256
    aspect_ratio: float = 1.0
    imagenet_norm: bool = False

    # clips
    vid_len: int = 16
    p2p_len: Optional[int] = None
    load_vid_len: Optional[int] = None
    max_vid_step: int = 1000
    vid_skip: int = 1
    one_every_n: int = 1
    fps: int = 4
    from_vid: bool = False
    is_seq: bool = True

    # batching
    batch_size_img: int = 1
    batch_size_vid: int = 1
    # validation/generation batches are this multiple of the train batch
    # (reference `--batch_size_valid_mult`, `options.py:55`, applied at
    # `helpers/generator.py:240` / `transformer_trainer.py:99`)
    batch_size_valid_mult: int = 1
    # shuffle the validation split too (reference `--shuffle_valid`,
    # `options.py:91`; the shipped save_videos scripts pass it)
    shuffle_valid: bool = True
    n_consecutive_img: int = 1
    img_out_of_n: int = 1

    # augmentation
    no_h_flip: bool = True
    no_v_flip: bool = True
    min_zoom: float = 1.0
    max_zoom: float = 1.0
    colorjitter: Optional[float] = None
    resize_center_crop_img: Optional[int] = None

    # elastic-view self-supervision (reference `data/augmentations.py`)
    load_elastic_view: bool = False
    elastic_alpha: float = 1.5
    elastic_sigma: float = 0.15
    elastic_min_zoom: float = 1.0
    elastic_max_zoom: float = 1.0
    elastic_occlusion: bool = False
    elastic_corruption: bool = False
    elastic_mean_corruption: float = 0.5
    distort_first: bool = False
    blur_first: Optional[Tuple[float, float]] = None

    # folds (large datasets are indexed fold by fold, reference
    # options.py:72-76)
    num_folds_train: Optional[int] = None
    init_fold_train: int = 0
    # pick a random fold per cycle instead of round-robin (reference
    # --random_fold_train, set by the shipped kinetics scripts;
    # `helpers/frame_autoencoder_trainer.py:108`)
    random_fold_train: bool = False

    # state / audio
    load_state: bool = False
    categories: Optional[Tuple[str, ...]] = None

    # layout twins: load per-frame segmentations alongside frames (reference
    # keys off `vid_layout_paths` in the dataset metadata,
    # `base_dataset.py:245-273`; this flag drives the synthetic dataset)
    load_layout: bool = False

    num_workers: int = 8

    @property
    def height(self) -> int:
        return self.max_dim

    @property
    def width(self) -> int:
        return int(self.max_dim * self.aspect_ratio)


@dataclass(frozen=True)
class AutoencoderConfig:
    """Frame autoencoder (reference ``options.py:157-266``, prefix ``q_``)."""

    necf: int = 128
    necf_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    z_size: int = 512
    z_num: int = 1024
    z_shape: Tuple[int, int] = (8, 8)
    max_dim: int = 256
    # each latent position is ``z_mult`` sub-vectors of ``z_size // z_mult``
    # channels, quantized each on its own
    z_mult: int = 1
    # the encoder's latent, and each quantized code, divided by its channel norm
    normalize_out: bool = False
    # the image and video G losses take the encoder's fp32 latent as it is:
    # no quantizer and no quantization loss (the latent that feeds a
    # continuous GPT)
    is_continuous: bool = False
    # frames are max_dim x int(max_dim * aspect_ratio); z_shape is the
    # user's to match (e.g. (8, 16) at 2)
    aspect_ratio: float = 1.0
    # context ("inter") features: this share of the channels at each resolution
    inter_p: float = 0.75
    skip_context: Tuple[int, ...] = tuple(range(1, 16))
    skip_memory: int = 15

    # the decoder's flow module (nn/decoder.py): False builds no InterBlocks
    # and decodes without context fusion
    use_inter: bool = True
    # Matching without the cost volume (a conv over [x, warped context]),
    # or the cost volume on the unprojected features
    no_corr: bool = False
    no_proj: bool = False
    # the warped context times 1 - sigmoid(occlusion)
    use_masked_flow: bool = False
    # a 3x3 deformable conv at the flow's offset instead of the warp
    use_deformed_conv: bool = False
    # Subpixel's 32 features, upsampled, added to the next resolution's
    # warped context (every inter_sizes_dec entry a multiple of 32)
    use_tradeoff: bool = False
    # an RGB head after every resolution, summed up the resolutions, in
    # place of the last 1x1 conv; then optionally tanh
    skip_rgb: bool = False
    skip_tanh: bool = False
    # the rollout's new context: the re-encoded frame ("enc") or the
    # decoder's own fused features ("dec", decode_video only)
    skip_mode: str = "enc"
    # once the FIFO is full, its first n_first slots stay pinned
    keep_first: bool = False
    n_first: int = 1
    # the decoder's concat convs compute their x block once per batch
    # element; False tiles x over the contexts (the same math in another
    # order, for A/B)
    shared_x_split: bool = True
    # the JAX package's static slot buckets of the rollout; the port slices
    # the FIFO to min(curr, skip_memory) slots, which gives the same result
    # (masked slots weigh 0), and reads this nowhere
    decode_buckets: Tuple[int, ...] = (2, 4, 8)

    # training (train/ae_losses.py, train/states.py, train/steps.py); the
    # discriminators' widths are ``ndcf * ndcf_mult``
    ndcf: int = 64
    ndcf_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    # share of an image batch whose context fusion is skipped
    inter_drop_p: float = 0.0
    p2p_context: bool = False
    lr: float = 0.002
    # after this many optimizer updates (an int or a tuple of them) the lr
    # is multiplied by ``lr_decay_mult``; 0 keeps it constant
    lr_decay_at: object = 0
    lr_decay_mult: float = 1.0
    beta1: float = 0.0
    beta2: float = 0.99
    gan_loss: str = "logistic"
    use_di: bool = True
    use_dv: bool = False
    use_df: bool = False
    use_vgg_img: bool = True
    use_vgg_vid: bool = False
    use_direct_recovery_img: bool = True
    use_direct_recovery_vid: bool = False
    use_inter_rec_loss_img: bool = False
    use_backwarp_consistency_img: bool = False
    use_elastic_flow_recovery: bool = False
    use_unc_gen: bool = False
    no_q_img: bool = False
    lambda_quant: float = 1.0
    lambda_vgg: float = 10.0
    lambda_gan: float = 1.0
    lambda_r1: float = 10.0
    g_reg_every: Optional[int] = None
    d_reg_every: Optional[int] = 16
    vid_step_every: int = 1
    use_ema: bool = True
    ema_decay: float = 0.999
    # adaptive discriminator augmentation (train/ada.py): a fixed
    # probability ``aug_p``, or with ``aug_p = 0`` the adaptive one, moved
    # by the sign of ``mean(sign(D(real))) - ada_target`` each image D step,
    # ``n / ada_length`` at a time for a batch of n
    use_aug: bool = False
    aug_p: float = 0.0
    ada_target: float = 0.6
    ada_length: int = 500000
    # layout twins: an encoder and quantizer over one-hot segmentations of
    # ``layout_size`` classes, and a decoder of their logits (the image
    # decoder's second head with ``same_decoder_layout``)
    use_layout: bool = False
    layout_size: Optional[int] = None
    same_decoder_layout: bool = False
    stddev_group: int = 4
    n_consecutive_dis: int = 1
    downsample_dis_num: int = 0
    downsample_vdis_num: int = 0
    slide_inter: bool = False
    vid_len: int = 16
    n_consecutive_img: int = 1
    load_elastic_view: bool = False
    elastic_corruption: bool = False
    # recompute the encoder, decoder, VGG and discriminators in the backward
    # pass instead of keeping their activations
    remat: bool = False

    def __post_init__(self):
        if self.use_tradeoff and any(s % 32 for s in self.inter_sizes_dec):
            raise ValueError(f"use_tradeoff needs every inter_sizes_dec entry a multiple of 32 "
                             f"(its 32-group upsampler); got {self.inter_sizes_dec}")

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
    """Latent transformer (reference ``options.py:268-347``, prefix ``x_``)."""

    z_num: int = 1024  # vocabulary
    z_len: int = 1024  # window capacity in tokens
    z_chunk: int = 64  # tokens added per slide of the window
    num_blocks: int = 16
    cond_len: int = 64
    n_layer: int = 24
    n_head: int = 16
    n_embd: int = 1024
    z_shape: Tuple[int, int] = (8, 8)
    # positional embeddings: "temporal" (spatial ``s_emb`` + temporal
    # ``t_emb``), "spatio-temporal" (``h_emb`` + ``w_emb`` + ``t_emb``) or
    # None (one ``pos_emb`` over ``num_blocks`` frames)
    emb_mode: Optional[str] = "temporal"
    # the continuous GPT (``CGPT``, ``ContinuousTransformer``): inputs of
    # ``n_in`` channels, ``n_proposals`` predictions a position, each with a
    # logit where there are several
    n_in: int = 3
    n_proposals: int = 1

    # conditioning modes
    p2p: bool = False  # the end frame's tokens are a prefix ("point to point")
    state: bool = False
    state_front: bool = False  # all state tokens before the frame tokens
    state_num: int = 0  # state vocabulary
    state_size: int = 0  # state tokens per frame
    use_start_token: bool = False
    cat: bool = False  # a class label leads the prefix
    num_lbl: int = 0  # classes
    stft: bool = False  # audio tokens are the state stream
    deblurring: bool = False  # a blurred clip's tokens are the state stream
    blur_sigma: int = 10

    # sampling
    sample: bool = True
    temperature: float = 1.0
    top_k: Optional[int] = 100
    sample_state: bool = False
    temperature_state: float = 1.0
    top_k_state: Optional[int] = None
    beam_size: Optional[int] = None
    # beam search: the first frame position takes the top tokens instead of
    # Gumbel-sampled ones
    no_sample: bool = False

    # int8 weights and activations in the decode step (nn/quantized.py)
    serve_int8: bool = False

    # segmentation layouts as the control stream: the autoencoder's layout
    # tokens take the place of state tokens (``state_num`` = the layout
    # codebook's size, ``state_size`` = tokens a layout frame)
    layout: bool = False

    # training (train/states.py, train/steps.py): dropout and the MLP's
    # residual noise act only in training mode
    resid_noise: bool = False
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.01
    lr_warmup_iter: int = 1
    lr_decay: bool = False
    finetune_head: bool = False
    finetune_f: Optional[float] = None
    # recompute each block in the backward pass instead of keeping its
    # activations (the (B, nh, L, L) attention probabilities above all)
    remat: bool = False
    # one update from this many equal microbatches of the batch
    grad_accum: int = 1
    # the parallel layer's options (not ported: raise)
    seq_parallel: bool = False
    fsdp: bool = False

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
    lr: float = 0.01
    beta1: float = 0.5
    beta2: float = 0.9
    weight_decay: float = 0.0


@dataclass(frozen=True)
class StftConfig:
    """STFT audio autoencoder (reference ``options.py:374-395``, prefix ``a_``):
    64x16 spectrogram patches to ``stft_shape`` latents of ``stft_size``
    channels, ``stft_num`` codes."""

    stft_size: int = 16
    stft_shape: Tuple[int, int] = (8, 2)
    stft_hsize: int = 128
    stft_num: int = 1024
    lr: float = 0.001
    beta1: float = 0.5
    beta2: float = 0.9
    weight_decay: float = 0.0


# The JAX package's config fields that the port does not have, by group
# (``config`` for the top level), with their defaults there: options of
# slices not ported yet (``ROADMAP.md``, queue 1), the JAX package's own
# knobs, and fields that neither package reads (the caller picks
# ``ContinuousTransformer``), so that a value they would ignore raises.
# ``tests/test_torch_generate.py`` holds this table to
# ``dataclasses.fields`` of ``ccvs_tpu/config.py``.
JAX_ONLY_DEFAULTS = {
    "ae": {
        # the JAX package's one-jit decode (its cli.py --fused); the port's
        # decode is eager
        "serve_fused": False,
        # read by no JAX module: make_ae_optimizers builds plain Adam
        "weight_decay": 0.0,
        # read by no JAX module: the video G step adds its quantization loss
        "use_quant_loss_vid": False,
        # read by no JAX module outside its config
        "decoder_only": False,
        # read by no JAX module: the caller gives the compute dtype
        "dtype": "bfloat16",
        # read by no JAX module outside its config
        "use_q_anyway": False,
    },
    "gpt": {"dtype": "bfloat16", "is_continuous": False, "embd_pdrop": 0.0},
    "state": {"quantize_only": False},
    "config": {"async_ckpt": False},
}


def _check_dropped(group, key, value):
    """Raise unless ``group.key`` is a JAX-only field at its default."""
    defaults = JAX_ONLY_DEFAULTS.get(group, {})
    if key not in defaults:
        raise ValueError(f"config field {group}.{key} is not known to the port")
    value = tuple(value) if isinstance(value, list) else value
    if value != defaults[key]:
        raise ValueError(f"config field {group}.{key} = {value!r} cannot be honoured: the port "
                         f"does not have this option yet (only its default "
                         f"{defaults[key]!r}); see ROADMAP.md, queue 1")


@dataclass(frozen=True)
class Config:
    name: str = "experiment"
    data: DataConfig = field(default_factory=DataConfig)
    ae: AutoencoderConfig = field(default_factory=AutoencoderConfig)
    gpt: TransformerConfig = field(default_factory=TransformerConfig)
    state: StateConfig = field(default_factory=StateConfig)
    stft: StftConfig = field(default_factory=StftConfig)
    # the autoencoder and STFT trainers draw their video batches from this
    # second dataset when it is set (reference ``--use_extra_dataset``)
    extra_data: Optional[DataConfig] = None

    # the trainers' bookkeeping
    save_path: str = "./runs"
    seed: int = 0
    n_iter: int = 200_000
    save_latest_freq: int = 1000
    save_freq: int = -1
    log_freq: Optional[int] = 2000
    n_iter_eval: Optional[int] = None
    # when set, every ``latest`` checkpoint also merge-writes the trained
    # parameters (the GPT's, or the autoencoder's raw generator) into this
    # fp16 npz, in the JAX package's flat layout (utils/checkpoint.py)
    npz_mirror: str = ""

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        """The config that :meth:`to_json` wrote, or the JAX package's
        (JSON lists back to tuples). A field the port does not have is
        dropped when it holds the JAX package's default
        (:data:`JAX_ONLY_DEFAULTS`); any other value, or a field neither
        package has, raises: the port cannot honour it."""
        raw = json.loads(text)

        def build(dc_type, d, group):
            names = {f.name for f in dataclasses.fields(dc_type)}
            for k, v in d.items():
                if k not in names:
                    _check_dropped(group, k, v)
            return dc_type(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items() if k in names})

        groups = {"data": DataConfig, "ae": AutoencoderConfig, "gpt": TransformerConfig,
                  "state": StateConfig, "stft": StftConfig, "extra_data": DataConfig}
        kw = {name: build(typ, raw[name], name) for name, typ in groups.items()
              if raw.get(name) is not None}
        top = {f.name for f in dataclasses.fields(cls)}
        for k, v in raw.items():
            if k not in top:
                _check_dropped("config", k, v)
        kw.update({k: v for k, v in raw.items() if k in top and k not in groups})
        return cls(**kw)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())


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
        ndcf=64,
        ndcf_mult=(1, 1, 2, 2, 4, 4),
        use_dv=True,
        use_vgg_vid=True,
        use_direct_recovery_vid=True,
        slide_inter=True,
        use_elastic_flow_recovery=True,
        elastic_corruption=True,
        load_elastic_view=True,
        n_consecutive_img=2,
        vid_len=4,
    )


def bairhd_config(name: str = "bairhd") -> Config:
    """BAIR robot pushing at 256x256 (scripts/bairhd/*.sh)."""
    return Config(
        name=name,
        data=DataConfig(
            dataset="bairhd",
            dataroot="datasets/bairhd",
            max_dim=256,
            true_dim=256,
            vid_len=16,
            fps=4,
            from_vid=False,
            batch_size_img=96,
            batch_size_vid=16,
            n_consecutive_img=2,
            img_out_of_n=30,
            load_elastic_view=True,
            elastic_alpha=3.0,
            elastic_sigma=0.1,
            elastic_min_zoom=0.90,
            elastic_max_zoom=1.10,
            elastic_corruption=True,
            blur_first=(0.0, 2.0),
            distort_first=True,
            load_vid_len=30,
        ),
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
    return dataclasses.replace(c, gpt=dataclasses.replace(c.gpt, p2p=True),
                               data=dataclasses.replace(c.data, p2p_len=16))


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
        data=DataConfig(
            dataset="kinetics600",
            dataroot="datasets/kinetics",
            max_dim=64,
            true_dim=256,
            vid_len=16,
            from_vid=True,
            imagenet_norm=True,
            resize_center_crop_img=256,
            no_h_flip=True,
            batch_size_vid=16,
            num_folds_train=100,
            random_fold_train=True,
        ),
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
    return dataclasses.replace(
        c, name="kinetics600_p2p",
        gpt=dataclasses.replace(c.gpt, p2p=True, z_len=1024, num_blocks=16, cond_len=64),
        data=dataclasses.replace(c.data, p2p_len=16))


def ucf101_config() -> Config:
    """UCF-101 at 256x256 (scripts/ucf101/*.sh): BAIR-256's model; the
    presets differ in their data."""
    c = bairhd_config("ucf101")
    return dataclasses.replace(c, data=dataclasses.replace(
        c.data, dataset="ucf101", dataroot="datasets/ucf101", from_vid=True,
        resize_center_crop_img=256, load_elastic_view=True))


def drums_config() -> Config:
    """Audio-conditioned drums at 128x128 (scripts/drums/*.sh): 45-frame clips
    at 30 fps continued from 15 context frames (``cond_len`` 960 = 15 x 64),
    each frame's 64 tokens after its 16 audio tokens (a 64x16 spectrogram
    patch through :class:`~ccvs_tpu_torch.models.stft_model.StftModel`), in
    a 1280-token window of 16 frames."""
    return Config(
        name="drums",
        data=DataConfig(
            dataset="drums",
            dataroot="datasets/drums",
            max_dim=128,
            true_dim=96,
            vid_len=45,
            fps=30,
            from_vid=True,
        ),
        ae=AutoencoderConfig(
            necf=128,
            necf_mult=(1, 1, 2, 2, 4),
            z_size=512,
            z_num=1024,
            z_shape=(8, 8),
            max_dim=128,
            inter_p=0.75,
            skip_context=tuple(range(1, 16)),
            skip_memory=15,
        ),
        gpt=TransformerConfig(
            z_num=1024,
            z_len=1280,
            z_chunk=80,
            cond_len=960,
            n_layer=24,
            n_head=16,
            n_embd=1024,
            num_blocks=16,
            stft=True,
            state=True,
            state_num=1024,
            state_size=16,
            top_k=100,
        ),
        stft=StftConfig(stft_size=16, stft_shape=(8, 2), stft_num=1024),
    )


PRESETS = {
    "bairhd": bairhd_config,
    "bairhd_state": bairhd_state_config,
    "bairhd_p2p": bairhd_p2p_config,
    "bairhd_unc": bairhd_unc_config,
    "kinetics600": kinetics_config,
    "kinetics600_p2p": kinetics_p2p_config,
    "ucf101": ucf101_config,
    "drums": drums_config,
}


def get_config(preset, **overrides):
    """The preset named ``preset`` with the top-level fields in ``overrides``
    replaced."""
    cfg = PRESETS[preset]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
