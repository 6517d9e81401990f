"""Model/training configuration.

The reference consumes a flat JSON config (``run_code/1d_config.json``) that
is gitignored and therefore absent from its repo; the schema was
reconstructed from every consumption site (SURVEY.md §2c; reference
train.py:23, tts/models.py:129-148).  This module gives that schema a typed
home with validated defaults, JSON round-trip, and the fixed hyperparameters
the reference hard-codes in train.py:32-47.

Where the reference's actual values are unknowable (the file is not
published), defaults here are chosen TPU-first: channel counts that tile the
128-lane MXU, GroupNorm-compatible widths, and head dims >= 64.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Topology of TTSSingleSpeaker (text encoder + conditional 1-D UNet)."""

    # --- text encoder (reference tts/models.py:128-135) ---
    cmu_vocab_len: int = 256          # >= 149 (148 symbols + sep id); padded
    #                                   to 256 for lane-aligned embedding rows
    cmu_seq_len: int = 550            # padded text length (train.py:164-165)
    cross_attention_dim: int = 768    # text width == cross-attn dim
    attention_head_dim: int = 64      # text-encoder head dim (dim % it == 0)
    text_encoder_dropout: float = 0.1
    text_encoder_layers: int = 4

    # --- UNet (reference tts/models.py:137-148) ---
    sample_size: int = 900            # latent frames (12 s * 75 Hz)
    in_channels: int = 8              # EnCodec n_q at 6 kbps
    out_channels: int = 8
    layers_per_block: int = 2
    block_out_channels: Tuple[int, ...] = (256, 512, 768, 768)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock1D",
        "CrossAttnDownBlock1D",
        "CrossAttnDownBlock1D",
        "DownBlock1D",
    )
    mid_block_type: Optional[str] = "UNetMidBlock1DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock1D",
        "CrossAttnUpBlock1D",
        "CrossAttnUpBlock1D",
        "CrossAttnUpBlock1D",
    )
    # UNet attention: `attention_head_dim` in the reference UNet is used as
    # the NUMBER OF HEADS (quirk: unet_blocks.py:317-319 passes it as
    # num_attention_heads and divides channels by it for the head dim).
    unet_num_heads: int = 8
    act_fn: str = "silu"
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    dropout: float = 0.0

    # --- optional reference UNet surface (dead in the reference's own
    # configs — its gitignored config uses the defaults — but part of the
    # class's documented surface: unet_1d_condition.py:198-256,
    # resnet.py:24-96) ---
    time_embedding_type: str = "positional"   # or "fourier"
    class_embed_type: Optional[str] = None    # "timestep"|"identity"|
    #                                           "projection"|None
    num_class_embeds: Optional[int] = None    # class_embed_type=None +
    #                                           this set -> nn.Embed table
    projection_class_embeddings_input_dim: Optional[int] = None
    upsample_conv_transpose: bool = False     # ConvTranspose1d(4,2,1)
    downsample_avg_pool: bool = False         # AvgPool(2,2) i/o strided conv

    # --- prompt conditioning (multi-speaker; BASELINE config #5) ---
    # The reference's class_embed_type plumbing (unet_1d_condition.py:229-256)
    # is the hook; here a reference-audio prompt encoder feeds BOTH a global
    # speaker embedding (added to the time embedding) and prompt tokens
    # concatenated to the cross-attention context.
    prompt_conditioning: bool = False
    prompt_frames: int = 225          # 3 s of codes @ 75 Hz
    prompt_encoder_layers: int = 2
    prompt_tokens: int = 32           # pooled prompt tokens fed to cross-attn

    def __post_init__(self):
        if self.cmu_vocab_len < 149:
            raise ValueError("cmu_vocab_len must cover 148 symbols + sep id")
        if self.cross_attention_dim % self.attention_head_dim != 0:
            raise ValueError("cross_attention_dim % attention_head_dim != 0")
        if len(self.down_block_types) != len(self.block_out_channels):
            raise ValueError("down_block_types/block_out_channels mismatch")
        if len(self.up_block_types) != len(self.block_out_channels):
            raise ValueError("up_block_types/block_out_channels mismatch")
        for c in self.block_out_channels:
            if c % self.norm_num_groups != 0:
                raise ValueError(f"channels {c} not divisible by groups")
        if self.time_embedding_type not in ("positional", "fourier"):
            raise ValueError(
                f"unknown time_embedding_type {self.time_embedding_type!r}")
        if self.class_embed_type not in (None, "timestep", "identity",
                                         "projection"):
            raise ValueError(
                f"unknown class_embed_type {self.class_embed_type!r}")
        if (self.class_embed_type == "projection"
                and self.projection_class_embeddings_input_dim is None):
            raise ValueError("class_embed_type='projection' requires "
                             "projection_class_embeddings_input_dim")


@dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (fixed in reference train.py:32-47, 60-65)."""

    learning_rate: float = 1e-5
    adam_b1: float = 0.95
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-6
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    num_train_epochs: int = 100
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 500
    save_per_epochs: int = 1
    batch_size: int = 32
    num_train_timesteps: int = 1000
    seed: int = 0
    # classifier-free guidance: per-sample probability of dropping the text
    # conditioning during training (0 = reference behavior, train.py has
    # no CFG). Enables guidance_scale > 1 at sampling time.
    cond_dropout_prob: float = 0.0
    # exponential moving average of the params (0 = off = reference
    # behavior, train.py samples from raw optimizer iterates). Typical
    # diffusion value: 0.9999. Updated once per OPTIMIZER step (gated on
    # the gradient-accumulation boundary), checkpointed alongside params.
    ema_decay: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.ema_decay < 1.0:
            # 1.0 would freeze the EMA at the random init forever —
            # synthesize --ema would then silently emit noise
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if not 0.0 <= self.cond_dropout_prob < 1.0:
            raise ValueError(
                f"cond_dropout_prob must be in [0, 1), got "
                f"{self.cond_dropout_prob}")
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        """Load a flat reference-style JSON config (SURVEY.md §2c schema)."""
        with open(path) as f:
            raw = json.load(f)
        return cls.from_flat_dict(raw)

    @classmethod
    def from_flat_dict(cls, raw: dict) -> "Config":
        model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        train_fields = {f.name for f in dataclasses.fields(TrainConfig)}
        if isinstance(raw.get("model"), dict) or isinstance(
                raw.get("train"), dict):
            # nested form (what to_json writes): build each section
            # directly so saved configs round-trip, and a field name the
            # two dataclasses might ever share cannot be misrouted
            def section(src, fields):
                return {k: tuple(v) if isinstance(v, list) else v
                        for k, v in (src or {}).items() if k in fields}
            return cls(
                model=ModelConfig(**section(raw.get("model"), model_fields)),
                train=TrainConfig(**section(raw.get("train"), train_fields)))
        mk = {}
        tk = {}
        for k, v in raw.items():
            if isinstance(v, list):
                v = tuple(v)
            if k in model_fields:
                mk[k] = v
            elif k in train_fields:
                tk[k] = v
            # unknown keys are ignored (reference does no validation at all)
        return cls(model=ModelConfig(**mk), train=TrainConfig(**tk))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "model": dataclasses.asdict(self.model),
                    "train": dataclasses.asdict(self.train),
                },
                f, indent=2,
            )
