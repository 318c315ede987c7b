"""Model and scheduler configuration, and the device / dtype policy.

Port of ``stablediffusion_tpu/core/config.py`` (the CLIP text, UNet, VAE,
MM-DiT and scheduler dataclasses, the SD1.5, SD2.1, SDXL and SD3 presets and
the tiny test configs) and of the dtype policy of ``stablediffusion_tpu/core/dtypes.py``
as the pipeline applies it (``pipelines/unified.py:417-420``): bf16 compute on the card, fp32
on the CPU.  The dataclasses keep the JAX package's field names and defaults,
so ``dataclasses.asdict`` of a preset here equals that of its counterpart.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower (transformers CLIPTextModel[WithProjection])."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (ViT-L) | "gelu" (bigG)
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    with_projection: bool = False
    eos_token_id: int = 49407

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "CLIPTextConfig":
        archs = d.get("architectures") or []
        return cls(
            vocab_size=d.get("vocab_size", 49408),
            hidden_size=d.get("hidden_size", 768),
            intermediate_size=d.get("intermediate_size", 3072),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            max_position_embeddings=d.get("max_position_embeddings", 77),
            hidden_act=d.get("hidden_act", "quick_gelu"),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            projection_dim=d.get("projection_dim", d.get("hidden_size", 768)),
            with_projection="CLIPTextModelWithProjection" in archs,
            eos_token_id=d.get("eos_token_id", 49407),
        )


# openai/clip-vit-large-patch14 — the SD1.5 text encoder and SDXL's first
SD15_TEXT_ENCODER = CLIPTextConfig()
SDXL_TEXT_ENCODER = CLIPTextConfig(projection_dim=768)
# laion OpenCLIP bigG — SDXL's second encoder (projected pooled output)
SDXL_TEXT_ENCODER_2 = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
    with_projection=True,
)


def tiny_clip_config(with_projection: bool = False) -> CLIPTextConfig:
    """Tiny config for CPU tests."""
    return CLIPTextConfig(
        vocab_size=1000,
        hidden_size=32,
        intermediate_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        max_position_embeddings=77,
        projection_dim=32,
        with_projection=with_projection,
        eos_token_id=999,
    )


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT vision tower (transformers CLIPVisionModel[WithProjection]),
    the IP-Adapter image encoder (``config.py:101``); the defaults are
    h94/IP-Adapter's ``models/image_encoder``, OpenCLIP ViT-H/14."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 1024
    with_projection: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "CLIPVisionConfig":
        archs = d.get("architectures") or []
        return cls(
            hidden_size=d.get("hidden_size", 1280),
            intermediate_size=d.get("intermediate_size", 5120),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 16),
            image_size=d.get("image_size", 224),
            patch_size=d.get("patch_size", 14),
            num_channels=d.get("num_channels", 3),
            hidden_act=d.get("hidden_act", "gelu"),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            projection_dim=d.get("projection_dim", 1024),
            with_projection="CLIPVisionModelWithProjection" in archs if archs else True,
        )


# h94/IP-Adapter models/image_encoder (ViT-H/14) and sdxl_models/image_encoder
# (ViT-bigG/14)
IP_ADAPTER_IMAGE_ENCODER = CLIPVisionConfig()
IP_ADAPTER_SDXL_IMAGE_ENCODER = CLIPVisionConfig(
    hidden_size=1664, intermediate_size=8192, num_hidden_layers=48,
    num_attention_heads=16, projection_dim=1280)


def tiny_clip_vision_config(with_projection: bool = True) -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, image_size=32, patch_size=8,
                            projection_dim=24, with_projection=with_projection)


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    sample_size: int = 512
    scaling_factor: float = 0.18215
    force_upcast: bool = True
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    shift_factor: Optional[float] = None
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "VAEConfig":
        return cls(
            in_channels=d.get("in_channels", 3),
            out_channels=d.get("out_channels", 3),
            block_out_channels=tuple(d.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=d.get("layers_per_block", 2),
            latent_channels=d.get("latent_channels", 4),
            norm_num_groups=d.get("norm_num_groups", 32),
            sample_size=d.get("sample_size", 512),
            scaling_factor=d.get("scaling_factor", 0.18215),
            force_upcast=bool(d.get("force_upcast", True)),
            latents_mean=tuple(d["latents_mean"]) if d.get("latents_mean") else None,
            latents_std=tuple(d["latents_std"]) if d.get("latents_std") else None,
            shift_factor=d.get("shift_factor"),
            use_quant_conv=bool(d.get("use_quant_conv", True)),
            use_post_quant_conv=bool(d.get("use_post_quant_conv", True)),
        )


SD15_VAE = VAEConfig()
SDXL_VAE = VAEConfig(sample_size=1024, scaling_factor=0.13025)
# SD3-family VAE: 16 latent channels, z' = (z - shift_factor) * scaling_factor,
# no quant convs
SD3_VAE = VAEConfig(
    sample_size=1024,
    latent_channels=16,
    scaling_factor=1.5305,
    shift_factor=0.0609,
    use_quant_conv=False,
    use_post_quant_conv=False,
)


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(
        block_out_channels=(8, 16),
        layers_per_block=1,
        norm_num_groups=4,
        sample_size=32,
    )


@dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel: the SD1.x, SD2.x and SDXL layouts.
    `num_attention_heads` and `transformer_layers_per_block` hold one value
    or one per resolution; `use_linear_projection` makes the transformers'
    proj_in/proj_out linear (SD2.x, SDXL); `addition_embed_type="text_time"`
    adds SDXL's micro-conditioning embedding."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    num_attention_heads: Union[int, Tuple[int, ...]] = 8
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None
    time_embedding_dim: Optional[int] = None  # default 4 * block_out_channels[0]

    @property
    def time_embed_dim(self) -> int:
        return self.time_embedding_dim or 4 * self.block_out_channels[0]

    def heads_for_block(self, i: int) -> int:
        h = self.num_attention_heads
        return h[i] if isinstance(h, tuple) else h

    def tf_layers_for_block(self, i: int) -> int:
        t = self.transformer_layers_per_block
        return t[i] if isinstance(t, tuple) else t

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "UNetConfig":
        heads = d.get("num_attention_heads")
        if heads is None:
            # SD1.x/2.x quirk: `attention_head_dim` holds the head *count*
            heads = d.get("attention_head_dim", 8)
        if isinstance(heads, list):
            heads = tuple(heads)
        tf_layers = d.get("transformer_layers_per_block", 1)
        if isinstance(tf_layers, list):
            tf_layers = tuple(tf_layers)
        return cls(
            sample_size=d.get("sample_size", 64),
            in_channels=d.get("in_channels", 4),
            out_channels=d.get("out_channels", 4),
            down_block_types=tuple(d["down_block_types"]),
            up_block_types=tuple(d["up_block_types"]),
            block_out_channels=tuple(d["block_out_channels"]),
            layers_per_block=d.get("layers_per_block", 2),
            transformer_layers_per_block=tf_layers,
            num_attention_heads=heads,
            cross_attention_dim=d.get("cross_attention_dim", 768),
            use_linear_projection=bool(d.get("use_linear_projection", False)),
            norm_num_groups=d.get("norm_num_groups", 32),
            norm_eps=d.get("norm_eps", 1e-5),
            flip_sin_to_cos=bool(d.get("flip_sin_to_cos", True)),
            freq_shift=d.get("freq_shift", 0),
            addition_embed_type=d.get("addition_embed_type"),
            addition_time_embed_dim=d.get("addition_time_embed_dim"),
            projection_class_embeddings_input_dim=d.get(
                "projection_class_embeddings_input_dim"
            ),
            time_embedding_dim=d.get("time_embedding_dim"),
        )


SD15_UNET = UNetConfig()

# 9-channel inpainting UNet (runwayml/stable-diffusion-inpainting): the
# pipeline's concat9 mode feeds [latents, mask, masked-image latents]
SD15_INPAINT_UNET = dataclasses.replace(SD15_UNET, in_channels=9)

# stabilityai/stable-diffusion-2-1 (v-prediction, OpenCLIP-H text encoder,
# linear transformer projections, 64-channel heads)
SD21_UNET = UNetConfig(
    sample_size=96,
    num_attention_heads=(5, 10, 20, 20),
    cross_attention_dim=1024,
    use_linear_projection=True,
)

SD21_TEXT_ENCODER = CLIPTextConfig(
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=23,
    num_attention_heads=16,
    hidden_act="gelu",
    projection_dim=512,
)

SDXL_UNET = UNetConfig(
    sample_size=128,
    down_block_types=(
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ),
    up_block_types=(
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ),
    block_out_channels=(320, 640, 1280),
    transformer_layers_per_block=(1, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,  # 1280 pooled + 6 * 256
)

# stabilityai/stable-diffusion-xl-refiner-1.0 UNet: conditions on encoder 2
# alone and on five time ids (an aesthetic score in place of the target size)
SDXL_REFINER_UNET = UNetConfig(
    sample_size=128,
    down_block_types=(
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ),
    block_out_channels=(384, 768, 1536, 1536),
    transformer_layers_per_block=4,
    num_attention_heads=(6, 12, 24, 24),
    cross_attention_dim=1280,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2560,  # 1280 pooled + 5 * 256
)


def tiny_unet_config(
    cross_attention_dim: int = 32,
    in_channels: int = 4,
    sdxl: bool = False,
) -> UNetConfig:
    """Tiny UNet for CPU tests: 2 resolutions, 1 layer per block; `sdxl`
    adds linear projections and the text_time embedding."""
    kwargs = dict(
        sample_size=16,
        in_channels=in_channels,
        out_channels=4,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        block_out_channels=(16, 32),
        layers_per_block=1,
        transformer_layers_per_block=1,
        num_attention_heads=2,
        cross_attention_dim=cross_attention_dim,
        norm_num_groups=8,
    )
    if sdxl:
        kwargs.update(
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            # pooled (= cross_attention_dim here) + 6 * 8
            projection_class_embeddings_input_dim=cross_attention_dim + 48,
            use_linear_projection=True,
        )
    return UNetConfig(**kwargs)


@dataclass(frozen=True)
class SD3Config:
    """SD3Transformer2DModel (MM-DiT, arXiv 2403.03206).  Defaults are
    SD3-medium; `qk_norm="rms_norm"` switches on the SD3.5 QK-RMSNorm."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    out_channels: int = 16
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None  # None | "rms_norm" (SD3.5)
    # MMDiT-X (SD3.5-medium): these blocks carry a second image-stream
    # self-attention (attn2) and a 9-chunk AdaLN-Zero
    dual_attention_layers: Tuple[int, ...] = ()

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "SD3Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "dual_attention_layers" in kw:
            kw["dual_attention_layers"] = tuple(kw["dual_attention_layers"])
        return cls(**kw)


SD3_MEDIUM = SD3Config()
SD35_LARGE = SD3Config(
    num_layers=38,
    num_attention_heads=38,
    caption_projection_dim=2432,
    qk_norm="rms_norm",
)
# MMDiT-X; real loads read transformer/config.json via from_diffusers_dict
SD35_MEDIUM = SD3Config(
    num_layers=24,
    pos_embed_max_size=384,
    qk_norm="rms_norm",
    dual_attention_layers=tuple(range(13)),
)


def tiny_sd3_config() -> SD3Config:
    return SD3Config(
        sample_size=8,
        patch_size=2,
        in_channels=4,
        num_layers=2,
        attention_head_dim=8,
        num_attention_heads=2,
        # must exceed the two concatenated CLIP hidden sizes (2*32 in tests),
        # as 4096 > 768+1280 does for real SD3
        joint_attention_dim=80,
        caption_projection_dim=16,
        pooled_projection_dim=20,
        out_channels=4,
        pos_embed_max_size=16,
    )


@dataclass(frozen=True)
class SchedulerConfig:
    """Shared scheduler config of the 15 schedulers; the registry
    (``schedulers/__init__.py``) overrides fields per name."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    clip_sample: bool = False
    use_karras_sigmas: bool = False
    algorithm_type: str = "dpmsolver++"
    solver_order: int = 2
    final_sigmas_type: str = "zero"
    solver_type: str = "bh2"
    rescale_betas_zero_snr: bool = False
    shift: float = 3.0

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "SchedulerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


SD15_SCHEDULER = SchedulerConfig()
SDXL_SCHEDULER = SchedulerConfig(timestep_spacing="leading")


# ---------------------------------------------------------------------------
# device and dtype policy
# ---------------------------------------------------------------------------


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or left as the default) and
    there is none: the port does not carry on silently on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        if device.index is None:  # "cuda" means the current card
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_dtype(device: torch.device) -> torch.dtype:
    """Compute dtype of the UNet and the denoise loop: bf16 on the card, fp32
    on the CPU (the parity path)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
