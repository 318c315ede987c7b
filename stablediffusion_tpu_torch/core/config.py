"""Model and scheduler configuration, and the device / dtype policy.

Port of ``stablediffusion_tpu/core/config.py`` (the CLIP text, UNet, VAE and
scheduler dataclasses, the SD1.5 presets and the tiny test configs) and of
the dtype policy of ``stablediffusion_tpu/core/dtypes.py`` as the pipeline
applies it (``pipelines/unified.py:417-420``): bf16 compute on the card, fp32
on the CPU.  The dataclasses keep the JAX package's field names and defaults,
so ``dataclasses.asdict`` of a preset here equals that of its counterpart.
"""

from __future__ import annotations

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


# openai/clip-vit-large-patch14 — the SD1.5 text encoder
SD15_TEXT_ENCODER = CLIPTextConfig()


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


SD15_VAE = VAEConfig()


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(
        block_out_channels=(8, 16),
        layers_per_block=1,
        norm_num_groups=4,
        sample_size=32,
    )


@dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel.  `num_attention_heads` holds head counts per
    resolution.  This slice runs the SD1.5 layout only; the SDXL fields are
    kept so that the dataclass matches its JAX counterpart, and the UNet
    module raises where they are set."""

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


SD15_UNET = UNetConfig()


def tiny_unet_config(
    cross_attention_dim: int = 32,
    in_channels: int = 4,
) -> UNetConfig:
    """Tiny SD1.5-layout UNet for CPU tests: 2 resolutions, 1 layer per
    block (the JAX config's sdxl=True variant is not ported)."""
    return UNetConfig(
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


@dataclass(frozen=True)
class SchedulerConfig:
    """Shared scheduler config; this slice's DDIM reads the beta schedule,
    timestep spacing, prediction type and the DDIM flags."""

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


SD15_SCHEDULER = SchedulerConfig()


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
