"""ControlNet (Zhang et al. 2023): residuals for the UNet from a control image.

Port of ``stablediffusion_tpu/models/controlnet.py``: the trunk is the
UNet's encoder (conv_in, the time embedding and SDXL's ``text_time``
embedding, the down blocks and the mid-block), a conditioning embedder maps
the control image (canny, pose, depth ...) to latent-resolution features
added after conv_in (``_cond_embedding`` :30), and 1x1 convolutions emit one
residual per UNet skip and one for the mid-block, which the UNet adds
(``apply`` :41).  Module names follow diffusers' ControlNetModel
(``controlnet_cond_embedding.*``, ``controlnet_down_blocks.N``,
``controlnet_mid_block`` and the trunk's UNet keys), so ``state_dict()`` keys
are the keys of a diffusers ControlNet folder.  Layout NCHW; the control
image is [B, 3, 8h, 8w] in [0, 1].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import UNetConfig
from stablediffusion_tpu_torch.models.layers import conv
from stablediffusion_tpu_torch.models.unet import (
    TimestepEmbedding,
    build_down_blocks,
    build_mid_block,
    text_time_embedding,
)
from stablediffusion_tpu_torch.ops.basic import silu, timestep_embedding

# diffusers ControlNetConditioningEmbedding's channel ladder
COND_EMBED_CHANNELS = (16, 32, 96, 256)


class ControlNetConditioningEmbedding(nn.Module):
    """Control image [B, 3, H, W] -> [B, C0, H/8, W/8]: conv_in, six 3x3
    convolutions (stride 2 on every second), conv_out, SiLU between."""

    def __init__(self, out_channels: int):
        super().__init__()
        ch = COND_EMBED_CHANNELS
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks += [nn.Conv2d(ch[i], ch[i], 3, padding=1),
                       nn.Conv2d(ch[i], ch[i + 1], 3, padding=1, stride=2)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = silu(conv(self.conv_in, cond))
        for block in self.blocks:
            h = silu(conv(block, h))
        return conv(self.conv_out, h)


def skip_channels(config: UNetConfig) -> List[int]:
    """The channels of each UNet skip, in push order: one zero convolution
    each."""
    ch, L = config.block_out_channels, config.layers_per_block
    out = [ch[0]]
    for i in range(len(ch)):
        out += [ch[i]] * L
        if i < len(ch) - 1:
            out.append(ch[i])
    return out


class ControlNetModel(nn.Module):
    """(sample, timesteps, context, control image[, scale, added_cond]) ->
    (one residual per UNet skip, the mid-block residual)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = config
        ch = config.block_out_channels
        self.conv_in = nn.Conv2d(config.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], config.time_embed_dim)
        if config.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                config.projection_class_embeddings_input_dim, config.time_embed_dim)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch[0])
        self.down_blocks, _ = build_down_blocks(config)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in skip_channels(config))
        self.mid_block = build_mid_block(config)
        self.controlnet_mid_block = nn.Conv2d(ch[-1], ch[-1], 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cond_image: torch.Tensor,
                conditioning_scale: float = 1.0,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        cfg = self.config
        B = sample.shape[0]
        dtype = sample.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        ctx = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        ).to(dtype)
        emb = self.time_embedding(t_emb)
        if cfg.addition_embed_type == "text_time" and added_cond is not None:
            emb = emb + text_time_embedding(self.add_embedding, cfg, added_cond, sample)

        x = conv(self.conv_in, sample)
        x = x + self.controlnet_cond_embedding(cond_image.to(dtype))
        skips = [x]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, emb)
                attn = block.attn(j)
                if attn is not None:
                    x = attn(x, ctx)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, emb), ctx), emb)

        # the scale as JAX multiplies it: a Python float on the conv output
        down_res = [conv(zc, s) * conditioning_scale
                    for zc, s in zip(self.controlnet_down_blocks, skips)]
        return down_res, conv(self.controlnet_mid_block, x) * conditioning_scale


def init_from_unet(unet: nn.Module, config: UNetConfig,
                   generator: Optional[torch.Generator] = None) -> ControlNetModel:
    """``ControlNetModel.from_unet`` (``controlnet.py:119``): the trunk is a
    copy of the UNet's (its IP-Adapter projections left out), the
    conditioning embedder is drawn from `generator` at the JAX package's
    scales (conv_out zero), and the control convolutions are zero, so a
    fresh ControlNet leaves the UNet's output unchanged.  On the UNet's
    device and in its dtype."""
    w = next(unet.parameters())
    with torch.device("meta"):
        net = ControlNetModel(config)
    net = net.to_empty(device=w.device).to(w.dtype).eval().requires_grad_(False)
    trunk = {k: v for k, v in unet.state_dict().items()
             if k.split(".")[0] in ("conv_in", "time_embedding", "add_embedding",
                                    "down_blocks", "mid_block")
             and ".to_k_ip." not in k and ".to_v_ip." not in k}
    own = net.state_dict()
    with torch.no_grad():
        for k, v in trunk.items():
            own[k].copy_(v)
        for name, t in own.items():
            if name.startswith(("controlnet_down_blocks", "controlnet_mid_block",
                                "controlnet_cond_embedding.conv_out")):
                t.zero_()
            elif name.startswith("controlnet_cond_embedding"):
                if name.endswith("bias"):
                    t.zero_()
                else:
                    k, ci = t.shape[-1], t.shape[1]
                    # drawn on the generator's device (a card's generator
                    # draws on the card), then moved to the net's
                    dev = generator.device if generator is not None else t.device
                    t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32,
                                        device=dev).mul_(0.3 / (k * ci**0.5)).to(t))
    return net
