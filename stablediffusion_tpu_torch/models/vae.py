"""AutoencoderKL decoder as a torch module.

Port of ``stablediffusion_tpu/models/vae.py:47-64,101-121`` (``decode`` and
the mid-block).  Module names follow diffusers' AutoencoderKL, so
``state_dict()`` keys equal the JAX param tree's decoder keys
(``decoder.mid_block.attentions.0.to_q.weight`` ...).  Only the decode path
is ported in this slice: the encoder and ``quant_conv`` belong to img2img and
inpainting (slice 2), and :data:`UNPORTED_PREFIXES` names their keys for the
weight loader.  The mid-block attention is one head at D = C (512 for SD1.5),
which ``ops/attention.py`` routes to the flash_stream kernel on the card.

``decode`` takes and returns NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import VAEConfig
from stablediffusion_tpu_torch.models.layers import (
    ResnetBlock2D,
    Upsample2D,
    conv,
    gn,
    gn_silu,
    lin,
)
from stablediffusion_tpu_torch.ops.attention import attention

# keys of a full AutoencoderKL tree that this decode-only module does not hold
UNPORTED_PREFIXES = ("encoder.", "quant_conv.")


class VAEAttention(nn.Module):
    """Mid-block self-attention: one head over all C channels."""

    def __init__(self, c: int, groups: int, eps: float):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=eps)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = gn(self.group_norm, x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q = lin(self.to_q, h)[:, :, None, :]  # single head, head_dim = C
        k = lin(self.to_k, h)[:, :, None, :]
        v = lin(self.to_v, h)[:, :, None, :]
        o = lin(self.to_out[0], attention(q, k, v)[:, :, 0, :])
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, c: int, groups: int, eps: float):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, c, groups, eps), ResnetBlock2D(c, c, groups, eps)]
        )
        self.attentions = nn.ModuleList([VAEAttention(c, groups, eps)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class UpDecoderBlock(nn.Module):
    def __init__(self, ci: int, co: int, n: int, groups: int, eps: float,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(ci if j == 0 else co, co, groups, eps) for j in range(n)
        )
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(co)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        dec_ch = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, dec_ch[0], 3, padding=1)
        self.mid_block = VAEMidBlock(dec_ch[0], g, eps)
        blocks, c_in = [], dec_ch[0]
        for i, c in enumerate(dec_ch):
            blocks.append(UpDecoderBlock(
                c_in, c, cfg.layers_per_block + 1, g, eps, i < len(dec_ch) - 1
            ))
            c_in = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, dec_ch[-1], eps=eps)
        self.conv_out = nn.Conv2d(dec_ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(conv(self.conv_in, z))
        for block in self.up_blocks:
            x = block(x)
        return conv(self.conv_out, gn_silu(self.conv_norm_out, x))


class AutoencoderKL(nn.Module):
    """Decode-only AutoencoderKL: latents NCHW -> image NCHW in [-1, 1]
    (``vae.decode``); the caller has already undone the scaling factor."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        if config.use_post_quant_conv:
            lc = config.latent_channels
            self.post_quant_conv = nn.Conv2d(lc, lc, 1)
        self.decoder = Decoder(config)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        x = latents
        if hasattr(self, "post_quant_conv"):
            x = conv(self.post_quant_conv, x)
        return self.decoder(x)
