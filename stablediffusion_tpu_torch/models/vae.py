"""AutoencoderKL as a torch module: encoder, decoder and the quant convs.

Port of ``stablediffusion_tpu/models/vae.py:37-121`` (``encode``,
``sample_latent``, ``decode`` and the mid-block).  Module names follow
diffusers' AutoencoderKL, so ``state_dict()`` keys equal the JAX param tree's
keys (``encoder.down_blocks.0.downsamplers.0.conv.weight``,
``decoder.mid_block.attentions.0.to_q.weight`` ...).  The mid-block attention
is one head at D = C (512 for SD1.5), which ``ops/attention.py`` routes to
the flash_stream kernel on the card; that kernel is forward only, so the
encoder runs under ``torch.no_grad()`` on the card, as the training step
runs it.

``encode`` and ``decode`` take and return NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
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


class DownEncoderBlock(nn.Module):
    """Resnets, then (all but the last block) a stride-2 3x3 conv after an
    asymmetric (0, 1) x (0, 1) zero pad: diffusers' Downsample2D with
    padding=0 in the VAE encoder, not the UNet's padded Downsample2D."""

    def __init__(self, ci: int, co: int, n: int, groups: int, eps: float,
                 downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(ci if j == 0 else co, co, groups, eps) for j in range(n)
        )
        if downsample:
            down = nn.Module()
            down.conv = nn.Conv2d(co, co, 3, stride=2, padding=0)
            self.downsamplers = nn.ModuleList([down])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = conv(self.downsamplers[0].conv, F.pad(x, (0, 1, 0, 1)))
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, c_in = [], ch[0]
        for i, c in enumerate(ch):
            blocks.append(DownEncoderBlock(
                c_in, c, cfg.layers_per_block, g, eps, i < len(ch) - 1
            ))
            c_in = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMidBlock(ch[-1], g, eps)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=eps)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = conv(self.conv_in, image)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return conv(self.conv_out, gn_silu(self.conv_norm_out, x))


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
    """image NCHW in [-1, 1] -> (mean, logvar) (``vae.encode``), and latents
    NCHW -> image NCHW in [-1, 1] (``vae.decode``); the caller applies and
    undoes the scaling factor."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        lc = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        # SD3-family VAEs have no quant convs
        if config.use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        if config.use_post_quant_conv:
            self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar), each [B, latent_ch, h/8, w/8]; logvar clipped to
        [-30, 20]."""
        moments = self.encoder(image)
        if hasattr(self, "quant_conv"):
            moments = conv(self.quant_conv, moments)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        x = latents
        if hasattr(self, "post_quant_conv"):
            x = conv(self.post_quant_conv, x)
        return self.decoder(x)


def sample_latent(
    mean: torch.Tensor,
    logvar: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mean + exp(logvar / 2) * eps, with eps standard normal drawn from
    `generator` on mean's device, or given (``vae.sample_latent``)."""
    if eps is None:
        if generator is None:
            raise ValueError("sample_latent needs a generator or an injected eps")
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
