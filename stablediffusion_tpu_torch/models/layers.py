"""Building blocks shared by CLIP, the UNet and the VAE decoder.

``nn.Module``s hold the parameters under the diffusers names; their forwards
call the plain functions of ``ops/basic.py``, as the JAX package's blocks
call its ops on param dicts (``stablediffusion_tpu/models/unet.py:48-57``,
``models/vae.py:37-44``).  Activations are NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stablediffusion_tpu_torch.ops.basic import (
    conv2d,
    group_norm,
    group_norm_silu,
    layer_norm,
    linear,
    silu,
    upsample_nearest_2x,
)


def lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(x, m.weight, m.bias)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias, stride=m.stride[0], padding=m.padding[0])


def ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias, m.eps)


def gn(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, m.weight, m.bias, m.num_groups, m.eps)


def gn_silu(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm_silu(x, m.weight, m.bias, m.num_groups, m.eps)


class ResnetBlock2D(nn.Module):
    """norm1 -> SiLU -> conv1 (+ time embedding) -> norm2 -> SiLU -> conv2,
    plus a 1x1 shortcut when the channel count changes.  `temb_dim=None`
    is the VAE's resnet, which takes no time embedding."""

    def __init__(self, ci: int, co: int, groups: int, eps: float,
                 temb_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, ci, eps=eps)
        self.conv1 = nn.Conv2d(ci, co, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, co)
        self.norm2 = nn.GroupNorm(groups, co, eps=eps)
        self.conv2 = nn.Conv2d(co, co, 3, padding=1)
        if ci != co:
            self.conv_shortcut = nn.Conv2d(ci, co, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        h = conv(self.conv1, gn_silu(self.norm1, x))
        if temb is not None:
            h = h + lin(self.time_emb_proj, silu(temb))[:, :, None, None]
        h = conv(self.conv2, gn_silu(self.norm2, h))
        if hasattr(self, "conv_shortcut"):
            x = conv(self.conv_shortcut, x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv (UNet down blocks)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, x)


class Upsample2D(nn.Module):
    """Nearest 2x then a 3x3 conv (UNet and VAE up blocks)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, upsample_nearest_2x(x))
