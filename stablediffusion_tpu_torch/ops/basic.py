"""Primitive NN ops as plain tensor functions.

Port of ``stablediffusion_tpu/ops/basic.py``.  The numerics carry over: norm
statistics in fp32 whatever the compute dtype, weights cast to the
activation's dtype, exact-erf GELU, CLIP's quick GELU, and the sinusoidal
timestep embedding with its ``[cos, sin]`` order under ``flip_sin_to_cos``.
The JAX package's one-hot and ones-matmul formulation of the norm statistics
existed for the TPU's matrix unit and is not ported.

Layouts are PyTorch's: image activations are NCHW, conv weights OIHW, linear
weights (out, in).  Plain GEMMs and convolutions stay torch ops, as the JAX
package left them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def linear(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x [..., in] @ weight[out, in]^T + bias, in x's dtype."""
    return F.linear(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype)
    )


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """NCHW conv with an OIHW kernel, in x's dtype."""
    return F.conv2d(
        x,
        weight.to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=stride,
        padding=padding,
    )


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over NCHW with statistics and the affine in fp32, cast back
    to x's dtype."""
    out = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return out.to(x.dtype)


def group_norm_silu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm followed by SiLU — the resnet prologue."""
    return silu(group_norm(x, weight, bias, num_groups, eps))


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics."""
    out = F.layer_norm(
        x.float(),
        (x.shape[-1],),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(),
        eps,
    )
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def geglu(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """GEGLU feed-forward gate: one projection to 2*d_ff, split,
    h * gelu(gate)."""
    h, gate = linear(x, weight, bias).chunk(2, dim=-1)
    return h * gelu(gate)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "quick_gelu": quick_gelu}


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding [B, dim] in fp32; flip_sin_to_cos=True
    gives the [cos, sin] order."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW nearest-neighbour 2x (UNet and VAE upsamplers)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
