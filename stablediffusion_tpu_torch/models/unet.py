"""UNet2DCondition, SD1.5 layout, as a torch module.

Port of ``stablediffusion_tpu/models/unet.py`` (``apply`` :140-304 without
its extras).  Module names follow diffusers' UNet2DConditionModel, so
``state_dict()`` keys equal the keys of the JAX package's param tree.  The
SD1.5 path only: 1x1-conv ``proj_in`` / ``proj_out``, GEGLU feed-forward, the
timestep embedding in fp32, and skips popped in the JAX order.  ControlNet
residuals, IP-Adapter, FreeU, PAG, DeepCache and SDXL ``added_cond`` are not
ported: the module takes no such arguments, and a config that asks for
linear projections or an addition embedding raises.

``forward`` takes and returns NCHW; attention runs on [B, H*W, heads, d].
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import UNetConfig
from stablediffusion_tpu_torch.models.layers import (
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
    conv,
    gn,
    gn_silu,
    lin,
    ln,
)
from stablediffusion_tpu_torch.ops.attention import attention
from stablediffusion_tpu_torch.ops.basic import (
    geglu,
    silu,
    timestep_embedding,
)


class Attention(nn.Module):
    """Self- or cross-attention: bias-free q/k/v projections, biased
    ``to_out.0``."""

    def __init__(self, c: int, ctx_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(ctx_dim, c, bias=False)
        self.to_v = nn.Linear(ctx_dim, c, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        B, S, C = x.shape
        d = C // self.heads
        q = lin(self.to_q, x).reshape(B, S, self.heads, d)
        k = lin(self.to_k, ctx).reshape(B, ctx.shape[1], self.heads, d)
        v = lin(self.to_v, ctx).reshape(B, ctx.shape[1], self.heads, d)
        return lin(self.to_out[0], attention(q, k, v).reshape(B, S, C))


class GEGLU(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu(x, self.proj.weight, self.proj.bias)


class FeedForward(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        # index 1 is diffusers' dropout, which holds no parameters
        self.net = nn.ModuleList([GEGLU(c, 4 * c), nn.Identity(), nn.Linear(4 * c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lin(self.net[2], self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, c: int, ctx_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(c)
        self.attn1 = Attention(c, c, heads)
        self.norm2 = nn.LayerNorm(c)
        self.attn2 = Attention(c, ctx_dim, heads)
        self.norm3 = nn.LayerNorm(c)
        self.ff = FeedForward(c)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        h = ln(self.norm1, x)
        x = x + self.attn1(h, h)
        x = x + self.attn2(ln(self.norm2, x), ctx)
        return x + self.ff(ln(self.norm3, x))


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) -> 1x1 conv proj_in -> transformer blocks ->
    1x1 conv proj_out, plus the residual."""

    def __init__(self, c: int, ctx_dim: int, heads: int, n_layers: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, ctx_dim, heads) for _ in range(n_layers)
        )
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = conv(self.proj_in, gn(self.norm, x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, ctx)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return conv(self.proj_out, h) + x


class TimestepEmbedding(nn.Module):
    def __init__(self, c_in: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(c_in, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lin(self.linear_2, silu(lin(self.linear_1, x)))


class _Block(nn.Module):
    """A down or up block: resnets, optional attentions, optional resampler.
    Each piece is registered only when present, as in diffusers."""

    def __init__(self, resnets, attentions, resampler_name, resampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))

    def attn(self, j: int):
        return self.attentions[j] if hasattr(self, "attentions") else None


class UNet2DConditionModel(nn.Module):
    """(sample NCHW, timesteps [] or [B], context [B, S, D]) -> NCHW noise
    prediction (``unet.apply``)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.use_linear_projection or config.addition_embed_type is not None:
            raise NotImplementedError(
                "linear transformer projections and SDXL addition embeddings "
                "are ported with SDXL (slice 2)"
            )
        self.config = config
        ch = config.block_out_channels
        n = len(ch)
        L = config.layers_per_block
        g, eps = config.norm_num_groups, config.norm_eps
        temb = config.time_embed_dim
        xdim = config.cross_attention_dim

        def tf(c, i):
            return Transformer2DModel(
                c, xdim, config.heads_for_block(i), config.tf_layers_for_block(i), g
            )

        self.conv_in = nn.Conv2d(config.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)

        down, skip_ch, c_in = [], [ch[0]], ch[0]
        for i, btype in enumerate(config.down_block_types):
            has_attn = btype == "CrossAttnDownBlock2D"
            resnets = [ResnetBlock2D(c_in if j == 0 else ch[i], ch[i], g, eps, temb)
                       for j in range(L)]
            attns = [tf(ch[i], i) for _ in range(L)] if has_attn else []
            skip_ch += [ch[i]] * L
            ds = Downsample2D(ch[i]) if i < n - 1 else None
            if ds is not None:
                skip_ch.append(ch[i])
            down.append(_Block(resnets, attns, "downsamplers", ds))
            c_in = ch[i]
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = _Block(
            [ResnetBlock2D(ch[-1], ch[-1], g, eps, temb) for _ in range(2)],
            [tf(ch[-1], n - 1)], "", None,
        )

        up, prev = [], ch[-1]
        for i, btype in enumerate(config.up_block_types):
            c = ch[n - 1 - i]
            resnets, attns = [], []
            for j in range(L + 1):
                resnets.append(ResnetBlock2D(prev + skip_ch.pop(), c, g, eps, temb))
                if btype == "CrossAttnUpBlock2D":
                    attns.append(tf(c, n - 1 - i))
                prev = c
            us = Upsample2D(c) if i < n - 1 else None
            up.append(_Block(resnets, attns, "upsamplers", us))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=eps)
        self.conv_out = nn.Conv2d(ch[0], config.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
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

        x = conv(self.conv_in, sample)
        skips: List[torch.Tensor] = [x]
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
        x = mid.resnets[0](x, emb)
        x = mid.attentions[0](x, ctx)
        x = mid.resnets[1](x, emb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), emb)
                attn = block.attn(j)
                if attn is not None:
                    x = attn(x, ctx)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        return conv(self.conv_out, gn_silu(self.conv_norm_out, x))
