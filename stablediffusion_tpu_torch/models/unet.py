"""UNet2DCondition (SD1.x, SD2.x and SDXL layouts) as a torch module.

Port of ``stablediffusion_tpu/models/unet.py`` (``apply`` :140-304).  Module
names follow diffusers' UNet2DConditionModel, so ``state_dict()`` keys equal
the keys of the JAX package's param tree: 1x1-conv or linear ``proj_in`` /
``proj_out`` (``use_linear_projection``, SD2.x and SDXL), per-resolution head
counts and transformer depths, GEGLU feed-forward, the timestep embedding in
fp32, SDXL's ``text_time`` micro-conditioning (``added_cond``), and skips
popped in the JAX order.  The pipeline extensions take these arguments, as
JAX's ``apply`` does:

  * ``down_block_residuals`` / ``mid_block_residual``: a ControlNet's
    residuals, added to the skips and the mid-block's output (:206-209,
    :264-265);
  * ``ip_hidden_states`` / ``ip_scale``: IP-Adapter's image tokens, which
    each cross-attention holding ``to_k_ip`` / ``to_v_ip`` attends to beside
    the text, scaled by ``ip_scale`` (:60-80);
  * ``freeu``: FreeU's (b1, b2, s1, s2) at the two deepest decoder stages,
    on full forwards only (:277-280, ``ops/freeu.py``);
  * ``pag_perturb``: a subset of ("down", "mid", "up") whose self-attentions
    become the identity map, ``to_out(to_v(norm1(x)))``, for PAG's extra
    branch; they launch no attention (:84-92);
  * ``deep_cache`` / ``return_deep_cache``: DeepCache; a full forward can
    also return the feature map entering the last up block, and a forward
    given it runs only the outermost down level and that up block
    (:147-148, :213-245, :271, :302).

``forward`` takes and returns NCHW; attention runs on [B, H*W, heads, d].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
from stablediffusion_tpu_torch.ops.freeu import apply_freeu
from stablediffusion_tpu_torch.ops.basic import (
    gelu,
    silu,
    timestep_embedding,
)


class Attention(nn.Module):
    """Self- or cross-attention: bias-free q/k/v projections, biased
    ``to_out.0``.  A loaded IP-Adapter adds bias-free ``to_k_ip`` /
    ``to_v_ip`` to the cross-attentions (``models/ip_adapter.fuse_ip_weights``)."""

    def __init__(self, c: int, ctx_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(ctx_dim, c, bias=False)
        self.to_v = nn.Linear(ctx_dim, c, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                ip_ctx: Optional[torch.Tensor] = None, ip_scale=None) -> torch.Tensor:
        B, S, C = x.shape
        d = C // self.heads
        # the heads are counted from the projection's width: under tensor
        # parallelism (parallel/tp.py) a rank holds heads / tensor of them
        q = lin(self.to_q, x)
        h = q.shape[-1] // d
        q = q.reshape(B, S, h, d)
        k = lin(self.to_k, ctx).reshape(B, ctx.shape[1], h, d)
        v = lin(self.to_v, ctx).reshape(B, ctx.shape[1], h, d)
        o = attention(q, k, v).reshape(B, S, h * d)
        if ip_ctx is not None and hasattr(self, "to_k_ip"):
            # the decoupled image stream, over the same queries
            k_ip = lin(self.to_k_ip, ip_ctx).reshape(B, ip_ctx.shape[1], h, d)
            v_ip = lin(self.to_v_ip, ip_ctx).reshape(B, ip_ctx.shape[1], h, d)
            o_ip = attention(q, k_ip, v_ip).reshape(B, S, h * d)
            # the scale rounded to the compute dtype first, as JAX casts it
            scale = float(torch.tensor(1.0 if ip_scale is None else float(ip_scale),
                                       dtype=o.dtype))
            o = o + o_ip * scale
        return lin(self.to_out[0], o)


class GEGLU(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # ops/basic.geglu's gate over the dispatched projection, which may
        # be int8 (JAX's geglu calls its linear, ops/basic.py:156-161)
        h, gate = lin(self.proj, x).chunk(2, dim=-1)
        return h * gelu(gate)


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

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, ip_ctx=None, ip_scale=None,
                perturb_self: bool = False) -> torch.Tensor:
        h = ln(self.norm1, x)
        if perturb_self:
            # PAG: the identity attention map, each token attending to
            # itself alone, leaves to_out(to_v(h)); no attention runs
            x = x + lin(self.attn1.to_out[0], lin(self.attn1.to_v, h))
        else:
            x = x + self.attn1(h, h)
        x = x + self.attn2(ln(self.norm2, x), ctx, ip_ctx, ip_scale)
        return x + self.ff(ln(self.norm3, x))


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) -> proj_in -> transformer blocks -> proj_out,
    plus the residual.  proj_in/proj_out are 1x1 convolutions (SD1.x) or,
    with `linear`, linears on the token sequence (SD2.x, SDXL)."""

    def __init__(self, c: int, ctx_dim: int, heads: int, n_layers: int, groups: int,
                 linear: bool = False):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c) if linear else nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, ctx_dim, heads) for _ in range(n_layers)
        )
        self.proj_out = nn.Linear(c, c) if linear else nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, ip_ctx=None, ip_scale=None,
                perturb_self: bool = False) -> torch.Tensor:
        B, C, H, W = x.shape
        h = gn(self.norm, x)
        if self.linear:
            h = lin(self.proj_in, h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = conv(self.proj_in, h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, ctx, ip_ctx=ip_ctx, ip_scale=ip_scale, perturb_self=perturb_self)
        if self.linear:
            h = lin(self.proj_out, h)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return (h if self.linear else conv(self.proj_out, h)) + x


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


def _transformer(config: UNetConfig, c: int, i: int) -> Transformer2DModel:
    return Transformer2DModel(
        c, config.cross_attention_dim, config.heads_for_block(i), config.tf_layers_for_block(i),
        config.norm_num_groups, linear=config.use_linear_projection)


def build_down_blocks(config: UNetConfig):
    """(the down blocks, the channels of the skips they push, conv_in's
    first): the encoder the UNet and a ControlNet share."""
    ch, n, L = config.block_out_channels, len(config.block_out_channels), config.layers_per_block
    g, eps, temb = config.norm_num_groups, config.norm_eps, config.time_embed_dim
    down, skip_ch, c_in = [], [ch[0]], ch[0]
    for i, btype in enumerate(config.down_block_types):
        has_attn = btype == "CrossAttnDownBlock2D"
        resnets = [ResnetBlock2D(c_in if j == 0 else ch[i], ch[i], g, eps, temb)
                   for j in range(L)]
        attns = [_transformer(config, ch[i], i) for _ in range(L)] if has_attn else []
        skip_ch += [ch[i]] * L
        ds = Downsample2D(ch[i]) if i < n - 1 else None
        if ds is not None:
            skip_ch.append(ch[i])
        down.append(_Block(resnets, attns, "downsamplers", ds))
        c_in = ch[i]
    return nn.ModuleList(down), skip_ch


def build_mid_block(config: UNetConfig) -> _Block:
    c, temb = config.block_out_channels[-1], config.time_embed_dim
    return _Block([ResnetBlock2D(c, c, config.norm_num_groups, config.norm_eps, temb)
                   for _ in range(2)],
                  [_transformer(config, c, len(config.block_out_channels) - 1)], "", None)


class UNet2DConditionModel(nn.Module):
    """(sample NCHW, timesteps [] or [B], context [B, S, D][, added_cond])
    -> NCHW noise prediction (``unet.apply``)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = config
        ch = config.block_out_channels
        n = len(ch)
        L = config.layers_per_block
        g, eps = config.norm_num_groups, config.norm_eps
        temb = config.time_embed_dim

        self.conv_in = nn.Conv2d(config.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        if config.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                config.projection_class_embeddings_input_dim, temb)
        self.down_blocks, skip_ch = build_down_blocks(config)
        self.mid_block = build_mid_block(config)

        up, prev = [], ch[-1]
        for i, btype in enumerate(config.up_block_types):
            c = ch[n - 1 - i]
            resnets, attns = [], []
            for j in range(L + 1):
                resnets.append(ResnetBlock2D(prev + skip_ch.pop(), c, g, eps, temb))
                if btype == "CrossAttnUpBlock2D":
                    attns.append(_transformer(config, c, n - 1 - i))
                prev = c
            us = Upsample2D(c) if i < n - 1 else None
            up.append(_Block(resnets, attns, "upsamplers", us))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=eps)
        self.conv_out = nn.Conv2d(ch[0], config.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                deep_cache: Optional[torch.Tensor] = None,
                return_deep_cache: bool = False,
                down_block_residuals: Optional[List[torch.Tensor]] = None,
                mid_block_residual: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None,
                ip_scale=None,
                freeu: Optional[Tuple[float, float, float, float]] = None,
                pag_perturb: Optional[Tuple[str, ...]] = None):
        """`added_cond` is SDXL's {"text_embeds" [B, P], "time_ids" [B, n]},
        required by a ``text_time`` UNet and ignored by others, as in JAX.
        The other arguments are the extensions of the module docstring; with
        `return_deep_cache`, returns (output, deep feature)."""
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
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("an SDXL UNet needs added_cond text_embeds/time_ids")
            emb = emb + text_time_embedding(self.add_embedding, cfg, added_cond, sample)

        def with_res(h, idx):
            if down_block_residuals is None:
                return h
            return h + down_block_residuals[idx].to(h.dtype)

        pag = set(pag_perturb or ())
        attn_kw = dict(ip_ctx=ip_hidden_states, ip_scale=ip_scale)
        shallow = deep_cache is not None
        x = conv(self.conv_in, sample)
        skips: List[torch.Tensor] = [with_res(x, 0)]
        for block in (self.down_blocks[:1] if shallow else self.down_blocks):
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, emb)
                attn = block.attn(j)
                if attn is not None:
                    x = attn(x, ctx, perturb_self="down" in pag, **attn_kw)
                skips.append(with_res(x, len(skips)))
            if hasattr(block, "downsamplers") and not shallow:
                x = block.downsamplers[0](x)
                skips.append(with_res(x, len(skips)))

        deep_feature = None
        if shallow:
            x = deep_cache.to(dtype)
            up_blocks = [(len(self.up_blocks) - 1, self.up_blocks[-1])]
        else:
            mid = self.mid_block
            x = mid.resnets[0](x, emb)
            x = mid.attentions[0](x, ctx, perturb_self="mid" in pag, **attn_kw)
            x = mid.resnets[1](x, emb)
            if mid_block_residual is not None:
                x = x + mid_block_residual.to(x.dtype)
            up_blocks = list(enumerate(self.up_blocks))

        for i, block in up_blocks:
            if not shallow and i == len(self.up_blocks) - 1:
                deep_feature = x  # the input to the last up block: the cache
            for j, resnet in enumerate(block.resnets):
                skip = skips.pop()
                if freeu is not None and not shallow:
                    x, skip = apply_freeu(x, skip, i, freeu)
                x = resnet(torch.cat([x, skip], dim=1), emb)
                attn = block.attn(j)
                if attn is not None:
                    x = attn(x, ctx, perturb_self="up" in pag, **attn_kw)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        out = conv(self.conv_out, gn_silu(self.conv_norm_out, x))
        return (out, deep_feature) if return_deep_cache else out


def text_time_embedding(add_embedding: TimestepEmbedding, cfg: UNetConfig,
                        added_cond: Dict[str, torch.Tensor],
                        sample: torch.Tensor) -> torch.Tensor:
    """SDXL's micro-conditioning for `sample`'s batch, device and dtype: each
    time id's sinusoids, concatenated after the pooled embeds, through
    ``add_embedding`` (the UNet's and a ControlNet's alike)."""
    B = sample.shape[0]
    time_ids = torch.as_tensor(added_cond["time_ids"], device=sample.device)
    t_flat = timestep_embedding(
        time_ids.reshape(-1), cfg.addition_time_embed_dim,
        flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
    ).reshape(B, -1)
    add = torch.cat([added_cond["text_embeds"].float(), t_flat], dim=-1)
    return add_embedding(add.to(sample.dtype))
