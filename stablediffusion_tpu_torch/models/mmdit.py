"""MM-DiT (SD3Transformer2DModel) as a torch module: SD3 and SD3.5.

Port of ``stablediffusion_tpu/models/mmdit.py``: the patch embedding with
its centre crop of the ``pos_embed_max_size`` grid (``_cropped_pos_embed``
:155), the timestep (float flow timesteps sigma * 1000, 256 frequencies,
``flip_sin_to_cos=True``, ``freq_shift=0``) and pooled-text embedders, the
``context_embedder``, the joint blocks (``_joint_block`` :105-153:
AdaLN-Zero with 6 chunks, 9 in the MMDiT-X ``dual`` blocks, whose
``attn2`` attends over the image stream alone; the last block is
``context_pre_only`` and modulates the text stream by (scale, shift) only),
the joint attention (``_joint_attention`` :54-87: image tokens first, then
the text tokens, in one ``attention()`` call; QK-RMSNorm under
``qk_norm="rms_norm"``), ``norm_out`` (whose chunks are (scale, shift), the
reverse of the blocks' shift-first order) and the unpatchify.  Module names
follow diffusers' SD3Transformer2DModel, so ``state_dict()`` keys equal the
checkpoint keys that the JAX param tree mirrors.

The JAX ``apply`` takes and returns NHWC latents; the port keeps its NCHW
convention at the module boundary and converts inside.  On the card the
joint attention is one ragged ``flash_fwd`` call: 4096 image tokens + 77
CLIP + 256 T5 tokens = 4429 at 1024², on both the query and the key side.
"""

from __future__ import annotations

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import SD3Config
from stablediffusion_tpu_torch.models.layers import conv, lin
from stablediffusion_tpu_torch.ops.attention import attention
from stablediffusion_tpu_torch.ops.basic import layer_norm, silu, timestep_embedding


def _ln_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return layer_norm(x, eps=eps)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _ln_noaffine(x) * (1.0 + scale[:, None]) + shift[:, None]


class RMSNorm(nn.Module):
    """QK-RMSNorm over the head dim: statistics in fp32, back in x's dtype."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (out * self.weight.float()).to(x.dtype)


class FeedForward(nn.Module):
    """diffusers FeedForward(activation_fn="gelu-approximate"): net.0.proj
    -> tanh-GELU -> net.2."""

    def __init__(self, d: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(d, 4 * d)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(4 * d, d)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nn.functional.gelu(lin(self.net[0].proj, x), approximate="tanh")
        return lin(self.net[2], h)


class _AdaLinear(nn.Module):
    """A modulation projection kept under ``<norm>.linear``."""

    def __init__(self, d: int, chunks: int):
        super().__init__()
        self.linear = nn.Linear(d, chunks * d)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return lin(self.linear, silu(temb))


def _heads(x: torch.Tensor, cfg: SD3Config) -> torch.Tensor:
    """[B, S, heads * head_dim] -> [B, S, heads, head_dim], the heads counted
    from the width (under tensor parallelism a rank holds a share of them)."""
    B, S, _ = x.shape
    return x.reshape(B, S, -1, cfg.attention_head_dim)


class JointAttention(nn.Module):
    """`to_q/k/v` over the image stream, `add_q/k/v_proj` over the text
    stream, one attention over [image; text]; `to_add_out` (absent in the
    context_pre_only block) projects the text part back."""

    def __init__(self, cfg: SD3Config, context_pre_only: bool):
        super().__init__()
        D, hd = cfg.dim, cfg.attention_head_dim
        self.cfg = cfg
        self.context_pre_only = context_pre_only
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, nn.Linear(D, D))
        self.to_out = nn.ModuleList([nn.Linear(D, D)])
        if not context_pre_only:
            self.to_add_out = nn.Linear(D, D)
        if cfg.qk_norm == "rms_norm":
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, name, RMSNorm(hd))

    def forward(self, x: torch.Tensor, ctx: torch.Tensor):
        cfg = self.cfg
        S = x.shape[1]
        q, k, v = (_heads(lin(m, x), cfg) for m in (self.to_q, self.to_k, self.to_v))
        qc, kc, vc = (_heads(lin(m, ctx), cfg)
                      for m in (self.add_q_proj, self.add_k_proj, self.add_v_proj))
        if cfg.qk_norm == "rms_norm":
            q, k = self.norm_q(q), self.norm_k(k)
            qc, kc = self.norm_added_q(qc), self.norm_added_k(kc)
        # image tokens first, then context (diffusers JointAttnProcessor order)
        o = attention(torch.cat([q, qc], 1), torch.cat([k, kc], 1), torch.cat([v, vc], 1))
        o = o.flatten(2)
        out_img = lin(self.to_out[0], o[:, :S])
        out_ctx = None if self.context_pre_only else lin(self.to_add_out, o[:, S:])
        return out_img, out_ctx


class ImageSelfAttention(nn.Module):
    """MMDiT-X ``attn2``: self-attention over the image stream alone."""

    def __init__(self, cfg: SD3Config):
        super().__init__()
        D = cfg.dim
        self.cfg = cfg
        self.to_q, self.to_k, self.to_v = nn.Linear(D, D), nn.Linear(D, D), nn.Linear(D, D)
        self.to_out = nn.ModuleList([nn.Linear(D, D)])
        if cfg.qk_norm == "rms_norm":
            self.norm_q = RMSNorm(cfg.attention_head_dim)
            self.norm_k = RMSNorm(cfg.attention_head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(lin(m, x), self.cfg) for m in (self.to_q, self.to_k, self.to_v))
        if self.cfg.qk_norm == "rms_norm":
            q, k = self.norm_q(q), self.norm_k(k)
        return lin(self.to_out[0], attention(q, k, v).flatten(2))


class JointTransformerBlock(nn.Module):
    def __init__(self, cfg: SD3Config, context_pre_only: bool, dual: bool):
        super().__init__()
        D = cfg.dim
        self.context_pre_only, self.dual = context_pre_only, dual
        self.norm1 = _AdaLinear(D, 9 if dual else 6)
        self.norm1_context = _AdaLinear(D, 2 if context_pre_only else 6)
        self.attn = JointAttention(cfg, context_pre_only)
        if dual:
            self.attn2 = ImageSelfAttention(cfg)
        self.ff = FeedForward(D)
        if not context_pre_only:
            self.ff_context = FeedForward(D)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, temb: torch.Tensor):
        mod = self.norm1(temb)
        if self.dual:
            # AdaLayerNormZeroX: 9 chunks, the extra 3 modulate and gate attn2
            (sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp,
             sh_msa2, sc_msa2, g_msa2) = mod.chunk(9, dim=-1)
            x_n2 = _modulate(x, sh_msa2, sc_msa2)
        else:
            sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = mod.chunk(6, dim=-1)
        x_n = _modulate(x, sh_msa, sc_msa)

        cmod = self.norm1_context(temb)
        if self.context_pre_only:
            # AdaLayerNormContinuous on the last block's text stream:
            # (scale, shift)
            c_sc, c_sh = cmod.chunk(2, dim=-1)
            ctx_n = _ln_noaffine(ctx) * (1.0 + c_sc[:, None]) + c_sh[:, None]
        else:
            c_sh_msa, c_sc_msa, c_g_msa, c_sh_mlp, c_sc_mlp, c_g_mlp = cmod.chunk(6, dim=-1)
            ctx_n = _modulate(ctx, c_sh_msa, c_sc_msa)

        attn_img, attn_ctx = self.attn(x_n, ctx_n)
        x = x + g_msa[:, None] * attn_img
        if self.dual:
            x = x + g_msa2[:, None] * self.attn2(x_n2)
        x = x + g_mlp[:, None] * self.ff(_modulate(x, sh_mlp, sc_mlp))
        if self.context_pre_only:
            return x, None
        ctx = ctx + c_g_msa[:, None] * attn_ctx
        ctx = ctx + c_g_mlp[:, None] * self.ff_context(_modulate(ctx, c_sh_mlp, c_sc_mlp))
        return x, ctx


class _MLPEmbedder(nn.Module):
    """linear_1 -> SiLU -> linear_2 (``timestep_embedder``, ``text_embedder``)."""

    def __init__(self, ci: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(ci, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lin(self.linear_2, silu(lin(self.linear_1, x)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.timestep_embedder = _MLPEmbedder(256, cfg.dim)
        self.text_embedder = _MLPEmbedder(cfg.pooled_projection_dim, cfg.dim)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        p, m = cfg.patch_size, cfg.pos_embed_max_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.dim, p, stride=p)
        self.pos_embed = nn.Parameter(torch.zeros(1, m * m, cfg.dim))


def cropped_pos_embed(pos_embed: torch.Tensor, h: int, w: int, max_size: int) -> torch.Tensor:
    """PatchEmbed.cropped_pos_embed: the centred h x w window of the stored
    max_size x max_size grid, [1, h*w, D]."""
    if h > max_size or w > max_size:
        raise ValueError(f"{h}x{w} patches exceed pos_embed_max_size {max_size}")
    top, left = (max_size - h) // 2, (max_size - w) // 2
    grid = pos_embed.reshape(1, max_size, max_size, -1)
    return grid[:, top:top + h, left:left + w].reshape(1, h * w, -1)


class SD3Transformer2DModel(nn.Module):
    """(latents [B, C, H, W], flow timestep [] or [B], text tokens
    [B, S_txt, joint_attention_dim], pooled [B, pooled_projection_dim]) ->
    the velocity [B, out_channels, H, W] (``mmdit.apply``)."""

    def __init__(self, config: SD3Config):
        super().__init__()
        self.config = config
        D = config.dim
        self.pos_embed = _PatchEmbed(config)
        self.time_text_embed = _TimeTextEmbed(config)
        self.context_embedder = nn.Linear(config.joint_attention_dim, D)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(config, i == config.num_layers - 1,
                                  i in config.dual_attention_layers)
            for i in range(config.num_layers))
        self.norm_out = _AdaLinear(D, 2)
        p = config.patch_size
        self.proj_out = nn.Linear(D, p * p * config.out_channels)

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        B, _, H, W = hidden_states.shape
        p = cfg.patch_size
        h, w = H // p, W // p
        dtype = hidden_states.dtype
        timestep = torch.as_tensor(timestep, device=hidden_states.device)
        if timestep.dim() == 0:
            timestep = timestep.expand(B)

        # patchify + positional embedding
        pe = self.pos_embed
        x = conv(pe.proj, hidden_states)
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D], row-major patches
        x = x + cropped_pos_embed(pe.pos_embed, h, w, cfg.pos_embed_max_size).to(dtype)

        # timestep + pooled-text conditioning
        tte = self.time_text_embed
        t_freq = timestep_embedding(timestep, 256, flip_sin_to_cos=True, freq_shift=0)
        temb = (tte.timestep_embedder(t_freq.to(dtype))
                + tte.text_embedder(pooled_projections.to(dtype)))

        ctx = lin(self.context_embedder, encoder_hidden_states.to(dtype))
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, temb)

        # final AdaLN-continuous: (scale, shift), then the projection
        scale, shift = self.norm_out(temb).chunk(2, dim=-1)
        x = _ln_noaffine(x) * (1.0 + scale[:, None]) + shift[:, None]
        x = lin(self.proj_out, x)

        # unpatchify -> NCHW
        x = x.reshape(B, h, w, p, p, cfg.out_channels)
        return x.permute(0, 5, 1, 3, 2, 4).reshape(B, cfg.out_channels, H, W)
