"""Plain PyTorch reference of the Stable Diffusion models the benchmark serves
and trains: CLIP text towers, the UNet2DCondition (SD1.x and SDXL layouts)
and the AutoencoderKL, written from the published architecture (diffusers'
and transformers' module layout and parameter names).

Every function takes a flat ``params`` dict under the diffusers key names and
the published ``config.json`` dict of its component, computes in the dtype of
its inputs (float32 in the benchmark, with TF32 off), and takes the attention
as an argument, so that the same graph can be counted on the meta device
(``harness/flops.py``).  Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over q [B, Sq, H, D], k/v [B, Skv, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


Attn = Callable[..., torch.Tensor]


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def _conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"), stride=stride, padding=padding)


def _gn(p: Params, name: str, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"], eps)


def _ln(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def sinusoids(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, freq_shift: float = 0.0) -> torch.Tensor:
    """diffusers' get_timestep_embedding: [N] -> [N, dim] float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - freq_shift))
    arg = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(arg), torch.cos(arg)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# --------------------------------------------------------------------- CLIP

def clip_text(p: Params, cfg: dict, ids: torch.Tensor, attn: Attn = attention,
              eos_id: int = 49407) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """transformers' CLIPTextModel[WithProjection]: (hidden states of the
    embeddings and of every layer, the final-normed last state, the projected
    pooled output or None).  The pooled row is the first `eos_id` token, which
    is what transformers' legacy rule (config eos_token_id 2: the row of the
    largest id) picks for CLIP's vocabulary, where the end token is the
    largest id."""
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg.get("layer_norm_eps", 1e-5)
    act = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
           "gelu": lambda x: F.gelu(x)}[cfg["hidden_act"]]
    B, S = ids.shape
    x = p["text_model.embeddings.token_embedding.weight"][ids]
    x = x + p["text_model.embeddings.position_embedding.weight"][:S]
    states = [x]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"text_model.encoder.layers.{i}"
        h = _ln(p, pre + ".layer_norm1", x, eps)
        q, k, v = (_linear(p, f"{pre}.self_attn.{n}_proj", h).reshape(B, S, heads, H // heads)
                   for n in "qkv")
        x = x + _linear(p, pre + ".self_attn.out_proj", attn(q, k, v, causal=True).reshape(B, S, H))
        h = _ln(p, pre + ".layer_norm2", x, eps)
        x = x + _linear(p, pre + ".mlp.fc2", act(_linear(p, pre + ".mlp.fc1", h)))
        states.append(x)
    last = _ln(p, "text_model.final_layer_norm", x, eps)
    eos = (ids == eos_id).int().argmax(dim=-1)
    pooled = last[torch.arange(B, device=ids.device), eos]
    projected = F.linear(pooled, p["text_projection.weight"]) if "text_projection.weight" in p else None
    return states, last, projected


# --------------------------------------------------------------------- UNet

def _resnet(p: Params, pre: str, x: torch.Tensor, emb: Optional[torch.Tensor], groups: int,
            eps: float) -> torch.Tensor:
    h = _conv(p, pre + ".conv1", F.silu(_gn(p, pre + ".norm1", x, groups, eps)))
    if emb is not None:
        h = h + _linear(p, pre + ".time_emb_proj", F.silu(emb))[:, :, None, None]
    h = _conv(p, pre + ".conv2", F.silu(_gn(p, pre + ".norm2", h, groups, eps)))
    if pre + ".conv_shortcut.weight" in p:
        x = _conv(p, pre + ".conv_shortcut", x, padding=0)
    return x + h


def _mha(p: Params, pre: str, x: torch.Tensor, ctx: torch.Tensor, heads: int, attn: Attn) -> torch.Tensor:
    B, S, C = x.shape
    q = _linear(p, pre + ".to_q", x).reshape(B, S, heads, C // heads)
    k = _linear(p, pre + ".to_k", ctx).reshape(B, ctx.shape[1], heads, C // heads)
    v = _linear(p, pre + ".to_v", ctx).reshape(B, ctx.shape[1], heads, C // heads)
    return _linear(p, pre + ".to_out.0", attn(q, k, v).reshape(B, S, C))


def _transformer(p: Params, pre: str, x: torch.Tensor, ctx: torch.Tensor, heads: int, depth: int,
                 groups: int, linear_proj: bool, attn: Attn) -> torch.Tensor:
    B, C, H, W = x.shape
    h = _gn(p, pre + ".norm", x, groups, 1e-6)
    if linear_proj:
        h = _linear(p, pre + ".proj_in", h.permute(0, 2, 3, 1).reshape(B, H * W, C))
    else:
        h = _conv(p, pre + ".proj_in", h, padding=0).permute(0, 2, 3, 1).reshape(B, H * W, C)
    for d in range(depth):
        blk = f"{pre}.transformer_blocks.{d}"
        n = _ln(p, blk + ".norm1", h)
        h = h + _mha(p, blk + ".attn1", n, n, heads, attn)
        h = h + _mha(p, blk + ".attn2", _ln(p, blk + ".norm2", h), ctx, heads, attn)
        a, gate = _linear(p, blk + ".ff.net.0.proj", _ln(p, blk + ".norm3", h)).chunk(2, dim=-1)
        h = h + _linear(p, blk + ".ff.net.2", a * F.gelu(gate))
    if linear_proj:
        h = _linear(p, pre + ".proj_out", h).reshape(B, H, W, C).permute(0, 3, 1, 2)
    else:
        h = _conv(p, pre + ".proj_out", h.reshape(B, H, W, C).permute(0, 3, 1, 2), padding=0)
    return h + x


def _per_block(v, n: int) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def unet(p: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
         added: Optional[Dict[str, torch.Tensor]] = None, attn: Attn = attention) -> torch.Tensor:
    """diffusers' UNet2DConditionModel forward: NCHW sample, timesteps [B],
    context [B, S, D] -> the NCHW prediction.  SDXL's ``text_time``
    conditioning takes ``added`` = {"text_embeds", "time_ids"}."""
    ch = list(cfg["block_out_channels"])
    n = len(ch)
    L = cfg.get("layers_per_block", 2)
    groups, eps = cfg.get("norm_num_groups", 32), cfg.get("norm_eps", 1e-5)
    # diffusers' quirk: attention_head_dim holds the head count when
    # num_attention_heads is not given
    heads = _per_block(cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8), n)
    depth = _per_block(cfg.get("transformer_layers_per_block", 1), n)
    lin = bool(cfg.get("use_linear_projection", False))
    flip, shift = cfg.get("flip_sin_to_cos", True), cfg.get("freq_shift", 0)

    emb = sinusoids(t, ch[0], flip, shift).to(x.dtype)
    emb = _linear(p, "time_embedding.linear_2", F.silu(_linear(p, "time_embedding.linear_1", emb)))
    if cfg.get("addition_embed_type") == "text_time":
        B = x.shape[0]
        tid = sinusoids(added["time_ids"].reshape(-1), cfg["addition_time_embed_dim"], flip, shift)
        aug = torch.cat([added["text_embeds"], tid.reshape(B, -1).to(x.dtype)], dim=-1)
        emb = emb + _linear(p, "add_embedding.linear_2", F.silu(_linear(p, "add_embedding.linear_1", aug)))

    h = _conv(p, "conv_in", x)
    skips = [h]
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(L):
            h = _resnet(p, f"down_blocks.{i}.resnets.{j}", h, emb, groups, eps)
            if kind == "CrossAttnDownBlock2D":
                h = _transformer(p, f"down_blocks.{i}.attentions.{j}", h, ctx, heads[i], depth[i],
                                 groups, lin, attn)
            skips.append(h)
        if i < n - 1:
            h = _conv(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
            skips.append(h)
    h = _resnet(p, "mid_block.resnets.0", h, emb, groups, eps)
    h = _transformer(p, "mid_block.attentions.0", h, ctx, heads[-1], depth[-1], groups, lin, attn)
    h = _resnet(p, "mid_block.resnets.1", h, emb, groups, eps)
    for i, kind in enumerate(cfg["up_block_types"]):
        r = n - 1 - i
        for j in range(L + 1):
            h = _resnet(p, f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=1), emb,
                        groups, eps)
            if kind == "CrossAttnUpBlock2D":
                h = _transformer(p, f"up_blocks.{i}.attentions.{j}", h, ctx, heads[r], depth[r],
                                 groups, lin, attn)
        if i < n - 1:
            h = _conv(p, f"up_blocks.{i}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0,
                                                                           mode="nearest"))
    return _conv(p, "conv_out", F.silu(_gn(p, "conv_norm_out", h, groups, eps)))


# ---------------------------------------------------------------------- VAE

def _vae_mid(p: Params, pre: str, x: torch.Tensor, groups: int, eps: float, attn: Attn) -> torch.Tensor:
    x = _resnet(p, pre + ".resnets.0", x, None, groups, eps)
    B, C, H, W = x.shape
    h = _gn(p, pre + ".attentions.0.group_norm", x, groups, eps).permute(0, 2, 3, 1).reshape(B, H * W, C)
    q, k, v = (_linear(p, f"{pre}.attentions.0.to_{n}", h)[:, :, None, :] for n in "qkv")
    o = _linear(p, pre + ".attentions.0.to_out.0", attn(q, k, v)[:, :, 0, :])
    x = x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return _resnet(p, pre + ".resnets.1", x, None, groups, eps)


def vae_decode(p: Params, cfg: dict, z: torch.Tensor, attn: Attn = attention) -> torch.Tensor:
    """AutoencoderKL.decode of unscaled latents -> NCHW image in about [-1, 1]."""
    groups, eps = cfg.get("norm_num_groups", 32), 1e-6
    ch = list(reversed(cfg["block_out_channels"]))
    L = cfg.get("layers_per_block", 2)
    if "post_quant_conv.weight" in p:
        z = _conv(p, "post_quant_conv", z, padding=0)
    x = _vae_mid(p, "decoder.mid_block", _conv(p, "decoder.conv_in", z), groups, eps, attn)
    for i in range(len(ch)):
        for j in range(L + 1):
            x = _resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", x, None, groups, eps)
        if i < len(ch) - 1:
            x = _conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(x, scale_factor=2.0, mode="nearest"))
    return _conv(p, "decoder.conv_out", F.silu(_gn(p, "decoder.conv_norm_out", x, groups, eps)))


def vae_encode(p: Params, cfg: dict, image: torch.Tensor, attn: Attn = attention) -> Tuple[torch.Tensor, torch.Tensor]:
    """AutoencoderKL.encode of an NCHW image in [-1, 1] -> (mean, logvar
    clipped to [-30, 20]), unscaled."""
    groups, eps = cfg.get("norm_num_groups", 32), 1e-6
    ch = list(cfg["block_out_channels"])
    x = _conv(p, "encoder.conv_in", image)
    for i in range(len(ch)):
        for j in range(cfg.get("layers_per_block", 2)):
            x = _resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", x, None, groups, eps)
        if i < len(ch) - 1:
            x = _conv(p, f"encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(x, (0, 1, 0, 1)),
                      stride=2, padding=0)
    x = _vae_mid(p, "encoder.mid_block", x, groups, eps, attn)
    x = _conv(p, "encoder.conv_out", F.silu(_gn(p, "encoder.conv_norm_out", x, groups, eps)))
    if "quant_conv.weight" in p:
        x = _conv(p, "quant_conv", x, padding=0)
    mean, logvar = x.chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)
