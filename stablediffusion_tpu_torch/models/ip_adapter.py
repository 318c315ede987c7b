"""IP-Adapter (arXiv 2308.06721): image-prompt conditioning.

Port of ``stablediffusion_tpu/models/ip_adapter.py``.  A checkpoint holds
two flat groups (``load_ip_adapter_file`` :252):

  * ``image_proj``: the standard ImageProjModel (``proj``, ``norm``), which
    maps the CLIP image embed to 4 context tokens, or IP-Adapter Plus's
    perceiver Resampler (``latents``, ``proj_in``, ``proj_out``,
    ``norm_out``, ``layers.*``) over the image encoder's penultimate hidden
    states; its config is read off the shapes (``ImageProjConfig`` :130-172);
  * ``ip_adapter``: ``{2i+1}.to_k_ip.weight`` / ``to_v_ip.weight`` for the
    i-th cross-attention in diffusers' ``attn_processors`` order: the down
    blocks, the up blocks, then the mid-block (``cross_attn_paths`` :42).

``fuse_ip_weights`` (:74) adds the projections to the UNet's cross-attention
modules as bias-free linears (``models/unet.Attention`` runs the decoupled
stream when they are there and image tokens are given); ``strip_ip_weights``
(:111) removes them.  The image-projection modules keep the checkpoint's key
names, so their ``state_dict()`` is the ``image_proj`` group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stablediffusion_tpu_torch.core.config import UNetConfig
from stablediffusion_tpu_torch.models.layers import lin, ln
from stablediffusion_tpu_torch.ops.attention import attention


def cross_attn_paths(config: UNetConfig) -> List[Tuple[str, ...]]:
    """The path of every attn2 in diffusers' ``attn_processors`` order
    (the down and up ModuleLists are made before the mid-block, so the mid
    comes last)."""
    paths: List[Tuple[str, ...]] = []
    L = config.layers_per_block
    for i, btype in enumerate(config.down_block_types):
        if btype != "CrossAttnDownBlock2D":
            continue
        for j in range(L):
            for t in range(config.tf_layers_for_block(i)):
                paths.append(("down_blocks", str(i), "attentions", str(j),
                              "transformer_blocks", str(t), "attn2"))
    n_blocks = len(config.block_out_channels)
    for i, btype in enumerate(config.up_block_types):
        if btype != "CrossAttnUpBlock2D":
            continue
        for j in range(L + 1):
            for t in range(config.tf_layers_for_block(n_blocks - 1 - i)):
                paths.append(("up_blocks", str(i), "attentions", str(j),
                              "transformer_blocks", str(t), "attn2"))
    for t in range(config.tf_layers_for_block(n_blocks - 1)):
        paths.append(("mid_block", "attentions", "0", "transformer_blocks", str(t), "attn2"))
    return paths


IP_NAMES = ("to_k_ip", "to_v_ip")


def fuse_ip_weights(unet: nn.Module, config: UNetConfig,
                    ip_sd: Mapping[str, torch.Tensor]) -> None:
    """Give each attn2 of `unet` its ``to_k_ip`` / ``to_v_ip`` from the
    ``ip_adapter`` group (torch layout [out, in]), on the UNet's device and
    in its dtype, in place; raises, changing nothing, unless the group
    fits every cross-attention."""
    paths = cross_attn_paths(config)
    found = {}
    for i, path in enumerate(paths):
        kw = ip_sd.get(f"{2 * i + 1}.to_k_ip.weight")
        vw = ip_sd.get(f"{2 * i + 1}.to_v_ip.weight")
        if kw is not None and vw is not None:
            found[".".join(path)] = (kw, vw)
    if len(found) != len(paths):
        raise ValueError(f"IP-Adapter weights matched {len(found)}/{len(paths)} "
                         "cross-attention layers: the checkpoint does not fit this UNet config")
    ref = next(unet.parameters())
    for path, (kw, vw) in found.items():
        attn = unet.get_submodule(path)
        for name, w in zip(IP_NAMES, (kw, vw)):
            m = nn.Linear(w.shape[1], w.shape[0], bias=False, device=ref.device, dtype=ref.dtype)
            with torch.no_grad():
                m.weight.copy_(torch.as_tensor(w))
            setattr(attn, name, m.requires_grad_(False))


def strip_ip_weights(unet: nn.Module) -> None:
    """Remove every ``to_k_ip`` / ``to_v_ip`` from `unet`, in place."""
    for m in list(unet.modules()):
        for name in IP_NAMES:
            if name in m._modules:
                del m._modules[name]


@dataclass(frozen=True)
class ImageProjConfig:
    kind: str  # "proj" (standard) | "resampler" (Plus)
    num_tokens: int
    cross_attention_dim: int
    # the resampler's
    dim: int = 0
    depth: int = 0
    heads: int = 0
    dim_head: int = 64
    embedding_dim: int = 0


def infer_image_proj_config(image_proj_sd: Mapping[str, torch.Tensor]) -> ImageProjConfig:
    """The image projection's config from its tensors' shapes."""
    if "proj.weight" in image_proj_sd:
        w = image_proj_sd["proj.weight"]  # [tokens * xdim, clip dim]
        xdim = int(image_proj_sd["norm.weight"].shape[0])
        return ImageProjConfig(kind="proj", num_tokens=int(w.shape[0]) // xdim,
                               cross_attention_dim=xdim)
    if "latents" in image_proj_sd:
        latents = image_proj_sd["latents"]  # [1, queries, dim]
        depth = 0
        while f"layers.{depth}.0.to_q.weight" in image_proj_sd:
            depth += 1
        dim_head = 64
        inner = int(image_proj_sd["layers.0.0.to_q.weight"].shape[0])
        return ImageProjConfig(
            kind="resampler", num_tokens=int(latents.shape[1]),
            cross_attention_dim=int(image_proj_sd["proj_out.weight"].shape[0]),
            dim=int(latents.shape[2]), depth=depth, heads=inner // dim_head,
            dim_head=dim_head, embedding_dim=int(image_proj_sd["proj_in.weight"].shape[1]))
    raise ValueError(f"unrecognized image_proj keys: {sorted(image_proj_sd)[:8]}")


def _linear(keys, name: str, fin: int, fout: int) -> nn.Linear:
    return nn.Linear(fin, fout, bias=f"{name}.bias" in keys)


class ImageProjModel(nn.Module):
    """The standard projection: [B, clip dim] -> [B, tokens, xdim]
    (``image_proj_apply``)."""

    def __init__(self, cfg: ImageProjConfig, clip_dim: int, keys=("proj.bias",)):
        super().__init__()
        self.cfg = cfg
        self.proj = _linear(keys, "proj", clip_dim, cfg.num_tokens * cfg.cross_attention_dim)
        self.norm = nn.LayerNorm(cfg.cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = lin(self.proj, image_embeds)
        return ln(self.norm, x.reshape(x.shape[0], self.cfg.num_tokens,
                                       self.cfg.cross_attention_dim))


class PerceiverAttention(nn.Module):
    """q from the latents, k and v from [x, latents] (tencent-ailab's
    resampler.py; its double square-root scale on q and k is D**-0.5)."""

    def __init__(self, cfg: ImageProjConfig, keys, prefix: str):
        super().__init__()
        inner = cfg.heads * cfg.dim_head
        self.heads, self.dim_head = cfg.heads, cfg.dim_head
        self.norm1 = nn.LayerNorm(cfg.dim)
        self.norm2 = nn.LayerNorm(cfg.dim)
        self.to_q = _linear(keys, f"{prefix}.to_q", cfg.dim, inner)
        self.to_kv = _linear(keys, f"{prefix}.to_kv", cfg.dim, 2 * inner)
        self.to_out = _linear(keys, f"{prefix}.to_out", inner, cfg.dim)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = ln(self.norm1, x)
        lat = ln(self.norm2, latents)
        B, Nl, _ = lat.shape
        kv_in = torch.cat([x, lat], dim=1)
        k, v = lin(self.to_kv, kv_in).chunk(2, dim=-1)
        shape = lambda t: t.reshape(B, t.shape[1], self.heads, self.dim_head)  # noqa: E731
        out = attention(shape(lin(self.to_q, lat)), shape(k), shape(v),
                        scale=self.dim_head**-0.5)
        return lin(self.to_out, out.reshape(B, Nl, self.heads * self.dim_head))


class Resampler(nn.Module):
    """IP-Adapter Plus: the penultimate CLIP hidden states [B, S, embed] ->
    [B, queries, xdim] (``resampler_apply`` :192-236)."""

    def __init__(self, cfg: ImageProjConfig, keys=(), ff_mult: int = 4):
        super().__init__()
        self.cfg = cfg
        self.latents = nn.Parameter(torch.zeros(1, cfg.num_tokens, cfg.dim))
        self.proj_in = _linear(keys, "proj_in", cfg.embedding_dim, cfg.dim)
        layers = []
        for d in range(cfg.depth):
            ff = nn.Sequential(nn.LayerNorm(cfg.dim),
                               _linear(keys, f"layers.{d}.1.1", cfg.dim, cfg.dim * ff_mult),
                               nn.GELU(),
                               _linear(keys, f"layers.{d}.1.3", cfg.dim * ff_mult, cfg.dim))
            layers.append(nn.ModuleList([PerceiverAttention(cfg, keys, f"layers.{d}.0"), ff]))
        self.layers = nn.ModuleList(layers)
        self.proj_out = _linear(keys, "proj_out", cfg.dim, cfg.cross_attention_dim)
        self.norm_out = nn.LayerNorm(cfg.cross_attention_dim)

    def forward(self, image_hidden: torch.Tensor) -> torch.Tensor:
        B = image_hidden.shape[0]
        latents = self.latents.to(image_hidden.dtype).expand(B, -1, -1)
        x = lin(self.proj_in, image_hidden)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            h = lin(ff[1], ln(ff[0], latents))
            latents = lin(ff[3], F.gelu(h, approximate="none")) + latents
        return ln(self.norm_out, lin(self.proj_out, latents))


def build_image_proj(cfg: ImageProjConfig, image_proj_sd: Mapping[str, torch.Tensor]
                     ) -> nn.Module:
    """The image projection module that `image_proj_sd` fills (its biases
    where the group has them)."""
    keys = set(image_proj_sd)
    if cfg.kind == "proj":
        return ImageProjModel(cfg, int(image_proj_sd["proj.weight"].shape[1]), keys)
    return Resampler(cfg, keys)


def project_image_embeds(proj: nn.Module, feats: torch.Tensor) -> torch.Tensor:
    """The projected image embeds (standard) or hidden states (Plus) as
    context tokens (``project_image_embeds`` :238)."""
    return proj(feats.to(next(proj.parameters()).dtype))


def load_ip_adapter_file(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(image_proj, ip_adapter) of a checkpoint: a .safetensors with
    ``image_proj.`` / ``ip_adapter.`` key prefixes, or a torch file of two
    nested dicts (read with ``weights_only=True``); CPU tensors in their
    stored dtypes, torch layout."""
    if path.endswith(".safetensors"):
        from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile

        with SafetensorsFile(path) as f:
            flat = {k: f.torch_tensor(k).clone() for k in f.keys()}
        groups = {g: {k[len(g) + 1:]: v for k, v in flat.items() if k.startswith(g + ".")}
                  for g in ("image_proj", "ip_adapter")}
    else:
        if not os.path.exists(path):
            raise FileNotFoundError(f"IP-Adapter checkpoint {path!r} not found")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        groups = {g: dict(sd.get(g, {})) for g in ("image_proj", "ip_adapter")}
    if not groups["image_proj"] or not groups["ip_adapter"]:
        raise ValueError(f"{path}: missing image_proj/ip_adapter groups")
    return groups["image_proj"], groups["ip_adapter"]


@dataclass
class IPAdapter:
    """A loaded IP-Adapter's image projection, held by the model."""

    config: ImageProjConfig
    image_proj: nn.Module
    num_tokens: int

    @classmethod
    def load(cls, path: str, device: torch.device, dtype: torch.dtype
             ) -> Tuple["IPAdapter", Dict[str, torch.Tensor]]:
        """(the adapter, its ``ip_adapter`` group) of a checkpoint file; the
        projection on `device` in `dtype`."""
        image_proj_sd, ip_sd = load_ip_adapter_file(path)
        cfg = infer_image_proj_config(image_proj_sd)
        proj = build_image_proj(cfg, image_proj_sd)
        proj.load_state_dict(image_proj_sd)
        proj = proj.to(device=device, dtype=dtype).eval().requires_grad_(False)
        return cls(cfg, proj, cfg.num_tokens), ip_sd
