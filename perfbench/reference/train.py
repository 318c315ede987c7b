"""Plain reference of the LoRA training step (diffusers' train_text_to_image_lora
recipe, UNet-only LoRA): encode the images with the VAE and sample the
latents, add noise at random timesteps (DDPM's forward process), predict the
noise with the LoRA-adapted UNet, mean squared error; gradients of the LoRA
factors, clipped by their global norm, through AdamW with decoupled weight
decay and the constant-with-warmup learning rate.  float32 throughout.

The random draws follow the documented order of the trainer being held to
it: one ``torch.Generator`` seeded with the training seed draws the LoRA
factors (``down`` normal over the rank, ``up`` zero, the UNet's attention
projections in sorted order), then each step's latent sample, noise and
timesteps.  The step takes rows in blocks, summing their share of the mean,
so that the plain attention fits on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import models
from perfbench.reference.pipeline import EOS, alphas_cumprod, tokenize

LORA_SUFFIXES = ("to_q", "to_k", "to_v", "to_out.0")


def lora_paths(unet_shapes: Dict[str, tuple]) -> List[str]:
    paths = [k[: -len(".weight")] for k, s in unet_shapes.items()
             if k.endswith(".weight") and len(s) == 2]
    return sorted(p for p in paths if p.endswith(LORA_SUFFIXES))


def init_lora(unet_shapes: Dict[str, tuple], rank: int, generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    for p in lora_paths(unet_shapes):
        n_out, n_in = unet_shapes[p + ".weight"]
        out[p] = {"down": torch.randn(n_in, rank, generator=generator, device=generator.device) / rank,
                  "up": torch.zeros(rank, n_out, device=generator.device)}
    return out


def lr_at(count: int, lr: float, warmup: int) -> float:
    return lr * min(count / max(warmup, 1), 1.0)


class AdamW:
    """Global-norm clipping, then AdamW (bias-corrected moments, decay on
    every factor), as the published recipe's optimizer with its defaults."""

    def __init__(self, lr: float, warmup: int, b1=0.9, b2=0.999, eps=1e-8, wd=1e-2, clip=1.0):
        self.lr, self.warmup, self.b1, self.b2, self.eps, self.wd, self.clip = lr, warmup, b1, b2, eps, wd, clip
        self.count = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
        scale = self.clip / max(norm, self.clip)
        return {k: g * scale for k, g in grads.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        grads = self.clipped(grads)
        lr = lr_at(self.count, self.lr, self.warmup)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g)).mul_(self.b1).add_(g, alpha=1 - self.b1)
            v = self.v.setdefault(k, torch.zeros_like(g)).mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * params[k]
            params[k] -= lr * u


def flat(lora: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f"{p}.{n}": t for p, f in lora.items() for n, t in f.items()}


def adapted(unet_params: Dict[str, torch.Tensor], factors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The UNet's weights with each factored projection's W + (down @ up)ᵀ
    (alpha = rank, so the scale is 1)."""
    out = dict(unet_params)
    for key in {k.rsplit(".", 1)[0] for k in factors}:
        out[key + ".weight"] = unet_params[key + ".weight"] + (factors[key + ".down"] @ factors[key + ".up"]).t()
    return out


def load_pixels(paths: List[str], device, flips: Optional[List[bool]] = None) -> torch.Tensor:
    """The images as NCHW float in [-1, 1] (square images at the training
    resolution: no crop or resize), each mirrored left to right where
    `flips` says so."""
    from PIL import Image

    flips = flips or [False] * len(paths)
    arrs = [np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0 for p in paths]
    arrs = [a[:, ::-1] if f else a for a, f in zip(arrs, flips)]
    return torch.from_numpy(np.stack(arrs) * 2.0 - 1.0).permute(0, 3, 1, 2).to(device)


def step_loss_and_grads(weights: dict, configs: dict, factors: Dict[str, torch.Tensor],
                        pixels: torch.Tensor, captions: List[str], generator: torch.Generator,
                        block: int = 2, quantize=None):
    """(loss, {factor: gradient}) of one step over the batch; the step's draws
    come from `generator`.  `quantize` (weights -> weights) stands in for a
    lower-precision product (the control)."""
    device = pixels.device
    vcfg, ucfg = configs["vae"], configs["unet"]
    vae_p, unet_p, te_p = weights["vae"], weights["unet"], weights["text_encoder"]
    if quantize is not None:
        vae_p, unet_p, te_p = quantize(vae_p), quantize(unet_p), quantize(te_p)
    B = pixels.shape[0]
    with torch.no_grad():
        moments = [models.vae_encode(vae_p, vcfg, pixels[i:i + block]) for i in range(0, B, block)]
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
    eps = torch.randn(mean.shape, generator=generator, device=device)
    latents = (mean + torch.exp(0.5 * logvar) * eps) * vcfg["scaling_factor"]
    noise = torch.randn(latents.shape, generator=generator, device=device)
    T = configs["scheduler"].get("num_train_timesteps", 1000)
    t = torch.randint(0, T, (B,), generator=generator, device=device)
    ac = torch.from_numpy(alphas_cumprod(configs["scheduler"])).to(device)[t][:, None, None, None]
    noisy = ac.sqrt() * latents + (1 - ac).sqrt() * noise
    ids = torch.tensor([tokenize(c, EOS) for c in captions], device=device)
    with torch.no_grad():
        _, ctx, _ = models.clip_text(te_p, configs["text_encoder"], ids)
    leaves = {k: v.detach().requires_grad_(True) for k, v in factors.items()}
    grads = {k: torch.zeros_like(v) for k, v in factors.items()}
    total = 0.0
    for i in range(0, B, block):
        sl = slice(i, i + block)
        params = adapted(unet_p, leaves)
        pred = models.unet(params, ucfg, noisy[sl], t[sl], ctx[sl])
        part = ((pred - noise[sl]) ** 2).mean(dim=(1, 2, 3)).sum() / B
        for k, g in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
            grads[k] += g
        total += float(part.detach())
    return total, grads


def quantize_fp8(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every matrix and kernel rounded to float8 e4m3 with a per-tensor
    scale (the next precision below bf16); vectors as they are."""
    out = {}
    for k, w in params.items():
        if w.dim() < 2:
            out[k] = w
            continue
        s = w.abs().max().clamp_min(1e-12) / 448.0
        out[k] = (w / s).to(torch.float8_e4m3fn).to(w.dtype) * s
    return out
