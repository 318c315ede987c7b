"""Plain reference of a txt2img request: tokenize, encode the prompt and the
negative prompt, DDIM with classifier-free guidance, decode, quantize to
8 bits.  It follows the published pipelines (diffusers'
StableDiffusionPipeline and StableDiffusionXLPipeline with DDIMScheduler,
eta 0, "leading" timestep spacing) and recomputes everything from the
request and the weights; float32 throughout."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import models

CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-"
BOS, EOS = 49406, 49407


def tokenize(text: str, pad_id: int, length: int = 77) -> List[int]:
    """The benchmark's character vocabulary (each character one token, a
    word's last character its ``</w>`` form, ids 0-83; CLIP's start and end
    ids), CLIP's rule of truncation to length - 2 and right padding, for
    prompts of lower-case a-z words, which is all the traffic sends."""
    ids: List[int] = []
    for word in text.split():
        if not (word.isascii() and word.isalpha() and word.islower()):
            raise ValueError(f"the reference tokenizes lower-case a-z words only, not {word!r}")
        ids += [CHARS.index(c) for c in word[:-1]] + [CHARS.index(word[-1]) + len(CHARS)]
    ids = [BOS] + ids[: length - 2] + [EOS]
    return ids + [pad_id] * (length - len(ids))


def seed_of(seed: int, site: int) -> int:
    """The 64-bit generator seed of one (request seed, draw site) pair: the
    derivation the serving pipeline documents for its per-request noise."""
    return int(np.random.SeedSequence([int(seed) % 2**63, site]).generate_state(1, np.uint64)[0])


def initial_latents(seed: int, shape, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 0))
    return torch.randn(shape, generator=g, device=device)


def alphas_cumprod(sched: dict) -> np.ndarray:
    T = sched.get("num_train_timesteps", 1000)
    b0, b1 = sched.get("beta_start", 0.00085), sched.get("beta_end", 0.012)
    if sched.get("beta_schedule", "scaled_linear") == "scaled_linear":
        betas = np.linspace(b0**0.5, b1**0.5, T, dtype=np.float64) ** 2
    else:
        betas = np.linspace(b0, b1, T, dtype=np.float64)
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(sched: dict, steps: int) -> np.ndarray:
    T = sched.get("num_train_timesteps", 1000)
    ratio = T // steps
    return (np.arange(steps) * ratio)[::-1].astype(np.int64) + sched.get("steps_offset", 1)


def encode_prompts(weights: Dict[str, dict], configs: dict, prompts: List[str], device,
                   attn=models.attention):
    """-> (context [B, 77, D], pooled [B, P] or None) for SD1.x (the last
    state of CLIP-L) or SDXL (the penultimate states of both towers,
    concatenated; the projected pooled output of the second)."""
    if "text_encoder_2" not in configs:
        ids = torch.tensor([tokenize(t, EOS) for t in prompts], device=device)
        _, last, _ = models.clip_text(weights["text_encoder"], configs["text_encoder"], ids, attn)
        return last, None
    hs = []
    pooled = None
    for comp, pad in (("text_encoder", EOS), ("text_encoder_2", 0)):
        ids = torch.tensor([tokenize(t, pad) for t in prompts], device=device)
        states, _, pooled = models.clip_text(weights[comp], configs[comp], ids, attn)
        hs.append(states[-2])
    return torch.cat(hs, dim=-1), pooled


@torch.no_grad()
def txt2img(weights: Dict[str, dict], configs: dict, prompt: str, negative_prompt: Optional[str],
            seed: int, size: int, steps: int, guidance: float, device) -> torch.Tensor:
    """One request -> its image as float [H, W, 3] in [0, 255], rounded to
    whole levels as the served 8-bit image is."""
    ctx, pooled = encode_prompts(weights, configs, [negative_prompt or "", prompt], device)
    ucfg, vcfg = configs["unet"], configs["vae"]
    f = 2 ** (len(vcfg["block_out_channels"]) - 1)
    lat = initial_latents(seed, (1, ucfg.get("in_channels", 4), size // f, size // f), device)
    added = None
    if pooled is not None:
        ids = torch.tensor([[size, size, 0, 0, size, size]] * 2, dtype=torch.float32, device=device)
        added = {"text_embeds": pooled, "time_ids": ids}
    ac = alphas_cumprod(configs["scheduler"])
    ratio = configs["scheduler"].get("num_train_timesteps", 1000) // steps
    for t in ddim_timesteps(configs["scheduler"], steps):
        tt = torch.full((2,), int(t), device=device)
        eps_u, eps_t = models.unet(weights["unet"], ucfg, torch.cat([lat, lat]), tt, ctx, added).chunk(2)
        eps = eps_u + guidance * (eps_t - eps_u)
        a_t = float(ac[t])
        a_prev = float(ac[t - ratio]) if t - ratio >= 0 else float(ac[0])
        x0 = (lat - (1.0 - a_t) ** 0.5 * eps) / a_t**0.5
        lat = a_prev**0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps
    image = models.vae_decode(weights["vae"], vcfg, lat / vcfg["scaling_factor"])
    image = (image[0].permute(1, 2, 0) / 2.0 + 0.5).clamp(0.0, 1.0)
    return torch.round(image * 255.0)
