"""The SD1.5 LoRA train step.

Port of the SD1.5 LoRA path of ``stablediffusion_tpu/train/train_step.py``
(``compute_snr``, ``min_snr_weight``, ``TrainStatics``,
``encode_prompt_train``, ``_prepare_diffusion``, ``_prediction_loss``,
``loss_fn``, ``make_train_step``): VAE encode -> noise and random timesteps
-> add_noise -> text encode -> UNet forward with LoRA-fused weights ->
epsilon or velocity MSE with optional Min-SNR weighting -> gradients to the
LoRA factors -> clip + AdamW.

Where the JAX step is one jitted function, this one runs eagerly:

  * The VAE encode and the text encode run under ``torch.no_grad()``; the
    VAE's mid-block attention therefore takes the forward-only
    flash_stream kernel on the card.
  * The UNet runs through ``torch.func.functional_call`` with the fused
    weights of ``lora/core.apply_lora_for_training``, in the compute dtype
    (bf16 on the card); the loss is fp32.  Its attention differentiates
    through the backward kernels (``ops/attention.FlashAttnFn``).
  * The random draws (the latent epsilon, the noise, the timesteps, the
    offset noise) come from a ``torch.Generator``, or are injected through
    ``draws=``: ``jax.random`` cannot be reproduced in torch, so the parity
    tests hand both sides the same numbers.
  * ``remat_policy`` "full" wraps the UNet forward in
    ``torch.utils.checkpoint`` (JAX ``jax.checkpoint``).

Layouts: the batch keeps the JAX package's public NHWC (``pixel_values``
[B, H, W, 3] in [-1, 1], ``latents`` [B, h, w, 4]); the draws are NCHW, the
layout the step computes in.  SDXL, text-encoder training, textual
inversion, ControlNet and the "dots" / "offload" remat policies belong to
later slices and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from stablediffusion_tpu_torch.lora.core import apply_lora_for_training
from stablediffusion_tpu_torch.models.vae import sample_latent
from stablediffusion_tpu_torch.schedulers.common import BaseScheduler
from stablediffusion_tpu_torch.train.optim import AdamW, global_norm, tree_leaves

_LATER = "the trainer slice of the port (ROADMAP §1 item 19)"


def compute_snr(alphas_cumprod, timesteps: torch.Tensor) -> torch.Tensor:
    """SNR(t) = alpha_bar / (1 - alpha_bar), fp32, on timesteps' device."""
    ac = torch.as_tensor(alphas_cumprod, device=timesteps.device)[timesteps.long()]
    return ac / (1.0 - ac)


def min_snr_weight(snr: torch.Tensor, gamma: float, prediction_type: str) -> torch.Tensor:
    """Min-SNR-gamma loss weighting (arXiv 2303.09556)."""
    capped = torch.clamp(snr, max=gamma)
    if prediction_type == "v_prediction":
        return capped / (snr + 1.0)
    return capped / torch.clamp(snr, min=1e-8)


@dataclass(frozen=True)
class TrainStatics:
    """Static settings of the step, with the JAX package's field names.  The
    SD1.5 LoRA path reads the configs, ``snr_gamma``, ``noise_offset``,
    ``compute_dtype``, ``vae_microbatch``, ``remat_policy`` and
    ``prior_loss_weight``; the other fields must keep their defaults (their
    paths raise).  JAX's legacy ``gradient_checkpointing`` flag is
    ``remat_policy="full"`` here, and the VAE encodes in its own parameters'
    dtype (JAX's ``vae_dtype``)."""

    unet_config: UNetConfig
    vae_config: VAEConfig
    text_config: CLIPTextConfig
    text_config_2: Optional[CLIPTextConfig]
    scheduler_config: SchedulerConfig
    train_text_encoder: bool
    snr_gamma: Optional[float]
    noise_offset: float = 0.0
    compute_dtype: torch.dtype = torch.bfloat16
    # encode pixels through the VAE in chunks of this many images (0: all)
    vae_microbatch: int = 0
    # "none" | "full" (torch.utils.checkpoint around the UNet forward)
    remat_policy: str = "none"
    controlnet_config: Optional[UNetConfig] = None
    ti_rows: Optional[tuple] = None
    ti_rows_2: Optional[tuple] = None
    # DreamBooth prior preservation: [instance | class] batch halves
    prior_loss_weight: Optional[float] = None

    @property
    def is_sdxl(self) -> bool:
        return self.text_config_2 is not None


def check_supported(statics: TrainStatics) -> None:
    """Raise on settings whose path this slice does not port."""
    if statics.is_sdxl:
        raise NotImplementedError(f"SDXL training comes with {_LATER}, after SDXL inference")
    if statics.train_text_encoder:
        raise NotImplementedError(f"train_text_encoder (text-encoder LoRA) comes with {_LATER}")
    if statics.ti_rows is not None or statics.ti_rows_2 is not None:
        raise NotImplementedError(f"textual-inversion training comes with {_LATER}")
    if statics.controlnet_config is not None:
        raise NotImplementedError(f"ControlNet training comes with {_LATER}")
    _remat_policy(statics)


def _remat_policy(statics: TrainStatics) -> str:
    policy = statics.remat_policy
    if policy in ("dots", "offload"):
        raise NotImplementedError(f"remat_policy {policy!r} comes with {_LATER}")
    if policy not in ("none", "full"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    return policy


@torch.no_grad()
def encode_prompt_train(statics: TrainStatics, text_encoder, input_ids: torch.Tensor):
    """Train-time prompt encoding, SD1.5: (last_hidden_state, None)."""
    if statics.is_sdxl:
        raise NotImplementedError(f"SDXL prompt encoding comes with {_LATER}")
    return text_encoder(input_ids).last_hidden_state, None


def _prepare_diffusion(
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: TrainStatics,
    scheduler: BaseScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
):
    """Forward diffusion: (latents, noise, timesteps, noisy, embeds), the
    latents NCHW fp32.  Draws, in this order, from `generator` unless
    `draws` holds them (NCHW, on the step's device): "latent_eps" [B, 4, h,
    w] for the latent sample, "noise" [B, 4, h, w], "timesteps" [B] in
    [0, T), and, with a noise offset, "offset" [B, 4, 1, 1]."""
    device = next(frozen["unet"].parameters()).device

    def draw(name, shape, make=None):
        if draws is not None and name in draws:
            return draws[name].to(device)
        if make is not None:
            return make(shape)
        return torch.randn(shape, generator=generator, device=device)

    # 1. VAE encode, or latents already sampled and scaled
    if "latents" in batch:
        latents = batch["latents"].to(device).float().permute(0, 3, 1, 2)
    else:
        vae = frozen["vae"]
        vae_dtype = next(vae.parameters()).dtype
        pixels = batch["pixel_values"].to(device).permute(0, 3, 1, 2).to(vae_dtype)
        mb = statics.vae_microbatch
        chunks = (pixels.split(mb) if mb and pixels.shape[0] > mb
                  and pixels.shape[0] % mb == 0 else [pixels])
        with torch.no_grad():
            moments = [vae.encode(c) for c in chunks]
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
        eps = draw("latent_eps", mean.shape)
        latents = sample_latent(mean, logvar, eps=eps).float()
        latents = latents * statics.vae_config.scaling_factor

    # 2. noise and random timesteps
    B = latents.shape[0]
    noise = draw("noise", latents.shape).float()
    T = statics.scheduler_config.num_train_timesteps
    timesteps = draw("timesteps", (B,), lambda shape: torch.randint(
        0, T, shape, generator=generator, device=device))
    if statics.noise_offset:
        offset = draw("offset", (B, latents.shape[1], 1, 1))
        noise = noise + statics.noise_offset * offset.float()
    noisy = scheduler.add_noise(latents, noise, timesteps)

    # 3. text encode, or embeddings precomputed
    if "prompt_embeds" in batch:
        embeds = batch["prompt_embeds"].to(device)
    else:
        embeds, _ = encode_prompt_train(statics, frozen["text_encoder"],
                                        batch["input_ids"].to(device))
    return latents, noise, timesteps, noisy, embeds


def _prediction_loss(pred, latents, noise, timesteps, statics: TrainStatics,
                     scheduler: BaseScheduler) -> torch.Tensor:
    """Target (epsilon | velocity) + per-sample MSE, optional Min-SNR
    weighting and prior-preservation weight."""
    ptype = statics.scheduler_config.prediction_type
    target = scheduler.get_velocity(latents, noise, timesteps) if ptype == "v_prediction" else noise
    per_sample = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    if statics.snr_gamma is not None:
        snr = compute_snr(scheduler.alphas_cumprod, timesteps)
        per_sample = per_sample * min_snr_weight(snr, statics.snr_gamma, ptype)
    if statics.prior_loss_weight is not None:
        half = per_sample.shape[0] // 2
        return per_sample[:half].mean() + statics.prior_loss_weight * per_sample[half:].mean()
    return per_sample.mean()


def loss_fn(
    lora: Mapping[str, Mapping],
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: TrainStatics,
    scheduler: BaseScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Forward diffusion + prediction loss, differentiable in the factors of
    ``lora["unet"]``.  `frozen` holds the modules "unet", "vae",
    "text_encoder"."""
    check_supported(statics)
    latents, noise, timesteps, noisy, embeds = _prepare_diffusion(
        frozen, batch, generator, statics, scheduler, draws
    )
    unet = frozen["unet"]
    fused = apply_lora_for_training(unet, lora["unet"])

    def unet_fwd(x, t, ctx):
        return functional_call(unet, fused, (x, t, ctx), strict=False)

    dt = statics.compute_dtype
    args = (noisy.to(dt), timesteps, embeds.to(dt))
    if _remat_policy(statics) == "full":
        pred = checkpoint(unet_fwd, *args, use_reentrant=False)
    else:
        pred = unet_fwd(*args)
    return _prediction_loss(pred.float(), latents, noise, timesteps, statics, scheduler)


def make_train_step(statics: TrainStatics, scheduler: BaseScheduler, optimizer: AdamW):
    """The train step ``step(trainable, opt_state, frozen, batch, generator,
    draws=None) -> (trainable, opt_state, {"loss", "grad_norm"})``.
    `trainable` is {"unet": lora}; its factors are updated in place (see
    ``train/optim.py``) and returned.  ``grad_norm`` is the global norm of the
    gradients before clipping, as ``optax.global_norm(grads)`` is in the JAX
    step; both metrics are 0-d fp32 tensors on the device."""
    check_supported(statics)

    def step(trainable, opt_state, frozen, batch, generator, draws=None):
        leaves = [t for _, t in tree_leaves(trainable)]
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(trainable, frozen, batch, generator, statics, scheduler, draws)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        grad_tree = _unflatten(trainable, grads)
        trainable, opt_state = optimizer.update(grad_tree, opt_state, trainable)
        return trainable, opt_state, {"loss": loss.detach(),
                                      "grad_norm": global_norm(list(grads))}

    return step


def _unflatten(like: Mapping, values) -> Dict:
    """`values` (in ``tree_leaves`` order) in the nested-dict shape of `like`."""
    it = iter(values)

    def build(node):
        return {k: build(v) if isinstance(v, Mapping) else next(it) for k, v in node.items()}

    return build(like)
