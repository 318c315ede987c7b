"""The LoRA train step, SD1.5 and SDXL, with text-encoder LoRA.

Port of the LoRA path of ``stablediffusion_tpu/train/train_step.py``
(``compute_snr``, ``min_snr_weight``, ``TrainStatics``,
``encode_prompt_train``, ``_resolve_remat``, ``_prepare_diffusion``,
``make_encode_fn``, ``_prediction_loss``, ``loss_fn``, ``make_train_step``):
VAE encode -> noise and random timesteps -> add_noise -> text encode (SDXL:
both towers' penultimate states and bigG's projected pooled) -> SDXL
micro-conditioning -> UNet forward with LoRA-fused weights -> epsilon or
velocity MSE with optional Min-SNR weighting -> gradients to the LoRA
factors -> the optimizer of ``train/optim.py``.

Where the JAX step is one jitted function, this one runs eagerly:

  * The VAE encode runs under ``torch.no_grad()``, so the VAE's mid-block
    attention takes the forward-only flash_stream kernel on the card.  The
    text encode does too, unless ``train_text_encoder``: then each tower
    with a LoRA runs through ``torch.func.functional_call`` with its fused
    weights, under grad, and its causal attention differentiates through
    the backward kernels (``ops/attention.FlashAttnFn``, fp32).
  * The UNet runs through ``functional_call`` with the fused weights of
    ``lora/core.apply_lora_for_training``, in the compute dtype (bf16 on
    the card); the loss is fp32.
  * A factor that no path of the loss reaches gets a zero gradient, as
    ``jax.grad`` gives it: SDXL reads CLIP-L's penultimate states only, so
    the last CLIP-L layer's factors never move, and its attention's
    backward never runs.
  * The random draws (the latent epsilon, the noise, the timesteps, the
    offset noise) come from a ``torch.Generator``, or are injected through
    ``draws=``: ``jax.random`` cannot be reproduced in torch, so the parity
    tests hand both sides the same numbers.
  * Remat "full" (``remat_policy="full"``, or JAX's legacy
    ``gradient_checkpointing`` flag with ``remat_policy=""``) wraps the
    UNet forward in ``torch.utils.checkpoint`` (JAX ``jax.checkpoint``).

Layouts: the batch keeps the JAX package's public NHWC (``pixel_values``
[B, H, W, 3] in [-1, 1], ``latents`` [B, h, w, 4]); the draws are NCHW, the
layout the step computes in.  Textual-inversion training, ControlNet and
the "dots" / "offload" remat policies raise, naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

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
from stablediffusion_tpu_torch.train.optim import global_norm, tree_leaves, unflatten

# what the port does not train yet -> the ROADMAP §1 item that brings it
_LATER = {
    "textual-inversion training": "item 19",
    "ControlNet training": "item 19 (after item 15's ControlNet model)",
    "remat_policy 'dots'": "item 19",
    "remat_policy 'offload'": "item 19",
}


def later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP §1 {_LATER[what]}")


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
    """Static settings of the step, with the JAX package's field names and
    defaults.  ``controlnet_config`` and ``ti_rows`` / ``ti_rows_2`` must
    keep theirs (their paths raise)."""

    unet_config: UNetConfig
    vae_config: VAEConfig
    text_config: CLIPTextConfig
    text_config_2: Optional[CLIPTextConfig]
    scheduler_config: SchedulerConfig
    train_text_encoder: bool
    snr_gamma: Optional[float]
    noise_offset: float = 0.0
    compute_dtype: torch.dtype = torch.bfloat16
    # legacy flag: remat_policy "" means "full" when set, else "none"
    gradient_checkpointing: bool = False
    # the VAE encodes in this dtype (a VAE held in another one is cast for
    # the call)
    vae_dtype: torch.dtype = torch.float32
    # encode pixels through the VAE in chunks of this many images (0: all)
    vae_microbatch: int = 0
    # "" (the legacy flag decides) | "none" | "full" (torch.utils.checkpoint
    # around the UNet forward)
    remat_policy: str = ""
    controlnet_config: Optional[UNetConfig] = None
    ti_rows: Optional[tuple] = None
    ti_rows_2: Optional[tuple] = None
    # DreamBooth prior preservation: [instance | class] batch halves
    prior_loss_weight: Optional[float] = None

    @property
    def is_sdxl(self) -> bool:
        return self.text_config_2 is not None


def check_supported(statics: TrainStatics) -> None:
    """Raise on settings whose path the port does not have."""
    if statics.ti_rows is not None or statics.ti_rows_2 is not None:
        raise later("textual-inversion training")
    if statics.controlnet_config is not None:
        raise later("ControlNet training")
    _resolve_remat(statics)


def _resolve_remat(statics: TrainStatics) -> str:
    """"none" or "full", as ``_resolve_remat`` (:122-141) resolves them."""
    policy = statics.remat_policy or ("full" if statics.gradient_checkpointing else "none")
    if policy in ("dots", "offload"):
        raise later(f"remat_policy {policy!r}")
    if policy not in ("none", "full"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    return policy


def encode_prompt_train(statics: TrainStatics, text_encoder: Callable,
                        text_encoder_2: Optional[Callable], input_ids: torch.Tensor,
                        input_ids_2: Optional[torch.Tensor]):
    """Train-time prompt encoding: (last_hidden_state, None) for SD1.5; for
    SDXL both towers' penultimate states concatenated and bigG's projected
    pooled.  The towers are modules or callables with a module's output
    (the LoRA-fused ones of :func:`loss_fn`)."""
    if not statics.is_sdxl:
        return text_encoder(input_ids).last_hidden_state, None
    out1 = text_encoder(input_ids)
    out2 = text_encoder_2(input_ids_2)
    embeds = torch.cat([out1.hidden_states[-2], out2.hidden_states[-2]], dim=-1)
    return embeds, out2.projected_pooled


class _Encode(torch.nn.Module):
    """A VAE's encode as a module's forward, for ``functional_call``."""

    def __init__(self, vae):
        super().__init__()
        self.vae = vae

    def forward(self, pixels):
        return self.vae.encode(pixels)


@torch.no_grad()
def vae_moments(vae, pixels: torch.Tensor, vae_dtype: torch.dtype, microbatch: int = 0):
    """(mean, logvar), NCHW, of `pixels` (NCHW) encoded with the VAE's
    weights in `vae_dtype` (cast for the call where the module holds
    another dtype), in chunks of `microbatch` images when that divides the
    batch."""
    pixels = pixels.to(vae_dtype)
    if next(vae.parameters()).dtype == vae_dtype:
        encode = vae.encode
    else:
        wrapper = _Encode(vae)
        cast = {f"vae.{n}": p.to(vae_dtype) for n, p in vae.named_parameters()}
        encode = lambda x: functional_call(wrapper, cast, (x,))  # noqa: E731
    mb = microbatch
    chunks = (pixels.split(mb) if mb and pixels.shape[0] > mb and pixels.shape[0] % mb == 0
              else [pixels])
    moments = [encode(c) for c in chunks]
    return torch.cat([m for m, _ in moments]), torch.cat([lv for _, lv in moments])


def _draw(draws, generator, device, name, shape, make=None):
    """draws[name] on `device` when given, else a fresh standard normal of
    `shape` from `generator` (or `make(shape)`)."""
    if draws is not None and name in draws:
        return draws[name].to(device)
    if make is not None:
        return make(shape)
    return torch.randn(shape, generator=generator, device=device)


def _prepare_diffusion(
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: TrainStatics,
    scheduler: BaseScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
    te: Optional[Callable] = None,
    te2: Optional[Callable] = None,
):
    """Forward diffusion: (latents, noise, timesteps, noisy, embeds,
    added_cond), the latents NCHW fp32, `added_cond` None unless SDXL.
    Draws, in this order, from `generator` unless `draws` holds them (NCHW,
    on the step's device): "latent_eps" [B, 4, h, w] for the latent sample,
    "noise" [B, 4, h, w], "timesteps" [B] in [0, T), and, with a noise
    offset, "offset" [B, 4, 1, 1].  `te` / `te2` replace the frozen text
    towers (the LoRA-fused ones, under grad); without them the text encode
    runs under no grad."""
    device = next(frozen["unet"].parameters()).device
    draw = lambda *a, **kw: _draw(draws, generator, device, *a, **kw)  # noqa: E731

    # 1. VAE encode, or latents already sampled and scaled
    if "latents" in batch:
        latents = batch["latents"].to(device).float().permute(0, 3, 1, 2)
    else:
        pixels = batch["pixel_values"].to(device).permute(0, 3, 1, 2)
        mean, logvar = vae_moments(frozen["vae"], pixels, statics.vae_dtype,
                                   statics.vae_microbatch)
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
        pooled = batch.get("pooled_embeds")
        pooled = pooled.to(device) if pooled is not None else None
    else:
        ids = batch["input_ids"].to(device)
        ids_2 = batch["input_ids_2"].to(device) if statics.is_sdxl else None
        towers = (te or frozen["text_encoder"], te2 or frozen.get("text_encoder_2"))
        with torch.set_grad_enabled(torch.is_grad_enabled() and (te or te2) is not None):
            embeds, pooled = encode_prompt_train(statics, *towers, ids, ids_2)

    # 4. SDXL micro-conditioning
    added_cond = None
    if statics.is_sdxl:
        time_ids = torch.cat([batch["original_sizes"], batch["crop_top_lefts"],
                              batch["target_sizes"]], dim=-1).to(device)
        added_cond = {"text_embeds": pooled.to(statics.compute_dtype), "time_ids": time_ids}
    return latents, noise, timesteps, noisy, embeds, added_cond


def make_encode_fn(statics: TrainStatics):
    """The ``cache_latents`` program (:244-293): ``encode(frozen, batch,
    generator, draws=None) -> batch'``, where batch' replaces
    pixel_values / input_ids(_2) with "latents" (sampled and scaled, fp32,
    NHWC) and "prompt_embeds" / "pooled_embeds", and keeps the
    micro-conditioning keys.  It runs under no grad, apart from the step,
    so that the VAE's activations and the towers are gone before the UNet's
    backward.  Not valid with train_text_encoder (the towers must be inside
    the gradient)."""
    if statics.train_text_encoder:
        raise ValueError("cached encode is incompatible with train_text_encoder")

    @torch.no_grad()
    def encode(frozen, batch, generator, draws=None):
        vae = frozen["vae"]
        device = next(vae.parameters()).device
        pixels = batch["pixel_values"].to(device).permute(0, 3, 1, 2)
        mean, logvar = vae_moments(vae, pixels, statics.vae_dtype)
        eps = _draw(draws, generator, device, "latent_eps", mean.shape)
        latents = sample_latent(mean, logvar, eps=eps).float()
        latents = latents * statics.vae_config.scaling_factor
        embeds, pooled = encode_prompt_train(
            statics, frozen["text_encoder"], frozen.get("text_encoder_2"),
            batch["input_ids"].to(device),
            batch["input_ids_2"].to(device) if statics.is_sdxl else None)
        out = {k: v for k, v in batch.items()
               if k not in ("pixel_values", "input_ids", "input_ids_2")}
        out["latents"] = latents.permute(0, 2, 3, 1)
        out["prompt_embeds"] = embeds
        if pooled is not None:
            out["pooled_embeds"] = pooled
        return out

    return encode


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


def _fused_tower(module, factors) -> Callable:
    """`module` with its LoRA-fused weights, differentiable in `factors`."""
    fused = apply_lora_for_training(module, factors)
    return lambda ids: functional_call(module, fused, (ids,), strict=False)


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
    ``lora["unet"]`` and, with ``train_text_encoder``, of
    ``lora["text_encoder"]`` / ``lora["text_encoder_2"]``.  `frozen` holds
    the modules "unet", "vae", "text_encoder" (and "text_encoder_2")."""
    check_supported(statics)
    te = te2 = None
    if statics.train_text_encoder:
        if "text_encoder" in lora:
            te = _fused_tower(frozen["text_encoder"], lora["text_encoder"])
        if frozen.get("text_encoder_2") is not None and "text_encoder_2" in lora:
            te2 = _fused_tower(frozen["text_encoder_2"], lora["text_encoder_2"])
    latents, noise, timesteps, noisy, embeds, added_cond = _prepare_diffusion(
        frozen, batch, generator, statics, scheduler, draws, te=te, te2=te2
    )
    unet = frozen["unet"]
    fused = apply_lora_for_training(unet, lora["unet"])

    def unet_fwd(x, t, ctx, added):
        return functional_call(unet, fused, (x, t, ctx, added), strict=False)

    dt = statics.compute_dtype
    args = (noisy.to(dt), timesteps, embeds.to(dt), added_cond)
    if _resolve_remat(statics) == "full":
        pred = checkpoint(unet_fwd, *args, use_reentrant=False)
    else:
        pred = unet_fwd(*args)
    return _prediction_loss(pred.float(), latents, noise, timesteps, statics, scheduler)


def make_train_step(statics: TrainStatics, scheduler: BaseScheduler, optimizer):
    """The train step ``step(trainable, opt_state, frozen, batch, generator,
    draws=None) -> (trainable, opt_state, {"loss", "grad_norm"})``.
    `trainable` is {"unet": lora[, "text_encoder": lora, "text_encoder_2":
    lora]}; its factors are updated in place (see ``train/optim.py``) and
    returned.  ``grad_norm`` is the global norm of the gradients before
    clipping, as ``optax.global_norm(grads)`` is in the JAX step; both
    metrics are 0-d fp32 tensors on the device."""
    check_supported(statics)

    def step(trainable, opt_state, frozen, batch, generator, draws=None):
        leaves = [t for _, t in tree_leaves(trainable)]
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(trainable, frozen, batch, generator, statics, scheduler, draws)
        # a factor no path reaches (CLIP-L's last layer under SDXL) gets a
        # zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        for t in leaves:
            t.requires_grad_(False)
        grad_tree = unflatten(trainable, grads)
        trainable, opt_state = optimizer.update(grad_tree, opt_state, trainable)
        return trainable, opt_state, {"loss": loss.detach(),
                                      "grad_norm": global_norm(list(grads))}

    return step

