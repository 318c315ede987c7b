"""The train steps, SD1.5 and SDXL: LoRA (with text-encoder LoRA), the whole
UNet, and textual inversion.

Port of ``stablediffusion_tpu/train/train_step.py`` (``compute_snr``,
``min_snr_weight``, ``TrainStatics``, ``encode_prompt_train``,
``_resolve_remat``, ``_prepare_diffusion``, ``make_encode_fn``,
``_prediction_loss``, ``loss_fn``, ``full_finetune_loss_fn``,
``controlnet_loss_fn``, ``ti_loss_fn``, ``make_train_step``): VAE encode -> noise and random
timesteps -> add_noise -> text encode (SDXL: both towers' penultimate
states and bigG's projected pooled) -> SDXL micro-conditioning -> UNet
forward -> epsilon or velocity MSE with optional Min-SNR weighting and the
DreamBooth prior-loss split -> gradients to the trainable tree -> the
optimizer of ``train/optim.py``.  The trainable tree is the LoRA factors
(``loss_fn``), the whole UNet as fp32 masters (``full_finetune_loss_fn``),
a whole ControlNet as fp32 masters over the frozen UNet
(``controlnet_loss_fn``) or the placeholder token's embedding rows
(``ti_loss_fn``).

Where the JAX step is one jitted function, this one runs eagerly:

  * The VAE encode runs under ``torch.no_grad()``, so the VAE's mid-block
    attention takes the forward-only flash_stream kernel on the card.  The
    text encode does too, unless a tower is trained (text-encoder LoRA, or
    the spliced rows of textual inversion): then the tower runs through
    ``torch.func.functional_call`` with its fused weights or spliced table,
    under grad, and its causal attention differentiates through the
    backward kernels (``ops/attention.FlashAttnFn``).
  * The UNet runs through ``functional_call`` with the trainable weights
    (LoRA-fused, or the fp32 masters, which ``ops/basic`` casts to the
    activations' dtype at each use as JAX's ``ops/basic.py`` does), in the
    compute dtype (bf16 on the card); the loss is fp32.
  * A trainable leaf that no path of the loss reaches gets a zero gradient,
    as ``jax.grad`` gives it: SDXL reads CLIP-L's penultimate states only,
    so the last CLIP-L layer's factors never move, and its attention's
    backward never runs.
  * The random draws (the latent epsilon, the noise, the timesteps, the
    offset noise) come from a ``torch.Generator``, or are injected through
    ``draws=``: ``jax.random`` cannot be reproduced in torch, so the parity
    tests hand both sides the same numbers.
  * Remat (``remat_policy``, or JAX's legacy ``gradient_checkpointing``
    flag with ``remat_policy=""``) makes each resnet and transformer block
    of the UNet or MM-DiT (:data:`REMAT_UNITS`) one
    ``torch.utils.checkpoint`` region (non-reentrant), where JAX wraps the
    whole forward in one ``jax.checkpoint`` and XLA schedules the
    recompute: eager torch recomputes a region whole before its first
    backward op, so only regions smaller than the model bound what the
    backward holds.  "full" recomputes each region (``jax.checkpoint``);
    "dots" keeps the outputs of its 2-D matrix products (``aten.mm`` /
    ``aten.addmm``: JAX's ``dots_with_no_batch_dims_saveable``) through
    selective checkpointing and recomputes the rest; "offload" keeps the
    same products in pinned host memory (JAX's
    ``offload_dot_with_no_batch_dims("device", "pinned_host")``) through a
    pair of dispatch modes of its own, since selective checkpointing holds
    its cache on the device.  The ops outside the blocks (the stem, the
    resamplers, the norms and projections around the transformer blocks,
    the head) are kept as without remat.  Every policy recomputes the
    attention forwards in the backward, so under remat each step launches
    its forwards with lse twice.

Layouts: the batch keeps the JAX package's public NHWC (``pixel_values``
[B, H, W, 3] in [-1, 1], ``latents`` [B, h, w, 4]); the draws are NCHW, the
layout the step computes in.

With a mesh (``parallel/mesh.py``) each rank holds its rows of the global
batch (``parallel.shard_batch``).  The draws do not depend on the world
size: each rank draws the global batch's from the same generator (or takes
the injected global draws) and keeps its rows, so a run over any number of
data ranks equals a 1-rank run on the same global batch.  The trainable
gradients are averaged over ``data`` before the optimizer, and, for the
leaves that feed the denoiser's tensor-split weights (``parallel/tp.py``),
summed over ``tensor``.  Under ``shard_params`` (FSDP, ``parallel/zero.py``)
the trainable tree and the frozen modules stay split: :func:`remat` gathers
a denoiser's weights one block at a time (the block's checkpoint region
gathers them again in the backward), the text towers and the VAE are held
whole for the step, and the optimizer updates the slices.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from stablediffusion_tpu_torch.lora.core import _fused, apply_lora_for_training, delta_w
from stablediffusion_tpu_torch.models.layers import ResnetBlock2D
from stablediffusion_tpu_torch.models.mmdit import JointTransformerBlock
from stablediffusion_tpu_torch.models.unet import BasicTransformerBlock
from stablediffusion_tpu_torch.models.vae import sample_latent
from stablediffusion_tpu_torch.parallel import zero
from stablediffusion_tpu_torch.schedulers.common import BaseScheduler
from stablediffusion_tpu_torch.train.optim import global_norm, tree_leaves, unflatten

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
    defaults."""

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
    # "" (the legacy flag decides) | "none" | "full" | "dots" | "offload":
    # torch.utils.checkpoint around the UNet forward, see the module's
    # docstring
    remat_policy: str = ""
    controlnet_config: Optional[UNetConfig] = None
    # textual inversion: the token-table rows of the placeholder's vectors,
    # the only trainable rows (ti_rows_2: SDXL's second tower)
    ti_rows: Optional[tuple] = None
    ti_rows_2: Optional[tuple] = None
    # DreamBooth prior preservation: [instance | class] batch halves
    prior_loss_weight: Optional[float] = None

    @property
    def is_sdxl(self) -> bool:
        return self.text_config_2 is not None


def check_supported(statics) -> None:
    """Raise on an unknown remat policy."""
    _resolve_remat(statics)


REMAT_POLICIES = ("none", "full", "dots", "offload")


def _resolve_remat(statics) -> str:
    """The policy name, as ``_resolve_remat`` (:122-141) resolves it: ""
    defers to the legacy ``gradient_checkpointing`` flag."""
    policy = statics.remat_policy or ("full" if statics.gradient_checkpointing else "none")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    return policy


def _dot_ops():
    """The 2-D matrix products, whose outputs "dots" and "offload" keep."""
    return (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _OffloadDots(TorchDispatchMode):
    """The forward of an "offload" region: each 2-D product's output is
    copied, in call order, to pinned host memory (a plain copy for a CPU
    tensor); nothing else is kept."""

    def __init__(self, store: collections.deque):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _dot_ops():
            if out.device.type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
            else:
                host = out.clone()
            self.store.append(host)
        return out


class _FetchDots(TorchDispatchMode):
    """The recompute of an "offload" region: each 2-D product returns the
    copy its forward kept, brought back to the product's device, instead of
    running; every other op runs again."""

    def __init__(self, store: collections.deque):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _dot_ops():
            return self.store.popleft().to(args[0].device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    store = collections.deque()
    return _OffloadDots(store), _FetchDots(store)


# the modules each remat region covers, one region per instance: every
# resnet and transformer block, as diffusers' gradient_checkpointing
# checkpoints them
REMAT_UNITS = (ResnetBlock2D, BasicTransformerBlock, JointTransformerBlock)


class _Region:
    """A remat unit's forward while :func:`remat` is active: one checkpoint
    region that runs the unit with its entries of the substituted weights.
    They are held here because the recompute runs in the backward, after
    ``functional_call`` has put the module's own weights back."""

    def __init__(self, unit: torch.nn.Module, weights: Mapping[str, Any], kw, split: bool):
        self.unit, self.weights, self.kw, self.split = unit, weights, kw, split
        self.inside = False

    def __call__(self, *args, **kwargs):
        if self.inside:  # functional_call's own call of the unit
            return type(self.unit).forward(self.unit, *args, **kwargs)
        return checkpoint(self._run, *args, use_reentrant=False, **self.kw, **kwargs)

    def _run(self, *args, **kwargs):
        self.inside = True
        try:
            weights = _whole_weights(self.unit, self.weights) if self.split else self.weights
            return functional_call(self.unit, weights, args, kwargs, strict=False)
        finally:
            self.inside = False


def _whole_weights(module: torch.nn.Module, weights: Mapping[str, Any], skip=()) -> dict:
    """FSDP: `weights` made whole for a call of `module` (a callable called,
    a split slice gathered), with the whole of each split parameter of
    `module` that they do not replace, but for those under the prefixes
    `skip`."""
    out = {k: v() if callable(v) else zero.whole(v) for k, v in weights.items()}
    for n, p in module.named_parameters():
        if n not in out and zero.is_split(p) and not n.startswith(skip):
            out[n] = zero.whole(p)
    return out


@contextlib.contextmanager
def remat(model: torch.nn.Module, weights: Mapping[str, Any], policy: str):
    """Within the block, each of `model`'s :data:`REMAT_UNITS` runs as one
    checkpoint region under `policy` (one of :data:`REMAT_POLICIES`), so
    that the backward holds the regions' inputs and one region's
    activations at a time.  `weights` are those the caller substitutes for
    the model's through ``functional_call`` ({} for none); the block
    yields those to substitute in the call of `model` itself.

    FSDP (`model`'s parameters or `weights`' entries split by
    ``parallel/zero``, and entries that may then be callables making a
    weight): every unit runs as a region ("full" for the policy "none"),
    which makes its weights whole at its start and again in the
    backward's recompute, so that the whole copies of one unit are alive at
    a time; the call of `model` itself gets the rest whole."""
    split = zero.is_split_module(model) or any(callable(v) or zero.is_split(v)
                                                for v in weights.values())
    if policy == "none" and split:
        policy = "full"
    if policy == "none":
        yield weights
        return
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             list(_dot_ops()))
    elif policy == "offload":
        kw["context_fn"] = _offload_contexts
    units = [(name, m) for name, m in model.named_modules() if isinstance(m, REMAT_UNITS)]
    for name, unit in units:
        sub = {k[len(name) + 1:]: v for k, v in weights.items() if k.startswith(name + ".")}
        unit.forward = _Region(unit, sub, kw, split)
    try:
        if split:
            inside = tuple(name + "." for name, _ in units)
            yield _whole_weights(model, {k: v for k, v in weights.items()
                                         if not k.startswith(inside)}, inside)
        else:
            yield weights
    finally:
        for _, unit in units:
            del unit.forward


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


class MeshDraws(dict):
    """A mesh rank's draws: the injected global ones (if any), and its
    ``rows`` (data ranks, data index) of the global batch, which
    :func:`_draw` keeps of every draw."""

    def __init__(self, draws: Optional[Mapping[str, torch.Tensor]], rows: tuple):
        super().__init__(draws or {})
        self.rows = rows


def mesh_draws(draws: Optional[Mapping[str, torch.Tensor]], mesh):
    """`draws` for a rank of `mesh` (:class:`MeshDraws`), so that its draws
    are its rows of the global batch's and do not depend on the world size;
    `draws` as they are without a mesh."""
    from stablediffusion_tpu_torch.parallel.mesh import DATA_AXIS

    if mesh is None or (mesh.shape[DATA_AXIS] == 1 and mesh.groups[DATA_AXIS] is None):
        return draws
    return MeshDraws(draws, (mesh.shape[DATA_AXIS], mesh.data_index))


def _draw(draws, generator, device, name, shape, make=None):
    """draws[name] on `device` when given, else a fresh standard normal of
    `shape` from `generator` (or `make(shape)`).  A mesh rank's draws
    (:class:`MeshDraws`) are the global batch's, of which this rank's rows
    are kept."""
    rows = getattr(draws, "rows", None)
    if rows is not None:
        shape = (shape[0] * rows[0], *shape[1:])
    if draws is not None and name in draws:
        x = draws[name].to(device)
    elif make is not None:
        x = make(shape)
    else:
        x = torch.randn(shape, generator=generator, device=device)
    return x if rows is None else x[rows[1]::rows[0]]


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


def lora_weights(module, factors) -> dict:
    """``apply_lora_for_training``'s fused weights; of an FSDP-split module,
    callables that :func:`remat` calls inside each weight's block, where the
    base weight is gathered whole."""
    if not zero.is_split_module(module):
        return apply_lora_for_training(module, factors)
    return {f"{path}.weight": functools.partial(_fuse_whole, module.get_submodule(path), f)
            for path, f in factors.items()}


def _fuse_whole(m: torch.nn.Module, factors) -> torch.Tensor:
    return _fused(zero.whole(m.weight), delta_w(factors))


def _fused_tower(module, factors) -> Callable:
    """`module` with its LoRA-fused weights, differentiable in `factors`."""
    fused = apply_lora_for_training(module, factors)
    return lambda ids: functional_call(module, fused, (ids,), strict=False)


TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


def _spliced_tower(module, rows_idx, rows: torch.Tensor) -> Callable:
    """`module` with `rows` in place of its token table's rows `rows_idx`,
    differentiable in `rows`: a new table (``index_put``, not in place), so
    the module's own table is never written."""
    table = getattr(module, "text_model").embeddings.token_embedding.weight
    idx = torch.as_tensor(rows_idx, device=table.device)
    spliced = table.index_put((idx,), rows.to(table.dtype))
    return lambda ids: functional_call(module, {TOKEN_TABLE: spliced}, (ids,), strict=False)


def _unet_pred(unet, weights: Mapping[str, torch.Tensor], noisy, timesteps, embeds,
               added_cond, statics: TrainStatics) -> torch.Tensor:
    """The UNet's prediction, fp32, with `weights` substituted for its own
    ({} for none), in the compute dtype, under the remat policy."""
    dt = statics.compute_dtype
    with remat(unet, weights, _resolve_remat(statics)) as w:
        pred = functional_call(unet, w, (noisy.to(dt), timesteps, embeds.to(dt), added_cond),
                               strict=False)
    return pred.float()


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
    lora = zero.whole_tree(lora)
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
    pred = _unet_pred(unet, lora_weights(unet, lora["unet"]), noisy, timesteps, embeds,
                      added_cond, statics)
    return _prediction_loss(pred, latents, noise, timesteps, statics, scheduler)


def full_finetune_loss_fn(
    unet_params: Mapping[str, torch.Tensor],
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: TrainStatics,
    scheduler: BaseScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The loss of full fine-tuning (:369-402): as :func:`loss_fn`, with the
    trainable tree the whole UNet, {parameter name: fp32 master}, in place
    of every weight of ``frozen["unet"]`` (which only lends its structure);
    the text towers stay frozen."""
    check_supported(statics)
    latents, noise, timesteps, noisy, embeds, added_cond = _prepare_diffusion(
        frozen, batch, generator, statics, scheduler, draws)
    pred = _unet_pred(frozen["unet"], unet_params, noisy, timesteps, embeds, added_cond,
                      statics)
    return _prediction_loss(pred, latents, noise, timesteps, statics, scheduler)


def _controlnet_remat(statics) -> str:
    """JAX's ControlNet step (:446-452) takes ``remat_policy`` when set; its
    legacy ``gradient_checkpointing`` flag there means "dots"
    (``dots_with_no_batch_dims_saveable``), not "full"."""
    if statics.remat_policy:
        return _resolve_remat(statics)
    return "dots" if statics.gradient_checkpointing else "none"


def control_image_for(cond: torch.Tensor, latent_hw) -> torch.Tensor:
    """The NHWC conditioning batch in [0, 1] as NCHW at latent x 8
    (:427-433): resized only when it differs, bilinear with antialiasing,
    which equals ``jax.image.resize(..., "bilinear")`` both ways (that
    antialiases a downscale; ``F.interpolate`` without it would not)."""
    cond = cond.permute(0, 3, 1, 2)
    h8, w8 = latent_hw[0] * 8, latent_hw[1] * 8
    if tuple(cond.shape[-2:]) != (h8, w8):
        cond = torch.nn.functional.interpolate(cond.float(), size=(h8, w8), mode="bilinear",
                                               align_corners=False, antialias=True)
    return cond


def controlnet_loss_fn(
    controlnet: Mapping[str, torch.Tensor],
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: TrainStatics,
    scheduler: BaseScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The loss of ControlNet training (:404-462): the trainable tree is a
    whole ControlNet, {parameter name: fp32 master}, in place of every
    weight of ``frozen["controlnet"]`` (which only lends its structure),
    cast to the compute dtype at each use; its residuals go into the
    frozen UNet.  The batch adds ``conditioning_pixel_values`` [B, H, W, 3]
    in [0, 1].  The UNet's down and mid blocks take no gradient: the
    residuals join after them (the skips and the mid-block's output), so
    only the ControlNet and the UNet's up blocks run their backward."""
    check_supported(statics)
    dt = statics.compute_dtype
    latents, noise, timesteps, noisy, embeds, added_cond = _prepare_diffusion(
        frozen, batch, generator, statics, scheduler, draws)
    cond = control_image_for(batch["conditioning_pixel_values"].to(noisy.device),
                             noisy.shape[-2:])
    net, unet = frozen["controlnet"], frozen["unet"]
    policy = _controlnet_remat(statics)
    with remat(net, controlnet, policy) as w_net, remat(unet, {}, policy) as w_unet:
        down_res, mid_res = functional_call(
            net, w_net, (noisy.to(dt), timesteps, embeds.to(dt), cond.to(dt)),
            {"added_cond": added_cond}, strict=False)
        pred = functional_call(unet, w_unet, (noisy.to(dt), timesteps, embeds.to(dt), added_cond),
                               {"down_block_residuals": down_res, "mid_block_residual": mid_res},
                               strict=False)
    return _prediction_loss(pred.float(), latents, noise, timesteps, statics, scheduler)


def ti_loss_fn(
    ti: Mapping[str, torch.Tensor],
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: TrainStatics,
    scheduler: BaseScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The loss of textual-inversion training (:463-517): the trainable
    tree is the placeholder's embedding rows, {"embeddings": [V, hidden]
    (and SDXL's "embeddings_2")}, spliced into the frozen towers' token
    tables at ``statics.ti_rows`` (``ti_rows_2``); the UNet and every other
    row stay frozen, so the gradients reach those rows only."""
    check_supported(statics)
    ti = zero.whole_tree(ti)
    te = _spliced_tower(frozen["text_encoder"], statics.ti_rows, ti["embeddings"])
    te2 = None
    if statics.is_sdxl:
        te2 = _spliced_tower(frozen["text_encoder_2"], statics.ti_rows_2, ti["embeddings_2"])
    latents, noise, timesteps, noisy, embeds, added_cond = _prepare_diffusion(
        frozen, batch, generator, statics, scheduler, draws, te=te, te2=te2)
    pred = _unet_pred(frozen["unet"], {}, noisy, timesteps, embeds, added_cond, statics)
    return _prediction_loss(pred, latents, noise, timesteps, statics, scheduler)


def _tp_partial(path: str, marked: Mapping[str, Mapping[str, str]]) -> bool:
    """Whether the trainable leaf `path` feeds a tensor-split weight of the
    component a prefix of `marked` names ({prefix: {module: "col"|"row"}}):
    its gradient is then this rank's part, summed over ``tensor``.  A
    row-parallel bias is added after the all-reduce, whole on every rank."""
    for prefix, names in marked.items():
        if prefix:
            if not path.startswith(prefix + "."):
                continue
            path = path[len(prefix) + 1:]
        mod, _, leaf = path.rpartition(".")
        if mod in names and (leaf in ("down", "up", "weight")
                             or (leaf == "bias" and names[mod] == "col")):
            return True
    return False


# elements of one all-reduce of the gradients (64 MB of fp32)
_BUCKET = 1 << 24


def _mean_over_data(mesh, grads):
    """The gradients averaged over ``data``: consecutive leaves of one dtype
    flattened into buckets of up to :data:`_BUCKET` elements, one
    all-reduce each (a collective a leaf would cost one launch a leaf)."""
    from stablediffusion_tpu_torch.parallel.mesh import DATA_AXIS

    n = mesh.shape[DATA_AXIS]
    out, i = list(grads), 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and grads[j].dtype == grads[i].dtype and (
                j == i or size + grads[j].numel() <= _BUCKET):
            size += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        mesh.all_reduce_(flat, DATA_AXIS).div_(n)
        for k, part in zip(range(i, j), flat.split([g.numel() for g in grads[i:j]])):
            out[k] = part.view_as(grads[k])
        i = j
    return out


def make_train_step(statics, scheduler: BaseScheduler, optimizer, loss=loss_fn, mesh=None,
                    shard_params: bool = False):
    """The train step ``step(trainable, opt_state, frozen, batch, generator,
    draws=None) -> (trainable, opt_state, {"loss", "grad_norm"})``.  `loss`
    picks the mode, as in JAX: :func:`loss_fn` with `trainable` {"unet":
    lora[, "text_encoder": lora, "text_encoder_2": lora]},
    :func:`full_finetune_loss_fn` with the UNet's masters,
    :func:`controlnet_loss_fn` with the ControlNet's, :func:`ti_loss_fn`
    with the placeholder's rows (``train/sd3_train.sd3_lora_loss_fn`` with
    its statics).  The trainable tensors are updated in place (see
    ``train/optim.py``) and returned.  ``grad_norm`` is the global norm of
    the gradients before clipping, as ``optax.global_norm(grads)`` is in the
    JAX step; both metrics are 0-d fp32 tensors on the device.

    With a `mesh` the batch holds this rank's rows and the step runs as the
    module docstring says; a ZeRO-1 optimizer is the caller's
    (``parallel/zero.ZeroOptimizer`` around `optimizer`).  With
    `shard_params` (which needs that optimizer, and a mesh whose
    ``tensor`` is 1), `trainable` is this rank's slices
    (``zero.shard_tree``) and the frozen modules are split
    (``zero.shard_modules_``)."""
    check_supported(statics)
    from stablediffusion_tpu_torch.parallel import tp
    from stablediffusion_tpu_torch.parallel.mesh import DATA_AXIS, TENSOR_AXIS

    if shard_params:
        if mesh is None:
            raise ValueError("shard_params splits state over the data axis: pass a mesh")
        if not isinstance(optimizer, zero.ZeroOptimizer):
            raise ValueError("shard_params updates split masters: wrap the optimizer in "
                             "parallel.zero.ZeroOptimizer")
        if mesh.shape[TENSOR_AXIS] > 1:
            raise ValueError("shard_params splits over data only: not on a tensor > 1 mesh")
    grad_norm = optimizer.grad_norm if shard_params else global_norm

    def step(trainable, opt_state, frozen, batch, generator, draws=None):
        denoisers = [frozen.get("unet"), frozen.get("transformer")]
        # FSDP: remat gathers a denoiser block by block, the rest is whole
        # for the step
        spans = [m for k, m in frozen.items()
                 if k not in ("unet", "transformer", "controlnet")] if shard_params else []
        leaves = [t for _, t in tree_leaves(trainable)]
        with zero.gathered(spans), tp.parallel(denoisers, mesh) as marked:
            for t in leaves:
                t.requires_grad_(True)
            loss_val = loss(trainable, frozen, batch, generator, statics, scheduler,
                            mesh_draws(draws, mesh))
            # a factor no path reaches (CLIP-L's last layer under SDXL) gets a
            # zero gradient, as jax.grad gives it
            grads = list(torch.autograd.grad(loss_val, leaves, allow_unused=True,
                                             materialize_grads=True))
            for t in leaves:
                t.requires_grad_(False)
        loss_val = loss_val.detach()
        if mesh is not None:
            split = {"": marked.get(0, {})} if loss is full_finetune_loss_fn else \
                {"unet": marked.get(0, {}), "transformer": marked.get(1, {})}
            # a split leaf's gradient comes averaged from zero.whole's backward
            whole = [i for i, t in enumerate(leaves) if not zero.is_split(t)]
            for i, g in zip(whole, _mean_over_data(mesh, [grads[i] for i in whole])):
                grads[i] = g
            for (p, _), g in zip(tree_leaves(trainable), grads):
                if _tp_partial(p, split):
                    mesh.all_reduce_(g, TENSOR_AXIS)
            loss_val = mesh.all_reduce_(loss_val.clone(), DATA_AXIS).div_(mesh.shape[DATA_AXIS])
        trainable, opt_state = optimizer.update(unflatten(trainable, grads), opt_state,
                                                trainable)
        return trainable, opt_state, {"loss": loss_val, "grad_norm": grad_norm(grads)}

    return step
