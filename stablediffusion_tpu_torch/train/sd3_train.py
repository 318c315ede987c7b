"""SD3 / MM-DiT LoRA fine-tuning: the flow-matching train step and trainer.

Port of ``stablediffusion_tpu/train/sd3_train.py``: ``SD3TrainStatics``,
``_encode_prompts_train``, ``make_sd3_encode_fn``, ``sd3_lora_loss_fn``,
``SD3TrainingArgs`` and ``SD3LoRATrainer``, with the semantics of diffusers'
train_dreambooth_lora_sd3.py: timesteps drawn from the logit-normal density
(or uniformly) over the shifted flow-match sigma table, x_t = (1 - σ) x₀ +
σ ε, the velocity target ε - x₀ (optionally weighted by σ⁻²), LoRA factors
on the MM-DiT's attention projections of both streams
(:data:`MMDIT_TARGET_SUFFIXES`), the VAE, both CLIP towers and T5 frozen.

As in ``train/train_step.py``, the step runs eagerly: the VAE encodes in
fp32 and the three towers encode under ``torch.no_grad()`` (their attention
takes the forward kernels without lse; T5's position bias takes the
counted masked route), the MM-DiT runs through ``functional_call`` with the
LoRA-fused weights in the compute dtype, each joint block a region of
``train_step.remat`` under a remat policy, and its joint attention
differentiates through the backward kernels.  The draws come from a
``torch.Generator`` in this order — "latent_eps" (NCHW), "density" ([B],
the standard normal of the logit-normal scheme or the uniform draw),
"noise" (NCHW) — or are injected through ``draws=``.  ``cache_latents``
runs the encode apart, under no grad (``make_sd3_encode_fn``), drawing the
same "latent_eps" first, so that it gives the fused step's factors
exactly.

The trainer runs ``trainer.train_loop``: its checkpoints are the port's
(``train/checkpoint.py``) with the generator's state, and a resumed run
skips the batches the saved steps consumed, so that it continues the
straight run exactly; the JAX trainer restarts its key and data stream.
With a mesh, as ``trainer.SDLoRATrainer`` (``trainer.MeshPlan``: data
ranks, ZeRO-1, FSDP; the MM-DiT's projections split over ``tensor``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    SchedulerConfig,
    SD3Config,
    VAEConfig,
)
from stablediffusion_tpu_torch.lora.core import init_lora
from stablediffusion_tpu_torch.parallel import zero
from stablediffusion_tpu_torch.lora.formats import save_lora_file
from stablediffusion_tpu_torch.models.vae import normalize_latents, sample_latent
from stablediffusion_tpu_torch.pipelines.sd3 import SD3Model
from stablediffusion_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from stablediffusion_tpu_torch.train.dataset import SDLoRADataset
from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from stablediffusion_tpu_torch.train.train_step import (
    _draw,
    _resolve_remat,
    lora_weights,
    make_train_step,
    mesh_draws,
    remat,
    vae_moments,
)
from stablediffusion_tpu_torch.train.trainer import MeshPlan, train_loop
from stablediffusion_tpu_torch.utils.observability import trace

logger = logging.getLogger(__name__)

# the MM-DiT's attention projections, both streams (diffusers
# train_dreambooth_lora_sd3's target_modules)
MMDIT_TARGET_SUFFIXES = (
    "to_q", "to_k", "to_v", "to_out.0",
    "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
)


@dataclass(frozen=True)
class SD3TrainStatics:
    """Static settings of the SD3 step, with the JAX package's field names
    and defaults."""

    transformer_config: SD3Config
    vae_config: VAEConfig
    text_config: CLIPTextConfig
    text_config_2: CLIPTextConfig
    text_config_3: Optional[Any]  # models/t5.T5Config
    scheduler_config: SchedulerConfig
    compute_dtype: torch.dtype = torch.bfloat16
    weighting_scheme: str = "logit_normal"  # | "uniform" | "sigma_sqrt"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    gradient_checkpointing: bool = False
    vae_microbatch: int = 0
    # "" (the legacy flag decides) | "none" | "full" | "dots" | "offload"
    remat_policy: str = ""


@torch.no_grad()
def _encode_prompts_train(statics: SD3TrainStatics, frozen: Mapping[str, Any],
                          batch: Mapping[str, torch.Tensor]):
    """(embeds [B, 77 + S_t5, joint], pooled [B, P1 + P2]) of the triple
    encode (``pipelines/sd3`` semantics, no negatives): both CLIP towers'
    penultimate states, zero-padded to the joint width, then T5's last
    hidden state, or 77 rows of zeros without T5 (as the JAX step)."""
    device = next(frozen["text_encoder"].parameters()).device
    joint = statics.transformer_config.joint_attention_dim
    out1 = frozen["text_encoder"](batch["input_ids"].to(device))
    out2 = frozen["text_encoder_2"](batch["input_ids_2"].to(device))
    h = torch.cat([out1.hidden_states[-2], out2.hidden_states[-2].to(out1.hidden_states[-2])],
                  dim=-1)
    h = F.pad(h, (0, joint - h.shape[-1]))
    pooled = torch.cat([out1.projected_pooled,
                        out2.projected_pooled.to(out1.projected_pooled)], dim=-1)
    if statics.text_config_3 is not None and "input_ids_3" in batch:
        t5_h = frozen["text_encoder_3"](batch["input_ids_3"].to(device))
    else:
        t5_h = h.new_zeros((h.shape[0], 77, joint))
    return torch.cat([h, t5_h.to(h.dtype)], dim=1), pooled


def _encode_latents(frozen, batch, statics: SD3TrainStatics, draw, microbatch: int):
    """NCHW fp32 latents of the batch's pixels: the fp32 VAE encode, a
    sample with the "latent_eps" draw, SD3's shift and scale."""
    vae = frozen["vae"]
    pixels = batch["pixel_values"].to(next(vae.parameters()).device).permute(0, 3, 1, 2)
    mean, logvar = vae_moments(vae, pixels, torch.float32, microbatch)
    latents = sample_latent(mean, logvar, eps=draw("latent_eps", mean.shape)).float()
    return normalize_latents(latents, statics.vae_config)


def make_sd3_encode_fn(statics: SD3TrainStatics):
    """The ``cache_latents`` program: ``encode(frozen, batch, generator,
    draws=None) -> batch'``, where batch' replaces pixel_values /
    input_ids* with "latents" (sampled and normalised, fp32, NHWC),
    "prompt_embeds" and "pooled_embeds", under no grad, so that the VAE's
    fp32 activations and the three towers are gone before the MM-DiT's
    backward."""

    @torch.no_grad()
    def encode(frozen, batch, generator, draws=None):
        device = next(frozen["vae"].parameters()).device
        draw = lambda *a, **kw: _draw(draws, generator, device, *a, **kw)  # noqa: E731
        latents = _encode_latents(frozen, batch, statics, draw, 0)
        embeds, pooled = _encode_prompts_train(statics, frozen, batch)
        out = {k: v for k, v in batch.items()
               if k not in ("pixel_values", "input_ids", "input_ids_2", "input_ids_3")}
        out["latents"] = latents.permute(0, 2, 3, 1)
        out["prompt_embeds"] = embeds
        out["pooled_embeds"] = pooled
        return out

    return encode


def sd3_lora_loss_fn(
    lora: Mapping[str, Mapping],
    frozen: Mapping[str, Any],
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator],
    statics: SD3TrainStatics,
    scheduler: FlowMatchEulerScheduler,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The flow-matching loss, differentiable in ``lora["transformer"]``'s
    factors.  `frozen` holds the modules "transformer", "vae",
    "text_encoder", "text_encoder_2" (and "text_encoder_3")."""
    transformer = frozen["transformer"]
    device = next(transformer.parameters()).device
    draw = lambda *a, **kw: _draw(draws, generator, device, *a, **kw)  # noqa: E731

    if "latents" in batch:
        latents = batch["latents"].to(device).float().permute(0, 3, 1, 2)
    else:
        latents = _encode_latents(frozen, batch, statics, draw, statics.vae_microbatch)

    # timesteps from the density over the shifted sigma table (diffusers
    # compute_density_for_timestep_sampling)
    B = latents.shape[0]
    T = statics.scheduler_config.num_train_timesteps
    if statics.weighting_scheme == "logit_normal":
        u = torch.sigmoid(statics.logit_mean
                          + statics.logit_std * draw("density", (B,)).float())
    else:
        u = draw("density", (B,), lambda shape: torch.rand(
            shape, generator=generator, device=device)).float()
    idx = torch.clamp((u * T).to(torch.int32), 0, T - 1).long()
    sigmas = torch.as_tensor(scheduler._train_sigmas, dtype=torch.float32, device=device)[idx]
    timesteps = sigmas * T

    noise = draw("noise", latents.shape).float()
    sig_b = sigmas[:, None, None, None]
    noisy = (1.0 - sig_b) * latents + sig_b * noise

    if "prompt_embeds" in batch:
        embeds, pooled = batch["prompt_embeds"].to(device), batch["pooled_embeds"].to(device)
    else:
        embeds, pooled = _encode_prompts_train(statics, frozen, batch)

    fused = lora_weights(transformer, zero.whole_tree(lora)["transformer"])

    dt = statics.compute_dtype
    with remat(transformer, fused, _resolve_remat(statics)) as w:
        pred = functional_call(transformer, w, (noisy.to(dt), timesteps, embeds.to(dt),
                                                pooled.to(dt)), strict=False).float()
    target = noise - latents  # the flow velocity
    per_sample = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    if statics.weighting_scheme == "sigma_sqrt":
        per_sample = per_sample * sigmas ** -2.0
    return per_sample.mean()


@dataclass
class SD3TrainingArgs:
    """The JAX package's fields and defaults."""

    train_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    accum_dtype: str = "fp32"  # "bf16": the low-memory accumulator
    mixed_precision: str = "bf16"
    rank: int = 16
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_weight_decay: float = 1e-2
    num_train_epochs: int = 1
    max_train_steps: Optional[int] = None
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    resolution: int = 1024
    max_grad_norm: float = 1.0
    use_8bit_adam: bool = False
    seed: int = 0
    weighting_scheme: str = "logit_normal"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    max_sequence_length: int = 77
    random_flip: bool = True
    center_crop: bool = False
    gradient_checkpointing: bool = False
    vae_microbatch: int = 0
    remat_policy: str = ""
    cache_latents: bool = False
    checkpointing_steps: Optional[int] = None
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    # ZeRO memory levers on a data mesh (parallel/zero.py)
    shard_opt_state: bool = False
    shard_params: bool = False
    output_dir: str = "sd3-lora-out"
    log_every: int = 10
    report_to: Optional[str] = None


class SD3LoRATrainer:
    def __init__(
        self,
        model: SD3Model,
        args: SD3TrainingArgs,
        data_dir: Optional[str] = None,
        mesh=None,
        dataset=None,
        initial: Optional[Mapping[str, Mapping]] = None,
        draws: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    ):
        """`dataset` (any object with the SDLoRADataset batch interface)
        overrides the jpg+txt `data_dir`.  `initial` ({"transformer": {path:
        {"down", "up"}}}) replaces the seeded initial factors and `draws`
        (step -> draws, see :func:`sd3_lora_loss_fn`) the generator's draws:
        both for parity tests."""
        self.plan = MeshPlan(mesh, args.shard_opt_state, args.shard_params)
        if data_dir is None and dataset is None:
            raise ValueError("need a data_dir or a dataset")
        self.model = model
        self.args = args
        self.data_dir = data_dir
        self.dataset = dataset
        self.initial = initial
        self.draws = draws
        self.metrics = None
        if args.report_to == "tensorboard" and self.plan.main:
            from stablediffusion_tpu_torch.utils.observability import Metrics

            self.metrics = Metrics(tensorboard_dir=f"{args.output_dir}/logs")

    def train(self) -> Dict[str, Dict[str, dict]]:
        args = self.args
        model = self.model
        device = model.device
        generator = torch.Generator(device=device).manual_seed(args.seed)
        dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
        if self.initial is not None:
            lora = {"transformer": {
                p: {k: torch.as_tensor(v).to(device, torch.float32).clone()
                    for k, v in f.items() if k != "alpha"}
                for p, f in self.initial["transformer"].items()}}
        else:
            lora = {"transformer": init_lora(model.transformer, args.rank,
                                             MMDIT_TARGET_SUFFIXES, generator,
                                             store_alpha=False)}

        dataset = self.dataset or SDLoRADataset(
            self.data_dir, resolution=args.resolution, random_flip=args.random_flip,
            center_crop=args.center_crop, seed=args.seed)
        steps_per_epoch = max(len(dataset) // args.train_batch_size, 1)
        total_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch

        schedule = make_lr_schedule(args.lr_scheduler, args.learning_rate,
                                    args.lr_warmup_steps, total_steps)
        plan = self.plan
        optimizer = plan.optimizer(make_optimizer(
            schedule, args.adam_beta1, args.adam_beta2, args.adam_epsilon,
            args.adam_weight_decay, args.max_grad_norm, args.gradient_accumulation_steps,
            use_8bit=args.use_8bit_adam, accum_dtype=args.accum_dtype))
        opt_state = optimizer.init(lora)

        scheduler = FlowMatchEulerScheduler(model.scheduler_config)
        statics = SD3TrainStatics(
            transformer_config=model.transformer_config,
            vae_config=model.vae_config,
            text_config=model.text_encoder_config,
            text_config_2=model.text_encoder_2_config,
            text_config_3=model.text_encoder_3_config,
            scheduler_config=model.scheduler_config,
            compute_dtype=dtype,
            weighting_scheme=args.weighting_scheme,
            logit_mean=args.logit_mean,
            logit_std=args.logit_std,
            gradient_checkpointing=args.gradient_checkpointing,
            vae_microbatch=args.vae_microbatch,
            remat_policy=args.remat_policy,
        )
        step_fn = make_train_step(statics, scheduler, optimizer, loss=sd3_lora_loss_fn,
                                  mesh=plan.mesh, shard_params=args.shard_params)
        encode_fn = make_sd3_encode_fn(statics) if args.cache_latents else None

        frozen = {"transformer": model.transformer, "vae": model.vae,
                  "text_encoder": model.text_encoder, "text_encoder_2": model.text_encoder_2}
        if model.text_encoder_3 is not None:
            frozen["text_encoder_3"] = model.text_encoder_3
        modules = list(frozen.values())
        plan.split_modules(modules)

        run = {"lora": plan.split(lora), "opt_state": opt_state}

        def state():
            return {**run, "rng": generator.get_state()}

        def load(st):
            run.update(lora=st["lora"], opt_state=st["opt_state"])
            generator.set_state(st["rng"].cpu())

        def step_once(step, batch):
            tb = self._prepare_batch(batch)
            draws = self.draws(step) if self.draws is not None else None
            with trace("train_step", self.metrics):
                if encode_fn is not None:
                    with plan.gathered(modules):
                        tb = encode_fn(frozen, tb, generator, mesh_draws(draws, plan.mesh))
                run["lora"], run["opt_state"], metrics = step_fn(
                    run["lora"], run["opt_state"], frozen, tb, generator, draws=draws)
            return metrics

        def logged(step, loss, batch, s_per_it):
            logger.info("step %d/%d loss %.5f %.2f s/it", step, total_steps, loss, s_per_it)
            if self.metrics is not None:
                self.metrics.observe("train/loss", loss, step=step)

        self.history = train_loop(args, dataset, total_steps, state, load, step_once, logged,
                                  plan=plan)
        plan.unsplit_modules(modules)
        lora = plan.whole(run["lora"])
        self.lora = lora
        if self.metrics is not None:
            self.metrics.flush()
        if not plan.main:
            return lora
        os.makedirs(args.output_dir, exist_ok=True)
        save_lora_file(lora, f"{args.output_dir}/pytorch_lora_weights.safetensors",
                       metadata={"format": "pt", "rank": str(args.rank)})
        return lora

    def _prepare_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The collated numpy batch as tensors on the model's device, the
        captions tokenized for each tower (T5 at max_sequence_length)."""
        model = self.model
        device = model.device
        captions = batch["captions"]

        def ids(tokens) -> torch.Tensor:
            return torch.from_numpy(np.asarray(tokens)).long().to(device)

        tb = {"pixel_values": torch.from_numpy(batch["pixel_values"]).to(device),
              "input_ids": ids(model.tokenizer(captions)),
              "input_ids_2": ids(model.tokenizer_2(captions))}
        if model.tokenizer_3 is not None and model.text_encoder_3 is not None:
            tb["input_ids_3"] = ids(model.tokenizer_3(
                captions, max_length=self.args.max_sequence_length))
        return tb
