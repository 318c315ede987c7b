"""ControlNetTrainer: full ControlNet training on paired images.

Port of ``stablediffusion_tpu/train/controlnet_trainer.py``
(``ControlNetTrainingArgs`` :39-81, ``ControlNetTrainer.train`` :107-264,
``_log_validation`` :266-302, ``_prepare_batch`` :304-327): the ControlNet
initialized from the frozen UNet (``models/controlnet.init_from_unet``) or
resumed from a diffusers-layout ControlNet (``SDModel.load_controlnet``),
AdamW (or 8-bit Adam, with accumulation) over the whole ControlNet as fp32
masters, paired image / conditioning batches from the folder dataset
(``conditioning_dir``) or a ``datasets`` dataset, the eager step of
``train_step.controlnet_loss_fn``, the shared loop
(``trainer.train_loop``: rotating checkpoints and an exact resume),
validation renders through the port's pipeline with ``control_image`` on the
net being trained, and the final save as a diffusers-layout ControlNet
folder (``io/loader.save_controlnet``).  SD1.5 and SDXL (with the
micro-conditioning) both train.

Where it differs from the JAX trainer:

  * The random draws come from one ``torch.Generator`` on the model's
    device, seeded by ``args.seed``: the conditioning embedder's initial
    weights (``init_from_unet``), then each step's draws.  For parity tests
    each step's draws can be handed in (``draws=``, a callable of the
    0-based step).
  * A checkpoint also holds the generator's state, and a resumed run skips
    the batches the saved steps consumed, so that it continues the straight
    run exactly (``trainer.train_loop``); JAX restarts its key and data.
  * The net being trained is a module of its own (``self.controlnet``, in
    the UNet's dtype) whose weights the step substitutes with the masters;
    the validation render installs it as the model's ControlNet with the
    masters written in, and puts the model's own back after.
  * With a mesh, as ``trainer.SDLoRATrainer`` (``trainer.MeshPlan``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.models.controlnet import init_from_unet
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train.dataset import SDLoRADataset
from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from stablediffusion_tpu_torch.train.train_step import (
    TrainStatics,
    controlnet_loss_fn,
    make_train_step,
)
from stablediffusion_tpu_torch.train.trainer import MeshPlan, train_loop
from stablediffusion_tpu_torch.utils.observability import trace

logger = logging.getLogger(__name__)


@dataclass
class ControlNetTrainingArgs:
    """The JAX package's fields and defaults (diffusers train_controlnet.py)."""

    train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    accum_dtype: str = "fp32"  # "bf16": low-memory accumulator
    mixed_precision: str = "bf16"
    learning_rate: float = 5e-6  # train_controlnet.py default
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_weight_decay: float = 1e-2
    num_train_epochs: int = 1
    max_train_steps: Optional[int] = None
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    resolution: int = 512
    max_grad_norm: float = 1.0
    use_8bit_adam: bool = False
    seed: int = 0
    snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    random_flip: bool = False  # default off: flips can break cond alignment
    center_crop: bool = False
    gradient_checkpointing: bool = False
    remat_policy: str = ""
    vae_microbatch: int = 8
    checkpointing_steps: Optional[int] = None
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    output_dir: str = "controlnet-out"
    log_every: int = 10
    report_to: Optional[str] = "tensorboard"
    logging_dir: Optional[str] = None
    # render validation images every N epochs with the in-training ControlNet
    validation_prompt: Optional[str] = None
    validation_image: Optional[str] = None  # path to a conditioning image
    num_validation_images: int = 4
    validation_epochs: int = 1
    validation_steps: Optional[int] = None  # step-based override
    validation_inference_steps: int = 25
    # ZeRO memory levers on a data mesh (parallel/zero.py)
    shard_opt_state: bool = False
    shard_params: bool = False


class ControlNetTrainer:
    def __init__(
        self,
        model: SDModel,
        args: ControlNetTrainingArgs,
        data_dir: Optional[str] = None,
        conditioning_dir: Optional[str] = None,
        controlnet_path: Optional[str] = None,  # resume from diffusers layout
        mesh=None,
        dataset=None,
        draws: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    ):
        """`dataset` (the SDLoRADataset batch interface, with
        ``conditioning_pixel_values``) overrides the folder pair; `draws`
        (step -> NCHW draws, see ``train_step._prepare_diffusion``) replaces
        the generator's draws, for parity tests."""
        if data_dir is None and dataset is None:
            raise ValueError("need a data_dir or a dataset")
        self.plan = MeshPlan(mesh, args.shard_opt_state, args.shard_params)
        self.model = model
        self.args = args
        self.data_dir = data_dir
        self.conditioning_dir = conditioning_dir
        self.controlnet_path = controlnet_path
        self.dataset = dataset
        self.draws = draws
        self.metrics = None
        if args.report_to == "tensorboard" and self.plan.main:
            from stablediffusion_tpu_torch.utils.observability import Metrics

            self.metrics = Metrics(tensorboard_dir=args.logging_dir
                                   or f"{args.output_dir}/logs")

    def _init_controlnet(self, generator: torch.Generator):
        """(config, module in the UNet's dtype, fp32 masters)."""
        model = self.model
        dtype = next(model.unet.parameters()).dtype
        if self.controlnet_path:
            from stablediffusion_tpu_torch.io.loader import load_controlnet

            # the masters from the file's own values, the module in the
            # UNet's dtype
            cfg, net = load_controlnet(self.controlnet_path, model.device, torch.float32)
            masters = {n: p.detach().clone() for n, p in net.named_parameters()}
            net = net.to(dtype)
        else:
            cfg = model.unet_config
            net = init_from_unet(model.unet, cfg, generator)
            masters = {n: p.detach().float().clone() for n, p in net.named_parameters()}
        net.requires_grad_(False)
        return cfg, net, masters

    def train(self) -> Dict[str, torch.Tensor]:
        """Run the training; returns the fp32 masters at its end."""
        args, model, plan = self.args, self.model, self.plan
        generator = torch.Generator(device=model.device).manual_seed(args.seed)
        dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
        cn_config, net, controlnet = self._init_controlnet(generator)

        dataset = self.dataset or SDLoRADataset(
            self.data_dir, resolution=args.resolution, random_flip=args.random_flip,
            center_crop=args.center_crop, seed=args.seed,
            conditioning_dir=self.conditioning_dir)
        steps_per_epoch = max(len(dataset) // args.train_batch_size, 1)
        total_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch

        schedule = make_lr_schedule(args.lr_scheduler, args.learning_rate,
                                    args.lr_warmup_steps, total_steps)
        optimizer = plan.optimizer(make_optimizer(
            schedule, args.adam_beta1, args.adam_beta2, args.adam_epsilon,
            args.adam_weight_decay, args.max_grad_norm, args.gradient_accumulation_steps,
            use_8bit=args.use_8bit_adam, accum_dtype=args.accum_dtype))
        opt_state = optimizer.init(controlnet)

        scheduler = DDPMScheduler(model.scheduler_config)
        statics = TrainStatics(
            unet_config=model.unet_config,
            vae_config=model.vae_config,
            text_config=model.text_encoder_config,
            text_config_2=model.text_encoder_2_config if model.is_sdxl else None,
            scheduler_config=model.scheduler_config,
            train_text_encoder=False,
            snr_gamma=args.snr_gamma,
            noise_offset=args.noise_offset,
            compute_dtype=dtype,
            gradient_checkpointing=args.gradient_checkpointing,
            remat_policy=args.remat_policy,
            vae_microbatch=args.vae_microbatch,
            controlnet_config=cn_config,
        )
        step_fn = make_train_step(statics, scheduler, optimizer, loss=controlnet_loss_fn,
                                  mesh=plan.mesh, shard_params=args.shard_params)

        frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder,
                  "controlnet": net}
        if model.is_sdxl:
            frozen["text_encoder_2"] = model.text_encoder_2
        modules = list(frozen.values())
        plan.split_modules(modules)
        run = {"controlnet": plan.split(controlnet), "opt_state": opt_state}

        def state():
            return {**run, "rng": generator.get_state()}

        def load(st):
            run.update(controlnet=st["controlnet"], opt_state=st["opt_state"])
            generator.set_state(st["rng"].cpu())

        def step_once(step, batch):
            tb = self._prepare_batch(batch)
            draws = self.draws(step) if self.draws is not None else None
            with trace("train_step", self.metrics):
                run["controlnet"], run["opt_state"], metrics = step_fn(
                    run["controlnet"], run["opt_state"], frozen, tb, generator, draws=draws)
            return metrics

        def logged(step, loss, batch, s_per_it):
            lr = float(schedule(step))
            logger.info("step %d/%d loss %.5f lr %.2e %.2f s/it", step, total_steps, loss, lr,
                        s_per_it)
            if self.metrics is not None:
                self.metrics.observe("train/loss", loss, step=step)
                self.metrics.observe("train/lr", lr, step=step)

        val_every = args.validation_steps or steps_per_epoch * args.validation_epochs

        def after(step):
            if args.validation_prompt and args.validation_image and step % val_every == 0:
                current = plan.whole(run["controlnet"])
                with plan.gathered(modules):
                    if plan.main:
                        self._log_validation(net, current, cn_config, step)

        self.history = train_loop(args, dataset, total_steps, state, load, step_once, logged,
                                  after, plan)
        plan.unsplit_modules(modules)
        controlnet = plan.whole(run["controlnet"])
        self.controlnet = controlnet
        self.controlnet_config = cn_config
        if self.metrics is not None:
            self.metrics.flush()
        if plan.main:
            from stablediffusion_tpu_torch.io.loader import save_controlnet

            # the fp32 masters, as JAX saves its fp32 tree
            save_controlnet(controlnet, cn_config, args.output_dir)
        return controlnet

    def _log_validation(self, net, controlnet, cn_config, step: int) -> None:
        """Render the validation images with the CURRENT ControlNet (its
        masters in the module, in the module's dtype) installed as the
        model's, then restore the model's own (:268-302)."""
        from PIL import Image

        from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

        args, model = self.args, self.model
        prev = model.controlnet_config, model.controlnet
        try:
            model.controlnet_config = cn_config
            model.controlnet = _with_weights(net, controlnet)
            cond = np.asarray(Image.open(args.validation_image).convert("RGB"),
                              np.float32) / 255.0
            out = StableDiffusionUnifiedPipeline(device=model.device)(
                model,
                prompt=args.validation_prompt,
                num_images_per_prompt=args.num_validation_images,
                num_inference_steps=args.validation_inference_steps,
                height=args.resolution,
                width=args.resolution,
                seed=args.seed,
                control_image=cond,
            )
            if self.metrics is not None:
                self.metrics.images("validation", out.images, step=step)
            logger.info("step %d: rendered %d validation images", step,
                        args.num_validation_images)
        finally:
            model.controlnet_config, model.controlnet = prev

    def _prepare_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The collated numpy batch as tensors on the model's device, the
        captions tokenized (SDXL: both towers and the micro-conditioning)."""
        model = self.model
        device = model.device
        if "conditioning_pixel_values" not in batch:
            raise ValueError("ControlNet training needs conditioning images (a "
                             "conditioning_dir or a dataset conditioning_image column)")
        tb = {
            "pixel_values": torch.from_numpy(batch["pixel_values"]).to(device),
            "conditioning_pixel_values": torch.from_numpy(
                np.asarray(batch["conditioning_pixel_values"], np.float32)).to(device),
            "input_ids": torch.from_numpy(np.asarray(model.tokenizer(batch["captions"])))
            .long().to(device),
        }
        if model.is_sdxl:
            tb["input_ids_2"] = torch.from_numpy(
                np.asarray(model.tokenizer_2(batch["captions"]))).long().to(device)
            for k in ("original_sizes", "crop_top_lefts", "target_sizes"):
                tb[k] = torch.from_numpy(batch[k]).to(device)
        return tb


def _with_weights(net: torch.nn.Module, weights: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """`net` with `weights` copied in (in its dtype)."""
    params = dict(net.named_parameters())
    with torch.no_grad():
        for n, t in weights.items():
            params[n].copy_(t)
    return net
