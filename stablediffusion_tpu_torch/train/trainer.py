"""SDLoRATrainer: in-process LoRA fine-tuning on a folder of images.

Port of the LoRA path of ``stablediffusion_tpu/train/trainer.py``
(``SDTrainingArgs`` :43-142, ``SDLoRATrainer.train`` :145-602,
``_log_validation`` :705-735, ``_prepare_batch`` :737-767): seed -> LoRA
factors on the UNet's attention projections (and, with
``train_text_encoder``, on both text towers' q/k/v/out_proj) -> the folder
dataset with its micro-conditioning collation and optional aspect-ratio
buckets -> LR schedule and AdamW (8-bit moments, gradient accumulation) ->
the eager train step of ``train/train_step.py`` (or, with
``cache_latents``, its separate no-grad encode first) -> logging,
per-epoch validation renders through the port's pipeline, rotating
checkpoints -> the LoRA safetensors file (peft or kohya).

Where it differs from the JAX trainer:

  * The random draws come from one ``torch.Generator`` on the model's
    device, seeded by ``args.seed``, in this order: the UNet's factors, the
    text towers', then each step's draws.  ``jax.random`` cannot be
    reproduced in torch, so for parity tests the initial factors
    (``initial=``) and each step's draws (``draws=``, a callable of the
    0-based step) can be handed in.  Nothing else uses them.
  * A checkpoint also holds the generator's state, and a resumed run skips
    the batches the saved steps consumed, so that it continues the straight
    run exactly.  The JAX trainer restarts its key and its data stream on
    resume.  The checkpoint format is the port's (``train/checkpoint.py``),
    not orbax.
  * Textual-inversion training, DreamBooth (``instance_prompt``,
    ``with_prior_preservation``), full finetuning with EMA (ROADMAP §1 item
    19) and a device mesh or sharded state (item 20) raise.

Like the JAX trainer, tower 2 is tokenized from the dataset's captions
(``trainer.py:759``).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from stablediffusion_tpu_torch.lora.core import (
    TEXT_TARGET_SUFFIXES,
    UNET_TARGET_SUFFIXES,
    init_lora,
)
from stablediffusion_tpu_torch.lora.formats import save_lora_file
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train import checkpoint as ckpt
from stablediffusion_tpu_torch.train.dataset import SDLoRADataset
from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from stablediffusion_tpu_torch.train.train_step import (
    TrainStatics,
    make_encode_fn,
    make_train_step,
)

logger = logging.getLogger(__name__)


@dataclass
class SDTrainingArgs:
    """The JAX package's fields and defaults (trainer.py:43-142)."""

    train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    # "fp32" (optax.MultiSteps) | "bf16" (multi_steps_lowmem)
    accum_dtype: str = "fp32"
    mixed_precision: str = "bf16"  # "bf16" | "no"
    rank: int = 16
    train_text_encoder: bool = True
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_weight_decay: float = 1e-2
    num_train_epochs: int = 100
    max_train_steps: Optional[int] = None
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 500
    resolution: int = 1024
    max_grad_norm: float = 1.0
    use_8bit_adam: bool = False
    seed: int = 0
    snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    random_flip: bool = True
    center_crop: bool = False
    # kohya-style aspect-ratio buckets: each batch from one bucket
    aspect_ratio_bucketing: bool = False
    bucket_step: int = 64
    max_bucket_ar: float = 2.0
    max_buckets: int = None
    gradient_checkpointing: bool = False
    # "" | "none" | "full" ("dots" and "offload" raise)
    remat_policy: str = ""
    # encode latents and text embeddings apart from the gradient step
    # (needs train_text_encoder=False)
    cache_latents: bool = False
    vae_microbatch: int = 8
    checkpointing_steps: Optional[int] = None
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None  # path | "latest"
    output_dir: str = "lora-out"
    log_every: int = 10
    validation_prompt: Optional[str] = None
    num_validation_images: int = 4
    validation_epochs: int = 1
    validation_inference_steps: int = 25
    report_to: Optional[str] = "tensorboard"
    logging_dir: Optional[str] = None  # default {output_dir}/logs
    debug_loss: bool = False  # the batch loss logged per filename
    # not ported yet (ROADMAP §1 item 19): full finetuning and EMA
    full_finetune: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    # not ported yet (ROADMAP §1 item 20): state sharded over a mesh
    shard_opt_state: bool = False
    shard_params: bool = False
    # "peft" (diffusers load_lora_weights) | "kohya" (A1111/kohya-ss)
    lora_format: str = "peft"
    # not ported yet (ROADMAP §1 item 19): textual-inversion training
    textual_inversion: Optional[str] = None
    ti_initializer_token: Optional[str] = None
    ti_num_vectors: int = 1
    ti_templates: str = "object"
    # not ported yet (ROADMAP §1 item 19): DreamBooth
    instance_prompt: Optional[str] = None
    with_prior_preservation: bool = False
    class_data_dir: Optional[str] = None
    class_prompt: Optional[str] = None
    num_class_images: int = 50
    prior_loss_weight: float = 1.0
    sample_batch_size: int = 4


def check_args(args: SDTrainingArgs, mesh=None) -> None:
    """Raise, naming the ROADMAP §1 item, on an option the port does not
    have."""
    later = {
        "textual_inversion": (args.textual_inversion, 19),
        "instance_prompt": (args.instance_prompt, 19),
        "with_prior_preservation": (args.with_prior_preservation, 19),
        "full_finetune": (args.full_finetune, 19),
        "use_ema": (args.use_ema, 19),
        "mesh": (mesh is not None, 20),
        "shard_opt_state": (args.shard_opt_state, 20),
        "shard_params": (args.shard_params, 20),
    }
    for name, (value, item) in later.items():
        if value:
            raise NotImplementedError(
                f"{name}: not ported yet, it comes with ROADMAP §1 item {item}")


class SDLoRATrainer:
    def __init__(
        self,
        model: SDModel,
        args: SDTrainingArgs,
        data_dir: Optional[str] = None,
        mesh=None,
        dataset=None,
        initial: Optional[Mapping[str, Mapping]] = None,
        draws: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    ):
        """`dataset` (any object with the SDLoRADataset batch interface)
        overrides the jpg+txt `data_dir`.  `initial` ({component: {path:
        {"down", "up"}}}) replaces the seeded initial factors and `draws`
        (step -> NCHW draws, see ``train_step._prepare_diffusion``) the
        generator's draws: both for parity tests."""
        check_args(args, mesh)
        if data_dir is None and dataset is None:
            raise ValueError("need a data_dir or a dataset")
        self.model = model
        self.args = args
        self.data_dir = data_dir
        self.dataset = dataset
        self.initial = initial
        self.draws = draws
        self.metrics = None
        if args.report_to == "tensorboard":
            from stablediffusion_tpu_torch.utils.observability import Metrics

            self.metrics = Metrics(tensorboard_dir=args.logging_dir
                                   or f"{args.output_dir}/logs")

    def _init_trainable(self, generator: torch.Generator) -> Dict[str, Dict[str, dict]]:
        """fp32 LoRA factors (store_alpha=False): the seeded ones, or
        copies of `initial` on the model's device."""
        args, model = self.args, self.model
        modules = {"unet": (model.unet, UNET_TARGET_SUFFIXES)}
        if args.train_text_encoder:
            modules["text_encoder"] = (model.text_encoder, TEXT_TARGET_SUFFIXES)
            if model.is_sdxl:
                modules["text_encoder_2"] = (model.text_encoder_2, TEXT_TARGET_SUFFIXES)
        trainable = {}
        for comp, (module, suffixes) in modules.items():
            if self.initial is not None:
                trainable[comp] = {
                    p: {k: torch.as_tensor(v).to(model.device, torch.float32).clone()
                        for k, v in f.items() if k != "alpha"}
                    for p, f in self.initial[comp].items()}
            else:
                trainable[comp] = init_lora(module, args.rank, suffixes, generator,
                                            store_alpha=False)
        return trainable

    def train(self) -> Dict[str, Dict[str, dict]]:
        args = self.args
        model = self.model
        device = model.device
        generator = torch.Generator(device=device).manual_seed(args.seed)
        dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
        lora = self._init_trainable(generator)

        dataset = self.dataset or SDLoRADataset(
            self.data_dir,
            resolution=args.resolution,
            random_flip=args.random_flip,
            center_crop=args.center_crop,
            seed=args.seed,
            aspect_ratio_bucketing=args.aspect_ratio_bucketing,
            bucket_step=args.bucket_step,
            max_bucket_ar=args.max_bucket_ar,
            max_buckets=args.max_buckets,
        )
        if args.aspect_ratio_bucketing and not getattr(dataset, "buckets", None):
            raise ValueError("aspect_ratio_bucketing needs the folder dataset "
                             "(SDLoRADataset); the provided dataset has no buckets")
        steps_per_epoch = max(len(dataset) // args.train_batch_size, 1)
        total_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch

        schedule = make_lr_schedule(args.lr_scheduler, args.learning_rate,
                                    args.lr_warmup_steps, total_steps)
        optimizer = make_optimizer(
            schedule, args.adam_beta1, args.adam_beta2, args.adam_epsilon,
            args.adam_weight_decay, args.max_grad_norm, args.gradient_accumulation_steps,
            use_8bit=args.use_8bit_adam, accum_dtype=args.accum_dtype,
        )
        opt_state = optimizer.init(lora)

        scheduler = DDPMScheduler(model.scheduler_config)
        statics = TrainStatics(
            unet_config=model.unet_config,
            vae_config=model.vae_config,
            text_config=model.text_encoder_config,
            text_config_2=model.text_encoder_2_config if model.is_sdxl else None,
            scheduler_config=model.scheduler_config,
            train_text_encoder=args.train_text_encoder,
            snr_gamma=args.snr_gamma,
            noise_offset=args.noise_offset,
            compute_dtype=dtype,
            gradient_checkpointing=args.gradient_checkpointing,
            remat_policy=args.remat_policy,
            vae_microbatch=args.vae_microbatch,
        )
        step_fn = make_train_step(statics, scheduler, optimizer)
        encode_fn = None
        if args.cache_latents:
            if args.train_text_encoder:
                raise ValueError("--cache_latents requires train_text_encoder=False")
            encode_fn = make_encode_fn(statics)

        frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
        if model.is_sdxl:
            frozen["text_encoder_2"] = model.text_encoder_2

        start_step = 0
        if args.resume_from_checkpoint:
            found = ckpt.resolve_resume(args.resume_from_checkpoint, args.output_dir)
            if found:
                start_step, path = found
                template = {"lora": lora, "opt_state": opt_state,
                            "rng": generator.get_state()}
                state = ckpt.load_checkpoint(path, template)
                lora, opt_state = state["lora"], state["opt_state"]
                generator.set_state(state["rng"].cpu())
                logger.info("resumed from %s at step %d", path, start_step)

        step = start_step
        t0 = time.time()
        history = []
        batch_iter = dataset.batches(args.train_batch_size, epochs=None)
        try:
            for _ in range(start_step):  # the batches the saved steps consumed
                next(batch_iter)
            for batch in batch_iter:
                if step >= total_steps:
                    break
                tb = self._prepare_batch(batch)
                draws = self.draws(step) if self.draws is not None else None
                if encode_fn is not None:
                    tb = encode_fn(frozen, tb, generator, draws)
                lora, opt_state, metrics = step_fn(lora, opt_state, frozen, tb, generator,
                                                   draws=draws)
                step += 1
                if step % args.log_every == 0 or step == total_steps:
                    loss = float(metrics["loss"])
                    history.append((step, loss))
                    lr = float(schedule(step))
                    logger.info("step %d/%d loss %.5f lr %.2e %.2f s/it", step, total_steps,
                                loss, lr, (time.time() - t0) / max(step - start_step, 1))
                    if self.metrics is not None:
                        self.metrics.observe("train/loss", loss, step=step)
                        self.metrics.observe("train/lr", lr, step=step)
                        if args.debug_loss:
                            for fname in batch.get("filenames") or []:
                                self.metrics.observe(f"loss_for_{fname}", loss, step=step)
                if (args.validation_prompt
                        and step % (steps_per_epoch * args.validation_epochs) == 0):
                    self._log_validation(lora, step // steps_per_epoch, step)
                if args.checkpointing_steps and step % args.checkpointing_steps == 0:
                    state = {"lora": lora, "opt_state": opt_state,
                             "rng": generator.get_state()}
                    ckpt.save_checkpoint(args.output_dir, step, state,
                                         args.checkpoints_total_limit)
        finally:
            batch_iter.close()
        self.history = history
        self.lora = lora
        if self.metrics is not None:
            self.metrics.flush()
        os.makedirs(args.output_dir, exist_ok=True)
        save_lora_file(
            lora,
            f"{args.output_dir}/pytorch_lora_weights.safetensors",
            metadata={"format": "pt", "rank": str(args.rank)},
            format=args.lora_format,
        )
        return lora

    def _log_validation(self, lora, epoch: int, step: int) -> None:
        """Render the validation images at a fixed seed with the current
        factors fused in, log them, and take the adapter out again: the
        model's weights come back bit for bit (``delete_adapters``)."""
        from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

        args, model = self.args, self.model
        model.load_lora_weights("__validation__", lora)
        try:
            model.set_adapters({"__validation__": 1.0})
            out = StableDiffusionUnifiedPipeline(device=model.device)(
                model,
                prompt=args.validation_prompt,
                num_images_per_prompt=args.num_validation_images,
                num_inference_steps=args.validation_inference_steps,
                seed=args.seed,
            )
            if self.metrics is not None:
                self.metrics.images("validation", out.images, step=step)
            logger.info("epoch %d: rendered %d validation images (%r)", epoch,
                        args.num_validation_images, args.validation_prompt)
        finally:
            model.delete_adapters()

    def _prepare_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The collated numpy batch as tensors on the model's device, with
        the captions tokenized (tower 2 from the dataset's captions)."""
        model = self.model
        device = model.device
        tb = {
            "pixel_values": torch.from_numpy(batch["pixel_values"]).to(device),
            "input_ids": torch.from_numpy(model.tokenizer(batch["captions"])).long().to(device),
        }
        if model.is_sdxl:
            tb["input_ids_2"] = torch.from_numpy(
                model.tokenizer_2(batch["captions"])).long().to(device)
            for k in ("original_sizes", "crop_top_lefts", "target_sizes"):
                tb[k] = torch.from_numpy(batch[k]).to(device)
        return tb
