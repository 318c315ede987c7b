"""SDLoRATrainer: in-process fine-tuning on a folder of images.

Port of ``stablediffusion_tpu/train/trainer.py`` (``SDTrainingArgs``
:43-142, ``SDLoRATrainer.train`` :170-602, ``_ensure_class_images``
:604-650, ``_set_ti_rows`` :651, the validation renders :677-735,
``_prepare_batch`` :737-767): seed -> the trainable tree -> the folder
dataset with its micro-conditioning collation and optional aspect-ratio
buckets (DreamBooth: [instance | class] batches) -> LR schedule and AdamW
(8-bit moments, gradient accumulation) -> the eager train step of
``train/train_step.py`` (or, with ``cache_latents``, its separate no-grad
encode first) -> logging, per-epoch validation renders through the port's
pipeline, rotating checkpoints -> the saved result.  The trainable tree is,
as in JAX:

  * LoRA factors on the UNet's attention projections (and, with
    ``train_text_encoder``, on both text towers' q/k/v/out_proj), saved as
    a peft or kohya file;
  * with ``full_finetune``, the whole UNet as fp32 masters (the towers
    frozen), optionally with an EMA of them (``use_ema``), installed as the
    model's UNet in fp32 (``SDModel.install_unet``) and saved as a
    diffusers folder (``io/loader.save_sd_model``);
  * with ``textual_inversion``, the placeholder token's embedding rows
    (SDXL: in both towers), seeded from ``ti_initializer_token``, captions
    drawn from the paper's templates (``train/ti_templates.py``), saved as
    ``learned_embeds.safetensors``.

``instance_prompt`` replaces the folder's captions; with
``with_prior_preservation`` the class images come from ``class_data_dir``,
rendered there by the model itself where fewer than ``num_class_images``
exist, and the class half of each batch is weighted by
``prior_loss_weight``.

Where it differs from the JAX trainer:

  * The random draws come from one ``torch.Generator`` on the model's
    device, seeded by ``args.seed``, in this order: the UNet's factors, the
    text towers', then each step's draws.  ``jax.random`` cannot be
    reproduced in torch, so for parity tests the initial factors
    (``initial=``) and each step's draws (``draws=``, a callable of the
    0-based step) can be handed in.  Nothing else uses them.
  * A checkpoint also holds the generator's state (and the template
    draw's), and a resumed run skips the batches the saved steps consumed,
    so that it continues the straight run exactly.  The JAX trainer
    restarts its key and its data stream on resume.  The checkpoint format
    is the port's (``train/checkpoint.py``), not orbax.
  * The EMA is updated in place (``torch._foreach_lerp_``, fp32), where
    JAX builds a new tree, e·d + p·(1−d); the two round differently in the
    last bit.
  * A combination of options the JAX trainer refuses in ``train()`` is
    refused when the trainer is built, before its log writer opens.
  * With a mesh (``parallel/mesh.py``, one process per GPU under
    torchrun), ``train_batch_size`` is the global batch: each data rank
    reads its rows (``batches(shard_index=, num_shards=)``), the step
    averages the gradients (``train_step.make_train_step``), and
    ``shard_opt_state`` (ZeRO-1) / ``shard_params`` (FSDP) split the state
    over ``data`` (``parallel/zero.py``).  Rank 0 logs, renders and saves;
    over more than one rank each rank checkpoints its own state under
    ``{output_dir}/rank-{r}``, where JAX's orbax writes one global
    checkpoint.

Like the JAX trainer, tower 2 is tokenized from the dataset's captions
(``trainer.py:759``), not from the instance prompt or the template.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
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
from stablediffusion_tpu_torch.train.dataset import DreamBoothDataset, SDLoRADataset
from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from stablediffusion_tpu_torch.train.ti_templates import OBJECT_TEMPLATES, STYLE_TEMPLATES
from stablediffusion_tpu_torch.utils.observability import trace
from stablediffusion_tpu_torch.train.train_step import (
    TOKEN_TABLE,
    TrainStatics,
    full_finetune_loss_fn,
    loss_fn,
    make_encode_fn,
    make_train_step,
    mesh_draws,
    ti_loss_fn,
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
    # "" | "none" | "full" | "dots" | "offload" (train_step.remat)
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
    # train the whole UNet (fp32 masters, towers frozen) and save a folder;
    # with use_ema, the EMA of the weights is what is saved
    full_finetune: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    # ZeRO memory levers on a data mesh (parallel/zero.py): split the Adam
    # moments (ZeRO-1), and the trainable and frozen weights (FSDP)
    shard_opt_state: bool = False
    shard_params: bool = False
    # "peft" (diffusers load_lora_weights) | "kohya" (A1111/kohya-ss)
    lora_format: str = "peft"
    # textual inversion: the placeholder token, the single token whose row
    # seeds its vectors, their number, and the caption templates ("object"
    # | "style"; the folder's captions are ignored)
    textual_inversion: Optional[str] = None
    ti_initializer_token: Optional[str] = None
    ti_num_vectors: int = 1
    ti_templates: str = "object"
    # DreamBooth: the instance prompt replaces the folder's captions; prior
    # preservation pairs each batch with class images (rendered into
    # class_data_dir by the model where too few exist)
    instance_prompt: Optional[str] = None
    with_prior_preservation: bool = False
    class_data_dir: Optional[str] = None
    class_prompt: Optional[str] = None
    num_class_images: int = 50
    prior_loss_weight: float = 1.0
    sample_batch_size: int = 4


class MeshPlan:
    """A trainer's use of a mesh (None: this process alone): the optimizer
    (ZeRO-1 wrapped), where the state lives (FSDP), which rank writes, and
    where each rank checkpoints."""

    def __init__(self, mesh=None, shard_opt_state: bool = False, shard_params: bool = False):
        if (shard_opt_state or shard_params) and mesh is None:
            raise ValueError("shard_opt_state/shard_params split state over the data axis — "
                             "pass a mesh (or --mesh_dp on the CLI)")
        self.mesh = mesh
        self.shard_opt_state, self.shard_params = shard_opt_state, shard_params

    @property
    def main(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    @property
    def world(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size() if self.mesh is not None and dist.is_initialized() else 1

    def data(self):
        """(data ranks, this rank's data index)."""
        if self.mesh is None:
            return 1, 0
        return self.mesh.shape["data"], self.mesh.data_index

    def optimizer(self, optimizer):
        """ZeRO-1 around `optimizer` (FSDP's slices need it too)."""
        if not (self.shard_opt_state or self.shard_params):
            return optimizer
        from stablediffusion_tpu_torch.parallel.zero import ZeroOptimizer

        return ZeroOptimizer(optimizer, self.mesh)

    def split(self, tree):
        """This rank's slices of a trainable tree under FSDP."""
        if not self.shard_params:
            return tree
        from stablediffusion_tpu_torch.parallel import zero

        return zero.shard_tree(tree, self.mesh)

    def split_modules(self, modules) -> None:
        if self.shard_params:
            from stablediffusion_tpu_torch.parallel import zero

            zero.shard_modules_(modules, self.mesh)

    def whole(self, tree):
        """The whole trainable tree from the ranks' slices (a collective)."""
        if not self.shard_params:
            return tree
        from stablediffusion_tpu_torch.parallel import zero

        return zero.gather_tree(tree)

    def unsplit_modules(self, modules) -> None:
        if self.shard_params:
            from stablediffusion_tpu_torch.parallel import zero

            zero.unshard_modules_(modules)

    def gathered(self, modules):
        """A block with the frozen modules whole (every rank enters it)."""
        import contextlib

        if not self.shard_params:
            return contextlib.nullcontext()
        from stablediffusion_tpu_torch.parallel import zero

        return zero.gathered(modules)

    def ckpt_dir(self, output_dir: str) -> str:
        return output_dir if self.world == 1 else os.path.join(output_dir,
                                                               f"rank-{self.mesh.rank}")


def train_loop(args, dataset, total_steps: int, state: Callable[[], dict],
               load: Callable[[dict], None], step_once: Callable[[int, Mapping], Mapping],
               logged: Callable[[int, float, Mapping, float], None],
               after: Optional[Callable[[int], None]] = None,
               plan: Optional[MeshPlan] = None):
    """The loop of both trainers (this one and ``sd3_train.SD3LoRATrainer``):
    resume from ``args.resume_from_checkpoint`` (the checkpoint's tree is
    ``state()``, handed back to ``load``) and skip the batches the saved
    steps consumed, so that the run continues the straight one exactly;
    then per step ``step_once(step, batch)`` (0-based, the collated batch)
    -> metrics, ``logged(step, loss, batch, seconds per step)`` every
    ``log_every`` steps and at the last, ``after(step)``, and a checkpoint
    of ``state()`` every ``checkpointing_steps``.  Under a mesh (`plan`)
    each data rank reads its rows of each global batch, and only rank 0
    logs.  Returns the logged (step, loss) pairs."""
    plan = plan or MeshPlan()
    n_data, d = plan.data()
    if args.train_batch_size % n_data:
        raise ValueError(f"train_batch_size {args.train_batch_size} does not divide over "
                         f"{n_data} data ranks")
    ckpt_dir = plan.ckpt_dir(args.output_dir)
    start_step = 0
    if args.resume_from_checkpoint:
        found = ckpt.resolve_resume(args.resume_from_checkpoint, ckpt_dir)
        if found:
            start_step, path = found
            load(ckpt.load_checkpoint(path, state()))
            logger.info("resumed from %s at step %d", path, start_step)
    step = start_step
    t0 = time.time()
    history = []
    batch_iter = dataset.batches(args.train_batch_size // n_data, epochs=None,
                                 shard_index=d, num_shards=n_data)
    try:
        for _ in range(start_step):  # the batches the saved steps consumed
            next(batch_iter)
        for batch in batch_iter:
            if step >= total_steps:
                break
            metrics = step_once(step, batch)
            step += 1
            if step % args.log_every == 0 or step == total_steps:
                loss = float(metrics["loss"])
                history.append((step, loss))
                if plan.main:
                    logged(step, loss, batch, (time.time() - t0) / max(step - start_step, 1))
            if after is not None:
                after(step)
            if args.checkpointing_steps and step % args.checkpointing_steps == 0:
                ckpt.save_checkpoint(ckpt_dir, step, state(), args.checkpoints_total_limit)
    finally:
        batch_iter.close()
    return history


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
        self.plan = MeshPlan(mesh, args.shard_opt_state, args.shard_params)
        if data_dir is None and dataset is None:
            raise ValueError("need a data_dir or a dataset")
        self.model = model
        self.args = args
        self.data_dir = data_dir
        self.dataset = dataset
        self.initial = initial
        self.draws = draws
        self._check_modes()
        self.metrics = None
        if args.report_to == "tensorboard" and self.plan.main:
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

    def _check_modes(self) -> None:
        """The JAX trainer's refusals of option combinations (:178-209,
        :264-269, :394-395), made before anything is written."""
        args = self.args
        if args.with_prior_preservation:
            if args.textual_inversion:
                raise ValueError(
                    "with_prior_preservation does not combine with textual_inversion (the "
                    "TI paper trains on concept images only)")
            if not (args.instance_prompt and args.class_prompt and args.class_data_dir):
                raise ValueError("with_prior_preservation needs instance_prompt, "
                                 "class_prompt and class_data_dir")
            if self.dataset is not None:
                raise ValueError("with_prior_preservation builds its own paired dataset; "
                                 "pass data_dir, not dataset=")
        if args.textual_inversion:
            if args.full_finetune or args.train_text_encoder:
                raise ValueError(
                    "textual_inversion trains ONLY the new embedding rows; set "
                    "full_finetune=False and train_text_encoder=False")
            if not args.ti_initializer_token:
                raise ValueError("textual_inversion needs ti_initializer_token")
            if args.ti_templates not in ("object", "style"):
                raise ValueError("ti_templates must be 'object' or 'style'")
        elif args.full_finetune and args.train_text_encoder:
            raise ValueError(
                "full_finetune trains the UNet only (the upstream train_text_to_image never "
                "trains text towers); set train_text_encoder=False")
        if args.use_ema and not args.full_finetune:
            raise ValueError("use_ema is a full_finetune option")

    def _init_ti(self) -> Dict[str, torch.Tensor]:
        """Textual inversion's setup (:200-256): the placeholder's rows,
        each a copy of the initializer token's row, appended to the
        tower(s) with the trigger registered (SDXL: the {clip_l, clip_g}
        payload); returns the fp32 trainable rows."""
        args, model = self.args, self.model
        V = int(args.ti_num_vectors)

        def init_rows(tokenizer, encoder):
            table = encoder.text_model.embeddings.token_embedding.weight
            init_ids = np.asarray(tokenizer([args.ti_initializer_token]))[0]
            if int(init_ids[2]) != tokenizer.eos_token_id:
                raise ValueError(f"ti_initializer_token {args.ti_initializer_token!r} must "
                                 "encode to a single token")
            row = table[int(init_ids[1])].detach().float().cpu().numpy()  # 0 is BOS
            return table.shape[0], np.tile(row[None, :], (V, 1))

        n1, rows = init_rows(model.tokenizer, model.text_encoder)
        self._ti_rows = {"text_encoder": tuple(range(n1, n1 + V))}
        if model.is_sdxl:
            n2, rows_2 = init_rows(model.tokenizer_2, model.text_encoder_2)
            model.load_textual_inversion({"clip_l": rows, "clip_g": rows_2},
                                         token=args.textual_inversion)
            self._ti_rows["text_encoder_2"] = tuple(range(n2, n2 + V))
        else:
            model.load_textual_inversion({args.textual_inversion: rows},
                                         token=args.textual_inversion)
        self._ti_templates = (OBJECT_TEMPLATES if args.ti_templates == "object"
                              else STYLE_TEMPLATES)
        self._ti_rng = np.random.default_rng(args.seed)
        trainable = {"embeddings": torch.tensor(rows, device=model.device)}
        if model.is_sdxl:
            trainable["embeddings_2"] = torch.tensor(rows_2, device=model.device)
        return trainable

    def train(self):
        """Run the training; returns the trainable tree at its end (LoRA
        factors, the fp32 UNet masters or their EMA, or the TI rows)."""
        args = self.args
        model = self.model
        device = model.device
        if args.with_prior_preservation:
            self._ensure_class_images()
        generator = torch.Generator(device=device).manual_seed(args.seed)
        dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
        full = args.full_finetune
        if args.textual_inversion:
            trainable, ckpt_key, loss = self._init_ti(), "ti", ti_loss_fn
        elif full:
            # fp32 masters over the whole UNet
            trainable = {n: p.detach().float().clone() for n, p in model.unet.named_parameters()}
            ckpt_key, loss = "unet", full_finetune_loss_fn
        else:
            trainable, ckpt_key, loss = self._init_trainable(generator), "lora", loss_fn

        if args.with_prior_preservation:
            dataset = DreamBoothDataset(
                self.data_dir, args.instance_prompt, args.class_data_dir, args.class_prompt,
                resolution=args.resolution, random_flip=args.random_flip,
                center_crop=args.center_crop, seed=args.seed)
        else:
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
        plan = self.plan
        optimizer = plan.optimizer(make_optimizer(
            schedule, args.adam_beta1, args.adam_beta2, args.adam_epsilon,
            args.adam_weight_decay, args.max_grad_norm, args.gradient_accumulation_steps,
            use_8bit=args.use_8bit_adam, accum_dtype=args.accum_dtype,
        ))
        opt_state = optimizer.init(trainable)

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
            ti_rows=self._ti_rows["text_encoder"] if args.textual_inversion else None,
            ti_rows_2=(self._ti_rows["text_encoder_2"]
                       if args.textual_inversion and model.is_sdxl else None),
            prior_loss_weight=(float(args.prior_loss_weight)
                               if args.with_prior_preservation else None),
        )
        step_fn = make_train_step(statics, scheduler, optimizer, loss=loss, mesh=plan.mesh,
                                  shard_params=args.shard_params)
        ema = None
        if args.use_ema:  # starts at the initial weights
            ema = plan.split({n: t.clone() for n, t in trainable.items()})
        trainable = plan.split(trainable)
        encode_fn = None
        if args.cache_latents:
            if args.train_text_encoder:
                raise ValueError("--cache_latents requires train_text_encoder=False")
            encode_fn = make_encode_fn(statics)

        frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
        if model.is_sdxl:
            frozen["text_encoder_2"] = model.text_encoder_2
        modules = list(frozen.values())
        plan.split_modules(modules)

        run = {ckpt_key: trainable, "opt_state": opt_state}
        if ema is not None:
            run["ema"] = ema

        def state():
            st = {**run, "rng": generator.get_state()}
            if args.textual_inversion:
                st["ti_rng"] = self._ti_rng.bit_generator.state
            return st

        def load(st):
            run.update({k: st[k] for k in run})
            generator.set_state(st["rng"].cpu())
            if args.textual_inversion:
                self._ti_rng.bit_generator.state = st["ti_rng"]

        def step_once(step, batch):
            tb = self._prepare_batch(batch)
            with trace("train_step", self.metrics):
                return _step(step, tb)

        def _step(step, tb):
            draws = self.draws(step) if self.draws is not None else None
            if encode_fn is not None:
                with plan.gathered(modules):
                    tb = encode_fn(frozen, tb, generator, mesh_draws(draws, plan.mesh))
            run[ckpt_key], run["opt_state"], metrics = step_fn(
                run[ckpt_key], run["opt_state"], frozen, tb, generator, draws=draws)
            # the EMA follows optimizer updates, not data steps: under
            # accumulation the weights move on every k-th call only
            if "ema" in run and (step + 1) % args.gradient_accumulation_steps == 0:
                names = list(run["ema"])
                torch._foreach_lerp_([run["ema"][n] for n in names],
                                     [run[ckpt_key][n] for n in names],
                                     1.0 - float(args.ema_decay))
            return metrics

        def logged(step, loss_val, batch, s_per_it):
            lr = float(schedule(step))
            logger.info("step %d/%d loss %.5f lr %.2e %.2f s/it", step, total_steps, loss_val,
                        lr, s_per_it)
            if self.metrics is not None:
                self.metrics.observe("train/loss", loss_val, step=step)
                self.metrics.observe("train/lr", lr, step=step)
                if args.debug_loss:
                    for fname in batch.get("filenames") or []:
                        self.metrics.observe(f"loss_for_{fname}", loss_val, step=step)

        def after(step):
            if (args.validation_prompt
                    and step % (steps_per_epoch * args.validation_epochs) == 0):
                epoch = step // steps_per_epoch
                current = plan.whole(run[ckpt_key])
                with plan.gathered(modules):
                    if not plan.main:
                        return
                    if args.textual_inversion:
                        self._set_ti_rows(current)
                        self._log_validation_full(None, epoch, step)
                    elif full:
                        self._log_validation_full(current, epoch, step)
                    else:
                        self._log_validation(current, epoch, step)

        self.history = train_loop(args, dataset, total_steps, state, load, step_once, logged,
                                  after, plan)
        plan.unsplit_modules(modules)
        trainable = plan.whole(run[ckpt_key])
        ema = plan.whole(run["ema"]) if "ema" in run else None
        self.lora = trainable
        if self.metrics is not None:
            self.metrics.flush()
        if not plan.main:
            return trainable
        os.makedirs(args.output_dir, exist_ok=True)
        if args.textual_inversion:
            # the rows into the live towers (the trigger is registered) and
            # the diffusers learned_embeds file load_textual_inversion reads
            from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

            self._set_ti_rows(trainable)
            rows = trainable["embeddings"].detach().float().cpu().numpy()
            payload = {args.textual_inversion: rows}
            if model.is_sdxl:
                payload = {"clip_l": rows,
                           "clip_g": trainable["embeddings_2"].detach().float().cpu().numpy()}
            save_safetensors(payload, f"{args.output_dir}/learned_embeds.safetensors")
            return trainable
        if full:
            # the trained (or EMA) fp32 weights become the model's UNet,
            # then the whole diffusers folder (train_text_to_image ships the
            # EMA)
            from stablediffusion_tpu_torch.io.loader import save_sd_model

            final = ema if ema is not None else trainable
            model.install_unet(final)
            save_sd_model(model, args.output_dir)
            return final
        save_lora_file(
            trainable,
            f"{args.output_dir}/pytorch_lora_weights.safetensors",
            metadata={"format": "pt", "rank": str(args.rank)},
            format=args.lora_format,
        )
        return trainable

    def _write_unet(self, weights: Mapping[str, torch.Tensor]) -> None:
        """Copy {name: tensor} into the model's UNet, in its dtype."""
        params = dict(self.model.unet.named_parameters())
        with torch.no_grad():
            for n, t in weights.items():
                params[n].copy_(t)

    def _ensure_class_images(self) -> None:
        """Top class_data_dir up to num_class_images with the model's own
        renders of class_prompt, through the port's pipeline on the model's
        device (the diffusers train_dreambooth pre-generation loop)."""
        from PIL import Image

        from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

        args = self.args
        os.makedirs(args.class_data_dir, exist_ok=True)
        exts = (".jpg", ".jpeg", ".png", ".webp")
        have = [f for f in os.listdir(args.class_data_dir) if f.lower().endswith(exts)]
        missing = int(args.num_class_images) - len(have)
        if missing <= 0:
            return
        logger.info("generating %d class images for %r", missing, args.class_prompt)
        pipe = StableDiffusionUnifiedPipeline(device=self.model.device)
        done = 0
        while done < missing:
            n = min(int(args.sample_batch_size), missing - done)
            out = pipe(self.model, prompt=args.class_prompt, num_images_per_prompt=n,
                       num_inference_steps=25, seed=args.seed + 7919 + done)
            for im in np.asarray(out.images):
                arr = (np.clip(im, 0.0, 1.0) * 255).astype(np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(args.class_data_dir, f"class-{len(have) + done}.jpg"))
                done += 1

    def _set_ti_rows(self, ti: Mapping[str, torch.Tensor]) -> None:
        """Write the trained rows into the live towers' tables, so that the
        registered trigger renders with them."""
        towers = {"text_encoder": (self.model.text_encoder, "embeddings"),
                  "text_encoder_2": (self.model.text_encoder_2, "embeddings_2")}
        with torch.no_grad():
            for comp, rows_idx in self._ti_rows.items():
                encoder, key = towers[comp]
                table = encoder.get_parameter(TOKEN_TABLE)
                table[torch.as_tensor(rows_idx, device=table.device)] = ti[key].to(table)

    def _log_validation_full(self, unet_weights, epoch: int, step: int) -> None:
        """The validation render of full fine-tuning and textual inversion
        (:677-703): `unet_weights` (the masters; None: the model's own)
        copied into the live UNet for the render, its weights copied back
        after."""
        prev = None
        if unet_weights is not None:
            prev = {n: p.detach().clone() for n, p in self.model.unet.named_parameters()}
            self._write_unet(unet_weights)
        try:
            self._render_validation(epoch, step)
        finally:
            if prev is not None:
                self._write_unet(prev)

    def _render_validation(self, epoch: int, step: int) -> None:
        from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

        args, model = self.args, self.model
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

    def _log_validation(self, lora, epoch: int, step: int) -> None:
        """Render the validation images at a fixed seed with the current
        factors fused in, log them, and take the adapter out again: the
        model's weights come back bit for bit (``delete_adapters``)."""
        model = self.model
        model.load_lora_weights("__validation__", lora)
        try:
            model.set_adapters({"__validation__": 1.0})
            self._render_validation(epoch, step)
        finally:
            model.delete_adapters()

    def _prepare_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The collated numpy batch as tensors on the model's device, with
        the captions tokenized: the instance prompt in place of the
        folder's without prior preservation, a template around the
        placeholder under textual inversion; tower 2 from the dataset's
        captions, as in JAX."""
        args, model = self.args, self.model
        device = model.device
        captions = batch["captions"]
        if args.instance_prompt and not args.with_prior_preservation:
            captions = [args.instance_prompt] * len(captions)
        if args.textual_inversion:
            captions = [self._ti_rng.choice(self._ti_templates).format(args.textual_inversion)
                        for _ in captions]
        tb = {
            "pixel_values": torch.from_numpy(batch["pixel_values"]).to(device),
            "input_ids": torch.from_numpy(model.tokenizer(captions)).long().to(device),
        }
        if model.is_sdxl:
            tb["input_ids_2"] = torch.from_numpy(
                model.tokenizer_2(batch["captions"])).long().to(device)
            for k in ("original_sizes", "crop_top_lefts", "target_sizes"):
                tb[k] = torch.from_numpy(batch[k]).to(device)
        return tb
