"""Standalone training CLI: the train_text_to_image(_lora)(_sdxl) analog.

Port of ``stablediffusion_tpu/train/cli.py`` (:24-378) with the same flags
and defaults: a diffusers-layout folder loaded by ``io/loader.load_sd_model``
(on ``--device``, the card by default), a folder of images with captions (or
a ``datasets`` dataset), ``train/trainer.SDLoRATrainer`` (LoRA,
``--full_finetune`` with ``--use_ema``, ``--train_textual_inversion``,
DreamBooth's ``--instance_prompt`` and ``--with_prior_preservation``), the
model card (``train/model_card.save_model_card``, :315-330) and, with
``--push_to_hub``, its upload (skipped with a warning where it cannot be
made), then, with a ``--validation_prompt``, the validation render into
``{output_dir}/validation/{i}.png`` (:337-365): of the saved adapter, or,
after full fine-tuning or textual inversion, of the trained model itself
(the JAX CLI loads a LoRA file there that those modes do not write).

Under ``torchrun`` (one process per GPU; ``--local_rank`` is read from its
environment) the process group comes up from the environment
(``parallel/mesh.maybe_initialize_distributed``) and the ranks form a data
mesh over gcd(batch, world) of them, as JAX's CLI takes gcd(batch, device
count) devices (a batch that does not divide runs whole on every rank);
``--shard_opt_state`` (ZeRO-1) and ``--shard_params`` (FSDP) split the
state over it.  The kernels build into the persistent cache
(``core/compile_cache``).  ControlNet training has a CLI of its own,
``train/controlnet_cli.py``, as in JAX.

Usage:
    python -m stablediffusion_tpu_torch.train.cli --pretrained_model_name_or_path
        /path/to/diffusers-layout --train_data_dir /path/to/imgs --rank 16 ...
    torchrun --nproc_per_node 2 -m stablediffusion_tpu_torch.train.cli ... --shard_opt_state
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

logger = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="LoRA fine-tuning on the H100 (PyTorch/CUDA port)")
    # model / data
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True,
                   help="diffusers-layout checkpoint folder")
    p.add_argument("--model_type", type=str, default=None,
                   choices=[None, "sd15", "sdxl"],
                   help="override auto-detection")
    p.add_argument("--pretrained_vae_model_name_or_path", type=str, default=None,
                   help="separate VAE folder (e.g. the sdxl fp16-fix VAE); "
                        "the VAE encodes in fp32, so this only swaps weights")
    p.add_argument("--train_data_dir", type=str, default=None,
                   help="folder of images (jpg+txt captions, or an "
                        "imagefolder with metadata.jsonl)")
    # HF `datasets` pipeline (ref: train_text_to_image_lora.py:594-709)
    p.add_argument("--dataset_name", type=str, default=None,
                   help="hub dataset name or local dataset dir for "
                        "datasets.load_dataset")
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--image_column", type=str, default=None)
    p.add_argument("--caption_column", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="lora-out")
    # image pipeline
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--aspect_ratio_bucketing", action="store_true",
                   help="kohya-style buckets: train non-square images at "
                        "their native aspect")
    p.add_argument("--bucket_step", type=int, default=64)
    p.add_argument("--max_bucket_ar", type=float, default=2.0)
    p.add_argument("--max_buckets", type=int, default=None,
                   help="cap OCCUPIED bucket shapes; the smallest buckets "
                        "merge into the nearest aspect ratio")
    # optimization
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--accum_dtype", choices=["fp32", "bf16"], default="fp32",
                   help="gradient-accumulator precision; bf16 halves the "
                        "accumulator tree")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--remat_policy", type=str, default="",
                   choices=["", "none", "full", "dots", "offload"],
                   help="UNet backward remat policy, each resnet and transformer "
                        "block one region (full recomputes it, dots keeps its 2-D "
                        "matrix products, offload keeps them in pinned host memory)")
    # encode VAE latents + text embeds apart from the gradient step
    # (diffusers --cache_latents)
    p.add_argument("--cache_latents", action="store_true")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--lora_format", choices=("peft", "kohya"), default="peft",
                   help="saved adapter convention: diffusers/peft or A1111/kohya-ss")
    p.add_argument("--train_text_encoder", action="store_true")
    # full-model fine-tuning (train_text_to_image analog; UNet only)
    p.add_argument("--instance_prompt", type=str, default=None,
                   help="DreamBooth: fixed caption for the training images "
                        "(e.g. 'a photo of sks dog'); overrides folder "
                        "captions")
    p.add_argument("--with_prior_preservation", action="store_true",
                   help="DreamBooth prior preservation: pair batches with "
                        "class images and add prior_loss_weight * class MSE")
    p.add_argument("--class_data_dir", type=str, default=None)
    p.add_argument("--class_prompt", type=str, default=None)
    p.add_argument("--num_class_images", type=int, default=50)
    p.add_argument("--prior_loss_weight", type=float, default=1.0)
    p.add_argument("--sample_batch_size", type=int, default=4)
    p.add_argument("--train_textual_inversion", type=str, default=None,
                   metavar="PLACEHOLDER",
                   help="textual-inversion training: learn embedding rows "
                        "for this placeholder token (e.g. '<my-concept>'); "
                        "UNet/text towers stay frozen")
    p.add_argument("--ti_initializer_token", type=str, default=None,
                   help="single existing token that seeds the new rows")
    p.add_argument("--ti_num_vectors", type=int, default=1)
    p.add_argument("--ti_templates", choices=("object", "style"),
                   default="object")
    p.add_argument("--full_finetune", action="store_true",
                   help="train the whole UNet instead of LoRA factors; "
                        "saves a full diffusers-layout model")
    p.add_argument("--use_ema", action="store_true",
                   help="EMA of the UNet weights (full_finetune only); the "
                        "EMA is what gets saved")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--shard_opt_state", action="store_true",
                   help="ZeRO-1: split the Adam moments over the data ranks")
    p.add_argument("--shard_params", action="store_true",
                   help="FSDP: split the trainable and frozen weights and the Adam moments "
                        "over the data ranks; the UNet is gathered one block at a time, "
                        "each block recomputed in the backward")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"])
    # checkpointing
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    # misc
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--validation_prompt", type=str, default=None)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--validation_epochs", type=int, default=1)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="blockwise-quantized int8/uint8 Adam moments")
    # flags of the diffusers scripts accepted as no-ops
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true", help="no-op: the port's attention kernels always run")
    p.add_argument("--allow_tf32", action="store_true", help="no-op")
    p.add_argument("--local_rank", type=int,
                   default=int(os.environ.get("LOCAL_RANK", -1)))
    p.add_argument("--debug_loss", action="store_true",
                   help="log the batch loss keyed per filename "
                        "(ref _sdxl.py:1196-1198)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model and the training run (cpu for tests)")
    args = p.parse_args(argv)
    if args.dataset_name is None and args.train_data_dir is None:
        p.error("Need either --dataset_name or --train_data_dir")
    return args




def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    import numpy as np
    import torch
    from PIL import Image

    from stablediffusion_tpu_torch.core.config import VAEConfig, resolve_device
    from stablediffusion_tpu_torch.io.loader import (
        _empty_module,
        _read_json,
        load_component_state,
        load_sd_model,
    )
    from stablediffusion_tpu_torch.lora.formats import load_lora_file
    from stablediffusion_tpu_torch.models.vae import AutoencoderKL
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.train.model_card import push_to_hub, save_model_card
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.images import to_uint8

    import math

    import torch.distributed as dist

    from stablediffusion_tpu_torch.core.compile_cache import enable_compilation_cache
    from stablediffusion_tpu_torch.parallel import make_mesh
    from stablediffusion_tpu_torch.parallel.mesh import maybe_initialize_distributed

    enable_compilation_cache()
    distributed = maybe_initialize_distributed(args.device)
    world = dist.get_world_size() if distributed else 1
    device = resolve_device(args.device)
    if distributed and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = load_sd_model(args.pretrained_model_name_or_path, model_type=args.model_type,
                          device=device)
    if args.pretrained_vae_model_name_or_path:
        # swap in a separate VAE (ref _sdxl.py:195-200), held in fp32
        vae_path = args.pretrained_vae_model_name_or_path
        if not os.path.exists(os.path.join(vae_path, "config.json")):
            vae_path = os.path.join(vae_path, "vae")
        model.vae_config = VAEConfig.from_diffusers_dict(
            _read_json(os.path.join(vae_path, "config.json")))
        model.vae = load_component_state(
            vae_path, _empty_module(AutoencoderKL, model.vae_config, device, torch.float32))
    if args.prediction_type:
        model.scheduler_config = dataclasses.replace(
            model.scheduler_config, prediction_type=args.prediction_type)
        model._scheduler = None

    lr = args.learning_rate
    if args.scale_lr:
        lr *= args.gradient_accumulation_steps * args.train_batch_size * world

    mixed = "bf16" if args.mixed_precision in ("bf16", "fp16") else "no"
    targs = SDTrainingArgs(
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        accum_dtype=args.accum_dtype,
        mixed_precision=mixed,
        rank=args.rank,
        train_text_encoder=args.train_text_encoder,
        learning_rate=lr,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_epsilon=args.adam_epsilon,
        adam_weight_decay=args.adam_weight_decay,
        num_train_epochs=args.num_train_epochs,
        max_train_steps=args.max_train_steps,
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        resolution=args.resolution,
        gradient_checkpointing=args.gradient_checkpointing,
        remat_policy=args.remat_policy,
        cache_latents=args.cache_latents,
        max_grad_norm=args.max_grad_norm,
        seed=args.seed,
        snr_gamma=args.snr_gamma,
        noise_offset=args.noise_offset,
        random_flip=args.random_flip,
        center_crop=args.center_crop,
        aspect_ratio_bucketing=args.aspect_ratio_bucketing,
        bucket_step=args.bucket_step,
        max_bucket_ar=args.max_bucket_ar,
        max_buckets=args.max_buckets,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        output_dir=args.output_dir,
        validation_prompt=args.validation_prompt,
        num_validation_images=args.num_validation_images,
        validation_epochs=args.validation_epochs,
        report_to=args.report_to,
        logging_dir=os.path.join(args.output_dir, args.logging_dir),
        debug_loss=args.debug_loss,
        use_8bit_adam=args.use_8bit_adam,
        lora_format=args.lora_format,
        full_finetune=args.full_finetune,
        use_ema=args.use_ema,
        instance_prompt=args.instance_prompt,
        with_prior_preservation=args.with_prior_preservation,
        class_data_dir=args.class_data_dir,
        class_prompt=args.class_prompt,
        num_class_images=args.num_class_images,
        prior_loss_weight=args.prior_loss_weight,
        sample_batch_size=args.sample_batch_size,
        textual_inversion=args.train_textual_inversion,
        ti_initializer_token=args.ti_initializer_token,
        ti_num_vectors=args.ti_num_vectors,
        ti_templates=args.ti_templates,
        ema_decay=args.ema_decay,
        shard_opt_state=args.shard_opt_state,
        shard_params=args.shard_params,
    )
    dataset = None
    use_hf = args.dataset_name is not None or (
        args.train_data_dir
        and os.path.exists(os.path.join(args.train_data_dir, "metadata.jsonl")))
    if use_hf:
        from stablediffusion_tpu_torch.train.dataset import HFImageCaptionDataset

        dataset = HFImageCaptionDataset(
            dataset_name=args.dataset_name,
            dataset_config_name=args.dataset_config_name,
            data_dir=args.train_data_dir,
            cache_dir=args.cache_dir,
            image_column=args.image_column,
            caption_column=args.caption_column,
            resolution=args.resolution,
            random_flip=args.random_flip,
            center_crop=args.center_crop,
            seed=args.seed,
        )
    mesh = None
    if distributed:
        n_data = math.gcd(args.train_batch_size, world)
        if n_data < world:
            logger.warning("batch %d not divisible by %d ranks: every rank trains the whole "
                           "batch", args.train_batch_size, world)
        # a mesh over every rank: n_data data groups would leave ranks out
        mesh = make_mesh(data=world) if n_data == world else None
    if mesh is None and (args.shard_opt_state or args.shard_params):
        raise ValueError("--shard_opt_state/--shard_params need a data mesh: launch under "
                         "torchrun with a batch that divides over the ranks")
    trainer = SDLoRATrainer(model, targs, args.train_data_dir, dataset=dataset, mesh=mesh)
    trainer.train()
    if distributed and dist.get_rank() != 0:
        return trainer  # rank 0 writes the card and renders

    save_model_card(
        args.output_dir,
        base_model=args.pretrained_model_name_or_path,
        prompt=args.validation_prompt,
        train_info={
            "rank": args.rank,
            "steps": trainer.history[-1][0] if trainer.history else 0,
            "resolution": args.resolution,
            "learning_rate": lr,
            "snr_gamma": args.snr_gamma,
        },
    )
    if args.push_to_hub:
        repo = args.hub_model_id or os.path.basename(os.path.abspath(args.output_dir))
        push_to_hub(args.output_dir, repo, token=args.hub_token)

    if args.validation_prompt:
        if not (args.full_finetune or args.train_textual_inversion):
            model.load_lora_weights(
                "trained",
                # the model's paths resolve kohya's underscore-flattened names
                load_lora_file(f"{args.output_dir}/pytorch_lora_weights.safetensors",
                               model.lora_module_paths()),
            )
            model.set_adapters({"trained": 1.0})
        out = StableDiffusionUnifiedPipeline(device=device)(
            model,
            prompt=args.validation_prompt,
            num_images_per_prompt=args.num_validation_images,
            num_inference_steps=25,
            seed=args.seed,
        )
        os.makedirs(f"{args.output_dir}/validation", exist_ok=True)
        for i, im in enumerate(to_uint8(np.asarray(out.images) * 2 - 1)):
            Image.fromarray(im).save(f"{args.output_dir}/validation/{i}.png")
    return trainer


if __name__ == "__main__":
    main()
