"""Standalone ControlNet training CLI (the diffusers train_controlnet.py
analog).

Port of ``stablediffusion_tpu/train/controlnet_cli.py`` with the same flags
and defaults, the CUDA-era flags (``--use_8bit_adam`` included) accepted as
no-ops as JAX accepts them: a diffusers-layout folder loaded by
``io/loader.load_sd_model`` (on ``--device``, the card by default),
``--controlnet_model_name_or_path`` to continue a diffusers-layout
ControlNet (default: initialized from the UNet), paired data (a folder of
images with ``--conditioning_data_dir`` holding the control images under
the same file names, or a ``datasets`` dataset with a conditioning column),
then ``train/controlnet_trainer.ControlNetTrainer``.  ``--scale_lr``
multiplies the rate by accumulation x batch x the world size, as JAX
multiplies by its device count.  Under ``torchrun`` the process group
comes up from its environment (``parallel/mesh.maybe_initialize_distributed``)
and the ranks form a data mesh; the kernels build into the persistent
cache (``core/compile_cache``).

Usage:
    python -m stablediffusion_tpu_torch.train.controlnet_cli \\
        --pretrained_model_name_or_path /ckpts/sd15 \\
        --train_data_dir imgs/ --conditioning_data_dir cond/ \\
        --resolution 512 --train_batch_size 4
    torchrun --nproc_per_node 2 -m stablediffusion_tpu_torch.train.controlnet_cli ...
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ControlNet training on the H100 (PyTorch/CUDA port)")
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--model_type", type=str, default=None, choices=[None, "sd15", "sdxl"])
    p.add_argument("--controlnet_model_name_or_path", type=str, default=None,
                   help="existing diffusers-layout ControlNet to continue "
                        "from; default initializes from the UNet")
    p.add_argument("--train_data_dir", type=str, default=None,
                   help="folder of images (jpg+txt captions or imagefolder)")
    p.add_argument("--conditioning_data_dir", type=str, default=None,
                   help="folder of control images matching train_data_dir "
                        "filenames (folder-pair mode)")
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--image_column", type=str, default=None)
    p.add_argument("--caption_column", type=str, default=None)
    p.add_argument("--conditioning_image_column", type=str, default="conditioning_image")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="controlnet-out")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--learning_rate", type=float, default=5e-6)
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
    p.add_argument("--mixed_precision", type=str, default="bf16", choices=["no", "fp16", "bf16"])
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--validation_prompt", type=str, default=None)
    p.add_argument("--validation_image", type=str, default=None)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--validation_steps", type=int, default=100)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--logging_dir", type=str, default="logs")
    # CUDA-era flags accepted as no-ops for launch-script compatibility
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    p.add_argument("--allow_tf32", action="store_true")
    p.add_argument("--set_grads_to_none", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model and the training run (cpu for tests)")
    args = p.parse_args(argv)
    if args.dataset_name is None and args.train_data_dir is None:
        p.error("Need either --dataset_name or --train_data_dir")
    if args.dataset_name is None and args.conditioning_data_dir is None:
        p.error("Folder mode needs --conditioning_data_dir")
    return args


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    import dataclasses

    import torch.distributed as dist

    from stablediffusion_tpu_torch.core.compile_cache import enable_compilation_cache
    from stablediffusion_tpu_torch.core.config import resolve_device
    from stablediffusion_tpu_torch.io.loader import load_sd_model
    from stablediffusion_tpu_torch.parallel import make_mesh
    from stablediffusion_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from stablediffusion_tpu_torch.train.controlnet_trainer import (
        ControlNetTrainer,
        ControlNetTrainingArgs,
    )

    enable_compilation_cache()
    distributed = maybe_initialize_distributed(args.device)
    world = dist.get_world_size() if distributed else 1

    device = resolve_device(args.device)
    if distributed and device.type == "cuda":
        import torch

        device = torch.device("cuda", torch.cuda.current_device())
    model = load_sd_model(args.pretrained_model_name_or_path, model_type=args.model_type,
                          device=device)
    if args.prediction_type:
        model.scheduler_config = dataclasses.replace(
            model.scheduler_config, prediction_type=args.prediction_type)
        model._scheduler = None

    lr = args.learning_rate
    if args.scale_lr:
        lr *= args.gradient_accumulation_steps * args.train_batch_size * world

    targs = ControlNetTrainingArgs(
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        mixed_precision="bf16" if args.mixed_precision in ("bf16", "fp16") else "no",
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
        max_grad_norm=args.max_grad_norm,
        seed=args.seed,
        snr_gamma=args.snr_gamma,
        noise_offset=args.noise_offset,
        random_flip=args.random_flip,
        center_crop=args.center_crop,
        gradient_checkpointing=args.gradient_checkpointing,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        output_dir=args.output_dir,
        report_to=args.report_to,
        logging_dir=os.path.join(args.output_dir, args.logging_dir),
        validation_prompt=args.validation_prompt,
        validation_image=args.validation_image,
        num_validation_images=args.num_validation_images,
        validation_steps=args.validation_steps,
    )
    # every rank of a torchrun launch is one data rank
    mesh = make_mesh(data=world) if distributed else None

    dataset = None
    if args.dataset_name is not None:
        from stablediffusion_tpu_torch.train.dataset import HFImageCaptionDataset

        dataset = HFImageCaptionDataset(
            dataset_name=args.dataset_name,
            dataset_config_name=args.dataset_config_name,
            data_dir=args.train_data_dir,
            cache_dir=args.cache_dir,
            image_column=args.image_column,
            caption_column=args.caption_column,
            conditioning_image_column=args.conditioning_image_column,
            resolution=args.resolution,
            random_flip=args.random_flip,
            center_crop=args.center_crop,
            seed=args.seed,
        )
    trainer = ControlNetTrainer(
        model,
        targs,
        data_dir=args.train_data_dir,
        conditioning_dir=args.conditioning_data_dir,
        controlnet_path=args.controlnet_model_name_or_path,
        mesh=mesh,
        dataset=dataset,
    )
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
