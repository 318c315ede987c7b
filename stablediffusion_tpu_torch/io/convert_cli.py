"""convert_from_A1111 CLI: a single-file LDM/A1111 checkpoint -> a
diffusers-layout folder.

Port of ``stablediffusion_tpu/io/convert_cli.py`` (:30-157), with its flags
and output: the file read by ``io/loader.read_single_file`` (a .ckpt through
``torch.load(weights_only=True)``), the port's copy of ``io/a1111.py``
renaming it, one safetensors file and config.json per component,
``scheduler/scheduler_config.json`` and ``model_index.json``;
``--extract_ema`` takes the EMA weights, ``--half`` writes the fp16
variant, ``--controlnet`` converts a ControlNet single file into a
ControlNet folder.  ``io/loader.load_sd_model`` (and the JAX package's
loader) read the result.

Usage:
    python -m stablediffusion_tpu_torch.io.convert_cli \\
        --checkpoint_path model.safetensors --save_path out/ [--extract_ema]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np


def _half(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: (v.astype(np.float16) if v.dtype == np.float32 else v) for k, v in flat.items()}


def _write_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _write(state, save_path: str, extract_ema: bool, half: bool, controlnet: bool) -> str:
    """Convert `state` and write the components; returns the model type."""
    from stablediffusion_tpu_torch.io.a1111 import convert_a1111_checkpoint
    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

    variant = ".fp16" if half else ""
    os.makedirs(save_path, exist_ok=True)
    if controlnet:
        from stablediffusion_tpu_torch.io.a1111 import (
            convert_controlnet,
            create_unet_config,
            infer_unet_params_from_state,
        )

        # the trunk's config inferred from its own shapes
        trunk = {"model.diffusion_model." + k[len("control_model."):]: v
                 for k, v in state.items()
                 if k.startswith("control_model.")
                 and not k.startswith(("control_model.input_hint_block",
                                       "control_model.zero_convs",
                                       "control_model.middle_block_out"))}
        cfg = create_unet_config(infer_unet_params_from_state(trunk))
        flat = convert_controlnet(state, cfg)
        save_safetensors(_half(flat) if half else flat, os.path.join(
            save_path, f"diffusion_pytorch_model{variant}.safetensors"))
        _write_json(cfg, os.path.join(save_path, "config.json"))
        return "controlnet"
    weights, configs = convert_a1111_checkpoint(state, extract_ema_weights=extract_ema)
    sub_fname = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model",
                 "text_encoder": "model", "text_encoder_2": "model"}
    for comp, flat in weights.items():
        d = os.path.join(save_path, comp)
        os.makedirs(d, exist_ok=True)
        save_safetensors(_half(flat) if half else flat,
                         os.path.join(d, f"{sub_fname[comp]}{variant}.safetensors"))
        if configs.get(comp):
            _write_json(configs[comp], os.path.join(d, "config.json"))
    return configs["model_type"]


def convert(
    checkpoint_path: str,
    save_path: str,
    extract_ema: bool = False,
    scheduler_type: str = "ddim",
    half: bool = False,
    controlnet: bool = False,
) -> str:
    """Convert and write the folder; returns the model type ("sd15", "sd2",
    "sdxl") or "controlnet"."""
    from stablediffusion_tpu_torch.io.loader import read_single_file

    with read_single_file(checkpoint_path) as state:
        # the arrays are views of the file's mapping: the writer drops them
        # before the block closes it
        model_type = _write(state, save_path, extract_ema, half, controlnet)
        del state
    if model_type == "controlnet":
        return model_type

    # the scheduler config (the reference builds one per --scheduler_type,
    # convert_from_A1111.py:940-1003)
    sched = {
        "num_train_timesteps": 1000,
        "beta_start": 0.00085,
        "beta_end": 0.012,
        "beta_schedule": "scaled_linear",
        "steps_offset": 1,
        "timestep_spacing": "leading",
        "prediction_type": "epsilon",
    }
    os.makedirs(os.path.join(save_path, "scheduler"), exist_ok=True)
    _write_json(sched, os.path.join(save_path, "scheduler", "scheduler_config.json"))
    _write_json({
        "_class_name": ("StableDiffusionXLPipeline" if model_type == "sdxl"
                        else "StableDiffusionPipeline"),
        "_converted_from": os.path.basename(checkpoint_path),
        "_scheduler_type": scheduler_type,
    }, os.path.join(save_path, "model_index.json"))
    return model_type


def main(argv=None):
    p = argparse.ArgumentParser(description="A1111/LDM -> diffusers layout")
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--scheduler_type", default="ddim",
                   choices=["pndm", "lms", "heun", "euler", "euler-ancestral", "dpm", "ddim"])
    p.add_argument("--extract_ema", action="store_true")
    p.add_argument("--from_safetensors", action="store_true",
                   help="accepted for parity; format is auto-detected")
    p.add_argument("--controlnet", action="store_true",
                   help="input is a ControlNet single-file checkpoint")
    p.add_argument("--half", action="store_true", help="save fp16 variant")
    args = p.parse_args(argv)
    mtype = convert(args.checkpoint_path, args.save_path, extract_ema=args.extract_ema,
                    scheduler_type=args.scheduler_type, half=args.half,
                    controlnet=args.controlnet)
    print(f"converted {mtype} checkpoint -> {args.save_path}")
    return mtype


if __name__ == "__main__":
    main()
