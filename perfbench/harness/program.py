"""The system under test: the PyTorch/CUDA port, built from the benchmark's
state dicts through its own config parsers, module classes and strict
``load_state_dict``.  This is the only harness module that imports the
program."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch

from perfbench.reference.pipeline import CHARS

# transformers' CLIP configs publish eos_token_id 2, under which transformers
# pools at the row of the largest token id: CLIP's end token, 49407.  The
# port pools at the id its config names, so it is given the end token itself.
CLIP_END_TOKEN = 49407


def tokenizer(pad_token_id: int):
    """The benchmark's character vocabulary as the port's CLIP tokenizer."""
    from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer

    vocab = {c: i for i, c in enumerate(CHARS)}
    vocab.update({c + "</w>": len(CHARS) + i for i, c in enumerate(CHARS)})
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = CLIP_END_TOKEN
    return CLIPTokenizer(vocab, [], pad_token_id=pad_token_id)


def _module(cls, config, state: Dict[str, torch.Tensor]):
    with torch.device("meta"):
        module = cls(config)
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def build_model(spec: dict, weights: Dict[str, Dict[str, torch.Tensor]], device):
    """An SDModel of the configuration file `spec` holding `weights`."""
    from stablediffusion_tpu_torch.core.config import (CLIPTextConfig, SchedulerConfig, UNetConfig,
                                                       VAEConfig)
    from stablediffusion_tpu_torch.models.clip import CLIPTextModel
    from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
    from stablediffusion_tpu_torch.models.vae import AutoencoderKL
    from stablediffusion_tpu_torch.models.wrapper import SDModel

    comps = spec["components"]

    def clip_cfg(name):
        return dataclasses.replace(CLIPTextConfig.from_diffusers_dict(comps[name]),
                                   eos_token_id=CLIP_END_TOKEN)

    pads = spec["tokenizer_pad_ids"]
    extra = {}
    if "text_encoder_2" in comps:
        cfg2 = clip_cfg("text_encoder_2")
        extra = dict(text_encoder_2_config=cfg2,
                     text_encoder_2=_module(CLIPTextModel, cfg2, weights["text_encoder_2"]),
                     tokenizer_2=tokenizer(pads["text_encoder_2"]))
    ucfg, vcfg, tcfg = (UNetConfig.from_diffusers_dict(comps["unet"]),
                        VAEConfig.from_diffusers_dict(comps["vae"]), clip_cfg("text_encoder"))
    model = SDModel(
        unet_config=ucfg, unet=_module(UNet2DConditionModel, ucfg, weights["unet"]),
        vae_config=vcfg, vae=_module(AutoencoderKL, vcfg, weights["vae"]),
        text_encoder_config=tcfg, text_encoder=_module(CLIPTextModel, tcfg, weights["text_encoder"]),
        tokenizer=tokenizer(pads["text_encoder"]),
        scheduler_config=SchedulerConfig.from_diffusers_dict(comps["scheduler"]),
        scheduler_name=spec["scheduler_name"],
        model_type="sdxl" if "text_encoder_2" in comps else "sd15", **extra)
    if model.device.type != torch.device(device).type:
        raise RuntimeError(f"model on {model.device}, wanted {device}")
    return model


def serving(model, max_batch: int, window_ms: float, adaptive: bool):
    """(handler, batcher) as the HTTP worker builds them, without HTTP."""
    from stablediffusion_tpu_torch.serve.batcher import Batcher
    from stablediffusion_tpu_torch.serve.handler import Handler

    handler = Handler(model=model)
    handler.uploader = None  # replies carry base64 JPEGs, whatever the environment says
    handler.expected_batch = max_batch
    return handler, Batcher(handler, max_batch=max_batch, window_ms=window_ms, adaptive=adaptive)


def folder_dataset(data_dir: str, args: dict):
    """The trainer's folder dataset (jpg + txt) as ``train()`` builds it."""
    from stablediffusion_tpu_torch.train.dataset import SDLoRADataset
    from stablediffusion_tpu_torch.train.trainer import SDTrainingArgs

    a = SDTrainingArgs(**args)
    return SDLoRADataset(data_dir, resolution=a.resolution, random_flip=a.random_flip,
                         center_crop=a.center_crop, seed=a.seed)


def lora_trainer(model, args: dict, dataset):
    """``SDLoRATrainer`` over `dataset` (any object with the folder
    dataset's batch interface); its ``train()`` is what a run drives."""
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs

    return SDLoRATrainer(model, SDTrainingArgs(**args), dataset=dataset)


@contextlib.contextmanager
def watched_steps(count: int, seen):
    """While open, the step that ``SDLoRATrainer.train()`` builds hands its
    first `count` calls to ``seen(i, trainable, opt_state, metrics)``: i = -1
    before the first with the initial state, then 0, 1, ... after each.
    Later calls pass straight through."""
    from stablediffusion_tpu_torch.train import trainer as trainer_mod

    inner = trainer_mod.make_train_step

    def make(*a, **k):
        step = inner(*a, **k)
        calls = [0]

        def watched(trainable, opt_state, frozen, batch, generator, draws=None):
            i = calls[0]
            if i >= count:
                return step(trainable, opt_state, frozen, batch, generator, draws=draws)
            if i == 0:
                seen(-1, trainable, opt_state, None)
            out = step(trainable, opt_state, frozen, batch, generator, draws=draws)
            calls[0] += 1
            seen(i, *out)
            return out

        return watched

    trainer_mod.make_train_step = make
    try:
        yield
    finally:
        trainer_mod.make_train_step = inner
