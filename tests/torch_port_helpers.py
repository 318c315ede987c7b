"""Tiny models for the port's CPU tests, built without JAX's slow
initialisation: random torch weights in the port's modules, carried to the
JAX package's param trees through its own ``io/torch_convert.py`` (the port
stores the torch layouts that diffusers files hold)."""

import numpy as np
import pytest
import torch

from helpers import tiny_tokenizer
from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.io.torch_convert import convert_state_dict
from stablediffusion_tpu.models.wrapper import SDModel as JSDModel
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer


def _init(module: torch.nn.Module, g: torch.Generator) -> torch.nn.Module:
    """The JAX package's scales (``models/unet.py:312``: linears at std
    fan_in^-0.5, convolutions at 0.3 of it), with norm scales 1 + N(0, 0.02)
    and biases N(0, 0.02) in place of its constants."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.02, generator=g)
                if name.endswith("weight"):
                    p.add_(1.0)
            else:
                fan_in = p.shape[0] if name.endswith("embedding.weight") else p[0].numel()
                p.normal_(0.0, (0.3 if p.dim() == 4 else 1.0) * fan_in**-0.5, generator=g)
    return module.eval().requires_grad_(False)


def port_tokenizer() -> CLIPTokenizer:
    tok = tiny_tokenizer()
    merges = [m for m, _ in sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])]
    return CLIPTokenizer(dict(tok.vocab), merges)


def tiny_port_model(in_channels: int = 4, seed: int = 0) -> SDModel:
    """A tiny SD1.5-layout port model on the CPU, fp32."""
    g = torch.Generator().manual_seed(seed)
    uc = tcfg.tiny_unet_config(in_channels=in_channels)
    vc, cc = tcfg.tiny_vae_config(), tcfg.tiny_clip_config()
    return SDModel(
        unet_config=uc, unet=_init(UNet2DConditionModel(uc), g),
        vae_config=vc, vae=_init(AutoencoderKL(vc), g),
        text_encoder_config=cc, text_encoder=_init(CLIPTextModel(cc), g),
        tokenizer=port_tokenizer(),
    )


def to_jax_model(model: SDModel) -> JSDModel:
    """The same weights as a JAX SDModel."""
    tree = lambda m: convert_state_dict(  # noqa: E731
        {k: np.asarray(v) for k, v in m.state_dict().items()})
    return JSDModel(
        model_type="sd15",
        unet_config=jcfg.tiny_unet_config(in_channels=model.unet_config.in_channels),
        unet_params=tree(model.unet), vae_config=jcfg.tiny_vae_config(),
        vae_params=tree(model.vae), text_encoder_config=jcfg.tiny_clip_config(),
        text_encoder_params=tree(model.text_encoder), tokenizer=tiny_tokenizer(),
    )


@pytest.fixture(scope="module", autouse=True)
def torch_single_thread():
    """One torch CPU thread for the module's tests: the tiny models' ops are
    too small to share out, and with several test workers on one machine
    each worker's full thread pool would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
