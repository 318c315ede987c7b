"""Random-weight models for smoke runs and benches.

Port of ``stablediffusion_tpu/utils/testing.py:17-55,78-134``
(``random_params_like`` / ``random_model_params``, ``bench_tokenizer``,
``random_full_model``), a random training batch as
``benchmarks/bench_train.py`` builds it, and the error rules that hold a CUDA
kernel against its plain version.  The values follow ``random_params_like`` — 1-D
parameters (norm scales, biases) are ones, the rest normal with std
min(0.02, fan_in**-0.5) — but are drawn by a ``torch.Generator`` on the
target device, so the two packages' weights differ.  Modules are built on the
meta device and materialised on the target device, so a full-width model
costs no host time.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import (
    SD15_TEXT_ENCODER,
    SD15_UNET,
    SD15_VAE,
    CLIPTextConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
    default_dtype,
    resolve_device,
)
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer

# Limit of an attention kernel's output against its plain version evaluated in
# fp32 on the same input values, per element: |out - ref| <= rtol*|ref| + atol.
# Both kernels load bf16 inputs into fp32 and compute in fp32 (probabilities
# included), so the two differ by the order of the fp32 sums and, in bf16, by
# the kernel's one rounding of its output.
KERNEL_TOL = {
    torch.float32: (0.0, 1e-5, "fp32 in, fp32 accumulation on both sides: only "
                    "the order of the sums differs (about 3e-6 at the main-path "
                    "shapes on an H100)"),
    torch.bfloat16: (2.0**-8, 1e-5, "the kernel rounds its fp32 result once to "
                     "bf16: at most half a bf16 ulp, 2**-8 |ref|, plus the fp32 "
                     "order-of-sums noise"),
}


def kernel_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far a kernel's `out` lies from `ref`, the plain version evaluated
    in fp32 on the same inputs, under :data:`KERNEL_TOL` for out's dtype.
    ``worst_over_limit`` <= 1 means every element is within its limit;
    ``typical_abs_ref`` is the mean |ref|, the scale the limit applies to."""
    rtol, atol, reason = KERNEL_TOL[out.dtype]
    ref = ref.float()
    diff = (out.float() - ref).abs()
    limit = ref.abs() * rtol + atol
    return {
        "max_abs_err": diff.max().item(),
        "worst_over_limit": (diff / limit).max().item(),
        "typical_abs_ref": ref.abs().mean().item(),
        "rtol": rtol, "atol": atol, "tol_reason": reason,
    }


# Limit of the backward kernels' gradients (dq, dk, dv) against the plain
# backward (ops/attention.flash_bwd_plain) evaluated in fp32 on the same
# inputs, the same lse and the same forward output, per element:
#   |out - ref| <= rtol*|ref| + atol_rel * max|ref|.
# Both sides compute in fp32, so in fp32 they differ only by the order of
# the sums, and in bf16 also by the kernel's one rounding of each gradient
# (half a bf16 ulp, 2**-8 |ref|).  A gradient element is a sum over up to
# 4096 query rows (dk, dv) or keys (dq) of terms of both signs, each itself
# a product of sums over D: its sum-order noise scales with the size of the
# terms, not with the (possibly cancelled) result, so the absolute part is
# tied to the tensor's scale.  An fp32 sum of N such terms carries about
# sqrt(N) * 6e-8 of relative noise, ~4e-6 at N = 4096; 2e-5 of the tensor's
# max |ref| leaves room for that and stays far below a typical |ref| (a
# dropped term of the backward, such as di, moves elements by O(max|ref|)).
GRAD_TOL = {
    torch.float32: (0.0, 2e-5, "fp32 in and out, fp32 inside on both sides: "
                    "the order of sums over up to 4096 terms differs, noise "
                    "~sqrt(N)*6e-8 of the terms' scale"),
    torch.bfloat16: (2.0**-8, 2e-5, "the kernel rounds each fp32 gradient "
                     "once to bf16 (at most 2**-8 |ref|), plus the fp32 "
                     "order-of-sums noise"),
}


def grad_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far a backward kernel's gradient `out` lies from `ref`, the plain
    backward evaluated in fp32 on the same inputs, under :data:`GRAD_TOL`
    for out's dtype; ``worst_over_limit`` <= 1 means every element is within
    its limit."""
    rtol, atol_rel, reason = GRAD_TOL[out.dtype]
    ref = ref.float()
    diff = (out.float() - ref).abs()
    atol = atol_rel * ref.abs().max().item()
    limit = ref.abs() * rtol + atol
    return {
        "max_abs_err": diff.max().item(),
        "worst_over_limit": (diff / limit).max().item(),
        "typical_abs_ref": ref.abs().mean().item(),
        "atol": atol, "rtol": rtol, "tol_reason": reason,
    }


def random_module(cls, config, device: torch.device, dtype: torch.dtype,
                  generator: torch.Generator) -> nn.Module:
    """`cls(config)` on `device` with random weights drawn from `generator`."""
    with torch.device("meta"):
        module = cls(config)
    module = module.to_empty(device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
                continue
            if p.dim() == 2:  # embedding tables are (vocab, dim), linears (out, in)
                fan_in = p.shape[0] if name.endswith("embedding.weight") else p.shape[1]
            else:  # OIHW conv kernel
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            std = min(0.02, fan_in**-0.5)
            p.normal_(0.0, std, generator=generator)
    return module.to(dtype).eval().requires_grad_(False)


def bench_tokenizer(pad_token_id: Optional[int] = None) -> CLIPTokenizer:
    """Char-level CLIPTokenizer with the real special ids (bos 49406, eos
    49407), so full-size text encoders pool at the true EOS position."""
    chars = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-"
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    return CLIPTokenizer(vocab, [], pad_token_id=pad_token_id)


def random_model(
    unet_config: UNetConfig,
    vae_config: VAEConfig,
    text_encoder_config: CLIPTextConfig,
    tokenizer,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
) -> SDModel:
    """An SDModel of the given configs with random weights from `seed`, on
    `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``).  The UNet and VAE are held in `dtype` (default: the
    device's compute dtype), the text encoder in fp32, as
    ``random_model_params`` holds them."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    g = torch.Generator(device=device).manual_seed(seed)
    return SDModel(
        unet_config=unet_config,
        unet=random_module(UNet2DConditionModel, unet_config, device, dtype, g),
        vae_config=vae_config,
        vae=random_module(AutoencoderKL, vae_config, device, dtype, g),
        text_encoder_config=text_encoder_config,
        text_encoder=random_module(
            CLIPTextModel, text_encoder_config, device, torch.float32, g
        ),
        tokenizer=tokenizer,
        scheduler_config=SchedulerConfig(),
        scheduler_name="DDIM",
    )


def random_full_model(
    name: str = "sd15",
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
) -> SDModel:
    """Full-width SD1.5 SDModel with random weights: the same FLOPs and
    memory traffic as the real checkpoint, which the repository does not
    hold."""
    if name != "sd15":
        raise NotImplementedError(
            f"model {name!r}: SDXL comes with slice 2 and SD3 with slice 4"
        )
    return random_model(
        SD15_UNET, SD15_VAE, SD15_TEXT_ENCODER, bench_tokenizer(),
        device=device, dtype=dtype, seed=seed,
    )


def random_train_batch(B: int, res: int, generator: torch.Generator) -> dict:
    """A training batch as ``benchmarks/bench_train.py:62-68`` builds it, on
    `generator`'s device: "pixel_values" NHWC [B, res, res, 3] fp32, normal
    with std 0.5, and "input_ids" [B, 77] uniform in [0, 49407)."""
    device = generator.device
    return {
        "pixel_values": torch.randn(B, res, res, 3, generator=generator,
                                    device=device) * 0.5,
        "input_ids": torch.randint(0, 49407, (B, 77), generator=generator,
                                   device=device),
    }
