"""Streaming attention for wide heads: the CUDA kernel ``csrc/flash_stream.cu``
and its plain PyTorch version.

Port of ``stablediffusion_tpu/ops/flash_attention.py`` (the package's own
Pallas kernel, ``flash_attention_streaming``).  Same function: online-softmax
attention, fp32 running max / denominator / accumulator, keys past the
sequence masked out, forward only, no mask argument.  It serves the VAE
mid-block's single 512-wide head (``ops/attention.py`` routes every D > 160
here), in the decode and, under ``torch.no_grad()``, in the training step's
encode.  It has no backward, as its Pallas original has none: on CUDA under
grad it raises rather than return an output without a ``grad_fn``.

Layout: q [B, Sq, H, D], k/v [B, Skv, H, D] -> out [B, Sq, H, D].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from stablediffusion_tpu_torch.ops import _build

FLASH_STREAM_LAUNCHES = _build.LaunchCounter("flash_stream")


def flash_stream_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The same function as the kernel, in plain PyTorch: fp32 logits, fp32
    softmax, fp32 product with v, cast back to the input type (the kernel
    keeps p in fp32 where the Pallas kernel rounds it to v's type)."""
    D = q.shape[-1]
    scale = D**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def flash_stream(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v for head dims above 160.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise, also when a
    gradient is needed."""
    if q.device.type == "cpu":
        return flash_stream_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_stream under grad: the kernel is forward only and has no "
            "backward; run it under torch.no_grad()"
        )
    out, args = _build.attention_launch_args("flash_stream", q, k, v, 168, 1024)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.entry("flash_stream")
    with torch.cuda.device(q.device):
        err = fn(*args, float(scale), stream)
    _build.check("flash_stream", err)
    FLASH_STREAM_LAUNCHES.add(q, k)
    return out
