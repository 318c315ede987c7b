"""Streaming attention for wide heads: the CUDA kernel ``csrc/flash_stream.cu``
and its plain PyTorch version.

Port of ``stablediffusion_tpu/ops/flash_attention.py`` (the package's own
Pallas kernel, ``flash_attention_streaming``).  Same function: online-softmax
attention, fp32 running max / denominator / accumulator, keys past the
sequence masked out, forward only, no mask argument.  It serves the VAE
mid-block's single 512-wide head (``ops/attention.py`` routes every D > 160
here), in the decode and, under ``torch.no_grad()``, in the training step's
encode.  It has no backward, as its Pallas original has none: on CUDA under
grad it raises rather than return an output without a ``grad_fn``.  At
D <= 512 the kernel runs both products on the tensor cores in 3xTF32 (each
fp32 operand split into two TF32 parts, three products summed), which holds
fp32's accuracy; ``utils/testing.attention_tf32x3_emulated`` emulates
that split and its products in plain PyTorch, not the kernel's order of
accumulation.

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
    gradient is needed.  The kernel computes in fp32: bf16 q, k, v are
    widened (exactly) and the result is rounded back to bf16.  At D <= 512,
    where it reads them through TMA maps, a view no map can read is copied
    first; the others are read by stride."""
    if q.device.type == "cpu":
        return flash_stream_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_stream under grad: the kernel is forward only and has no "
            "backward; run it under torch.no_grad()"
        )
    given = q, k
    if all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        q, k, v = (t.float() for t in (q, k, v))
    if q.shape[-1] <= _build.STREAM_TMA_MAX_D:
        # a view no TMA map or 16-byte row load can read (a stride-0 expand)
        # is copied, as ops/attention.dout_for_kernels copies dO
        q, k, v = (t if _build.vector_loadable(t) and _build.tma_mappable(t)
                   else t.contiguous() for t in (q, k, v))
    out, args = _build.attention_launch_args("flash_stream", q, k, v, 168, 1024)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.entry("flash_stream")
    with torch.cuda.device(q.device):
        err = fn(*args, float(scale), stream)
    _build.check("flash_stream", err)
    FLASH_STREAM_LAUNCHES.add(*given)
    return out.to(given[0].dtype)
