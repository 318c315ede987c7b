"""Attention: one entry point, routed by device and shape to a CUDA kernel.

Port of ``stablediffusion_tpu/ops/attention.py``.  ``attention()`` is the
single entry point for CLIP, the UNet transformer blocks and the VAE
mid-block.  The TPU version chose between XLA's fusion, the library Pallas
flash kernel (``_lib_flash``) and the streaming kernel by thresholds measured
on a v5e; those thresholds do not carry over, and the only alternative to a
kernel is the plain version, which materialises the [B, H, Sq, Skv] logits.
So on the card every attention goes through a kernel:

  * CPU tensors                  -> ``attention_plain``
  * CUDA tensors, D <= 160       -> ``flash_fwd`` (csrc/flash_fwd.cu): the
                                    UNet at every level, CLIP with causal=True
  * CUDA tensors, D > 160        -> ``flash_stream`` (ops/flash_attention.py):
                                    the VAE mid-block
  * CUDA tensors with an additive ``mask`` raise NotImplementedError: no path
    of this slice needs one.

Layout: q [B, Sq, H, D], k/v [B, Skv, H, D] -> out [B, Sq, H, D].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.ops.flash_attention import flash_stream

FLASH_FWD_LAUNCHES = _build.LaunchCounter("flash_fwd")

# head dims up to this go to flash_fwd, wider ones to flash_stream
FLASH_FWD_MAX_D = 160


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v with the numerics of ``attention_xla``
    (stablediffusion_tpu/ops/attention.py:25-55): fp32 logits and softmax,
    probabilities cast to the input type for the product with v.  `causal`
    lets query i see keys j <= i."""
    D = q.shape[-1]
    scale = D**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        keep = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _route(q_shape, k_shape, causal: bool, device_type: str) -> str:
    """The kernel a call goes to: "plain" | "flash_fwd" | "flash_stream".
    Depends only on the device and the shapes; raises where no kernel takes
    the call."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise NotImplementedError(f"attention on device type {device_type!r}")
    D = q_shape[-1]
    if D <= FLASH_FWD_MAX_D:
        return "flash_fwd"
    if causal:
        raise NotImplementedError(
            f"causal attention at head dim {D} > {FLASH_FWD_MAX_D}: "
            "flash_stream has no causal mask"
        )
    return "flash_stream"


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The flash forward kernel for head dims that are multiples of 8 up to
    160.  CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, causal=causal)
    out, args = _build.attention_launch_args("flash_fwd", q, k, v, 8, FLASH_FWD_MAX_D)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.entry("flash_fwd")
    with torch.cuda.device(q.device):
        err = fn(*args, float(scale), int(bool(causal)), stream)
    _build.check("flash_fwd", err)
    FLASH_FWD_LAUNCHES.add(q, k, causal)
    return out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """softmax(q k^T * scale) v, routed by :func:`_route`; `scale` defaults
    to D**-0.5."""
    route = _route(q.shape, k.shape, causal, q.device.type)
    if route == "plain":
        return attention_plain(q, k, v, mask=mask, scale=scale, causal=causal)
    if mask is not None:
        raise NotImplementedError(
            "attention with an additive mask on CUDA: no kernel takes one"
        )
    if route == "flash_fwd":
        return flash_fwd(q, k, v, scale=scale, causal=causal)
    return flash_stream(q, k, v, scale=scale)
