"""Attention: one entry point, routed by device, shape and autograd to a CUDA
kernel.

Port of ``stablediffusion_tpu/ops/attention.py``.  ``attention()`` is the
single entry point for CLIP, the UNet transformer blocks and the VAE
mid-block.  The TPU version chose between XLA's fusion, the library Pallas
flash kernel (``_lib_flash``, forward and custom-VJP backward) and the
streaming kernel by thresholds measured on a v5e; those thresholds do not
carry over, and the only alternative to a kernel is the plain version, which
materialises the [B, H, Sq, Skv] logits.  So on the card every attention goes
through a kernel (:func:`_route`):

  * CPU tensors                  -> ``attention_plain``; autograd of it
                                    gives the gradients
  * CUDA, D <= 160, no grad      -> ``flash_fwd`` (csrc/flash_fwd.cu): the
                                    UNet in inference, CLIP with causal=True
                                    (bf16: TMA-fed wgmma; fp32: the same in
                                    3xTF32, each operand split into two TF32
                                    parts, which holds fp32's accuracy)
  * CUDA, D <= 160, under grad   -> ``FlashAttnFn``: ``flash_fwd`` writing the
                                    row log-sum-exp, and a backward of two
                                    kernels (csrc/flash_bwd.cu): the UNet in
                                    training
  * CUDA, D > 160, no grad       -> ``flash_stream`` (ops/flash_attention.py):
                                    the VAE mid-block
  * CUDA, D > 160, under grad    -> NotImplementedError: no backward kernel
                                    exists for it, in JAX either
  * CUDA, an additive ``mask``  -> ``attention_plain`` (T5's position bias):
                                    the counterpart of the JAX package's
                                    masked route, which goes to XLA's fusion
                                    whatever the shape (no Pallas kernel takes
                                    a mask there either); counted by
                                    ``ATTENTION_MASKED_LAUNCHES``

"Under grad" means ``torch.is_grad_enabled()`` and an input that requires
grad.  On CUDA no output needing a gradient comes back without a
``grad_fn``: the backward kernels run, or the call raises.

Layout: q [B, Sq, H, D], k/v [B, Skv, H, D] -> out [B, Sq, H, D]; the
log-sum-exp is fp32 [B, H, Sq].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.ops.flash_attention import flash_stream

FLASH_FWD_LAUNCHES = _build.LaunchCounter("flash_fwd")
FLASH_BWD_DQ_LAUNCHES = _build.LaunchCounter("flash_bwd_dq")
FLASH_BWD_DKV_LAUNCHES = _build.LaunchCounter("flash_bwd_dkv")
# masked CUDA calls, which run the plain version by design (no kernel)
ATTENTION_MASKED_LAUNCHES = _build.LaunchCounter("attention_masked")

# head dims up to this go to flash_fwd, wider ones to flash_stream
FLASH_FWD_MAX_D = 160
# {padded head width: keys a pipeline stage holds} of the bf16 flash_fwd
# kernel, as csrc/flash_fwd.cu's kBf16Tiles sets them
FLASH_FWD_BF16_TILES = {64: 128, 128: 128, 192: 64}


def flash_fwd_key_tile(D: int) -> Tuple[int, int]:
    """(padded head width, key tile) of the bf16 flash_fwd kernel at head
    dim D: D rounded up to whole 64-column swizzle atoms, and the keys of one
    pipeline stage.  The kernel rounds p to bf16 from the running max of
    these key tiles, so the tile is the `block` of its plain version
    (utils/testing.attention_p_rounded)."""
    if not 0 < D <= FLASH_FWD_MAX_D:
        raise ValueError(f"flash_fwd takes head dims up to {FLASH_FWD_MAX_D}, not {D}")
    dp = -(-D // 64) * 64
    return dp, FLASH_FWD_BF16_TILES[dp]


def _logits(q, k, scale, causal, mask=None):
    """fp32 scaled logits [B, H, Sq, Skv], masked to -inf past the diagonal
    when `causal` (query i sees keys j <= i)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        keep = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


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
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    probs = torch.softmax(_logits(q, k, scale, causal, mask), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def attention_plain_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): ``attention_plain`` and the fp32 log-sum-exp of each row's
    scaled logits, [B, H, Sq] — the plain version of what ``flash_fwd``
    writes when a backward follows."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = _logits(q, k, scale, causal)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v), lse


def _bwd_plain_from_di(q, k, v, do, lse, di, scale, causal):
    """(dq, dk, dv) by the kernels' recompute formulation, in fp32, from the
    forward's lse and di = rowsum(O * dO), both [B, H, Sq]."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.exp(_logits(q, k, scale, causal) - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds.sub_(di[..., None]).mul_(p)  # ds = p * (dp - di), in place
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(O * dO) in fp32, [B, H, Sq] (the JAX library computes it
    outside its kernels, flash_attention.py:273-275)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T * scale) v, spelled out as the two
    backward kernels compute them (not autograd): p = exp(s - lse),
    dv = p^T dO, ds = p (dO v^T - rowsum(O dO)), dq = scale ds k,
    dk = scale ds^T q; fp32 inside, each gradient in its input's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dq, dk, dv = _bwd_plain_from_di(q, k, v, do, lse, _row_dot(o, do), scale, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will record an op on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _route(q_shape, k_shape, causal: bool, device_type: str,
           needs_grad: bool = False, masked: bool = False) -> str:
    """The kernel a call goes to: "plain" | "flash_fwd" | "flash" (the
    forward with lse and the backward kernels, :class:`FlashAttnFn`) |
    "flash_stream" | "plain_masked" (an additive mask on the card).  Depends
    only on the device, the shapes, the mask's presence and whether a
    gradient is needed; raises where no kernel takes the call."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise NotImplementedError(f"attention on device type {device_type!r}")
    if masked:
        return "plain_masked"
    D = q_shape[-1]
    if D <= FLASH_FWD_MAX_D:
        return "flash" if needs_grad else "flash_fwd"
    if needs_grad:
        raise NotImplementedError(
            f"attention backward at head dim {D} > {FLASH_FWD_MAX_D}: "
            "flash_stream is forward only (as its Pallas original is) and no "
            "backward kernel takes this head dim; run it under torch.no_grad()"
        )
    if causal:
        raise NotImplementedError(
            f"causal attention at head dim {D} > {FLASH_FWD_MAX_D}: "
            "flash_stream has no causal mask"
        )
    return "flash_stream"


def _fp32_mappable(*tensors):
    """The fp32 tensors that no TMA map can read but whose rows are 16-byte
    loadable (a stride-0 expand) copied contiguous, the rest as they lie; in
    bf16 all as they lie (such a view raises at the launch)."""
    return tuple(t.contiguous() if t.dtype == torch.float32 and _build.vector_loadable(t)
                 and not _build.tma_mappable(t) else t for t in tensors)


def _launch_fwd(q, k, v, scale: float, causal: bool, with_lse: bool):
    """One flash_fwd launch: (out, lse or None).  Both kernels read q, k, v
    through TMA tensor maps.  In fp32 a view that no map can read but whose
    rows are 16-byte loadable (a stride-0 expand) is copied first; in bf16
    such a view raises."""
    q, k, v = _fp32_mappable(q, k, v)
    out, args = _build.attention_launch_args("flash_fwd", q, k, v, 8, FLASH_FWD_MAX_D)
    B, Sq, H, _ = q.shape
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.entry("flash_fwd")
    lse_ptr = ctypes.c_void_p(None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(*args, float(scale), int(bool(causal)), lse_ptr, stream)
    _build.check("flash_fwd", err)
    FLASH_FWD_LAUNCHES.add(q, k, causal, lse=with_lse)
    return out, lse


def _launch_bwd(name, q, k, v, do, lse, di, scale, causal, dq=None, dk=None, dv=None):
    args = _build.bwd_launch_args(q, k, v, do, lse, di, dq, dk, dv)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.entry(name)
    with torch.cuda.device(q.device):
        err = fn(*args, float(scale), int(bool(causal)), stream)
    _build.check(name, err)


def flash_bwd_dkv(q, k, v, do, lse, di, scale: float, causal: bool = False):
    """(dk, dv) from the flash_bwd_dkv kernel, given the forward's lse and
    di = rowsum(O * dO).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        _, dk, dv = _bwd_plain_from_di(q, k, v, do, lse, di, scale, causal)
        return dk.to(k.dtype), dv.to(v.dtype)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, di, scale, causal, dk=dk, dv=dv)
    FLASH_BWD_DKV_LAUNCHES.add(q, k, causal)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, scale: float, causal: bool = False):
    """dq from the flash_bwd_dq kernel; otherwise as :func:`flash_bwd_dkv`."""
    if q.device.type == "cpu":
        dq, _, _ = _bwd_plain_from_di(q, k, v, do, lse, di, scale, causal)
        return dq.to(q.dtype)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, di, scale, causal, dq=dq)
    FLASH_BWD_DQ_LAUNCHES.add(q, k, causal)
    return dq


def dout_for_kernels(do: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dO in `dtype`, made contiguous where its layout suits either the
    kernels' 16-byte row loads or the bf16 kernels' TMA maps no more
    (:func:`_build.vector_loadable`, :func:`_build.tma_mappable`): autograd
    may hand in any view, such as the zero-stride expansion that the
    gradient of a sum is."""
    do = do.to(dtype)
    if not (_build.vector_loadable(do) and _build.tma_mappable(do)):
        do = do.contiguous()
    return do


def flash_bwd(q, k, v, o, do, lse, scale: Optional[float] = None, causal: bool = False):
    """(dq, dk, dv): di = rowsum(O * dO) in plain torch, as the JAX library
    computes it outside its kernels, then the two backward kernels.  dO goes
    through :func:`dout_for_kernels` first; q, k and v are taken as the
    forward takes them (in fp32 a view no TMA map can read is copied), and a
    layout the kernels cannot read raises.  CPU tensors take the plain
    version."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse, scale, causal)
    q, k, v = _fp32_mappable(q, k, v)
    do = dout_for_kernels(do, q.dtype)
    di = _row_dot(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, scale, causal)
    dq = flash_bwd_dq(q, k, v, do, lse, di, scale, causal)
    return dq, dk, dv


class FlashAttnFn(torch.autograd.Function):
    """Attention whose forward is ``flash_fwd`` writing the row
    log-sum-exp and whose backward is the two kernels of csrc/flash_bwd.cu
    (TMA-fed wgmma, as the forward; fp32 in 3xTF32): the port of the library
    kernel's custom VJP (flash_attention.py:234-323).  Saves q, k, v, out
    and lse; no [Sq, Skv] tensor is kept.  The incoming dO may be any view:
    :func:`flash_bwd` makes it contiguous where the kernels cannot read it."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        out, lse = _launch_fwd(q, k, v, scale, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, do, lse, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The flash forward kernel for head dims that are multiples of 8 up to
    160.  CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.  Under grad the launch also writes the lse and the output
    differentiates through the backward kernels (:class:`FlashAttnFn`);
    without, it writes no lse."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, causal=causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if needs_grad(q, k, v):
        return FlashAttnFn.apply(q, k, v, float(scale), bool(causal))
    return _launch_fwd(q, k, v, scale, causal, with_lse=False)[0]


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v, routed by :func:`_route`; `scale`
    defaults to D**-0.5 (T5 passes 1.0, which reaches every route as it
    is)."""
    route = _route(q.shape, k.shape, causal, q.device.type, needs_grad(q, k, v),
                   masked=mask is not None)
    if route == "plain":
        return attention_plain(q, k, v, mask=mask, scale=scale, causal=causal)
    if route == "plain_masked":
        ATTENTION_MASKED_LAUNCHES.add(q, k, causal)
        return attention_plain(q, k, v, mask=mask, scale=scale, causal=causal)
    if route in ("flash", "flash_fwd"):
        return flash_fwd(q, k, v, scale=scale, causal=causal)
    return flash_stream(q, k, v, scale=scale)
