"""Random-weight models for smoke runs and benches.

Port of ``stablediffusion_tpu/utils/testing.py:17-186``
(``random_params_like`` / ``random_model_params``, ``bench_tokenizer``,
``bench_t5_tokenizer``, ``random_full_model`` for SD1.5, SDXL and SD3),
a random SD3-family model of any configs (``random_sd3_model``), a random
SDXL refiner, a random
training batch as
``benchmarks/bench_train.py`` builds it, the error rules that hold a CUDA
kernel against its plain version (with the fp32 kernels' 3xTF32 split and
products in plain PyTorch: ``tf32_round``, ``attention_tf32x3_emulated``
with the causal mask and the lse, and two products that are not
fp32-accurate, ``tf32_wrong_variants``; the backward's,
``attention_bwd_tf32x3_emulated`` and ``tf32_bwd_wrong_variants``), and files for the adapter and single-file paths: seeded random LoRA factors (``random_lora``, saved by
``lora/formats.save_lora_file`` as peft or kohya) and textual-inversion
embeddings (``random_textual_inversion``), and an A1111/LDM single-file
writer (``ldm_state_dict``, ``save_ldm_single_file``), the inverse of
``io/a1111``'s UNet, VAE and CLIP-L mapping (as the JAX tests' inverse,
``tests/test_a1111.py:42-140``), and seeded writers of a ControlNet folder
(``write_controlnet_folder``), an IP-Adapter ``.safetensors``
(``write_ip_adapter_file``: ``image_proj.*`` and ``ip_adapter.*``, standard
or Plus) and an ``image_encoder`` folder (``write_image_encoder_folder``),
which the loaders read back.  The values follow ``random_params_like`` — 1-D
parameters (norm scales, biases) are ones, the rest normal with std
min(0.02, fan_in**-0.5) — but are drawn by a ``torch.Generator`` on the
target device, so the two packages' weights differ.  Modules are built on the
meta device and materialised on the target device, so a full-width model
costs no host time.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import (
    SD3_MEDIUM,
    SD3_VAE,
    SD15_TEXT_ENCODER,
    SD15_UNET,
    SD15_VAE,
    SDXL_REFINER_UNET,
    SDXL_SCHEDULER,
    SDXL_TEXT_ENCODER,
    SDXL_TEXT_ENCODER_2,
    SDXL_UNET,
    SDXL_VAE,
    CLIPTextConfig,
    SchedulerConfig,
    SD3Config,
    UNetConfig,
    VAEConfig,
    default_dtype,
    resolve_device,
)
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
from stablediffusion_tpu_torch.models.t5 import T5_XXL, T5Config, T5EncoderModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.ops.attention import _row_dot, flash_fwd_key_tile
from stablediffusion_tpu_torch.pipelines.sd3 import SD3Model
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer, _bytes_to_unicode
from stablediffusion_tpu_torch.tokenizer.sentencepiece_unigram import (
    METASPACE,
    SentencePieceUnigramTokenizer,
)

# Limit of an attention kernel's output against its plain version evaluated in
# fp32 on the same input values, per element: |out - ref| <= rtol*|ref| + atol.
# The kernels load bf16 inputs exactly and accumulate in fp32, so the two
# differ by the order of the fp32 sums and, in bf16, by the kernel's one
# rounding of its output.
KERNEL_TOL = {
    torch.float32: (0.0, 1e-5, "fp32 in, fp32 accumulation on both sides: only "
                    "the order of the sums differs (about 3e-6 at the main-path "
                    "shapes on an H100)"),
    torch.bfloat16: (2.0**-8, 1e-5, "the kernel rounds its fp32 result once to "
                     "bf16: at most half a bf16 ulp, 2**-8 |ref|, plus the fp32 "
                     "order-of-sums noise"),
}

# The bf16 flash_fwd also rounds each probability p to bf16 for its product
# with v, as the JAX kernel does (`p.astype(v.dtype)`), p = exp(s - m) taken
# from the running max m of its key tiles (ops/attention.flash_fwd_key_tile:
# 128 keys up to head dim 128, 64 above).  Its plain version is therefore
# that same online softmax in fp32 with the same rounding
# (:func:`attention_p_rounded`), and the two compute each fp32 p to within
# P_EPS of each other: the logits' fp32 sums run in another order, and the
# kernel's exp2 is the hardware's approximation, each worth about 2**-20 of p
# at these magnitudes.  A p that lies within P_EPS of a bf16 rounding midpoint
# may round the other way in the kernel, which moves it by one bf16 ulp, at
# most 2**-7 of itself: the limit gains 2**-7 * (sum of p |v| over those p)
# over the denominator, per element.  Only about one p in 2**8 is that close.
P_EPS = 2.0**-16
P_FLIP_RTOL = 2.0**-7


def kernel_error(out: torch.Tensor, ref: torch.Tensor,
                 flips: Optional[torch.Tensor] = None) -> dict:
    """How far a kernel's `out` lies from `ref`, its plain version evaluated
    in fp32 on the same inputs, under :data:`KERNEL_TOL` for out's dtype.
    With `flips` (from :func:`attention_p_rounded`, for a kernel that rounds
    p to bf16) the limit also takes :data:`P_FLIP_RTOL` times it.
    ``worst_over_limit`` <= 1 means every element is within its limit;
    ``typical_abs_ref`` is the mean |ref|, the scale the limit applies to."""
    rtol, atol, reason = KERNEL_TOL[out.dtype]
    ref = ref.float()
    diff = (out.float() - ref).abs()
    limit = ref.abs() * rtol + atol
    if flips is not None:
        limit = limit + P_FLIP_RTOL * flips.float()
        reason += ("; against the same tiles with p rounded to bf16, plus 2**-7 of "
                   "p|v| / l over the p within 2**-16 of a rounding midpoint")
    return {
        "max_abs_err": diff.max().item(),
        "worst_over_limit": (diff / limit).max().item(),
        "typical_abs_ref": ref.abs().mean().item(),
        "rtol": rtol, "atol": atol, "tol_reason": reason,
    }


def attention_p_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, block: Optional[int] = None,
                        scale: Optional[float] = None, rescale: bool = True,
                        acc_dtype: torch.dtype = torch.float32):
    """The plain version of the bf16 flash_fwd, in fp32 on q/k/v's device:
    online softmax over key tiles of `block` (by default the kernel's own,
    ``flash_fwd_key_tile`` of the head dim); each p = exp(s - m), m the
    running max, is rounded to bf16 for its product with v, and the
    denominator l sums the fp32 p.  Returns (out, flips), both fp32
    [B, Sq, H, D]; flips is the sum of p |v| / l over the p within
    :data:`P_EPS` of a bf16 rounding midpoint (see :func:`kernel_error`).
    Wrong kernels, to show that the rule has teeth: `rescale=False` never
    rescales the accumulator when the running max grows (l still is);
    `acc_dtype=torch.bfloat16` keeps the accumulator in bf16 between tiles."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    block = flash_fwd_key_tile(q.shape[-1])[1] if block is None else block
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    B, H, Sq, D = qf.shape
    dev = q.device
    m = torch.full((B, H, Sq, 1), -1e30, device=dev)
    l = torch.zeros((B, H, Sq, 1), device=dev)
    acc = torch.zeros((B, H, Sq, D), device=dev)
    flips = torch.zeros((B, H, Sq, D), device=dev)
    rows = torch.arange(Sq, device=dev)[:, None]
    for k0 in range(0, kf.shape[2], block):
        kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2], device=dev)[None, :]
            s = s.masked_fill(keys > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        near = ((p * (1 - P_EPS)).to(torch.bfloat16)
                != (p * (1 + P_EPS)).to(torch.bfloat16))
        acc = (acc * alpha if rescale else acc) + p.to(torch.bfloat16).float() @ vt
        acc = acc.to(acc_dtype).float()
        flips = flips * alpha + (p * near) @ vt.abs()
        m = m_new
    return (acc / l).transpose(1, 2), (flips / l).transpose(1, 2)


def attention_wrong_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = False, block: Optional[int] = None) -> dict:
    """Three wrong bf16 attention forwards, each rounded to q's dtype as a
    kernel rounds its output: "no_rescale" (the accumulator is not rescaled
    when the running max grows), "scale_twice" (the logits scaled by
    scale**2) and "acc_bf16" (the accumulator kept in bf16 between tiles of
    `block` keys, by default the kernel's key tile); all otherwise
    :func:`attention_p_rounded`."""
    scale = q.shape[-1] ** -0.5
    variants = {"no_rescale": dict(rescale=False), "scale_twice": dict(scale=scale * scale),
                "acc_bf16": dict(acc_dtype=torch.bfloat16)}
    return {n: attention_p_rounded(q, k, v, causal, block, **kw)[0].to(q.dtype)
            for n, kw in variants.items()}


# The fp32 kernels, flash_fwd and flash_stream, run both products on the
# tensor cores in 3xTF32 (csrc/hopper.cuh): each operand x is split into
# hi = tf32(x) and lo = tf32(x - hi), TF32 rounding to nearest with ties
# away from zero as cvt.rna.tf32.f32 does, and a product is hi*hi + hi*lo +
# lo*hi in fp32.  The functions below emulate that split and its three
# products in plain PyTorch, over the kernels' 64-key tiles (the online
# softmax's p is split from its running max), with flash_fwd's causal mask
# and log-sum-exp, and two products that are not fp32-accurate, which the
# unchanged fp32 rule of KERNEL_TOL must refuse.  They do not emulate the
# kernels' accumulation: the tensor cores add with truncation and the FPU
# adds each part into o (flash_stream's of 64 keys; flash_fwd's of 32, the
# small products first), flash_fwd's two warpgroups take the key tiles in
# turn and merge their halves, the lo parts keep bits that the tensor core
# ignores, and the kernels exponentiate with ex2.approx; so they show that
# the 3xTF32 split is accurate enough, and the card's tests show that the
# kernels are.
TF32_KEY_TILE = 64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 `x` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on its bit pattern; a carry may reach the exponent; inf and NaN
    pass unchanged."""
    x = x.float()
    r = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): x to about 2**-22."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, terms: str) -> torch.Tensor:
    """a @ b from the TF32 parts that the kernel multiplies, summed in fp32
    matmuls: "3x" (hi*hi + hi*lo + lo*hi), "1x" (each operand rounded to
    TF32 once) or "hi_hilo" (hi*hi + hi*lo, a's lo dropped)."""
    if terms == "1x":
        return tf32_round(a) @ tf32_round(b)
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    out = ah @ bh + ah @ bl
    return out + al @ bh if terms == "3x" else out


def _attention_tf32(q, k, v, scale, terms, causal=False):
    """(out [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq]) of the 3xTF32
    arithmetic (or a wrong `terms`), online softmax over TF32_KEY_TILE keys,
    keys past the diagonal masked to -1e30 when `causal`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    B, H, Sq, D = qf.shape
    s = _tf32_product(qf, kf.transpose(-1, -2), terms) * scale
    if causal:
        keep = torch.ones(Sq, kf.shape[2], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    m = torch.full((B, H, Sq, 1), -1e30, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    for k0 in range(0, kf.shape[2], TF32_KEY_TILE):
        st = s[..., k0:k0 + TF32_KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_product(p, vf[:, :, k0:k0 + TF32_KEY_TILE], terms)
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def attention_tf32x3_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None, causal: bool = False):
    """The fp32 kernels' 3xTF32 split and products in plain PyTorch on q's
    device (fp32 matmuls, so TF32 must be off there): s = q k^T and o += p v
    each from the three TF32 products, online softmax over 64-key tiles,
    with flash_fwd's causal mask (query i sees keys j <= i) when `causal`;
    the kernels' order and rounding of their sums are not emulated.  (out
    [B, Sq, H, D], lse fp32 [B, H, Sq]), the counterpart of
    ``ops/attention.attention_plain_lse``."""
    return _attention_tf32(q, k, v, scale, "3x", causal)


def tf32_wrong_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> dict:
    """Two products that are not fp32-accurate, in the emulation of
    :func:`attention_tf32x3_emulated` (the same key tiles and, with
    `causal`, the same mask): "1xTF32" (each operand rounded to TF32 once,
    as a plain TF32 product) and "hi_hilo" (hi*hi + hi*lo: the lo*hi term
    dropped).  Outputs only."""
    return {"1xTF32": _attention_tf32(q, k, v, None, "1x", causal)[0],
            "hi_hilo": _attention_tf32(q, k, v, None, "hi_hilo", causal)[0]}


# The fp32 backward kernels (csrc/flash_bwd.cu) run every product of the
# backward in 3xTF32 as well: s = q k^T and dp = dO v^T, then dV = p^T dO,
# dK = scale ds^T q and dQ = scale ds k with ds = p (dp - di).  The functions
# below emulate the split and the three products of each (sums in fp32
# matmuls, one batch element at a time), with the causal mask on p, and two
# products that are not fp32-accurate, which the unchanged fp32 rule of
# GRAD_TOL must refuse.  As for the forward, the kernels' order and rounding
# of their sums are not emulated here (utils/tf32_accumulation does that).


def _attention_bwd_tf32(q, k, v, o, do, lse, scale, terms, causal):
    """(dq, dk, dv) in q's dtype of the backward from the TF32 parts named by
    `terms` (:func:`_tf32_product`); p = 0 past the diagonal when `causal`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    di = _row_dot(o, do)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, D]
    grads = []
    for b in range(q.shape[0]):
        s = _tf32_product(qf[b], kf[b].transpose(-1, -2), terms) * scale
        p = torch.exp(s - lse[b].float()[..., None])
        if causal:
            keep = torch.ones(p.shape[-2:], dtype=torch.bool, device=p.device).tril()
            p = p.masked_fill(~keep, 0.0)
        del s
        ds = p * (_tf32_product(dof[b], vf[b].transpose(-1, -2), terms) - di[b].float()[..., None])
        grads.append((_tf32_product(ds, kf[b], terms) * scale,
                      _tf32_product(ds.transpose(-1, -2), qf[b], terms) * scale,
                      _tf32_product(p.transpose(-1, -2), dof[b], terms)))
        del p, ds
    return tuple(torch.stack(ts).transpose(1, 2).to(q.dtype) for ts in zip(*grads))


def attention_bwd_tf32x3_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                                  scale: Optional[float] = None, causal: bool = False):
    """The fp32 backward kernels' 3xTF32 split and products in plain PyTorch
    on q's device (fp32 matmuls, so TF32 must be off there), given the
    forward's output `o` and lse: each of the five products from hi*hi +
    hi*lo + lo*hi, di = rowsum(o * dO) in fp32, p masked to 0 past the
    diagonal when `causal`; the kernels' order and rounding of their sums
    are not emulated.  (dq, dk, dv) [B, S, H, D], the counterpart of
    ``ops/attention.flash_bwd_plain``."""
    return _attention_bwd_tf32(q, k, v, o, do, lse, scale, "3x", causal)


def tf32_bwd_wrong_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                            scale: Optional[float] = None, causal: bool = False) -> dict:
    """Two backwards whose products are not fp32-accurate, in the emulation
    of :func:`attention_bwd_tf32x3_emulated` (with `causal`, the same mask):
    "1xTF32" (each operand rounded to TF32 once) and "hi_hilo" (hi*hi +
    hi*lo: the lo*hi term dropped).  Each (dq, dk, dv)."""
    return {name: _attention_bwd_tf32(q, k, v, o, do, lse, scale, terms, causal)
            for name, terms in (("1xTF32", "1x"), ("hi_hilo", "hi_hilo"))}


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


def grad_error(out: torch.Tensor, ref: torch.Tensor,
               flips: Optional[torch.Tensor] = None) -> dict:
    """How far a backward kernel's gradient `out` lies from `ref`, the plain
    backward evaluated in fp32 on the same inputs, under :data:`GRAD_TOL`
    for out's dtype; ``worst_over_limit`` <= 1 means every element is within
    its limit.  With `flips` (from :func:`attention_bwd_rounded`, for the
    bf16 kernels, which round p and ds to bf16) the limit also takes
    :data:`P_FLIP_RTOL` times it."""
    rtol, atol_rel, reason = GRAD_TOL[out.dtype]
    ref = ref.float()
    diff = (out.float() - ref).abs()
    atol = atol_rel * ref.abs().max().item()
    limit = ref.abs() * rtol + atol
    if flips is not None:
        limit = limit + P_FLIP_RTOL * flips.float()
        reason += ("; against the same backward with p and ds rounded to bf16, plus "
                   "2**-7 of the terms whose p or ds lies near a rounding midpoint")
    return {
        "max_abs_err": diff.max().item(),
        "worst_over_limit": (diff / limit).max().item(),
        "typical_abs_ref": ref.abs().mean().item(),
        "atol": atol, "rtol": rtol, "tol_reason": reason,
    }


# The bf16 backward kernels round p to bf16 for dV += p^T dO and
# ds = scale * p * (dp - di) to bf16 for dK += ds^T q and dQ += ds k, as the
# JAX library kernels do (`p.T.astype(do.dtype)`, `ds.T.astype(do.dtype)`
# after `ds *= sm_scale`, `ds.astype(k.dtype)`); their plain version
# (:func:`attention_bwd_rounded`) rounds at the same places.  The kernel's
# fp32 p differs from the plain one by exp2's approximation and the order of
# the logits' sums, about 2**-20 of p, as in the forward; its ds also by the
# order of dp's sum over D, an absolute error of a few fp32 ulps of
# |dp| + |di| that (dp - di) may not shrink with it.  So a p within P_EPS of
# itself, or a ds within P_EPS * scale * p * (|dp| + |di|) of a bf16
# rounding midpoint may round the other way in the kernel: the limit takes
# 2**-7 of the term that p or ds enters, summed over those.


def _near_midpoint(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Whether x moved by up to w either way may round to another bf16."""
    return (x - w).to(torch.bfloat16) != (x + w).to(torch.bfloat16)


def _scaled_logits(q, k, scale, causal):
    """fp32 q k^T * scale of one batch element, [H, Sq, Skv] from [H, S, D];
    -inf past the diagonal when `causal`."""
    s = (q @ k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _bwd_rounded_one(q, k, v, do, lse, di, scale, causal, scale_ds, acc_tile):
    """:func:`attention_bwd_rounded` for one batch element, fp32 [H, S, D]
    and [H, Sq] in; returns (dq, dk, dv, flips of each)."""
    p = torch.exp(_scaled_logits(q, k, scale, causal) - lse[..., None])
    dp = do @ v.transpose(-1, -2)
    c = scale if scale_ds else 1.0
    ds = p * (dp - di[..., None]) * c
    w = P_EPS * c * p * (dp.abs() + di.abs()[..., None])
    del dp
    near_ds = _near_midpoint(ds, w)
    del w
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    fdv = (p * _near_midpoint(p, P_EPS * p)).transpose(-1, -2) @ do.abs()
    del p
    ads = ds.abs() * near_ds
    del ds, near_ds
    fdk, fdq = ads.transpose(-1, -2) @ q.abs(), ads @ k.abs()
    del ads
    dq = dsb @ k
    if acc_tile is None:
        dv, dk = pb.transpose(-1, -2) @ do, dsb.transpose(-1, -2) @ q
    else:  # a wrong kernel: dK and dV rounded to bf16 after each query tile
        dv, dk = torch.zeros_like(v), torch.zeros_like(k)
        for t in range(0, q.shape[1], acc_tile):
            rows = slice(t, t + acc_tile)
            dv = (dv + pb[:, rows].transpose(-1, -2) @ do[:, rows]).to(torch.bfloat16).float()
            dk = (dk + dsb[:, rows].transpose(-1, -2) @ q[:, rows]).to(torch.bfloat16).float()
    return dq, dk, dv, fdq, fdk, fdv


def attention_bwd_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                          scale: Optional[float] = None, causal: bool = False, *,
                          di: Optional[torch.Tensor] = None, scale_ds: bool = True,
                          acc_tile: Optional[int] = None):
    """The plain version of the bf16 backward kernels, in fp32 on q's
    device: p = exp(s - lse), masked to 0 past the diagonal when `causal`;
    dV = bf16(p)^T dO; ds = scale * p * (dO v^T - di) with
    di = rowsum(O * dO); dK = bf16(ds)^T q, dQ = bf16(ds) k.  q, k, v, o, dO
    are [B, S, H, D], lse fp32 [B, H, Sq].  Returns ((dq, dk, dv), (flips of
    dq, dk, dv)), all fp32 [B, S, H, D]: a flip term is the sum of |the other
    factor| * p (or |ds|) over the p (or ds) near a bf16 rounding midpoint
    (see the note above; :func:`grad_error` takes 2**-7 of it).  One batch
    element at a time, so that the [H, Sq, Skv] tensors stay small.  Wrong
    kernels, for the rule's teeth: `di` in place of rowsum(O * dO);
    `scale_ds=False` leaves the scale out of ds; `acc_tile` rounds dK and dV
    to bf16 after every `acc_tile` query rows."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    di = _row_dot(o, do) if di is None else di
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, D]
    per_b = [_bwd_rounded_one(qf[b], kf[b], vf[b], dof[b], lse[b].float(), di[b].float(),
                              scale, causal, scale_ds, acc_tile)
             for b in range(q.shape[0])]
    out = [torch.stack(ts).transpose(1, 2) for ts in zip(*per_b)]
    return tuple(out[:3]), tuple(out[3:])


def attention_bwd_wrong_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                                 scale: Optional[float] = None,
                                 causal: bool = False) -> dict:
    """Four wrong bf16 backwards, each (dq, dk, dv) rounded to q's dtype as
    a kernel rounds its output; otherwise :func:`attention_bwd_rounded`:
    "no_di" (di = 0), "acc_bf16" (dK and dV kept in bf16 between 64-row
    query tiles), "ds_unscaled" (the scale left out of ds, so of dk and dq)
    and "lse_max_only" (p from the row max of the scaled logits, an lse
    without log l)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf = (t.float().transpose(1, 2) for t in (q, k))
    row_max = torch.stack([_scaled_logits(qf[b], kf[b], scale, causal).amax(-1)
                           for b in range(q.shape[0])])
    variants = {"no_di": dict(di=torch.zeros_like(lse)), "acc_bf16": dict(acc_tile=64),
                "ds_unscaled": dict(scale_ds=False), "lse_max_only": dict(lse=row_max)}
    out = {}
    for name, kw in variants.items():
        grads, _ = attention_bwd_rounded(q, k, v, o, do, scale=scale, causal=causal,
                                         **{"lse": lse, **kw})
        out[name] = tuple(g.to(q.dtype) for g in grads)
    return out


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
            elif p.dim() == 3:  # the MM-DiT's position table [1, positions, dim]
                fan_in = p.shape[2]
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


def bench_t5_tokenizer(extra_ids: int = 100) -> SentencePieceUnigramTokenizer:
    """Char-level SentencePiece-unigram tokenizer with T5's special layout
    (<pad> 0, </s> 1, <unk> 2, the sentinels at the end of the id space), so
    a full-size T5 runs the real encode contract; its ids stay far below the
    32128-row table, and ``save_pretrained`` round-trips it.  The JAX
    package's tokenizer of the same name builds the same vocabulary."""
    chars = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-"
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), (METASPACE, -1.0)]
    vocab += [(c, -2.0) for c in chars]
    vocab += [(METASPACE + c, -1.5) for c in chars]
    return SentencePieceUnigramTokenizer(vocab, unk_id=2, eos_id=1, pad_id=0,
                                         extra_ids=extra_ids)


def synthetic_clip_tokenizer(pad_token_id: Optional[int] = None) -> CLIPTokenizer:
    """A byte-level CLIP BPE vocabulary in the real one's layout, for a
    full-width model that must round-trip through a checkpoint folder: the
    256 byte tokens (ids 0-255, "!" first, so that OpenCLIP's pad id 0
    round-trips as "!"), their ``</w>`` forms (256-511), a few merges of
    common English pairs, and bos 49406 / eos 49407, all inside the
    49408-row embedding table.  The real vocabulary is not in the
    repository."""
    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"),
              ("o", "f</w>"), ("r", "e"), ("o", "n</w>"), ("e", "r</w>"), ("a", "t")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    return CLIPTokenizer(vocab, merges, pad_token_id=pad_token_id)


def random_model(
    unet_config: UNetConfig,
    vae_config: VAEConfig,
    text_encoder_config: CLIPTextConfig,
    tokenizer,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    text_encoder_2_config: Optional[CLIPTextConfig] = None,
    tokenizer_2=None,
    vae_dtype: Optional[torch.dtype] = None,
    scheduler_config: Optional[SchedulerConfig] = None,
) -> SDModel:
    """An SDModel of the given configs with random weights from `seed`, on
    `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``).  The UNet is held in `dtype` (default: the device's
    compute dtype), the VAE in `vae_dtype` (default `dtype`), the text
    encoders in fp32, as ``random_model_params`` holds them.  A
    `text_encoder_2_config` makes it an SDXL model."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    g = torch.Generator(device=device).manual_seed(seed)
    sdxl = {}
    if text_encoder_2_config is not None:
        sdxl = dict(
            text_encoder_2_config=text_encoder_2_config,
            text_encoder_2=random_module(CLIPTextModel, text_encoder_2_config, device,
                                         torch.float32, g),
            tokenizer_2=tokenizer_2,
        )
    return SDModel(
        unet_config=unet_config,
        unet=random_module(UNet2DConditionModel, unet_config, device, dtype, g),
        vae_config=vae_config,
        vae=random_module(AutoencoderKL, vae_config, device, vae_dtype or dtype, g),
        text_encoder_config=text_encoder_config,
        text_encoder=random_module(
            CLIPTextModel, text_encoder_config, device, torch.float32, g
        ),
        tokenizer=tokenizer,
        scheduler_config=scheduler_config or SchedulerConfig(),
        scheduler_name="DDIM",
        model_type="sdxl" if sdxl else "sd15",
        **sdxl,
    )


def random_sd3_model(
    transformer_config: SD3Config,
    vae_config: VAEConfig,
    text_encoder_config: CLIPTextConfig,
    text_encoder_2_config: CLIPTextConfig,
    tokenizer,
    tokenizer_2,
    text_encoder_3_config: Optional[T5Config] = None,
    tokenizer_3=None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    scheduler_config: Optional[SchedulerConfig] = None,
) -> SD3Model:
    """An SD3Model of the given configs with random weights from `seed`, on
    `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``), every module in `dtype` (default: the device's
    compute dtype).  A `text_encoder_3_config` adds T5."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    g = torch.Generator(device=device).manual_seed(seed)
    t5 = {}
    if text_encoder_3_config is not None:
        t5 = dict(text_encoder_3_config=text_encoder_3_config,
                  text_encoder_3=random_module(T5EncoderModel, text_encoder_3_config,
                                               device, dtype, g),
                  tokenizer_3=tokenizer_3)
    return SD3Model(
        transformer_config=transformer_config,
        transformer=random_module(SD3Transformer2DModel, transformer_config, device, dtype, g),
        vae_config=vae_config,
        vae=random_module(AutoencoderKL, vae_config, device, dtype, g),
        text_encoder_config=text_encoder_config,
        text_encoder=random_module(CLIPTextModel, text_encoder_config, device, dtype, g),
        tokenizer=tokenizer,
        text_encoder_2_config=text_encoder_2_config,
        text_encoder_2=random_module(CLIPTextModel, text_encoder_2_config, device, dtype, g),
        tokenizer_2=tokenizer_2,
        scheduler_config=scheduler_config or SchedulerConfig(shift=3.0),
        **t5,
    )


def random_full_model(
    name: str = "sd15",
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    with_t5: bool = False,
):
    """Full-width SD1.5 or SDXL SDModel, or SD3-medium SD3Model, with random
    weights: the same FLOPs and memory traffic as the real checkpoint, which
    the repository does not hold.  SDXL: CLIP-L and bigG (its char-level
    tokenizer pads with id 0, as OpenCLIP's does), the VAE in fp32 and the
    "leading" scheduler, as the JAX package's ``random_full_model("sdxl")``
    builds it.  SD3: the T5-free serving configuration unless `with_t5`
    adds T5-XXL and ``bench_t5_tokenizer``; CLIP-L with its projection, as
    SD3 checkpoints ship it (pooled 768 + 1280 = 2048); every module in
    `dtype`, as the JAX package's ``_random_full_sd3`` holds them."""
    if name == "sd3":
        return random_sd3_model(
            SD3_MEDIUM, SD3_VAE, dataclasses.replace(SDXL_TEXT_ENCODER, with_projection=True),
            SDXL_TEXT_ENCODER_2, bench_tokenizer(), bench_tokenizer(pad_token_id=0),
            text_encoder_3_config=T5_XXL if with_t5 else None,
            tokenizer_3=bench_t5_tokenizer() if with_t5 else None,
            device=device, dtype=dtype, seed=seed)
    if name == "sdxl":
        return random_model(
            SDXL_UNET, SDXL_VAE, SDXL_TEXT_ENCODER, bench_tokenizer(),
            device=device, dtype=dtype, seed=seed,
            text_encoder_2_config=SDXL_TEXT_ENCODER_2,
            tokenizer_2=bench_tokenizer(pad_token_id=0),
            vae_dtype=torch.float32, scheduler_config=SDXL_SCHEDULER,
        )
    if name != "sd15":
        raise ValueError(f"model {name!r}: one of 'sd15', 'sdxl', 'sd3'")
    return random_model(
        SD15_UNET, SD15_VAE, SD15_TEXT_ENCODER, bench_tokenizer(),
        device=device, dtype=dtype, seed=seed,
    )


def random_refiner(model: SDModel, config: UNetConfig = SDXL_REFINER_UNET,
                   seed: int = 1) -> SDModel:
    """Give an SDXL `model` a refiner UNet of `config` (default the
    full-width SDXL refiner) with random weights from `seed`, on the model's
    device and in its UNet's dtype, as ``SDModel.load_refiner`` would load
    one.  Returns the model."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    dtype = next(model.unet.parameters()).dtype
    model.refiner_config = config
    model.refiner = random_module(UNet2DConditionModel, config, model.device, dtype, g)
    return model


def random_train_batch(B: int, res: int, generator: torch.Generator,
                       sdxl: bool = False) -> dict:
    """A training batch as ``benchmarks/bench_train.py:62-68`` builds it, on
    `generator`'s device: "pixel_values" NHWC [B, res, res, 3] fp32, normal
    with std 0.5, and "input_ids" [B, 77] uniform in [0, 49407).  With
    `sdxl`, also "input_ids_2" and the micro-conditioning of an uncropped
    res x res image ("original_sizes", "crop_top_lefts", "target_sizes",
    fp32 [B, 2])."""
    device = generator.device
    batch = {
        "pixel_values": torch.randn(B, res, res, 3, generator=generator,
                                    device=device) * 0.5,
        "input_ids": torch.randint(0, 49407, (B, 77), generator=generator,
                                   device=device),
    }
    if sdxl:
        size = torch.full((B, 2), float(res), device=device)
        batch.update(
            input_ids_2=torch.randint(0, 49407, (B, 77), generator=generator, device=device),
            original_sizes=size, crop_top_lefts=torch.zeros_like(size), target_sizes=size.clone())
    return batch


def write_image_folder(path: str, n: int, size, seed: int = 0,
                       caption: str = "a photograph of an astronaut riding a horse") -> str:
    """Write `n` JPEGs of `size` (an int, or (height, width)) with seeded
    smooth random content, each with a caption file "`caption` {i}", into
    `path` (made if missing): the folder layout ``train/dataset.py``
    reads.  Returns `path`."""
    import os

    from PIL import Image

    h, w = (size, size) if isinstance(size, int) else size
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        # a coarse random grid upsampled: content a VAE would see in a photo
        coarse = rng.uniform(0, 255, (max(h // 32, 2), max(w // 32, 2), 3)).astype(np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        img.save(os.path.join(path, f"img{i:03d}.jpg"), quality=95)
        with open(os.path.join(path, f"img{i:03d}.txt"), "w") as f:
            f.write(f"{caption} {i}")
    return path


def random_lora(module: nn.Module, suffixes: Sequence[str], rank: int, seed: int,
                std: float = 0.02, alpha: Optional[float] = None) -> Dict[str, dict]:
    """Factors {path: {"down" [in, r], "up" [r, out], "alpha"}} for every
    linear of `module` whose path ends with one of `suffixes` (``""``: all
    of them), fp32 on the module's device, normal with std `std` (up too,
    so that the adapter changes the weights); alpha = rank unless given."""
    from stablediffusion_tpu_torch.lora.core import linear_module_paths

    device = next(module.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path in linear_module_paths(module, suffixes):
        n_out, n_in = module.get_submodule(path).weight.shape
        out[path] = {
            "down": torch.randn(n_in, rank, generator=g, device=device) * std,
            "up": torch.randn(rank, n_out, generator=g, device=device) * std,
            "alpha": torch.tensor(float(alpha if alpha is not None else rank)),
        }
    return out


def random_textual_inversion(model: SDModel, n_vectors: int, seed: int,
                             std: float = 0.02) -> Dict[str, torch.Tensor]:
    """Embedding rows from `seed` in the format the model takes: SDXL's
    ``{"clip_l", "clip_g"}``, else community ``{"emb_params"}``; fp32 on
    the CPU, ready for ``save_safetensors``."""
    g = torch.Generator().manual_seed(seed)

    def rows(cfg):
        return torch.randn(n_vectors, cfg.hidden_size, generator=g) * std

    if model.is_sdxl:
        return {"clip_l": rows(model.text_encoder_config),
                "clip_g": rows(model.text_encoder_2_config)}
    return {"emb_params": rows(model.text_encoder_config)}


_RESNET_TO_LDM = {"norm1": "in_layers.0", "conv1": "in_layers.2",
                  "time_emb_proj": "emb_layers.1", "norm2": "out_layers.0",
                  "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_VAE_ATTN_TO_LDM = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
                    "to_out.0": "proj_out"}


def _unet_key_to_ldm(key: str, cfg: UNetConfig) -> str:
    L = cfg.layers_per_block
    simple = {"conv_in.": "input_blocks.0.0.", "time_embedding.linear_1.": "time_embed.0.",
              "time_embedding.linear_2.": "time_embed.2.", "conv_norm_out.": "out.0.",
              "conv_out.": "out.2.", "add_embedding.linear_1.": "label_emb.0.0.",
              "add_embedding.linear_2.": "label_emb.0.2."}
    for new, old in simple.items():
        if key.startswith(new):
            return old + key[len(new):]
    if m := re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)\.(.*)", key):
        i, j = int(m.group(1)), int(m.group(2))
        return f"input_blocks.{1 + i * (L + 1) + j}.0.{_RESNET_TO_LDM[m.group(3)]}.{m.group(4)}"
    if m := re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.(.*)", key):
        i, j = int(m.group(1)), int(m.group(2))
        return f"input_blocks.{1 + i * (L + 1) + j}.1.{m.group(3)}"
    if m := re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", key):
        return f"input_blocks.{1 + int(m.group(1)) * (L + 1) + L}.0.op.{m.group(2)}"
    if m := re.match(r"mid_block\.resnets\.(\d)\.(\w+)\.(.*)", key):
        slot = 0 if m.group(1) == "0" else 2
        return f"middle_block.{slot}.{_RESNET_TO_LDM[m.group(2)]}.{m.group(3)}"
    if m := re.match(r"mid_block\.attentions\.0\.(.*)", key):
        return f"middle_block.1.{m.group(1)}"
    if m := re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)\.(.*)", key):
        i, j = int(m.group(1)), int(m.group(2))
        return f"output_blocks.{i * (L + 1) + j}.0.{_RESNET_TO_LDM[m.group(3)]}.{m.group(4)}"
    if m := re.match(r"up_blocks\.(\d+)\.attentions\.(\d+)\.(.*)", key):
        i, j = int(m.group(1)), int(m.group(2))
        return f"output_blocks.{i * (L + 1) + j}.1.{m.group(3)}"
    if m := re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", key):
        i = int(m.group(1))
        slot = 2 if cfg.up_block_types[i] == "CrossAttnUpBlock2D" else 1
        return f"output_blocks.{i * (L + 1) + L}.{slot}.conv.{m.group(2)}"
    raise KeyError(f"no LDM name for UNet key {key!r}")


def _vae_key_to_ldm(key: str, val: torch.Tensor, n_up: int):
    """(LDM key, tensor) of one VAE tensor; the mid-block attention's
    linears become the 1x1 convolutions LDM stores."""
    if key.startswith(("quant_conv.", "post_quant_conv.")):
        return "first_stage_model." + key, val
    side, rest = key.split(".", 1)
    if rest.startswith(("conv_in.", "conv_out.")):
        nk = rest
    elif rest.startswith("conv_norm_out."):
        nk = "norm_out." + rest[len("conv_norm_out."):]
    elif m := re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", rest):
        nk = f"down.{m.group(1)}.block.{m.group(2)}.{m.group(3)}"
    elif m := re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", rest):
        nk = f"down.{m.group(1)}.downsample.conv.{m.group(2)}"
    elif m := re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", rest):
        nk = f"up.{n_up - 1 - int(m.group(1))}.block.{m.group(2)}.{m.group(3)}"
    elif m := re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", rest):
        nk = f"up.{n_up - 1 - int(m.group(1))}.upsample.conv.{m.group(2)}"
    elif m := re.match(r"mid_block\.resnets\.(\d)\.(.*)", rest):
        nk = f"mid.block_{int(m.group(1)) + 1}.{m.group(2)}"
    elif m := re.match(r"mid_block\.attentions\.0\.(\w+(?:\.0)?)\.(.*)", rest):
        part, r = m.group(1), m.group(2)
        if r == "weight" and part != "group_norm":
            val = val[:, :, None, None]
        nk = f"mid.attn_1.{_VAE_ATTN_TO_LDM[part]}.{r}"
    else:
        raise KeyError(f"no LDM name for VAE key {key!r}")
    return f"first_stage_model.{side}.{nk.replace('conv_shortcut', 'nin_shortcut')}", val


def ldm_state_dict(model: SDModel) -> Dict[str, torch.Tensor]:
    """An SD1.x model's tensors under A1111/LDM names, as a single-file
    checkpoint holds them: the UNet under ``model.diffusion_model.``, the
    VAE under ``first_stage_model.`` (attention as 1x1 convolutions), CLIP-L
    under ``cond_stage_model.transformer.``; each in its module's dtype."""
    if model.is_sdxl:
        raise NotImplementedError("the LDM writer covers SD1.x (UNet, VAE, CLIP-L)")
    out = {"model.diffusion_model." + _unet_key_to_ldm(k, model.unet_config): v
           for k, v in model.unet.state_dict().items()}
    n_up = len(model.vae_config.block_out_channels)
    out.update(_vae_key_to_ldm(k, v, n_up) for k, v in model.vae.state_dict().items())
    out.update({"cond_stage_model.transformer." + k: v
                for k, v in model.text_encoder.state_dict().items()})
    return out


def save_ldm_single_file(model: SDModel, path: str) -> None:
    """Write `model` as an A1111/LDM .safetensors single file."""
    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

    save_safetensors(ldm_state_dict(model), path)


# -- ControlNet, IP-Adapter and image-encoder files ---------------------------
def random_controlnet(config: UNetConfig, device: Union[str, torch.device, None] = None,
                      dtype: Optional[torch.dtype] = None, seed: int = 0) -> nn.Module:
    """A ControlNet of `config` with random weights from `seed`.  Its
    "zero" convolutions (the control outputs and the embedder's conv_out)
    get seeded non-zero weights and zero biases, so that it changes the
    UNet's output (one built by ``controlnet.init_from_unet`` does not)."""
    from stablediffusion_tpu_torch.models.controlnet import ControlNetModel

    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    g = torch.Generator(device=device).manual_seed(seed)
    net = random_module(ControlNetModel, config, device, dtype, g)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith(("controlnet_down_blocks", "controlnet_mid_block",
                                "controlnet_cond_embedding.conv_out")) and p.dim() == 1:
                p.zero_()
    return net


def write_controlnet_folder(path: str, config: UNetConfig,
                            device: Union[str, torch.device, None] = None,
                            dtype: torch.dtype = torch.float16, seed: int = 0) -> str:
    """A diffusers ControlNet folder at `path` of :func:`random_controlnet`'s
    weights in `dtype` (built on `device`), read back by
    ``SDModel.load_controlnet``.  Returns `path`."""
    from stablediffusion_tpu_torch.io.loader import save_controlnet

    save_controlnet(random_controlnet(config, device, dtype, seed), config, path)
    return path


def write_image_encoder_folder(path: str, config, device: Union[str, torch.device, None] = None,
                               dtype: torch.dtype = torch.float16, seed: int = 0) -> str:
    """An ``image_encoder`` folder at `path` (``model.safetensors`` in
    `dtype` and config.json) of a CLIP vision tower of `config` with random
    weights from `seed`, read back by ``SDModel.load_image_encoder``.
    Returns `path`."""
    from stablediffusion_tpu_torch.io.loader import save_image_encoder
    from stablediffusion_tpu_torch.models.clip_vision import CLIPVisionModel

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    save_image_encoder(random_module(CLIPVisionModel, config, device, dtype, g), config, path)
    return path


def ip_adapter_state(unet_config: UNetConfig, image_encoder_config, plus: bool = False,
                     num_tokens: int = 4, depth: int = 4, heads: int = 12, dim: int = 768,
                     seed: int = 0, dtype: torch.dtype = torch.float32,
                     std: float = 0.02) -> Dict[str, torch.Tensor]:
    """The flat state of an IP-Adapter checkpoint for a UNet of
    `unet_config` and an image encoder of `image_encoder_config`, random
    from `seed` (CPU): ``image_proj.*`` (the standard projection of the
    projected embed to `num_tokens` tokens, or with `plus` the Resampler:
    `num_tokens` queries of width `dim`, `depth` layers of `heads` heads of
    64, over the encoder's hidden states) and ``ip_adapter.{2i+1}.to_k_ip``
    / ``to_v_ip`` for every cross-attention.  Norm scales are ones, the
    other vectors and matrices normal with std `std`."""
    from stablediffusion_tpu_torch.models.ip_adapter import (
        ImageProjConfig,
        ImageProjModel,
        Resampler,
        cross_attn_paths,
    )

    g = torch.Generator().manual_seed(seed)
    xdim = unet_config.cross_attention_dim
    if plus:
        cfg = ImageProjConfig("resampler", num_tokens, xdim, dim=dim, depth=depth, heads=heads,
                              embedding_dim=image_encoder_config.hidden_size)
        keys = {"proj_in.bias", "proj_out.bias"}
        proj = Resampler(cfg, keys)
    else:
        cfg = ImageProjConfig("proj", num_tokens, xdim)
        proj = ImageProjModel(cfg, image_encoder_config.projection_dim)
    state = {}
    for name, p in proj.state_dict().items():
        is_norm_scale = name.endswith("weight") and p.dim() == 1
        state[f"image_proj.{name}"] = (torch.ones(p.shape) if is_norm_scale
                                       else torch.randn(p.shape, generator=g) * std)
    ch, n = unet_config.block_out_channels, len(unet_config.block_out_channels)
    for i, path in enumerate(cross_attn_paths(unet_config)):
        if path[0] == "mid_block":
            c = ch[-1]
        else:
            c = ch[int(path[1])] if path[0] == "down_blocks" else ch[n - 1 - int(path[1])]
        for name in ("to_k_ip", "to_v_ip"):
            state[f"ip_adapter.{2 * i + 1}.{name}.weight"] = torch.randn(
                c, xdim, generator=g) * std
    return {k: v.to(dtype) for k, v in state.items()}


def write_ip_adapter_file(path: str, unet_config: UNetConfig, image_encoder_config,
                          plus: bool = False, seed: int = 0,
                          dtype: torch.dtype = torch.float16, **kw) -> str:
    """:func:`ip_adapter_state` written as a .safetensors IP-Adapter file at
    `path`, read back by ``SDModel.load_ip_adapter``.  Returns `path`."""
    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

    save_safetensors(ip_adapter_state(unet_config, image_encoder_config, plus=plus, seed=seed,
                                      dtype=dtype, **kw), path)
    return path
