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
from stablediffusion_tpu_torch.ops.attention import _row_dot
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer

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
# from the running max m of its 64-key tiles.  Its plain version is therefore
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
                        causal: bool = False, block: int = 64,
                        scale: Optional[float] = None, rescale: bool = True,
                        acc_dtype: torch.dtype = torch.float32):
    """The plain version of the bf16 flash_fwd, in fp32 on q/k/v's device:
    online softmax over key tiles of `block`; each p = exp(s - m), m the
    running max, is rounded to bf16 for its product with v, and the
    denominator l sums the fp32 p.  Returns (out, flips), both fp32
    [B, Sq, H, D]; flips is the sum of p |v| / l over the p within
    :data:`P_EPS` of a bf16 rounding midpoint (see :func:`kernel_error`).
    Wrong kernels, to show that the rule has teeth: `rescale=False` never
    rescales the accumulator when the running max grows (l still is);
    `acc_dtype=torch.bfloat16` keeps the accumulator in bf16 between tiles."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
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
                             causal: bool = False, block: int = 64) -> dict:
    """Three wrong bf16 attention forwards, each rounded to q's dtype as a
    kernel rounds its output: "no_rescale" (the accumulator is not rescaled
    when the running max grows), "scale_twice" (the logits scaled by
    scale**2) and "acc_bf16" (the accumulator kept in bf16 between tiles of
    `block` keys); all otherwise :func:`attention_p_rounded`."""
    scale = q.shape[-1] ** -0.5
    variants = {"no_rescale": dict(rescale=False), "scale_twice": dict(scale=scale * scale),
                "acc_bf16": dict(acc_dtype=torch.bfloat16)}
    return {n: attention_p_rounded(q, k, v, causal, block, **kw)[0].to(q.dtype)
            for n, kw in variants.items()}


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
