"""How the tensor core's truncating fp32 adds in the 3xTF32 attention kernels
reach a training step's gradients, on the CPU:

    python3 -m stablediffusion_tpu_torch.utils.tf32_accumulation [VARIANT ...]

Runs chip_smoke.py's narrow fp32 train step (an SD1.5-layout UNet of two
levels, LoRA on its attention, the same seeds; ``phase_train_reference``)
on the CPU twice: with the plain attention, and with every unmasked
attention replaced by an emulation of the 3xTF32 kernels' arithmetic, and
prints the largest difference of the loss and of each LoRA gradient relative
to that tensor's largest element, the quantity that phase holds to 1e-3
(``TRAIN_REF_TOL``).

The emulation splits every operand into TF32 hi and lo parts and adds each
wgmma's product (hi*hi, hi*lo, lo*hi over 8 head dims, keys or query rows,
exact) to an fp32 accumulator, rounding each sum toward zero where a VARIANT
says so, as Hopper's tensor cores do; parts are added by the FPU, rounding
to nearest.  A VARIANT is "FWD" or "FWD/BWD".  FWD is "s,pv,keys,order"
(flash_fwd): s and pv are 1 where q k^T and p v truncate (0: round to
nearest), keys is the keys one part of p v adds (64, 32, 16 or 8) and order
is "kstep" (each k-step's three products in turn) or "small" (every hi*lo
and lo*hi of a part before its hi*hi).  BWD is "s,dp,grads,rows,order"
(flash_bwd_dkv and flash_bwd_dq): s and dp say how s = q k^T and dp = dO
v^T add over the head dims in k-step order (0: one accumulator rounding to
nearest; 1: one truncating accumulator; 8, 16 or 32: a truncating
accumulator for each part of that many head dims, the parts added by the
FPU); grads is 1 where the gradients' products (p^T dO, ds^T q, ds k)
truncate, rows the query rows (dV, dK) or keys (dQ) one part of a
gradient's product adds within a 64-row tile (64, 32, 16 or 8), and order
as above, for the gradients' products.  With no BWD the backward is
``ops/attention.flash_bwd_plain`` on the emulated output and lse.  With no
VARIANT it runs DEFAULT_VARIANTS: the forward as flash_fwd adds, with the
backward as the kernels add (KERNEL_BWD_VARIANT) and with dp in one
accumulator.  Each variant takes a few minutes on a few cores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.ops import attention as attn_ops
from stablediffusion_tpu_torch.utils.testing import tf32_split

# how csrc/flash_bwd.cu's fp32 kernels add: s in one accumulator, dp one a
# k-step, each gradient's products one a 64-row tile, in k-step order
KERNEL_BWD_VARIANT = "1,8,1,64,kstep"
DEFAULT_VARIANTS = ("1,1,32,small/" + KERNEL_BWD_VARIANT, "1,1,32,small/1,1,1,64,kstep")
TILE = 64  # keys (forward, dq) or query rows (dkv) of one tile of the kernels


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 `x` to fp32, rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def tc_product(a: torch.Tensor, b: torch.Tensor, truncate: bool,
               small_first: bool = False) -> torch.Tensor:
    """a @ b (fp32) in 3xTF32 on the emulated tensor core: k-steps of 8
    along a's last dimension, each of the products hi*hi, hi*lo, lo*hi of a
    k-step exact and added to one fp32 accumulator, the sum rounded toward
    zero when `truncate` (else to nearest); with `small_first` every hi*lo
    and lo*hi before any hi*hi."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    pairs = ((ah, bh), (ah, bl), (al, bh))
    steps = [(k0, i) for k0 in range(0, a.shape[-1], 8) for i in range(3)]
    if small_first:
        steps = [s for s in steps if s[1] > 0] + [s for s in steps if s[1] == 0]
    acc = None
    for k0, i in steps:
        x, y = pairs[i]
        d = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
        total = d if acc is None else acc.double() + d
        acc = round_toward_zero(total) if truncate else total.float()
    return acc


def parts_product(a: torch.Tensor, b: torch.Tensor, rows: int, truncate: bool,
                  small_first: bool) -> torch.Tensor:
    """a @ b with a's last dimension cut into parts of `rows` (within tiles
    of TILE, as the kernels' tiles start at 0): each part's product on the
    emulated tensor core (:func:`tc_product`), the parts added by the FPU in
    order, rounding to nearest."""
    out = None
    for c0 in range(0, a.shape[-1], rows):
        part = tc_product(a[..., c0:c0 + rows], b[..., c0:c0 + rows, :], truncate, small_first)
        out = part if out is None else out + part
    return out


@dataclasses.dataclass(frozen=True)
class BwdVariant:
    s_part: int  # head dims one part of s adds: 0 round to nearest, 1 all of them
    dp_part: int  # the same for dp
    grads_truncate: bool
    rows: int
    small_first: bool

    @classmethod
    def parse(cls, text: str) -> "BwdVariant":
        s, dp, grads, rows, order = text.split(",")
        if (order not in ("kstep", "small") or int(rows) not in (8, 16, 32, 64)
                or not {s, dp} <= {"0", "1", "8", "16", "32"}):
            raise ValueError(f"backward variant {text!r}: want s,dp,grads,rows,order "
                             "(s, dp 0, 1, 8, 16 or 32; rows 8-64, order kstep or small)")
        return cls(int(s), int(dp), grads == "1", int(rows), order == "small")


@dataclasses.dataclass(frozen=True)
class Variant:
    s_truncates: bool
    pv_truncates: bool
    pv_keys: int
    small_first: bool
    bwd: Optional[BwdVariant] = None

    @classmethod
    def parse(cls, text: str) -> "Variant":
        fwd, _, bwd = text.partition("/")
        s, pv, keys, order = fwd.split(",")
        if order not in ("kstep", "small") or int(keys) not in (8, 16, 32, 64):
            raise ValueError(f"variant {text!r}: want s,pv,keys,order (keys 8-64, "
                             "order kstep or small)")
        return cls(s == "1", pv == "1", int(keys), order == "small",
                   BwdVariant.parse(bwd) if bwd else None)


def attention_tc(q, k, v, scale: float, causal: bool, variant: Variant):
    """(out [B, Sq, H, D] fp32, lse [B, H, Sq]) of the emulated kernel: s =
    q k^T on the tensor core, online softmax over 64-key tiles, each tile's
    p v in parts of `variant.pv_keys` keys added into o by the FPU."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    B, H, Sq, D = qf.shape
    Skv = kf.shape[2]
    s = tc_product(qf, kf.transpose(-1, -2), variant.s_truncates) * scale
    if causal:
        keep = torch.ones(Sq, Skv, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -1e30)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Skv, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha
        for c0 in range(0, p.shape[-1], variant.pv_keys):
            c1 = c0 + variant.pv_keys
            o = o + tc_product(p[..., c0:c1], vf[:, :, k0 + c0:k0 + c1],
                               variant.pv_truncates, variant.small_first)
        m = m_new
    return (o / l).transpose(1, 2).contiguous(), (m + torch.log(l))[..., 0]


def attention_bwd_tc(q, k, v, o, do, lse, scale: float, causal: bool, variant: BwdVariant):
    """(dq, dk, dv) [B, S, H, D] fp32 of the emulated fp32 backward kernels:
    s = q k^T and dp = dO v^T on the tensor core in k-step order over the
    head dims, p = exp(scale s - lse) (0 past the diagonal when `causal`),
    ds = p (dp - di) with di = rowsum(o dO) in fp32; dV = p^T dO and dK =
    scale ds^T q over the query rows, dQ = scale ds k over the keys, each in
    parts of `variant.rows` added by the FPU, the scale applied to the sum."""
    di = attn_ops._row_dot(o, do)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, D]
    Sq, Skv = qf.shape[2], kf.shape[2]
    def headdim(a, b, part):
        if part <= 1:
            return tc_product(a, b, part == 1)
        return parts_product(a, b, part, True, False)

    s = headdim(qf, kf.transpose(-1, -2), variant.s_part)
    p = torch.exp(s * scale - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~torch.ones(Sq, Skv, dtype=torch.bool).tril(), 0.0)
    ds = p * (headdim(dof, vf.transpose(-1, -2), variant.dp_part) - di[..., None])
    grad = lambda a, b: parts_product(a, b, variant.rows, variant.grads_truncate,  # noqa: E731
                                      variant.small_first)
    dv = grad(p.transpose(-1, -2), dof)
    dk = grad(ds.transpose(-1, -2), qf) * scale
    dq = grad(ds, kf) * scale
    return tuple(t.transpose(1, 2).contiguous() for t in (dq, dk, dv))


class _TcAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, variant):
        out, lse = attention_tc(q, k, v, scale, causal, variant)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.variant = scale, causal, variant
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.variant.bwd is None:
            dq, dk, dv = attn_ops.flash_bwd_plain(q, k, v, out, do, lse, ctx.scale, ctx.causal)
        else:
            dq, dk, dv = attention_bwd_tc(q, k, v, out, do, lse, ctx.scale, ctx.causal,
                                          ctx.variant.bwd)
        return dq, dk, dv, None, None, None


@contextlib.contextmanager
def emulated_attention(variant: Variant):
    """Every unmasked attention of the UNet, CLIP and the VAE through the
    emulated kernel while the context is open."""
    from stablediffusion_tpu_torch.models import clip, unet, vae

    plain = attn_ops.attention

    def attention(q, k, v, mask=None, scale=None, causal=False):
        if mask is not None:
            return plain(q, k, v, mask=mask, scale=scale, causal=causal)
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return _TcAttention.apply(q, k, v, float(scale), bool(causal), variant)

    modules = (clip, unet, vae)
    for mod in modules:
        mod.attention = attention
    try:
        yield
    finally:
        for mod in modules:
            mod.attention = plain


def train_reference_grads():
    """(names, [loss, every LoRA gradient]) of chip_smoke.py phase 8's
    narrow fp32 train step on the CPU, with its weights, LoRA and draws."""
    from stablediffusion_tpu_torch.core.config import (
        SD15_TEXT_ENCODER,
        SD15_UNET,
        SchedulerConfig,
        VAEConfig,
    )
    from stablediffusion_tpu_torch.lora.core import UNET_TARGET_SUFFIXES, init_lora
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.train.train_step import TrainStatics, loss_fn
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        SD15_UNET, sample_size=16, block_out_channels=(320, 640),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1)
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    model = random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device="cpu",
                         dtype=torch.float32, seed=3)
    statics = TrainStatics(unet_config=ucfg, vae_config=vcfg, text_config=tcfg,
                           text_config_2=None, scheduler_config=SchedulerConfig(),
                           train_text_encoder=False, snr_gamma=5.0, compute_dtype=torch.float32)
    r = np.random.default_rng(11)
    batch = {"pixel_values": torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(r.integers(0, 49407, (2, 77)))}
    draws = {"latent_eps": torch.from_numpy(r.standard_normal((2, 4, 16, 16)).astype(np.float32)),
             "noise": torch.from_numpy(r.standard_normal((2, 4, 16, 16)).astype(np.float32)),
             "timesteps": torch.from_numpy(np.array([17, 630]))}
    lora = init_lora(model.unet, 4, UNET_TARGET_SUFFIXES, torch.Generator().manual_seed(5),
                     store_alpha=False)
    for f in lora.values():
        f["up"] = torch.from_numpy(r.standard_normal(tuple(f["up"].shape)).astype(np.float32) * 0.05)
    mods = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
    trainable = {"unet": lora}
    named = tree_leaves(trainable)
    leaves = [t.requires_grad_(True) for _, t in named]
    loss = loss_fn(trainable, mods, batch, None, statics, DDPMScheduler(), draws=draws)
    grads = torch.autograd.grad(loss, leaves)
    return ["loss"] + [n for n, _ in named], [loss.detach()] + list(grads)


def main(argv=None) -> None:
    texts = list(sys.argv[1:] if argv is None else argv) or list(DEFAULT_VARIANTS)
    variants = [Variant.parse(t) for t in texts]
    names, ref = train_reference_grads()
    for text, variant in zip(texts, variants):
        with emulated_attention(variant):
            _, got = train_reference_grads()
        errs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(got, ref)]
        worst = int(np.argmax(errs))
        print(json.dumps({"variant": text, "worst_rel_err": errs[worst],
                          "at": names[worst], "tol_of_phase_8": 1e-3}), flush=True)


if __name__ == "__main__":
    main()
