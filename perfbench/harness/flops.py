"""The yardstick's arithmetic: the work a configuration's shapes imply, the
card's peaks, and each attention call's roofline bound.  Nothing here reads
the program: FLOPs come from the plain reference run on the meta device under
``FlopCounterMode``, with each attention counted by formula.

Frozen copies, so that a change to the program cannot move the yardstick:
  * the peak table of ``stablediffusion_tpu_torch/utils/bench_utils.py``
    (``_PEAK_BY_NAME``, the bf16 dense rates) as of the benchmark's first
    version, with the TF32 rate of the H100 SXM beside it;
  * the bound arithmetic of the kernel table in ``PERF.md``: the larger of
    the products over the peak of the input dtype and the bytes over 3.35 TB/s,
    each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

from perfbench.reference import models
from perfbench.reference import shapes as shape_specs

BF16_PEAK = {"H100 80GB HBM3": 989.4e12, "H100 SXM": 989.4e12, "H100 NVL": 835e12,
             "H100 PCIe": 756e12}
# dense TF32 tensor-core rate: the highest the card reaches on fp32 inputs
TF32_PEAK = {"H100 80GB HBM3": 494.7e12, "H100 SXM": 494.7e12, "H100 NVL": 417.5e12,
             "H100 PCIe": 378e12}
HBM_BYTES_PER_S = 3.35e12


def _lookup(table: Dict[str, float], device_name: str) -> float:
    for k, v in sorted(table.items(), key=lambda kv: -len(kv[0])):
        if k in device_name:
            return v
    raise KeyError(f"no peak for {device_name!r}")


def peak(device_name: str, dtype: torch.dtype = torch.bfloat16) -> float:
    return _lookup(TF32_PEAK if dtype == torch.float32 else BF16_PEAK, device_name)


@dataclass(frozen=True)
class AttnCall:
    """One attention call: q [B, Sq, H, D], k/v [B, Skv, H, D]."""
    B: int
    Sq: int
    Skv: int
    H: int
    D: int
    causal: bool
    dtype: torch.dtype
    backward: bool = False

    @property
    def pairs(self) -> int:
        if not self.causal:
            return self.Sq * self.Skv
        # query i sees keys j <= i (the query rows aligned to the last keys
        # when Sq < Skv)
        off = self.Skv - self.Sq
        return sum(min(self.Skv, i + 1 + off) for i in range(self.Sq))

    @property
    def flops(self) -> float:
        """Forward 4·B·H·pairs·D (q·kᵀ and p·v); backward 8·B·H·pairs·D
        (dV, dP, dS·K and dSᵀ·Q), no recompute counted."""
        return (8 if self.backward else 4) * self.B * self.H * self.pairs * self.D

    @property
    def bytes(self) -> float:
        size = torch.finfo(self.dtype).bits // 8
        q, kv = self.B * self.Sq * self.H * self.D, self.B * self.Skv * self.H * self.D
        if self.backward:  # read q, k, v, o, do; write dq, dk, dv
            return size * (3 * q + 2 * kv + 2 * kv + q)
        return size * (q + 2 * kv + q)

    def bound_s(self, device_name: str) -> float:
        return max(self.flops / peak(device_name, self.dtype), self.bytes / HBM_BYTES_PER_S)


class Recorder:
    """An attention for the reference graph on the meta device: records each
    call (and, under autograd, its backward) and returns an empty output of
    its shape."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.calls: List[AttnCall] = []

    def __call__(self, q, k, v, causal: bool = False):
        B, Sq, H, D = q.shape
        call = AttnCall(B, Sq, k.shape[1], H, D, causal, self.dtype)
        self.calls.append(call)
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
            return torch.empty_like(q)
        return _Recorded.apply(q, k, v, self, call)


class _Recorded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, recorder, call):
        ctx.recorder, ctx.call = recorder, call
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, grad):
        c = ctx.call
        ctx.recorder.calls.append(AttnCall(c.B, c.Sq, c.Skv, c.H, c.D, c.causal, c.dtype, True))
        return torch.empty_like(grad), torch.empty(c.B, c.Skv, c.H, c.D, device=grad.device), \
            torch.empty(c.B, c.Skv, c.H, c.D, device=grad.device), None, None


def _meta(shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def _count(fn: Callable[[], object]) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@dataclass
class RequestWork:
    """The work one merged txt2img call of `batch` rows implies."""
    flops: float
    attention: List[AttnCall]


def _work(dtype: torch.dtype, fn: Callable) -> RequestWork:
    """FLOPs of `fn(attention)` on the meta device (products under the
    counter, attention by formula) and its attention calls."""
    rec = Recorder(dtype)
    flops = _count(lambda: fn(rec))
    return RequestWork(flops + math.fsum(c.flops for c in rec.calls), rec.calls)


def txt2img_work(spec: dict, served: Dict[str, torch.dtype], batch: int, size: int,
                 steps: int) -> RequestWork:
    """The products of one merged txt2img call of `batch` requests (both
    halves of the prompt encode, the UNet under CFG at every step, the
    decode) and its attention calls, from the configuration's shapes."""
    comps = spec["components"]
    ucfg, vcfg = comps["unet"], comps["vae"]
    lat = size // 2 ** (len(vcfg["block_out_channels"]) - 1)
    parts = []  # (work, times)
    towers = [c for c in ("text_encoder", "text_encoder_2") if c in comps]
    ids = torch.zeros(batch, 77, dtype=torch.long, device="meta")
    for comp in towers:
        p = _meta(shape_specs.clip_text(comps[comp]))
        # the prompts, then the negatives
        parts.append((_work(served[comp], lambda a: models.clip_text(p, comps[comp], ids, a)), 2))
    up = _meta(shape_specs.unet(ucfg))
    x = torch.empty(2 * batch, ucfg.get("in_channels", 4), lat, lat, device="meta")
    t = torch.zeros(2 * batch, device="meta")
    ctx = torch.empty(2 * batch, 77, sum(comps[c]["hidden_size"] for c in towers), device="meta")
    added = None
    if ucfg.get("addition_embed_type") == "text_time":
        added = {"text_embeds": torch.empty(2 * batch, comps["text_encoder_2"]["projection_dim"],
                                            device="meta"),
                 "time_ids": torch.empty(2 * batch, 6, device="meta")}
    parts.append((_work(served["unet"], lambda a: models.unet(up, ucfg, x, t, ctx, added, a)), steps))
    vp = _meta(shape_specs.vae(vcfg))
    z = torch.empty(batch, vcfg.get("latent_channels", 4), lat, lat, device="meta")
    # the decode computes in float32 (force_upcast) whatever its weights' dtype
    parts.append((_work(torch.float32, lambda a: models.vae_decode(vp, vcfg, z, a)), 1))
    return RequestWork(math.fsum(w.flops * n for w, n in parts),
                       [c for w, n in parts for _ in range(n) for c in w.attention])


def lora_train_work(spec: dict, served: Dict[str, torch.dtype], batch: int, size: int,
                    rank: int, vae_microbatch: int) -> RequestWork:
    """The products of one UNet-LoRA train step of `batch` rows (the prompt
    encode; the VAE encode in blocks of `vae_microbatch` rows where that
    divides the batch; the UNet's forward and its backward to the factors
    of its attention projections) and its attention calls, forward and
    backward, from the configuration's shapes."""
    from perfbench.reference import train as ref_train

    comps = spec["components"]
    ucfg, vcfg = comps["unet"], comps["vae"]
    lat = size // 2 ** (len(vcfg["block_out_channels"]) - 1)
    parts = []
    ids = torch.zeros(batch, 77, dtype=torch.long, device="meta")
    tp = _meta(shape_specs.clip_text(comps["text_encoder"]))
    parts.append((_work(served["text_encoder"],
                        lambda a: models.clip_text(tp, comps["text_encoder"], ids, a)), 1))
    vp = _meta(shape_specs.vae(vcfg))
    mb = vae_microbatch if vae_microbatch and batch > vae_microbatch and batch % vae_microbatch == 0 else batch
    img = torch.empty(mb, 3, size, size, device="meta")
    # the encode computes in float32 whatever its weights' dtype
    parts.append((_work(torch.float32, lambda a: models.vae_encode(vp, vcfg, img, a)), batch // mb))
    shapes = shape_specs.unet(ucfg)
    up = _meta(shapes)
    factors = {}
    for p in ref_train.lora_paths(shapes):
        n_out, n_in = shapes[p + ".weight"]
        factors[p + ".down"] = torch.empty(n_in, rank, device="meta", requires_grad=True)
        factors[p + ".up"] = torch.empty(rank, n_out, device="meta", requires_grad=True)
    x = torch.empty(batch, ucfg.get("in_channels", 4), lat, lat, device="meta")
    t = torch.zeros(batch, device="meta")
    ctx = torch.empty(batch, 77, comps["text_encoder"]["hidden_size"], device="meta")

    def unet_step(a):
        out = models.unet(ref_train.adapted(up, factors), ucfg, x, t, ctx, None, a)
        torch.autograd.grad(out.float().pow(2).mean(), list(factors.values()))

    parts.append((_work(served["unet"], unet_step), 1))
    return RequestWork(math.fsum(w.flops * n for w, n in parts),
                       [c for w, n in parts for _ in range(n) for c in w.attention])


def attention_bound_s(calls: List[AttnCall], device_name: str) -> float:
    return math.fsum(c.bound_s(device_name) for c in calls)
