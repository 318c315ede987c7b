"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, nothing caught):

1. Card and build: print the card's name and power limit, build the three
   CUDA sources of ``stablediffusion_tpu_torch/csrc`` (one nvcc each, all
   started together), print each kernel's registers and spilled bytes
   (``-Xptxas -v``; a spill in ``flash_bwd.cu`` fails the run), set and
   print the TF32 switches.
2. txt2img main path: the full-width SD1.5 model with random weights answers
   three 512x512, 20-step DDIM, CFG 7.5 requests through the pipeline call
   (batch 1, batch 1 with another seed, a two-prompt batch).  Outputs must be
   finite and of the right shape, and the kernels' launch counts must equal
   what the path implies (no forward writes an lse there).  The wrappers
   also count their launches by call shape, which gives phase 3 its cases.
3. Forward kernels against their plain versions: every call shape the main
   path launched, the UNet's also at B=16 (batch 8 under CFG), and a ragged
   VAE length, each in fp32 and bf16, against the plain version evaluated in
   fp32 on the same inputs under the per-element limit of
   ``utils/testing.KERNEL_TOL`` (the bf16 ``flash_fwd``, which rounds p to
   bf16, against ``attention_p_rounded``, the same 64-key online softmax with
   the same rounding, plus ``P_FLIP_RTOL`` times its p near a rounding
   midpoint); at [2,4096,8,40] bf16 three wrong forwards (no accumulator
   rescale, the scale applied twice, the accumulator kept in bf16 between
   tiles) must break that limit.  Each kernel's device time (its own kernel events under
   torch.profiler; the event-timed call, which includes the wrapper's host
   work, beside it), the plain version's and one library call's
   (``F.scaled_dot_product_attention``, a yardstick the port never calls)
   beside the card's bound.
4. Full width in bf16: one UNet forward at B=2 on the main path's weights,
   through the kernels and through the plain attention, each against an fp32
   copy with the plain attention.  The random weights' biases are ones, which
   makes the main path's images almost the same for every prompt and seed, so
   phase 2 alone would not see a wrong kernel output.
5. Reference check: a narrow model (two UNet levels at the SD1.5 head dims
   40/80, a 2-layer CLIP-L, a VAE whose mid-block takes flash_stream) runs
   the pipeline on the card and on the CPU (plain attention) in fp32 with the
   same weights and injected latents; latents and pixels must agree.
6. Where the time goes: one more batch-1 request under torch.profiler;
   device time by kernel group and the device's busy share.
7. Training main path: ``make_train_step`` on the full-width SD1.5 model at
   512x512, batch 8, rank-16 LoRA on the UNet's attention projections,
   Min-SNR 5, AdamW, bf16 UNet, fp32 VAE encode; one warm step and three
   timed ones.  Loss and grad norm finite, every LoRA ``up`` factor moved by
   step 1 (a non-zero gradient), and exact launches per step: 32
   ``flash_fwd`` with lse, 12 causal ``flash_fwd`` without for CLIP, 32 of
   each backward kernel, 1 ``flash_stream`` (the VAE encoder).  Step wall
   time, images/s and peak memory, then one step under torch.profiler.
8. Backward kernels against their plain version: every (shape, dtype,
   causal) the train path launched, each also in the other dtype, CLIP's
   causal shape and a ragged Sq; ``flash_bwd_dq`` and ``flash_bwd_dkv``
   evaluated per element under ``utils/testing.GRAD_TOL``: in bf16 against
   ``attention_bwd_rounded`` (p and ds rounded to bf16 where the kernels and
   the JAX library round them) plus ``P_FLIP_RTOL`` times its flip term, in
   fp32 against ``flash_bwd_plain``; the forward's lse against
   ``attention_plain_lse``; at [8,4096,8,40] bf16 four wrong backwards (di
   = 0, dK/dV kept in bf16 between query tiles, ds unscaled, p from the row
   max) must break the rule; kernel, plain and SDPA-backward times beside
   the bound.
9. Train reference: a narrow SD1.5-layout model, card against CPU, fp32:
   loss and every LoRA gradient of one ``loss_fn`` + backward.

Prints one JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import subprocess
import sys
import time

PEAK_FLOPS = {
    "bfloat16": 989e12,  # H100 SXM dense bf16 tensor-core rate
    # fp32-exact attention cannot use TF32 tensor cores: the H100 SXM's
    # fp32 rate outside the tensor cores
    "float32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12
# reference check: card (kernels) vs CPU (plain) in fp32 with TF32 off; the
# sums run in other orders through 4 DDIM steps of the UNet
REF_TOL = 1e-3
# full-width bf16 UNet: both paths round the probabilities to bf16 for the
# product with v (the kernel from its fp32 running max, the plain path after
# the softmax), so the kernels' path should lie as far from the fp32 model
# as the plain one; 25% covers the other bf16 roundings, which differ
UNET_SLACK = 1.25
# the training main path: batch 8 as benchmarks/bench_train.py (it fits the
# card without checkpointing the UNet), one warm step and this many timed ones
TRAIN_BATCH = 8
TRAIN_STEPS = 3
# train reference: loss and LoRA gradients, card (kernels) vs CPU (plain),
# fp32 with TF32 off, relative to each tensor's largest element
TRAIN_REF_TOL = 1e-3
# exponentials a clock on one SM of an H100 SXM: 16 on the MUFU, plus the
# 128 FMA lanes at 4 FMA-pipe operations each for a polynomial exp2 (range
# reduction and three Horner steps, as FlashAttention-4 emulates it); and
# the card's SMs
MUFU_PER_CLOCK = 16
FMA_EXP_PER_CLOCK = 128 / 4
SMS = 132


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, key: str, reps: int) -> float:
    """Mean device time of one launch of the CUDA kernel whose name holds
    `key` (each wrapper launches it once a call), from torch.profiler's
    kernel events over `reps` calls after one warm-up: the kernel's own
    time, without the wrapper's host work.  The mean is over the events
    the profiler kept: late in a long run it drops some, and a profiling
    run that kept none is repeated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and key in e.name]
        if us:
            return sum(us) / 1e3 / len(us)
    raise AssertionError(f"the profiler saw no kernel named like {key!r}")


@functools.lru_cache(maxsize=None)
def _sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def _pairs(Sq, Skv, causal):
    """(query, key) pairs a call computes: a causal call only j <= i."""
    return sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv


def _roofline(flops, nbytes, dtype, exps=0):
    """(least ms on the card, what bounds it, each term in ms): the largest
    of products / peak, exponentials on the MUFU and the FMA lanes together
    / (SMs x their rate x the max SM clock), and bytes / HBM rate; products
    and exponentials are both "operations".  Each term alone is a floor, so
    their maximum is one.  ``exp_mufu`` (every exponential on the MUFU, as
    the port's kernels compute them) is reported beside, not part of the
    bound."""
    clock = SMS * _sm_clock_hz()
    terms = {"products": flops / PEAK_FLOPS[dtype] * 1e3,
             "exp": exps / (clock * (MUFU_PER_CLOCK + FMA_EXP_PER_CLOCK)) * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    bound = max(terms.values())
    terms["exp_mufu"] = exps / (clock * MUFU_PER_CLOCK) * 1e3
    return bound, ("bytes" if bound == terms["bytes"] else "operations"), terms


def _bound(B, Sq, H, D, Skv, causal, dtype, itemsize):
    """The forward's bound: 4 operations per pair and head dim and one
    exponential per pair; q, k, v read once, out written once."""
    pairs = B * H * _pairs(Sq, Skv, causal)
    return _roofline(4 * pairs * D, itemsize * B * H * D * (2 * Sq + 2 * Skv), dtype,
                     exps=pairs)


def _bwd_bound(kernel, B, Sq, H, D, Skv, causal, dtype, itemsize):
    """A backward kernel's bound on its own function.  dkv: s, dp, dV, dK,
    8 operations per pair and head dim; reads q, k, v, dO, lse, di, writes
    dK, dV.  dq: s, dp, dQ, 6 per pair; reads the same, writes dQ.  (The
    pair together could do with 10: s and dp once.)  Each kernel recomputes
    p = exp(s - lse): one exponential per pair."""
    dkv = kernel == "flash_bwd_dkv"
    pairs = B * H * _pairs(Sq, Skv, causal)
    rows = 2 * Sq + 2 * Skv + (2 * Skv if dkv else Sq)
    return _roofline((8 if dkv else 6) * pairs * D,
                     itemsize * B * H * D * rows + 2 * 4 * B * H * Sq, dtype, exps=pairs)


def kernel_case(name, kernel, plain, B, Sq, H, D, Skv, dtype, causal,
                launches, launches_batch1):
    import torch
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.utils.testing import (
        attention_p_rounded,
        attention_wrong_variants,
        kernel_error,
    )

    g = torch.Generator(device="cuda").manual_seed(1234)
    q = torch.randn(B, Sq, H, D, device="cuda", dtype=dtype, generator=g)
    k = torch.randn(B, Skv, H, D, device="cuda", dtype=dtype, generator=g)
    v = torch.randn(B, Skv, H, D, device="cuda", dtype=dtype, generator=g)
    kw = {"causal": True} if causal else {}
    out = kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    # the plain version in fp32 on the same input values; the bf16 flash_fwd
    # rounds p to bf16 from the running max of its 64-key tiles, and its
    # plain version does the same
    dname = str(dtype).replace("torch.", "")
    if (name, dname) == ("flash_fwd", "bfloat16"):
        ref, flips = attention_p_rounded(q, k, v, causal)
    else:
        ref, flips = plain(q.float(), k.float(), v.float(), **kw), None
    err = kernel_error(out, ref, flips)
    teeth = None
    if (name, B, Sq, H, D, Skv, dname) == ("flash_fwd", 2, 4096, 8, 40, 4096, "bfloat16"):
        teeth = {n: kernel_error(w, ref, flips)["worst_over_limit"]
                 for n, w in attention_wrong_variants(q, k, v, causal).items()}
        print(json.dumps({"p_round_rule_teeth": "wrong bf16 forwards against "
                          "attention_p_rounded", "shape": [B, Sq, H, D], "skv": Skv,
                          "worst_over_limit": teeth}), flush=True)
    del ref, flips
    big = B * Sq * Skv * H >= 2**31  # plain logits of 8 GiB and up
    ms = _device_ms(lambda: kernel(q, k, v, **kw), name, 10)
    event_ms = _time_ms(lambda: kernel(q, k, v, **kw), 10)
    plain_ms = _time_ms(lambda: plain(q, k, v, **kw), 2 if big else 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 10
    )
    bound_ms, bound_by, terms = _bound(B, Sq, H, D, Skv, causal, dname, q.element_size())
    row = dict(kernel=name, shape=[B, Sq, H, D], skv=Skv, dtype=dname,
               causal=causal, launches=launches, launches_batch1=launches_batch1,
               **err, kernel_ms=ms, event_ms=event_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_terms_ms=terms)
    print(json.dumps(row), flush=True)
    if not err["worst_over_limit"] <= 1.0:
        raise AssertionError(f"{name} {row['shape']} Skv={Skv} {dname}: max abs err "
                             f"{err['max_abs_err']}, {err['worst_over_limit']} x its limit")
    if teeth is not None and not min(teeth.values()) > 1.0:
        raise AssertionError(f"the bf16 limit accepts a wrong forward: {teeth}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return row


def _cases(by_shape):
    """Every (kernel, B, Sq, H, D, Skv, causal) the main path launched, the
    UNet's (flash_fwd, not causal) at batch 1 also at B=16, and a ragged VAE
    length."""
    cases = set()
    for name, shapes in by_shape.items():
        for (qs, skv, _dtype, causal, _lse) in shapes:
            cases.add((name, *qs, skv, causal))
            if name == "flash_fwd" and not causal and qs[0] == 2:
                cases.add((name, 16, *qs[1:], skv, causal))
    cases.add(("flash_stream", 1, 4096, 1, 512, 4100, False))
    return sorted(cases)


def phase_kernels(by_shape, by_shape_batch1):
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import (
        flash_stream,
        flash_stream_plain,
    )

    fns = {"flash_fwd": (flash_fwd, attention_plain),
           "flash_stream": (flash_stream, flash_stream_plain)}
    rows = []
    for (name, B, Sq, H, D, Skv, causal) in _cases(by_shape):
        for dtype in (torch.bfloat16, torch.float32):
            key = ((B, Sq, H, D), Skv, str(dtype).replace("torch.", ""), causal, False)
            rows.append(kernel_case(
                name, *fns[name], B, Sq, H, D, Skv, dtype, causal,
                by_shape[name].get(key, 0), by_shape_batch1[name].get(key, 0)))
    for name in fns:
        per_request = sum(r["launches_batch1"] for r in rows if r["kernel"] == name)
        print(f"{name}: {sum(r['kernel'] == name for r in rows)} cases; launches of "
              f"the batch-1 request summed over them: {per_request}", flush=True)
    return rows


def _count_blocks(model):
    from stablediffusion_tpu_torch.models.unet import BasicTransformerBlock
    from stablediffusion_tpu_torch.models.vae import VAEAttention

    n_tf = sum(isinstance(m, BasicTransformerBlock) for m in model.unet.modules())
    n_vae = sum(isinstance(m, VAEAttention) for m in model.vae.decoder.modules())
    return n_tf, n_vae


def phase_reference():
    """Narrow model, card vs CPU, fp32, same weights and latents."""
    import dataclasses

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.core.config import (
        SD15_TEXT_ENCODER,
        SD15_UNET,
        VAEConfig,
    )
    from stablediffusion_tpu_torch.models.wrapper import SDModel
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import (
        StableDiffusionUnifiedPipeline,
    )
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        SD15_UNET, sample_size=16, block_out_channels=(320, 640),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1,
    )
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    cpu = random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device="cpu",
                       dtype=torch.float32, seed=3)
    gpu = SDModel(
        unet_config=ucfg, unet=copy.deepcopy(cpu.unet).cuda(),
        vae_config=vcfg, vae=copy.deepcopy(cpu.vae).cuda(),
        text_encoder_config=tcfg, text_encoder=copy.deepcopy(cpu.text_encoder).cuda(),
        tokenizer=cpu.tokenizer,
    )
    lat = np.random.default_rng(7).standard_normal((1, 16, 16, 4)).astype(np.float32)
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        pipe = StableDiffusionUnifiedPipeline(device=dev, dtype=torch.float32)
        common = dict(prompt="a small red house", num_inference_steps=4,
                      guidance_scale=7.5, latents=torch.from_numpy(lat))
        f0, s0 = FLASH_FWD_LAUNCHES.count, FLASH_STREAM_LAUNCHES.count
        latents = pipe(model, output_type="latents", **common).latents
        images = pipe(model, output_type="np", **common).images
        outs[name] = (latents.float().cpu().numpy(), images)
        if dev == "cuda" and (FLASH_FWD_LAUNCHES.count == f0
                              or FLASH_STREAM_LAUNCHES.count == s0):
            raise AssertionError("reference run on the card launched no kernel")
    lat_err = float(np.abs(outs["cpu"][0] - outs["cuda"][0]).max())
    img_err = float(np.abs(outs["cpu"][1] - outs["cuda"][1]).max())
    print(json.dumps({"reference": "narrow SD1.5 layout, card vs CPU, fp32",
                      "latents_max_abs_err": lat_err,
                      "images_max_abs_err": img_err, "tol": REF_TOL}), flush=True)
    if not (lat_err <= REF_TOL and img_err <= REF_TOL):
        raise AssertionError(f"card disagrees with CPU: {lat_err}, {img_err}")


def phase_main_path():
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import (
        StableDiffusionUnifiedPipeline,
    )
    from stablediffusion_tpu_torch.utils.testing import random_full_model

    t0 = time.perf_counter()
    model = random_full_model("sd15", device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"full-width SD1.5 random model built in {time.perf_counter() - t0:.3f} s",
          flush=True)
    pipe = StableDiffusionUnifiedPipeline(device="cuda")
    steps = 20
    n_tf, n_vae = _count_blocks(model)
    n_clip = model.text_encoder_config.num_hidden_layers
    # per request: one CLIP encode each for the prompts and the negatives
    # (one launch per layer each), two attentions per transformer block per
    # step, one mid-block attention per decode
    want = {"flash_fwd": 2 * n_clip + 2 * n_tf * steps, "flash_stream": n_vae}
    requests = [
        dict(prompt="a photograph of an astronaut riding a horse", seed=0),
        dict(prompt="a watercolor painting of a fox in the snow", seed=1),
        dict(prompt=["a red bicycle by a canal", "a lighthouse at dusk"], seed=2),
    ]
    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    for c in counters.values():
        c.reset()
    results, batch1 = [], None
    torch.cuda.reset_peak_memory_stats()
    for req in requests:
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(model, height=512, width=512, num_inference_steps=steps,
                   guidance_scale=7.5, **req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count - before[n] for n, c in counters.items()}
        B = 1 if isinstance(req["prompt"], str) else len(req["prompt"])
        im = out.images
        print(json.dumps({"request": req, "wall_s": wall, "launches": got,
                          "expected_launches": want, "shape": list(im.shape),
                          "dtype": str(im.dtype), "mean": float(im.mean()),
                          "std": float(im.std())}), flush=True)
        if im.shape != (B, 512, 512, 3) or im.dtype != np.float32:
            raise AssertionError(f"bad output {im.shape} {im.dtype}")
        if not (np.isfinite(im).all() and im.min() >= 0.0 and im.max() <= 1.0):
            raise AssertionError("non-finite or out-of-range pixels")
        if got != want:
            raise AssertionError(f"launch counts {got} != expected {want}")
        results.append(im)
        if batch1 is None:  # launches of the first (batch-1) request by shape
            batch1 = {n: dict(c.by_shape) for n, c in counters.items()}
    if np.array_equal(results[0], results[1]):
        raise AssertionError("two seeds and prompts gave identical images")
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    if min(totals.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {totals}")
    for n, shapes in batch1.items():
        for (qs, skv, dtype, causal, _lse), count in sorted(shapes.items()):
            print(json.dumps({"batch1_launches": n, "shape": list(qs), "skv": skv,
                              "dtype": dtype, "causal": causal, "count": count}),
                  flush=True)
    print(f"main path peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return totals, by_shape, batch1, model, pipe


def _rel_err(a, ref):
    """rms(a - ref) over the spread of ref (its standard deviation)."""
    return ((a - ref).pow(2).mean().sqrt() / ref.std()).item()


def phase_unet_bf16(model):
    """One full-width UNet forward at B=2 in bf16 through the kernels and
    through the plain attention, each against an fp32 copy of the same UNet
    with the plain attention, on the same inputs."""
    import torch

    import stablediffusion_tpu_torch.models.unet as unet_module
    from stablediffusion_tpu_torch.ops.attention import attention_plain

    unet = model.unet
    dtype = next(unet.parameters()).dtype
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, unet.config.in_channels, 64, 64, device="cuda", generator=g)
    ctx = torch.randn(2, 77, unet.config.cross_attention_dim, device="cuda", generator=g)
    t = torch.tensor(500, device="cuda")
    with torch.inference_mode():
        kern = unet(x.to(dtype), t, ctx.to(dtype)).float()
        routed = unet_module.attention
        unet_module.attention = attention_plain
        try:
            plain = unet(x.to(dtype), t, ctx.to(dtype)).float()
            ref = copy.deepcopy(unet).float()(x, t, ctx).float()
        finally:
            unet_module.attention = routed
    err_kernel, err_plain = _rel_err(kern, ref), _rel_err(plain, ref)
    print(json.dumps({
        "unet_bf16": "full-width SD1.5 UNet, B=2, 64x64 latents, t=500",
        "dtype": str(dtype), "ref_std": ref.std().item(),
        "kernels_vs_fp32": err_kernel, "plain_vs_fp32": err_plain,
        "kernels_vs_plain": _rel_err(kern, plain),
        "limit": f"kernels_vs_fp32 <= {UNET_SLACK} * plain_vs_fp32"}), flush=True)
    if not (torch.isfinite(kern).all() and err_kernel <= UNET_SLACK * err_plain):
        raise AssertionError(f"bf16 UNet through the kernels: {err_kernel} from "
                             f"fp32, the plain path {err_plain}")
    del ref
    torch.cuda.empty_cache()


def _kernel_group(name: str) -> str:
    low = name.lower()
    for key in ("flash_fwd", "flash_stream", "flash_bwd_dkv", "flash_bwd_dq"):
        if key in low:
            return key
    if any(s in low for s in ("conv", "fprop", "dgrad", "implicit", "cudnn")):
        return "convolution"
    if any(s in low for s in ("gemm", "cublas", "cutlass", "xmma")):
        return "gemm"
    if "norm" in low:
        return "normalization"
    return "elementwise and other"


def _profile(label, fn):
    """Device time by kernel group over one call of `fn` under
    torch.profiler, and the device's busy share of the call's wall time (the
    profiler's own host cost lowers that share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, groups, by_name = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        dur = e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):  # union of the device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {
        "profile": label,
        "wall_ms_profiled": wall_ms, "device_kernel_ms": sum(groups.values()),
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:90], ms] for n, ms in top],
    }
    print(json.dumps(row), flush=True)
    return row


def phase_profile(model, pipe):
    """Where the time goes in one batch-1 request."""
    _profile("one batch-1 request, 512x512, 20 DDIM steps, CFG 7.5",
             lambda: pipe(model, prompt="a photograph of an astronaut riding a horse",
                          seed=0, height=512, width=512, num_inference_steps=20,
                          guidance_scale=7.5))


def _train_counters():
    from stablediffusion_tpu_torch.ops.attention import (
        FLASH_BWD_DKV_LAUNCHES,
        FLASH_BWD_DQ_LAUNCHES,
        FLASH_FWD_LAUNCHES,
    )
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES

    return {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES,
            "flash_bwd_dq": FLASH_BWD_DQ_LAUNCHES, "flash_bwd_dkv": FLASH_BWD_DKV_LAUNCHES}


def _fwd_split(count, by_shape):
    """flash_fwd launches by kind: with lse (under grad), causal without."""
    with_lse = sum(n for key, n in by_shape.items() if key[4])
    causal = sum(n for key, n in by_shape.items() if key[3] and not key[4])
    return {"with_lse": with_lse, "causal_no_lse": causal,
            "other": count - with_lse - causal}


def phase_train():
    """The training main path: make_train_step on the full-width SD1.5
    model at 512x512, batch 8, rank-16 LoRA on the UNet's attention
    projections, Min-SNR 5, constant-LR AdamW, bf16 UNet, fp32 VAE; one warm
    step and TRAIN_STEPS timed ones.  Launch counts per step are exact."""
    import torch

    from stablediffusion_tpu_torch.core.config import (
        SD15_TEXT_ENCODER,
        SD15_UNET,
        SD15_VAE,
        SchedulerConfig,
    )
    from stablediffusion_tpu_torch.lora.core import UNET_TARGET_SUFFIXES, init_lora
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer
    from stablediffusion_tpu_torch.train.train_step import TrainStatics, make_train_step
    from stablediffusion_tpu_torch.utils.testing import random_full_model, random_train_batch

    model = random_full_model("sd15", device="cuda", seed=1)
    model.vae.float()  # the trainers encode in fp32
    frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
    g = torch.Generator(device="cuda").manual_seed(2)
    lora = {"unet": init_lora(model.unet, 16, UNET_TARGET_SUFFIXES, g, store_alpha=False)}
    statics = TrainStatics(
        unet_config=SD15_UNET, vae_config=SD15_VAE, text_config=SD15_TEXT_ENCODER,
        text_config_2=None, scheduler_config=SchedulerConfig(),
        train_text_encoder=False, snr_gamma=5.0, compute_dtype=torch.bfloat16,
    )
    opt = make_optimizer(make_lr_schedule("constant", 1e-4))
    opt_state = opt.init(lora)
    step = make_train_step(statics, DDPMScheduler(statics.scheduler_config), opt)
    batch = random_train_batch(TRAIN_BATCH, 512, g)

    n_tf, _ = _count_blocks(model)
    n_clip = SD15_TEXT_ENCODER.num_hidden_layers
    want = {"flash_fwd": {"with_lse": 2 * n_tf, "causal_no_lse": n_clip, "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf, "flash_bwd_dkv": 2 * n_tf}
    counters = _train_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(1 + TRAIN_STEPS):
        snap = {n: (c.count, dict(c.by_shape)) for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        lora, opt_state, m = step(lora, opt_state, frozen, batch, g)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count - snap[n][0] for n, c in counters.items()}
        fwd = counters["flash_fwd"]
        now, prev = _fwd_split(fwd.count, fwd.by_shape), _fwd_split(*snap["flash_fwd"])
        got["flash_fwd"] = {k: now[k] - prev[k] for k in now}
        row = {"train_step": i, "warm": i == 0, "wall_s": wall, "loss": loss,
               "grad_norm": gnorm, "launches": got}
        print(json.dumps(row), flush=True)
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"train step {i}: loss {loss}, grad norm {gnorm}")
        if got != want:
            raise AssertionError(f"train step {i}: launches {got} != expected {want}")
        if i == 0:
            # from zero, AdamW moves an element by about lr exactly where its
            # gradient is non-zero: a zero `up` after step 1 had no gradient
            dead = [p for p, f in lora["unet"].items() if not f["up"].abs().max().item() > 0]
            if dead:
                raise AssertionError(f"{len(dead)} LoRA up factors got no gradient: {dead[:3]}")
        else:
            walls.append(wall)
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    if min(totals.values()) == 0:
        raise AssertionError(f"a kernel of the train path never launched: {totals}")
    best = min(walls)
    summary = {
        "train": "SD1.5 512x512 LoRA r16 on to_q/to_k/to_v/to_out.0, Min-SNR 5, "
                 "AdamW constant 1e-4, bf16 UNet, fp32 VAE encode",
        "batch": TRAIN_BATCH, "remat_policy": statics.remat_policy,
        "step_wall_s": walls, "best_step_s": best, "images_per_s": TRAIN_BATCH / best,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want, "launches_total": totals,
        "lora_params": sum(t.numel() for f in lora["unet"].values() for t in f.values()),
    }
    print(json.dumps(summary), flush=True)
    _profile(f"one train step, SD1.5 512x512, batch {TRAIN_BATCH}",
             lambda: step(lora, opt_state, frozen, batch, g)[2]["loss"].item())
    return totals, by_shape, summary


def _train_bwd_cases(by_shape):
    """(B, Sq, H, D, Skv, causal, dtype) of every backward launch of the
    train path, each also in the other dtype, CLIP's causal shape at B=8,
    and a ragged Sq (the SD3 joint stream at 512^2)."""
    import torch

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = set()
    for (qs, skv, dtype, causal, _lse) in by_shape["flash_bwd_dkv"]:
        for d in dtypes:
            cases.add((*qs, skv, causal, d))
    for d in dtypes:
        cases.add((8, 77, 12, 64, 77, True, d))
        cases.add((2, 1101, 8, 64, 1101, False, d))
    return [(*c[:6], dtypes[c[6]]) for c in sorted(cases)]


def bwd_case(B, Sq, H, D, Skv, causal, dtype, launches, teeth):
    """Both backward kernels and the forward's lse at one shape against
    their plain versions evaluated in fp32 on the same inputs (bf16:
    ``attention_bwd_rounded``, which rounds p and ds to bf16 where the
    kernels and the JAX library do, under ``GRAD_TOL`` plus its flip term;
    fp32: ``flash_bwd_plain`` under ``GRAD_TOL``); times of each kernel, of
    the plain backward, and of SDPA's backward (autograd of
    F.scaled_dot_product_attention minus its forward), beside each kernel's
    bound.  With `teeth`, four wrong bf16 backwards must break the rule."""
    import torch
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops.attention import (
        _launch_fwd,
        _row_dot,
        attention_plain_lse,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_plain,
    )
    from stablediffusion_tpu_torch.utils.testing import (
        attention_bwd_rounded,
        attention_bwd_wrong_variants,
        grad_error,
        kernel_error,
    )

    g = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", dtype=dtype, generator=g)
               for S in (Sq, Skv, Skv))
    do = torch.randn(B, Sq, H, D, device="cuda", dtype=dtype, generator=g)
    scale = D**-0.5
    rounded = dtype == torch.bfloat16
    with torch.no_grad():
        out, lse = _launch_fwd(q, k, v, scale, causal, with_lse=True)
        di = _row_dot(out, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, scale, causal)
        dq = flash_bwd_dq(q, k, v, do, lse, di, scale, causal)
        torch.cuda.synchronize()
        lse_err = kernel_error(lse, attention_plain_lse(
            q.float(), k.float(), v.float(), causal=causal)[1])
        if rounded:
            refs, flips = attention_bwd_rounded(q, k, v, out, do, lse, scale, causal)
        else:
            refs = flash_bwd_plain(*(t.float() for t in (q, k, v, out, do)), lse, scale, causal)
            flips = (None,) * 3
        errs = {n: grad_error(t, r, f)
                for n, t, r, f in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, flips)}
        rejected = None
        if teeth:
            # the rule's teeth: wrong backwards, each rounded to bf16 as the
            # kernels round their outputs, must fail it
            rejected = {
                name: max(grad_error(w, r, f)["worst_over_limit"]
                          for w, r, f in zip(wrong, refs, flips))
                for name, wrong in attention_bwd_wrong_variants(
                    q, k, v, out, do, lse, scale, causal).items()}
        del refs, flips
        torch.cuda.empty_cache()
        fwd_lse_ms = _device_ms(lambda: _launch_fwd(q, k, v, scale, causal, with_lse=True),
                                "flash_fwd", 5)
        dkv_ms = _device_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, di, scale, causal),
                            "flash_bwd_dkv", 5)
        dq_ms = _device_ms(lambda: flash_bwd_dq(q, k, v, do, lse, di, scale, causal),
                           "flash_bwd_dq", 5)
        plain_ms = _time_ms(lambda: flash_bwd_plain(q, k, v, out, do, lse, scale, causal), 3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
    fwd_ms = _time_ms(sdpa, 10)
    fwd_bwd_ms = _time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), 10)
    dname = str(dtype).replace("torch.", "")
    rows = []
    for name, ms, outs in (("flash_bwd_dkv", dkv_ms, ("dk", "dv")), ("flash_bwd_dq", dq_ms, ("dq",))):
        bound_ms, bound_by, terms = _bwd_bound(name, B, Sq, H, D, Skv, causal, dname,
                                               q.element_size())
        row = dict(kernel=name, shape=[B, Sq, H, D], skv=Skv, dtype=dname, causal=causal,
                   launches=launches,
                   max_abs_err=max(errs[o]["max_abs_err"] for o in outs),
                   worst_over_limit=max(errs[o]["worst_over_limit"] for o in outs),
                   typical_abs_ref=min(errs[o]["typical_abs_ref"] for o in outs),
                   atol=min(errs[o]["atol"] for o in outs), rtol=errs[outs[0]]["rtol"],
                   ref="attention_bwd_rounded" if rounded else "flash_bwd_plain",
                   lse_worst_over_limit=lse_err["worst_over_limit"], fwd_lse_ms=fwd_lse_ms,
                   kernel_ms=ms, plain_ms=plain_ms, library_ms=fwd_bwd_ms - fwd_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms_ms=terms)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rejected is not None:
        print(json.dumps({"grad_rule_teeth": "wrong bf16 backwards against "
                          "attention_bwd_rounded", "shape": [B, Sq, H, D], "skv": Skv,
                          "dtype": dname, "worst_over_limit": rejected}), flush=True)
        if not min(rejected.values()) > 1.0:
            raise AssertionError(f"the bf16 gradient rule accepts a wrong backward: {rejected}")
    bad = [r for r in rows if not (r["worst_over_limit"] <= 1.0 and r["lse_worst_over_limit"] <= 1.0)]
    if bad:
        raise AssertionError(f"backward kernels outside the rule: {bad}")
    del q, k, v, do, out, lse, di, dq, dk, dv, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_train_kernels(by_shape):
    """The forwards at every shape the train path launched (phase 3's
    check and times; under grad flash_fwd also writes the lse, which
    bwd_case times), then the backward cases."""
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import flash_stream, flash_stream_plain

    fns = {"flash_fwd": (flash_fwd, attention_plain),
           "flash_stream": (flash_stream, flash_stream_plain)}
    rows = []
    for name, fn in fns.items():
        for (qs, skv, dname, causal, _lse), n in sorted(by_shape[name].items()):
            row = kernel_case(name, *fn, *qs, skv, getattr(torch, dname), causal, n, 0)
            rows.append(dict(row, path="train"))
    for (B, Sq, H, D, Skv, causal, dtype) in _train_bwd_cases(by_shape):
        dname = str(dtype).replace("torch.", "")
        key = ((B, Sq, H, D), Skv, dname, causal, False)
        teeth = (B, Sq, H, D, Skv, dname) == (TRAIN_BATCH, 4096, 8, 40, 4096, "bfloat16")
        rows += bwd_case(B, Sq, H, D, Skv, causal, dtype,
                         by_shape["flash_bwd_dkv"].get(key, 0), teeth)
    launched = {n: sum(r["launches"] for r in rows if r["kernel"] == n)
                for n in ("flash_fwd", "flash_stream", "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"train path: {len(rows)} kernel rows; the path's launches summed over "
          f"them: {launched}", flush=True)
    return rows


def phase_train_reference():
    """Narrow SD1.5-layout model, card (kernels) against CPU (plain
    attention), fp32, the same weights, LoRA, batch and draws: loss and
    every LoRA gradient of one loss_fn + backward."""
    import dataclasses

    import numpy as np
    import torch

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
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1,
    )
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    cpu = random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device="cpu",
                       dtype=torch.float32, seed=3)
    statics = TrainStatics(
        unet_config=ucfg, vae_config=vcfg, text_config=tcfg, text_config_2=None,
        scheduler_config=SchedulerConfig(), train_text_encoder=False, snr_gamma=5.0,
        compute_dtype=torch.float32,
    )
    r = np.random.default_rng(11)
    batch = {"pixel_values": torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(r.integers(0, 49407, (2, 77)))}
    draws = {"latent_eps": torch.from_numpy(r.standard_normal((2, 4, 16, 16)).astype(np.float32)),
             "noise": torch.from_numpy(r.standard_normal((2, 4, 16, 16)).astype(np.float32)),
             "timesteps": torch.from_numpy(np.array([17, 630]))}
    lora = init_lora(cpu.unet, 4, UNET_TARGET_SUFFIXES, torch.Generator().manual_seed(5),
                     store_alpha=False)
    for f in lora.values():  # non-zero up: zeros give zero down gradients
        f["up"] = torch.from_numpy(r.standard_normal(tuple(f["up"].shape)).astype(np.float32) * 0.05)
    counters = _train_counters()
    results = {}
    for dev in ("cpu", "cuda"):
        mods = {"unet": cpu.unet, "vae": cpu.vae, "text_encoder": cpu.text_encoder}
        if dev == "cuda":
            mods = {n: copy.deepcopy(m).cuda() for n, m in mods.items()}
        trainable = {"unet": {p: {n: t.to(dev) for n, t in f.items()} for p, f in lora.items()}}
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(trainable)]
        before = {n: c.count for n, c in counters.items()}
        loss = loss_fn(trainable, mods, batch, None, statics, DDPMScheduler(), draws=draws)
        grads = torch.autograd.grad(loss, leaves)
        results[dev] = [loss.detach().cpu()] + [gr.cpu() for gr in grads]
        launched = {n: c.count - before[n] for n, c in counters.items()}
        if dev == "cuda" and min(launched.values()) == 0:
            raise AssertionError(f"train reference on the card skipped a kernel: {launched}")
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(results["cuda"], results["cpu"]))
    print(json.dumps({"train_reference": "narrow SD1.5 layout, loss and LoRA gradients, "
                      "card vs CPU, fp32", "loss_cpu": results["cpu"][0].item(),
                      "loss_cuda": results["cuda"][0].item(), "tensors": len(results["cpu"]),
                      "worst_rel_err": worst, "tol": TRAIN_REF_TOL}), flush=True)
    if not worst <= TRAIN_REF_TOL:
        raise AssertionError(f"train step on the card disagrees with the CPU: {worst}")


def main() -> int:
    import torch

    from stablediffusion_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"max SM clock {_sm_clock_hz() / 1e6:.0f} MHz (the bound's exponential rate)",
          flush=True)
    t = time.perf_counter()
    _build.build()
    print(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t:.3f} s",
          flush=True)
    for source, log in sorted(_build.BUILD_LOGS.items()):
        usage = _build.ptxas_usage(log)
        print(json.dumps({"ptxas": source, "kernels": usage}), flush=True)
        spilled = [u for u in usage if u["spill_bytes"]]
        if source == "flash_bwd" and spilled:
            raise AssertionError(f"flash_bwd kernels spill registers: {spilled}")
    if set(_build.SOURCES) - set(_build.BUILD_LOGS):
        print("ptxas: the libraries were built by an earlier run; no report", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    launches, by_shape, batch1, model, pipe = phase_main_path()
    rows = phase_kernels(by_shape, batch1)
    phase_unet_bf16(model)
    phase_reference()
    phase_profile(model, pipe)
    del model, pipe
    torch.cuda.empty_cache()

    train_launches, train_by_shape, _ = phase_train()
    torch.cuda.empty_cache()
    rows += phase_train_kernels(train_by_shape)
    phase_train_reference()

    # one line per kernel, at its heaviest main-path shape; launches from the
    # path that needs the kernel (txt2img for the forwards, training for the
    # backward), with both paths' counts beside
    main_case = {
        "flash_fwd": dict(shape=[2, 4096, 8, 40], skv=4096, dtype="bfloat16"),
        "flash_stream": dict(shape=[1, 4096, 1, 512], skv=4096, dtype="float32"),
        "flash_bwd_dkv": dict(shape=[TRAIN_BATCH, 4096, 8, 40], skv=4096, dtype="bfloat16"),
        "flash_bwd_dq": dict(shape=[TRAIN_BATCH, 4096, 8, 40], skv=4096, dtype="bfloat16"),
    }
    lib_flash = "stablediffusion_tpu/ops/attention.py:165"
    meta = {
        "flash_fwd": ("stablediffusion_tpu_torch/csrc/flash_fwd.cu", lib_flash),
        "flash_stream": ("stablediffusion_tpu_torch/csrc/flash_stream.cu",
                         "stablediffusion_tpu/ops/flash_attention.py:145"),
        "flash_bwd_dkv": ("stablediffusion_tpu_torch/csrc/flash_bwd.cu", lib_flash),
        "flash_bwd_dq": ("stablediffusion_tpu_torch/csrc/flash_bwd.cu", lib_flash),
    }
    # the library Pallas kernels behind _lib_flash (jax 0.9.0)
    library_kernel = {
        "flash_fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:589",
        "flash_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "flash_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
    }
    kernels = []
    for name, want in main_case.items():
        row = next(r for r in rows if r["kernel"] == name and not r["causal"]
                   and r.get("path") != "train"
                   and all(r[k] == v for k, v in want.items()))
        mine = [r for r in rows if r["kernel"] == name]
        by_path = {"txt2img": launches.get(name, 0), "train": train_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "replaces_library_kernel": library_kernel.get(name),
            "launches": by_path["train" if name.startswith("flash_bwd") else "txt2img"],
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "event_ms": row.get("event_ms"),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound_terms_ms": row["bound_terms_ms"],
            "library_ms": row["library_ms"],
            "shape": row["shape"], "skv": row["skv"], "dtype": row["dtype"],
            "cases": len(mine),
            "worst_over_limit": max(r["worst_over_limit"] for r in mine),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
