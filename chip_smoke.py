"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, nothing caught):

1. Card and build: print the card's name and power limit, build both CUDA
   kernels from ``stablediffusion_tpu_torch/csrc``, set and print the TF32
   switches.
2. Main path: the full-width SD1.5 model with random weights answers three
   512x512, 20-step DDIM, CFG 7.5 txt2img requests through the pipeline
   call (batch 1, batch 1 with another seed, a two-prompt batch).  Outputs
   must be finite and of the right shape, and the kernels' launch counts must
   equal what the path implies.  The wrappers also count their launches by
   call shape, which gives phase 3 its cases.
3. Kernels against their plain versions: every call shape the main path
   launched, the UNet's also at B=16 (batch 8 under CFG), and a ragged VAE
   length, each in fp32 and bf16, against the plain version evaluated in fp32
   on the same inputs under the per-element limit of
   ``utils/testing.KERNEL_TOL``; times of the kernel, the plain version and
   one library call (``F.scaled_dot_product_attention``, a yardstick the port
   never calls) beside the card's bound.
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

Prints one JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import copy
import json
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
# full-width bf16 UNet: the kernels' path keeps the probabilities in fp32
# where the plain path rounds them to bf16, so it should lie no farther from
# the fp32 model; 25% covers the bf16 rounding the two paths share
UNET_SLACK = 1.25


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


def _bound(B, Sq, H, D, Skv, causal, dtype, itemsize):
    """Least time on the card: the larger of operations / peak and bytes /
    HBM rate; q, k, v read once, out written once.  A causal call does only
    the pairs j <= i."""
    pairs = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    flops = 4 * B * H * pairs * D
    nbytes = itemsize * B * H * D * (2 * Sq + 2 * Skv)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_case(name, kernel, plain, B, Sq, H, D, Skv, dtype, causal,
                launches, launches_batch1):
    import torch
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.utils.testing import kernel_error

    g = torch.Generator(device="cuda").manual_seed(1234)
    q = torch.randn(B, Sq, H, D, device="cuda", dtype=dtype, generator=g)
    k = torch.randn(B, Skv, H, D, device="cuda", dtype=dtype, generator=g)
    v = torch.randn(B, Skv, H, D, device="cuda", dtype=dtype, generator=g)
    kw = {"causal": True} if causal else {}
    out = kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    # the plain version in fp32 on the same input values: the kernels compute
    # in fp32, so in bf16 only their output rounding separates the two
    err = kernel_error(out, plain(q.float(), k.float(), v.float(), **kw))
    dname = str(dtype).replace("torch.", "")
    big = B * Sq * Skv * H >= 2**31  # plain logits of 8 GiB and up
    ms = _time_ms(lambda: kernel(q, k, v, **kw), 10)
    plain_ms = _time_ms(lambda: plain(q, k, v, **kw), 2 if big else 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 10
    )
    bound_ms, bound_by = _bound(B, Sq, H, D, Skv, causal, dname, q.element_size())
    row = dict(kernel=name, shape=[B, Sq, H, D], skv=Skv, dtype=dname,
               causal=causal, launches=launches, launches_batch1=launches_batch1,
               **err, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    print(json.dumps(row), flush=True)
    if not err["worst_over_limit"] <= 1.0:
        raise AssertionError(f"{name} {row['shape']} Skv={Skv} {dname}: max abs err "
                             f"{err['max_abs_err']}, {err['worst_over_limit']} x its limit")
    del q, k, v, out
    torch.cuda.empty_cache()
    return row


def _cases(by_shape):
    """Every (kernel, B, Sq, H, D, Skv, causal) the main path launched, the
    UNet's (flash_fwd, not causal) at batch 1 also at B=16, and a ragged VAE
    length."""
    cases = set()
    for name, shapes in by_shape.items():
        for (qs, skv, _dtype, causal) in shapes:
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
            key = ((B, Sq, H, D), Skv, str(dtype).replace("torch.", ""), causal)
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
    n_vae = sum(isinstance(m, VAEAttention) for m in model.vae.modules())
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
        for (qs, skv, dtype, causal), count in sorted(shapes.items()):
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
    for key in ("flash_fwd", "flash_stream"):
        if key in low:
            return key
    if any(s in low for s in ("conv", "fprop", "dgrad", "implicit", "cudnn")):
        return "convolution"
    if any(s in low for s in ("gemm", "cublas", "cutlass", "xmma")):
        return "gemm"
    if "norm" in low:
        return "normalization"
    return "elementwise and other"


def phase_profile(model, pipe):
    """Where the time goes: device time by kernel group over one batch-1
    request under torch.profiler, and the device's busy share of the
    request's wall time (the profiler's own host cost lowers that share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe(model, prompt="a photograph of an astronaut riding a horse", seed=0,
             height=512, width=512, num_inference_steps=20, guidance_scale=7.5)
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
    kernel_ms = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "profile": "one batch-1 request, 512x512, 20 DDIM steps, CFG 7.5",
        "wall_ms_profiled": wall_ms, "device_kernel_ms": kernel_ms,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:90], ms] for n, ms in top],
    }), flush=True)


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
    t = time.perf_counter()
    _build.build()
    print(f"built {sorted(_build.SIGNATURES)} in {time.perf_counter() - t:.3f} s",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    launches, by_shape, batch1, model, pipe = phase_main_path()
    rows = phase_kernels(by_shape, batch1)
    phase_unet_bf16(model)
    phase_reference()
    phase_profile(model, pipe)

    # one line per kernel, at its heaviest main-path shape
    main_case = {
        "flash_fwd": dict(shape=[2, 4096, 8, 40], skv=4096, dtype="bfloat16"),
        "flash_stream": dict(shape=[1, 4096, 1, 512], skv=4096, dtype="float32"),
    }
    meta = {
        "flash_fwd": ("stablediffusion_tpu_torch/csrc/flash_fwd.cu",
                      "stablediffusion_tpu/ops/attention.py:165"),
        "flash_stream": ("stablediffusion_tpu_torch/csrc/flash_stream.cu",
                         "stablediffusion_tpu/ops/flash_attention.py:145"),
    }
    kernels = []
    for name, want in main_case.items():
        row = next(r for r in rows if r["kernel"] == name and not r["causal"]
                   and all(r[k] == v for k, v in want.items()))
        mine = [r for r in rows if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
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
