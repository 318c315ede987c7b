"""Where the bf16 backward kernels' time goes (`csrc/flash_bwd.cu`), on the
card, and how they compare with another version of the source:

    python3 -m stablediffusion_tpu_torch.utils.flash_bwd_ablation
    python3 -m stablediffusion_tpu_torch.utils.flash_bwd_ablation --against DIR

Builds the kernels as they are and four broken copies of them, made from
their source text: "no_exp" takes p as the scaled logit itself (no
exponential; the rest of the softmax arithmetic stays), "no_first_products"
drops s = q k^T and dp = dO v^T (dq) and their transposes (dkv), which then
run on zeroed registers, "no_second_products" drops dQ += ds k (dq) and
dV += p^T dO, dK += ds^T q (dkv) (the softmax, whose only use is their
input, goes with them), and "ring_only" drops both, leaving the copies,
barriers and epilogue.  Times flash_bwd_dkv and flash_bwd_dq of each at the
main path's bf16 shapes with CUDA events (10 launches after a warm-up,
repeated twice) and prints one JSON line per case, after the card's name and
power limit.  The copies' outputs are of no use; only their times are.

With ``--against DIR`` (a directory holding another ``flash_bwd.cu`` and the
headers it includes, such as the source of an earlier commit unpacked by
``git archive``) it builds that source beside this one instead and times
both kernels of both at every bf16 shape the card's paths launch
(PATH_SHAPES), each the median of 20 launches' device times under
torch.profiler after a warm-up, in the order other, this, this, other.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.ops.attention import _row_dot

# (B, Sq, H, D, Skv): SD3 training's joint stream, SD1.5's heaviest and its
# cross-attention, the SDXL trainer's heaviest
SHAPES = ((1, 4250, 24, 64, 4250), (8, 4096, 8, 40, 4096), (8, 4096, 8, 40, 77),
          (2, 4096, 10, 64, 4096))
# every bf16 backward shape of chip_smoke.py's train paths: SD1.5 LoRA at
# batch 8 (and 2, its variants), the SDXL trainer, SD3 training, the
# ControlNet trainer at batch 4; phase 8's causal CLIP shape
PATH_SHAPES = tuple(
    (B, S, 8, D, skv) for B in (8, 4, 2)
    for S, D in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for skv in (S, 77)
) + ((2, 4096, 10, 64, 4096), (2, 4096, 10, 64, 77), (2, 1024, 20, 64, 1024),
     (2, 1024, 20, 64, 77), (1, 4250, 24, 64, 4250), (8, 77, 12, 64, 77, "causal"))

_EXP_DKV = "const float pe = exp2_approx(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x) * kLog2e));"
_EXP_DQ = "s[x] = p.scale * exp2_approx(fmaf(s[x], sl2, -lse2[r])) * (dp[x] - dd[r]);"
_FIRST = ("    kmajor_product<D16, BQ, L::kKeys>(s, k_tile, q_tile);\n",
          "    if constexpr (DK) kmajor_product<D16, BQ, L::kKeys>(dp, v_tile, do_tile);\n",
          "        kmajor_product<D16, BK, L::kRows>(s, qt, k_tile);\n",
          "        kmajor_product<D16, BK, L::kRows>(dp, dot, sV + st * L::kKVBytes);\n")
_SECOND = ("    if constexpr (DV) mnmajor_product<NC, BQ>(dv, pa, do_tile);\n",
           "    if constexpr (DK) mnmajor_product<NC, BQ>(dk, da, q_tile);\n",
           "        mnmajor_product<NC, BK>(dq, da, k_tile);\n")


def _drop(src: str, lines) -> str:
    for line in lines:
        assert src.count(line) == 1, line
        src = src.replace(line, "")
    return src


def variants() -> dict:
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    assert src.count(_EXP_DKV) == 1 and src.count(_EXP_DQ) == 1
    no_exp = src.replace(_EXP_DKV, "const float pe = fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x));")
    no_exp = no_exp.replace(_EXP_DQ, "s[x] = p.scale * fmaf(s[x], sl2, -lse2[r]) * (dp[x] - dd[r]);")
    return {"kernel": src, "no_exp": no_exp, "no_first_products": _drop(src, _FIRST),
            "no_second_products": _drop(src, _SECOND),
            "ring_only": _drop(_drop(src, _FIRST), _SECOND)}


def build(out_dir, sources: dict) -> dict:
    """Compile every variant (name -> source path), one nvcc each, all
    started together; each source finds its headers beside it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            fn = getattr(lib, _build.ENTRIES[kernel][1])
            fn.argtypes = _build.ENTRIES[kernel][2]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablation_sources(out_dir) -> dict:
    """The kernel and its broken copies written into `out_dir`, beside this
    source's headers."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    paths = {}
    for name, text in variants().items():
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(text)
    return paths


def _device_ms(launch, key: str, reps: int = 20) -> float:
    """Median device time of `reps` launches of the kernel whose name holds
    `key`, from torch.profiler's kernel events, after a warm-up; a profiling
    run that kept no event of it is repeated, up to three runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and key in e.name]
        if us:
            return statistics.median(us) / 1e3
    raise RuntimeError(f"torch.profiler kept no event of {key} in 3 runs")


def _event_ms(launch) -> list:
    times = []
    for _ in range(2):
        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return times


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a directory with another flash_bwd.cu to time beside this one")
    against = parser.parse_args().against
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "flash_bwd_ablation"
    if against is None:
        libs, shapes = build(out_dir, ablation_sources(out_dir)), SHAPES
    else:
        sources = {"other": against.resolve() / "flash_bwd.cu", "kernel": _build.CSRC / "flash_bwd.cu"}
        libs, shapes = build(out_dir, sources), PATH_SHAPES
    fwd = _build.entry("flash_fwd")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Sq, H, D, Skv, *causal in shapes:
        causal = int(bool(causal))
        q, k, v = (torch.randn(B, S, H, D, device="cuda", dtype=torch.bfloat16, generator=g)
                   for S in (Sq, Skv, Skv))
        do = torch.randn_like(q)
        scale = D**-0.5
        out, args = _build.attention_launch_args("flash_fwd", q, k, v, 8, 160)
        lse = torch.empty(B, H, Sq, device="cuda", dtype=torch.float32)
        _build.check("flash_fwd", fwd(*args, scale, causal, ctypes.c_void_p(lse.data_ptr()),
                                      stream))
        di = _row_dot(out, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        row = {"shape": [B, Sq, H, D], "skv": Skv, "causal": bool(causal), "dtype": "bfloat16"}
        for kernel, outs in (("flash_bwd_dkv", (None, dk, dv)), ("flash_bwd_dq", (dq, None, None))):
            bwd_args = _build.bwd_launch_args(q, k, v, do, lse, di, *outs)
            order = list(libs) if against is None else ["other", "kernel", "kernel", "other"]
            for name in order:
                fn = getattr(libs[name], _build.ENTRIES[kernel][1])
                launch = lambda: _build.check(  # noqa: E731
                    kernel, fn(*bwd_args, scale, causal, stream))
                if against is None:
                    row[f"{kernel}_{name}_ms"] = _event_ms(launch)
                else:
                    row.setdefault(f"{kernel}_{name}_ms", []).append(_device_ms(launch, kernel))
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, di, dq, dk, dv


if __name__ == "__main__":
    main()
