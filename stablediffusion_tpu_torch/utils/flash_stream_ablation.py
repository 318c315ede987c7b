"""Where `csrc/flash_stream.cu`'s fp32 time goes, on the card, and how it
compares with another version of the source:

    python3 -m stablediffusion_tpu_torch.utils.flash_stream_ablation
    python3 -m stablediffusion_tpu_torch.utils.flash_stream_ablation --against DIR

Builds the kernel as it is and broken copies of it, made from its source
text: "no_products" drops every wgmma (q k^T and p v run on nothing; the
copies, the splits, the softmax and the barriers stay), "no_copies" issues
no TMA copy (each stage's barrier is arrived on without bytes, so the
products run on whatever shared memory holds), "no_split" leaves every
operand unsplit (hi = x, lo = 0: the products still run, the K chunks' split
pass and its barrier go), "ring_only" drops the products and the split
(the copies, the barriers and the softmax stay), "products_only" drops the
copies and the split (the products, the barriers and the softmax stay), and
"no_merge" drops the exchange of a cluster's two halves through distributed
shared memory (the key split at [1,4096,1,512]).  Times each at the path's
fp32 shapes with CUDA events (10 launches after a warm-up, repeated twice)
and prints one JSON line per shape, after the card's name and power limit
and the registers and spills that ptxas reports for each build's 3xTF32
kernels.  The copies' outputs are of no use; only their times are.

With ``--against DIR`` (a directory holding another ``flash_stream.cu`` and
the headers it includes, such as the source of an earlier commit unpacked
by ``git archive``) it builds that source beside this one instead and times
both at every fp32 shape the card's paths launch (SHAPES), each the median
of 20 launches' device times under torch.profiler after a warm-up, in the
order other, this, this, other.
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

# (B, Sq, H, D, Skv): an SD1.5 request's decode (a key split across a
# cluster), a burst decode and the ControlNet trainer's encode, the SD1.5
# train step's encode, an SDXL or SD3 request's decode, the SDXL trainer's
# encode
SHAPES = ((1, 4096, 1, 512, 4096), (4, 4096, 1, 512, 4096), (8, 4096, 1, 512, 4096),
          (1, 16384, 1, 512, 16384), (2, 16384, 1, 512, 16384))

_WGMMA = ("          wgmma_tf32_n64(s, ah[b2], dh, x > 0 || kk > 0);\n",
          "          wgmma_tf32_n64(s, ah[b2], dl, 1);\n",
          "          wgmma_tf32_n64(s, al[b2], dh, 1);\n",
          "          wgmma_tf32_n64(part, ah[b2], dh, kk > 0);\n",
          "          wgmma_tf32_n64(part, ah[b2], dl, 1);\n",
          "          wgmma_tf32_n64(part, al[b2], dh, 1);\n")
_SPLIT_PASS = ("    float4* hi = reinterpret_cast<float4*>(gbase + L::kRing + st * kTfStageBytes);\n",
               "    named_bar_sync(2 + wg, 128);\n")
_NO_SPLIT = ("#include \"hopper.cuh\"\n",
             "#include \"hopper.cuh\"\n\n#define split_tf32(x, hi, lo) ((hi) = __float_as_uint(x), (lo) = 0u)\n")
_MERGE = ("    if (!stores) {   // send this half of o^T to the block that stores it\n",
          "    cluster_sync();\n  }\n  if (stores) {\n")


def _drop(src: str, lines) -> str:
    for line in lines:
        assert src.count(line) == 1, line
        src = src.replace(line, "")
    return src


def _cut(src: str, start: str, end: str, keep_end: bool = True) -> str:
    """`src` without the text from `start` up to `end` (kept, or not)."""
    a, b = src.index(start), src.index(end)
    assert a < b and src.count(start) == 1 and src.count(end) == 1, start
    return src[:a] + src[b if keep_end else b + len(end):]


def _no_copies(src: str) -> str:
    """Every expect_tx becomes a plain arrival and no TMA copy is issued."""
    out = []
    for line in src.splitlines(keepends=True):
        if "mbar_expect_tx(" in line:
            bar = line.split("mbar_expect_tx(", 1)[1].rsplit(",", 1)[0]
            line = line.split("mbar_expect_tx(")[0] + f"mbar_arrive({bar});\n"
        out.append(line)
    src = "".join(out)
    assert src.count("tma_load(") == 4
    return src.replace("tma_load(", "if (false) tma_load(")


def variants() -> dict:
    src = (_build.CSRC / "flash_stream.cu").read_text()
    no_split = _cut(src, *_SPLIT_PASS, keep_end=False).replace(*_NO_SPLIT)
    assert no_split.count("#define split_tf32") == 1
    return {"kernel": src, "no_products": _drop(src, _WGMMA), "no_copies": _no_copies(src),
            "no_split": no_split, "ring_only": _drop(no_split, _WGMMA),
            "products_only": _no_copies(no_split), "no_merge": _cut(src, *_MERGE)}


def build(out_dir, sources: dict) -> dict:
    """Compile every variant (name -> source path), one nvcc each, all
    started together, and print the registers and spills of its 3xTF32
    kernels; each source finds its headers beside it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        print(json.dumps({"ptxas": name, "kernels": [
            u for u in _build.ptxas_usage(log) if "tf32" in u["kernel"]]}), flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).sdt_flash_stream
        fn.argtypes = _build.ENTRIES["flash_stream"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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


def _device_ms(launch, reps: int = 20) -> float:
    """Median device time of `reps` launches of a flash_stream kernel, from
    torch.profiler's kernel events, after a warm-up; a profiling run that
    kept no event of it is repeated, up to three runs."""
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
              if e.device_type == DeviceType.CUDA and "flash_stream" in e.name]
        if us:
            return statistics.median(us) / 1e3
    raise RuntimeError("torch.profiler kept no event of flash_stream in 3 runs")


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
                        help="a directory with another flash_stream.cu to time beside this one")
    against = parser.parse_args().against
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "flash_stream_ablation"
    if against is None:
        fns = build(out_dir, ablation_sources(out_dir))
    else:
        fns = build(out_dir, {"other": against.resolve() / "flash_stream.cu",
                              "kernel": _build.CSRC / "flash_stream.cu"})
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Sq, H, D, Skv in SHAPES:
        q = torch.randn(B, Sq, H, D, device="cuda", generator=g)
        k, v = (torch.randn(B, Skv, H, D, device="cuda", generator=g) for _ in range(2))
        out, args = _build.attention_launch_args("flash_stream", q, k, v, 168, 1024)
        row = {"shape": [B, Sq, H, D], "skv": Skv, "dtype": "float32"}
        order = list(fns) if against is None else ["other", "kernel", "kernel", "other"]
        for name in order:
            fn = fns[name]
            launch = lambda: _build.check(name, fn(*args, D**-0.5, stream))  # noqa: E731
            if against is None:
                row[f"{name}_ms"] = _event_ms(launch)
            else:
                row.setdefault(f"{name}_ms", []).append(_device_ms(launch))
        print(json.dumps(row), flush=True)
        del q, k, v, out


if __name__ == "__main__":
    main()
