"""Where `csrc/flash_stream.cu`'s time goes, on the card:

    python3 -m stablediffusion_tpu_torch.utils.flash_stream_ablation

Builds the kernel as it is and two broken copies of it, made from its source
text: "no_copies" stages nothing from global memory after the first Q tile
(the products run on whatever shared memory holds), "no_products" keeps the
copies, barriers and softmax but drops both product loops.  Times each at
the VAE's fp32 [1, 4096, 1, 512] and the train encode's [8, 4096, 1, 512]
with CUDA events (10 launches after a warm-up, repeated twice) and prints
one JSON line per case, after the card's name and power limit.  The copies
are outputs of no use; only their times are.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from stablediffusion_tpu_torch.ops import _build

SHAPES = ((1, 4096, 1, 512), (8, 4096, 1, 512))


def _cut(src: str, start: str, end: str) -> str:
    """`src` without the text from `start` up to (not including) `end`."""
    a, b = src.index(start), src.index(end)
    assert a < b and src.count(start) == 1, start
    return src[:a] + src[b:]


def variants() -> dict:
    src = (_build.CSRC / "flash_stream.cu").read_text()
    no_copies = src.replace("    if (i + 1 < total) load_chunk(i + 1);\n", "")
    no_copies = no_copies.replace("  load_chunk(0);  // Q rides in the first group\n", "")
    no_products = _cut(src, "#pragma unroll\n      for (int cc = 0; cc < kKF4 / 4; ++cc) {",
                       "      continue;\n    }\n\n    if (st == nK)")
    no_products = _cut(no_products, "#pragma unroll\n    for (int kk = 0; kk < kVK; ++kk) {",
                       "  sdt::cp_async_wait<0>();\n  if (xc == 0) l_s[xr] = l;")
    no_products = no_products.replace("  sdt::cp_async_wait<0>();\n  if (xc == 0) l_s[xr] = l;",
                                      "  }\n\n  sdt::cp_async_wait<0>();\n  if (xc == 0) l_s[xr] = l;")
    assert src.count("load_chunk(") - no_copies.count("load_chunk(") == 2
    return {"kernel": src, "no_copies": no_copies, "no_products": no_products}


def build(out_dir) -> dict:
    """Compile every variant, one nvcc each, all started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "common.cuh", out_dir / "common.cuh")
    procs = {}
    for name, text in variants().items():
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
               str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).sdt_flash_stream
        fn.argtypes = _build.ENTRIES["flash_stream"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fns = build(_build.BUILD_DIR / "flash_stream_ablation")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for shape in SHAPES:
        q, k, v = (torch.randn(shape, device="cuda") for _ in range(3))
        out, args = _build.attention_launch_args("flash_stream", q, k, v, 168, 1024)
        row = {"shape": list(shape), "skv": shape[1], "dtype": "float32"}
        for name, fn in fns.items():
            launch = lambda: _build.check(name, fn(*args, shape[-1] ** -0.5, stream))  # noqa: E731
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
            row[f"{name}_ms"] = times
        print(json.dumps(row), flush=True)
        del out


if __name__ == "__main__":
    main()
