"""Where `csrc/flash_stream.cu`'s fp32 time goes, on the card, and how it
compares with another version of the source:

    python3 -m stablediffusion_tpu_torch.utils.flash_stream_ablation
    python3 -m stablediffusion_tpu_torch.utils.flash_stream_ablation --against DIR

Builds the kernel as it is and broken copies of it, made from the text of
its source and of hopper.cuh (whose 3xTF32 section holds its products and
the split): "no_products" drops every wgmma (q k^T and p v run on nothing; the
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
from pathlib import Path

import torch

from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.utils import kernel_ablation as ka

# (B, Sq, H, D, Skv): an SD1.5 request's decode (a key split across a
# cluster), a burst decode and the ControlNet trainer's encode, the SD1.5
# train step's encode, an SDXL or SD3 request's decode, the SDXL trainer's
# encode
SHAPES = ((1, 4096, 1, 512, 4096), (4, 4096, 1, 512, 4096), (8, 4096, 1, 512, 4096),
          (1, 16384, 1, 512, 16384), (2, 16384, 1, 512, 16384))

_SPLIT_PASS = ("    split_atom_tf32(gbase + L::kRing + st * kTfStageBytes, tid);\n",
               "    named_bar_sync(2 + wg, 128);\n")
_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;\n",
          "  hi = __float_as_uint(x);\n  lo = 0u;\n")
_MERGE = ("    if (!stores) {   // send this half of o^T to the block that stores it\n",
          "    cluster_sync();\n  }\n  if (stores) {\n")


def variants() -> dict:
    """name -> {file: text} of the files each variant changes."""
    src = (_build.CSRC / "flash_stream.cu").read_text()
    hdr = (_build.CSRC / "hopper.cuh").read_text()
    assert hdr.count(_SPLIT[0]) == 1
    no_split = {"flash_stream.cu": ka.cut(src, *_SPLIT_PASS, keep_end=False),
                "hopper.cuh": hdr.replace(*_SPLIT)}
    # the 3xTF32 products: hopper.cuh's qk_kstep and vt_p_product
    no_products = ka.drop_calls(hdr, "wgmma_tf32_n64")
    return {"kernel": {}, "no_products": {"hopper.cuh": no_products},
            "no_copies": {"flash_stream.cu": ka.no_copies(src, 4)}, "no_split": no_split,
            "ring_only": {**no_split,
                          "hopper.cuh": ka.drop_calls(no_split["hopper.cuh"], "wgmma_tf32_n64")},
            "products_only": {**no_split,
                              "flash_stream.cu": ka.no_copies(no_split["flash_stream.cu"], 4)},
            "no_merge": {"flash_stream.cu": ka.cut(src, *_MERGE)}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a directory with another flash_stream.cu to time beside this one")
    against = parser.parse_args().against
    print(ka.card(), flush=True)
    out_dir = _build.BUILD_DIR / "flash_stream_ablation"
    if against is None:
        sources = ka.write_sources(out_dir, "flash_stream", variants())
    else:
        sources = {"other": against.resolve() / "flash_stream.cu",
                   "kernel": _build.CSRC / "flash_stream.cu"}
    libs = ka.build(out_dir, sources, ["flash_stream"], report=lambda u: "tf32" in u["kernel"])
    fns = {name: lib.sdt_flash_stream for name, lib in libs.items()}
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
                row[f"{name}_ms"] = ka.event_ms(launch)
            else:
                row.setdefault(f"{name}_ms", []).append(ka.device_ms(launch, "flash_stream"))
        print(json.dumps(row), flush=True)
        del q, k, v, out


if __name__ == "__main__":
    main()
