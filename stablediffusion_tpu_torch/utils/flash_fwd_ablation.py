"""Where `csrc/flash_fwd.cu`'s fp32 (3xTF32) time goes, on the card, and how
it compares with another version of the source:

    python3 -m stablediffusion_tpu_torch.utils.flash_fwd_ablation
    python3 -m stablediffusion_tpu_torch.utils.flash_fwd_ablation --against DIR

Builds the kernel as it is and broken copies of it, made from the text of
its source and of hopper.cuh (whose 3xTF32 section holds its products and
the split): "no_products" drops every wgmma (q k^T and p v run on nothing;
the copies, the splits, the softmax and the barriers stay), "no_copies"
issues no TMA copy (each stage's barrier is arrived on without bytes, so
the products run on whatever shared memory holds) and "no_split" leaves
every operand unsplit (hi = x, lo = 0, and no split pass over the K atoms:
the products still run), "free_v" loads no V (o^T += v^T p^T takes a
constant as its A: what building v^T in registers costs, the most that
writing V transposed for an A = p product could save) and "no_p_store"
writes no p tiles (what p's trip through shared memory costs);
"one_warpgroup" is another design, not a broken copy:
warpgroup 0 walks every key tile of its 64 rows and warpgroup 1 idles, where
the kernel gives the two warpgroups alternate key tiles and merges their
halves.  Times each at the fp32 shapes of the card's paths (SHAPES), the
median of 20 launches' device times under torch.profiler after a warm-up
(these kernels take microseconds, less than a launch's host work), and
prints one JSON line per shape, after the card's name and power limit and
the registers and spills that ptxas reports for each build's 3xTF32
kernels.  The broken copies' outputs are of no use; only their times are.

With ``--against DIR`` (a directory holding another ``flash_fwd.cu`` and the
headers it includes, such as the source of an earlier commit unpacked by
``git archive``) it builds that source beside this one instead and times the
fp32 forward of both at every shape, each the median of 20 launches' device
times under torch.profiler after a warm-up, in the order other, this, this,
other.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.utils import kernel_ablation as ka

# (B, Sq, H, D, Skv, causal, lse): the IP-Adapter image encoders (ViT-bigG/14
# on an SDXL request, ViT-H/14 on SD1.5), CLIP-L on an SD1.5 request and its
# burst of 4, bigG on an SDXL request, the SDXL trainer's CLIP-L and bigG
# (with the lse for the backward)
SHAPES = ((1, 257, 16, 104, 257, False, False), (1, 257, 16, 80, 257, False, False),
          (1, 77, 12, 64, 77, True, False), (4, 77, 12, 64, 77, True, False),
          (1, 77, 20, 64, 77, True, False), (2, 77, 12, 64, 77, True, True),
          (2, 77, 20, 64, 77, True, True))

_SPLIT_PASS = ("    split_atom_tf32(gbase + stage_off(wg, c), tid);\n",)
_V_LOADS = tuple((f"vk[off[{k}][{c}]]", "1.f") for k in range(2) for c in range(2))
_P_STORE = ("      store_p_pair(p_tiles, kPLo, row0 + 8 * r, i >> 2, p0, p1);\n",)
_ONE_WARPGROUP = (
    ("      const int total = (n_tiles - w + 1) / 2 * per;\n",
     "      const int total = w == 0 ? n_tiles * per : 0;\n"),
    ("        const int k0 = (w + 2 * (c / per)) * kTfKeys;\n",
     "        const int k0 = (c / per) * kTfKeys;\n"),
    ("  for (int j = wg, c = 0; j < n_tiles; j += 2, c += per) {\n",
     "  for (int j = 0, c = 0; wg == 0 && j < n_tiles; ++j, c += per) {\n"))
_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;\n",
          "  hi = __float_as_uint(x);\n  lo = 0u;\n")


def variants() -> dict:
    """name -> {file: text} of the files each variant changes."""
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    hdr = (_build.CSRC / "hopper.cuh").read_text()
    assert hdr.count(_SPLIT[0]) == 1
    one, free_v = src, hdr
    for old, new in _ONE_WARPGROUP:
        assert one.count(old) == 1, old
        one = one.replace(old, new)
    for old, new in _V_LOADS:
        assert free_v.count(old) == 1, old
        free_v = free_v.replace(old, new)
    # the 3xTF32 products: hopper.cuh's qk_kstep and vt_p_product
    return {"kernel": {}, "no_products": {"hopper.cuh": ka.drop_calls(hdr, "wgmma_tf32_n64")},
            "no_copies": {"flash_fwd.cu": ka.no_copies(src, 4)},
            "no_split": {"flash_fwd.cu": ka.drop_lines(src, _SPLIT_PASS),
                         "hopper.cuh": hdr.replace(*_SPLIT)},
            "free_v": {"hopper.cuh": free_v},
            "no_p_store": {"flash_fwd.cu": ka.drop_lines(src, _P_STORE)},
            "one_warpgroup": {"flash_fwd.cu": one}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a directory with another flash_fwd.cu to time beside this one")
    against = parser.parse_args().against
    print(ka.card(), flush=True)
    out_dir = _build.BUILD_DIR / "flash_fwd_ablation"
    if against is None:
        sources = ka.write_sources(out_dir, "flash_fwd", variants())
    else:
        sources = {"other": against.resolve() / "flash_fwd.cu",
                   "kernel": _build.CSRC / "flash_fwd.cu"}
    libs = ka.build(out_dir, sources, ["flash_fwd"],
                    report=lambda u: not u["kernel"].startswith("flash_fwd_wgmma"))
    fns = {name: lib.sdt_flash_fwd for name, lib in libs.items()}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Sq, H, D, Skv, causal, with_lse in SHAPES:
        q = torch.randn(B, Sq, H, D, device="cuda", generator=g)
        k, v = (torch.randn(B, Skv, H, D, device="cuda", generator=g) for _ in range(2))
        out, args = _build.attention_launch_args("flash_fwd", q, k, v, 8, 160)
        lse = torch.empty(B, H, Sq, device="cuda") if with_lse else None
        lse_ptr = ctypes.c_void_p(None if lse is None else lse.data_ptr())
        row = {"shape": [B, Sq, H, D], "skv": Skv, "causal": causal, "lse": with_lse,
               "dtype": "float32"}
        order = list(fns) if against is None else ["other", "kernel", "kernel", "other"]
        for name in order:
            fn = fns[name]
            launch = lambda: _build.check(  # noqa: E731
                name, fn(*args, D**-0.5, int(causal), lse_ptr, stream))
            row.setdefault(f"{name}_ms", []).append(ka.device_ms(launch, "flash_fwd"))
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse


if __name__ == "__main__":
    main()
