"""Where the backward kernels' time goes (`csrc/flash_bwd.cu`), on the card,
and how they compare with another version of the source:

    python3 -m stablediffusion_tpu_torch.utils.flash_bwd_ablation
    python3 -m stablediffusion_tpu_torch.utils.flash_bwd_ablation --against DIR
    (either with --dtype bfloat16 or float32: that dtype's shapes only)

Builds the kernels as they are and four broken copies of them, made from
their source text: "no_exp" takes p as the scaled logit itself (no
exponential; the rest of the softmax arithmetic stays), "no_first_products"
drops s = q k^T and dp = dO v^T (dq) and their transposes (dkv), which then
run on zeroed registers, "no_second_products" drops dQ += ds k (dq) and
dV += p^T dO, dK += ds^T q (dkv) (the softmax, whose only use is their
input, goes with them), and "ring_only" drops both, leaving the copies,
barriers and epilogue.  The fp32 (3xTF32) kernels have one: "dp_unflushed"
adds dp's products over the head dims in one accumulator, as s's, where the
kernels add each k-step's into an accumulator of its own (the cost of that
flush).  Times flash_bwd_dkv and flash_bwd_dq of each at the main path's
bf16 shapes and the fp32 CLIP shapes, each the median of 20 launches'
device times under torch.profiler after a warm-up, and prints one JSON line
per case, after the card's name and power limit.  The copies' outputs are of no use; only their
times are.

With ``--against DIR`` (a directory holding another ``flash_bwd.cu`` and the
headers it includes, such as the source of an earlier commit unpacked by
``git archive``) it builds that source beside this one instead and times
both kernels of both at every bf16 and fp32 shape the card's paths launch
(PATH_SHAPES), each the median of 20 launches' device times under
torch.profiler after a warm-up, in the order other, this, this, other.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.ops.attention import _row_dot
from stablediffusion_tpu_torch.utils import kernel_ablation as ka

# (B, Sq, H, D, Skv, causal, dtype): SD3 training's joint stream, SD1.5's
# heaviest and its cross-attention, the SDXL trainer's heaviest (bf16); the
# SDXL trainer's CLIP-L and bigG towers (fp32, causal)
_BF16, _F32 = torch.bfloat16, torch.float32
SHAPES = ((1, 4250, 24, 64, 4250, False, _BF16), (8, 4096, 8, 40, 4096, False, _BF16),
          (8, 4096, 8, 40, 77, False, _BF16), (2, 4096, 10, 64, 4096, False, _BF16),
          (2, 77, 12, 64, 77, True, _F32), (2, 77, 20, 64, 77, True, _F32))
# every backward shape of chip_smoke.py's train paths: in bf16 SD1.5 LoRA at
# batch 8 (and 2, its variants), the SDXL trainer, SD3 training, the
# ControlNet trainer at batch 4, phase 8's causal CLIP shape; in fp32 the
# SDXL trainer's and its textual inversion's two towers, the narrow fp32
# train reference's UNet (batch 2: 256 tokens at D = 40, 64 at D = 80, each
# also against the 77 text keys), and every fp32 shape phase 8 holds (the
# SD1.5 LoRA step's in fp32, CLIP's at batch 8, a ragged length)
PATH_SHAPES = tuple(
    (B, S, 8, D, skv, False, _BF16) for B in (8, 4, 2)
    for S, D in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for skv in (S, 77)
) + ((2, 4096, 10, 64, 4096, False, _BF16), (2, 4096, 10, 64, 77, False, _BF16),
     (2, 1024, 20, 64, 1024, False, _BF16), (2, 1024, 20, 64, 77, False, _BF16),
     (1, 4250, 24, 64, 4250, False, _BF16), (8, 77, 12, 64, 77, True, _BF16),
     (2, 77, 12, 64, 77, True, _F32), (2, 77, 20, 64, 77, True, _F32),
     (2, 256, 8, 40, 256, False, _F32), (2, 256, 8, 40, 77, False, _F32),
     (2, 64, 8, 80, 64, False, _F32), (2, 64, 8, 80, 77, False, _F32),
     (8, 77, 12, 64, 77, True, _F32), (2, 1101, 8, 64, 1101, False, _F32)) + tuple(
    (8, S, 8, D, skv, False, _F32)
    for S, D in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for skv in (S, 77))

_EXP_DKV = "const float pe = exp2_approx(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x) * kLog2e));"
_EXP_DQ = "s[x] = p.scale * exp2_approx(fmaf(s[x], sl2, -lse2[r])) * (dp[x] - dd[r]);"
_FIRST = ("    kmajor_product<D16, BQ, L::kKeys>(s, k_tile, q_tile);\n",
          "    if constexpr (DK) kmajor_product<D16, BQ, L::kKeys>(dp, v_tile, do_tile);\n",
          "        kmajor_product<D16, BK, L::kRows>(s, qt, k_tile);\n",
          "        kmajor_product<D16, BK, L::kRows>(dp, dot, sV + st * L::kKVBytes);\n")
_SECOND = ("    if constexpr (DV) mnmajor_product<NC, BQ>(dv, pa, do_tile);\n",
           "    if constexpr (DK) mnmajor_product<NC, BQ>(dk, da, q_tile);\n",
           "        mnmajor_product<NC, BK>(dq, da, k_tile);\n")

_DP_FLUSHED = "headdim_product<true>(wg, dp"


def _drop(src: str, lines) -> str:
    for line in lines:
        assert src.count(line) == 1, line
        src = src.replace(line, "")
    return src


def variants() -> dict:
    """name -> {file: text} of the files each variant changes."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    assert src.count(_EXP_DKV) == 1 and src.count(_EXP_DQ) == 1
    no_exp = src.replace(_EXP_DKV, "const float pe = fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x));")
    no_exp = no_exp.replace(_EXP_DQ, "s[x] = p.scale * fmaf(s[x], sl2, -lse2[r]) * (dp[x] - dd[r]);")
    assert src.count(_DP_FLUSHED) == 2
    texts = {"no_exp": no_exp, "no_first_products": _drop(src, _FIRST),
             "no_second_products": _drop(src, _SECOND),
             "ring_only": _drop(_drop(src, _FIRST), _SECOND),
             "dp_unflushed": src.replace(_DP_FLUSHED, "headdim_product<false>(wg, dp")}
    return {"kernel": {}, **{n: {"flash_bwd.cu": t} for n, t in texts.items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a directory with another flash_bwd.cu to time beside this one")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                        help="time the shapes of this dtype only")
    opts = parser.parse_args()
    against = opts.against
    print(ka.card(), flush=True)
    out_dir = _build.BUILD_DIR / "flash_bwd_ablation"
    if against is None:
        sources, shapes = ka.write_sources(out_dir, "flash_bwd", variants()), SHAPES
    else:
        sources = {"other": against.resolve() / "flash_bwd.cu", "kernel": _build.CSRC / "flash_bwd.cu"}
        shapes = PATH_SHAPES
    libs = ka.build(out_dir, sources, ["flash_bwd_dq", "flash_bwd_dkv"])
    fwd = _build.entry("flash_fwd")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Sq, H, D, Skv, causal, dtype in shapes:
        if opts.dtype is not None and dtype != getattr(torch, opts.dtype):
            continue
        causal = int(causal)
        q, k, v = (torch.randn(B, S, H, D, device="cuda", dtype=dtype, generator=g)
                   for S in (Sq, Skv, Skv))
        do = torch.randn_like(q)
        scale = D**-0.5
        out, args = _build.attention_launch_args("flash_fwd", q, k, v, 8, 160)
        lse = torch.empty(B, H, Sq, device="cuda", dtype=torch.float32)
        _build.check("flash_fwd", fwd(*args, scale, causal, ctypes.c_void_p(lse.data_ptr()),
                                      stream))
        di = _row_dot(out, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        row = {"shape": [B, Sq, H, D], "skv": Skv, "causal": bool(causal),
               "dtype": str(dtype).replace("torch.", "")}
        for kernel, outs in (("flash_bwd_dkv", (None, dk, dv)), ("flash_bwd_dq", (dq, None, None))):
            bwd_args = _build.bwd_launch_args(q, k, v, do, lse, di, *outs)
            order = list(libs) if against is None else ["other", "kernel", "kernel", "other"]
            for name in order:
                fn = getattr(libs[name], _build.ENTRIES[kernel][1])
                launch = lambda: _build.check(  # noqa: E731
                    kernel, fn(*bwd_args, scale, causal, stream))
                row.setdefault(f"{kernel}_{name}_ms", []).append(ka.device_ms(launch, kernel))
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, di, dq, dk, dv


if __name__ == "__main__":
    main()
