"""The bf16 flash_fwd kernel's key tile has one source of truth: the table
``kBf16Tiles`` in csrc/flash_fwd.cu.  ops/attention.flash_fwd_key_tile mirrors
it for the kernel's plain version (utils/testing.attention_p_rounded rounds p
from the running max of the same key tiles), so the two are read side by
side here: a kernel tile changed without the Python one would make the rule
hold the kernel against the wrong reference."""

import re
from pathlib import Path

import pytest
import torch

from stablediffusion_tpu_torch.ops.attention import (
    FLASH_FWD_BF16_TILES,
    FLASH_FWD_MAX_D,
    flash_fwd_key_tile,
)
from stablediffusion_tpu_torch.utils.testing import attention_p_rounded

SOURCE = (Path(__file__).resolve().parent.parent / "stablediffusion_tpu_torch" / "csrc"
          / "flash_fwd.cu").read_text()


def _cuda_tiles() -> dict:
    """{padded width: key tile} from the kernel source's kBf16Tiles."""
    m = re.search(r"constexpr int kBf16Tiles\[\]\[\d\] = \{(.*?)\};", SOURCE, re.S)
    assert m, "kBf16Tiles not found in csrc/flash_fwd.cu"
    rows = re.findall(r"\{\s*(\d+)\s*,\s*(\d+)[^}]*\}", m.group(1))
    return {int(dp): int(bk) for dp, bk in rows}


def _cuda_dispatch() -> dict:
    """{k16 steps of the head dim: D16 of the instantiation launched}."""
    body = SOURCE[SOURCE.index("cudaError_t dispatch_bf16"):]
    body = body[:body.index("\n}\n")]
    cases = {int(n): int(d16) for n, d16 in
             re.findall(r"case (\d+): return launch_wgmma<(\d+)>", body)}
    default = re.search(r"default: return launch_wgmma<(\d+)>", body)
    assert default, "dispatch_bf16 has no default instantiation"
    cases[int(default.group(1)) // 16] = int(default.group(1))
    return cases


def test_python_table_is_the_kernels():
    assert FLASH_FWD_BF16_TILES == _cuda_tiles()


@pytest.mark.parametrize("D", range(8, FLASH_FWD_MAX_D + 1, 8))
def test_key_tile_matches_the_kernel(D):
    """At every head dim the bf16 kernel takes: the instantiation dispatched
    rounds D up to a multiple of 16, its shared tiles to the smallest padded
    width of kBf16Tiles that holds it, and its key tile is that width's, as
    flash_fwd_key_tile says."""
    tiles, dispatch = _cuda_tiles(), _cuda_dispatch()
    d16 = dispatch[-(-D // 16)]
    assert d16 >= D and d16 % 16 == 0 and d16 - D < 16
    dp = min(w for w in tiles if w >= d16)
    assert flash_fwd_key_tile(D) == (dp, tiles[dp])


@pytest.mark.parametrize("D, Skv", [(40, 300), (160, 200)])
def test_p_rounded_defaults_to_the_kernels_tile(D, Skv):
    """The plain version of the kernel's p rounding takes the kernel's key
    tile when no block is given."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, S, 2, D, generator=g).to(torch.bfloat16) for S in (33, Skv, Skv))
    tile = flash_fwd_key_tile(D)[1]
    out, flips = attention_p_rounded(q, k, v)
    ref, ref_flips = attention_p_rounded(q, k, v, block=tile)
    assert torch.equal(out, ref) and torch.equal(flips, ref_flips)
