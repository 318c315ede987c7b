"""The fp32 flash_stream's 3xTF32 split on the CPU: TF32 rounding on known
bit patterns, the split, and the plain-torch emulation of its three products
(``utils/testing.attention_tf32x3_emulated``, which does not emulate the
kernel's order and rounding of sums) against the plain version under the
unchanged fp32 rule of ``KERNEL_TOL``; two products that are not
fp32-accurate (operands rounded to TF32 once; hi*hi + hi*lo only) must break
that rule at the same shapes.  The kernel itself is held on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3)."""

import numpy as np
import pytest
import torch

from stablediffusion_tpu_torch.ops.flash_attention import flash_stream_plain
from stablediffusion_tpu_torch.utils.testing import (
    attention_tf32x3_emulated,
    kernel_error,
    tf32_round,
    tf32_split,
    tf32_wrong_variants,
)
from torch_port_helpers import port_test_module  # noqa: F401

# (B, Sq, H, D, Skv): two heads at D = 192 over 77 keys, a width past 512
# with a ragged key tile, the VAE's 512-wide head with one key past the tiles
SHAPES = [(1, 300, 2, 192, 77), (2, 77, 1, 520, 130), (1, 512, 1, 512, 513)]


def _bits(x: int) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("x, want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),  # below the midpoint: down
    (0x3F801000, 0x3F802000),  # the midpoint: away from zero
    (0xBF801000, 0xBF802000),  # the negative midpoint: away from zero
    (0x3F801001, 0x3F802000),  # above it: up
    (0x3FFFF000, 0x40000000),  # a carry into the exponent: 2 - 2**-12 -> 2.0
    (0x00001000, 0x00002000),  # a subnormal midpoint
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
])
def test_tf32_round_bit_patterns(x, want):
    got = tf32_round(_bits(x)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, (hex(x), hex(got), hex(want))


def test_tf32_round_keeps_nan():
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


def test_tf32_split_is_exact_to_2_pow_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()  # TF32 values
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * x.double().abs()).all()


def _qkv(B, Sq, H, D, Skv):
    r = np.random.default_rng(0)
    return [torch.from_numpy(r.standard_normal((B, S, H, D)).astype(np.float32))
            for S in (Sq, Skv, Skv)]


@pytest.mark.parametrize("B, Sq, H, D, Skv", SHAPES)
def test_emulation_within_the_fp32_rule(B, Sq, H, D, Skv):
    q, k, v = _qkv(B, Sq, H, D, Skv)
    err = kernel_error(attention_tf32x3_emulated(q, k, v)[0], flash_stream_plain(q, k, v))
    assert err["worst_over_limit"] <= 1.0, err


@pytest.mark.parametrize("B, Sq, H, D, Skv", SHAPES)
def test_products_not_fp32_accurate_break_the_rule(B, Sq, H, D, Skv):
    q, k, v = _qkv(B, Sq, H, D, Skv)
    ref = flash_stream_plain(q, k, v)
    worst = {n: kernel_error(w, ref)["worst_over_limit"]
             for n, w in tf32_wrong_variants(q, k, v).items()}
    assert set(worst) == {"1xTF32", "hi_hilo"} and min(worst.values()) > 1.0, worst
