"""The fp32 flash_fwd's 3xTF32 arithmetic on the CPU: the plain-torch
emulation of its split and products over its 64-key tiles, with the causal
mask and the log-sum-exp (``utils/testing.attention_tf32x3_emulated``, which
does not emulate the kernel's order and rounding of sums), against the plain
version under the unchanged fp32 rule of ``KERNEL_TOL``, at narrow forms of
the fp32 path shapes: CLIP's causal self-attention over 77 tokens (heads of
64), the IP-Adapter's ViT-bigG/14 head (D = 104 over 257 tokens) and the
narrowest head dim, 8.  Two products that are not fp32-accurate, with the
same mask and key tiles, must break that rule at each shape; and at the
ViT-bigG shape the JAX package's library flash kernel, run in Pallas
interpret mode, agrees with the port's CPU route and with the emulation.
Last, the rounding of ``utils/tf32_accumulation``, which emulates the
tensor core's truncating sums.  The kernel itself is held on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu_torch.ops.attention import attention_plain_lse, flash_fwd
from stablediffusion_tpu_torch.utils.testing import (
    attention_tf32x3_emulated,
    kernel_error,
    tf32_wrong_variants,
)
from torch_port_helpers import port_test_module  # noqa: F401

# (B, Sq, H, D, Skv, causal): CLIP-L's causal self-attention with 3 of its
# 12 heads (two key tiles, the second ragged: 77 = 64 + 13), the SDXL
# trainer's batch of 2 with 2 heads, ViT-bigG/14's head over 257 tokens
# (five key tiles, the last of one key), and D = 8 with ragged Sq and Skv
SHAPES = [(1, 77, 3, 64, 77, True), (2, 77, 2, 64, 77, True),
          (1, 257, 2, 104, 257, False), (2, 100, 2, 8, 130, False)]


def _qkv(B, Sq, H, D, Skv, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, S, H, D)).astype(np.float32) for S in (Sq, Skv, Skv)]


@pytest.mark.parametrize("B, Sq, H, D, Skv, causal", SHAPES)
def test_emulation_within_the_fp32_rule(B, Sq, H, D, Skv, causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, Sq, H, D, Skv))
    out, lse = attention_tf32x3_emulated(q, k, v, causal=causal)
    ref, ref_lse = attention_plain_lse(q, k, v, causal=causal)
    assert out.shape == q.shape and lse.shape == (B, H, Sq)
    assert kernel_error(out, ref)["worst_over_limit"] <= 1.0
    assert kernel_error(lse, ref_lse)["worst_over_limit"] <= 1.0


@pytest.mark.parametrize("B, Sq, H, D, Skv, causal", SHAPES)
def test_products_not_fp32_accurate_break_the_rule(B, Sq, H, D, Skv, causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, Sq, H, D, Skv))
    ref = attention_plain_lse(q, k, v, causal=causal)[0]
    worst = {n: kernel_error(w, ref)["worst_over_limit"]
             for n, w in tf32_wrong_variants(q, k, v, causal).items()}
    assert set(worst) == {"1xTF32", "hi_hilo"} and min(worst.values()) > 1.0, worst


def test_wrong_variants_keep_the_mask():
    """A wrong variant differs from the causal reference by its products
    alone: without the mask it would differ by O(1) on every row but the
    last, and break the rule for the wrong reason."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 77, 3, 64, 77))
    ref = attention_plain_lse(q, k, v, causal=True)[0]
    for name, wrong in tf32_wrong_variants(q, k, v, causal=True).items():
        assert (wrong - ref).abs().max().item() < 1e-2, name
    unmasked = attention_plain_lse(q, k, v)[0]
    assert (unmasked - ref).abs().max().item() > 0.1


def test_vit_head_against_the_jax_library_kernel():
    """ViT-bigG/14's head shape (D = 104 over 257 tokens, 2 of 16 heads) in
    fp32 through the JAX package's library flash kernel in Pallas interpret
    mode (``_lib_flash``, as tests/test_torch_ops.py runs it), against the
    port's CPU route and the 3xTF32 emulation, under the fp32 rule."""
    from jax.experimental.pallas import tpu as pltpu

    from stablediffusion_tpu.ops.attention import _lib_flash

    arrays = _qkv(1, 257, 2, 104, 257, seed=3)
    with pltpu.force_tpu_interpret_mode():
        lib = np.asarray(_lib_flash(*(jnp.asarray(a) for a in arrays), 104**-0.5))
    lib = torch.from_numpy(lib.astype(np.float32))
    q, k, v = (torch.from_numpy(a) for a in arrays)
    assert kernel_error(flash_fwd(q, k, v), lib)["worst_over_limit"] <= 1.0
    assert kernel_error(attention_tf32x3_emulated(q, k, v)[0], lib)["worst_over_limit"] <= 1.0


def test_round_toward_zero_and_the_truncating_product():
    """utils/tf32_accumulation's emulation of the tensor core's adds: fp64
    to fp32 toward zero (never away from it, exact values kept), and a
    product of positive operands whose truncating sums lie at or below the
    round-to-nearest ones, by less than 1e-6 relative."""
    from stablediffusion_tpu_torch.utils.tf32_accumulation import round_toward_zero, tc_product

    x = torch.tensor([1.0 + 2.0**-30, -(1.0 + 2.0**-30), 0.75, -3.0], dtype=torch.float64)
    assert round_toward_zero(x).tolist() == [1.0, -1.0, 0.75, -3.0]
    r = np.random.default_rng(1)
    a = torch.from_numpy(r.uniform(0.5, 1.0, (16, 64)).astype(np.float32))
    b = torch.from_numpy(r.uniform(0.5, 1.0, (64, 16)).astype(np.float32))
    for small_first in (False, True):
        down = tc_product(a, b, truncate=True, small_first=small_first)
        near = tc_product(a, b, truncate=False, small_first=small_first)
        assert (down <= near).all() and ((near - down) / near).max().item() < 1e-6
