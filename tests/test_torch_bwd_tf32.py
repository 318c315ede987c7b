"""The fp32 backward kernels' 3xTF32 arithmetic on the CPU: the plain-torch
emulation of their split and products (``utils/testing.
attention_bwd_tf32x3_emulated``: s = q k^T, dp = dO v^T, dV = p^T dO, dK =
scale ds^T q and dQ = scale ds k each from hi*hi + hi*lo + lo*hi, with the
causal mask; not the kernels' order and rounding of sums) against the plain
backward (``ops/attention.flash_bwd_plain``) under the unchanged fp32 rule of
``GRAD_TOL``, at narrow forms of the fp32 path shapes: CLIP's causal
self-attention over 77 tokens (heads of 64), the narrow UNet's D = 40 over
256 tokens and D = 80 over 64 tokens against 77 keys, D = 160 and the
narrowest head dim, 8, ragged on both sides.  Two backwards whose products
are not fp32-accurate, with the same mask, must break that rule at each
shape.  The truncating sums of ``utils/tf32_accumulation`` in the kernels'
order (s in one accumulator over the head dims, dp in one a k-step, the
gradients' products in one a 64-row tile, each added by the FPU) stay within
it; and at CLIP-L's
heads without the mask the JAX package's library flash kernel's backward,
run in Pallas interpret mode, agrees with the port's CPU route and with the
emulation.  The kernels themselves are held on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu_torch.ops.attention import attention_plain_lse, flash_bwd, flash_bwd_plain
from stablediffusion_tpu_torch.utils.testing import (
    attention_bwd_tf32x3_emulated,
    grad_error,
    tf32_bwd_wrong_variants,
)
from torch_port_helpers import port_test_module  # noqa: F401

# (B, Sq, H, D, Skv, causal): CLIP-L's causal self-attention with 3 of its
# 12 heads (two tiles of 64, the second ragged: 77 = 64 + 13), the SDXL
# trainer's batch of 2 with 2 heads, the narrow UNet's self-attention at D =
# 40 and its second level's D = 80 against the 77 text keys, D = 160, and
# D = 8 with ragged Sq and Skv
SHAPES = [(1, 77, 3, 64, 77, True), (2, 77, 2, 64, 77, True), (1, 256, 2, 40, 256, False),
          (2, 64, 2, 80, 77, False), (1, 64, 2, 160, 64, False), (2, 100, 2, 8, 130, False)]


def _case(B, Sq, H, D, Skv, causal, seed=0):
    """q, k, v, dO from a seed with numpy, the plain forward's output and
    lse, and the plain backward on them."""
    r = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(r.standard_normal((B, S, H, D)).astype(np.float32))
                   for S in (Sq, Skv, Skv, Sq))
    out, lse = attention_plain_lse(q, k, v, causal=causal)
    ref = flash_bwd_plain(q, k, v, out, do, lse, causal=causal)
    return (q, k, v, out, do, lse), ref


def _worst(grads, refs):
    return max(grad_error(g, r)["worst_over_limit"] for g, r in zip(grads, refs))


@pytest.mark.parametrize("B, Sq, H, D, Skv, causal", SHAPES)
def test_emulated_backward_within_the_fp32_rule(B, Sq, H, D, Skv, causal):
    args, ref = _case(B, Sq, H, D, Skv, causal)
    grads = attention_bwd_tf32x3_emulated(*args, causal=causal)
    assert [g.shape for g in grads] == [r.shape for r in ref]
    assert _worst(grads, ref) <= 1.0


@pytest.mark.parametrize("B, Sq, H, D, Skv, causal", SHAPES)
def test_products_not_fp32_accurate_break_the_rule(B, Sq, H, D, Skv, causal):
    args, ref = _case(B, Sq, H, D, Skv, causal)
    worst = {n: _worst(w, ref) for n, w in tf32_bwd_wrong_variants(*args, causal=causal).items()}
    assert set(worst) == {"1xTF32", "hi_hilo"} and min(worst.values()) > 1.0, worst


def test_wrong_backwards_keep_the_mask():
    """A wrong backward differs from the causal reference by its products
    alone: without the mask it would differ by O(1), and break the rule for
    the wrong reason."""
    args, ref = _case(1, 77, 3, 64, 77, True)
    for name, wrong in tf32_bwd_wrong_variants(*args, causal=True).items():
        assert max((w - r).abs().max().item() for w, r in zip(wrong, ref)) < 1e-2, name
    unmasked = flash_bwd_plain(*args)
    assert max((u - r).abs().max().item() for u, r in zip(unmasked, ref)) > 0.1


@pytest.mark.parametrize("B, Sq, H, D, Skv, causal", [SHAPES[0], SHAPES[3]])
def test_the_kernels_truncating_order_within_the_rule(B, Sq, H, D, Skv, causal):
    """The tensor core's adds round toward zero (``utils/tf32_accumulation``):
    in the order the kernels add (k-step order; s in one accumulator over the
    head dims, dp's k-steps each in one of their own, dV, dK and dQ one
    accumulator a 64-row tile, the parts added by the FPU) the backward
    keeps the rule."""
    from stablediffusion_tpu_torch.utils.tf32_accumulation import (
        KERNEL_BWD_VARIANT,
        BwdVariant,
        attention_bwd_tc,
    )

    args, ref = _case(B, Sq, H, D, Skv, causal)
    grads = attention_bwd_tc(*args, D**-0.5, causal, BwdVariant.parse(KERNEL_BWD_VARIANT))
    assert _worst(grads, ref) <= 1.0


def test_against_the_jax_library_kernel():
    """CLIP-L's head shape without the mask (the library kernel takes none;
    3 of 12 heads over 77 tokens, which its wrapper pads to 256 with segment
    ids) in fp32: jax.vjp of the JAX package's library flash kernel (its dkv
    and dq Pallas kernels in interpret mode, as tests/test_torch_grad.py runs
    them) against the port's CPU route and the 3xTF32 emulation, under the
    fp32 rule."""
    from jax.experimental.pallas import tpu as pltpu

    from stablediffusion_tpu.ops.attention import _lib_flash

    (q, k, v, out, do, lse), ref = _case(1, 77, 3, 64, 77, False, seed=3)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: _lib_flash(a, b, c, 64**-0.5),
                         *(jnp.asarray(t.numpy()) for t in (q, k, v)))
        lib = [torch.from_numpy(np.array(g, np.float32)) for g in vjp(jnp.asarray(do.numpy()))]
    assert _worst(flash_bwd(q, k, v, out, do, lse), lib) <= 1.0
    assert _worst(attention_bwd_tf32x3_emulated(q, k, v, out, do, lse), lib) <= 1.0
