"""PyTorch/CUDA port: the attention backward and the route rule under grad.

The port's plain backward (``flash_bwd_plain``, the formulation of the two
backward kernels) and torch autograd of ``attention_plain`` (what the CPU
route differentiates) against ``jax.grad`` of the JAX package's attention:
of ``_lib_flash`` run in Pallas interpret mode, as tests/test_ops.py runs the
library kernel on the CPU, at the shapes where the JAX trainers take it
(D = 40 and 80, and a ragged length that takes its segment-id padding), and
of ``attention_xla`` where JAX takes XLA (Skv = 77, D = 160, CLIP's additive
causal mask).  fp32 on both sides.  In bf16, the library's gradients against
``utils/testing.attention_bwd_rounded``, the plain version of the bf16
backward kernels, which round p and ds to bf16 where the library does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.ops.attention import _lib_flash, attention_xla
from stablediffusion_tpu_torch.ops.attention import (
    _route,
    attention,
    attention_plain_lse,
    flash_bwd,
    flash_bwd_plain,
    needs_grad,
)
from stablediffusion_tpu_torch.ops.flash_attention import flash_stream
from stablediffusion_tpu_torch.utils.testing import (
    attention_bwd_rounded,
    attention_bwd_wrong_variants,
    grad_error,
)

# fp32 gradients of O(1) through sums over up to 512 keys on both sides
ATOL = 1e-4


def _inputs(r, B, Sq, H, D, Skv):
    q = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Skv, H, D)).astype(np.float32)
    v = r.standard_normal((B, Skv, H, D)).astype(np.float32)
    do = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, scale, causal):
    """(plain backward, autograd of the CPU route), each (dq, dk, dv)."""
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = attention_plain_lse(*t[:3], scale=scale, causal=causal)
    plain = flash_bwd_plain(*t[:3], out, t[3], lse, scale, causal)
    for a, b in zip(flash_bwd(*t[:3], out, t[3], lse, scale, causal), plain):
        assert torch.equal(a, b)  # the CPU wrapper is the plain version
    leaves = [x.clone().requires_grad_(True) for x in t[:3]]
    o = attention(*leaves, scale=scale, causal=causal)
    assert o.grad_fn is not None
    auto = torch.autograd.grad(o, leaves, t[3])
    return plain, auto


def _check(ref, plain, auto):
    for name, r_, p_, a_ in zip("qkv", ref, plain, auto):
        np.testing.assert_allclose(p_.numpy(), np.asarray(r_), atol=ATOL, err_msg=f"d{name} plain")
        np.testing.assert_allclose(a_.numpy(), np.asarray(r_), atol=ATOL, err_msg=f"d{name} autograd")


@pytest.mark.parametrize(
    "B, Sq, H, D, Skv",
    [(1, 256, 2, 40, 256), (1, 256, 2, 80, 256), (1, 200, 2, 40, 300)],
)
def test_backward_matches_lib_flash_grad(B, Sq, H, D, Skv):
    """jax.grad of the library flash kernel (its dkv and dq Pallas kernels)
    in interpret mode; the last case is ragged in Sq and Skv, which the
    wrapper zero-pads to 256 / 512 and masks with segment ids."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, do = _inputs(np.random.default_rng(D + Sq), B, Sq, H, D, Skv)
    scale = D**-0.5

    def f(q_, k_, v_):
        return jnp.sum(_lib_flash(q_, k_, v_, scale) * do)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _check(ref, *_port_grads(q, k, v, do, scale, False))


@pytest.mark.parametrize(
    "B, Sq, H, D, Skv, causal",
    [(2, 256, 2, 40, 77, False), (2, 64, 2, 160, 77, False), (2, 64, 2, 160, 64, False),
     (2, 77, 3, 64, 77, True)],
)
def test_backward_matches_xla_grad(B, Sq, H, D, Skv, causal):
    """jax.grad of attention_xla, which JAX takes at Skv = 77 and D = 160;
    causal=True against CLIP's additive -inf mask
    (stablediffusion_tpu/models/clip.py:72-74)."""
    q, k, v, do = _inputs(np.random.default_rng(D + Skv), B, Sq, H, D, Skv)
    mask = None
    if causal:
        mask = jnp.asarray(np.where(np.tril(np.ones((Sq, Skv), bool)), 0.0, -np.inf)[None, None],
                           jnp.float32)

    def f(q_, k_, v_):
        return jnp.sum(attention_xla(q_, k_, v_, mask=mask) * do)

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _check(ref, *_port_grads(q, k, v, do, D**-0.5, causal))


def _bf16_lib_case(B, Sq, H, D, Skv):
    """bf16 q, k, v, dO from a seed; the library flash kernel's output and
    its (dq, dk, dv) by jax.vjp in Pallas interpret mode, and the plain
    fp32 lse: the inputs of attention_bwd_rounded as the kernels get them
    (the forward's own output, the row log-sum-exp)."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(np.random.default_rng(D + Sq), B, Sq, H, D, Skv))
    to_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    to_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    scale = D**-0.5
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: _lib_flash(a, b, c, scale), *map(to_jax, (q, k, v)))
        lib = [to_torch(g) for g in vjp(to_jax(do))]
    lse = attention_plain_lse(q.float(), k.float(), v.float(), scale=scale)[1]
    return (q, k, v, to_torch(o), do, lse), lib


@pytest.mark.parametrize(
    "B, Sq, H, D, Skv",
    [(1, 256, 2, 40, 256), (1, 256, 2, 80, 256), (1, 200, 2, 40, 300)],
)
def test_bf16_rounded_backward_matches_lib_flash(B, Sq, H, D, Skv):
    """The library's bf16 backward (its dkv and dq Pallas kernels round p
    and ds to bf16 before their products) lies within the bf16 rule of
    utils/testing.grad_error against attention_bwd_rounded: 2**-8 |ref| +
    2e-5 max|ref| for the output's own rounding and the fp32 order of sums,
    plus 2**-7 of the terms whose p or ds lies near a bf16 rounding midpoint
    (the library's fp32 p and ds differ from the plain ones by the order of
    the sums).  It lies closer to it than to flash_bwd_plain (fp32 p and
    ds), which it fails: the rounding is the library's.  The four wrong
    backwards fail the rule."""
    (q, k, v, o, do, lse), lib = _bf16_lib_case(B, Sq, H, D, Skv)
    scale = D**-0.5
    ref, flips = attention_bwd_rounded(q, k, v, o, do, lse, scale)
    plain = flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), do.float(), lse, scale)
    for name, g, r_, f, p_ in zip(("dq", "dk", "dv"), lib, ref, flips, plain):
        assert grad_error(g, r_, f)["worst_over_limit"] <= 1.0, name
        assert grad_error(g, p_)["worst_over_limit"] > 1.0, name
        assert (g.float() - r_).abs().mean() < (g.float() - p_).abs().mean(), name
    for name, wrong in attention_bwd_wrong_variants(q, k, v, o, do, lse, scale).items():
        worst = max(grad_error(w, r_, f)["worst_over_limit"] for w, r_, f in zip(wrong, ref, flips))
        assert worst > 1.0, name


@pytest.mark.parametrize("variant", ["no_di", "acc_bf16", "ds_unscaled", "lse_max_only"])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_rule_has_teeth(variant, causal):
    """Each wrong bf16 backward breaks the rule against attention_bwd_rounded
    by more than 1x in some gradient, without and with the causal mask, at
    8 query tiles of 64 rows; the output and lse come from the plain
    forward."""
    B, Sq, H, D = 2, 512, 2, 40
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(np.random.default_rng(7), B, Sq, H, D, Sq))
    o, lse = attention_plain_lse(q, k, v, causal=causal)
    ref, flips = attention_bwd_rounded(q, k, v, o, do, lse, causal=causal)
    right = [g.to(torch.bfloat16) for g in ref]
    assert max(grad_error(g, r_, f)["worst_over_limit"] for g, r_, f in zip(right, ref, flips)) <= 1.0
    wrong = attention_bwd_wrong_variants(q, k, v, o, do, lse, causal=causal)[variant]
    assert max(grad_error(w, r_, f)["worst_over_limit"] for w, r_, f in zip(wrong, ref, flips)) > 1.0


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("D, causal", [(40, False), (80, False), (160, False), (64, True),
                                       (8, False), (512, False), (168, False)])
def test_route_under_grad(grad, device, D, causal):
    """The route rule: CPU -> plain; CUDA and D <= 160 -> "flash" (the
    forward with lse and the backward kernels) under grad, "flash_fwd"
    without; CUDA and D > 160 -> "flash_stream" without grad and a
    NotImplementedError naming the missing backward under grad."""
    shape = (2, 77, 2, D)
    if device == "cpu":
        assert _route(shape, shape, causal, device, grad) == "plain"
    elif D <= 160:
        assert _route(shape, shape, causal, device, grad) == ("flash" if grad else "flash_fwd")
    elif grad:
        with pytest.raises(NotImplementedError, match="backward"):
            _route(shape, shape, causal, device, grad)
    else:
        assert _route(shape, shape, causal, device, grad) == "flash_stream"


def test_needs_grad_follows_autograd():
    x = torch.zeros(1, 8, 1, 8)
    y = x.clone().requires_grad_(True)
    assert not needs_grad(x, x, x) and needs_grad(x, y, x)
    with torch.no_grad():
        assert not needs_grad(y, y, y)
    # the CPU wrapper of the forward-only kernel differentiates through its
    # plain version; only the CUDA branch refuses a gradient
    out = flash_stream(y, y, y)
    assert out.grad_fn is not None
