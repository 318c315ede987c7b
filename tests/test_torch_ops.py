"""PyTorch/CUDA port: ops/basic.py and the plain attention versions against
their JAX counterparts, in fp32 on the CPU.

Same numpy inputs go to both.  Layout conversions: the JAX ops take NHWC
activations, HWIO conv kernels and (in, out) linear kernels; the port takes
NCHW, OIHW and (out, in).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.ops import basic as J
from stablediffusion_tpu.ops.attention import attention_xla
from stablediffusion_tpu_torch.ops import basic as T
from stablediffusion_tpu_torch.ops.attention import (
    attention,
    attention_plain,
    flash_fwd,
)
from stablediffusion_tpu_torch.ops._build import attention_launch_args, ptxas_usage
from stablediffusion_tpu_torch.ops.flash_attention import (
    flash_stream,
    flash_stream_plain,
)

# fp32 elementwise/normalisation ops on both sides: only evaluation order and
# libm differ (a few ulp); 1e-5 absolute at O(1) values
ATOL = 1e-5
# fp32 GEMM/conv/attention reductions over up to a few hundred terms
ATOL_RED = 3e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.transpose(a, (0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def r():
    return np.random.default_rng(0)


def test_linear(r):
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    w = r.standard_normal((16, 24)).astype(np.float32)
    b = r.standard_normal((24,)).astype(np.float32)
    ref = J.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    out = T.linear(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_RED)


@pytest.mark.parametrize("k, stride, pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv2d(r, k, stride, pad):
    x = r.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = r.standard_normal((k, k, 6, 10)).astype(np.float32) * 0.2
    b = r.standard_normal((10,)).astype(np.float32)
    ref = J.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                   jnp.asarray(x), stride=stride, padding=pad)
    out = T.conv2d(_nchw(x), _t(np.transpose(w, (3, 2, 0, 1))), _t(b),
                   stride=stride, padding=pad)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL_RED)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm(r, eps, silu):
    x = (r.standard_normal((2, 6, 6, 16)) * 3 + 1).astype(np.float32)
    g = r.standard_normal((16,)).astype(np.float32)
    b = r.standard_normal((16,)).astype(np.float32)
    p = {"weight": jnp.asarray(g), "bias": jnp.asarray(b)}
    jf = J.group_norm_silu if silu else J.group_norm
    tf = T.group_norm_silu if silu else T.group_norm
    ref = jf(p, jnp.asarray(x), 4, eps)
    out = tf(_nchw(x), _t(g), _t(b), 4, eps)
    # JAX takes var = E[x^2] - E[x]^2, torch the two-pass variance: at
    # |mean| ~ 1, std ~ 3 that costs a few fp32 ulp of the statistics
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL_RED)


def test_layer_norm(r):
    x = (r.standard_normal((2, 7, 32)) * 2 + 0.5).astype(np.float32)
    g = r.standard_normal((32,)).astype(np.float32)
    b = r.standard_normal((32,)).astype(np.float32)
    ref = J.layer_norm({"weight": jnp.asarray(g), "bias": jnp.asarray(b)},
                       jnp.asarray(x), eps=1e-5)
    out = T.layer_norm(_t(x), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_RED)


@pytest.mark.parametrize("name", ["silu", "gelu", "quick_gelu"])
def test_activations(r, name):
    x = (r.standard_normal((64,)) * 4).astype(np.float32)
    ref = getattr(J, name)(jnp.asarray(x))
    out = getattr(T, name)(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert T.ACTIVATIONS[name] is getattr(T, name)


def test_geglu(r):
    x = r.standard_normal((2, 5, 8)).astype(np.float32)
    w = r.standard_normal((8, 32)).astype(np.float32) * 0.3
    b = r.standard_normal((32,)).astype(np.float32)
    ref = J.geglu({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    out = T.geglu(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_RED)


@pytest.mark.parametrize("dim, flip, shift", [(320, True, 0), (320, False, 1), (33, True, 0)])
def test_timestep_embedding(dim, flip, shift):
    t = np.array([1, 261, 981], np.int32)
    ref = J.timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip, freq_shift=shift)
    out = T.timestep_embedding(_t(t), dim, flip_sin_to_cos=flip, freq_shift=shift)
    assert out.dtype == torch.float32 and out.shape == (3, dim)
    # sin/cos of arguments up to ~1e3 in fp32: the argument itself carries
    # ~6e-5 of rounding, which both sides share up to libm differences
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_upsample_nearest_2x(r):
    x = r.standard_normal((1, 3, 4, 5)).astype(np.float32)
    ref = J.upsample_nearest_2x(jnp.asarray(x))
    np.testing.assert_array_equal(_nhwc(T.upsample_nearest_2x(_nchw(x))), np.asarray(ref))


# -- attention --------------------------------------------------------------


def _qkv(r, B, Sq, H, D, Skv):
    q = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Skv, H, D)).astype(np.float32)
    v = r.standard_normal((B, Skv, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("D", [40, 80, 160])
def test_plain_attention_causal_matches_additive_mask(r, D):
    """causal=True against attention_xla with CLIP's additive causal mask
    (stablediffusion_tpu/models/clip.py:72-74), at Skv = 77."""
    q, k, v = _qkv(r, 2, 77, 2, D, 77)
    mask = np.where(np.tril(np.ones((77, 77), bool)), 0.0, -np.inf)[None, None]
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask, jnp.float32))
    out = attention_plain(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_RED)
    # the CPU route of the entry point and of the kernel wrapper is the plain one
    np.testing.assert_array_equal(attention(_t(q), _t(k), _t(v), causal=True).numpy(), out.numpy())
    np.testing.assert_array_equal(flash_fwd(_t(q), _t(k), _t(v), causal=True).numpy(), out.numpy())


@pytest.mark.parametrize("D, Sq, Skv", [(40, 256, 77), (80, 64, 64), (160, 16, 77)])
def test_plain_attention_matches_xla(r, D, Sq, Skv):
    q, k, v = _qkv(r, 2, Sq, 3, D, Skv)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3)
    out = attention(_t(q), _t(k), _t(v), scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_RED)


def test_plain_attention_additive_mask(r):
    q, k, v = _qkv(r, 1, 8, 2, 16, 12)
    mask = (r.standard_normal((1, 2, 8, 12)) * 3).astype(np.float32)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    out = attention(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_RED)


@pytest.mark.parametrize(
    "B, Sq, H, D, Skv",
    [(1, 2048, 4, 40, 2048), (1, 2048, 1, 512, 2048), (1, 200, 1, 512, 1100)],
)
def test_plain_streaming_matches_pallas_interpret(r, B, Sq, H, D, Skv):
    """The streaming kernel's plain version against the Pallas kernel run in
    interpret mode, as tests/test_ops.py runs it; the last case has a ragged
    key length (the kernel's tail mask)."""
    from jax.experimental.pallas import tpu as pltpu

    from stablediffusion_tpu.ops.flash_attention import flash_attention_streaming

    q, k, v = _qkv(r, B, Sq, H, D, Skv)
    with pltpu.force_tpu_interpret_mode():
        ref = flash_attention_streaming(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = flash_stream_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_array_equal(flash_stream(_t(q), _t(k), _t(v)).numpy(), out.numpy())


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA argument check raises on what the kernels do not take: here
    tensors that do not lie on a CUDA device."""
    x = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attention_launch_args("flash_fwd", x, x, x, 8, 160)


def test_ptxas_usage_reads_registers_and_spills():
    """chip_smoke.py's register report: nvcc's ``-Xptxas -v`` lines of two
    kernels (a template instance with a spill, one with a type argument)
    read back as name, registers and spilled bytes."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1a_12_flash_bwd_cu_2b"
        "23flash_bwd_dkv_tc_kernelILi80EEEvNS_9BwdParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    16 bytes stack frame, 16 bytes spill stores, 36 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1c_15_flash_stream_cu_3d"
        "19flash_stream_kernelI13__nv_bfloat16Li512EEEvNS_12StreamParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 254 registers, used 1 barriers",
    ])
    assert ptxas_usage(log) == [
        {"kernel": "flash_bwd_dkv_tc_kernel<80>", "registers": 255, "spill_bytes": 52},
        {"kernel": "flash_stream_kernel<bf16, 512>", "registers": 254, "spill_bytes": 0},
    ]


# (B, Sq, H, D, Skv, the key block _lib_flash picks): more than one key
# block, so the JAX kernel runs its online softmax (with one block it
# normalises p before rounding it); 2100 keys are padded to 2304
@pytest.mark.parametrize("B, Sq, H, D, Skv, block",
                         [(1, 256, 2, 40, 2048, 1024), (2, 128, 2, 64, 2100, 256)])
def test_bf16_p_rounding_rule_has_teeth(r, B, Sq, H, D, Skv, block):
    """The bf16 rule of utils/testing.kernel_error against
    attention_p_rounded (p rounded to bf16 from the running max of each key
    tile): the JAX library flash kernel in bf16, run in Pallas interpret
    mode, lies within it against its own key blocks, where the plain
    version in fp32 without the rounding rejects it; forwards that
    skip the accumulator's rescale, scale the logits twice, or keep the
    accumulator in bf16 between 64-key tiles all break it by a large
    factor."""
    from jax.experimental.pallas import tpu as pltpu

    from stablediffusion_tpu.ops.attention import _lib_flash
    from stablediffusion_tpu_torch.utils.testing import (
        attention_p_rounded,
        attention_wrong_variants,
        kernel_error,
    )

    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(r, B, Sq, H, D, Skv))
    with pltpu.force_tpu_interpret_mode():
        lib = _lib_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                         D**-0.5)
    lib = torch.from_numpy(np.array(lib.astype(jnp.float32))).to(torch.bfloat16)
    assert kernel_error(lib, *attention_p_rounded(q, k, v, block=block))["worst_over_limit"] <= 1.0
    assert kernel_error(lib, attention_plain(q.float(), k.float(), v.float()))[
        "worst_over_limit"] > 1.0
    ref, flips = attention_p_rounded(q, k, v)
    for name, wrong in attention_wrong_variants(q, k, v).items():
        assert kernel_error(wrong, ref, flips)["worst_over_limit"] > 10.0, name
