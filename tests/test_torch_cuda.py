"""PyTorch/CUDA port on the card: each CUDA kernel against its plain version,
attention under autograd, and the wrappers' refusals.  Needs an NVIDIA GPU
and nvcc; without a card every test skips.  On the card (its machine has no
jax, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from stablediffusion_tpu_torch.ops.attention import (
    FLASH_BWD_DKV_LAUNCHES,
    FLASH_BWD_DQ_LAUNCHES,
    FLASH_FWD_LAUNCHES,
    attention,
    attention_plain,
    attention_plain_lse,
    flash_bwd,
    flash_bwd_plain,
    flash_fwd,
)
from stablediffusion_tpu_torch.ops.flash_attention import (
    FLASH_STREAM_LAUNCHES,
    flash_stream,
    flash_stream_plain,
)
from stablediffusion_tpu_torch.utils.testing import grad_error, kernel_error

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _within_limit(out, plain, q, k, v, **kw):
    """The kernel's output against the plain version evaluated in fp32 on the
    same input values, under the per-element limit of KERNEL_TOL (stated
    there with its reason)."""
    err = kernel_error(out, plain(q.float(), k.float(), v.float(), **kw))
    assert err["worst_over_limit"] <= 1.0, err


def _qkv(device, dtype, B, Sq, H, D, Skv):
    g = torch.Generator(device=device).manual_seed(0)
    return [torch.randn(B, S, H, D, device=device, dtype=dtype, generator=g)
            for S in (Sq, Skv, Skv)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, Sq, H, D, Skv, causal",
    [(2, 4096, 8, 40, 4096, False), (2, 1024, 8, 80, 77, False),
     (2, 256, 8, 160, 256, False), (2, 77, 12, 64, 77, True),
     (3, 100, 2, 24, 50, False)],
)
def test_flash_fwd_matches_plain(cuda, dtype, B, Sq, H, D, Skv, causal):
    q, k, v = _qkv(cuda, dtype, B, Sq, H, D, Skv)
    before = FLASH_FWD_LAUNCHES.count
    out = flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_FWD_LAUNCHES.count == before + 1
    _within_limit(out, attention_plain, q, k, v, causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq, H, D, Skv", [(4096, 1, 512, 4100), (300, 2, 192, 77), (64, 1, 1024, 33)])
def test_flash_stream_matches_plain(cuda, dtype, Sq, H, D, Skv):
    q, k, v = _qkv(cuda, dtype, 1, Sq, H, D, Skv)
    before = FLASH_STREAM_LAUNCHES.count
    out = flash_stream(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_STREAM_LAUNCHES.count == before + 1
    _within_limit(out, flash_stream_plain, q, k, v)


def test_strided_inputs(cuda):
    """q/k/v read by stride: slices of a fused [B, S, 3, H, D] projection."""
    qkv = torch.randn(2, 128, 3, 4, 64, device=cuda)
    q, k, v = qkv.unbind(2)
    _within_limit(attention(q, k, v), attention_plain, q, k, v)


def test_refusals(cuda):
    q = torch.randn(1, 16, 1, 64, device=cuda)
    with pytest.raises(NotImplementedError):
        attention(q, q, q, mask=torch.zeros(1, 1, 16, 16, device=cuda))
    with pytest.raises(ValueError):
        flash_fwd(torch.randn(1, 16, 1, 36, device=cuda), *[torch.randn(1, 16, 1, 36, device=cuda)] * 2)
    with pytest.raises(TypeError):
        flash_fwd(q.half(), q.half(), q.half())
    odd = torch.randn(1, 16, 1, 65, device=cuda)[..., :64]  # rows 65 elements apart
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd(odd, odd, odd)
    with pytest.raises(NotImplementedError):
        wide = torch.randn(1, 16, 1, 512, device=cuda)
        attention(wide, wide, wide, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, Sq, H, D, Skv, causal",
    [(2, 1024, 8, 40, 1024, False), (2, 256, 4, 80, 77, False),
     (2, 256, 4, 160, 256, False), (2, 77, 12, 64, 77, True),
     (3, 100, 2, 24, 50, False), (1, 130, 2, 160, 200, True)],
)
def test_flash_bwd_matches_plain(cuda, dtype, B, Sq, H, D, Skv, causal):
    """Both backward kernels against flash_bwd_plain evaluated in fp32 on the
    same q, k, v, dO, forward output and lse, under GRAD_TOL; ragged and
    causal cases included.  The forward's lse against attention_plain_lse."""
    q, k, v = _qkv(cuda, dtype, B, Sq, H, D, Skv)
    do = torch.randn_like(q)
    with torch.no_grad():
        out, lse = _fwd_with_lse(q, k, v, causal)
    ref_out, ref_lse = attention_plain_lse(q.float(), k.float(), v.float(), causal=causal)
    assert kernel_error(lse, ref_lse)["worst_over_limit"] <= 1.0
    before = (FLASH_BWD_DQ_LAUNCHES.count, FLASH_BWD_DKV_LAUNCHES.count)
    grads = flash_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DQ_LAUNCHES.count, FLASH_BWD_DKV_LAUNCHES.count) == (before[0] + 1, before[1] + 1)
    refs = flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), do.float(), lse,
                           causal=causal)
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and g.shape == r.shape
        err = grad_error(g, r)
        assert err["worst_over_limit"] <= 1.0, err


def _fwd_with_lse(q, k, v, causal):
    from stablediffusion_tpu_torch.ops.attention import _launch_fwd

    return _launch_fwd(q, k, v, q.shape[-1] ** -0.5, causal, with_lse=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_fn_matches_plain_autograd(cuda, causal):
    """Gradients through FlashAttnFn (the kernels) against torch autograd of
    attention_plain, fp32, with dO strided (a transposed view) so that the
    wrapper's layout check acts."""
    q, k, v = _qkv(cuda, torch.float32, 2, 200, 3, 40, 200 if causal else 77)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves, causal=causal)
    assert out.grad_fn is not None and "FlashAttnFn" in type(out.grad_fn).__name__
    do = torch.randn(out.shape[0], out.shape[2], out.shape[1], out.shape[3],
                     device=cuda).transpose(1, 2)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(attention_plain(*ref_leaves, causal=causal), ref_leaves, do)
    for g, r in zip(got, ref):
        assert grad_error(g, r)["worst_over_limit"] <= 1.0
    with torch.no_grad():
        torch.testing.assert_close(out, attention_plain(q, k, v, causal=causal),
                                   rtol=0, atol=1e-5)


def test_wide_heads_refuse_grad(cuda):
    """No backward kernel takes D > 160: under grad the entry point and the
    flash_stream wrapper raise rather than return an output without a
    grad_fn; under no_grad they run."""
    wide = torch.randn(1, 64, 1, 512, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        attention(wide, wide, wide)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_stream(wide, wide, wide)
    with torch.no_grad():
        assert attention(wide, wide, wide).shape == wide.shape


def test_inference_writes_no_lse(cuda):
    """Under no_grad, or with no input requiring grad, the forward launches
    without lse, as the inference path always did; under grad with lse."""
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 64, 2, 40, 64)
    FLASH_FWD_LAUNCHES.reset()
    with torch.no_grad():
        attention(q, k, v)
    attention(q, k, v)
    assert all(not key[4] for key in FLASH_FWD_LAUNCHES.by_shape)
    assert FLASH_FWD_LAUNCHES.count == 2
    attention(q.requires_grad_(True), k, v)
    assert sum(n for key, n in FLASH_FWD_LAUNCHES.by_shape.items() if key[4]) == 1
