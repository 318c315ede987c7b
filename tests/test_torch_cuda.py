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
from stablediffusion_tpu_torch.utils.testing import (
    attention_bwd_rounded,
    attention_p_rounded,
    grad_error,
    kernel_error,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _within_limit(out, plain, q, k, v, p_rounded=False, **kw):
    """The kernel's output against the plain version evaluated in fp32 on the
    same input values, under the per-element limit of KERNEL_TOL (stated
    there with its reason); with `p_rounded` (the bf16 flash_fwd, which
    rounds p to bf16) the plain version is attention_p_rounded, and the
    limit takes its term for p near a rounding midpoint."""
    if p_rounded:
        err = kernel_error(out, *attention_p_rounded(q, k, v, **kw))
    else:
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
     (3, 100, 2, 24, 50, False), (2, 300, 2, 40, 4100, False),
     (2, 1101, 8, 64, 1101, False), (1, 1101, 4, 24, 77, False),
     (1, 200, 2, 40, 200, True), (2, 64, 8, 160, 77, False)],
)
def test_flash_fwd_matches_plain(cuda, dtype, B, Sq, H, D, Skv, causal):
    """Every head-dim bucket of both kernels, with the bf16 tensor-core
    kernel's traps: D = 24 and 40 (the k16 steps read zero-filled columns up
    to the next multiple of 16), Skv = 77 and 4100 (a ragged last key tile,
    whose V rows must be zero in shared memory), ragged Sq = 1101, causal.
    The lse written when a backward follows is finite on every row (every
    row sees at least one key, so none is fully masked; the kernels would
    give such a row -1e30 + log of its count) and matches the plain one."""
    q, k, v = _qkv(cuda, dtype, B, Sq, H, D, Skv)
    before = FLASH_FWD_LAUNCHES.count
    out = flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_FWD_LAUNCHES.count == before + 1
    _within_limit(out, attention_plain, q, k, v, p_rounded=dtype == torch.bfloat16,
                  causal=causal)
    with torch.no_grad():
        out_lse, lse = _fwd_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(out_lse, out) and torch.isfinite(lse).all()
    ref_lse = attention_plain_lse(q.float(), k.float(), v.float(), causal=causal)[1]
    assert kernel_error(lse, ref_lse)["worst_over_limit"] <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Sq, H, D, Skv", [
    (1, 4096, 1, 512, 4100), (1, 300, 2, 192, 77), (1, 64, 1, 1024, 33),
    (8, 4096, 1, 512, 4096), (1, 1001, 1, 512, 4096), (2, 77, 1, 520, 130)])
def test_flash_stream_matches_plain(cuda, dtype, B, Sq, H, D, Skv):
    """Every head-dim bucket, the VAE's [1|8, 4096, 1, 512], a ragged Sq and
    a head dim that leaves a partial K chunk (520 = 8 * 64 + 8)."""
    q, k, v = _qkv(cuda, dtype, B, Sq, H, D, Skv)
    before = FLASH_STREAM_LAUNCHES.count
    out = flash_stream(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_STREAM_LAUNCHES.count == before + 1
    _within_limit(out, flash_stream_plain, q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_inputs(cuda, dtype):
    """q/k/v read by stride: slices of a fused [B, S, 3, H, D] projection."""
    qkv = torch.randn(2, 128, 3, 4, 64, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    _within_limit(attention(q, k, v), attention_plain, q, k, v,
                  p_rounded=dtype == torch.bfloat16)


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


def _bwd_within_rule(grads, q, k, v, out, do, lse, causal):
    """Each gradient against the plain backward evaluated in fp32 on the same
    q, k, v, dO, forward output and lse, under GRAD_TOL (stated there with
    its reason): fp32 against flash_bwd_plain; bf16 against
    attention_bwd_rounded, which rounds p and ds to bf16 where the kernels
    and the JAX library do, plus 2**-7 of its flip term."""
    if q.dtype == torch.bfloat16:
        refs, flips = attention_bwd_rounded(q, k, v, out, do, lse, causal=causal)
    else:
        refs = flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), do.float(), lse,
                               causal=causal)
        flips = (None,) * 3
    for g, r, f in zip(grads, refs, flips):
        assert g.dtype == q.dtype and g.shape == r.shape
        err = grad_error(g, r, f)
        assert err["worst_over_limit"] <= 1.0, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, Sq, H, D, Skv, causal",
    [(2, 1024, 8, 40, 1024, False), (2, 256, 4, 80, 77, False),
     (2, 256, 4, 160, 256, False), (2, 77, 12, 64, 77, True),
     (3, 100, 2, 24, 50, False), (1, 130, 2, 160, 200, True),
     (8, 77, 12, 64, 77, True), (2, 1101, 8, 64, 1101, False),
     (1, 300, 2, 80, 1101, False), (2, 1101, 2, 40, 77, False),
     (1, 200, 2, 24, 300, True), (2, 64, 8, 160, 77, False),
     (1, 200, 2, 128, 150, False), (1, 100, 2, 96, 130, True),
     (1, 90, 2, 136, 100, False)],
)
def test_flash_bwd_matches_plain(cuda, dtype, B, Sq, H, D, Skv, causal):
    """Both backward kernels against their plain version (_bwd_within_rule)
    at every head-dim bucket and at the tensor-core kernels' traps: D = 24,
    40 and 136 (the k16 steps read zero-filled columns up to the next
    multiple of 16, and no column past D is stored), D = 128 and up (dkv's
    two warps per 16 keys), Skv = 77, 50 and 1101 (a ragged last key tile),
    ragged Sq (100, 130, 1101, 300), causal (CLIP's [8, 77, 12, 64], and
    tiles cut by the diagonal).  The forward's lse against
    attention_plain_lse."""
    q, k, v = _qkv(cuda, dtype, B, Sq, H, D, Skv)
    do = torch.randn_like(q)
    with torch.no_grad():
        out, lse = _fwd_with_lse(q, k, v, causal)
    ref_lse = attention_plain_lse(q.float(), k.float(), v.float(), causal=causal)[1]
    assert kernel_error(lse, ref_lse)["worst_over_limit"] <= 1.0
    before = (FLASH_BWD_DQ_LAUNCHES.count, FLASH_BWD_DKV_LAUNCHES.count)
    grads = flash_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DQ_LAUNCHES.count, FLASH_BWD_DKV_LAUNCHES.count) == (before[0] + 1, before[1] + 1)
    _bwd_within_rule(grads, q, k, v, out, do, lse, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs give bit-identical
    gradients."""
    q, k, v = _qkv(cuda, dtype, 2, 1024, 4, 40, 1024)
    do = torch.randn_like(q)
    with torch.no_grad():
        out, lse = _fwd_with_lse(q, k, v, False)
    first = flash_bwd(q, k, v, out, do, lse)
    second = flash_bwd(q, k, v, out, do, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B, Sq, H, D, Skv, causal",
                         [(2, 300, 4, 40, 300, False), (2, 256, 4, 80, 77, False),
                          (2, 77, 12, 64, 77, True), (1, 128, 2, 160, 130, False)])
def test_flash_attn_fn_bf16_matches_rounded(cuda, B, Sq, H, D, Skv, causal):
    """bf16 gradients through FlashAttnFn (the forward with lse, then both
    backward kernels), with dO a transposed view so that the wrapper's
    layout check makes it contiguous, against attention_bwd_rounded
    evaluated on the forward's own output and lse, under the bf16 rule."""
    q, k, v = _qkv(cuda, torch.bfloat16, B, Sq, H, D, Skv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves, causal=causal)
    assert out.grad_fn is not None and "FlashAttnFn" in type(out.grad_fn).__name__
    do = torch.randn(B, H, Sq, D, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    grads = torch.autograd.grad(out, leaves, do)
    with torch.no_grad():
        out_lse, lse = _fwd_with_lse(q, k, v, causal)
    assert torch.equal(out_lse, out.detach())
    _bwd_within_rule(grads, q, k, v, out.detach(), do, lse, causal)


def _fwd_with_lse(q, k, v, causal):
    from stablediffusion_tpu_torch.ops.attention import _launch_fwd

    return _launch_fwd(q, k, v, q.shape[-1] ** -0.5, causal, with_lse=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_fn_matches_plain_autograd(cuda, causal):
    """Gradients through FlashAttnFn (the kernels) against torch autograd of
    attention_plain, fp32, with dO strided (a transposed view) so that the
    wrapper's layout check acts.  (fp32 runs the scalar kernels; bf16
    through FlashAttnFn is test_flash_attn_fn_bf16_matches_rounded.)"""
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
