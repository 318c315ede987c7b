"""PyTorch/CUDA port on the card: each CUDA kernel against its plain version,
and the wrappers' refusals.  Needs an NVIDIA GPU and nvcc; without a card
every test skips.  On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from stablediffusion_tpu_torch.ops.attention import (
    FLASH_FWD_LAUNCHES,
    attention,
    attention_plain,
    flash_fwd,
)
from stablediffusion_tpu_torch.ops.flash_attention import (
    FLASH_STREAM_LAUNCHES,
    flash_stream,
    flash_stream_plain,
)
from stablediffusion_tpu_torch.utils.testing import kernel_error

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
