"""PyTorch/CUDA port on the card: each CUDA kernel against its plain version,
attention under autograd, and the wrappers' refusals.  Needs an NVIDIA GPU
and nvcc; without a card every test skips.  On the card (its machine has no
jax, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from stablediffusion_tpu_torch.ops.attention import (
    ATTENTION_MASKED_LAUNCHES,
    FLASH_BWD_DKV_LAUNCHES,
    FLASH_BWD_DQ_LAUNCHES,
    FLASH_FWD_LAUNCHES,
    attention,
    attention_plain,
    attention_plain_lse,
    flash_bwd,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_key_tile,
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
    rounds p to bf16) the plain version is attention_p_rounded over the
    kernel's key tiles, and the limit takes its term for p near a rounding
    midpoint."""
    if p_rounded:
        tile = flash_fwd_key_tile(q.shape[-1])[1]
        err = kernel_error(out, *attention_p_rounded(q, k, v, block=tile, **kw))
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
     (1, 200, 2, 40, 200, True), (2, 64, 8, 160, 77, False),
     (2, 4096, 10, 64, 4096, False), (2, 1024, 20, 64, 1024, False),
     (2, 4096, 10, 64, 77, False), (2, 77, 20, 64, 77, True),
     # the bf16 instantiations not above (one per k16 count of the head dim:
     # 8, 96, 104, 128, 136), over ragged Sq and Skv, and causal at a
     # padded width of 128 and 192
     (2, 300, 2, 8, 333, False), (1, 257, 3, 96, 4100, False),
     (2, 1101, 4, 104, 1101, False), (1, 500, 2, 128, 129, True),
     (1, 333, 2, 136, 77, False), (1, 700, 2, 160, 700, True),
     (2, 4429, 4, 40, 4429, False)],
)
def test_flash_fwd_matches_plain(cuda, dtype, B, Sq, H, D, Skv, causal):
    """Every head-dim bucket of both kernels, with the bf16 tensor-core
    kernel's traps: D = 24 and 40 (the k16 steps read zero-filled columns up
    to the next multiple of 16, and the padding of a 64-column swizzle
    atom), D = 80, 104 and 160 (two and three atoms), Skv = 77, 4100 and
    4429 (a ragged last key tile, whose K and V rows TMA must zero-fill),
    ragged Sq = 1101 and 4429 (a partial last query tile), causal.
    SDXL's head dim 64 at 1024² (its self-attention at [2,4096,10,64] and
    [2,1024,20,64], a x77 cross-attention, bigG's causal [2,77,20,64]).
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
    (8, 4096, 1, 512, 4096), (1, 1001, 1, 512, 4096), (2, 77, 1, 520, 130),
    (1, 16384, 1, 512, 16384)])
def test_flash_stream_matches_plain(cuda, dtype, B, Sq, H, D, Skv):
    """Every head-dim bucket, the VAE's [1|8, 4096, 1, 512], the 1024²
    decode's [1, 16384, 1, 512], a ragged Sq and a head dim that leaves a
    partial K chunk (520 = 8 * 64 + 8)."""
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


@pytest.mark.parametrize("D", [40, 64, 80])
def test_strided_views_the_models_pass(cuda, D):
    """The bf16 kernel's tensor maps take each tensor's own strides: the
    MM-DiT's torch.cat of the image and text streams (models/mmdit.py),
    head-split views of one projection ([B, S, H * D] -> [B, S, H, D]), and
    q/k/v sliced out of a fused [B, S, 3 * H * D] projection, at a ragged
    joint length; each equals the kernel on contiguous copies bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, C, H = 2, 1101, 77, 6
    img = torch.randn(B, S, 3 * H * D, device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn(B, C, 3 * H * D, device=cuda, generator=g).to(torch.bfloat16)
    heads = lambda t, i: t[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D))  # noqa: E731
    q, k, v = (torch.cat([heads(img, i), heads(ctx, i)], 1) for i in range(3))
    out = flash_fwd(q, k, v)
    _within_limit(out, attention_plain, q, k, v, p_rounded=True)
    fused = [heads(img, i) for i in range(3)]
    assert not fused[0].is_contiguous()
    out_fused = flash_fwd(*fused)
    torch.cuda.synchronize()
    assert torch.equal(out_fused, flash_fwd(*(t.contiguous() for t in fused)))
    _within_limit(out_fused, attention_plain, *fused, p_rounded=True)


def test_refusals(cuda):
    q = torch.randn(1, 16, 1, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_fwd(torch.randn(1, 16, 1, 36, device=cuda), *[torch.randn(1, 16, 1, 36, device=cuda)] * 2)
    with pytest.raises(TypeError):
        flash_fwd(q.half(), q.half(), q.half())
    odd = torch.randn(1, 16, 1, 65, device=cuda)[..., :64]  # rows 65 elements apart
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd(odd, odd, odd)


def test_flash_fwd_refuses_what_a_tensor_map_cannot_take(cuda):
    """Inputs the bf16 kernel's TMA tensor maps cannot describe raise
    ValueError in the wrapper and launch nothing: a view at a 2-byte offset
    (the map's base must be 16-byte aligned) and a key tensor broadcast
    along the sequence (stride 0)."""
    base = torch.randn(1, 16 * 64 + 1, device=cuda).to(torch.bfloat16)
    shifted = base[:, 1:].view(1, 16, 1, 64)  # 2 bytes past an aligned start
    ok = torch.randn(1, 16, 1, 64, device=cuda).to(torch.bfloat16)
    broadcast = ok[:, :1].expand(1, 16, 1, 64)
    before = FLASH_FWD_LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd(shifted, ok, ok)
    with pytest.raises(ValueError, match="tensor map"):
        flash_fwd(ok, broadcast, ok)
    assert FLASH_FWD_LAUNCHES.count == before
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
     (1, 90, 2, 136, 100, False),
     # the MM-DiT's joint stream in SD3 training: 4250 = 66 * 64 + 26
     # (4096 image + 77 CLIP + 77 T5 tokens at 1024^2), 1178 = 1024 + 154
     # at 512^2, ragged on both sides
     (1, 4250, 24, 64, 4250, False), (2, 1178, 24, 64, 1178, False),
     (2, 4250, 24, 64, 4250, False),
     # the Hopper kernels' traps: lse/di rows that start off a 16-byte
     # boundary (Sq = 4250 at D = 40, Sq = 77 over 300 keys, B * H > 1); the
     # SD1.5 cross shape, 77 keys at B * H = 64 (dkv's 64-key split blocks);
     # causal across several 128-row tiles, with split blocks (24 < 132) and
     # with 128-key blocks (160)
     (3, 4250, 2, 40, 4250, False), (3, 77, 2, 64, 300, False),
     (8, 4096, 8, 40, 77, False), (2, 300, 4, 64, 300, True),
     (4, 600, 8, 64, 600, True)],
)
def test_flash_bwd_matches_plain(cuda, dtype, B, Sq, H, D, Skv, causal):
    """Both backward kernels against their plain version (_bwd_within_rule)
    at every head-dim bucket and at the Hopper kernels' traps: D = 24, 40
    and 136 (the k16 steps read zero-filled columns up to the next multiple
    of 16, and no column past D is stored), D = 80 and up (dkv's warpgroups
    split by gradient), Skv = 77, 50 and 1101 (a ragged last key tile, and
    dkv's 64-key blocks that split the query tiles where 128-key blocks
    would not fill the card), ragged Sq (100, 130, 1101, 300, 77), the SD3
    joint stream's 4250 and 1178 on both sides (the last query tile's rows
    and the last key tile's keys live in part, and the lse/di rows start off
    a 16-byte boundary; the gradients start uninitialised, so a row left
    unwritten shows), causal (CLIP's [8, 77, 12, 64], and tiles cut by the
    diagonal).  The forward's lse against attention_plain_lse."""
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
    assert all(torch.isfinite(g).all() for g in grads)
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


def test_flash_attn_fn_takes_an_expanded_dout(cuda):
    """bf16 gradients through FlashAttnFn when autograd hands in dO expanded
    along the sequence (the gradient of a sum over it: stride 0, which the
    16-byte loads would take but no TMA map can), against
    attention_bwd_rounded on the same dO, under the bf16 rule."""
    from stablediffusion_tpu_torch.ops._build import tma_mappable, vector_loadable

    B, S, H, D = 2, 300, 4, 64
    q, k, v = _qkv(cuda, torch.bfloat16, B, S, H, D, S)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves)
    g = torch.randn(B, H, D, device=cuda, dtype=torch.bfloat16)
    do = g.unsqueeze(1).expand(B, S, H, D)
    assert vector_loadable(do) and not tma_mappable(do)
    grads = torch.autograd.grad(out.sum(dim=1), leaves, g)
    with torch.no_grad():
        _, lse = _fwd_with_lse(q, k, v, False)
    _bwd_within_rule(grads, q, k, v, out.detach(), do, lse, False)


def test_flash_bwd_refuses_what_a_tensor_map_cannot_take(cuda):
    """A bf16 q broadcast along the sequence (stride 0) passes the 16-byte
    load check but no TMA map can read it: the backward's wrapper raises a
    ValueError that names q and launches neither kernel."""
    from stablediffusion_tpu_torch.ops.attention import flash_bwd_dkv, flash_bwd_dq

    q, k, v = _qkv(cuda, torch.bfloat16, 1, 64, 2, 64, 64)
    do = torch.randn_like(q)
    with torch.no_grad():
        out, lse = _fwd_with_lse(q, k, v, False)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    broadcast = q[:, :1].expand_as(q)
    before = (FLASH_BWD_DQ_LAUNCHES.count, FLASH_BWD_DKV_LAUNCHES.count)
    for fn in (flash_bwd_dkv, flash_bwd_dq):
        with pytest.raises(ValueError, match="flash_bwd: q cannot be read through a TMA"):
            fn(broadcast, k, v, do, lse, di, 0.125)
    assert (FLASH_BWD_DQ_LAUNCHES.count, FLASH_BWD_DKV_LAUNCHES.count) == before


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


# -- the serving slice: schedulers, checkpoint folders, the handler -----------


def _tiny_model(device, dtype=torch.float32, seed=0):
    """A tiny SD1.5-layout model with random weights and a char-level
    tokenizer whose ids fit the tiny 1000-row table."""
    from stablediffusion_tpu_torch.core import config as tcfg
    from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer
    from stablediffusion_tpu_torch.utils.testing import random_model

    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = 998
    vocab["<|endoftext|>"] = 999
    return random_model(tcfg.tiny_unet_config(), tcfg.tiny_vae_config(),
                        tcfg.tiny_clip_config(), CLIPTokenizer(vocab, []),
                        device=device, dtype=dtype, seed=seed)


@pytest.mark.parametrize("name", ["DPM++ 2M SDE Karras", "euler_a", "uni_pc"])
def test_scheduler_plan_on_card_matches_cpu(cuda, name):
    """A whole 10-step plan on the card against the CPU, fp32, the same
    model outputs and injected step noise: within 1e-5 of max |ref|."""
    from stablediffusion_tpu_torch.schedulers import make_scheduler

    s = make_scheduler(name)
    plan = s.plan(10)
    g = torch.Generator().manual_seed(3)
    shape = (2, 4, 64, 64)
    x0 = torch.randn(shape, generator=g) * plan.init_noise_sigma
    outs = torch.randn((plan.num_steps, *shape), generator=g)
    noise = torch.randn((plan.num_steps, *shape), generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        x, state = x0.to(dev), s.init_state(plan, shape, torch.device(dev))
        for i in range(plan.num_steps):
            out = outs[i].to(dev) + 0.1 * s.scale_model_input(plan, x, i)
            x, state = s.step(plan, state, i, out, x,
                              noise=noise[i].to(dev) if s.uses_noise() else None)
        res[dev] = x.cpu()
    assert (res["cuda"] - res["cpu"]).abs().max() <= 1e-5 * res["cpu"].abs().max()


def test_load_sd_model_to_cuda(cuda, tmp_path):
    """A folder saved from the CPU loads onto the card: the UNet and VAE in
    bf16, the text encoder in fp32, every tensor the saved one cast."""
    from stablediffusion_tpu_torch.io.loader import load_sd_model, save_sd_model

    cpu = _tiny_model("cpu")
    save_sd_model(cpu, str(tmp_path))
    got = load_sd_model(str(tmp_path))
    assert got.device.type == "cuda"
    for comp, dtype in (("unet", torch.bfloat16), ("vae", torch.bfloat16),
                        ("text_encoder", torch.float32)):
        sd = getattr(cpu, comp).state_dict()
        for k, v in getattr(got, comp).state_dict().items():
            assert v.dtype == dtype and torch.equal(v.cpu(), sd[k].to(dtype)), (comp, k)


def test_served_request_is_deterministic(cuda):
    """The same request served twice gives the same JPEG bytes: the kernels
    use no atomics and every draw comes from the request's seed."""
    from stablediffusion_tpu_torch.serve.handler import Handler

    h = Handler(model=_tiny_model(cuda))
    req = dict(prompt="a red cat", height=64, width=64, num_inference_steps=4,
               guidance_scale=7.5, seed=11)
    h.model.set_scheduler("euler_a")
    a, b = h(dict(req), "a"), h(dict(req), "b")
    assert "error" not in a, a.get("traceback")
    assert a["images"] == b["images"] and a["seed"] == 11


# -- the adapter slice: in-place LoRA fusion and textual inversion ------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_fusion_on_card(cuda, dtype):
    """Adapters fused in place on the card: each fused weight against the
    plain fuse on the CPU from the same factors within one ulp of its dtype
    plus the fp32 error bound of the two dW sums, which run in other orders
    ((r + 2) unit roundoffs of sum |down_ik * up_kj| times the scale; next
    to a bf16 ulp it is nothing); a scale swap equals the direct fusion bit
    for bit; delete_adapters gives back every weight bit for bit; the
    pristine copies stay on the card."""
    from stablediffusion_tpu_torch.lora import core
    from stablediffusion_tpu_torch.utils.testing import random_lora

    model = _tiny_model(cuda, dtype=dtype, seed=2)
    before = {k: v.clone() for k, v in model.unet.state_dict().items()}
    lora = {"unet": random_lora(model.unet, ("",), rank=4, seed=3, std=0.1)}
    model.load_lora_weights("a", lora)
    model.set_adapters({"a": 0.5})
    model.set_adapters({"a": 0.8})
    fused = {k: v.clone() for k, v in model.unet.state_dict().items()}
    assert all(p.device.type == "cuda" for p in model._pristine["unet"].values())
    cpu_base = {k: v.cpu() for k, v in model._pristine["unet"].items()}
    cpu_lora = {p: {n: t.cpu() for n, t in f.items()} for p, f in lora["unet"].items()}
    ref = core.fuse(model.unet, {"a": cpu_lora}, {"a": 0.8}, base=cpu_base)
    assert set(ref) == set(cpu_base)
    for key, want in ref.items():
        got = fused[key].cpu().float()
        big = torch.maximum(got.abs(), want.float().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent
                          - (24 if dtype == torch.float32 else 8))
        f = cpu_lora[key[:-len(".weight")]]
        r = f["down"].shape[1]
        dw_bound = (r + 2) * 2.0**-24 * 0.8 * (f["alpha"] / r) * (
            f["down"].abs() @ f["up"].abs()).t()
        assert bool(((got - want.float()).abs() <= ulp + dw_bound).all()), key
    model.set_adapters({"a": 0.0})
    assert all(torch.equal(model.unet.state_dict()[k], v) for k, v in before.items())
    model.set_adapters({"a": 0.8})
    assert all(torch.equal(model.unet.state_dict()[k], v) for k, v in fused.items())
    model.delete_adapters()
    assert all(torch.equal(model.unet.state_dict()[k], v) for k, v in before.items())
    assert model._pristine == {}


def test_textual_inversion_rows_on_card(cuda):
    """A textual inversion extends the table on the card in its dtype;
    unloading slices it back bit for bit."""
    model = _tiny_model(cuda, seed=4)
    table0 = model.text_encoder.text_model.embeddings.token_embedding.weight.clone()
    model.load_textual_inversion({"<x>": torch.ones(2, table0.shape[1])})
    t = model.text_encoder.text_model.embeddings.token_embedding.weight
    assert t.device.type == "cuda" and t.dtype == table0.dtype and t.shape[0] == 1002
    model.unload_textual_inversion()
    assert torch.equal(model.text_encoder.text_model.embeddings.token_embedding.weight, table0)


# -- the SD3 slice: the masked route and the ragged joint length --------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_route_counts_its_calls(cuda, dtype):
    """An additive mask on the card (T5's position bias) goes to the plain
    version by design: its own counter moves, no kernel launches, and the
    scale reaches it as given (T5 passes 1.0)."""
    q, k, v = _qkv(cuda, dtype, 2, 256, 4, 64, 256)
    bias = torch.randn(1, 4, 256, 256, device=cuda)
    counts = (ATTENTION_MASKED_LAUNCHES.count, FLASH_FWD_LAUNCHES.count)
    out = attention(q, k, v, mask=bias, scale=1.0)
    assert (ATTENTION_MASKED_LAUNCHES.count, FLASH_FWD_LAUNCHES.count) == (
        counts[0] + 1, counts[1])
    assert torch.equal(out, attention_plain(q, k, v, mask=bias, scale=1.0))
    assert not torch.equal(out, attention_plain(q, k, v, mask=bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, S, H, D", [
    (1, 333, 3, 64), (2, 1357, 24, 64), (2, 4429, 24, 64), (1, 4250, 24, 64),
    (2, 4429, 2, 24), (2, 4429, 2, 40), (1, 4429, 2, 80), (1, 4429, 2, 104),
    (1, 4429, 2, 160)])
def test_flash_fwd_ragged_joint_length(cuda, dtype, B, S, H, D):
    """The MM-DiT's joint attention: one ragged length on both sides (4429
    = 34 * 128 + 77 at 1024² with T5, 4250 in training, 1357 at 512²), at
    head dim 64 and at every other padded width of the bf16 kernel.  The
    last query tile's rows are written (the output starts uninitialised)
    and the keys past Skv are masked."""
    q, k, v = _qkv(cuda, dtype, B, S, H, D, S)
    before = FLASH_FWD_LAUNCHES.count
    out = flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_FWD_LAUNCHES.count == before + 1 and torch.isfinite(out).all()
    _within_limit(out, attention_plain, q, k, v, p_rounded=dtype == torch.bfloat16)


@pytest.mark.parametrize("policy", ["full", "dots", "offload"])
def test_remat_policies_on_card(cuda, policy):
    """A narrow SD1.5-layout UNet (head dims 40 and 80) trained with LoRA in
    fp32 on the card: each remat policy gives the loss and every factor's
    gradient of no remat (fp32 with TF32 off: within 1e-6 of each
    tensor's largest element), with exact launches: no remat launches each
    UNet attention's forward with lse once, a remat policy twice (the
    backward recomputes it); one backward pair each either way; CLIP's
    causal forwards without lse and the VAE's flash_stream once."""
    import dataclasses

    from stablediffusion_tpu_torch.core.config import SD15_TEXT_ENCODER, SD15_UNET, VAEConfig
    from stablediffusion_tpu_torch.lora.core import UNET_TARGET_SUFFIXES, init_lora
    from stablediffusion_tpu_torch.models.unet import BasicTransformerBlock
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.train.train_step import TrainStatics, loss_fn
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        SD15_UNET, sample_size=16, block_out_channels=(320, 640),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1)
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device=cuda,
                             dtype=torch.float32, seed=3)
        frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
        n_tf = sum(isinstance(m, BasicTransformerBlock) for m in model.unet.modules())
        g = torch.Generator(device=cuda).manual_seed(1)
        batch = {"pixel_values": torch.rand(2, 32, 32, 3, generator=g, device=cuda) * 2 - 1,
                 "input_ids": torch.randint(0, 49407, (2, 77), generator=g, device=cuda)}
        draws = {"latent_eps": torch.randn(2, 4, 16, 16, generator=g, device=cuda),
                 "noise": torch.randn(2, 4, 16, 16, generator=g, device=cuda),
                 "timesteps": torch.tensor([17, 630], device=cuda)}
        lora = init_lora(model.unet, 4, UNET_TARGET_SUFFIXES, g, store_alpha=False)
        for f in lora.values():  # non-zero up: zeros give zero down gradients
            f["up"].normal_(0, 0.05, generator=g)
        out, launches = {}, {}
        for p in ("none", policy):
            st = TrainStatics(unet_config=ucfg, vae_config=vcfg, text_config=tcfg,
                              text_config_2=None, scheduler_config=model.scheduler_config,
                              train_text_encoder=False, snr_gamma=5.0,
                              compute_dtype=torch.float32, remat_policy=p)
            trainable = {"unet": {k: {n: t.clone() for n, t in f.items()}
                                  for k, f in lora.items()}}
            leaves = [t.requires_grad_(True) for _, t in tree_leaves(trainable)]
            counters = (FLASH_FWD_LAUNCHES, FLASH_BWD_DQ_LAUNCHES, FLASH_BWD_DKV_LAUNCHES,
                        FLASH_STREAM_LAUNCHES)
            before = [c.count for c in counters]
            lse_before = sum(n for key, n in FLASH_FWD_LAUNCHES.by_shape.items() if key[4])
            loss = loss_fn(trainable, frozen, batch, None, st, DDPMScheduler(), draws=draws)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            lse = sum(n for key, n in FLASH_FWD_LAUNCHES.by_shape.items() if key[4]) - lse_before
            fwd, dq, dkv, stream = (c.count - b for c, b in zip(counters, before))
            launches[p] = dict(with_lse=lse, without=fwd - lse, dq=dq, dkv=dkv, stream=stream)
            out[p] = [loss.detach()] + list(grads)
        assert launches["none"] == dict(with_lse=2 * n_tf, without=2, dq=2 * n_tf,
                                        dkv=2 * n_tf, stream=1)
        assert launches[policy] == dict(launches["none"], with_lse=4 * n_tf)
        for a, b in zip(out["none"], out[policy]):
            torch.testing.assert_close(b, a, rtol=0,
                                       atol=1e-6 * max(1.0, a.abs().max().item()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _int8_layer(kind, mode, cin, cout, k=3, stride=1, padding=1, seed=0):
    from stablediffusion_tpu_torch.ops.quant import quantized_layer

    torch.manual_seed(seed)
    m = (torch.nn.Linear(cin, cout) if kind == "linear"
         else torch.nn.Conv2d(cin, cout, k, stride=stride, padding=padding))
    return quantized_layer(m, mode)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("rows", [2, 154])
def test_int8_linear_on_card_matches_cpu(cuda, mode, rows):
    """fp32 on both devices: w8a8's codes and int32 sums are exact, so the
    card equals the CPU bit for bit; rows below the int8 GEMM's minimum are
    zero-padded and counted."""
    from stablediffusion_tpu_torch.ops.quant import INT8_LINEAR_CALLS, int8_linear

    torch.backends.cuda.matmul.allow_tf32 = False
    m = _int8_layer("linear", mode, 320, 640)
    x = torch.randn(rows, 320, generator=torch.Generator().manual_seed(1))
    ref = int8_linear(m, x)
    INT8_LINEAR_CALLS.reset()
    out = int8_linear(m.to(cuda), x.to(cuda))
    assert INT8_LINEAR_CALLS.by_mode[mode] == 1
    assert INT8_LINEAR_CALLS.padded == int(mode == "w8a8" and rows < 17)
    if mode == "w8a8":
        assert torch.equal(out.cpu(), ref)
    else:
        torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("k, stride, padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_int8_conv2d_on_card_matches_cpu(cuda, mode, k, stride, padding):
    from stablediffusion_tpu_torch.ops.quant import INT8_CONV_CALLS, int8_conv2d

    torch.backends.cudnn.allow_tf32 = False
    m = _int8_layer("conv", mode, 64, 128, k, stride, padding)
    x = torch.randn(2, 64, 16, 16, generator=torch.Generator().manual_seed(2))
    ref = int8_conv2d(m, x, stride, padding)
    INT8_CONV_CALLS.reset()
    out = int8_conv2d(m.to(cuda), x.to(cuda), stride, padding)
    assert INT8_CONV_CALLS.by_mode[mode] == 1
    if mode == "w8a8":
        assert torch.equal(out.cpu(), ref)
    else:
        torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)


def test_int8_gemm_refusal_raises_on_card(cuda):
    """An inner size the card's int8 GEMM refuses (not a multiple of 8)
    raises; nothing falls back to a floating-point product."""
    from stablediffusion_tpu_torch.ops.quant import int8_linear

    m = _int8_layer("linear", "w8a8", 12, 64).to(cuda)
    with pytest.raises(RuntimeError):
        int8_linear(m, torch.randn(32, 12, device=cuda))


# -- the pipeline extensions: new attention shapes, card against the CPU -----


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Sq, H, D, Skv", [
    (2, 4096, 8, 40, 4), (2, 1024, 8, 80, 16), (2, 256, 8, 160, 4), (2, 64, 8, 160, 16),
    (2, 4096, 10, 64, 4), (2, 1024, 20, 64, 16),  # IP-Adapter's image keys
    (1, 257, 16, 80, 257), (1, 257, 16, 104, 257),  # ViT-H/14, ViT-bigG/14
    (1, 16, 12, 64, 273),  # the Plus resampler
    (1, 4096, 8, 40, 4096), (3, 1024, 8, 80, 77),  # PAG's half, IP2P's three rows
])
def test_flash_fwd_at_the_extension_shapes(cuda, dtype, B, Sq, H, D, Skv):
    """The extensions' new shapes: key lengths of 4 and 16 (one ragged key
    tile), D = 104 (the <128> instantiation), a 16-query resampler over 273
    keys, batch 1 and 3."""
    q, k, v = _qkv(cuda, dtype, B, Sq, H, D, Skv)
    out = flash_fwd(q, k, v)
    torch.cuda.synchronize()
    _within_limit(out, attention_plain, q, k, v, p_rounded=dtype == torch.bfloat16)


@pytest.mark.parametrize("extra", [
    dict(freeu=True), dict(pag_scale=2.0, pag_applied_layers=("down", "mid", "up")),
    dict(cache_interval=2), dict(prompt_weighting=True, prompt="a (red:1.3) [cat:dog:0.5]"),
    dict(hires_scale=2.0), dict(control_image=True), dict(ip_adapter_image=True),
], ids=["freeu", "pag", "deepcache", "weighting", "hires", "controlnet", "ip_adapter"])
def test_extensions_on_card_match_cpu(cuda, extra, tmp_path):
    """Each extension through the kernels on the card against the plain
    attention on the CPU, fp32, the same weights and injected latents."""
    import copy

    import numpy as np

    from stablediffusion_tpu_torch.core.config import tiny_clip_vision_config
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils.testing import (
        write_controlnet_folder,
        write_image_encoder_folder,
        write_ip_adapter_file,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = dict(extra)
    cpu = _tiny_model("cpu")
    card = copy.deepcopy(cpu)
    for c in ("unet", "vae", "text_encoder"):
        setattr(card, c, getattr(card, c).to(cuda))
    models = {"cpu": cpu, cuda: card}
    if extra.pop("control_image", False):
        write_controlnet_folder(str(tmp_path / "cn"), models["cpu"].unet_config, device="cpu",
                                dtype=torch.float32, seed=1)
        extra["control_image"] = np.random.default_rng(0).uniform(0, 1, (64, 64, 3))
    if extra.pop("ip_adapter_image", False):
        vcfg = tiny_clip_vision_config()
        write_image_encoder_folder(str(tmp_path / "image_encoder"), vcfg, device="cpu",
                                   dtype=torch.float32, seed=2)
        write_ip_adapter_file(str(tmp_path / "ip.safetensors"), models["cpu"].unet_config, vcfg,
                              plus=True, num_tokens=4, depth=1, heads=1, dim=32,
                              dtype=torch.float32)
        extra["ip_adapter_image"] = np.random.default_rng(1).uniform(0, 1, (32, 32, 3))
    outs = {}
    for d, m in models.items():
        if "control_image" in extra:
            m.load_controlnet(str(tmp_path / "cn"))
        if "ip_adapter_image" in extra:
            m.load_ip_adapter(str(tmp_path / "ip.safetensors"), str(tmp_path))
        req = dict(dict(prompt="a cat", num_inference_steps=4, guidance_scale=7.5, seed=3,
                        height=64, width=64), **extra)
        rng = np.random.default_rng(4)
        if "hires_scale" in req:  # each pass's draws: the CPU's and the card's
            # generators draw different streams
            req["draws"] = [{"latents": rng.standard_normal((1, 16, 16, 4)).astype(np.float32)},
                            {"latents": rng.standard_normal((1, 32, 32, 4)).astype(np.float32)}]
        else:
            req["latents"] = torch.from_numpy(
                rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
        pipe = StableDiffusionUnifiedPipeline(device=d, dtype=torch.float32)
        outs[str(d)] = pipe(m, output_type="np", **req).images
    err = float(np.abs(outs["cpu"] - outs["cuda"]).max())
    assert np.isfinite(outs["cuda"]).all() and err <= 1e-3, err


def test_controlnet_init_and_loss_on_card_match_cpu(cuda):
    """ControlNet training on the card: ``init_from_unet`` draws from a
    card generator (it once drew on the CPU with the card's generator and
    raised), and ``controlnet_loss_fn``'s loss and ControlNet gradients
    through the kernels (forward with lse, both backward kernels) against
    the CPU's plain attention, fp32, the same draws."""
    import copy

    import numpy as np

    from stablediffusion_tpu_torch.models.controlnet import init_from_unet
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.train_step import TrainStatics, controlnet_loss_fn
    from stablediffusion_tpu_torch.utils.testing import random_controlnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = _tiny_model("cpu")
    card = copy.deepcopy(cpu)
    for c in ("unet", "vae", "text_encoder"):
        setattr(card, c, getattr(card, c).to(cuda))
    fresh = init_from_unet(card.unet, card.unet_config, torch.Generator(cuda).manual_seed(0))
    assert next(fresh.parameters()).device.type == "cuda"
    net = random_controlnet(cpu.unet_config, device="cpu", dtype=torch.float32, seed=3)
    statics = TrainStatics(unet_config=cpu.unet_config, vae_config=cpu.vae_config,
                           text_config=cpu.text_encoder_config, text_config_2=None,
                           scheduler_config=cpu.scheduler_config, train_text_encoder=False,
                           snr_gamma=5.0, compute_dtype=torch.float32,
                           controlnet_config=cpu.unet_config)
    r = np.random.default_rng(0)
    batch = {"pixel_values": torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype("f4")),
             "conditioning_pixel_values": torch.from_numpy(
                 r.uniform(0, 1, (2, 32, 32, 3)).astype("f4")),
             "input_ids": torch.from_numpy(r.integers(0, 50, (2, 77)))}
    draws = {"latent_eps": torch.randn(2, 4, 16, 16), "noise": torch.randn(2, 4, 16, 16),
             "timesteps": torch.tensor([10, 700])}
    out = {}
    for d, m in (("cpu", cpu), ("cuda", card)):
        n = net.to(d)
        masters = {k: p.detach().clone().requires_grad_(True) for k, p in n.named_parameters()}
        frozen = {"unet": m.unet, "vae": m.vae, "text_encoder": m.text_encoder, "controlnet": n}
        loss = controlnet_loss_fn(masters, frozen, {k: v.to(d) for k, v in batch.items()},
                                  None, statics, DDPMScheduler(statics.scheduler_config), draws)
        grads = torch.autograd.grad(loss, list(masters.values()))
        out[d] = (loss.item(), [g.cpu() for g in grads])
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 1e-4 * max(1.0, abs(out["cpu"][0]))
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert (a - b).abs().max() <= 1e-3 * max(a.abs().max().item(), 1e-6)


def test_world_size_one_nccl_step_equals_meshless(cuda):
    """A 1-rank NCCL group: the data-parallel LoRA step of the narrow model
    (all-reduced gradients, the global batch's draws) bit for bit the
    meshless step."""
    import os
    import socket

    import torch.distributed as dist

    from stablediffusion_tpu_torch.parallel import dryrun, make_mesh
    from stablediffusion_tpu_torch.parallel.mesh import maybe_initialize_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    det = torch.backends.cudnn.deterministic
    # the same algorithms in both runs: cuDNN picks its convolutions' per call
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    try:
        assert maybe_initialize_distributed("cuda") and dist.get_backend() == "nccl"
        mesh = make_mesh()
        batch = {k: v.to(cuda) for k, v in dryrun.make_inputs(2)["batch"].items()}
        runs = []
        for m in (None, mesh):
            model = dryrun.tiny_model()
            for c in ("unet", "vae", "text_encoder"):
                setattr(model, c, getattr(model, c).to(cuda))
            runs.append(dryrun.run_step(model, m, False, batch))
        for p, t in runs[0]["after"].items():
            assert torch.equal(t, runs[1]["after"][p]), p
    finally:
        torch.backends.cudnn.deterministic = det
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)


def test_request_flops_equal_the_sdpa_count(cuda):
    """bench_utils.flops of a narrow request on the card (FlopCounterMode
    plus the kernels' launch records) equals FlopCounterMode's count of the
    same request with every attention through SDPA."""
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops import attention as att
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils import bench_utils

    model = _tiny_model(cuda)
    pipe = StableDiffusionUnifiedPipeline(device=cuda)

    def run():
        return pipe(model, prompt="a cat", num_inference_steps=3, seed=1, height=64, width=64)

    _, ours, parts = bench_utils.flops(run)
    assert parts["flash_fwd"] > 0

    def sdpa(q, k, v, scale=None, causal=False):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=causal,
                                              scale=scale).transpose(1, 2)

    orig = att.flash_fwd, att.flash_stream
    att.flash_fwd, att.flash_stream = sdpa, (lambda q, k, v, scale=None: sdpa(q, k, v, scale))
    try:
        _, theirs, _ = bench_utils.flops(run)
    finally:
        att.flash_fwd, att.flash_stream = orig
    assert ours == theirs
