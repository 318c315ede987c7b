"""PyTorch/CUDA port: the blockwise 8-bit Adam and gradient accumulation
against the JAX package's ``train/optim.py``, on the CPU.

8-bit Adam: ``make_optimizer(use_8bit=True)`` on both sides (clip +
``scale_by_adam_8bit`` + masked ``add_decayed_weights`` +
``scale_by_learning_rate``) over five updates of a LoRA-shaped tree with
leaves above and below ``MIN_QUANT_SIZE``: the int8/uint8 codes equal, the
block scales and the params within 1e-6 of their largest element.  The
clip threshold sits above every gradient norm, so both sides see the same
gradients bit for bit (a clipped gradient would differ in the last bit
through the norm's summation order, and could flip a code).

Accumulation: ``optax.MultiSteps`` (fp32, Welford's running mean) and
``multi_steps_lowmem`` (bf16 running sum) around AdamW for k = 2 and 3 over
six calls: the params after each call within 1e-6, nothing moving on the
calls that only accumulate, and the inner count moving only on the k-th.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from stablediffusion_tpu.train import optim as joptim
from stablediffusion_tpu_torch.train import optim as toptim
from torch_port_helpers import port_test_module  # noqa: F401

TOL = 1e-6


def _tree(r):
    """A LoRA-shaped tree: two leaves of at least 4096 elements (the 8-bit
    moments, one of them not a whole number of blocks), two smaller."""
    return {"attn.to_q": {"down": r.standard_normal((320, 16)).astype(np.float32),
                          "up": r.standard_normal((16, 330)).astype(np.float32)},
            "attn.to_k": {"down": r.standard_normal((64, 16)).astype(np.float32),
                          "up": r.standard_normal((16, 40)).astype(np.float32)}}


def _grads(r, like, n):
    return [jax.tree_util.tree_map(
        lambda p: (r.standard_normal(p.shape) * 1e-2).astype(np.float32), like)
        for _ in range(n)]


def _as_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_adam_8bit_matches_jax():
    r = np.random.default_rng(0)
    params = _tree(r)
    sched = dict(name="linear", lr=1e-2, warmup_steps=1, total_steps=8)
    jopt = joptim.make_optimizer(joptim.make_lr_schedule(**sched), use_8bit=True,
                                 max_grad_norm=1e3)
    topt = toptim.make_optimizer(toptim.make_lr_schedule(**sched), use_8bit=True,
                                 max_grad_norm=1e3)
    jp, js = params, jopt.init(params)
    tp = _as_torch(params)
    ts = topt.init(tp)
    big = {"attn.to_q.down", "attn.to_q.up"}
    for path, t in toptim.tree_leaves(tp):
        kind = toptim.QuantizedMoment if path in big else torch.Tensor
        assert isinstance(ts["mu"][path], kind) and isinstance(ts["nu"][path], kind), path
    for i, g in enumerate(_grads(r, params, 5)):
        assert float(optax.global_norm(g)) < 1e3
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(_as_torch(g), ts, tp)
        adam = js[1][0]  # chain(clip, chain(adam8, decay, lr)) -> the adam8 state
        assert int(adam.count) == ts["count"] == i + 1
        for path, t in toptim.tree_leaves(tp):
            a, b = path.rsplit(".", 1)
            assert _rel(t.numpy(), jp[a][b]) <= TOL, (i, path)
            jmu, jnu = adam.mu[a][b], adam.nu[a][b]
            tmu, tnu = ts["mu"][path], ts["nu"][path]
            if path in big:
                np.testing.assert_array_equal(tmu.q.numpy(), np.asarray(jmu.q))
                np.testing.assert_array_equal(tnu.q.numpy(), np.asarray(jnu.q))
                assert tmu.q.dtype == torch.int8 and tnu.q.dtype == torch.uint8
                assert _rel(tmu.scale.numpy(), jmu.scale) <= TOL
                assert _rel(tnu.scale.numpy(), jnu.scale) <= TOL
            else:  # fp32 moments below MIN_QUANT_SIZE
                assert tmu.dtype == torch.float32
                assert _rel(tmu.numpy(), jmu) <= TOL and _rel(tnu.numpy(), jnu) <= TOL


@pytest.mark.parametrize("quantizer", ["m", "v"])
def test_quantizers_match_jax(quantizer):
    """The codes and scales of one moment, and its dequantized values, for
    a tensor that spans decades (not a whole number of blocks)."""
    r = np.random.default_rng(1)
    x = (r.standard_normal(5000) * 10.0 ** r.uniform(-6, 0, 5000)).astype(np.float32)
    if quantizer == "v":
        x = x * x
    jq = getattr(joptim, f"_quantize_{quantizer}")(x)
    tq = getattr(toptim, f"quantize_{quantizer}")(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(toptim.dequantize(tq, torch.from_numpy(x)).numpy(),
                                  np.asarray(joptim._dequantize(jq, x)))
    assert tq.q.shape == (20, toptim.BLOCK_SIZE)  # 5000 padded to 5120


@pytest.mark.parametrize("accum_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_jax(k, accum_dtype):
    r = np.random.default_rng(2)
    params = _tree(r)
    sched = dict(name="constant_with_warmup", lr=1e-2, warmup_steps=1)
    kw = dict(max_grad_norm=0.5, grad_accum_steps=k, accum_dtype=accum_dtype)
    jopt = joptim.make_optimizer(joptim.make_lr_schedule(**sched), **kw)
    topt = toptim.make_optimizer(toptim.make_lr_schedule(**sched), **kw)
    assert isinstance(topt, toptim.MultiSteps)
    jp, js = params, jopt.init(params)
    tp = _as_torch(params)
    ts = topt.init(tp)
    want_dtype = torch.float32 if accum_dtype == "fp32" else torch.bfloat16
    assert all(a.dtype == want_dtype for a in ts["acc"].values())
    for i, g in enumerate(_grads(r, params, 6)):
        before = {p: t.clone() for p, t in toptim.tree_leaves(tp)}
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(_as_torch(g), ts, tp)
        emitted = (i + 1) % k == 0
        assert ts["mini_step"] == (i + 1) % k
        assert ts["inner"]["count"] == (i + 1) // k
        for path, t in toptim.tree_leaves(tp):
            a, b = path.rsplit(".", 1)
            assert _rel(t.numpy(), jp[a][b]) <= TOL, (i, path)
            if not emitted:
                assert torch.equal(t, before[path]), (i, path)
    # the 8-bit moments compose with accumulation, as in make_optimizer
    assert toptim.make_optimizer(toptim.make_lr_schedule("constant", 1e-3),
                                 grad_accum_steps=k, use_8bit=True).inner.use_8bit
