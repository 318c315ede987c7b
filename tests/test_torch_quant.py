"""PyTorch/CUDA port: int8 quantization (``ops/quant.py``) against the JAX
package, in fp32 on the CPU.

Codes and scales of weights and activations equal JAX's exactly;
``int8_linear`` / ``int8_conv2d`` in both modes within 1e-6 of the output's
scale (stride 2 with the downsampler's padding among the cases); the set of
quantized layers and their modes equal to ``quantize_params``' for the tiny
UNets and the MM-DiT under every mode, ``min_size`` and ``w8a8:N``;
``SDModel`` / ``SD3Model`` quantize, revert bit for bit and survive an
adapter swap with codes equal to JAX's quantized fused weights; "w8"
txt2img for SD1.5, SDXL and SD3 within 1e-4 of max(1, max |ref|) with the
JAX draws injected, and every layer of a "w8a8" tower within 1e-6 of JAX's
on the same input; the int8 call counters exact, the UNet's GEGLU
projection included; "auto" at the port's constants; the handler's
``quantize`` key.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from stablediffusion_tpu.ops import quant as jquant
from stablediffusion_tpu.pipelines.sd3 import StableDiffusion3Pipeline as JSD3Pipeline
from stablediffusion_tpu.pipelines.unified import StableDiffusionUnifiedPipeline as JPipeline
from stablediffusion_tpu_torch.io.from_jax import to_torch_layout
from stablediffusion_tpu_torch.lora import core
from stablediffusion_tpu_torch.ops import quant
from stablediffusion_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.serve.handler import Handler
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    capture_jax_sd3_draws,
    port_test_module,
    tiny_port_model,
    tiny_sd3_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
    to_jax_sd3_model,
)

# the int8 codes and scales are held to the JAX package's bit for bit, so
# its programs here are compiled with XLA's optimizations, as it runs them
# (tests/torch_port_helpers.port_test_module)
JAX_OPTIMIZED = True
ATOL = 1e-4
REQ = dict(prompt="a cat", negative_prompt="dog", num_inference_steps=2, guidance_scale=7.5,
           height=32, width=32, seed=3, output_type="np")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape, axes, dims", [
    ((24, 40), (0,), (1,)),            # (in, out) linear / [out, in]
    ((3, 3, 8, 16), (0, 1, 2), (1, 2, 3)),  # HWIO conv / OIHW
])
def test_weight_codes_and_scales_equal_jax(shape, axes, dims):
    w = _rng(0).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the _EPS floor
    jq, js = jquant.quantize_weight(jnp.asarray(w), axes)
    key = "m.weight"
    wt = torch.from_numpy(np.ascontiguousarray(to_torch_layout(key, w)))
    q, s = quant.quantize_weight(wt, dims)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), to_torch_layout(key, np.asarray(jq)))
    np.testing.assert_array_equal(s.numpy(), to_torch_layout("m.w8_scale", np.asarray(js)))


def test_activation_codes_and_scales_equal_jax():
    x = _rng(1).standard_normal((2, 7, 24)).astype(np.float32) * 3
    x[0, 0] = 0.0
    for jf, tf in ((jquant.quantize_act_per_token, quant.quantize_act_per_token),
                   (jquant.quantize_act_per_tensor, quant.quantize_act_per_tensor)):
        jq, js = jf(jnp.asarray(x))
        q, s = tf(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _close(out, ref, tol=1e-6):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_int8_linear_matches_jax(mode):
    rng = _rng(2)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    jp = jquant.quantize_params({"m": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}},
                                mode, min_size=1)["m"]
    lin = torch.nn.Linear(40, 24)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    m = quant.quantized_layer(lin, mode)
    np.testing.assert_array_equal(m.weight_int8.numpy().T, np.asarray(jp["weight_int8"]))
    _close(quant.int8_linear(m, torch.from_numpy(x)).numpy(),
           jquant.int8_linear(jp, jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("k, stride, padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)],
                         ids=["3x3", "downsampler", "1x1"])
def test_int8_conv2d_matches_jax(mode, k, stride, padding):
    rng = _rng(3)
    w = rng.standard_normal((k, k, 8, 16)).astype(np.float32)  # HWIO
    b = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((2, 10, 10, 8)).astype(np.float32)  # NHWC
    jp = jquant.quantize_params({"m": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}},
                                mode, min_size=1)["m"]
    ref = jquant.int8_conv2d(jp, jnp.asarray(x), stride=stride, padding=padding)
    conv = torch.nn.Conv2d(8, 16, k, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
        conv.bias.copy_(torch.from_numpy(b))
    m = quant.quantized_layer(conv, mode)
    out = quant.int8_conv2d(m, torch.from_numpy(x).permute(0, 3, 1, 2), stride, padding)
    _close(out.permute(0, 2, 3, 1).numpy(), ref)


def _jax_plan(tree, path=()):
    """{module path: mode} of the int8 layers of a quantized JAX tree."""
    if isinstance(tree, dict):
        if "weight_int8" in tree:
            return {".".join(path): "w8a8" if "w8a8_scale" in tree else "w8"}
        out = {}
        for k, v in tree.items():
            out.update(_jax_plan(v, path + (str(k),)))
        return out
    return {}


@pytest.fixture(scope="module")
def towers():
    return {"sd15": tiny_port_model(seed=1), "sdxl": tiny_sdxl_port_model(seed=2),
            "sd3": tiny_sd3_port_model(seed=3)}


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w8a8:128"])
@pytest.mark.parametrize("min_size", [1, 1024])
@pytest.mark.parametrize("name", ["sd15", "sdxl", "sd3"])
def test_quantized_layers_equal_jax(towers, name, mode, min_size):
    """The port's plan (dotted module paths, torch's out axis for
    ``a8_min_out``) selects exactly the layers JAX's "/"-joined tree paths
    select, each with the same mode."""
    from torch_port_helpers import jax_tree

    tm = towers[name]
    tower = tm.transformer if name == "sd3" else tm.unet
    skip = tm._QUANT_SKIP
    plan = quant.quantize_plan(tower, mode, min_size=min_size, skip_keys=skip)
    ref = _jax_plan(jquant.quantize_params(jax_tree(tower), mode, min_size=min_size,
                                           skip_keys=skip))
    assert plan and plan == ref
    if name == "sdxl" and min_size == 1:  # the micro-conditioning MLP is quantized
        assert "add_embedding.linear_1" in plan


def _codes(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _jax_state(tree):
    from stablediffusion_tpu_torch.io.from_jax import flatten

    return {k: torch.from_numpy(np.array(to_torch_layout(k, np.asarray(v))))
            for k, v in flatten(tree).items()}


def _assert_state_equal(state, ref):
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        if v.dtype == torch.int8:
            assert torch.equal(v, ref[k]), k
        else:
            torch.testing.assert_close(v, ref[k], atol=0, rtol=0, msg=k)


def _unet_adapter(tm, seed):
    rng = _rng(seed)
    tree = {}
    for path in core.linear_module_paths(tm.unet, core.UNET_TARGET_SUFFIXES):
        n_out, n_in = tm.unet.get_submodule(path).weight.shape
        tree[path] = {"down": rng.standard_normal((n_in, 2)).astype(np.float32) * 0.2,
                      "up": rng.standard_normal((2, n_out)).astype(np.float32) * 0.2,
                      "alpha": np.float32(2.0)}
    return tree


def test_sdmodel_quantize_revert_and_adapter_swap():
    """Codes equal to JAX's after quantize, after an adapter fused into the
    quantized model, and after delete_adapters; quantize(None) gives back
    the floating-point UNet bit for bit."""
    tm = tiny_port_model(seed=4)
    jm = to_jax_model(tm)
    fp = _codes(tm.unet)
    tm.quantize("w8a8:128", min_size=1)
    jm.quantize("w8a8:128", min_size=1)
    _assert_state_equal(_codes(tm.unet), _jax_state(jm.unet_params))
    adapter = _unet_adapter(tm, 5)
    tm.load_lora_weights("a", {"unet": {p: {k: torch.from_numpy(np.asarray(v))
                                            for k, v in f.items()}
                                        for p, f in adapter.items()}})
    jm.load_lora_weights("a", {"unet": {p: {k: jnp.asarray(v) for k, v in f.items()}
                                        for p, f in adapter.items()}})
    tm.set_adapters({"a": 0.7})
    jm.set_adapters({"a": 0.7})
    fused = _codes(tm.unet)
    _assert_state_equal(fused, _jax_state(jm.unet_params))
    assert tm.quant_mode == "w8a8:128" and tm.get_list_adapters() == {"a": 0.7}
    tm.delete_adapters()
    jm.delete_adapters()
    _assert_state_equal(_codes(tm.unet), _jax_state(jm.unet_params))
    tm.quantize(None)
    assert tm.quant_mode is None
    _assert_state_equal(_codes(tm.unet), fp)


def test_sd3model_quantize_revert_and_adapter_swap():
    tm = tiny_sd3_port_model(seed=6)
    jm = to_jax_sd3_model(tm)
    fp = _codes(tm.transformer)
    rng = _rng(7)
    adapter = {}
    for path in core.linear_module_paths(tm.transformer, ("to_q", "add_q_proj")):
        n_out, n_in = tm.transformer.get_submodule(path).weight.shape
        adapter[path] = {"down": rng.standard_normal((n_in, 2)).astype(np.float32) * 0.2,
                         "up": rng.standard_normal((2, n_out)).astype(np.float32) * 0.2}
    tm.quantize("w8", min_size=1)
    jm.quantize("w8", min_size=1)
    _assert_state_equal(_codes(tm.transformer), _jax_state(jm.transformer_params))
    # the boundary layers stay floating point; the int8 linears still
    # resolve kohya keys
    assert isinstance(tm.transformer.proj_out, torch.nn.Linear)
    assert isinstance(tm.transformer.context_embedder, torch.nn.Linear)
    assert set(adapter) <= set(tm.lora_module_paths()["transformer"])
    tm.load_lora_weights("a", {"transformer": {p: {k: torch.from_numpy(v)
                                                   for k, v in f.items()}
                                               for p, f in adapter.items()}})
    jm.load_lora_weights("a", {"transformer": {p: {k: jnp.asarray(v) for k, v in f.items()}
                                               for p, f in adapter.items()}})
    tm.set_adapters({"a": 1.0})
    jm.set_adapters({"a": 1.0})
    _assert_state_equal(_codes(tm.transformer), _jax_state(jm.transformer_params))
    tm.delete_adapters()
    tm.quantize(None)
    _assert_state_equal(_codes(tm.transformer), fp)


def _models(name, seed):
    if name == "sd3":
        tm = tiny_sd3_port_model(seed=seed)
        return tm, to_jax_sd3_model(tm)
    tm = tiny_port_model(seed=seed) if name == "sd15" else tiny_sdxl_port_model(seed=seed)
    return tm, to_jax_model(tm)


@pytest.mark.parametrize("name", ["sd15", "sdxl", "sd3"])
def test_quantized_txt2img_matches_jax(name):
    """Whole txt2img calls with every tower layer "w8" (min_size 1), the
    JAX draws injected, within 1e-4 of max(1, max |ref|)."""
    tm, jm = _models(name, 8)
    if name == "sd3":
        jpipe, pipe, capture = JSD3Pipeline(), StableDiffusion3Pipeline(device="cpu"), \
            capture_jax_sd3_draws
    else:
        jpipe, pipe, capture = JPipeline(do_cfg=True), \
            StableDiffusionUnifiedPipeline(device="cpu"), capture_jax_draws
    tm.quantize("w8", min_size=1)
    jm.quantize("w8", min_size=1)
    with capture() as draws:
        ref = np.asarray(jpipe(jm, **REQ).images)
    out = pipe(tm, draws=draws, **REQ).images
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name, mode", [("sd15", "w8a8"), ("sdxl", "w8a8:128"),
                                        ("sd3", "w8a8")])
def test_w8a8_layers_match_jax_inside_the_tower(monkeypatch, name, mode):
    """One tower forward of a w8a8 model: every int8 layer's output within
    1e-6 of its scale of JAX's ``int8_linear`` / ``int8_conv2d`` on the same
    input with JAX's quantized params.  Whole w8a8 calls are held layer by
    layer: rounding activations to codes turns an fp32 difference in the
    last bit into a whole code step wherever it meets a rounding midpoint,
    and the step grows through the layers (JAX's own jitted and eager
    forwards of a tiny w8a8 UNet differ by far more than 1e-4)."""
    from stablediffusion_tpu_torch.models import layers

    tm, jm = _models(name, 13)
    tm.quantize(mode, min_size=1)
    jm.quantize(mode, min_size=1)
    tower = tm.transformer if name == "sd3" else tm.unet
    jtree = jm.transformer_params if name == "sd3" else jm.unet_params
    paths = {id(m): p for p, m in tower.named_modules() if isinstance(m, quant._Int8Module)}
    seen = []

    def spy(fn):
        def run(m, x, *args, **kw):
            y = fn(m, x, *args, **kw)
            seen.append((paths[id(m)], m, x, args, kw, y))
            return y
        return run

    monkeypatch.setattr(layers, "int8_linear", spy(quant.int8_linear))
    monkeypatch.setattr(layers, "int8_conv2d", spy(quant.int8_conv2d))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if name == "sd3":
            tower(torch.randn(2, 4, 8, 8, generator=g), torch.tensor(500.0),
                  torch.randn(2, 9, 80, generator=g), torch.randn(2, 20, generator=g))
        else:
            cond = None
            if name == "sdxl":
                cond = {"text_embeds": torch.randn(2, 32, generator=g),
                        "time_ids": torch.ones(2, 6)}
            tower(torch.randn(2, 4, 8, 8, generator=g), torch.tensor(10),
                  torch.randn(2, 5, tm.unet_config.cross_attention_dim, generator=g), cond)
    assert sorted({p for p, *_ in seen}) == sorted(paths.values())
    assert {m.mode for _, m, *_ in seen} == ({"w8a8", "w8"} if ":" in mode else {"w8a8"})
    for path, m, x, args, kw, y in seen:
        node = jtree
        for part in path.split("."):
            node = node[part]
        if isinstance(m, quant.Int8Linear):
            ref = np.asarray(jquant.int8_linear(node, jnp.asarray(x.numpy())))
        else:
            ref = np.asarray(jquant.int8_conv2d(
                node, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), **kw)).transpose(0, 3, 1, 2)
        _close(y.numpy(), ref)


def test_int8_call_counts_are_exact():
    """One SDXL-layout UNet forward: every int8 layer runs once, through the
    dispatch (the GEGLU projections included), counted by its mode."""
    tm = tiny_sdxl_port_model(seed=9)
    tm.quantize("w8a8:128", min_size=1)
    layers = {p: m for p, m in tm.unet.named_modules() if isinstance(m, quant._Int8Module)}
    geglu = [p for p in layers if p.endswith("ff.net.0.proj")]
    assert geglu and all(layers[p].mode == "w8a8" for p in geglu)
    want = {kind: {md: sum(isinstance(m, cls) and m.mode == md for m in layers.values())
                   for md in quant.QUANT_MODES}
            for kind, cls in (("linear", quant.Int8Linear), ("conv", quant.Int8Conv2d))}
    quant.INT8_LINEAR_CALLS.reset()
    quant.INT8_CONV_CALLS.reset()
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    ctx = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    cond = {"text_embeds": torch.randn(2, 32), "time_ids": torch.ones(2, 6)}
    with torch.no_grad():
        tm.unet(x, torch.tensor(10), ctx, cond)
    assert quant.INT8_LINEAR_CALLS.by_mode == want["linear"]
    assert quant.INT8_CONV_CALLS.by_mode == want["conv"]
    assert quant.INT8_LINEAR_CALLS.padded == quant.INT8_CONV_CALLS.padded == 0  # the CPU


def test_resolve_quant_mode_at_the_port_constants():
    for mode in ("auto", None, "w8", "w8a8", "w8a8:2048"):
        quant.validate_quant_mode(mode)
    for bad in ("int4", "w8a8:x", "w4"):
        with pytest.raises(ValueError, match="unknown quant mode"):
            quant.validate_quant_mode(bad)
    # the H100's measured choice (PERF.md §6, "The int8 path"), not the v5e's
    assert (quant.AUTO_QUANT_SMALL_BATCH, quant.AUTO_QUANT_LARGE_BATCH,
            quant.AUTO_QUANT_BATCH_THRESHOLD) == ("w8", "w8", 8)
    t = quant.AUTO_QUANT_BATCH_THRESHOLD
    assert quant.resolve_quant_mode("auto", 1) == quant.AUTO_QUANT_SMALL_BATCH
    assert quant.resolve_quant_mode("auto", t - 1) == quant.AUTO_QUANT_SMALL_BATCH
    assert quant.resolve_quant_mode("auto", t) == quant.AUTO_QUANT_LARGE_BATCH
    for mode in (None, "w8", "w8a8", "w8a8:2048"):
        assert quant.resolve_quant_mode(mode, t) == mode
    tm = tiny_port_model(seed=10)
    tm.quantize("auto", expected_batch=t)
    assert tm.quant_mode == quant.AUTO_QUANT_LARGE_BATCH
    with pytest.raises(ValueError, match="unknown quant mode"):
        tm.quantize("int4")
    assert tm.quant_mode == quant.AUTO_QUANT_LARGE_BATCH  # unchanged by the bad call


def test_handler_quantize_key_auto_and_idempotence():
    tm = tiny_port_model(seed=11)
    tm.quant_min_size = 1
    h = Handler(model=tm)
    h.expected_batch = quant.AUTO_QUANT_BATCH_THRESHOLD  # what the worker sets
    req = dict(prompt="a cat", height=32, width=32, num_inference_steps=1, seed=1)
    out = h({**req, "model": {"quantize": "auto"}}, "q")
    assert "error" not in out, out.get("traceback")
    assert tm.quant_mode == quant.AUTO_QUANT_LARGE_BATCH
    layer = tm.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q
    assert isinstance(layer, quant.Int8Linear)
    h.maybe_reload_model({"quantize": "auto"})  # the same concrete mode: no re-quantize
    assert tm.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q is layer
    err = h({**req, "model": {"quantize": "int4"}}, "bad")
    assert "unknown quant mode" in err["error"] and tm.quant_mode == quant.AUTO_QUANT_LARGE_BATCH
    out = h({**req, "model": {"quantize": None}}, "revert")
    assert "error" not in out and tm.quant_mode is None
    h2 = Handler(model=tiny_port_model(seed=12))
    h2.maybe_reload_model({"quantize": "auto"})
    assert h2.model.quant_mode == quant.AUTO_QUANT_SMALL_BATCH
