"""PyTorch/CUDA port: LoRA files and the adapter lifecycle against the JAX
package, in fp32 on the CPU.

The same seeded factors, written in each key format (peft, legacy
diffusers, kohya with ``lora_te_`` / ``lora_te1_`` / ``lora_te2_``), parse
to equal trees in both packages; files saved by either load in the other
with equal tensors; ``lora_module_paths`` (kohya's resolver table) is the
same list of strings; fused weights agree within 1e-6; whole txt2img calls
after ``load_loras`` (with the JAX call's draws injected) within 1e-4 of
max(1, max |ref|), also under ``cross_attention_kwargs={"scale"}``.  The
port's in-place fusion restores the weights bit for bit.
"""

import numpy as np
import pytest
import torch

from stablediffusion_tpu.lora import core as jcore
from stablediffusion_tpu.lora import formats as jformats
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu_torch.io.from_jax import to_torch_layout
from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors
from stablediffusion_tpu_torch.lora import core, formats
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

ATOL = 1e-4
ATTN = core.UNET_TARGET_SUFFIXES
TEXT = core.TEXT_TARGET_SUFFIXES


@pytest.fixture(scope="module")
def sd15():
    tm = tiny_port_model(seed=1)
    return to_jax_model(tm), tm


@pytest.fixture(scope="module")
def sdxl():
    tm = tiny_sdxl_port_model(seed=2)
    return to_jax_model(tm), tm


def _factors(module, suffixes, rank, seed, std=0.2, alpha=None):
    """{path: (down [in, r], up [r, out], alpha)} of numpy fp32 for the
    linears of `module` ending in `suffixes`."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in core.linear_module_paths(module, suffixes):
        n_out, n_in = module.get_submodule(path).weight.shape
        out[path] = (rng.standard_normal((n_in, rank)).astype(np.float32) * std,
                     rng.standard_normal((rank, n_out)).astype(np.float32) * std,
                     np.float32(alpha if alpha is not None else rank))
    return out


def _adapter(tm, seed, rank=2, towers=True):
    """Factors on the UNet's attention and, with `towers`, each text
    tower's attention."""
    comps = {"unet": _factors(tm.unet, ATTN, rank, seed)}
    if towers:
        comps["text_encoder"] = _factors(tm.text_encoder, TEXT, rank, seed + 1, alpha=1.0)
        if tm.is_sdxl:
            comps["text_encoder_2"] = _factors(tm.text_encoder_2, TEXT, rank, seed + 2)
    return comps


def _flat(comps, fmt):
    """A LoRA state dict of `comps` in the key format `fmt`."""
    flat = {}
    te_prefix = {"text_encoder": "lora_te1_" if "text_encoder_2" in comps else "lora_te_",
                 "text_encoder_2": "lora_te2_", "unet": "lora_unet_"}
    for comp, tree in comps.items():
        for path, (down, up, alpha) in tree.items():
            if fmt == "kohya":
                k = te_prefix[comp] + path.replace(".", "_")
                flat[f"{k}.lora_down.weight"] = down.T.copy()
                flat[f"{k}.lora_up.weight"] = up.T.copy()
                flat[f"{k}.alpha"] = np.asarray(alpha)
                continue
            if fmt == "legacy" and comp == "unet":
                attn, proj = path.rsplit(".", 1) if not path.endswith("to_out.0") else (
                    path[:-len(".to_out.0")], "to_out")
                k = f"unet.{attn}.processor.{proj}_lora.lora"
                flat[f"{k}.down.weight"] = down.T.copy()
                flat[f"{k}.up.weight"] = up.T.copy()
                continue
            flat[f"{comp}.{path}.lora_A.weight"] = down.T.copy()
            flat[f"{comp}.{path}.lora_B.weight"] = up.T.copy()
            flat[f"{comp}.{path}.alpha"] = np.asarray(alpha)
    return flat


def _assert_trees_equal(port_tree, jax_tree):
    assert set(port_tree) == set(jax_tree)
    for comp in jax_tree:
        assert set(port_tree[comp]) == set(jax_tree[comp]), comp
        for path, jf in jax_tree[comp].items():
            pf = port_tree[comp][path]
            assert set(pf) == set(jf), path
            for k, v in jf.items():
                np.testing.assert_array_equal(pf[k].numpy(), np.asarray(v), err_msg=path)


@pytest.mark.parametrize("model, fmt", [("sd15", "peft"), ("sd15", "legacy"),
                                        ("sd15", "kohya"), ("sdxl", "peft"),
                                        ("sdxl", "kohya")])
def test_parsed_trees_equal_jax(request, model, fmt):
    jm, tm = request.getfixturevalue(model)
    flat = _flat(_adapter(tm, seed=3, towers=fmt != "legacy"), fmt)
    port = formats.parse_lora_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                                         tm.lora_module_paths())
    ref = jformats.parse_lora_state_dict(flat, jm.lora_module_paths())
    _assert_trees_equal(port, ref)
    assert set(port) == ({"unet"} if fmt == "legacy" else
                         {"unet", "text_encoder"} | ({"text_encoder_2"} if tm.is_sdxl else set()))


@pytest.mark.parametrize("model", ["sd15", "sdxl"])
def test_lora_module_paths_equal_jax(request, model):
    jm, tm = request.getfixturevalue(model)
    assert tm.lora_module_paths() == jm.lora_module_paths()


@pytest.mark.parametrize("fmt", ["peft", "kohya"])
def test_saved_files_cross_load(sdxl, tmp_path, fmt):
    """A file saved by either package loads in the other, tensors equal."""
    jm, tm = sdxl
    comps = _adapter(tm, seed=4)
    port_tree = {c: {p: {"down": torch.from_numpy(d), "up": torch.from_numpy(u),
                         "alpha": torch.tensor(float(a))} for p, (d, u, a) in t.items()}
                 for c, t in comps.items()}
    jax_tree = {c: {p: {"down": d, "up": u, "alpha": np.float32(a)}
                    for p, (d, u, a) in t.items()} for c, t in comps.items()}
    formats.save_lora_file(port_tree, str(tmp_path / "port.safetensors"), format=fmt)
    jformats.save_lora_file(jax_tree, str(tmp_path / "jax.safetensors"), format=fmt)
    paths_t, paths_j = tm.lora_module_paths(), jm.lora_module_paths()
    for name in ("port", "jax"):
        f = str(tmp_path / f"{name}.safetensors")
        _assert_trees_equal(formats.load_lora_file(f, paths_t),
                            jformats.load_lora_file(f, paths_j))


def test_fused_weights_match_jax(sdxl):
    """Two adapters at 0.7 and -0.4 over shared paths: the port's fused
    weights within 1e-6 of JAX's, every tower."""
    jm, tm = sdxl
    a, b = _adapter(tm, seed=5), _adapter(tm, seed=6)
    scales = {"a": 0.7, "b": -0.4}
    for comp, module, params in (("unet", tm.unet, jm.unet_params),
                                 ("text_encoder", tm.text_encoder, jm.text_encoder_params),
                                 ("text_encoder_2", tm.text_encoder_2,
                                  jm.text_encoder_2_params)):
        def tree(x, torch_=True):
            mk = torch.from_numpy if torch_ else (lambda v: v)
            return {p: {"down": mk(d), "up": mk(u), "alpha": mk(np.asarray(al))}
                    for p, (d, u, al) in x[comp].items()}

        port = core.fuse(module, {"a": tree(a), "b": tree(b)}, scales)
        ref = jcore.fuse(params, {"a": tree(a, False), "b": tree(b, False)}, scales)
        assert set(port) == {f"{p}.weight" for p in a[comp]}
        for key, w in port.items():
            node = ref
            for part in key.split("."):
                node = node[part]
            np.testing.assert_allclose(w.numpy(), to_torch_layout(key, np.asarray(node)),
                                       atol=1e-6, rtol=0, err_msg=key)


def _write_kohya(tm, tmp_path, name, seed):
    save_safetensors({k: np.ascontiguousarray(v)
                      for k, v in _flat(_adapter(tm, seed=seed), "kohya").items()},
                     str(tmp_path / f"{tm.model_type}_{name}.safetensors"))


@pytest.mark.parametrize("model, scale", [("sd15", None), ("sd15", 0.5), ("sdxl", 0.5)])
def test_txt2img_after_load_loras_matches_jax(request, tmp_path, model, scale):
    """Two kohya files on the UNet and every tower, fused by ``load_loras``
    at 0.8 and 0.5; txt2img in both packages with the JAX draws injected,
    optionally with the text towers re-fused at `scale` for the call."""
    jm, tm = request.getfixturevalue(model)
    _write_kohya(tm, tmp_path, "k", seed=7)
    _write_kohya(tm, tmp_path, "q", seed=8)
    loras = {"k": 0.8, "q": 0.5}
    req = dict(prompt="a cat", negative_prompt="dog", num_inference_steps=2,
               guidance_scale=7.5, height=32, width=32, seed=3, output_type="np",
               cross_attention_kwargs=None if scale is None else {"scale": scale})
    try:
        jm.load_loras(loras, lora_dir=str(tmp_path))
        tm.load_loras(loras, lora_dir=str(tmp_path))
        assert tm.get_list_adapters() == jm.get_list_adapters() == loras
        with capture_jax_draws() as draws:
            ref = np.asarray(JPipeline(do_cfg=True)(jm, **req).images)
        out = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **req).images
    finally:
        jm.delete_adapters()
        tm.delete_adapters()
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def _state(tm):
    return {c: {k: v.clone() for k, v in m.state_dict().items()}
            for c, m in tm._lora_modules().items()}


def _equal(a, b):
    return all(torch.equal(a[c][k], b[c][k]) for c in a for k in a[c])


def test_lifecycle_scales_replace_and_restore_bit_identical(sdxl, tmp_path):
    """set_adapters({a: 0.5}) then ({a: 1.0}) equals ({a: 1.0}) directly;
    scale 0 is the identity; two adapters add; delete_adapters gives back
    every weight bit for bit; the per-call text scale leaves the weights as
    they are."""
    _, tm = sdxl
    before = _state(tm)
    _write_kohya(tm, tmp_path, "a", seed=9)
    _write_kohya(tm, tmp_path, "b", seed=10)
    try:
        tm.load_loras({"a": 1.0}, lora_dir=str(tmp_path))
        direct = _state(tm)
        assert not _equal(direct, before)
        tm.set_adapters({"a": 0.5})
        tm.set_adapters({"a": 1.0})
        assert _equal(_state(tm), direct)
        tm.set_adapters({"a": 0.0})
        assert _equal(_state(tm), before)
        tm.load_loras({"a": 0.3, "b": 0.6}, lora_dir=str(tmp_path))
        both = _state(tm)
        path = "text_model.encoder.layers.0.self_attn.q_proj"
        dw = sum(s * core.delta_w(tm._adapter_store[n]["text_encoder"][path]).t()
                 for n, s in (("a", 0.3), ("b", 0.6)))
        key = f"{path}.weight"
        torch.testing.assert_close(both["text_encoder"][key],
                                   before["text_encoder"][key] + dw, atol=1e-6, rtol=0)
        StableDiffusionUnifiedPipeline(device="cpu")(
            tm, prompt="a", num_inference_steps=1, height=32, width=32, seed=0,
            cross_attention_kwargs={"scale": 0.25})
        assert _equal(_state(tm), both)
    finally:
        tm.delete_adapters()
    assert _equal(_state(tm), before)
    assert tm.get_list_adapters() == {} and tm._pristine == {}


def test_unmatched_adapter_raises_and_missing_paths_warn(sd15):
    _, tm = sd15
    bogus = {"nonexistent.module": {"down": torch.ones(8, 2), "up": torch.ones(2, 8)}}
    with pytest.raises(ValueError, match="matched no module"):
        core.fuse(tm.unet, {"bad": bogus})
    path = core.linear_module_paths(tm.unet, ATTN)[0]
    n_out, n_in = tm.unet.get_submodule(path).weight.shape
    part = {**bogus, path: {"down": torch.zeros(n_in, 2), "up": torch.zeros(2, n_out)}}
    with pytest.warns(UserWarning, match="1/2 module paths"):
        assert set(core.fuse(tm.unet, {"part": part})) == {f"{path}.weight"}
    with pytest.raises(ValueError, match="unknown adapters"):
        tm.set_adapters({"never_loaded": 1.0})


def test_conv_factor_refused(sd15):
    """kohya's SD1.x 1x1-conv proj_in factors ([r, in, 1, 1]): the JAX
    package parses them into a 4-D tree that fuses to a misshapen weight;
    the port refuses them, naming the path and the shape."""
    jm, tm = sd15
    key = "lora_unet_down_blocks_0_attentions_0_proj_in"
    flat = {f"{key}.lora_down.weight": np.ones((2, 16, 1, 1), np.float32),
            f"{key}.lora_up.weight": np.ones((16, 2, 1, 1), np.float32),
            f"{key}.alpha": np.asarray(2.0, np.float32)}
    with pytest.raises(ValueError, match=r"down_blocks\.0\.attentions\.0\.proj_in.*\(2, 16, 1, 1\)"):
        formats.parse_lora_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                                      tm.lora_module_paths())
    ref = jformats.parse_lora_state_dict(flat, jm.lora_module_paths())
    assert np.asarray(ref["unet"]["down_blocks.0.attentions.0.proj_in"]["down"]).ndim == 4


def test_non_lora_and_incomplete_keys_raise():
    with pytest.raises(ValueError, match="not a LoRA"):
        formats.parse_lora_state_dict({"unet.conv_in.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="incomplete"):
        formats.parse_lora_state_dict({"unet.a.lora_A.weight": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="unknown LoRA save format"):
        formats.save_lora_file({}, "x.safetensors", format="nope")
