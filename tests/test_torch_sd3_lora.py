"""PyTorch/CUDA port: SD3 LoRA adapters against the JAX package, in fp32 on
the CPU.

Two adapters on the MM-DiT and both CLIP towers fuse to weights within 1e-6
of JAX's ``SD3Model.load_lora_weights`` / ``set_adapters`` (T5 is never
touched), and ``delete_adapters`` gives every weight back bit for bit; a
txt2img after ``load_loras`` agrees with JAX's within 1e-4 of max(1,
max |ref|) with the JAX draws injected; a file written by the port's
``SD3LoRATrainer`` fuses alike in both packages, and one written by JAX in
the port; the handler's model block fuses and clears SD3 LoRAs, also under
int8 quantization.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from stablediffusion_tpu.lora import core as jcore
from stablediffusion_tpu.lora import formats as jformats
from stablediffusion_tpu.pipelines.sd3 import StableDiffusion3Pipeline as JSD3Pipeline
from stablediffusion_tpu_torch.io.from_jax import to_torch_layout
from stablediffusion_tpu_torch.lora import core, formats
from stablediffusion_tpu_torch.ops import quant
from stablediffusion_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
from stablediffusion_tpu_torch.serve.handler import Handler, encode_images_b64
from stablediffusion_tpu_torch.train import sd3_train
from stablediffusion_tpu_torch.utils.testing import write_image_folder
from torch_port_helpers import (  # noqa: F401
    capture_jax_sd3_draws,
    port_test_module,
    tiny_sd3_port_model,
    to_jax_sd3_model,
)

ATOL = 1e-4
REQ = dict(prompt="a cat", negative_prompt="dog", num_inference_steps=2, guidance_scale=5.0,
           height=32, width=32, seed=3, max_sequence_length=16)


@pytest.fixture(scope="module")
def models():
    tm = tiny_sd3_port_model(seed=30)
    return tm, to_jax_sd3_model(tm)


def _factors(module, suffixes, seed, alpha=None):
    rng = np.random.default_rng(seed)
    out = {}
    for path in core.linear_module_paths(module, suffixes):
        n_out, n_in = module.get_submodule(path).weight.shape
        f = {"down": rng.standard_normal((n_in, 2)).astype(np.float32) * 0.2,
             "up": rng.standard_normal((2, n_out)).astype(np.float32) * 0.2}
        if alpha is not None:
            f["alpha"] = np.float32(alpha)
        out[path] = f
    return out


def _adapter(tm, seed):
    return {"transformer": _factors(tm.transformer, sd3_train.MMDIT_TARGET_SUFFIXES, seed),
            "text_encoder": _factors(tm.text_encoder, core.TEXT_TARGET_SUFFIXES, seed + 1, 1.0),
            "text_encoder_2": _factors(tm.text_encoder_2, core.TEXT_TARGET_SUFFIXES, seed + 2)}


def _as(adapter, fn):
    return {c: {p: {k: fn(np.asarray(v)) for k, v in f.items()} for p, f in tree.items()}
            for c, tree in adapter.items()}


def _state(tm):
    return {c: {k: v.clone() for k, v in m.state_dict().items()}
            for c, m in (("transformer", tm.transformer), ("text_encoder", tm.text_encoder),
                         ("text_encoder_2", tm.text_encoder_2),
                         ("text_encoder_3", tm.text_encoder_3))}


def _assert_same(a, b):
    for c in a:
        assert a[c].keys() == b[c].keys()
        for k in a[c]:
            assert torch.equal(a[c][k], b[c][k]), (c, k)


def _assert_fused_like_jax(tm, jm, paths):
    for comp, jtree in (("transformer", jm.transformer_params),
                        ("text_encoder", jm.text_encoder_params),
                        ("text_encoder_2", jm.text_encoder_2_params)):
        module = getattr(tm, comp)
        for path in paths[comp]:
            node = jtree
            for part in path.split("."):
                node = node[part]
            key = f"{path}.weight"
            np.testing.assert_allclose(module.get_submodule(path).weight.numpy(),
                                       to_torch_layout(key, np.asarray(node["weight"])),
                                       atol=1e-6, rtol=0, err_msg=f"{comp} {key}")


def test_fused_weights_match_jax_and_delete_restores(models):
    tm, jm = models
    before = _state(tm)
    a, b = _adapter(tm, 1), _adapter(tm, 4)
    try:
        for name, ad in (("a", a), ("b", b)):
            tm.load_lora_weights(name, _as(ad, torch.from_numpy))
            jm.load_lora_weights(name, _as(ad, jnp.asarray))
        scales = {"a": 0.7, "b": -0.4}
        tm.set_adapters(scales)
        jm.set_adapters(scales)
        assert tm.get_list_adapters() == jm.get_list_adapters() == scales
        _assert_fused_like_jax(tm, jm, {c: list(t) for c, t in a.items()})
        after = _state(tm)
        _assert_same({"text_encoder_3": after["text_encoder_3"]},
                     {"text_encoder_3": before["text_encoder_3"]})
        assert not torch.equal(after["transformer"]["transformer_blocks.0.attn.to_q.weight"],
                               before["transformer"]["transformer_blocks.0.attn.to_q.weight"])
    finally:
        tm.delete_adapters()
        jm.delete_adapters()
    _assert_same(_state(tm), before)
    assert tm.get_list_adapters() == {} and tm._pristine == {}


def _save_peft(adapter, path):
    formats.save_lora_file(_as(adapter, torch.from_numpy), str(path))


def test_txt2img_after_load_loras_matches_jax(models, tmp_path):
    tm, jm = models
    _save_peft(_adapter(tm, 7), tmp_path / "sd3_style.safetensors")
    try:
        tm.load_loras({"style": 0.8}, lora_dir=str(tmp_path))
        jm.load_loras({"style": 0.8}, lora_dir=str(tmp_path))
        with capture_jax_sd3_draws() as draws:
            ref = np.asarray(JSD3Pipeline()(jm, output_type="np", **REQ).images)
        out = StableDiffusion3Pipeline(device="cpu")(tm, draws=draws, output_type="np",
                                                     **REQ).images
    finally:
        tm.delete_adapters()
        jm.delete_adapters()
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_trainer_and_jax_files_load_in_both_packages(models, tmp_path):
    """The port trainer's file (both streams' attention) and a JAX-written
    one (``init_lora`` + 0.01, as JAX's serving test writes it) fuse to the
    same weights in both packages."""
    import jax

    tm, jm = models
    data = write_image_folder(str(tmp_path / "data"), 2, (24, 24), seed=0)
    args = sd3_train.SD3TrainingArgs(
        train_batch_size=2, max_train_steps=1, resolution=16, rank=2, mixed_precision="no",
        max_sequence_length=16, learning_rate=1e-2, seed=0, output_dir=str(tmp_path / "out"))
    sd3_train.SD3LoRATrainer(tm, args, data).train()
    lora_dir = tmp_path / "loras"
    lora_dir.mkdir()
    (tmp_path / "out" / "pytorch_lora_weights.safetensors").rename(
        lora_dir / "sd3_trained.safetensors")
    jlora = jax.tree_util.tree_map(lambda x: x + 0.01, jcore.init_lora(
        jax.random.key(0), jm.transformer_params, 2, sd3_train.MMDIT_TARGET_SUFFIXES))
    jformats.save_lora_file({"transformer": jlora}, str(lora_dir / "sd3_jax.safetensors"))
    before = _state(tm)
    for name in ("trained", "jax"):
        try:
            tm.load_loras(name, lora_dir=str(lora_dir))
            jm.load_loras(name, lora_dir=str(lora_dir))
            paths = {"transformer": sorted(tm._pristine["transformer"]),
                     "text_encoder": [], "text_encoder_2": []}
            assert paths["transformer"], name
            paths["transformer"] = [k[: -len(".weight")] for k in paths["transformer"]]
            _assert_fused_like_jax(tm, jm, paths)
        finally:
            tm.delete_adapters()
            jm.delete_adapters()
        _assert_same(_state(tm), before)


def test_handler_model_block_fuses_and_clears_sd3_loras(models, tmp_path):
    tm, _ = models
    _save_peft(_adapter(tm, 9), tmp_path / "sd3_style.safetensors")
    before = _state(tm)
    h = Handler(model=tm, lora_dir=str(tmp_path))
    req = {**REQ}
    try:
        resp = h({**req, "model": {"loras": {"style": 0.8}}}, "lora")
        assert "error" not in resp, resp.get("traceback")
        assert tm.get_list_adapters() == {"style": 0.8}
        direct = StableDiffusion3Pipeline(device="cpu", output_type="uint8")(tm, **req)
        assert resp["images"] == encode_images_b64(direct.images)
        # quantized over the fused weights, and back
        quant.INT8_LINEAR_CALLS.reset()
        tm.quant_min_size = 1
        resp = h({**req, "model": {"quantize": "w8a8"}}, "q")
        assert "error" not in resp, resp.get("traceback")
        assert quant.INT8_LINEAR_CALLS.by_mode["w8a8"] > 0
        resp = h({**req, "model": {"quantize": None, "loras": []}}, "clear")
        assert "error" not in resp, resp.get("traceback")
    finally:
        tm.quant_min_size = 65536
        tm.quantize(None)
        tm.delete_adapters()
    assert tm.get_list_adapters() == {}
    _assert_same(_state(tm), before)
