"""PyTorch/CUDA port: int8 checkpoint folders and the quantize CLI against
the JAX package, on the CPU.

An int8 folder (SD1.5 "w8", SDXL with the mixed "w8a8:128", SD3 "w8a8")
written by the port loads in the JAX package and one written by JAX loads
in the port, with the tower's codes, scales and floating-point tensors equal
both ways and the model ``quant_frozen`` at the recorded mode; the port's
txt2img from either writer's "w8" folder is the same image.  A frozen model
refuses fusion (before it reads a file) and re-quantization; an fp save of a
model quantized in memory is refused.  The port's quantize CLI writes the
same tensors as JAX's from one fp folder; an int8 folder serves through the
handler, and the worker's ``--quantize`` quantizes the model it loads.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from stablediffusion_tpu.io import loader as jloader
from stablediffusion_tpu.io import quantize_cli as jquantize_cli
from stablediffusion_tpu.io.torch_convert import flatten
from stablediffusion_tpu_torch.io import loader, quantize_cli
from stablediffusion_tpu_torch.io.from_jax import to_torch_layout
from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile
from stablediffusion_tpu_torch.ops import quant
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.serve.handler import Handler
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    tiny_sd3_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
    to_jax_sd3_model,
)

REQ = dict(prompt="a cat", negative_prompt="dog", num_inference_steps=2, guidance_scale=7.5,
           height=32, width=32, seed=3)


def _write_tokenizers(path, sdxl_like):
    from test_loader import _write_tokenizer_files

    _write_tokenizer_files(os.path.join(path, "tokenizer"))
    if sdxl_like:
        _write_tokenizer_files(os.path.join(path, "tokenizer_2"), pad_token="!")


CASES = {"sd15": "w8", "sdxl": "w8a8:128", "sd3": "w8a8"}


def _pair(name, seed):
    """(port model, JAX twin, port saver, JAX saver, port loader, JAX
    loader, tower attribute) of a tiny `name` model."""
    if name == "sd3":
        tm = tiny_sd3_port_model(seed=seed, with_t5=False)
        return (tm, to_jax_sd3_model(tm), loader.save_sd3_model, jloader.save_sd3_model,
                lambda d: loader.load_sd3_model(d, device="cpu", variant=None),
                lambda d: jloader.load_sd3_model(d, variant=None), "transformer")
    tm = tiny_port_model(seed=seed) if name == "sd15" else tiny_sdxl_port_model(seed=seed)
    return (tm, to_jax_model(tm), loader.save_sd_model, jloader.save_sd_model,
            lambda d: loader.load_sd_model(d, device="cpu"),
            lambda d: jloader.load_sd_model(d), "unet")


def _assert_tower_equal(state, jtree):
    flat = flatten(jtree)
    assert sorted(state) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), to_torch_layout(k, np.asarray(v)),
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_folders_load_both_ways(tmp_path, name):
    mode = CASES[name]
    tm, jm, save, jsave, load, jload, tower = _pair(name, 20)
    tm.quant_min_size = jm.quant_min_size = 1
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save(tm, port_dir, quantize=mode)
    _write_tokenizers(port_dir, name != "sd15")
    jsave(jm, jax_dir, quantize=mode)
    _write_tokenizers(jax_dir, name != "sd15")
    for d in (port_dir, jax_dir):
        assert json.load(open(os.path.join(d, "model_index.json")))["_sdtpu_quant"] == mode
        with SafetensorsFile(os.path.join(d, tower, "diffusion_pytorch_model.safetensors")) as f:
            assert f.metadata == {"sdtpu_layout": "canonical", "sdtpu_quant": mode}
    from_port, from_jax = jload(port_dir), load(jax_dir)
    for m in (from_port, from_jax):
        assert (m.quant_mode, m.quant_frozen) == (mode, True)
    state = getattr(from_jax, tower).state_dict()
    _assert_tower_equal(state, getattr(from_port, f"{tower}_params"))
    # the in-memory quantization writes the same folder as the fp one
    tm.quantize(mode)
    _assert_tower_equal(dict(getattr(tm, tower).state_dict()),
                        getattr(from_port, f"{tower}_params"))
    modes = {m.mode for m in getattr(from_jax, tower).modules()
             if isinstance(m, quant._Int8Module)}
    assert modes == ({"w8", "w8a8"} if ":" in mode else {mode})
    if name == "sd15":
        # the port renders alike from either writer's folder (JAX's own
        # model against the port's is test_torch_quant.py's txt2img case)
        pipe = StableDiffusionUnifiedPipeline(device="cpu")
        np.testing.assert_array_equal(pipe(load(port_dir), **REQ).images,
                                      pipe(from_jax, **REQ).images)


def test_frozen_model_refuses_fusion_and_requantization(tmp_path):
    tm = tiny_port_model(seed=21)
    tm.quant_min_size = 1
    loader.save_sd_model(tm, str(tmp_path / "q"), quantize="w8a8")
    q = loader.load_sd_model(str(tmp_path / "q"), device="cpu")
    assert q.quant_frozen and any(isinstance(m, quant.Int8Linear) for m in q.unet.modules())
    # no floating-point copy of a quantized layer exists in the loaded model
    assert not q._fp_modules and not any(k.endswith("to_q.weight")
                                         for k in q.unet.state_dict())
    for call in (lambda: q.quantize("w8"), lambda: q.quantize(None),
                 lambda: q.load_lora_weights("a", {}), lambda: q.set_adapters({}),
                 lambda: q.load_loras({"missing": 1.0}, lora_dir=str(tmp_path / "nowhere"))):
        with pytest.raises(ValueError, match="requires fp weights"):
            call()
    q.delete_adapters()  # nothing fused: a no-op
    assert q.quant_mode == "w8a8"
    tm.quantize("w8")
    with pytest.raises(ValueError, match="int8-quantized in memory"):
        loader.save_sd_model(tm, str(tmp_path / "fp"))
    with pytest.raises(ValueError, match="cannot write a 'w8a8' checkpoint"):
        loader.save_sd_model(tm, str(tmp_path / "other"), quantize="w8a8")
    tm.quantize(None)
    loader.save_sd_model(tm, str(tmp_path / "auto"), quantize="auto")
    auto = json.load(open(tmp_path / "auto" / "model_index.json"))["_sdtpu_quant"]
    assert auto == quant.AUTO_QUANT_SMALL_BATCH


def test_quantize_cli_writes_what_jax_writes(tmp_path, capsys):
    tm = tiny_sdxl_port_model(seed=22)
    src = str(tmp_path / "src")
    loader.save_sd_model(tm, src)
    _write_tokenizers(src, True)
    args = ["--mode", "w8a8:128", "--min_size", "1"]
    quantize_cli.main([src, str(tmp_path / "port"), *args])
    assert "quantized (w8a8:128)" in capsys.readouterr().out
    jquantize_cli.main([src, str(tmp_path / "jax"), *args])
    for comp in ("unet", "vae", "text_encoder", "text_encoder_2"):
        names = os.listdir(tmp_path / "port" / comp)
        fname = next(n for n in names if n.endswith(".safetensors"))
        with SafetensorsFile(str(tmp_path / "port" / comp / fname)) as a, \
                SafetensorsFile(str(tmp_path / "jax" / comp / fname)) as b:
            assert sorted(a.keys()) == sorted(b.keys()) and a.metadata == b.metadata, comp
            for k in a.keys():
                assert torch.equal(a.torch_tensor(k), b.torch_tensor(k)), (comp, k)
    assert os.path.isdir(tmp_path / "port" / "tokenizer_2")
    got = loader.load_sd_model(str(tmp_path / "port"), device="cpu")
    assert (got.model_type, got.quant_mode, got.quant_frozen) == ("sdxl", "w8a8:128", True)
    with pytest.raises(ValueError, match="unknown quant mode"):
        quantize_cli.main([src, str(tmp_path / "bad"), "--mode", "int4"])


def test_int8_folder_served_and_worker_quantize(tmp_path):
    from stablediffusion_tpu_torch.serve.worker import build, parse_args

    tm = tiny_port_model(seed=23)
    tm.quant_min_size = 1
    loader.save_sd_model(tm, str(tmp_path / "sd15_q"), quantize="w8a8")
    loader.save_sd_model(tm, str(tmp_path / "sd15_fp"))
    h = Handler(model_dir=str(tmp_path), device="cpu")
    req = dict(prompt="a cat", height=32, width=32, num_inference_steps=2, seed=4)
    resp = h({**req, "model": {"type": "sd15", "name": "q"}}, "int8")
    assert "error" not in resp, resp.get("traceback")
    assert h.model.quant_frozen and h.model.quant_mode == "w8a8"
    direct = StableDiffusionUnifiedPipeline(device="cpu", output_type="uint8")(h.model, **req)
    from stablediffusion_tpu_torch.serve.handler import encode_images_b64

    assert resp["images"] == encode_images_b64(direct.images)
    # a request naming the folder's own mode keeps the model; another mode
    # answers on the error channel
    assert "error" not in h({**req, "model": {"quantize": "w8a8"}}, "same")
    assert "requires fp weights" in h({**req, "model": {"quantize": "w8"}}, "other")["error"]
    quant.INT8_LINEAR_CALLS.reset()
    server = build(parse_args(["--model_dir", str(tmp_path), "--model_type", "sd15",
                               "--model_name", "fp", "--quantize", "auto", "--max_batch",
                               str(quant.AUTO_QUANT_BATCH_THRESHOLD), "--device", "cpu",
                               "--host", "127.0.0.1", "--port", "0"]))
    try:
        model = server.handler.model
        assert model.quant_mode == quant.AUTO_QUANT_LARGE_BATCH and not model.quant_frozen
        assert dataclasses.asdict(model.unet_config) == dataclasses.asdict(tm.unet_config)
    finally:
        server.server_close()
