"""PyTorch/CUDA port: the serving handler, the HTTP worker and the batcher,
on a tiny CPU model.

Mirrors ``tests/test_serve.py:26-136,355-430`` (router modes, seed echo,
params merge, img2img through base64, scheduler swap, error channel, HTTP
round trip, batcher merge / buckets / errors), plus the port's own: a model
block that loads a diffusers folder (SDXL by default, as in JAX), an SDXL
request with prompt_2 and the refiner, and the features that answer on the
error channel with their ROADMAP item.
"""

import dataclasses
import http.client
import json
import threading

import numpy as np
import pytest

from stablediffusion_tpu_torch.io.loader import save_sd_model
from stablediffusion_tpu_torch.serve.batcher import Batcher, _batchable
from stablediffusion_tpu_torch.serve.handler import (
    INFERENCE_ARG_KEYS,
    Handler,
    decode_image_b64,
    encode_images_b64,
)
from stablediffusion_tpu_torch.serve.worker import make_server, parse_args
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
)

ARGS = dict(prompt="a cat", height=32, width=32, num_inference_steps=2)


@pytest.fixture(scope="module")
def handler():
    return Handler(model=tiny_port_model())


def test_inference_mode(handler):
    resp = handler({**ARGS, "seed": 7}, "req-1")
    assert "error" not in resp, resp.get("traceback")
    assert resp["seed"] == 7
    assert len(resp["images"]) == 1
    img = decode_image_b64(resp["images"][0])
    assert img.shape == (32, 32, 3)


def test_auto_seed_echo(handler):
    resp = handler(dict(ARGS), "req-2")
    assert isinstance(resp["seed"], int) and 0 <= resp["seed"] < 1e9


def test_params_merge(handler):
    resp = handler({"prompt": "x", "params": {**ARGS, "seed": 3}}, "req-3")
    assert resp["seed"] == 3


def test_img2img_base64_roundtrip(handler):
    first = handler({**ARGS, "seed": 1}, "r")
    resp = handler(
        {**ARGS, "seed": 2, "image": first["images"][0], "strength": 0.5},
        "req-4",
    )
    assert "error" not in resp, resp.get("traceback")
    assert len(resp["images"]) == 1


def test_scheduler_swap_via_model_block(handler):
    resp = handler({**ARGS, "seed": 1, "model": {"scheduler": "euler"}}, "req-5")
    assert "error" not in resp
    assert handler.model.scheduler_name == "euler"
    handler.model.set_scheduler("DDIM")


# the ids are those the cases had before the constructor mode, LoRAs and
# textual inversion were ported (their cases moved to tests of their own)
@pytest.mark.parametrize("request_input, item", [
    # the inference_wandb mode is ported: it answers a bad request on the
    # error channel as the inference mode does
    pytest.param({"mode": "inference_wandb", "hires_scale": 2.0, "denoising_end": 0.5},
                 "cannot combine", id="request_input0-item 21"),
    # the train mode is ported with its textual-inversion option, which
    # refuses to train the text towers (their LoRA is on by default), as
    # in JAX, before it reads the folder
    pytest.param({"mode": "train", "train": {"data_dir": "unused", "textual_inversion": "<x>"}},
                 "train_text_encoder=False", id="request_input2-item 19"),
    # int8 quantization is ported: the model block's mode is validated
    # before the model changes, and a bad one answers on the error channel
    pytest.param({"model": {"quantize": "int4"}}, "unknown quant mode 'int4'",
                 id="request_input4-item 16"),
    # SD3 is ported: an SD3 model block naming a folder that is not there
    # answers on the error channel like any other
    pytest.param({"model": {"type": "sd3", "name": "x"}}, "sd3_x",
                 id="request_input5-item 18"),
    # the pipeline extensions are ported: the hires fix answers a window it
    # cannot combine with on the error channel, as JAX's pipeline raises, and
    # an IP-Adapter file that is not there is named
    pytest.param({"hires_scale": 2.0, "denoising_end": 0.5}, "cannot combine",
                 id="request_input6-item 15"),
    pytest.param({"model": {"ip_adapter": "ip.bin"}}, "ip.bin",
                 id="request_input7-not supported"),
])
def test_unported_features_answer_on_the_error_channel(handler, request_input, item):
    resp = handler({**ARGS, "seed": 1, **request_input}, "req-6")
    assert "error" in resp and item in resp["error"], resp
    assert "error" not in handler({**ARGS, "seed": 1}, "after")  # still serving


def test_unknown_mode_is_error(handler):
    resp = handler({**ARGS, "mode": "nope"}, "req-8")
    assert "error" in resp and "unknown mode" in resp["error"]


def test_missing_model():
    h = Handler(model=None, device="cpu")
    resp = h(dict(ARGS), "req-9")
    assert "error" in resp and "no model" in resp["error"]


def test_model_block_loads_a_folder(tmp_path):
    """{"model": {"type": "sd15", "name": N}} loads <model_dir>/sd15_N once;
    the same name again does not reload."""
    model = tiny_port_model(seed=2)
    save_sd_model(model, str(tmp_path / "sd15_tiny"))
    h = Handler(model_dir=str(tmp_path), device="cpu")
    resp = h({**ARGS, "seed": 4, "model": {"type": "sd15", "name": "tiny"}}, "load")
    assert "error" not in resp, resp.get("traceback")
    loaded = h.model
    assert loaded.path == str(tmp_path / "sd15_tiny") and h.model_generation == 1
    h({**ARGS, "seed": 4, "model": {"type": "sd15", "name": "tiny"}}, "again")
    assert h.model is loaded
    resp = h({**ARGS, "model": {"name": "absent"}}, "bad")
    assert "FileNotFoundError" in resp["error"]


def test_sdxl_request_through_the_handler(tmp_path):
    """A model block with a name and no type, and no model loaded, loads
    <model_dir>/sdxl_N (the JAX default type); prompt_2 / negative_prompt_2
    reach the pipeline; use_refiner answers on the error channel until a
    refiner is loaded, then runs it."""
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

    model = tiny_sdxl_port_model(seed=3, refiner=True)
    save_sd_model(model, str(tmp_path / "sdxl_tiny"))
    save_sd_model(dataclasses.replace(model, unet_config=model.refiner_config,
                                      unet=model.refiner), str(tmp_path / "refiner"))
    h = Handler(model_dir=str(tmp_path), device="cpu")
    req = {**ARGS, "seed": 5, "prompt_2": "a dog", "negative_prompt_2": "cat"}
    resp = h({**req, "model": {"name": "tiny"}}, "sdxl")
    assert "error" not in resp, resp.get("traceback")
    assert h.model.model_type == "sdxl" and h.model.path == str(tmp_path / "sdxl_tiny")
    direct = StableDiffusionUnifiedPipeline(device="cpu", output_type="uint8")(
        h.model, **{k: v for k, v in req.items()})
    assert resp["images"] == encode_images_b64(direct.images)
    refine = {**ARGS, "seed": 6, "params": {"use_refiner": True, "strength": 0.5,
                                            "image": resp["images"][0]}}
    err = h(refine, "no refiner")
    assert "error" in err and "no refiner loaded" in err["error"]
    h.model.load_refiner(str(tmp_path / "refiner"))
    out = h(refine, "refiner")
    assert "error" not in out, out.get("traceback")
    assert decode_image_b64(out["images"][0]).shape == (32, 32, 3)


def test_http_worker_roundtrip(handler):
    """Drive the real HTTP surface on a local port."""
    server = make_server(handler, "127.0.0.1", 0, max_batch=1)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["model"] == "sd15"

        body = json.dumps({"id": "job-1", "input": {**ARGS, "seed": 9}})
        conn.request("POST", "/", body=body, headers={"Content-Type": "application/json"})
        resp = json.loads(conn.getresponse().read())
        assert resp["seed"] == 9 and len(resp["images"]) == 1

        # malformed json -> 400
        conn.request("POST", "/", body="{not json",
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 400
        r.read()
        # a failing request -> 500 with the error (full fine-tuning trains
        # the UNet only, and the towers' LoRA is on by default)
        conn.request("POST", "/", body=json.dumps({"input": {
            **ARGS, "mode": "train", "train": {"data_dir": "unused", "full_finetune": True}}}))
        r = conn.getresponse()
        assert r.status == 500 and "UNet only" in json.loads(r.read())["error"]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_worker_flags_for_unported_features():
    from stablediffusion_tpu_torch.serve.worker import build

    # --mesh_dp is ported: outside torchrun there is one rank, so a mesh of
    # two data ranks fails JAX's make_mesh assert (parallel/mesh.py)
    for flags, item in ((["--mesh_dp", "2"], "mesh 2x1 != 1 ranks"),):
        with pytest.raises(AssertionError, match=item):
            build(parse_args([*flags, "--device", "cpu"]))
    # --quantize is ported: without a preloaded model it is ignored (the
    # quantized worker is test_torch_quant_checkpoint.py's), and "auto"
    # resolves against --max_batch
    server = build(parse_args(["--quantize", "w8", "--host", "127.0.0.1", "--port", "0",
                               "--max_batch", "8", "--device", "cpu"]))
    try:
        assert server.handler.model is None and server.handler.expected_batch == 8
    finally:
        server.server_close()
    args = parse_args(["--model_dir", "d", "--model_name", "n", "--max_batch", "4"])
    # the JAX worker's default model type (serve/worker.py:155)
    assert (args.model_type, args.max_batch, args.port) == ("sdxl", 4, 8000)


def _kohya_file(model, path):
    from stablediffusion_tpu_torch.lora.core import UNET_TARGET_SUFFIXES
    from stablediffusion_tpu_torch.lora.formats import save_lora_file
    from stablediffusion_tpu_torch.utils.testing import random_lora

    save_lora_file({"unet": random_lora(model.unet, UNET_TARGET_SUFFIXES, 2, 0, 0.3)},
                   str(path), format="kohya")


def test_lora_dir_apart_from_the_model_dir(tmp_path, monkeypatch):
    """A LoRA kept outside the model folder is found through lora_dir
    (Handler and the worker's --lora_dir), which defaults to the model dir."""
    from stablediffusion_tpu_torch.serve import worker

    model = tiny_port_model(seed=4)
    (tmp_path / "models").mkdir()
    (tmp_path / "loras").mkdir()
    _kohya_file(model, tmp_path / "loras" / "sd15_style.safetensors")
    h = Handler(model=model, model_dir=str(tmp_path / "models"),
                lora_dir=str(tmp_path / "loras"))
    plain = h({**ARGS, "seed": 2}, "plain")
    styled = h({**ARGS, "seed": 2, "model": {"loras": {"style": 1.0}}}, "style")
    assert "error" not in styled, styled.get("traceback")
    assert model.get_list_adapters() == {"style": 1.0}
    assert styled["images"] != plain["images"]
    assert Handler(model=model, model_dir="m").lora_dir == "m"
    # the worker hands --lora_dir to its handler (built here on the CPU model)
    monkeypatch.setattr(worker, "Handler", lambda **kw: Handler(model=model, **kw))
    for flags, want in ((["--lora_dir", str(tmp_path / "loras")], str(tmp_path / "loras")),
                        ([], "m")):
        server = worker.build(parse_args(["--model_dir", "m", "--host", "127.0.0.1",
                                          "--port", "0", "--max_batch", "1", *flags]))
        server.server_close()
        assert server.handler.lora_dir == want


@pytest.mark.parametrize("loras", [[], None, {}])
def test_empty_loras_clear_the_adapters(loras, tmp_path):
    """{"model": {"loras": []}} (or null) answers with images on a model
    with no adapters, as in JAX, and clears any that are fused: the image
    comes back to the plain one byte for byte."""
    model = tiny_port_model(seed=5)
    h = Handler(model=model, model_dir=str(tmp_path))
    plain = h({**ARGS, "seed": 3}, "plain")
    resp = h({**ARGS, "seed": 3, "model": {"loras": loras}}, "empty")
    assert "error" not in resp, resp.get("traceback")
    assert resp["images"] == plain["images"]
    _kohya_file(model, tmp_path / "sd15_s.safetensors")
    fused = h({**ARGS, "seed": 3, "model": {"loras": ["s"]}}, "fused")
    assert fused["images"] != plain["images"]
    cleared = h({**ARGS, "seed": 3, "model": {"loras": loras}}, "cleared")
    assert cleared["images"] == plain["images"] and model.get_list_adapters() == {}


def test_constructor_mode_grid(tmp_path):
    """schedulers x lora_scales x steps_grid x guidance_grid, one image
    each; the scheduler and the adapters' scales it switches; without
    adapters the scales leave the model as it is."""
    model = tiny_port_model(seed=6)
    _kohya_file(model, tmp_path / "sd15_s.safetensors")
    h = Handler(model=model, model_dir=str(tmp_path))
    body = {"mode": "constructor", "prompt": "a cat", "height": 32, "width": 32, "seed": 1,
            "params": {"schedulers": ["DDIM", "euler"], "lora_scales": [0.5],
                       "steps_grid": [1, 2], "guidance_grid": [7.5]}}
    bare = h(dict(body), "bare")
    assert "error" not in bare, bare.get("traceback")
    assert [(r["scheduler"], r["steps"]) for r in bare["grid"]] == [
        ("DDIM", 1), ("DDIM", 2), ("euler", 1), ("euler", 2)]
    assert all(r["seed"] == 1 and len(r["images"]) == 1 for r in bare["grid"])
    with_lora = h({**body, "model": {"loras": {"s": 0.8}}}, "lora")
    assert model.get_list_adapters() == {"s": 0.8} and model.scheduler_name == "euler"
    assert with_lora["grid"][0]["images"] != bare["grid"][0]["images"]


def test_bucket_upload_sink(handler, tmp_path, monkeypatch):
    """BUCKET_ENDPOINT_URL-gated image sink: when configured, inference
    responses carry URLs instead of base64."""
    import os

    from PIL import Image

    from stablediffusion_tpu_torch.serve.upload import make_uploader

    root = str(tmp_path / "bucket")
    monkeypatch.setenv("BUCKET_ENDPOINT_URL", root)
    assert make_uploader() is not None
    monkeypatch.delenv("BUCKET_ENDPOINT_URL")
    assert make_uploader() is None  # fallback: base64 branch

    h = Handler(model=handler.model, uploader=make_uploader(root))
    resp = h({**ARGS, "seed": 7}, "job-42")
    assert "error" not in resp, resp.get("traceback")
    (url,) = resp["images"]
    assert url.startswith("file://") and url.endswith("/0.jpg")
    path = url[len("file://"):]
    assert os.path.exists(path) and "job-42" in path
    assert Image.open(path).size == (32, 32)


def test_upload_scheme_dispatch(tmp_path):
    from stablediffusion_tpu_torch.serve import upload

    assert isinstance(upload.make_uploader(str(tmp_path)), upload.FileUploader)
    assert isinstance(upload.make_uploader(f"file://{tmp_path}"), upload.FileUploader)
    assert isinstance(upload.make_uploader("http://bucket.example/up"), upload.HTTPUploader)
    assert upload.make_uploader(None) is None


def test_warmup_runs_each_batch_size(handler, monkeypatch):
    """warmup generates once per batch size it is given."""
    seen = []
    real = handler._generate

    def spy(args, output_type="uint8"):
        seen.append(args["num_images_per_prompt"])
        return real(args, output_type)

    monkeypatch.setattr(handler, "_generate", spy)
    assert handler.warmup(steps=1, size=32, batches=(1, 2)) >= 0.0
    assert seen == [1, 2]


# -- micro-batching ------------------------------------------------------------


def test_batcher_merges_and_is_composition_invariant(handler):
    """Concurrent same-bucket requests merge into ONE pipeline call, and each
    request's image equals what it gets batched alone (per-sample seed
    streams).  Exact JPEG bytes hold where the pixels are equal; on the CPU
    the fp32 convolutions and GEMMs block by batch size, so the decoded
    pixels are compared within one uint8 level (a rounding flip)."""
    b = Batcher(handler, max_batch=4, window_ms=200.0, adaptive=False)
    results = {}

    def go(seed):
        results[seed] = b.submit({**ARGS, "seed": seed}, f"b{seed}")

    threads = [threading.Thread(target=go, args=(s,)) for s in (101, 202, 303)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert b.merged_calls == 1, b.merged_calls
    assert b.padded_samples == 1  # three requests pad to a batch of four
    for s in (101, 202, 303):
        r = results[s]
        assert "error" not in r, r.get("traceback")
        assert r["seed"] == s and r["batched"] == 3

    solo = b.submit({**ARGS, "seed": 202}, "solo")
    assert solo["batched"] == 1
    merged_px = decode_image_b64(results[202]["images"][0])
    solo_px = decode_image_b64(solo["images"][0])
    assert np.abs(merged_px - solo_px).max() <= 1.0 / 255 + 1e-6
    other = decode_image_b64(results[101]["images"][0])
    assert np.abs(other - solo_px).max() > 0  # another seed differs
    b.close()


def test_batcher_buckets_and_serial_fallthrough(handler):
    b = Batcher(handler, max_batch=4, window_ms=50.0)
    # different shapes -> different buckets, both succeed
    r1 = b.submit({**ARGS, "seed": 1}, "s1")
    r2 = b.submit({**ARGS, "height": 64, "width": 64, "seed": 1}, "s2")
    assert "error" not in r1 and "error" not in r2

    # non-batchable inputs take the serial handler path
    assert not _batchable({**ARGS, "model": {"scheduler": "DDIM"}})
    assert not _batchable({**ARGS, "mode": "constructor"})
    assert not _batchable({**ARGS, "image": "abc"})
    assert not _batchable({**ARGS, "seed": [1, 2]})
    assert not _batchable({**ARGS, "num_images_per_prompt": 2})
    r3 = b.submit({**ARGS, "seed": 5, "model": {"scheduler": "DDIM"}}, "s3")
    assert "error" not in r3 and "batched" not in r3
    b.close()


def test_batcher_error_channel(handler):
    b = Batcher(handler, max_batch=2, window_ms=10.0)
    r = b.submit({**ARGS, "seed": 1, "clip_skip": 99}, "bad")
    assert "error" in r
    b.close()


def test_batcher_survives_malformed_and_filters_args(handler):
    """A request that errors inside the merged call (or has unhashable args)
    must return a per-request error WITHOUT killing the batch thread; extra
    client keys and 'mode' are filtered like the serial path."""
    b = Batcher(handler, max_batch=4, window_ms=10.0)
    r = b.submit({**ARGS, "seed": 1, "sigmas": {"0": 1}}, "bad")
    assert "error" in r
    r = b.submit({**ARGS, "seed": 2, "mode": "inference", "webhook": "http://x"}, "ok")
    assert "error" not in r, r.get("traceback")
    b.close()


def test_batcher_key_partition_is_total():
    """Every inference argument is merged per request, forces the serial
    path, or splits buckets: the three sets cover INFERENCE_ARG_KEYS."""
    from stablediffusion_tpu_torch.serve import batcher

    keys = set(batcher._MERGED_KEYS) | set(batcher._NON_BATCHABLE) | set(batcher._bucket_keys())
    assert set(INFERENCE_ARG_KEYS) <= keys


def test_chip_smoke_burst_merges_a_late_request(handler):
    """chip_smoke.py's burst helper runs its burst under the batcher's
    fixed window, so a second request that reaches the batcher 50 ms after
    the first (ten times the adaptive window's grace floor) still joins its
    merged call; the worker's own window settings come back afterwards."""
    import importlib.util
    import time
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    server = make_server(handler, "127.0.0.1", 0, max_batch=2, batch_window_ms=200)
    batcher = server.batcher
    submit = batcher.submit

    def late_submit(request_input, request_id=""):
        if request_id == "burst-1":
            time.sleep(0.05)
        return submit(request_input, request_id)

    batcher.submit = late_submit
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        bodies = [{**ARGS, "prompt": p, "seed": 20 + i} for i, p in enumerate(["a", "b"])]
        _, row = chip_smoke._burst(server, server.server_address[1], {}, "cpu", bodies, {})
        assert row["merged_calls"] == 1 and row["batched_per_reply"] == [2, 2]
        assert (batcher.adaptive, batcher.window_ms) == (True, 200)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)


def test_encode_accepts_float_and_uint8():
    x = np.random.default_rng(0).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    a = encode_images_b64(x)
    b = encode_images_b64((x * 255).round().astype(np.uint8))
    assert a == b and len(a) == 2
