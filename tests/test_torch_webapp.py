"""PyTorch/CUDA port: the web UI (``serve/webapp.py``) and the worker's
front doors against the JAX package, on the CPU.

``index_html()`` is JAX's string; the functions that build requests return
JAX's values on ``tests/test_webapp.py``'s cases and raise alike; a
UI-built request
drives the port's handler on a tiny model; the worker serves the page on
GET /ui and answers a UI payload by POST; ``trigger_fn`` answers the same
job, through the open server's route and alone under the worker's lock.
"""

import http.client
import json
import threading

import numpy as np
import pytest

from stablediffusion_tpu.serve import webapp as jwebapp
from stablediffusion_tpu_torch.serve import webapp, worker
from stablediffusion_tpu_torch.serve.handler import Handler
from torch_port_helpers import port_test_module, tiny_port_model  # noqa: F401

IMG = np.zeros((64, 64, 3), np.uint8)
UI_CASES = [
    dict(task="inpaint", prompt="a cat", negative_prompt="bad", steps=12, cfg=5.5, seed=42,
         width=512, height=768, num_images=2, clip_skip=2, strength=0.6, scheduler="euler",
         model_type="sdxl", checkpoint="ckpt", loras="style:0.7",
         textual_inversions="e.pt:t", lora_te_scale=0.5, image=IMG, mask_image=IMG,
         prompt_weighting=True, vae_tiling=True, hires_scale=2.0, quantize="w8a8"),
    dict(task="txt2img", prompt="x", seed=-1),
    dict(task="img2img", prompt="x", image=IMG, image_guidance_scale=1.5, freeu=True,
         pag_scale=2.0, checkpoint="c", quantize="auto"),
]


def test_index_html_is_jax_string():
    assert webapp.index_html() == jwebapp.index_html()
    assert webapp.INDEX_HTML == jwebapp.INDEX_HTML


@pytest.mark.parametrize("text", ["style:0.7, detail", "", "a:1,b:-0.5,,c"])
def test_parse_specs_match_jax(text):
    assert webapp.parse_lora_spec(text) == jwebapp.parse_lora_spec(text)
    ti = text.replace("style", "embeds/x.pt")
    assert webapp.parse_ti_spec(ti) == jwebapp.parse_ti_spec(ti)
    assert webapp.parse_ti_spec("C:/e/x.pt:tok, y.safetensors") == jwebapp.parse_ti_spec(
        "C:/e/x.pt:tok, y.safetensors")


@pytest.mark.parametrize("case", range(len(UI_CASES)))
def test_build_ui_request_matches_jax(case):
    kw = dict(UI_CASES[case])
    task, prompt = kw.pop("task"), kw.pop("prompt")
    assert webapp.build_ui_request(task, prompt, **kw) == jwebapp.build_ui_request(
        task, prompt, **kw)


def test_request_functions_raise_as_jax():
    for fn in (lambda m: m.build_ui_request("img2img", "x"),
               lambda m: m.build_ui_request("inpaint", "x", image=IMG),
               lambda m: m.build_train_request("", 16, 500, 512, "out")):
        with pytest.raises(ValueError) as port:
            fn(webapp)
        with pytest.raises(ValueError) as ref:
            fn(jwebapp)
        assert str(port.value) == str(ref.value)
    assert webapp.build_train_request("/data/d", 16, 500, 512, "out") == \
        jwebapp.build_train_request("/data/d", 16, 500, 512, "out")


def test_launch_gradio_needs_gradio():
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            webapp.launch_gradio(None)
    else:
        pytest.skip("gradio is installed: launch_gradio would serve")


@pytest.fixture(scope="module")
def served():
    """A worker over a tiny CPU model on a free loopback port, serial."""
    handler = Handler(model=tiny_port_model(seed=40))
    server = worker.make_server(handler, "127.0.0.1", 0, max_batch=1)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server
    server.shutdown()
    server.server_close()
    t.join(timeout=10)
    assert worker.SERVER is not server


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def test_ui_page_payload_and_trigger_fn(served):
    port = served.server_address[1]
    status, ctype, body = _request(port, "GET", "/ui")
    assert status == 200 and ctype.startswith("text/html")
    assert body.decode() == webapp.index_html()
    assert _request(port, "GET", "/nope")[0] == 404
    req = webapp.build_ui_request("txt2img", "a cat", steps=2, width=32, height=32, seed=7,
                                  scheduler="euler")
    status, _, body = _request(port, "POST", "/", {"id": "ui", "input": req})
    resp = json.loads(body)
    assert status == 200 and "error" not in resp, resp.get("traceback")
    assert len(resp["images"]) == 1 and resp["seed"] == 7
    # the queue entry shares the open server's handler and answers the same job
    assert worker.SERVER is served and worker.get_handler() is served.handler
    again = worker.trigger_fn({"id": "q", "input": req})
    assert again["images"] == resp["images"] and again["seed"] == 7


def test_trigger_fn_alone_under_the_lock(monkeypatch):
    """Without an open server, trigger_fn runs the worker's handler under the
    lock the server's serial requests share."""
    handler = Handler(model=tiny_port_model(seed=41))
    seen = []

    def locked_handler(request_input, request_id=""):
        seen.append(worker._LOCK.locked())
        return handler(request_input, request_id)

    monkeypatch.setattr(worker, "SERVER", None)
    monkeypatch.setattr(worker, "HANDLER", locked_handler)
    req = webapp.build_ui_request("txt2img", "a dog", steps=1, width=32, height=32, seed=3)
    resp = worker.trigger_fn({"id": "alone", "input": req})
    assert "error" not in resp, resp.get("traceback")
    assert resp["seed"] == 3 and len(resp["images"]) == 1
    assert worker.trigger_fn({"input": {"mode": "nope"}})["error"].startswith("ValueError")
    assert seen == [True, True]
