"""PyTorch/CUDA port: textual inversion against the JAX package, in fp32 on
the CPU.

The same embedding rows, in each format both packages read (diffusers
``{token: rows}``, A1111 .pt, community ``emb_params`` safetensors, SDXL's
``clip_l``/``clip_g``), extend the tables alike and register triggers whose
ids equal the JAX tokenizer's, word boundaries included; a prompt with the
trigger gives the same image within 1e-4 of max(1, max |ref|) (JAX draws
injected); unloading gives the tables back bit for bit.
"""

import numpy as np
import pytest
import torch

from helpers import tiny_tokenizer
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors
from stablediffusion_tpu_torch.lora import core
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.serve.handler import Handler
from stablediffusion_tpu_torch.utils.testing import random_lora, random_textual_inversion
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    port_test_module,
    port_tokenizer,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

ATOL = 1e-4
TABLE = "text_model.embeddings.token_embedding.weight"


@pytest.fixture(scope="module")
def sd15():
    tm = tiny_port_model(seed=3)
    return to_jax_model(tm), tm


@pytest.fixture(scope="module")
def sdxl():
    tm = tiny_sdxl_port_model(seed=4)
    return to_jax_model(tm), tm


def _table(model, tower="text_encoder"):
    if hasattr(model, "text_encoder_params"):  # JAX
        tree = getattr(model, f"{tower}_params")
        return np.asarray(tree["text_model"]["embeddings"]["token_embedding"]["weight"])
    return getattr(model, tower).state_dict()[TABLE].numpy()


@pytest.mark.parametrize("text", ["a thing cat", "something <thing>", "<thing>x thing,thing",
                                  "Thing THING things"])
def test_trigger_ids_equal_jax(text):
    """Whole-string triggers, longest first, only at word boundaries ("thing"
    not inside "something"), lowercased; cleared back to BPE."""
    jt, tt = tiny_tokenizer(), port_tokenizer()
    for tok in (jt, tt):
        tok.add_tokens({"thing": [1000, 1001], "<thing>": [1002], "<thing>x": [1003]})
    assert tt.tokenize(text) == jt.tokenize(text)
    assert tt(text).tolist() == jt(text).tolist()
    jt.clear_added_tokens()
    tt.clear_added_tokens()
    assert tt.tokenize(text) == jt.tokenize(text) == port_tokenizer().tokenize(text)


def _sources(tmp_path, hidden, fmt):
    """(source for the port, source for JAX, expected trigger, n rows)."""
    rows = np.random.default_rng(5).standard_normal((2, hidden)).astype(np.float32)
    if fmt == "diffusers":
        return {"<concept>": rows}, {"<concept>": rows}, "<concept>", 2
    if fmt == "a1111_pt":
        f = tmp_path / "myconcept.pt"
        vec = torch.from_numpy(rows[:1].copy()).requires_grad_(True)  # saved with grad
        torch.save({"string_to_param": {"*": vec}, "name": "myconcept"}, f)
        return str(f), str(f), "myconcept", 1
    f = tmp_path / "style.safetensors"
    save_safetensors({"emb_params": rows}, str(f))
    return str(f), str(f), "style", 2


@pytest.mark.parametrize("fmt", ["diffusers", "a1111_pt", "emb_params"])
def test_formats_extend_tables_as_jax(sd15, tmp_path, fmt):
    jm, tm = sd15
    rows0 = _table(tm).shape[0]
    src_t, src_j, trigger, n = _sources(tmp_path, tm.text_encoder_config.hidden_size, fmt)
    try:
        assert tm.load_textual_inversion(src_t) == trigger
        assert jm.load_textual_inversion(src_j) == trigger
        assert _table(tm).shape[0] == rows0 + n
        np.testing.assert_array_equal(_table(tm), _table(jm))
        ids = list(range(rows0, rows0 + n))
        prompt = f"a {trigger} cat"
        assert tm.tokenizer.tokenize(prompt) == jm.tokenizer.tokenize(prompt)
        assert tm.tokenizer.tokenize(trigger) == ids
        param = tm.text_encoder.text_model.embeddings.token_embedding.weight
        assert isinstance(param, torch.nn.Parameter) and not param.requires_grad
    finally:
        tm.unload_textual_inversion()
        jm.unload_textual_inversion()
    assert _table(tm).shape[0] == rows0 and tm.tokenizer.added_tokens == {}


def test_sdxl_dual_tower_pipeline_matches_jax(sdxl, tmp_path):
    """clip_l / clip_g rows in both tables, the trigger in both prompts;
    the image within 1e-4 of JAX's, and different without the rows."""
    jm, tm = sdxl
    f = tmp_path / "dual.safetensors"
    save_safetensors(random_textual_inversion(tm, 2, seed=6, std=0.5), str(f))
    before = [_table(tm, t).copy() for t in ("text_encoder", "text_encoder_2")]
    req = dict(prompt="a <xl> cat", prompt_2="<xl> dog", num_inference_steps=2,
               guidance_scale=7.5, height=32, width=32, seed=5, output_type="np")
    try:
        for m in (tm, jm):
            assert m.load_textual_inversion(str(f), token="<xl>") == "<xl>"
        r1, r2 = before[0].shape[0], before[1].shape[0]
        assert tm.tokenizer.tokenize("<xl>") == [r1, r1 + 1]
        assert tm.tokenizer_2.tokenize("<xl>") == [r2, r2 + 1]
        for t in ("text_encoder", "text_encoder_2"):
            np.testing.assert_array_equal(_table(tm, t), _table(jm, t))
        with capture_jax_draws() as draws:
            ref = np.asarray(JPipeline(do_cfg=True)(jm, **req).images)
        out = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **req).images
        np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))
    finally:
        tm.unload_textual_inversion()
        jm.unload_textual_inversion()
    bare = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **req).images
    assert np.abs(bare - out).max() > 1e-4
    for t, b in zip(("text_encoder", "text_encoder_2"), before):
        np.testing.assert_array_equal(_table(tm, t), b)


def test_sd15_pipeline_with_trigger_matches_jax(sd15):
    jm, tm = sd15
    rows = np.random.default_rng(7).standard_normal(
        (1, tm.text_encoder_config.hidden_size)).astype(np.float32)
    req = dict(prompt="a cat <concept>", num_inference_steps=2, guidance_scale=7.5,
               height=32, width=32, seed=11, output_type="np")
    try:
        tm.load_textual_inversion({"<concept>": rows})
        jm.load_textual_inversion({"<concept>": rows})
        with capture_jax_draws() as draws:
            ref = np.asarray(JPipeline(do_cfg=True)(jm, **req).images)
        out = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **req).images
    finally:
        tm.unload_textual_inversion()
        jm.unload_textual_inversion()
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_lora_refusion_keeps_the_rows(sd15):
    """An adapter fused after a textual inversion keeps the new rows;
    deleting it and unloading gives back the original table and weights."""
    _, tm = sd15
    table0 = _table(tm).copy()
    state0 = {k: v.clone() for k, v in tm.text_encoder.state_dict().items()}
    try:
        tm.load_textual_inversion({"<c>": np.ones((1, table0.shape[1]), np.float32)})
        grown = _table(tm).copy()
        tm.load_lora_weights("t", {"text_encoder": random_lora(
            tm.text_encoder, core.TEXT_TARGET_SUFFIXES, rank=2, seed=8)})
        tm.set_adapters({"t": 1.0})
        np.testing.assert_array_equal(_table(tm), grown)
        tm.set_adapters({"t": 0.5})
        np.testing.assert_array_equal(_table(tm), grown)
    finally:
        tm.delete_adapters()
        tm.unload_textual_inversion()
    state = tm.text_encoder.state_dict()
    assert all(torch.equal(state[k], v) for k, v in state0.items())


def test_refusals(sd15, sdxl, tmp_path):
    _, tm = sd15
    _, xm = sdxl
    with pytest.raises(ValueError, match="hidden"):
        tm.load_textual_inversion({"<c>": np.zeros((1, 9999), np.float32)})
    with pytest.raises(ValueError, match="clip_g"):
        xm.load_textual_inversion({"<c>": np.zeros((1, 32), np.float32)})
    with pytest.raises(ValueError, match="needs an SDXL model"):
        tm.load_textual_inversion({"clip_l": np.zeros((1, 32), np.float32),
                                   "clip_g": np.zeros((1, 32), np.float32)})
    with pytest.raises(ValueError, match="unrecognized embedding format"):
        tm.load_textual_inversion({"a": np.zeros((1, 32)), "b": np.zeros((1, 32))})
    f = tmp_path / "pickled.pt"
    torch.save({"string_to_param": {"*": torch.zeros(1, 32)}, "name": "p",
                "extra": object.__new__(_Opaque)}, f)
    with pytest.raises(ValueError, match="allow_pickle"):
        tm.load_textual_inversion(str(f))
    try:
        assert tm.load_textual_inversion(str(f), allow_pickle=True) == "p"
    finally:
        tm.unload_textual_inversion()
    assert _table(tm).shape[0] == tm.text_encoder_config.vocab_size


class _Opaque:
    """A class that ``torch.load(weights_only=True)`` refuses."""


def test_handler_model_block_is_declarative(tmp_path):
    """{"textual_inversion": [file]} loads it before the request runs, []
    unloads; a name that is not a path is looked up in the model dir."""
    model = tiny_port_model(seed=5)
    rows0 = _table(model).shape[0]
    save_safetensors({"emb_params": np.ones((2, 32), np.float32)},
                     str(tmp_path / "shiny.safetensors"))
    h = Handler(model=model, model_dir=str(tmp_path))
    req = dict(prompt="a shiny cat", height=32, width=32, num_inference_steps=2, seed=3)
    plain = h(dict(req), "plain")
    with_ti = h({**req, "model": {"textual_inversion": ["shiny.safetensors"]}}, "ti")
    assert "error" not in with_ti, with_ti.get("traceback")
    assert _table(model).shape[0] == rows0 + 2
    assert model.tokenizer.tokenize("shiny") == [rows0, rows0 + 1]
    assert with_ti["images"] != plain["images"]
    again = h({**req, "model": {"textual_inversion": []}}, "none")
    assert _table(model).shape[0] == rows0 and again["images"] == plain["images"]
