"""PyTorch/CUDA port: A1111 prompt weighting, long-prompt chunks and prompt
editing against the JAX package, in fp32 on the CPU.

The parser, the token streams and chunks, and the editing schedule equal
JAX's (the port keeps copies); ``apply_token_weights`` within 1e-6, its
near-zero-mean guard included; ``encode_prompt(prompt_weighting=True)``
for SD1.5 (a chunked prompt over 75 tokens, a chunk floor) and SDXL within
1e-4; whole txt2img and img2img calls with weights, ``[from:to:when]`` edits
and ``[a|b]`` alternation (an order-2 scheduler too), SD1.5 and SD3, the
JAX draws injected, within TOL of max(1, max |ref|).
"""

import numpy as np
import pytest
import torch

from helpers import tiny_tokenizer
from stablediffusion_tpu.pipelines.sd3 import StableDiffusion3Pipeline as JSD3Pipeline
from stablediffusion_tpu.pipelines.unified import StableDiffusionUnifiedPipeline as JPipeline
from stablediffusion_tpu.utils import prompt_edit as jpe
from stablediffusion_tpu.utils import prompt_weights as jpw
from stablediffusion_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.utils import prompt_edit as pe
from stablediffusion_tpu_torch.utils import prompt_weights as pw
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    capture_jax_sd3_draws,
    port_test_module,
    port_tokenizer,
    tiny_port_model,
    tiny_sd3_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
    to_jax_sd3_model,
)

TOL = 1e-4
LONG = " ".join(["a small red house by the sea"] * 14)  # more than 75 tokens
TEXTS = ["a (red:1.3) cat", "((big)) [small] dog", "an (unclosed cat", "literal \\(x\\) :)",
         "(a [b (c:0.5)] d)", "", LONG, "(nested (colon: 2.0) here)"]
EDITS = ["a [cat:dog:0.5] on a hill", "a [red|blue] ball", "[a house:3] by a lake",
         "a (cat:1.2) [on a mat:under a table:2] x", "plain text", "a [big] cat",
         "[(cat:1.3):dog:0.25] and [x|y|z]"]


def _close(got, ref, tol=TOL):
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("text", TEXTS)
def test_parser_and_streams_equal_jax(text):
    assert pw.parse_weighted_prompt(text) == jpw.parse_weighted_prompt(text)
    assert pw.strip_weight_markup(text) == jpw.strip_weight_markup(text)
    tok, jtok = port_tokenizer(), tiny_tokenizer()
    assert pw.token_stream(tok, text) == jpw.token_stream(jtok, text)
    assert pw.num_chunks(tok, text) == jpw.num_chunks(jtok, text)
    for got, ref in zip(pw.encode_with_weights(tok, [text, "x"]),
                        jpw.encode_with_weights(jtok, [text, "x"])):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(pw.encode_chunked(tok, [text, "y"], k=3),
                        jpw.encode_chunked(jtok, [text, "y"], k=3)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("text", EDITS)
@pytest.mark.parametrize("steps", [1, 4, 10])
def test_edit_schedule_equals_jax(text, steps):
    texts = [text, "a [cat|dog]"]
    assert pe.schedule_prompts(texts, steps) == jpe.schedule_prompts(texts, steps)
    assert [pe.realize_at(text, i, steps) for i in range(steps)] == [
        jpe.realize_at(text, i, steps) for i in range(steps)]
    merged = pe.schedule_prompts(texts, steps)
    if merged is not None:
        assert pe.unique_variants(merged[1]) == jpe.unique_variants(merged[1])


@pytest.mark.parametrize("case", ["random", "zero_mean", "ones"])
def test_apply_token_weights_matches_jax(case):
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 6)).astype(np.float32)
    if case == "zero_mean":  # the weighted mean vanishes: the guard skips the restore
        h = np.ones((2, 6, 5), np.float32)
        h[:, 3:] = -1.0
        w = np.ones((2, 6), np.float32)
        w[:, :3] = 0.0
        w[:, 3:] = 0.0
    elif case == "ones":
        w = np.ones((2, 6), np.float32)
    got = pw.apply_token_weights(torch.from_numpy(h), w)
    ref = np.asarray(jpw.apply_token_weights(h, w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sd15():
    tm = tiny_port_model(seed=2)
    return to_jax_model(tm), tm


@pytest.fixture(scope="module")
def sdxl():
    tm = tiny_sdxl_port_model(seed=3)
    return to_jax_model(tm), tm


@pytest.mark.parametrize("prompt, neg, min_chunks", [
    ("a (red:1.4) [house]", "blurry", 1),
    (LONG, "(ugly:1.2)", 1),  # two chunks, shared by the negative
    ("a cat", LONG, 1),
    ("a ((cat))", None, 3),  # a chunk floor
])
@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_encode_prompt_weighting_matches_jax(sd15, sdxl, family, prompt, neg, min_chunks):
    jm, tm = sd15 if family == "sd15" else sdxl
    got = StableDiffusionUnifiedPipeline(device="cpu").encode_prompt(
        tm, prompt, negative_prompt=neg, prompt_weighting=True, min_chunks=min_chunks,
        clip_skip=1)
    ref = JPipeline().encode_prompt(jm, prompt, negative_prompt=neg, prompt_weighting=True,
                                    min_chunks=min_chunks, clip_skip=1)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("kw", [
    dict(prompt="a (cat:1.3) [dog:fox:0.5] x [red|blue]"),
    dict(prompt=LONG + " [a|b]", negative_prompt="(bad:1.1)"),
    dict(prompt="[a house:2] on a (hill:0.8)", image="img", strength=0.6),
    dict(prompt="[cat:dog:0.5]", scheduler="heun"),
], ids=["edit_alternation", "long_alternation", "img2img_shift", "heun"])
def test_sd15_pipeline_weighting_and_editing_match_jax(sd15, kw):
    jm, tm = sd15
    kw = dict(kw)
    name = kw.pop("scheduler", "euler")
    tm.set_scheduler(name)
    jm.set_scheduler(name)
    if kw.get("image") == "img":
        kw["image"] = np.random.default_rng(5).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    common = dict(num_inference_steps=4, guidance_scale=7.5, seed=7, height=32, width=32,
                  output_type="latents", prompt_weighting=True, **kw)
    with capture_jax_draws() as draws:
        ref = JPipeline()(jm, **common).latents
    got = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **common).latents
    _close(got, ref)


@pytest.fixture(scope="module")
def sd3():
    tm = tiny_sd3_port_model(seed=4)
    return to_jax_sd3_model(tm), tm


def test_sd3_encode_prompt_weighting_matches_jax(sd3):
    jm, tm = sd3
    kw = dict(negative_prompt="(blurry:1.2)", prompt_weighting=True, max_sequence_length=16)
    got = StableDiffusion3Pipeline(device="cpu").encode_prompt(tm, "a (red:1.5) [cat]", **kw)
    ref = JSD3Pipeline().encode_prompt(jm, "a (red:1.5) [cat]", **kw)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("strength", [None, 0.7])
def test_sd3_pipeline_editing_matches_jax(sd3, strength):
    jm, tm = sd3
    common = dict(prompt="a (cat:1.2) [on a mat:in a box:0.5] [red|blue]", num_inference_steps=4,
                  guidance_scale=5.0, seed=2, height=32, width=32, max_sequence_length=16,
                  output_type="latents", prompt_weighting=True)
    if strength is not None:
        common.update(image=np.random.default_rng(1).uniform(0, 1, (1, 32, 32, 3))
                      .astype(np.float32), strength=strength)
    with capture_jax_sd3_draws() as draws:
        ref = JSD3Pipeline()(jm, **common).latents
    got = StableDiffusion3Pipeline(device="cpu")(tm, draws=draws, **common).latents
    _close(got, ref)
