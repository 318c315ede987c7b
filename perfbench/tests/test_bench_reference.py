"""The plain reference against the port at tiny widths on the CPU (the port
takes its plain attention there), float32: each model, and a whole txt2img
request."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.harness import program, weights
from perfbench.reference import models, pipeline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def setup(name):
    spec = json.load(open(CONFIGS / f"{name}.tiny.json"))
    w = weights.make_weights(spec, 2**31 + 5, "cpu")
    return spec, w, program.build_model(spec, w, "cpu")


def close(a, b, tol=1e-5):
    return (a - b).abs().max().item() <= tol * max(b.abs().max().item(), 1.0)


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_models_match(name):
    spec, w, model = setup(name)
    comps = spec["components"]
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 84, (2, 77), generator=g)
    ids[:, 0], ids[:, 20] = 49406, 49407
    with torch.no_grad():
        out = model.text_encoder(ids)
        states, last, _ = models.clip_text(w["text_encoder"], comps["text_encoder"], ids)
        assert close(out.last_hidden_state, last) and close(out.hidden_states[-2], states[-2])
        if "text_encoder_2" in comps:
            out2 = model.text_encoder_2(ids)
            _, _, proj = models.clip_text(w["text_encoder_2"], comps["text_encoder_2"], ids)
            assert close(out2.projected_pooled, proj)
        ucfg = comps["unet"]
        x = torch.randn(2, 4, 16, 16, generator=g)
        t = torch.tensor([999, 1])
        ctx = torch.randn(2, 77, ucfg["cross_attention_dim"], generator=g)
        added = None
        if ucfg.get("addition_embed_type") == "text_time":
            pooled = comps["text_encoder_2"]["projection_dim"]
            added = {"text_embeds": torch.randn(2, pooled, generator=g),
                     "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2)}
        assert close(model.unet(x, t, ctx, added), models.unet(w["unet"], ucfg, x, t, ctx, added))
        z = torch.randn(2, 4, 8, 8, generator=g)
        assert close(model.vae.decode(z), models.vae_decode(w["vae"], comps["vae"], z))
        img = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
        for a, b in zip(model.vae.encode(img), models.vae_encode(w["vae"], comps["vae"], img)):
            assert close(a, b)


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_txt2img_matches_the_ports_pipeline(name):
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

    spec, w, model = setup(name)
    pipe = StableDiffusionUnifiedPipeline(do_cfg=True, output_type="uint8", device="cpu")
    prompts, negs, seeds = ["a cat on a mat", "dog"], ["blurry", ""], [11, 2**31 + 9]
    out = pipe(model, prompt=prompts, negative_prompt=negs, seed=seeds, height=64, width=64,
               num_inference_steps=3, guidance_scale=7.5)
    for i in range(2):
        ref = pipeline.txt2img(w, spec["components"], prompts[i], negs[i], seeds[i], 64, 3, 7.5, "cpu")
        got = torch.from_numpy(out.images[i]).float()
        # 8-bit levels: a value on a rounding edge may land one level off
        assert (got - ref).abs().max().item() <= 1.0
        assert (got - ref).pow(2).mean().sqrt().item() < 0.1
