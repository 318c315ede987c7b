"""PyTorch/CUDA port: the CLIP vision tower and IP-Adapter against the JAX
package, in fp32 on the CPU.

``models/clip_vision.CLIPVisionModel`` against ``clip_vision.apply`` on
``tiny_clip_vision_config`` (with and without a projection: last and
penultimate hidden states, pooled output, image embeds) within 1e-5; the
standard projection and the Plus Resampler against ``image_proj_apply`` /
``resampler_apply``, their shape-inferred configs equal; ``cross_attn_paths``
equal; the decoupled cross-attention after ``load_ip_adapter`` against
``unet.apply`` with ``ip_hidden_states``; pipeline calls with
``ip_adapter_image_embeds`` and with ``ip_adapter_image`` (standard and Plus,
SD1.5 and SDXL), the JAX draws injected, within TOL of max(1, max |ref|);
the lifecycle with a LoRA and int8 ("w8"): every tensor, int8 codes of the
IP projections included, equal to JAX's, and ``unload_ip_adapter`` giving the
UNet back bit for bit; the handler's ``ip_adapter`` key; image-encoder
folders both ways with the JAX loader.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.models import clip_vision as jclip_vision
from stablediffusion_tpu.models import ip_adapter as jip
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.pipelines.unified import StableDiffusionUnifiedPipeline as JPipeline
from stablediffusion_tpu_torch.core.config import (
    IP_ADAPTER_IMAGE_ENCODER,
    SD15_UNET,
    SDXL_UNET,
    tiny_clip_vision_config,
)
from stablediffusion_tpu_torch.io.from_jax import flatten, to_torch_layout
from stablediffusion_tpu_torch.io.loader import load_image_encoder
from stablediffusion_tpu_torch.lora import core
from stablediffusion_tpu_torch.models import ip_adapter
from stablediffusion_tpu_torch.models.clip_vision import CLIPVisionModel
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.serve.handler import Handler
from stablediffusion_tpu_torch.utils.testing import (
    ip_adapter_state,
    write_image_encoder_folder,
    write_ip_adapter_file,
)
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    _init,
    jax_tree,
    jitted,
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

TOL = 1e-4
VCFG = tiny_clip_vision_config()
REQ = dict(prompt="a cat", negative_prompt="a dog", num_inference_steps=3, guidance_scale=7.5,
           seed=6, height=32, width=32, output_type="latents")
PLUS = dict(plus=True, num_tokens=6, depth=2, heads=2, dim=32)


def _close(got, ref, tol=TOL):
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("with_projection", [True, False])
def test_clip_vision_matches_jax(with_projection):
    cfg = tiny_clip_vision_config(with_projection=with_projection)
    model = _init(CLIPVisionModel(cfg), torch.Generator().manual_seed(1))
    px = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jclip_vision.apply(jax_tree(model), jcfg.CLIPVisionConfig(**dataclasses.asdict(cfg)),
                             jnp.asarray(px))
    with torch.no_grad():
        out = model(torch.from_numpy(px).permute(0, 3, 1, 2))
    for got, want in ((out.last_hidden_state, ref.last_hidden_state),
                      (out.penultimate(), ref.penultimate()),
                      (out.pooled_output, ref.pooled_output)):
        _close(got, want, 1e-5)
    assert len(out.hidden_states) == len(ref.hidden_states) == cfg.num_hidden_layers + 1
    if with_projection:
        _close(out.image_embeds, ref.image_embeds, 1e-5)
    else:
        assert out.image_embeds is None and ref.image_embeds is None


def _proj_groups(unet_config, **kw):
    state = ip_adapter_state(unet_config, VCFG, seed=3, **kw)
    group = {k[len("image_proj."):]: v for k, v in state.items() if k.startswith("image_proj.")}
    return state, group


@pytest.mark.parametrize("kw", [dict(), dict(num_tokens=2), PLUS, dict(PLUS, depth=1)],
                         ids=["proj4", "proj2", "plus", "plus_depth1"])
def test_image_projection_matches_jax(kw):
    _, group = _proj_groups(tiny_port_model().unet_config, **kw)
    cfg = ip_adapter.infer_image_proj_config(group)
    jcfg_ = jip.infer_image_proj_config({k: v.numpy() for k, v in group.items()})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_)
    proj = ip_adapter.build_image_proj(cfg, group)
    proj.load_state_dict(group)
    jparams = jip.convert_image_proj({k: v.numpy() for k, v in group.items()})
    rng = np.random.default_rng(4)
    feats = (rng.standard_normal((2, VCFG.projection_dim)) if cfg.kind == "proj"
             else rng.standard_normal((2, 17, VCFG.hidden_size))).astype(np.float32)
    ref = jip.project_image_embeds(jparams, jcfg_, jnp.asarray(feats))
    with torch.no_grad():
        got = ip_adapter.project_image_embeds(proj, torch.from_numpy(feats))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("cfg", [SD15_UNET, SDXL_UNET, tiny_port_model().unet_config,
                                 tiny_sdxl_port_model().unet_config],
                         ids=["sd15", "sdxl", "tiny", "tiny_sdxl"])
def test_cross_attn_paths_equal_jax(cfg):
    paths = ip_adapter.cross_attn_paths(cfg)
    assert paths == jip.cross_attn_paths(jcfg.UNetConfig(**dataclasses.asdict(cfg)))
    if cfg is SD15_UNET:
        assert len(paths) == 16
    if cfg is SDXL_UNET:
        assert len(paths) == 70


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{family: (jax model, port model)}, each with a standard adapter and
    the tiny image encoder loaded from files, and the Plus adapter's path."""
    out = {}
    root = tmp_path_factory.mktemp("ip")
    enc = write_image_encoder_folder(str(root / "image_encoder"), VCFG, device="cpu",
                                     dtype=torch.float32, seed=5)
    for family, tm in (("sd15", tiny_port_model(seed=11)), ("sdxl", tiny_sdxl_port_model(seed=12))):
        jm = to_jax_model(tm)
        std = write_ip_adapter_file(str(root / f"{family}_std.safetensors"), tm.unet_config,
                                    VCFG, seed=7, dtype=torch.float32)
        plus = write_ip_adapter_file(str(root / f"{family}_plus.safetensors"), tm.unet_config,
                                     VCFG, seed=8, dtype=torch.float32, **PLUS)
        for m in (tm, jm):
            m.load_ip_adapter(std)
            m.load_image_encoder(str(root))
        out[family] = (jm, tm, std, plus)
    return out


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_decoupled_attention_matches_jax(pair, family):
    jm, tm, _, _ = pair[family]
    cfg = tm.unet_config
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim)).astype(np.float32)
    ip = rng.standard_normal((2, 4, cfg.cross_attention_dim)).astype(np.float32)
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        added = {"text_embeds": rng.standard_normal((2, pooled)).astype(np.float32),
                 "time_ids": np.tile(np.float32([32, 32, 0, 0, 32, 32]), (2, 1))}
    ref = jitted(junet.apply)(jm.unet_params, jm.unet_config, jnp.asarray(x), jnp.asarray(300),
                      jnp.asarray(ctx), added_cond=None if added is None else
                      {k: jnp.asarray(v) for k, v in added.items()},
                      ip_hidden_states=jnp.asarray(ip), ip_scale=jnp.float32(0.6))
    with torch.no_grad():
        got = tm.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(300),
                      torch.from_numpy(ctx), None if added is None else
                      {k: torch.from_numpy(v) for k, v in added.items()},
                      ip_hidden_states=torch.from_numpy(ip), ip_scale=0.6)
    _close(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("family, kw", [
    ("sd15", dict(embeds="half")),
    ("sd15", dict(embeds="full", ip_adapter_scale=0.5)),
    ("sd15", dict(image=True)),
    ("sd15", dict(image=True, plus=True, guidance_scale=1.0)),
    ("sd15", dict(image=True, plus=True, output_type="np", num_images_per_prompt=2)),
    ("sdxl", dict(embeds="half")),
    ("sdxl", dict(image=True, plus=True)),
], ids=["sd15_embeds", "sd15_embeds_cfg_scale", "sd15_image", "sd15_plus_no_cfg",
        "sd15_plus_np_n2", "sdxl_embeds", "sdxl_plus"])
def test_pipeline_ip_adapter_matches_jax(pair, family, kw):
    jm, tm, std, plus = pair[family]
    kw = dict(kw)
    if kw.pop("plus", False):
        for m in (tm, jm):
            m.load_ip_adapter(plus)
    common = dict(REQ, **{k: v for k, v in kw.items() if k not in ("embeds", "image")})
    xdim = tm.unet_config.cross_attention_dim
    rng = np.random.default_rng(10)
    if kw.get("embeds"):
        n = 1 if kw["embeds"] == "half" else 2
        common["ip_adapter_image_embeds"] = rng.standard_normal((n, 4, xdim)).astype(np.float32)
    else:
        common["ip_adapter_image"] = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    try:
        with capture_jax_draws() as draws:
            ref = JPipeline()(jm, **common)
        got = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **common)
    finally:
        for m in (tm, jm):
            m.load_ip_adapter(std)
    key = "latents" if common["output_type"] == "latents" else "images"
    _close(getattr(got, key), getattr(ref, key))


def test_ip_adapter_guards_raise_as_jax(pair):
    jm, tm, _, _ = pair["sd15"]
    bad = dict(REQ, ip_adapter_image_embeds=np.zeros((3, 4, 32), np.float32))
    for pipe, m in ((JPipeline(), jm), (StableDiffusionUnifiedPipeline(device="cpu"), tm)):
        with pytest.raises(ValueError, match="ip_adapter_image_embeds batch 3"):
            pipe(m, **bad)
    fresh = tiny_port_model(seed=1)
    jfresh = to_jax_model(fresh)
    img = dict(REQ, ip_adapter_image=np.zeros((32, 32, 3), np.float32))
    for pipe, m in ((JPipeline(), jfresh), (StableDiffusionUnifiedPipeline(device="cpu"), fresh)):
        with pytest.raises(ValueError, match="no IP-Adapter loaded"):
            pipe(m, **img)


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _jax_state(tree):
    return {k: torch.from_numpy(np.array(to_torch_layout(k, np.asarray(v))))
            for k, v in flatten(tree).items()}


def _assert_state_equal(state, ref, fused=()):
    """Equal key sets and tensors; the weights a LoRA fused into (`fused`
    paths) within the port's fusion rounding (one fp32 ulp of the fused
    weight, so an int8 code may move by one and a scale by 1e-6)."""
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        w = ref[k].to(v.dtype)
        if k.rpartition(".")[0] in fused:
            if v.dtype == torch.int8:
                assert (v.int() - w.int()).abs().max() <= 1, k
            else:
                torch.testing.assert_close(v, w, rtol=1e-6, atol=1e-7, msg=k)
        else:
            assert torch.equal(v, w), k


def test_lifecycle_with_lora_and_int8_matches_jax(tmp_path):
    """load_ip_adapter, a LoRA fused, quantize("w8"): every UNet tensor (the
    IP projections' int8 codes included) equal to JAX's; quantize(None),
    delete_adapters, unload_ip_adapter: the UNet bit for bit as before."""
    tm = tiny_port_model(seed=13)
    jm = to_jax_model(tm)
    before = _state(tm.unet)
    path = write_ip_adapter_file(str(tmp_path / "ip.safetensors"), tm.unet_config, VCFG,
                                 seed=14, dtype=torch.float32, std=0.2)
    tm.load_ip_adapter(path)
    jm.load_ip_adapter(path)
    _assert_state_equal(_state(tm.unet), _jax_state(jm.unet_params))
    rng = np.random.default_rng(15)
    adapter = {}
    for p in core.linear_module_paths(tm.unet, core.UNET_TARGET_SUFFIXES):
        n_out, n_in = tm.unet.get_submodule(p).weight.shape
        adapter[p] = {"down": rng.standard_normal((n_in, 2)).astype(np.float32) * 0.2,
                      "up": rng.standard_normal((2, n_out)).astype(np.float32) * 0.2,
                      "alpha": np.float32(2.0)}
    tm.load_lora_weights("a", {"unet": {p: {k: torch.from_numpy(np.asarray(v))
                                            for k, v in f.items()} for p, f in adapter.items()}})
    jm.load_lora_weights("a", {"unet": {p: {k: jnp.asarray(v) for k, v in f.items()}
                                        for p, f in adapter.items()}})
    tm.set_adapters({"a": 0.8})
    jm.set_adapters({"a": 0.8})
    tm.quantize("w8", min_size=1)
    jm.quantize("w8", min_size=1)
    state = _state(tm.unet)
    _assert_state_equal(state, _jax_state(jm.unet_params), fused=set(adapter))
    ip_int8 = [k for k in state if ".to_k_ip.weight_int8" in k or ".to_v_ip.weight_int8" in k]
    assert len(ip_int8) == 2 * len(ip_adapter.cross_attn_paths(tm.unet_config))
    # a reload of the adapter under int8 keeps the LoRA and the mode
    tm.load_ip_adapter(path)
    _assert_state_equal(_state(tm.unet), state)
    tm.quantize(None)
    tm.delete_adapters()
    assert any(".to_k_ip." in k for k in tm.unet.state_dict())
    tm.unload_ip_adapter()
    _assert_state_equal(_state(tm.unet), before)
    assert tm.ip_adapter is None


def test_handler_ip_adapter_key(tmp_path):
    tm = tiny_port_model(seed=16)
    path = write_ip_adapter_file(str(tmp_path / "ip.safetensors"), tm.unet_config, VCFG,
                                 seed=17, dtype=torch.float32)
    h = Handler(model=tm, model_dir=str(tmp_path))
    args = dict(prompt="a cat", num_inference_steps=2, height=32, width=32, seed=1)
    plain = h(dict(args))
    assert "error" not in plain
    # JAX's handler loads the adapter without an image encoder, so an image
    # prompt answers on the error channel and precomputed embeds go through
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((32, 32, 3), 128, np.uint8)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    resp = h({**args, "model": {"ip_adapter": "ip.safetensors"}, "ip_adapter_image": b64})
    assert "error" in resp and "no image encoder loaded" in resp["error"]
    assert tm.ip_adapter is not None
    embeds = np.random.default_rng(0).standard_normal((1, 4, 32)).tolist()
    with_ip = h({**args, "params": {"ip_adapter_image_embeds": embeds}})
    assert "error" not in with_ip and with_ip["images"] != plain["images"]
    write_image_encoder_folder(str(tmp_path / "image_encoder"), VCFG, device="cpu",
                               dtype=torch.float32, seed=2)
    tm.load_image_encoder(str(tmp_path))
    assert "error" not in h({**args, "ip_adapter_image": b64})
    h({**args, "model": {"ip_adapter": None}})
    assert tm.ip_adapter is None
    assert h(dict(args))["images"] == plain["images"]


def test_image_encoder_folders_both_ways(tmp_path):
    write_image_encoder_folder(str(tmp_path / "image_encoder"), VCFG, device="cpu",
                               dtype=torch.float32, seed=3)
    cfg, enc = load_image_encoder(str(tmp_path), torch.device("cpu"), torch.float32)
    assert cfg == VCFG
    jm = to_jax_model(tiny_port_model())
    jm.load_image_encoder(str(tmp_path))
    assert dataclasses.asdict(jm.image_encoder_config) == dataclasses.asdict(cfg)
    _assert_state_equal(_state(enc), _jax_state(jm.image_encoder_params))
    # the ViT-H/14 preset is the JAX config's default
    assert dataclasses.asdict(IP_ADAPTER_IMAGE_ENCODER) == dataclasses.asdict(
        jcfg.CLIPVisionConfig())


def test_load_from_jax_fills_the_vision_tower_and_resampler():
    """``io/from_jax.load_from_jax`` carries the JAX package's own trees:
    ``clip_vision.init_params`` (the patch kernel HWIO, the class embedding
    and position table as they are) and a converted Resampler (its
    ``latents`` as they are), which then compute as JAX does."""
    import jax

    from stablediffusion_tpu_torch.io.from_jax import load_from_jax

    # init under jit: one compile in place of the eager init's per-op ones
    jtree = jax.jit(jclip_vision.init_params, static_argnums=1)(
        jax.random.key(3), jcfg.CLIPVisionConfig(**dataclasses.asdict(VCFG)))
    with torch.device("meta"):
        enc = CLIPVisionModel(VCFG)
    enc = load_from_jax(enc.to_empty(device="cpu"), jax.device_get(jtree))
    px = np.random.default_rng(5).standard_normal((1, 32, 32, 3)).astype(np.float32)
    ref = jclip_vision.apply(jtree, jcfg.CLIPVisionConfig(**dataclasses.asdict(VCFG)),
                             jnp.asarray(px))
    with torch.no_grad():
        out = enc(torch.from_numpy(px).permute(0, 3, 1, 2))
    _close(out.image_embeds, ref.image_embeds, 1e-5)
    _, group = _proj_groups(tiny_port_model().unet_config, **PLUS)
    cfg = ip_adapter.infer_image_proj_config(group)
    jparams = jip.convert_image_proj({k: v.numpy() for k, v in group.items()})
    proj = load_from_jax(ip_adapter.build_image_proj(cfg, group), jax.device_get(jparams))
    for k, v in proj.state_dict().items():
        assert torch.equal(v, group[k]), k
