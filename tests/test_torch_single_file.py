"""PyTorch/CUDA port: A1111/LDM single-file checkpoints, their serving and
the handler's constructor mode, against the JAX package, in fp32 on the CPU.

The port's LDM writer (``utils/testing.save_ldm_single_file``) is held by
the JAX converter; a tiny LDM file (the JAX tests' own, and one the writer
makes from a model whose configs the converter recovers) loads in both
packages with equal tensors and gives the same txt2img image within 1e-4 of
max(1, max |ref|), JAX draws injected; the handler serves a single file
like the folder of the same weights, and its constructor grid matches
JAX's within one uint8 level.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from helpers import tiny_tokenizer
from stablediffusion_tpu.io import loader as jloader
from stablediffusion_tpu.io.a1111 import convert_a1111_checkpoint as jconvert
from stablediffusion_tpu.io.torch_convert import flatten as jflatten
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu.serve.handler import Handler as JHandler
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io import loader
from stablediffusion_tpu_torch.io.from_jax import to_torch_layout
from stablediffusion_tpu_torch.lora import core
from stablediffusion_tpu_torch.lora.formats import save_lora_file
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.serve.handler import Handler
from stablediffusion_tpu_torch.utils.testing import (
    ldm_state_dict,
    random_lora,
    save_ldm_single_file,
)
from test_a1111 import _unet_to_ldm, _vae_to_ldm
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    _init,
    port_test_module,
    port_tokenizer,
    tiny_port_model,
    tiny_sdxl_port_model,
)

ATOL = 1e-4
COMPONENTS = ("unet", "vae", "text_encoder")


def inferable_tiny_model(seed: int = 0) -> SDModel:
    """A tiny SD1.5-layout model whose configs the single-file converter
    recovers from its tensors' shapes: 8 heads and 32 norm groups (the LDM
    defaults), a 1-head gelu CLIP, the default sizes and EOS id."""
    g = torch.Generator().manual_seed(seed)
    uc = dataclasses.replace(tcfg.tiny_unet_config(), block_out_channels=(32, 64),
                             norm_num_groups=32, num_attention_heads=8, sample_size=64)
    vc = dataclasses.replace(tcfg.tiny_vae_config(), block_out_channels=(32, 64),
                             norm_num_groups=32, sample_size=512)
    cc = dataclasses.replace(tcfg.tiny_clip_config(), num_attention_heads=1,
                             hidden_act="gelu", eos_token_id=49407)
    return SDModel(unet_config=uc, unet=_init(UNet2DConditionModel(uc), g),
                   vae_config=vc, vae=_init(AutoencoderKL(vc), g),
                   text_encoder_config=cc, text_encoder=_init(CLIPTextModel(cc), g),
                   tokenizer=port_tokenizer())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(model dir, source model): the inferable model as the folder
    ``sd15_tiny`` and the single file ``model.safetensors`` beside a
    ``tokenizer/`` folder, and a kohya LoRA ``sd15_k`` on its UNet and CLIP
    attention."""
    root = tmp_path_factory.mktemp("single")
    model = inferable_tiny_model()
    loader.save_sd_model(model, str(root / "sd15_tiny"))
    save_ldm_single_file(model, str(root / "model.safetensors"))
    model.tokenizer.save_pretrained(str(root / "tokenizer"))
    save_lora_file({"unet": random_lora(model.unet, core.UNET_TARGET_SUFFIXES, 2, 1, 0.3),
                    "text_encoder": random_lora(model.text_encoder,
                                                core.TEXT_TARGET_SUFFIXES, 2, 2, 0.3)},
                   str(root / "sd15_k.safetensors"), format="kohya")
    return root, model


def _assert_state_equal(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _assert_equal_to_jax(module: torch.nn.Module, tree):
    flat = {k: to_torch_layout(k, np.asarray(v)) for k, v in jflatten(tree).items()}
    state = module.state_dict()
    assert set(flat) == set(state)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def test_ldm_writer_is_held_by_the_jax_converter():
    """The JAX package's ``convert_a1111_checkpoint`` of the writer's output
    gives back every source tensor, and the shapes' configs."""
    tm = tiny_port_model(seed=4)
    weights, configs = jconvert({k: v.numpy() for k, v in ldm_state_dict(tm).items()})
    assert configs["model_type"] == "sd15"
    for comp in COMPONENTS:
        state = getattr(tm, comp).state_dict()
        assert set(weights[comp]) == set(state), comp
        for k, v in state.items():
            np.testing.assert_array_equal(weights[comp][k], v.numpy(), err_msg=k)
    assert configs["unet"]["block_out_channels"] == [16, 32]
    with pytest.raises(NotImplementedError, match="SD1.x"):
        ldm_state_dict(tiny_sdxl_port_model())


def test_jax_tests_single_file_loads_in_both(tmp_path):
    """An LDM file written by ``tests/test_a1111.py``'s own inverse mapping
    (``_unet_to_ldm`` / ``_vae_to_ldm``, CLIP-L under its prefix as
    ``_tiny_single_file`` writes it), over a tiny port model's weights in
    place of that test's slow JAX initialisation: both packages read the
    same tensors.  Head counts and norm groups are not in the shapes; the
    port builds with the ones given, where the JAX test replaces its
    configs after loading."""
    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

    tm = tiny_port_model(seed=7)
    state = _unet_to_ldm({k: v.numpy() for k, v in tm.unet.state_dict().items()},
                         tm.unet_config)
    state.update(_vae_to_ldm({k: v.numpy() for k, v in tm.vae.state_dict().items()}))
    state.update({f"cond_stage_model.transformer.{k}": v.numpy()
                  for k, v in tm.text_encoder.state_dict().items()})
    ckpt = str(tmp_path / "model.safetensors")
    save_safetensors({k: np.ascontiguousarray(v) for k, v in state.items()}, ckpt)
    tiny_tokenizer().save_pretrained(str(tmp_path / "tokenizer"))
    jm = jloader.load_sd_single_file(ckpt, tokenizer_dir=str(tmp_path))
    over = {"unet": {"num_attention_heads": 2, "norm_num_groups": 8},
            "vae": {"norm_num_groups": 4}}
    pm = loader.load_sd_single_file(ckpt, tokenizer_dir=str(tmp_path), device="cpu",
                                    config_overrides=over)
    assert pm.model_type == jm.model_type == "sd15" and pm.path == jm.path
    assert pm.unet_config == dataclasses.replace(tm.unet_config, sample_size=64)
    assert pm.vae_config.norm_num_groups == 4
    for comp in COMPONENTS:
        _assert_equal_to_jax(getattr(pm, comp), getattr(jm, f"{comp}_params"))
    for comp in COMPONENTS:
        _assert_state_equal(getattr(pm, comp), getattr(tm, comp))
    assert pm.text_encoder_config.hidden_act == jm.text_encoder_config.hidden_act == "gelu"
    assert pm.tokenizer.tokenize("a cat") == tiny_tokenizer().tokenize("a cat")


def test_written_file_round_trips_and_matches_jax(served):
    """The writer's file: the port loads every tensor equal to the source
    and recovers its configs; the JAX loader reads the same tensors; the
    txt2img images agree."""
    root, model = served
    ckpt = str(root / "model.safetensors")
    tm = loader.load_sd_single_file(ckpt, tokenizer_dir=str(root), device="cpu")
    jm = jloader.load_sd_single_file(ckpt, tokenizer_dir=str(root))
    for comp in COMPONENTS:
        _assert_state_equal(getattr(tm, comp), getattr(model, comp))
        _assert_equal_to_jax(getattr(tm, comp), getattr(jm, f"{comp}_params"))
    assert (tm.unet_config, tm.vae_config, tm.text_encoder_config) == (
        model.unet_config, model.vae_config, model.text_encoder_config)
    req = dict(prompt="a dog", num_inference_steps=2, guidance_scale=7.5, height=32,
               width=32, seed=2, output_type="np")
    with capture_jax_draws() as draws:
        ref = np.asarray(JPipeline(do_cfg=True)(jm, **req).images)
    out = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **req).images
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_tokenizers_prediction_type_and_reload(served):
    """No tokenizer_dir: no tokenizer (a warning); prediction_type is
    applied; reload drops adapters and textual inversions and keeps the
    tokenizer, the configs and the prediction type."""
    root, _ = served
    ckpt = str(root / "model.safetensors")
    assert loader.load_sd_single_file(ckpt, device="cpu").tokenizer is None
    tm = loader.load_sd_single_file(ckpt, tokenizer_dir=str(root), device="cpu",
                                    prediction_type="v_prediction")
    assert tm.scheduler_config.prediction_type == "v_prediction"
    assert tm.path == os.path.abspath(ckpt)
    state0 = {k: v.clone() for k, v in tm.text_encoder.state_dict().items()}
    tok = tm.tokenizer
    tm.load_loras({"k": 0.7}, lora_dir=str(root))
    tm.load_textual_inversion({"<c>": np.ones((1, 32), np.float32)})
    assert tm.reload() is tm
    assert tm.tokenizer is tok and tok.added_tokens == {} and tm.adapters == {}
    assert tm.scheduler_config.prediction_type == "v_prediction"
    state = tm.text_encoder.state_dict()
    assert all(torch.equal(state[k], v) for k, v in state0.items())
    folder = loader.load_sd_model(str(root / "sd15_tiny"), device="cpu")
    folder.load_loras(["k"], lora_dir=str(root))
    assert folder.reload().adapters == {}


def test_sdxl_tokenizer_2_falls_back_to_the_first(tmp_path, monkeypatch):
    """An SDXL single file with only ``tokenizer/`` beside it: the second
    tower reuses its files with OpenCLIP's pad (id 0).  The converter is
    replaced by one that returns a tiny SDXL model's tensors, as the JAX
    test does, since the writer covers SD1.x only."""
    import stablediffusion_tpu_torch.io.a1111 as a1111

    src = tiny_sdxl_port_model(seed=6)
    comps = COMPONENTS + ("text_encoder_2",)

    def fake_convert(state, extract_ema_weights=False, scaling_factor=None):
        weights = {c: {k: v.numpy() for k, v in getattr(src, c).state_dict().items()}
                   for c in comps}
        configs = {"model_type": "sdxl", "unet": loader._unet_cfg_dict(src.unet_config),
                   "vae": loader._vae_cfg_dict(src.vae_config),
                   "text_encoder": loader._clip_cfg_dict(src.text_encoder_config),
                   "text_encoder_2": loader._clip_cfg_dict(src.text_encoder_2_config)}
        return weights, configs

    monkeypatch.setattr(a1111, "convert_a1111_checkpoint", fake_convert)
    port_tokenizer().save_pretrained(str(tmp_path / "tokenizer"))
    f = tmp_path / "sdxl.safetensors"
    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

    save_safetensors({"dummy": np.zeros(1, np.float32)}, str(f))
    m = loader.load_sd_single_file(str(f), tokenizer_dir=str(tmp_path), device="cpu")
    assert m.is_sdxl and m.tokenizer_2.pad_token_id == 0 and m.tokenizer.pad_token_id == 999
    for c in comps:
        _assert_state_equal(getattr(m, c), getattr(src, c))
    assert next(m.vae.parameters()).dtype == torch.float32


def test_resolve_checkpoint_and_folder_loader_refusal(served, tmp_path):
    root, _ = served
    ckpt = str(root / "model.safetensors")
    assert loader.resolve_checkpoint("sd15", ckpt) == ckpt
    assert loader.resolve_checkpoint("sd15", "model.safetensors",
                                     cache_dir=str(root)) == ckpt
    with pytest.raises(FileNotFoundError):
        loader.resolve_checkpoint("sd15", "nope.safetensors", cache_dir=str(tmp_path))
    with pytest.raises(ValueError, match="load_sd_single_file"):
        loader.load_sd_model(ckpt, device="cpu")


def test_handler_serves_a_single_file_like_its_folder(served):
    """A model block naming the file loads it (tokenizer found beside it)
    once; its image equals the folder's of the same weights, byte for
    byte."""
    root, _ = served
    req = dict(prompt="a cat", height=32, width=32, num_inference_steps=2, seed=4)
    by_file = Handler(model_dir=str(root), device="cpu")
    r1 = by_file({**req, "model": {"type": "sd15", "name": "model.safetensors"}}, "file")
    assert "error" not in r1, r1.get("traceback")
    loaded = by_file.model
    assert loaded.path == os.path.abspath(str(root / "model.safetensors"))
    assert loaded.tokenizer is not None
    by_file({**req, "model": {"type": "sd15", "name": "model.safetensors",
                              "prediction_type": "v_prediction"}}, "again")
    assert by_file.model is loaded  # no reload; the prediction type applies
    assert loaded.scheduler.config.prediction_type == "v_prediction"
    by_folder = Handler(model_dir=str(root), device="cpu")
    r2 = by_folder({**req, "model": {"type": "sd15", "name": "tiny"}}, "folder")
    assert r1["images"] == r2["images"]


def test_constructor_grid_matches_jax(served):
    """mode "constructor" over 2 schedulers x 2 LoRA scales x 1 step count x
    1 guidance scale on the single file with a kohya LoRA: the same grid as
    JAX's, each image within one uint8 level (JAX draws injected per
    generation), and the adapters' own scale back after."""
    root, _ = served
    body = {"mode": "constructor", "prompt": "a cat", "height": 32, "width": 32, "seed": 6,
            "model": {"type": "sd15", "name": "model.safetensors", "loras": {"k": 0.9}},
            "params": {"schedulers": ["DDIM", "euler_a"], "lora_scales": [0.4, 1.0],
                       "steps_grid": [2], "guidance_grid": [7.5]}}
    jh = JHandler(model_dir=str(root))
    th = Handler(model_dir=str(root), device="cpu")
    draws, images = [], {"jax": [], "port": []}
    j_orig, t_orig = jh._generate, th._generate

    def j_gen(args, output_type="uint8"):
        with capture_jax_draws() as d:
            out = j_orig(args, output_type)
        draws.append(d)
        images["jax"].append(np.asarray(out.images))
        return out

    def t_gen(args, output_type="uint8"):
        out = t_orig(dict(args, draws=draws[len(images["port"])]), output_type)
        images["port"].append(out.images)
        return out

    jh._generate, th._generate = j_gen, t_gen
    gen0 = th.model_generation
    ref, out = jh(dict(body), "j"), th(dict(body), "t")
    assert "error" not in out, out.get("traceback")
    assert th.model_generation == gen0 + 2
    strip = lambda g: [{k: v for k, v in r.items() if k != "images"} for r in g]  # noqa: E731
    assert strip(out["grid"]) == strip(ref["grid"]) and len(out["grid"]) == 4
    for a, b in zip(images["port"], images["jax"]):
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert th.model.get_list_adapters() == {"k": 0.9}
    assert th.model.scheduler_name == "euler_a"


def test_single_file_loader_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_sd_single_file("no-such-file.safetensors")
