"""PyTorch/CUDA port: checkpoint folders, safetensors and the tokenizer's
save, against the JAX package, on the CPU.

A folder written by the JAX package's ``save_sd_model`` loads into the port,
and one written by the port's loads into the JAX package's
``load_sd_model``, with every tensor equal both ways; the tiny txt2img from
the loaded folders agrees within 1e-4.  The same holds for SDXL folders
(the second text tower and its tokenizer), and an SD2.x-layout folder loads
as "sd15" in both packages.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.io import loader as jloader
from stablediffusion_tpu.io.safetensors_io import load_safetensors as jload_safetensors
from stablediffusion_tpu.io.torch_convert import deconvert_tensor, flatten
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu.tokenizer.clip_bpe import CLIPTokenizer as JCLIPTokenizer
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io import loader
from stablediffusion_tpu_torch.io.safetensors_io import (
    SafetensorsFile,
    save_safetensors,
)
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer
from stablediffusion_tpu_torch.utils.testing import synthetic_clip_tokenizer
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

COMPONENTS = ("unet", "vae", "text_encoder")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """(port model, its JAX twin, a JAX-written folder, a port-written one)."""
    tm = tiny_port_model(seed=3)
    tm.set_scheduler("euler_a")
    jm = to_jax_model(tm)
    jm.set_scheduler("euler_a")
    jdir = str(tmp_path_factory.mktemp("jax_saved"))
    tdir = str(tmp_path_factory.mktemp("port_saved"))
    jloader.save_sd_model(jm, jdir)
    loader.save_sd_model(tm, tdir)
    return tm, jm, jdir, tdir


def _assert_same_weights(port_model, jax_model):
    for comp in COMPONENTS:
        sd = getattr(port_model, comp).state_dict()
        flat = flatten(getattr(jax_model, f"{comp}_params"))
        assert set(sd) == set(flat), comp
        for k, v in flat.items():
            np.testing.assert_array_equal(sd[k].numpy(), deconvert_tensor(k, np.asarray(v)),
                                          err_msg=k)


def test_jax_folder_loads_into_the_port(folders):
    tm, jm, jdir, _ = folders
    got = loader.load_sd_model(jdir, device="cpu")
    assert got.path == jdir and got.model_type == "sd15"
    assert got.scheduler_name == "euler_a"  # model_index.json's _scheduler_type
    for comp in COMPONENTS:
        a, b = getattr(got, comp).state_dict(), getattr(tm, comp).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (comp, k)
    assert got.unet_config == tm.unet_config and got.vae_config == tm.vae_config
    assert got.text_encoder_config == tm.text_encoder_config
    assert got.scheduler_config == tm.scheduler_config
    _assert_same_weights(got, jm)


def test_port_folder_loads_into_jax(folders):
    tm, jm, _, tdir = folders
    got = jloader.load_sd_model(tdir)
    assert got.scheduler_name == "euler_a"
    _assert_same_weights(tm, got)
    np.testing.assert_array_equal(got.tokenizer("a cat and a dog"),
                                  tm.tokenizer("a cat and a dog"))
    for sub in ("unet", "vae", "text_encoder"):
        cfg = json.load(open(os.path.join(tdir, sub, "config.json")))
        ref = json.load(open(os.path.join(folders[2], sub, "config.json")))
        assert cfg == ref, sub


def test_txt2img_from_loaded_folders_matches_jax(folders):
    _, _, jdir, tdir = folders
    tm = loader.load_sd_model(jdir, device="cpu", scheduler_name="DDIM")
    jm = jloader.load_sd_model(tdir, scheduler_name="DDIM")
    lat = np.random.default_rng(8).standard_normal((1, 16, 16, 4)).astype(np.float32)
    common = dict(prompt="a cat", num_inference_steps=3, guidance_scale=7.5,
                  output_type="np", seed=0)
    ref = JPipeline(do_cfg=True)(jm, latents=jnp.asarray(lat), **common).images
    out = StableDiffusionUnifiedPipeline(device="cpu")(
        tm, latents=torch.from_numpy(lat), **common).images
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_fp16_variant_sharded_index_and_dtype(folders, tmp_path):
    """The fp16 variant is found first, a sharded index is followed, each
    tensor is cast to its parameter's dtype, and position_ids are dropped."""
    tm, _, jdir, _ = folders
    d = str(tmp_path / "m")
    loader.save_sd_model(tm, d, variant="fp16")
    assert os.path.exists(os.path.join(d, "unet", "diffusion_pytorch_model.fp16.safetensors"))
    # shard the VAE in two through an index, with a stray position_ids
    sd = tm.vae.state_dict()
    names = sorted(sd)
    shards = {"a.safetensors": names[: len(names) // 2], "b.safetensors": names[len(names) // 2:]}
    vdir = os.path.join(d, "vae")
    os.remove(os.path.join(vdir, "diffusion_pytorch_model.fp16.safetensors"))
    for fname, keys in shards.items():
        extra = {"position_ids": torch.arange(4)} if fname == "a.safetensors" else {}
        save_safetensors({**{k: sd[k].half() for k in keys}, **extra}, os.path.join(vdir, fname))
    index = {"weight_map": {k: f for f, ks in shards.items() for k in ks}}
    json.dump(index, open(os.path.join(vdir, "diffusion_pytorch_model.safetensors.index.json"), "w"))
    got = loader.load_sd_model(d, device="cpu", dtype=torch.bfloat16)
    assert next(got.unet.parameters()).dtype == torch.bfloat16
    assert next(got.text_encoder.parameters()).dtype == torch.float32
    for k, v in got.vae.state_dict().items():
        assert torch.equal(v, sd[k].half().to(torch.bfloat16)), k


def test_strict_keys_and_unported_formats(folders, tmp_path):
    tm, _, jdir, _ = folders
    d = str(tmp_path / "m")
    loader.save_sd_model(tm, d)
    path = os.path.join(d, "vae", "diffusion_pytorch_model.safetensors")
    sd = dict(tm.vae.state_dict())
    save_safetensors({**sd, "extra.weight": torch.zeros(2)}, path)
    with pytest.raises(KeyError, match="unexpected"):
        loader.load_sd_model(d, device="cpu")
    sd.pop("decoder.conv_out.bias")
    save_safetensors(sd, path)
    with pytest.raises(KeyError, match="missing"):
        loader.load_sd_model(d, device="cpu")
    # int8 folders are ported: the mode is recorded and the model loads
    # frozen (the int8 parity cases are in test_torch_quant_checkpoint.py)
    loader.save_sd_model(tm, str(tmp_path / "q"), quantize="w8")
    q = loader.load_sd_model(str(tmp_path / "q"), device="cpu")
    assert (q.quant_mode, q.quant_frozen) == ("w8", True)
    with pytest.raises(ValueError, match="requires fp weights"):
        q.quantize("w8a8")
    with pytest.raises(ValueError, match="load_sd3_model"):
        loader.load_sd_model(d, model_type="sd3", device="cpu")
    single = tmp_path / "model.safetensors"
    save_safetensors({"x": torch.zeros(1)}, str(single))
    with pytest.raises(ValueError, match="load_sd_single_file"):
        loader.load_sd_model(str(single), device="cpu")


def test_resolve_checkpoint_is_local_only(tmp_path):
    os.makedirs(tmp_path / "sd15_mine")
    assert loader.resolve_checkpoint("sd15", "mine", cache_dir=str(tmp_path)) == str(
        tmp_path / "sd15_mine")
    with pytest.raises(FileNotFoundError, match="locally"):
        loader.resolve_checkpoint("sd15", "absent", cache_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        loader.resolve_checkpoint("sd15", "absent.safetensors", cache_dir=str(tmp_path))


def test_safetensors_bf16_through_torch_interchanges_with_jax(tmp_path):
    """bf16 written through torch reads back bit-exact, and the JAX codec
    (ml_dtypes) reads the same values."""
    p = str(tmp_path / "t.safetensors")
    t = {"w": torch.randn(3, 5).to(torch.bfloat16), "i": np.arange(4, dtype=np.int64)}
    save_safetensors(t, p, metadata={"k": "v"})
    with SafetensorsFile(p) as f:
        assert f.metadata == {"k": "v"} and f.dtype_str("w") == "BF16"
        assert torch.equal(f.torch_tensor("w"), t["w"])
        np.testing.assert_array_equal(f.tensor("i"), t["i"])
        with pytest.raises(TypeError, match="torch_tensor"):
            f.tensor("w")
    ref = jload_safetensors(p)
    np.testing.assert_array_equal(np.asarray(ref["w"], np.float32), t["w"].float().numpy())


def test_tokenizer_save_pretrained_round_trip(tmp_path):
    tok = tiny_port_model().tokenizer
    tok.save_pretrained(str(tmp_path))
    back = CLIPTokenizer.from_pretrained(str(tmp_path))
    assert back.vocab == tok.vocab and back.bpe_ranks == tok.bpe_ranks
    np.testing.assert_array_equal(back("a cat, a dog"), tok("a cat, a dog"))


def test_config_from_diffusers_dict_matches_jax(folders):
    from stablediffusion_tpu.core import config as jcfg

    _, _, jdir, _ = folders
    for sub, name in (("unet", "UNetConfig"), ("vae", "VAEConfig"),
                      ("text_encoder", "CLIPTextConfig")):
        d = json.load(open(os.path.join(jdir, sub, "config.json")))
        assert (getattr(tcfg, name).from_diffusers_dict(d).__dict__
                == getattr(jcfg, name).from_diffusers_dict(d).__dict__)
    d = {"attention_head_dim": [5, 10], "down_block_types": ["a"], "up_block_types": ["b"],
         "block_out_channels": [32], "prediction_type": "v_prediction", "unknown": 1}
    assert tcfg.UNetConfig.from_diffusers_dict(d).num_attention_heads == (5, 10)
    assert (tcfg.SchedulerConfig.from_diffusers_dict(d).prediction_type == "v_prediction")
    assert tcfg.SD15_INPAINT_UNET.in_channels == 9


SDXL_COMPONENTS = ("unet", "vae", "text_encoder", "text_encoder_2")


def _state_equal(a, b, comps):
    for comp in comps:
        x, y = getattr(a, comp).state_dict(), getattr(b, comp).state_dict()
        assert x.keys() == y.keys(), comp
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), (comp, k)


def test_sdxl_folders_both_ways(tmp_path):
    """An SDXL folder (text_encoder_2/, tokenizer_2/ padding with id 0, the
    SDXL pipeline class) written by either package loads into the other with
    every tensor equal, as model type "sdxl" when none is given; a refiner
    loads from a folder's unet/ alone."""
    tm = tiny_sdxl_port_model(seed=4, refiner=True)
    jm = to_jax_model(tm)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    loader.save_sd_model(tm, tdir)
    jloader.save_sd_model(jm, jdir)
    idx = json.load(open(os.path.join(tdir, "model_index.json")))
    assert idx["_class_name"] == "StableDiffusionXLPipeline"
    got_j = jloader.load_sd_model(tdir)
    assert got_j.model_type == "sdxl"
    for comp in SDXL_COMPONENTS:
        sd, flat = getattr(tm, comp).state_dict(), flatten(getattr(got_j, f"{comp}_params"))
        assert set(sd) == set(flat), comp
        for k, v in flat.items():
            np.testing.assert_array_equal(sd[k].numpy(), deconvert_tensor(k, np.asarray(v)))
    got_t = loader.load_sd_model(jdir, device="cpu")
    assert got_t.model_type == "sdxl" and got_t.is_sdxl
    assert got_t.text_encoder_2_config == tm.text_encoder_2_config
    assert got_t.unet_config == tm.unet_config
    _state_equal(got_t, tm, SDXL_COMPONENTS)
    # the card's dtypes: the UNet in the compute dtype, SDXL's VAE in fp32
    half = loader.load_sd_model(jdir, device="cpu", dtype=torch.bfloat16)
    assert next(half.unet.parameters()).dtype == torch.bfloat16
    assert next(half.vae.parameters()).dtype == torch.float32
    # both packages read each tokenizer folder alike (a pad token is read
    # back as id 0 only when it is "!", OpenCLIP's id 0, in both)
    for d in (tdir, jdir):
        a, b = loader.load_sd_model(d, device="cpu"), jloader.load_sd_model(d)
        for name in ("tokenizer", "tokenizer_2"):
            ta, tb = getattr(a, name), getattr(b, name)
            assert ta.pad_token_id == tb.pad_token_id, (d, name)
            np.testing.assert_array_equal(ta("a cat"), tb("a cat"))
    real_layout = synthetic_clip_tokenizer(pad_token_id=0)
    real_layout.save_pretrained(str(tmp_path / "tok2"))
    assert CLIPTokenizer.from_pretrained(str(tmp_path / "tok2")).pad_token_id == 0
    assert JCLIPTokenizer.from_pretrained(str(tmp_path / "tok2")).pad_token_id == 0
    # the refiner: a folder whose unet/ is the refiner's
    rdir = str(tmp_path / "refiner")
    loader.save_sd_model(dataclasses.replace(tm, unet_config=tm.refiner_config,
                                             unet=tm.refiner), rdir)
    got_t.load_refiner(rdir)
    got_j.load_refiner(rdir)
    assert got_t.refiner_config == tm.refiner_config
    assert got_j.refiner_config == jm.refiner_config
    x, y = got_t.refiner.state_dict(), tm.refiner.state_dict()
    assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


def test_sd2_layout_folder_loads_as_sd15_and_runs(tmp_path):
    """An SD2.x-layout folder (linear projections, per-level heads, one text
    tower) loads as "sd15" in both packages and gives the same txt2img."""
    tm = tiny_port_model(seed=6)
    ucfg = dataclasses.replace(tm.unet_config, use_linear_projection=True,
                               num_attention_heads=(2, 4))
    unet = UNet2DConditionModel(ucfg)
    with torch.no_grad():  # the conv proj weights as linears
        for k, v in unet.state_dict().items():
            src = tm.unet.state_dict()[k]
            v.copy_(src.reshape(v.shape))
    tm = dataclasses.replace(tm, unet_config=ucfg, unet=unet.eval())
    d = str(tmp_path / "sd21_tiny")
    loader.save_sd_model(tm, d)
    got_t, got_j = loader.load_sd_model(d, device="cpu"), jloader.load_sd_model(d)
    assert got_t.model_type == got_j.model_type == "sd15"
    assert got_t.unet_config.use_linear_projection and got_j.unet_config.use_linear_projection
    lat = np.random.default_rng(3).standard_normal((1, 16, 16, 4)).astype(np.float32)
    common = dict(prompt="a dog", num_inference_steps=2, guidance_scale=7.5,
                  output_type="latents", seed=0)
    ref = JPipeline(do_cfg=True)(got_j, latents=jnp.asarray(lat), **common).latents
    out = StableDiffusionUnifiedPipeline(device="cpu")(
        got_t, latents=torch.from_numpy(lat), **common).latents
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))
