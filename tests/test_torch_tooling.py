"""PyTorch/CUDA port: the tooling, on the CPU.

``io/convert_cli`` against the JAX package's on seeded single files
(.safetensors and .ckpt, with --extract_ema and --half; a ControlNet file):
every tensor of the written folders equal and the JSON files equal; the
native BPE loop's ids equal the pure-Python loop's on the synthetic
vocabulary, with the path counter; ``utils/bench_utils``' FLOP count of a
tiny UNet call equal to a hand count from the call's linears, convolutions
and attentions, and the attention FLOPs from launch records; ``trace`` and
``profile_to`` writing their outputs; the handler's ``inference_wandb``
mode without wandb; the kernel build cache's directory.
"""

import json
import os

import numpy as np
import pytest
import torch

from stablediffusion_tpu.io import convert_cli as jconvert
from stablediffusion_tpu_torch.core import compile_cache
from stablediffusion_tpu_torch.io import convert_cli
from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile
from stablediffusion_tpu_torch.models import layers as tlayers
from stablediffusion_tpu_torch.models import unet as tunet
from stablediffusion_tpu_torch.ops import _build
from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
from stablediffusion_tpu_torch.serve.handler import Handler
from stablediffusion_tpu_torch.tokenizer import bpe_native, clip_bpe
from stablediffusion_tpu_torch.utils import bench_utils
from stablediffusion_tpu_torch.utils.observability import Metrics, profile_to, trace
from stablediffusion_tpu_torch.utils.testing import (
    ldm_state_dict,
    save_ldm_single_file,
    write_controlnet_folder,
)
from torch_port_helpers import port_test_module, port_tokenizer, tiny_port_model  # noqa: F401


def _folder_tensors(root):
    """{relative file: {name: array}} and {relative file: parsed JSON}."""
    tensors, jsons = {}, {}
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if f.endswith(".safetensors"):
                with SafetensorsFile(os.path.join(d, f)) as sf:
                    tensors[rel] = {k: np.array(sf.tensor(k)) for k in sf.keys()}
            elif f.endswith(".json"):
                with open(os.path.join(d, f)) as fh:
                    jsons[rel] = json.load(fh)
    return tensors, jsons


@pytest.fixture(scope="module")
def single_files(tmp_path_factory):
    """A seeded tiny SD1.5 model as an LDM .safetensors file and a .ckpt
    (with model_ema copies, for --extract_ema)."""
    root = tmp_path_factory.mktemp("single")
    tm = tiny_port_model(seed=4)
    st = str(root / "model.safetensors")
    save_ldm_single_file(tm, st)
    state = dict(ldm_state_dict(tm))
    for k, v in list(state.items()):
        if k.startswith("model.diffusion_model."):
            state["model_ema." + k[len("model."):].replace(".", "")] = v * 0.5
    ck = str(root / "model.ckpt")
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}}, ck)
    return st, ck


@pytest.mark.parametrize("fmt, flags", [("safetensors", []), ("ckpt", ["--extract_ema"]),
                                        ("safetensors", ["--half",
                                                         "--scheduler_type", "euler"])],
                         ids=["safetensors", "ckpt_ema", "half"])
def test_convert_cli_matches_jax(single_files, tmp_path, fmt, flags):
    src = single_files[0] if fmt == "safetensors" else single_files[1]
    argv = ["--checkpoint_path", src, *flags]
    assert convert_cli.main([*argv, "--save_path", str(tmp_path / "port")]) == "sd15"
    jconvert.main([*argv, "--save_path", str(tmp_path / "jax")])
    pt, pj = _folder_tensors(tmp_path / "port")
    jt, jj = _folder_tensors(tmp_path / "jax")
    assert pj == jj
    assert sorted(pt) == sorted(jt) and len(pt) == 3
    for f in pt:
        assert sorted(pt[f]) == sorted(jt[f]), f
        for k in pt[f]:
            assert pt[f][k].dtype == jt[f][k].dtype, (f, k)
            np.testing.assert_array_equal(pt[f][k], jt[f][k], err_msg=f"{f} {k}")


def test_convert_cli_controlnet_matches_jax(tmp_path):
    """A ControlNet single file: a seeded diffusers ControlNet renamed to the
    LDM control_model layout (the UNet trunk's LDM names, input_hint_block,
    zero_convs, middle_block_out)."""
    tm = tiny_port_model(seed=5)
    folder = write_controlnet_folder(str(tmp_path / "cn"), tm.unet_config, device="cpu",
                                     dtype=torch.float32, seed=2)
    from stablediffusion_tpu_torch.io.loader import load_controlnet
    from stablediffusion_tpu_torch.utils.testing import _unet_key_to_ldm

    cfg, net = load_controlnet(folder, torch.device("cpu"), torch.float32)
    state = {}
    for k, v in net.state_dict().items():
        if k.startswith("controlnet_cond_embedding."):
            rest = k[len("controlnet_cond_embedding."):]
            idx = {"conv_in": 0, "conv_out": 14}.get(rest.split(".")[0])
            if idx is None:  # blocks.i -> input_hint_block.(2 + 2 i)
                idx = 2 + 2 * int(rest.split(".")[1])
                rest = rest.split(".", 2)[2]
            else:
                rest = rest.split(".", 1)[1]
            state[f"control_model.input_hint_block.{idx}.{rest}"] = v.numpy()
        elif k.startswith("controlnet_down_blocks."):
            i, rest = k[len("controlnet_down_blocks."):].split(".", 1)
            state[f"control_model.zero_convs.{i}.0.{rest}"] = v.numpy()
        elif k.startswith("controlnet_mid_block."):
            state["control_model.middle_block_out.0." + k.split(".", 1)[1]] = v.numpy()
        else:
            state["control_model." + _unet_key_to_ldm(k, cfg)] = v.numpy()
    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors

    src = str(tmp_path / "cn.safetensors")
    save_safetensors(state, src)
    assert convert_cli.main(["--checkpoint_path", src, "--controlnet",
                             "--save_path", str(tmp_path / "port")]) == "controlnet"
    jconvert.main(["--checkpoint_path", src, "--controlnet", "--save_path",
                   str(tmp_path / "jax")])
    pt, pj = _folder_tensors(tmp_path / "port")
    jt, jj = _folder_tensors(tmp_path / "jax")
    assert pj == jj and sorted(pt) == sorted(jt)
    for f in pt:
        assert sorted(pt[f]) == sorted(jt[f])
        for k in pt[f]:
            np.testing.assert_array_equal(pt[f][k], jt[f][k])


def test_native_bpe_ids_equal_python():
    """The native merge loop gives the pure-Python loop's ids on every word
    of a mixed text, and the counter records which path ran."""
    assert bpe_native.available()
    texts = ["a photograph of an astronaut riding a horse", "hello world, 12 cats!",
             "the quick brown fox jumps over the lazy dog", "zzz qqq xyzzy"]
    native = port_tokenizer()
    python = port_tokenizer()
    python._native = False
    before = dict(clip_bpe.TOKENIZE_PATHS)
    for t in texts:
        np.testing.assert_array_equal(native([t]), python([t]))
    words = sum(len(clip_bpe._PATTERN.findall(clip_bpe._clean(t).lower())) for t in texts)
    assert clip_bpe.TOKENIZE_PATHS["native"] - before["native"] == words
    assert clip_bpe.TOKENIZE_PATHS["python"] - before["python"] == words
    assert bpe_native.lib_path().parent == _build.BUILD_DIR


def test_flop_count_matches_a_hand_count(monkeypatch):
    """bench_utils.flops of a tiny UNet call against the sum of 2·M·N·K over
    the call's linears, 2·(output elements)·C_in·kh·kw over its
    convolutions and 4·B·H·Sq·Skv·D over its attentions, recorded from the
    functions the model calls."""
    tm = tiny_port_model(seed=1)
    counted = []
    orig_lin, orig_conv, orig_attn = tlayers.linear, tlayers.conv2d, tunet.attention

    def linear(x, w, b=None):
        counted.append(2 * x[..., 0].numel() * w.shape[0] * w.shape[1])
        return orig_lin(x, w, b)

    def conv2d(x, w, b=None, **kw):
        y = orig_conv(x, w, b, **kw)
        counted.append(2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    def attention(q, k, v, **kw):
        B, Sq, H, D = q.shape
        counted.append(4 * B * H * Sq * k.shape[1] * D)
        return orig_attn(q, k, v, **kw)

    monkeypatch.setattr(tlayers, "linear", linear)
    monkeypatch.setattr(tlayers, "conv2d", conv2d)
    monkeypatch.setattr(tunet, "attention", attention)
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(r.standard_normal((2, 77, 32)).astype(np.float32))
    with torch.no_grad():
        _, total, parts = bench_utils.flops(tm.unet, x, torch.tensor([3, 700]), ctx)
    assert total == sum(counted) == parts["aten"]  # no kernel launches on the CPU
    assert bench_utils.peak_flops_per_sec() is None and bench_utils.mfu(total, 1.0) is None


def test_attention_flops_from_launch_records():
    """The kernels' FLOPs come from their launch records: 4·B·H·Sq·Skv·D a
    forward, counted after a snapshot."""
    snap = bench_utils.launch_snapshot()
    q, k = torch.empty(2, 64, 8, 40), torch.empty(2, 77, 8, 40)
    try:
        FLASH_FWD_LAUNCHES.add(q, k)
        FLASH_FWD_LAUNCHES.add(q, k)
        got = bench_utils.attention_flops(snap)
    finally:
        FLASH_FWD_LAUNCHES.by_shape = snap["flash_fwd"]
        FLASH_FWD_LAUNCHES.count -= 2
    assert got["flash_fwd"] == 2 * 4 * 2 * 8 * 64 * 77 * 40
    assert got["flash_bwd_dq"] == got["flash_stream"] == 0


def test_record_result_writes_only_its_path(tmp_path):
    path = str(tmp_path / "r.json")
    bench_utils.record_result("a", {"x": 1}, path)
    bench_utils.record_result("b", {"y": 2}, path)
    with open(path) as f:
        data = json.load(f)
    assert data["a"]["x"] == 1 and data["b"] == {"y": 2, "device": "cpu"}


def test_trace_and_profile_to_write_their_output(tmp_path):
    """A span records its wall in the metrics and appears in the Chrome
    trace that profile_to writes."""
    m = Metrics()
    with profile_to(str(tmp_path)) as prof:
        with trace("generate", m):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert m.counts["generate_sec"] == 1 and m.values["generate_sec"] > 0
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "generate" for e in events)
    assert any(e.key == "generate" for e in prof.key_averages())


def test_inference_wandb_without_wandb():
    """wandb is not installed: the mode renders and returns its config
    inline (JAX handler.py:461-462)."""
    with pytest.raises(ImportError):
        import wandb  # noqa: F401
    h = Handler(model=tiny_port_model(seed=6))
    resp = h({"mode": "inference_wandb", "prompt": "a cat", "num_inference_steps": 2,
              "height": 32, "width": 32, "seed": 5, "guidance_scale": 4.0})
    assert "error" not in resp, resp
    assert resp["wandb_url"] is None and len(resp["images"]) == 1 and resp["seed"] == 5
    assert resp["config"] == {"prompt": "a cat", "negative_prompt": None, "scheduler": "DDIM",
                              "steps": 2, "cfg": 4.0, "clip_skip": None, "seed": 5,
                              "adapters": {}}


def test_compile_cache_points_the_builds_at_its_directory(tmp_path, monkeypatch):
    """Without a card and without a path nothing moves; with a path the
    kernels' and the BPE library's builds go under {path}/cuda."""
    before = _build.BUILD_DIR
    monkeypatch.setattr(compile_cache, "_ENABLED", None)
    try:
        assert compile_cache.enable_compilation_cache() is False
        assert _build.BUILD_DIR == before
        assert compile_cache.enable_compilation_cache(str(tmp_path)) is True
        assert _build.BUILD_DIR == tmp_path / "cuda"
        assert bpe_native.build().parent == tmp_path / "cuda"
        assert _build._lib_path("flash_fwd").parent == tmp_path / "cuda"
    finally:
        _build.BUILD_DIR = before
