"""PyTorch/CUDA port: configs, package boundaries, device policy, routing.

The port (stablediffusion_tpu_torch) keeps its own copies of the JAX
package's configs; each preset must stay field-for-field equal to its JAX
counterpart.  The port must import neither jax nor stablediffusion_tpu, and
must contain no library attention call and no torch.compile.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

import stablediffusion_tpu.core.config as jcfg
import stablediffusion_tpu_torch.core.config as tcfg
from stablediffusion_tpu_torch.ops.attention import _route

PKG = pathlib.Path(tcfg.__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "name",
    [
        "SD15_TEXT_ENCODER", "SD15_UNET", "SD15_VAE", "SD15_SCHEDULER",
        "tiny_clip_config", "tiny_clip_config_proj", "tiny_unet_config",
        "tiny_vae_config", "SchedulerConfig",
    ],
)
def test_config_matches_jax(name):
    def get(mod):
        if name == "tiny_clip_config_proj":
            return mod.tiny_clip_config(with_projection=True)
        obj = getattr(mod, name)
        return obj() if callable(obj) else obj

    assert dataclasses.asdict(get(tcfg)) == dataclasses.asdict(get(jcfg))


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_import_pulls_in_no_jax():
    """Every module of the port, imported in a fresh interpreter (this one
    has jax loaded by conftest), leaves jax and stablediffusion_tpu out of
    sys.modules; the training slice's subpackages are among them."""
    mods = _modules()
    for sub in ("lora.core", "train.optim", "train.train_step", "schedulers.ddpm"):
        assert f"stablediffusion_tpu_torch.{sub}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'stablediffusion_tpu' or m.startswith('stablediffusion_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(PKG.parent), timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_package_source_scan():
    """No jax import, no stablediffusion_tpu import, no library attention,
    no torch.compile anywhere in the port's Python sources."""
    found = []
    scanned = {p.relative_to(PKG).parts[0] for p in PKG.rglob("*.py")}
    assert {"lora", "train", "ops", "models"} <= scanned
    for path in sorted(PKG.rglob("*.py")):
        src = path.read_text()
        if "scaled_dot_product_attention" in src:
            found.append(f"{path.name}: scaled_dot_product_attention")
        tree = ast.parse(src, filename=str(path))
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                root = m.split(".")[0]
                if root in ("jax", "jaxlib", "stablediffusion_tpu"):
                    found.append(f"{path.name}: import {m}")
            if (isinstance(node, ast.Attribute) and node.attr == "compile"
                    and isinstance(node.value, ast.Name) and node.value.id == "torch"):
                found.append(f"{path.name}:{node.lineno}: torch.compile")
            if (isinstance(node, ast.ImportFrom) and node.module == "torch"
                    and any(a.name == "compile" for a in node.names)):
                found.append(f"{path.name}:{node.lineno}: from torch import compile")
    assert not found, found


def test_package_has_both_kernel_sources():
    """Every kernel source the build names is in the package: the two
    forwards and the backward."""
    from stablediffusion_tpu_torch.ops import _build

    names = sorted(p.name for p in (PKG / "csrc").iterdir())
    for src in ("flash_fwd.cu", "flash_stream.cu", "flash_bwd.cu"):
        assert src in names
    assert sorted(f"{s}.cu" for s in _build.SOURCES) == sorted(n for n in names if n.endswith(".cu"))
    assert {src for src, _, _ in _build.ENTRIES.values()} == set(_build.SOURCES)


def test_kernel_library_name_tracks_its_sources(tmp_path, monkeypatch):
    """An edited kernel source or shared header gives a new library name, so
    the next use rebuilds; another kernel's source does not."""
    from stablediffusion_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._lib_path("flash_fwd")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("flash_fwd-")
    with open(csrc / "flash_stream.cu", "a") as f:
        f.write("\n// another kernel's edit\n")
    assert _build._lib_path("flash_fwd") == first
    with open(csrc / "common.cuh", "a") as f:
        f.write("\n// a shared header's edit\n")
    assert _build._lib_path("flash_fwd") != first


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from stablediffusion_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        _build.check("flash_fwd", 700)
    _build.check("flash_fwd", 0)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device="cpu" and without a card, the entry points raise; they
    do not fall back to the CPU."""
    from stablediffusion_tpu_torch.pipelines.unified import (
        StableDiffusionUnifiedPipeline,
    )
    from stablediffusion_tpu_torch.utils.testing import random_full_model, random_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusionUnifiedPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_full_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_model(tcfg.tiny_unet_config(), tcfg.tiny_vae_config(),
                     tcfg.tiny_clip_config(), None)
    assert StableDiffusionUnifiedPipeline(device="cpu").dtype == torch.float32


def test_dtype_policy():
    assert tcfg.default_dtype(torch.device("cuda")) == torch.bfloat16
    assert tcfg.default_dtype(torch.device("cpu")) == torch.float32


@pytest.mark.parametrize(
    "q_shape, k_shape, causal, device, want",
    [
        ((2, 4096, 8, 40), (2, 4096, 8, 40), False, "cuda", "flash_fwd"),  # UNet L1 self, b1
        ((16, 4096, 8, 40), (16, 4096, 8, 40), False, "cuda", "flash_fwd"),  # L1, b8
        ((2, 4096, 8, 40), (2, 77, 8, 40), False, "cuda", "flash_fwd"),  # L1 cross
        ((2, 1024, 8, 80), (2, 1024, 8, 80), False, "cuda", "flash_fwd"),  # L2
        ((2, 256, 8, 160), (2, 77, 8, 160), False, "cuda", "flash_fwd"),  # L3 cross
        ((2, 64, 8, 160), (2, 64, 8, 160), False, "cuda", "flash_fwd"),  # mid block
        ((2, 77, 12, 64), (2, 77, 12, 64), True, "cuda", "flash_fwd"),  # CLIP-L
        ((1, 4096, 1, 512), (1, 4096, 1, 512), False, "cuda", "flash_stream"),  # VAE
        ((1, 16384, 1, 512), (1, 16384, 1, 512), False, "cuda", "flash_stream"),
        ((2, 4096, 8, 40), (2, 4096, 8, 40), False, "cpu", "plain"),
        ((1, 4096, 1, 512), (1, 4096, 1, 512), False, "cpu", "plain"),
    ],
)
def test_route_table(q_shape, k_shape, causal, device, want):
    assert _route(q_shape, k_shape, causal, device) == want


def test_route_raises_where_no_kernel_takes_the_call():
    with pytest.raises(NotImplementedError):
        _route((1, 77, 1, 512), (1, 77, 1, 512), True, "cuda")
    with pytest.raises(NotImplementedError):
        _route((1, 77, 1, 64), (1, 77, 1, 64), False, "mps")
