"""The yardstick's FLOP and byte arithmetic against FlopCounterMode."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import flops
from perfbench.reference import models

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def counted(fn) -> float:
    with FlopCounterMode(display=False) as c:
        fn()
    return float(c.get_total_flops())


@pytest.mark.parametrize("B,Sq,Skv,H,D", [(2, 16, 16, 2, 8), (1, 7, 12, 3, 16), (3, 5, 5, 1, 40)])
def test_attention_formula_matches_counter(B, Sq, Skv, H, D):
    q, k, v = torch.randn(B, Sq, H, D), torch.randn(B, Skv, H, D), torch.randn(B, Skv, H, D)
    call = flops.AttnCall(B, Sq, Skv, H, D, False, torch.float32)
    assert call.flops == counted(lambda: models.attention(q, k, v))


@pytest.mark.parametrize("S", [2, 5, 77])
def test_causal_counts_the_pairs_it_needs(S):
    call = flops.AttnCall(2, S, S, 3, 8, True, torch.float32)
    assert call.pairs == S * (S + 1) // 2
    q = torch.randn(2, S, 3, 8)
    # the plain attention computes every pair; a causal call needs half
    whole = counted(lambda: models.attention(q, q, q, causal=True))
    assert call.flops == pytest.approx(whole * call.pairs / (S * S))


def test_backward_and_bytes():
    fwd = flops.AttnCall(2, 64, 77, 8, 40, False, torch.bfloat16)
    bwd = flops.AttnCall(2, 64, 77, 8, 40, False, torch.bfloat16, backward=True)
    assert bwd.flops == 2 * fwd.flops
    q, kv = 2 * 64 * 8 * 40, 2 * 77 * 8 * 40
    assert fwd.bytes == 2 * (q + 2 * kv + q)
    assert bwd.bytes == 2 * (3 * q + 4 * kv + q)
    f32 = flops.AttnCall(2, 64, 77, 8, 40, False, torch.float32)
    assert f32.bytes == 2 * fwd.bytes


def test_bound_is_the_larger_floor():
    name = "NVIDIA H100 80GB HBM3"
    big = flops.AttnCall(8, 4096, 4096, 8, 40, False, torch.bfloat16)
    assert big.bound_s(name) == pytest.approx(big.flops / 989.4e12)
    thin = flops.AttnCall(8, 4096, 77, 8, 40, False, torch.bfloat16)
    assert thin.bound_s(name) == pytest.approx(thin.bytes / 3.35e12)
    f32 = flops.AttnCall(8, 4096, 4096, 8, 40, False, torch.float32)
    assert f32.bound_s(name) == pytest.approx(f32.flops / 494.7e12)
    with pytest.raises(KeyError):
        flops.peak("cpu")


def test_convolution_and_linear_counts():
    x, w = torch.randn(2, 8, 16, 16), torch.randn(12, 8, 3, 3)
    assert counted(lambda: F.conv2d(x, w, padding=1)) == 2 * 2 * 12 * 16 * 16 * 8 * 9
    a, b = torch.randn(5, 7), torch.randn(11, 7)
    assert counted(lambda: F.linear(a, b)) == 2 * 5 * 7 * 11


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_request_work_is_linear_in_the_batch(name):
    spec = json.load(open(CONFIGS / f"{name}.tiny.json"))
    served = {k: torch.float32 for k in spec["served_dtypes"]}
    one = flops.txt2img_work(spec, served, 1, 64, 3)
    three = flops.txt2img_work(spec, served, 3, 64, 3)
    assert three.flops == pytest.approx(3 * one.flops)
    assert len(three.attention) == len(one.attention)
    # per UNet step: a self and a cross attention per transformer block
    unet = spec["components"]["unet"]
    depth = unet.get("transformer_layers_per_block", 1)
    n = len(unet["block_out_channels"])
    depth = depth if isinstance(depth, list) else [depth] * n
    L = unet["layers_per_block"]
    blocks = sum(depth[i] * L for i, k in enumerate(unet["down_block_types"]) if k.startswith("CrossAttn"))
    blocks += depth[-1]
    blocks += sum(depth[n - 1 - i] * (L + 1) for i, k in enumerate(unet["up_block_types"])
                  if k.startswith("CrossAttn"))
    towers = sum(spec["components"][c]["num_hidden_layers"] for c in ("text_encoder", "text_encoder_2")
                 if c in spec["components"])
    assert len(one.attention) == 3 * 2 * blocks + 2 * towers + 1


def test_sd15_request_matches_the_published_count():
    """34.67 TFLOP a 512px SD1.5 request at 20 steps under CFG: the count the
    repository's FlopCounterMode-based accounting gave (PERF.md)."""
    spec = json.load(open(CONFIGS / "sd15.json"))
    served = {"unet": torch.bfloat16, "vae": torch.bfloat16, "text_encoder": torch.float32}
    work = flops.txt2img_work(spec, served, 1, 512, 20)
    assert work.flops / 1e12 == pytest.approx(34.6718, rel=1e-4)
