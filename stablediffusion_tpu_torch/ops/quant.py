"""int8 quantization of the denoise tower's large linears and convolutions.

Port of ``stablediffusion_tpu/ops/quant.py``, opt-in and approximate as
there.  Two modes, applied after any LoRA fusion:

  * "w8"   weight-only: int8 weights with a per-output-channel fp32 scale,
           dequantized to the activation's dtype at each call; the product
           runs in that dtype;
  * "w8a8" the activations are quantized at each call too (per token for a
           linear, per tensor for a convolution, whose window sum a
           per-pixel scale cannot leave), the product runs int8 x int8 ->
           int32 (``torch._int_mm``: cuBLASLt's int8 GEMM on the card), and
           the int32 sum is rescaled by (activation scale x weight scale).

"w8a8:N" gives layers with fewer than N output channels "w8" instead.

In the JAX package the mode lives in the param tree's structure
(``"w8_scale"`` against ``"w8a8_scale"``); here it lives in the module: an
:class:`Int8Linear` or :class:`Int8Conv2d` holds ``weight_int8`` in torch's
layout ([out, in] or [O, I, kh, kw]), a ``w8_scale`` or ``w8a8_scale``
buffer of shape [out, 1] or [out, 1, 1, 1], and the bias.
:func:`quantize_params` swaps them in for ``nn.Linear`` and ``nn.Conv2d``
modules, and ``models/layers.lin`` / ``conv`` send them to
:func:`int8_linear` / :func:`int8_conv2d`.

Torch has no int8 convolution (``F.conv2d`` on int8 tensors wraps its sums
in int8, and ``F.unfold`` takes no int8), so a "w8a8" convolution gathers
its kh x kw shifted slices of the zero-padded int8 NHWC input into a patch
matrix and runs ``torch._int_mm`` on it: exact in int32 on both devices.
On the card ``torch._int_mm`` takes more than 16 rows: a product with fewer
(SDXL's ``add_embedding`` at the batch's rows) is zero-padded to 17 rows,
which changes no output row, and counted; any other shape it refuses
raises.  Nothing falls back to a floating-point product.

Numerics as JAX's: scales from the absolute max in fp32, ``torch.round``
(half to even, as ``jnp.round``), codes clipped to +-127, ``_EPS`` 1e-8.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8
# torch._int_mm on the card takes more than 16 rows
_INT_MM_MIN_ROWS = 17
QUANT_MODES = ("w8", "w8a8")
DEFAULT_SKIP_KEYS = ("norm", "time_emb", "label_emb", "conv_in", "conv_out", "pos_embed")


class Int8CallCounter:
    """Plain-integer count of the int8 products, by mode ("w8" or "w8a8"),
    and of those whose rows were padded for the card's int8 GEMM.  The int8
    functions call :meth:`add` once per product, on any device."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def add(self, mode: str, padded: bool = False) -> None:
        self.count += 1
        self.by_mode[mode] += 1
        self.padded += int(padded)

    def reset(self) -> None:
        self.count = 0
        self.by_mode = {m: 0 for m in QUANT_MODES}
        self.padded = 0

    def __repr__(self) -> str:
        return f"Int8CallCounter({self.name!r}, by_mode={self.by_mode}, padded={self.padded})"


INT8_LINEAR_CALLS = Int8CallCounter("int8_linear")
INT8_CONV_CALLS = Int8CallCounter("int8_conv2d")


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, a true division on every device: on the card a tensor
    divided by a Python number is multiplied by its reciprocal, which
    rounds otherwise than JAX's and the CPU's division."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_weight(w: torch.Tensor, contract_dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 codes and fp32 scales of `w`.
    `contract_dims`: the dims the product sums over, (1,) for an [out, in]
    linear, (1, 2, 3) for an OIHW convolution; the scale keeps them as 1."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(contract_dims), keepdim=True)
    scale = torch.clamp(_over_127(amax), min=_EPS)
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_act_per_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last dim) dynamic activation codes and fp32 scales [..., 1]."""
    xf = x.float()
    s = torch.clamp(_over_127(xf.abs().amax(dim=-1, keepdim=True)), min=_EPS)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def quantize_act_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dynamic scale for the whole tensor (convolutions)."""
    xf = x.float()
    s = torch.clamp(_over_127(xf.abs().amax()), min=_EPS)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


class _Int8Module(nn.Module):
    """weight_int8, the mode's scale buffer and the bias of a quantized layer."""

    def __init__(self, weight_int8: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], mode: str):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        self.mode = mode
        self.register_buffer("weight_int8", weight_int8)
        self.register_buffer(f"{mode}_scale", scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @property
    def scale(self) -> torch.Tensor:
        return getattr(self, f"{self.mode}_scale")

    def extra_repr(self) -> str:
        return f"{tuple(self.weight_int8.shape)}, mode={self.mode}"


class Int8Linear(_Int8Module):
    """The int8 form of an ``nn.Linear``: weight_int8 [out, in]."""


class Int8Conv2d(_Int8Module):
    """The int8 form of an ``nn.Conv2d``: weight_int8 [O, I, kh, kw], with
    the convolution's stride and padding."""

    def __init__(self, weight_int8, scale, bias, mode, stride=(1, 1), padding=(0, 0)):
        super().__init__(weight_int8, scale, bias, mode)
        self.stride, self.padding = tuple(stride), tuple(padding)


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """a [M, K] int8 @ b [K, N] int8 -> (int32 [M, N], rows padded).  On the
    card fewer than 17 rows are zero-padded, which changes no output row."""
    M = a.shape[0]
    padded = a.is_cuda and M < _INT_MM_MIN_ROWS
    if padded:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - M))
    return torch._int_mm(a, b)[:M], padded


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], channel_dim: int) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


def int8_linear(m: Int8Linear, x: torch.Tensor) -> torch.Tensor:
    """The quantized counterpart of ``ops/basic.linear``, in x's dtype."""
    wq = m.weight_int8
    padded = False
    if m.mode == "w8":
        y = F.linear(x, wq.to(x.dtype) * m.w8_scale.to(x.dtype))
    else:
        xq, xs = quantize_act_per_token(x)
        acc, padded = _int8_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
        y = (acc.float() * xs.reshape(-1, 1) * m.w8a8_scale.reshape(1, -1)).to(x.dtype)
        y = y.reshape(*x.shape[:-1], wq.shape[0])
    INT8_LINEAR_CALLS.add(m.mode, padded)
    return _add_bias(y, m.bias, -1)


def _patches(xq: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """The patch matrix [B*Ho*Wo, kh*kw*C] of an NCHW int8 tensor, columns
    ordered (i, j, c), and (Ho, Wo)."""
    x = F.pad(xq, (padding,) * 4) if padding else xq
    x = x.permute(0, 2, 3, 1)
    B, H, W, C = x.shape
    Ho, Wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    cols = [x[:, i:i + stride * (Ho - 1) + 1:stride, j:j + stride * (Wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    x = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return x.reshape(B * Ho * Wo, kh * kw * C), Ho, Wo


def int8_conv2d(m: Int8Conv2d, x: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """The quantized counterpart of ``ops/basic.conv2d`` (NCHW), in x's
    dtype."""
    wq = m.weight_int8
    padded = False
    if m.mode == "w8":
        y = F.conv2d(x, wq.to(x.dtype) * m.w8_scale.to(x.dtype), None, stride, padding)
    else:
        O, _, kh, kw = wq.shape
        xq, xs = quantize_act_per_tensor(x)
        cols, Ho, Wo = _patches(xq, kh, kw, stride, padding)
        acc, padded = _int8_mm(cols, wq.permute(0, 2, 3, 1).reshape(O, -1).t())
        y = (acc.float() * xs * m.w8a8_scale.reshape(1, -1)).to(x.dtype)
        y = y.reshape(x.shape[0], Ho, Wo, O).permute(0, 3, 1, 2)
    INT8_CONV_CALLS.add(m.mode, padded)
    return _add_bias(y, m.bias, 1)


def validate_quant_mode(mode) -> None:
    """Raise on an unknown mode ("auto" | "w8" | "w8a8" | "w8a8:N" | None).
    Callers that keep the mode validate it before they change any state."""
    if mode is None or mode == "auto":
        return
    base, _, thr = str(mode).partition(":")
    if base not in QUANT_MODES or (thr and not thr.isdigit()):
        raise ValueError(f"unknown quant mode {mode!r}")


# quantize="auto": the int8 mode with the shortest denoise step at the
# expected serving batch, from the step's device times in chip_smoke.py's
# phase 35 on an NVIDIA H100 80GB HBM3 at a 700 W limit (PERF.md §6, "The
# int8 path"): "w8" was the fastest int8 mode at SD1.5 batch 1 and batch 8
# and at SDXL batch 1.  The w8a8 modes lose there to their plain activation
# quantization and rescale passes, which cost more than cuBLASLt's int8 GEMM
# saves over the bf16 one; every int8 mode's step is longer than bf16's, so
# int8 buys memory on the card, not time.  The rule keeps its shape, a
# threshold between a small- and a large-batch mode, for a faster w8a8.
AUTO_QUANT_SMALL_BATCH = "w8"
AUTO_QUANT_LARGE_BATCH = "w8"
AUTO_QUANT_BATCH_THRESHOLD = 8


def resolve_quant_mode(mode, expected_batch: int = 1):
    """"auto" -> the mode for `expected_batch` (the constants above); any
    other mode unchanged.  Called at the edges (``quantize``, the handler,
    the quantize CLI, the savers), so a stored mode is always concrete."""
    if mode != "auto":
        return mode
    if int(expected_batch) >= AUTO_QUANT_BATCH_THRESHOLD:
        return AUTO_QUANT_LARGE_BATCH
    return AUTO_QUANT_SMALL_BATCH


def quantized_layer(m: nn.Module, mode: str) -> _Int8Module:
    """The int8 form of one ``nn.Linear`` or ``nn.Conv2d`` in `mode`, on
    its device, the bias in its dtype."""
    w = m.weight.detach()
    bias = None if m.bias is None else m.bias.detach().clone()
    if isinstance(m, nn.Conv2d):
        wq, scale = quantize_weight(w, (1, 2, 3))
        return Int8Conv2d(wq, scale, bias, mode, m.stride, m.padding)
    wq, scale = quantize_weight(w, (1,))
    return Int8Linear(wq, scale, bias, mode)


def quantize_plan(module: nn.Module, mode: str = "w8a8", min_size: int = 65536,
                  skip_keys: tuple = DEFAULT_SKIP_KEYS, a8_min_out: int = 0) -> Dict[str, str]:
    """{module path: leaf mode} of the layers :func:`quantize_params` would
    swap: every ``nn.Linear`` / ``nn.Conv2d`` whose path contains none of
    `skip_keys` and whose weight has at least `min_size` elements; under
    "w8a8", one with fewer than `a8_min_out` output channels (or than N
    of "w8a8:N") gets "w8"."""
    if ":" in mode:
        mode, _, thr = mode.partition(":")
        a8_min_out = max(int(a8_min_out), int(thr))
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r}")
    plan = {}
    for path, m in module.named_modules():
        if not isinstance(m, (nn.Linear, nn.Conv2d)):
            continue
        if any(s in path for s in skip_keys) or m.weight.numel() < min_size:
            continue
        plan[path] = "w8" if mode == "w8a8" and m.weight.shape[0] < a8_min_out else mode
    return plan


def swap_modules(module: nn.Module, new: Dict[str, nn.Module]) -> Dict[str, nn.Module]:
    """Put each module of `new` ({path: module}) at its path in `module`;
    returns the modules it replaced."""
    old = {}
    for path, m in new.items():
        parent_path, _, name = path.rpartition(".")
        parent = module.get_submodule(parent_path) if parent_path else module
        old[path] = parent._modules[name]
        parent._modules[name] = m
    return old


def quantize_params(module: nn.Module, mode: str = "w8a8", min_size: int = 65536,
                    skip_keys: tuple = DEFAULT_SKIP_KEYS,
                    a8_min_out: int = 0) -> Dict[str, nn.Module]:
    """Swap the int8 form of every layer of :func:`quantize_plan` into
    `module`, in place; returns {path: the floating-point module it
    replaced}, which ``swap_modules`` puts back.  Apply after LoRA fusion.
    `mode` may carry the threshold inline, "w8a8:N"."""
    plan = quantize_plan(module, mode, min_size, skip_keys, a8_min_out)
    with torch.no_grad():
        new = {path: quantized_layer(module.get_submodule(path), leaf_mode)
               for path, leaf_mode in plan.items()}
    return swap_modules(module, new)


def swap_in_int8_layers(module: nn.Module, state_keys) -> None:
    """Swap an uninitialised int8 layer into `module`, on its weight's
    device, at every path whose state in `state_keys` holds a
    ``<path>.weight_int8`` (the mode from the scale's name): the skeleton
    an int8 tree or checkpoint loads into."""
    keys = set(state_keys)
    new = {}
    for key in sorted(keys):
        if not key.endswith(".weight_int8"):
            continue
        path = key[: -len(".weight_int8")]
        m = module.get_submodule(path)
        if isinstance(m, _Int8Module):
            continue
        mode = "w8a8" if f"{path}.w8a8_scale" in keys else "w8"
        w = m.weight
        wq = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((w.shape[0],) + (1,) * (w.dim() - 1), dtype=torch.float32,
                            device=w.device)
        bias = None if m.bias is None else torch.empty_like(m.bias)
        new[path] = (Int8Conv2d(wq, scale, bias, mode, m.stride, m.padding)
                     if isinstance(m, nn.Conv2d) else Int8Linear(wq, scale, bias, mode))
    swap_modules(module, new)
