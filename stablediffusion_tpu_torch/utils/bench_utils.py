"""FLOPs, MFU and memory accounting for benchmarks on the card.

Port of ``stablediffusion_tpu/utils/bench_utils.py``:

  * :func:`peak_flops_per_sec`: the card's bf16 dense peak from its name
    (the H100 SXM: 989.4e12), or None off the card.
  * :func:`flops`: the FLOPs of one call, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops plus the
    attention kernels' work from their launch records, which the counter
    cannot see (they launch through ctypes): 4·B·H·Sq·Skv·D a forward
    (``flash_fwd``, ``flash_stream``; a causal call counted whole, as the
    counter counts SDPA's), and the backward pair's work as the kernel
    table's bound counts it (``flash_bwd_dkv`` 8, ``flash_bwd_dq`` 6 per
    (query, key) pair and head dim).  On the CPU the attention is plain
    matrix products, which the counter sees, and no kernel launches.
  * :func:`mfu` / :func:`flops_fields`: FLOPs over seconds over the peak.
  * :func:`hbm_stats`: the card's memory from ``torch.cuda.memory_stats``.
  * :func:`record_result`: merge a payload into the JSON file its caller
    names (never the JAX package's ``benchmarks/RESULTS.json``).
  * :func:`warmup` takes JAX's ``aot_compile``'s place: the port has no
    ahead-of-time compile, so one untimed call (the kernels' build, cuDNN's
    algorithm search, the allocator's growth) before the timed ones.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

# bf16 dense peak FLOPs/s by card name (NVIDIA's H100 datasheet)
_PEAK_BY_NAME = {
    "H100 80GB HBM3": 989.4e12,  # H100 SXM5
    "H100 SXM": 989.4e12,
    "H100 NVL": 835e12,
    "H100 PCIe": 756e12,
}


def peak_flops_per_sec(device: Any = None) -> Optional[float]:
    """The bf16 dense peak of the card (`device`, default the current one),
    or None without a card or for a name not in the table."""
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for k, v in sorted(_PEAK_BY_NAME.items(), key=lambda kv: -len(kv[0])):
        if k in name:
            return v
    return None


def _counters():
    from stablediffusion_tpu_torch.ops import attention, flash_attention

    return {"flash_fwd": attention.FLASH_FWD_LAUNCHES,
            "flash_stream": flash_attention.FLASH_STREAM_LAUNCHES,
            "flash_bwd_dkv": attention.FLASH_BWD_DKV_LAUNCHES,
            "flash_bwd_dq": attention.FLASH_BWD_DQ_LAUNCHES}


# FLOPs per (query, key) pair and head dim of each kernel
_PER_PAIR = {"flash_fwd": 4, "flash_stream": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}


def launch_snapshot() -> Dict[str, Dict[tuple, int]]:
    return {n: dict(c.by_shape) for n, c in _counters().items()}


def attention_flops(since: Optional[Dict[str, Dict[tuple, int]]] = None) -> Dict[str, float]:
    """{kernel: FLOPs} of the launches recorded after `since`
    (:func:`launch_snapshot`; None: all of them)."""
    out = {}
    for name, counter in _counters().items():
        before = (since or {}).get(name, {})
        total = 0.0
        for (qshape, skv, *_), n in counter.by_shape.items():
            n -= before.get((qshape, skv, *_), 0)
            B, Sq, H, D = qshape
            total += n * _PER_PAIR[name] * B * H * Sq * skv * D
        out[name] = total
    return out


def flops(fn: Callable, *args, **kwargs) -> Tuple[Any, float, Dict[str, float]]:
    """Run ``fn(*args, **kwargs)`` once; returns (its result, its FLOPs,
    {"aten": the counter's, kernel: the launches'})."""
    from torch.utils.flop_counter import FlopCounterMode

    snap = launch_snapshot()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    parts = {"aten": float(counter.get_total_flops()), **attention_flops(snap)}
    return out, sum(parts.values()), parts


def mfu(flops_: Optional[float], seconds: float) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None when unknowable."""
    peak = peak_flops_per_sec()
    if not flops_ or not peak or seconds <= 0:
        return None
    return flops_ / seconds / peak


def flops_fields(flops_: Optional[float], seconds: float, per: int = 1) -> Dict[str, Any]:
    """The detail fields of a measured phase: TFLOPs an item, TFLOP/s and
    MFU %, `per` items a call."""
    out: Dict[str, Any] = {}
    if not flops_:
        return out
    out["tflops_per_item"] = flops_ / per / 1e12
    out["tflops_per_sec"] = flops_ / seconds / 1e12
    u = mfu(flops_, seconds)
    if u is not None:
        out["mfu_pct"] = 100.0 * u
    return out


def hbm_stats() -> Dict[str, float]:
    """The card's memory (GiB): the allocator's peak and current bytes and
    the card's total; {} without a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    st = torch.cuda.memory_stats()
    return {"peak_gb": st.get("allocated_bytes.all.peak", 0) / 2**30,
            "in_use_gb": st.get("allocated_bytes.all.current", 0) / 2**30,
            "limit_gb": torch.cuda.get_device_properties(0).total_memory / 2**30}


def warmup(fn: Callable, *args, **kwargs) -> Callable:
    """Call `fn` once, untimed, and wait for the card; returns `fn` for the
    timed calls (JAX's ``aot_compile`` returned the compiled executable)."""
    import torch

    fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return fn


def record_result(name: str, payload: Dict[str, Any], path: str) -> None:
    """Merge `payload` under `name` in the JSON file `path` (a flat {name:
    payload} dict; other names kept), with the card's name added.  Never
    raises: bookkeeping must not end a run after its measurement."""
    try:
        import torch

        data: Dict[str, Any] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
        payload = dict(payload)
        payload["device"] = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                             else "cpu")
        data[name] = payload
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
    except Exception as e:
        import sys

        print(f"record_result({name!r}) failed: {e}", file=sys.stderr)
