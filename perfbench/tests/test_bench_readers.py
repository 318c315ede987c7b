"""The per-layer readers on a synthetic traced run."""

import pytest
import torch

from perfbench.harness import flops, readers
from perfbench.harness.trace import DeviceTrace


class Run:
    def __init__(self, trace, calls, work):
        self.trace, self.traced_calls, self._work = trace, calls, work
        self.device_name, self.memory_peak_bytes = "NVIDIA H100 80GB HBM3", 3 * 2**30

    def work(self, rows):
        return self._work(rows)


def work(rows):
    a = [flops.AttnCall(2 * rows, 4096, 4096, 10, 64, False, torch.bfloat16),
         flops.AttnCall(rows, 77, 77, 20, 64, True, torch.float32, backward=True)]
    return flops.RequestWork(1e12 * rows, a)


def trace(n_attn):
    attn = [("flash_fwd_wgmma_kernel", 0.0, 0.1), ("flash_bwd_dq", 0.4, 0.5), ("flash_bwd_dkv", 0.5, 0.6)]
    other = [("sm90_xmma_fprop_implicit_gemm", 0.1, 0.4), ("elementwise", 0.8, 1.0)]
    return DeviceTrace(1.0, attn[:n_attn] + other)


def test_readers():
    r = Run(trace(3), [{"rows": 4, "images": 3}], work)
    assert readers.idle_share(r) == pytest.approx(100 * (1 - 0.8 / 1.0))
    assert readers.conv_ms_per_image(r) == pytest.approx(300.0 / 3)
    assert readers.mfu(r) == pytest.approx(100 * 3e12 / 1.0 / 989.4e12)
    bound = flops.attention_bound_s(work(4).attention, r.device_name)
    assert readers.attn_roofline(r) == pytest.approx(100 * bound / 0.3)
    assert readers.peak_mem_gib(r) == pytest.approx(3.0)


def test_roofline_refuses_other_work():
    with pytest.raises(RuntimeError, match="attn_roofline"):
        readers.attn_roofline(Run(trace(2), [{"rows": 4, "images": 4}], work))


def test_nothing_to_read():
    r = Run(None, [], work)
    assert readers.idle_share(r) is None and readers.mfu(r) is None and readers.attn_roofline(r) is None
