"""The trace reduction: the busy union, idle gaps, groups, and the frozen
kernel grouping."""

import pytest

from perfbench.harness.trace import DeviceTrace, kernel_group


def test_busy_is_the_union_of_intervals():
    t = DeviceTrace(10.0, [("a", 0.0, 1.0), ("b", 2.0, 3.0), ("c", 2.5, 6.0), ("d", 8.0, 9.0),
                           ("e", 9.5, 11.0)])
    assert t.busy_s() == pytest.approx(1 + 4 + 1 + 0.5)
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([2.0, 1.0, 0.5])
    assert gaps[0][0] == "after c, before d"


def test_groups_and_matching():
    t = DeviceTrace(1.0, [("void (anonymous namespace)::flash_fwd_wgmma_kernel<64, 64>", 0, 0.1),
                          ("sm90_xmma_fprop_implicit_gemm_bf16", 0.1, 0.3),
                          ("nvjet_tst_128x160", 0.3, 0.4), ("RowwiseMomentsCUDAKernel", 0.4, 0.5),
                          ("flash_bwd_dq_wgmma_kernel<48>", 0.5, 0.6), ("elementwise", 0.6, 0.7)])
    assert t.group_s() == pytest.approx({"flash_fwd": 0.1, "convolution": 0.2, "gemm": 0.1,
                                         "normalization": 0.1, "flash_bwd_dq": 0.1,
                                         "elementwise and other": 0.1})
    assert len(t.matching(("flash_fwd", "flash_bwd", "flash_stream"))) == 2


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_stream_tf32_kernel<2, 1>", "flash_stream"),
    ("flash_bwd_dkv_tf32_kernel<2>", "flash_bwd_dkv"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel", "convolution"),
    ("sm90_xmma_dgrad_implicit_gemm", "convolution"),
    ("cutlass_80_tensorop_bf16_s16816gemm", "gemm"),
    ("vectorized_layer_norm_kernel", "normalization"),
    ("GeluCUDAKernelImpl", "elementwise and other"),
])
def test_frozen_grouping(name, group):
    assert kernel_group(name) == group
