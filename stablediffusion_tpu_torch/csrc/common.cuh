// Shared helpers of the attention kernels: 8-element fp32 vector loads and
// the fp32 tile staging of the scalar kernels, cp.async, bf16 packing and
// exp2.  The Hopper pieces of the bf16 kernels are in hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sdt {

// Masked logits use -1e30, not -inf, so that no row yields NaN
// (stablediffusion_tpu/ops/flash_attention.py:64).
constexpr float kNegInf = -1e30f;

// Load 8 consecutive fp32 elements at p (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// Stage `rows` rows of `d` elements (row stride `ld_g` elements in global
// memory) into fp32 shared memory with row stride `ld_s`, times `mul`.
// Rows at or past `valid` are zero-filled: this is the ragged-end mask that
// replaces the TPU wrapper's zero padding.
__device__ __forceinline__ void stage_rows(float* dst, int ld_s, const float* src,
                                           long long ld_g, int rows, int valid,
                                           int d, float mul) {
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int d8 = (c - r * chunks) * 8;
    float tmp[8];
    if (r < valid) {
      load8(src + r * ld_g + d8, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * ld_s + d8 + i] = tmp[i] * mul;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy that bypasses L1; with `valid` false nothing
// is read and the 16 bytes are zero-filled (source size 0).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4-byte global -> shared copy (for fp32 row statistics, whose rows need
// not be 16-byte aligned); zero-filled when `valid` is false
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

using bf16 = __nv_bfloat16;

// two fp32 rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sdt
