// Shared helpers of the attention kernels: 8-element fp32 vector loads and
// the fp32 tile staging of the scalar kernels, cp.async, and
// the bf16 tensor-core pieces (ldmatrix, mma.sync m16n8k16, bf16 packing,
// exp2, tile staging) that the bf16 flash_fwd and flash_bwd kernels share.
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

// ---------------------------------------------------------------------------
// bf16 tensor cores: mma.sync.m16n8k16, bf16 in, fp32 accumulation.  With
// g = lane / 4 and t = lane % 4, a thread holds A (16x16) elements
// (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); B (16x8) elements
// (k 2t..2t+1, n g), (k 2t+8.., n g); C (16x8) elements (g, 2t..2t+1),
// (g+8, 2t..2t+1).  So the C fragments of two adjacent n8 tiles, rounded to
// bf16 and packed in pairs, are the A fragment of one k16 step.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned& r0, unsigned& r1,
                                                  unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the A fragment of one k16 step from the fp32 C fragments of the two n8
// tiles that cover its 16 columns, each rounded to bf16
__device__ __forceinline__ void c_to_a(const float (&lo)[4], const float (&hi)[4],
                                       unsigned (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy `rows` rows of a tile (row stride `ld_g` elements) into shared rows of
// DP + 8 elements, in 16-byte chunks by `kThreads` threads; rows at or past
// `valid` and columns at or past D are zero-filled.  The row stride of
// DP / 8 + 1 16-byte units is odd, so the 8 row addresses of each ldmatrix
// hit 8 distinct bank groups.
template <int DP, int kThreads>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long ld_g,
                                           int rows, int valid, int D) {
  constexpr int kChunks = DP / 8;
  constexpr int ld = DP + 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = r < valid && col < D;
    cp_async16(smem_u32(dst + r * ld + col), ok ? src + r * ld_g + col : src, ok);
  }
}

// The A fragment of rows r0..r0+15, k16 step kk, of a shared tile [rows][LD]
template <int LD>
__device__ __forceinline__ void load_a(const bf16* tile, int r0, int kk, unsigned (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = kk * 16 + (lane >> 4) * 8;
  ldmatrix_x4(smem_u32(tile + r * LD + c), a[0], a[1], a[2], a[3]);
}

// B fragments (b[0], b[1] of n8 tile n0/8, b[2], b[3] of the next) of the
// k16 step kk when B = T^T, T a shared tile [n][LD] (a product with T's rows)
template <int LD>
__device__ __forceinline__ void load_b_rows(const bf16* tile, int n0, int kk, unsigned (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = kk * 16 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(smem_u32(tile + r * LD + c), b[0], b[1], b[2], b[3]);
}

// The same when B = T, T a shared tile [k][LD]: rows k0..k0+15, columns
// n0..n0+15 (ldmatrix.trans)
template <int LD>
__device__ __forceinline__ void load_b_cols(const bf16* tile, int k0, int n0, unsigned (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(smem_u32(tile + r * LD + c), b[0], b[1], b[2], b[3]);
}

}  // namespace sdt
