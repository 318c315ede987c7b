// Hopper (sm_90a) pieces of the attention kernels, shared by flash_fwd.cu,
// flash_bwd.cu and flash_stream.cu: mbarriers, TMA tensor copies and the
// maps they read, wgmma with its shared-memory descriptors and fences,
// setmaxnreg, named and cluster barriers, and the 3xTF32 pieces of the fp32
// kernels (the TF32 split, TF32 wgmma, ldmatrix, distributed shared memory,
// and the products and two-level sum that flash_fwd's and flash_stream's
// fp32 kernels both run).
// Tiles live in shared memory as 128-byte atoms, [rows][64 bf16 or 32 fp32
// columns] each, written by TMA with the 128-byte swizzle.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace sdt {

constexpr int kAtomCols = 64;     // bf16 columns of one 128-byte swizzle row
constexpr int kF32AtomCols = 32;  // fp32 columns of one 128-byte swizzle row
constexpr int kAtomBytes = 128;
// a barrier wait that lasts this many SM clocks (seconds) traps instead of
// hanging the card: every wait of these kernels is for a copy or a product
// of the same block
constexpr long long kWaitLimitClocks = 1LL << 33;

// D rounded up to whole swizzle atoms: 24/40/64 -> 64, 80/104/128 -> 128,
// 160 -> 192
__host__ __device__ constexpr int atom_width(int d) {
  return (d + kAtomCols - 1) / kAtomCols * kAtomCols;
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// arrive once every cp.async this thread issued before has landed; the
// arrival is one of the barrier's expected count (noinc)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitLimitClocks) __trap();
}

// The same wait without the time limit, for the consumers of a producer that
// waits with it (a producer that waits on them until their last release
// traps for both).  A __trap() in code after setmaxnreg.inc makes ptxas
// allocate that code within the launch's register count, 168 a thread at
// 384 threads, whatever setmaxnreg grants; without one it takes what
// setmaxnreg grants.
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// --- TMA ----------------------------------------------------------------------

// one box of a 4-D (D, H, S, B) tensor map into shared memory; completion
// (its bytes) is reported to `bar`.  Elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(h), "r"(s), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the `rows` rows from `s` of one (batch, head), every 64-column atom of a
// tile of NC atoms, into consecutive atoms at `dst`
template <int NC>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int rows, int h, int s, int b) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(dst + c * rows * kAtomBytes, map, bar, c * kAtomCols, h, s, b);
}

// --- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile stored with the 128-byte swizzle
// (layout type 1, bits 62-63).  Start address, leading and stride byte
// offsets in 16-byte units.  sbo: the step between groups of 8 rows (1024
// bytes here).  lbo: unused by the K-major layouts; for an MN-major operand
// it is the step to the next 64-column atom, which a 64-wide product never
// takes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d = a b (accumulate == 0) or d += a b, m64n32k16: A and B from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same, m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same, m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a b, m64n64k16: A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d = a b^T over the head dims for one warpgroup's 64 rows of A and the N
// rows of B, both tiles K-major in atoms (A's atoms A_ROWS rows apart, B's
// N): D16 / 16 k16 steps (D16 = D rounded up to 16; columns D.. of the last
// step are the zeros TMA filled in).  A k16 step is 32 bytes along a
// swizzled row, so the descriptors advance by 32 bytes within an atom and by
// a whole atom from one 64-column atom to the next.
template <int D16, int N, int A_ROWS>
__device__ __forceinline__ void kmajor_product(float (&d)[N / 2], uint32_t a_tile,
                                               uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D16 / 16; ++kk) {
    const uint32_t atom = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = smem_desc(a_tile + atom * A_ROWS * kAtomBytes + off, 16, 1024);
    const uint64_t db = smem_desc(b_tile + atom * N * kAtomBytes + off, 16, 1024);
    if constexpr (N == 128)
      wgmma_ss_n128(d, da, db, kk > 0);
    else if constexpr (N == 64)
      wgmma_ss_n64(d, da, db, kk > 0);
    else
      wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// d[c] += a b for each 64-column atom c of B, B a tile of K rows stored
// MN-major in atoms K rows apart: K / 16 k16 steps of 16 rows = 2048 bytes,
// with a[kk] the A fragment of step kk
template <int NC, int K>
__device__ __forceinline__ void mnmajor_product(float (&d)[NC][32],
                                                const uint32_t (&a)[K / 16][4],
                                                uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs_n64(d[c], a[kk],
                   smem_desc(b_tile + c * K * kAtomBytes + kk * 16 * kAtomBytes, 1024, 1024));
}

// In wgmma's accumulator layout warp w4 of a warpgroup holds rows 16 w4 + g
// and 16 w4 + g + 8 (g = lane / 4), and for each n8 tile j the columns
// 8 j + 2 t, +1 (t = lane % 4): registers 4 j + e, row + 8 (e >> 1), column
// + (e & 1), as mma.sync's C fragment.  So the accumulator of two n8 tiles,
// rounded to bf16, is the A fragment of one k16 step: the A fragments of a
// product over the N columns of an m64nN accumulator.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Store the accumulators of d (m64n64 per atom) rounded to bf16: the rows
// of this thread at `row0` + g (+8) with row stride `ss`, columns < D, rows
// < `rows`
template <int NC>
__device__ __forceinline__ void store_acc_bf16(bf16* out, long long ss, int row0, int rows,
                                               int D, const float (&d)[NC][32]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < rows) {
      bf16* orow = out + static_cast<long long>(row) * ss;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int col = c * kAtomCols + jn * 8 + t * 2;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(d[c][4 * jn + 2 * r], d[c][4 * jn + 2 * r + 1]);
        }
    }
  }
}

// --- 3xTF32 -----------------------------------------------------------------

// The 3xTF32 split: x = hi + lo to about 2^-22 of |x|, with hi = tf32(x)
// and lo = tf32(x - hi) (the difference is exact in fp32), each rounded to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds.  hi*hi + hi*lo
// + lo*hi then carries a product to about fp32's accuracy; lo*lo, under
// 2^-22 of it, is dropped.  The rounding is an integer add of half a TF32
// ulp (0x1000): hi is then masked to its 19 bits, for the exact x - hi;
// lo is left unmasked, since TF32 wgmma reads only the top 19 bits of a
// register.  Two instructions for hi and one for lo, where ptxas spends four
// on cvt.rna.tf32.f32 (its inf/NaN test); the same bits for finite x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d = a b (accumulate == 0) or d += a b, m64n64k8 in TF32: A (4 registers
// of the split, mma.sync's m16n8k8 A layout per warp) from registers, B
// from shared memory K-major.  TF32 wgmma has no transposed operand.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Four 8x4 fp32 matrices (8 rows of 16 bytes, one row address a lane:
// lanes 8i..8i+7 give matrix i's rows); lane l receives word l % 4 of row
// l / 4 of each: mma.sync's m16n8k8 TF32 A fragment when the matrices are
// rows 0-7 / 8-15 x columns 0-3, then the same x columns 4-7.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma's operand reads, TMA's writes) after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over `count` threads (whole warps)
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive at named barrier `id` over `count` threads without waiting: this
// thread's earlier shared-memory accesses are performed for the threads that
// wait at it (named_bar_sync)
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- the 3xTF32 attention kernels' products (flash_fwd.cu, flash_stream.cu) --
//
// Both run s = q k^T and o^T += v^T p^T per consumer warpgroup over tiles of
// 64 query rows and 64 keys, with fp32 tiles in 32-column atoms [64 rows][32]
// (8 KiB) written by TMA with the 128-byte swizzle.  A ring stage holds a K
// atom (hi in place, its lo 8 KiB above) or a V chunk [64 keys][64 head
// dims] (two atoms).  In wgmma's accumulator layout warp w4 of a warpgroup
// holds M rows 16 w4 + g and 16 w4 + g + 8 (g = lane / 4) and, for each n8
// tile j, the N columns 8 j + 2 t4, +1 (t4 = lane % 4): registers 4 j + e at
// M row + 8 (e >> 1), N column + (e & 1).

constexpr int kTfRows = 64;                      // query rows a tile (wgmma M of s)
constexpr int kTfKeys = 64;                      // keys a tile
constexpr int kTfAtomBytes = kTfRows * kAtomBytes;  // [64 rows][32 fp32]
constexpr int kTfStageBytes = 2 * kTfAtomBytes;  // a K atom (hi, lo) or a V chunk
// registers a thread of the 3xTF32 kernels (384 threads, launched at 168)
// after setmaxnreg: the producer warpgroup gives its share back and the two
// consumer warpgroups take it, 128 * 24 + 256 * 240 = 384 * 168
constexpr int kTfProducerRegs = 24;
constexpr int kTfConsumerRegs = 240;
constexpr float kTfLog2e = 1.4426950408889634f;
constexpr float kTfMaskLog2 = kNegInf * kTfLog2e;  // the -1e30 mask, log2 domain

// Split the K atom at `atom` (generic pointer) for the products: hi in place,
// lo 8 KiB above; one warpgroup's 128 threads (`tid` its thread).  The caller
// fences for the async proxy and syncs the warpgroup before wgmma reads it.
__device__ __forceinline__ void split_atom_tf32(unsigned char* atom, int tid) {
  float4* hi = reinterpret_cast<float4*>(atom);
  float4* lo = hi + kTfAtomBytes / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = hi[tid + 128 * i];
    uint32_t h4[4], l4[4];
    split_tf32(x.x, h4[0], l4[0]);
    split_tf32(x.y, h4[1], l4[1]);
    split_tf32(x.z, h4[2], l4[2]);
    split_tf32(x.w, h4[3], l4[3]);
    hi[tid + 128 * i] = make_float4(__uint_as_float(h4[0]), __uint_as_float(h4[1]),
                                    __uint_as_float(h4[2]), __uint_as_float(h4[3]));
    lo[tid + 128 * i] = make_float4(__uint_as_float(l4[0]), __uint_as_float(l4[1]),
                                    __uint_as_float(l4[2]), __uint_as_float(l4[3]));
  }
}

// This lane's ldmatrix row of a Q atom at `q_tile`: matrix lm = lane / 8
// (rows + 8 (lm & 1), columns + 4 (lm >> 1)) of its warp's 16 rows.
__device__ __forceinline__ uint32_t q_ldmatrix_row(uint32_t q_tile) {
  const int lane = threadIdx.x & 31;
  const int w4 = (threadIdx.x >> 5) & 3;
  return q_tile + (16 * w4 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kAtomBytes;
}

// One k-step (8 head dims) of s += q k^T (s = q k^T when `accumulate` is 0)
// in 3xTF32 over 64 keys: A = q's k-step kk from the Q atom whose ldmatrix
// row (q_ldmatrix_row) is at `q_row`, split in registers into (ah, al); B
// = the split K atom at `k_atom`.  The three products are committed as one
// group; returns once the group before it is done, so the caller builds the
// next k-step's A in the other buffer while this one runs.
__device__ __forceinline__ void qk_kstep(float (&s)[32], uint32_t (&ah)[4], uint32_t (&al)[4],
                                         uint32_t q_row, uint32_t k_atom, int kk,
                                         int accumulate) {
  const int lane = threadIdx.x & 31;
  reg_fence(ah);
  reg_fence(al);
  uint32_t q4[4];
  ldmatrix_x4(q4, q_row + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(q4[e]), ah[e], al[e]);
  wgmma_fence();
  const uint64_t dh = smem_desc(k_atom + kk * 32, 16, 1024);
  const uint64_t dl = smem_desc(k_atom + kTfAtomBytes + kk * 32, 16, 1024);
  wgmma_tf32_n64(s, ah, dh, accumulate);
  wgmma_tf32_n64(s, ah, dl, 1);
  wgmma_tf32_n64(s, al, dh, 1);
  wgmma_commit();
  wgmma_wait<1>();
}

// p of keys 8 j + 2 t4 and + 1 (n8 tile j < 8 of a 64-key accumulator) of
// query row `row`, split, into the K-major p tiles (hi at `p_hi`, generic;
// lo `lo_off` bytes above; two atoms [64 rows][32 keys] each) with the key
// permutation of vt_p_product's A: key 8 j' + 2 t4 of an atom lies at its
// column 8 j' + t4, key + 1 at column + 4.  With it the V loads of the
// product hit 32 banks.
__device__ __forceinline__ void store_p_pair(unsigned char* p_hi, int lo_off, int row, int j,
                                             float p0, float p1) {
  const int t4 = threadIdx.x & 3;
  const int base = (j >> 2) * kTfAtomBytes + row * kAtomBytes + 4 * t4;
  const float pe[2] = {p0, p1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int off = base + (((2 * (j & 3) + e) ^ (row & 7)) << 4);
    uint32_t ph, pl;
    split_tf32(pe[e], ph, pl);
    *reinterpret_cast<uint32_t*>(p_hi + off) = ph;
    *reinterpret_cast<uint32_t*>(p_hi + lo_off + off) = pl;
  }
}

// The pair store_p_pair(p_hi, lo_off, row, j, ...) wrote, read back as
// hi + lo (lo masked to its TF32 bits): p to about 2^-22 of itself.
__device__ __forceinline__ void load_p_pair(const unsigned char* p_hi, int lo_off, int row, int j,
                                            float& p0, float& p1) {
  const int t4 = threadIdx.x & 3;
  const int base = (j >> 2) * kTfAtomBytes + row * kAtomBytes + 4 * t4;
  float pe[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int off = base + (((2 * (j & 3) + e) ^ (row & 7)) << 4);
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(p_hi + lo_off + off) & 0xffffe000u;
    pe[e] = *reinterpret_cast<const float*>(p_hi + off) + __uint_as_float(lo);
  }
  p0 = pe[0];
  p1 = pe[1];
}

// part = v^T p^T over k-steps kk0 .. kk0 + NK - 1 (8 keys each) of a 64-key
// tile for one m-tile (64 head dims) of o^T: TF32 wgmma takes no transposed
// operand and V arrives MN-major, so A = v^T from registers: head dims
// 16 w4 + g (+8) of the m-tile, keys 8 kk + 2 t4 (column t4) and + 1
// (column t4 + 4) of k-step kk, 32-bit loads from the V chunk at `chunk`
// (two [64 keys][32] atoms) split in registers into (ah, al), a k-step built
// while the previous one runs; B = p^T, the p tiles (store_p_pair) at `p_hi`
// and `p_hi` + `lo_off` (shared addresses).  The first product overwrites
// part.  The tensor core truncates each add to its fp32 accumulator, a bias
// toward zero that grows with the adds: with kSmallFirst the small products
// (v_hi p_lo, v_lo p_hi) of every k-step go first and v_hi p_hi after (A
// built twice), so the large ones meet NK truncations instead of 3 NK.
// Returns with the last k-step in flight and the chunk read.
template <int NK, bool kSmallFirst>
__device__ __forceinline__ void vt_p_product(float (&part)[32], uint32_t (&ah)[2][4],
                                             uint32_t (&al)[2][4], const float* chunk,
                                             uint32_t p_hi, int lo_off, int kk0) {
  const int lane = threadIdx.x & 31;
  const int w4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const float* va = chunk + (w4 >> 1) * (kTfAtomBytes / 4);
  const int col = 16 * (w4 & 1) + g;
  // where the four elements of k-step 0 lie in the atom (key 2 t4 + k, head
  // dim col + 8 c, under the swizzle's XOR with key & 7); k-step kk lies
  // 8 kk keys = 256 kk floats further, which the swizzle leaves alone.  Four
  // offsets a thread, not one for each element, which at three m-tiles of
  // o^T left too few registers.
  int off[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = 2 * t4 + k, cc = col + 8 * c;
      off[k][c] = key * kF32AtomCols + ((((cc >> 2) ^ key) << 2) | (cc & 3));
    }
  // k-step kk's A into buffer b2, fenced for wgmma
  auto build = [&](int kk, int b2) {
    reg_fence(ah[b2]);
    reg_fence(al[b2]);
    const float* vk = va + kk * 8 * kF32AtomCols;
    split_tf32(vk[off[0][0]], ah[b2][0], al[b2][0]);
    split_tf32(vk[off[0][1]], ah[b2][1], al[b2][1]);
    split_tf32(vk[off[1][0]], ah[b2][2], al[b2][2]);
    split_tf32(vk[off[1][1]], ah[b2][3], al[b2][3]);
    wgmma_fence();
  };
  auto p_desc = [&](int kk, int lo) {
    return smem_desc(p_hi + (kk >> 2) * kTfAtomBytes + (kk & 3) * 32 + lo * lo_off, 16, 1024);
  };
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int kk = kk0 + i, b2 = i & 1;
    build(kk, b2);
    if constexpr (kSmallFirst) {
      wgmma_tf32_n64(part, ah[b2], p_desc(kk, 1), i > 0);
      wgmma_tf32_n64(part, al[b2], p_desc(kk, 0), 1);
    } else {
      wgmma_tf32_n64(part, ah[b2], p_desc(kk, 0), i > 0);
      wgmma_tf32_n64(part, ah[b2], p_desc(kk, 1), 1);
      wgmma_tf32_n64(part, al[b2], p_desc(kk, 0), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-step's products are done
  }
  if constexpr (kSmallFirst) {
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int kk = kk0 + i, b2 = (NK + i) & 1;
      build(kk, b2);
      wgmma_tf32_n64(part, ah[b2], p_desc(kk, 0), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
}

// o = o * alpha + part over an m64n64 accumulator of o^T, whose N column
// 8 jn + 2 t4 + (e & 1) is a query row with its rescale factor in alpha
// (shared memory): the two-level sum.  The tensor core adds into its fp32
// accumulator with truncation, an error that grows with the number of
// products added, so each key tile's products get an accumulator of their
// own (part) and the FPU adds it into o, rounding to nearest.
__device__ __forceinline__ void add_scaled(float (&o)[32], const float (&part)[32],
                                           const float* alpha) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const float2 a = *reinterpret_cast<const float2*>(alpha + 8 * jn + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[4 * jn + e] = fmaf(o[4 * jn + e], (e & 1) ? a.y : a.x, part[4 * jn + e]);
  }
}

// --- clusters -----------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; release before, acquire after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address in block `rank`'s shared memory of what lies at `addr` in this
// block's
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// 16 bytes, or 4, into block `rank`'s shared memory at `addr` (of this block)
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, uint32_t rank, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   cluster_addr(addr, rank)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, uint32_t rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(cluster_addr(addr, rank)), "f"(v)
               : "memory");
}

// --- tensor maps (host) -----------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda); null where it is missing
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (D, H, S, B) of a [B, S, H, D] tensor of `type` (elements of
// `elem_bytes`) with its own element strides, read in boxes of `atom_cols`
// columns (128 bytes) x `rows` rows of one (batch, head), 128-byte
// swizzled.  Elements past S and past D read as zero.  A dimension of size 1
// takes the dense stride (its own is never stepped).
inline bool encode_map_typed(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                             int atom_cols, const void* ptr, int D, int H, int S, int B,
                             long long sh, long long ss, long long sb, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  long long st[3] = {sh, ss, sb};
  long long dense = D;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = dense;
    dense = st[i] * static_cast<long long>(dims[i + 1]);
  }
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(st[i]) * elem_bytes;
  cuuint32_t box[4] = {static_cast<cuuint32_t>(atom_cols), 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16 map: 64-column atoms
inline bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
                       long long sh, long long ss, long long sb, int rows) {
  return encode_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), kAtomCols, ptr,
                          D, H, S, B, sh, ss, sb, rows);
}

// the fp32 map: 32-column atoms
inline bool encode_map_f32(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
                           long long sh, long long ss, long long sb, int rows) {
  return encode_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), kF32AtomCols,
                          ptr, D, H, S, B, sh, ss, sb, rows);
}

// SMs of the current device (the grid heuristics' wave size)
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

}  // namespace sdt
