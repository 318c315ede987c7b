// Hopper (sm_90a) pieces of the bf16 attention kernels, shared by
// flash_fwd.cu and flash_bwd.cu: mbarriers, TMA tensor copies and the maps
// they read, wgmma with its shared-memory descriptors and fences, and
// setmaxnreg.  Tiles live in shared memory as 64-column (128-byte) atoms,
// [rows][64 columns] each, written by TMA with the 128-byte swizzle.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace sdt {

constexpr int kAtomCols = 64;  // bf16 columns of one 128-byte swizzle row
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

// The 4-D map (D, H, S, B) of a bf16 [B, S, H, D] tensor with its own
// element strides, read in boxes of 64 columns x `rows` rows of one (batch,
// head), 128-byte swizzled.  Elements past S and past D read as zero.  A
// dimension of size 1 takes the dense stride (its own is never stepped).
inline bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
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
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(st[i]) * sizeof(bf16);
  cuuint32_t box[4] = {kAtomCols, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
