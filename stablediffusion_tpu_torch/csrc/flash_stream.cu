// flash_stream: online-softmax attention forward for wide heads, D > 160 and
// a multiple of 8, up to 1024, in fp32 (ops/flash_attention.flash_stream
// widens bf16 to fp32, exactly, and rounds the result back).  On the main
// path it takes the VAE mid-block's single 512-wide head, in fp32 (the
// decode under force_upcast, the trainers' encode).
//
// Replaces: stablediffusion_tpu/ops/flash_attention.py:145-207
// (flash_attention_streaming; kernel body _flash_stream_kernel :67-127).  It
// keeps that kernel's semantics: s = (q.k^T) * scale in fp32, fp32 running
// max, denominator and accumulator, keys past Skv masked to -1e30, no mask
// argument, forward only.  The TPU version pads q and kv to its block grid
// and slices the result back; here TMA's zero fill and one mask of the last
// key tile take the ragged ends.  Its _VMEM_BUDGET and 128-lane scratch are
// TPU artifacts and do not carry over.
//
// fp32, 160 < D <= 512 (every head dim a path runs): 3xTF32 on the tensor
// cores, its products, split and two-level sum shared with flash_fwd.cu's
// fp32 kernel (hopper.cuh's 3xTF32 section).  What bounds it on an H100:
//   * The products: 4 Sq Skv D operations.  On FFMAs (67 TFLOP/s) exact fp32
//     has a floor of 8.2 ms at [1,16384,1,512].  TF32 runs at 495 TFLOP/s
//     but keeps 10 mantissa bits, which the fp32 rule (atol 1e-5) refuses.
//     So every operand is split, x = hi + lo, hi = tf32(x) rounded to
//     nearest as cvt.rna.tf32.f32 rounds (the tensor core would truncate),
//     lo = tf32(x - hi), and each product is hi*hi + hi*lo + lo*hi, summed
//     in fp32: about fp32's accuracy at 495 / 3 = 165 TFLOP/s (3.3 ms at
//     [1,16384,1,512]).
//   * L2 traffic: every query tile reads all of K and V, 16 GiB a call at
//     [1,16384,1,512] with 64-row tiles (the FFMA kernel's 32-row tiles
//     read 32); the copies alone take about 4.6 ms there.  64 rows is the
//     most a block holds: the fp32 accumulator of 64 rows x 512 columns is
//     half the SM's registers.
// The design, one block per 64 query rows of one (batch, head), 384 threads:
// two consumer warpgroups and a producer warpgroup.  Consumer warpgroup w
// owns half of the head dims (w = 0: the first 128 MW columns) in both
// products:
//   * s = q k^T: each warpgroup contracts its half of the head dims over all
//     64 keys of the tile, by wgmma m64n64k8 with A from registers and B from
//     shared memory.  A is q (K-major), read from the resident Q atoms by
//     ldmatrix and split in registers k-step by k-step: Q's hi and lo would
//     not both fit (64 rows x 512 fp32 = 128 KiB each).  B is a K chunk
//     [64 keys][32 head dims], K-major as TMA wrote it, which its warpgroup
//     splits in place (hi) and 8 KiB above (lo), then fences for the async
//     proxy.  The warpgroups then swap the partial sums of each other's 32
//     keys through shared memory (in the p hi tile) and add them, warpgroup
//     0's first, so each holds s for its own 32 keys.
//   * Softmax in registers in wgmma's accumulator layout, the scale and
//     log2(e) in one multiply, exp2; the warpgroups swap their row maxima
//     through shared memory and each keeps the denominator of its own keys.
//     Keys >= Skv are masked in the last tile only, behind one tile-uniform
//     branch.  p is split and written to shared memory as two K-major tiles
//     [64 rows][64 keys] (hi, lo).
//   * o += p v as o^T += v^T p^T: TF32 wgmma takes no transposed operand, and
//     V arrives MN-major ([keys][D]).  So each warpgroup computes the 64-row
//     m-tiles of its head dims (m64n64k8, the query rows as N) from a V chunk
//     [64 keys][64 head dims] each, with A = v^T from registers: each lane
//     reads its 4 elements of a k-step with 32-bit loads and splits them;
//     B = p^T, the p tiles K-major.  Within a k8 step, A's columns t and
//     t + 4 hold keys 2t and 2t + 1, which is where the accumulator layout of
//     s puts them; the p tiles store the same permutation, and with it the V
//     loads hit 32 banks.
//   * Two-level sums.  The tensor core adds into its fp32 accumulator with
//     truncation, and the error grows with the number of products added:
//     o^T accumulated over 16384 keys in the tensor core missed the fp32
//     rule (1.19e-5 at [1,16384,1,512]).  So an m-tile's products over one
//     key tile go to an accumulator of their own, and the FPU adds it into
//     o^T, rounding to nearest, with the rescale: o^T = o^T * alpha + part.
//     The accumulators (s, part) have registers of their own: where two
//     shared registers, ptxas serialized every wgmma of the kernel.  Each is
//     set to zero before its first product, so that neither holds registers
//     through the other's phase.
//   * Pipelining.  A warpgroup issues each k-step's 3 products as one group
//     and builds the next k-step's A while it runs (two A buffers,
//     wgmma.wait_group 1); a K chunk's split runs under the previous
//     chunk's products.
//   * TMA into a ring, fed by a producer warp.  Q's atoms come in once; the
//     K and V chunks of each tile through a ring of 16 KiB stages, each with
//     a full mbarrier (TMA's byte count) and an empty one (its warpgroup's 4
//     warps).  A chunk belongs to one warpgroup, the two warpgroups' chunks
//     alternate and the number of stages is even, so each warpgroup streams
//     through its own stages, and one producer thread feeds each (warps 8
//     and 9): neither warpgroup waits for the other's refills.
//   * Registers.  The launch gives 168 a thread (65536 / 384); the producer
//     warpgroup gives its share back (setmaxnreg 24) and the consumers take
//     240, of which a consumer at D = 512 uses most (the accumulator alone
//     is 128).  ptxas allocates the code after setmaxnreg.inc within the
//     launch's 168 if a __trap() is reachable there, so the consumers wait
//     by mbar_wait_spin, without the time limit; the producer waits with
//     it, up to the consumers' last release, so a copy that never lands
//     still traps.
//   * Small grids.  Where the query tiles give fewer blocks than SMs
//     ([1,4096,1,512]: 64), a cluster of two blocks takes one query tile and
//     splits its key tiles in halves; at the end each block sends the other
//     the half of its accumulator and its row statistics that the other
//     stores, through distributed shared memory, and each merges the two
//     halves by one fixed expression.  No atomics: the result is
//     the same bits on every run.
// Per instantiation <MW, SPLIT>: MW = 64-column m-tiles a warpgroup (2: D <=
// 256, 3: <= 384, 4: <= 512), SPLIT = blocks a cluster.  Shared memory at
// MW = 4: Q 128 KiB, p 32 KiB, a ring of 4 stages (64 KiB).
// Later work (utils/flash_stream_ablation splits the time): TMA multicast of
// each K/V chunk to a two-block cluster over two query tiles (halves the L2
// traffic); softmax under the next tile's products.
//
// D > 512 (no path runs it) keeps the earlier FFMA kernel below: an
// SGEMM-style register tiling of 32 query rows a block with K and V chunks
// through a cp.async double buffer, BK = 64 keys a tile, K chunks of
// KC = 128 head dims, V chunks of VK = 8 keys, an 8 x 4 logit tile.  Grid
// (ceil(Sq / 32), B * H), 256 threads.
//
// The TPU kernel's sequential key-block grid axis is the loop over key tiles
// inside the block.  The largest dynamic shared memory of each kernel is set
// once, at its first launch.

#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 at D > 512: register-tiled FFMA
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 32;        // query rows per block
constexpr int kLdP = kBQ + 4;  // p^T row stride

struct StreamParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Sq, Skv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// 4 elements at `g` into shared memory at `s` (16-byte aligned) by
// cp.async; zeros when `ok` is false
__device__ __forceinline__ void copy4(float* s, const float* g, bool ok) {
  sdt::cp_async16(sdt::smem_u32(s), g, ok);
}

// Where a thread's copies of a [rows][D] tile start and how they step: the
// block copies 4-element pieces in order, 256 a pass, so thread t starts at
// element 4t and moves 1024 elements a pass.  One division, made once.
struct RowWalk {
  int r, c, step_r, step_c;
  __device__ explicit RowWalk(int D) {
    r = 4 * threadIdx.x / D;
    c = 4 * threadIdx.x - r * D;
    step_r = 4 * kThreads / D;
    step_c = 4 * kThreads - step_r * D;
  }
};

// rows x D elements of a tile (global row stride ld_g) into shared rows of
// ld_s floats; rows at or past `valid` are zero-filled.  `safe` is a
// readable address handed to the copies that read nothing.
__device__ __forceinline__ void copy_rows(float* dst, int ld_s, const float* src, long long ld_g,
                                          int rows, int valid, int D, RowWalk w,
                                          const float* safe) {
  while (w.r < rows) {
    const bool ok = w.r < valid;
    copy4(dst + w.r * ld_s + w.c, ok ? src + w.r * ld_g + w.c : safe, ok);
    w.r += w.step_r;
    w.c += w.step_c;
    if (w.c >= D) {
      w.c -= D;
      ++w.r;
    }
  }
}

constexpr int kMaxD = 1024;
constexpr int kBK = 64;                    // keys per tile
constexpr int kKC = 128;                   // head dims per K chunk
constexpr int kVK = 8;                     // keys per V chunk
constexpr int kSK = kBK / 16;              // logit-tile keys per thread
constexpr int kLdK = kKC + 4;              // K chunk row stride: odd float4 count
constexpr int kKF4 = kKC / 4;              // float4s per K chunk row
constexpr int kKRows = kThreads / kKF4;    // K chunk rows one pass copies
constexpr int kLdS = kBK + 16;             // partial-logit row stride
constexpr int kC4 = kMaxD / 256;           // float4 accumulator columns per thread

// floats of shared memory at head dim D
__host__ __device__ constexpr int ffma_ring(int D) {
  return kBK * kLdK > kVK * (D + 4) ? kBK * kLdK : kVK * (D + 4);
}
__host__ __device__ constexpr int ffma_floats(int D) {
  return kBQ * (D + 4) + 2 * ffma_ring(D) + 2 * kBQ * kLdS + kBK * kLdP + 2 * kBQ;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_stream_ffma_kernel(const StreamParams p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldq = D + 4;
  const int ring = ffma_ring(D);
  float* Qs = smem;                      // [kBQ][ldq]
  float* Ring = Qs + kBQ * ldq;          // 2 x (K chunk [kBK][kLdK] | V chunk [kVK][ldq])
  float* Sred = Ring + 2 * ring;         // [2][kBQ][kLdS]
  float* Pt = Sred + 2 * kBQ * kLdS;     // [kBK][kLdP]: p transposed
  float* alpha_s = Pt + kBK * kLdP;      // [kBQ]
  float* l_s = alpha_s + kBQ;            // [kBQ]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kBQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                    static_cast<long long>(q0) * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
              static_cast<long long>(q0) * p.o_ss;

  const int tid = threadIdx.x;
  // s = q k^T: group sg takes a quarter of each K chunk's float4 columns;
  // thread rows srb + 4i, keys skb + 16j
  const int sg = tid >> 6;
  const int srb = (tid >> 4) & 3;
  const int skb = tid & 15;
  // softmax: row xr, keys xc + 8j
  const int xr = tid >> 3;
  const int xc = tid & 7;
  // o += p v: rows 8*orb .. +7, columns 4*ocb + 256*jj .. +3
  const int orb = tid >> 6;
  const int ocb = tid & 63;

  const int nK = (D + kKC - 1) / kKC;  // K chunks per tile
  constexpr int nV = kBK / kVK;        // V chunks per tile
  const int nS = nK + nV;
  const int n_tiles = (p.Skv + kBK - 1) / kBK;
  const int total = n_tiles * nS;

  // this thread's copies of a K chunk: rows krow + kKRows * it, one float4
  // at column kcol; of a Q or V tile: a RowWalk
  const int krow = tid / kKF4;
  const int kcol = (tid % kKF4) * 4;
  const RowWalk walk(D);

  // chunk i of the sequence K chunks 0..nK-1, V chunks 0..nV-1 of key tile
  // 0, then of key tile 1, ...
  auto load_chunk = [&](int i) {
    float* buf = Ring + (i & 1) * ring;
    const int kt = i / nS;
    const int st = i - kt * nS;
    const int k0 = kt * kBK;
    if (st < nK) {
      const int dcol = st * kKC + kcol;
      const float* src = kg + static_cast<long long>(k0 + krow) * p.k_ss + dcol;
      float* dst = buf + krow * kLdK + kcol;
#pragma unroll
      for (int it = 0; it < kBK / kKRows; ++it) {
        const bool ok = dcol < D && k0 + krow + it * kKRows < p.Skv;
        copy4(dst + it * kKRows * kLdK, ok ? src + it * kKRows * p.k_ss : kg, ok);
      }
    } else {
      const int key0 = k0 + (st - nK) * kVK;
      copy_rows(buf, ldq, vg + static_cast<long long>(key0) * p.v_ss, p.v_ss, kVK,
                p.Skv - key0, D, walk, vg);
    }
  };

  copy_rows(Qs, ldq, qg, p.q_ss, kBQ, p.Sq - q0, D, walk, qg);
  load_chunk(0);  // Q rides in the first group
  sdt::cp_async_commit();

  float m = sdt::kNegInf, l = 0.f;  // row xr's running max and denominator
  float acc[8][4 * kC4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kC4; ++c) acc[i][c] = 0.f;
  float s[8][kSK];

  for (int i = 0; i < total; ++i) {
    sdt::cp_async_wait<0>();
    __syncthreads();  // chunk i landed; chunk i-1's buffer is free
    if (i + 1 < total) load_chunk(i + 1);
    sdt::cp_async_commit();

    const float* buf = Ring + (i & 1) * ring;
    const int kt = i / nS;
    const int st = i - kt * nS;
    if (st < nK) {
      if (st == 0) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int j = 0; j < kSK; ++j) s[a][j] = 0.f;
      }
      const int d0 = st * kKC;
#pragma unroll
      for (int cc = 0; cc < kKF4 / 4; ++cc) {
        const int col = (sg * (kKF4 / 4) + cc) * 4;  // within the chunk
        if (d0 + col < D) {
          float4 qv[8], kv[kSK];
#pragma unroll
          for (int a = 0; a < 8; ++a)
            qv[a] = *reinterpret_cast<const float4*>(Qs + (srb + 4 * a) * ldq + d0 + col);
#pragma unroll
          for (int j = 0; j < kSK; ++j)
            kv[j] = *reinterpret_cast<const float4*>(buf + (skb + 16 * j) * kLdK + col);
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int j = 0; j < kSK; ++j) {
              float t = s[a][j];
              t = fmaf(qv[a].x, kv[j].x, t);
              t = fmaf(qv[a].y, kv[j].y, t);
              t = fmaf(qv[a].z, kv[j].z, t);
              t = fmaf(qv[a].w, kv[j].w, t);
              s[a][j] = t;
            }
        }
      }
      continue;
    }

    if (st == nK) {
      // sum the four groups' partial logits: 2+3 -> 0+1, then the softmax
      // reads the two remaining slots
      float* mine = Sred + (sg & 1) * kBQ * kLdS;
      if (sg >= 2) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int j = 0; j < kSK; ++j) mine[(srb + 4 * a) * kLdS + skb + 16 * j] = s[a][j];
      }
      __syncthreads();
      if (sg < 2) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int j = 0; j < kSK; ++j) mine[(srb + 4 * a) * kLdS + skb + 16 * j] += s[a][j];
      }
      __syncthreads();
      const int k0 = kt * kBK;
      float x[kBK / 8];
      float mx = sdt::kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int key = xc + 8 * j;
        const float v = (Sred[xr * kLdS + key] + Sred[(kBQ + xr) * kLdS + key]) * p.scale;
        x[j] = k0 + key < p.Skv ? v : sdt::kNegInf;
        mx = fmaxf(mx, x[j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m, mx);
      const float alpha = __expf(m - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float e = __expf(x[j] - m_new);
        rs += e;
        Pt[(xc + 8 * j) * kLdP + xr] = e;
      }
      rs = group8_sum(rs);
      l = l * alpha + rs;
      m = m_new;
      if (xc == 0) alpha_s[xr] = alpha;
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float al = alpha_s[orb * 8 + a];
#pragma unroll
        for (int c = 0; c < 4 * kC4; ++c) acc[a][c] *= al;
      }
    }

    // o += p v over this chunk's kVK keys
    const int kc0 = (st - nK) * kVK;
#pragma unroll
    for (int kk = 0; kk < kVK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(Pt + (kc0 + kk) * kLdP + orb * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(Pt + (kc0 + kk) * kLdP + orb * 8 + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float4 vv[kC4];
#pragma unroll
      for (int jj = 0; jj < kC4; ++jj)  // columns past D: zeros, never stored
        vv[jj] = ocb * 4 + 256 * jj < D
                     ? *reinterpret_cast<const float4*>(buf + kk * ldq + ocb * 4 + 256 * jj)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int jj = 0; jj < kC4; ++jj) {
          acc[a][4 * jj + 0] = fmaf(pr[a], vv[jj].x, acc[a][4 * jj + 0]);
          acc[a][4 * jj + 1] = fmaf(pr[a], vv[jj].y, acc[a][4 * jj + 1]);
          acc[a][4 * jj + 2] = fmaf(pr[a], vv[jj].z, acc[a][4 * jj + 2]);
          acc[a][4 * jj + 3] = fmaf(pr[a], vv[jj].w, acc[a][4 * jj + 3]);
        }
    }
  }

  sdt::cp_async_wait<0>();
  if (xc == 0) l_s[xr] = l;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = orb * 8 + a;
    if (q0 + r >= p.Sq) continue;
    const float inv = 1.f / l_s[r];
    float* orow = og + static_cast<long long>(r) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < kC4; ++jj) {
      const int d = ocb * 4 + 256 * jj;
      if (d < D)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[a][4 * jj] * inv, acc[a][4 * jj + 1] * inv,
                        acc[a][4 * jj + 2] * inv, acc[a][4 * jj + 3] * inv);
    }
  }
}

cudaError_t launch_ffma(const StreamParams& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_stream_ffma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * ffma_floats(kMaxD)));
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * ffma_floats(p.D);
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_stream_ffma_kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32, 160 < D <= 512: 3xTF32 wgmma fed by TMA (sm_90a)
// ---------------------------------------------------------------------------

using sdt::kTfAtomBytes;  // the 3xTF32 tiles' geometry (hopper.cuh)
using sdt::kTfKeys;
using sdt::kTfRows;
using sdt::kTfStageBytes;
constexpr int kTfConsumerWarps = 8;         // two consumer warpgroups
constexpr int kTfThreads = 128 * 3;          // + the producer warpgroup
constexpr int kTfWgWarps = 4;                // the warps of a warpgroup

// Shared memory of one block, in bytes from a 1024-byte aligned base: Q's
// atoms, p's hi and lo tiles (2 atoms each: [64 rows][64 keys]; the hi tile
// first carries the warpgroups' exchange of s), the ring, the row statistics
// (rmax[2][64], lsum[2][64], alpha[64], and the cluster's m_peer[64],
// l_peer[64]) and the mbarriers (q_full, then the full barrier of each
// stage, then its empty barrier).  As many stages as fit, up to 8, an even
// number: a warpgroup's chunks then keep to its own stages.
constexpr int kTfStatBytes = 7 * kTfRows * 4;
constexpr int tf_bytes(int q_atoms, int stages) {
  return (q_atoms + 4) * kTfAtomBytes + stages * kTfStageBytes + kTfStatBytes +
         8 * (1 + 2 * stages) + 1024;  // + alignment slack
}
constexpr int tf_stages(int q_atoms) {
  return tf_bytes(q_atoms, 8) <= 232448   ? 8
         : tf_bytes(q_atoms, 6) <= 232448 ? 6
                                          : 4;
}

template <int MW>
struct TfLayout {
  static constexpr int kAtoms = 4 * MW;  // 32-column atoms of D <= 128 MW
  static constexpr int kStages = tf_stages(kAtoms);
  static constexpr int kQ = 0;
  static constexpr int kPHi = kQ + kAtoms * kTfAtomBytes;
  static constexpr int kPLo = kPHi + 2 * kTfAtomBytes;
  static constexpr int kRing = kPLo + 2 * kTfAtomBytes;
  static constexpr int kStats = kRing + kStages * kTfStageBytes;
  static constexpr int kBar = kStats + kTfStatBytes;
  static constexpr int kBytes = tf_bytes(kAtoms, kStages);
  static_assert(kBar + 8 * (1 + 2 * kStages) + 1024 == kBytes, "layout");
  static_assert(kBytes <= 232448, "shared memory of one block");
  // the peer's accumulator half lands in the Q atoms at the end
  static_assert(MW * 32 * 128 * 4 <= kAtoms * kTfAtomBytes, "merge buffer");
};

template <int MW, int SPLIT>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_stream_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const StreamParams p) {
  using namespace sdt;
  using L = TfLayout<MW>;
  constexpr int S = L::kStages;
  constexpr int kChunks = 3 * MW;  // a warpgroup's chunks a key tile: 2 MW K, MW V
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sQ = base + L::kQ, sPh = base + L::kPHi, sRing = base + L::kRing;
  float* const rmax = reinterpret_cast<float*>(gbase + L::kStats);  // [2][64]
  float* const lsum = rmax + 2 * kTfRows;                           // [2][64]
  float* const alpha_s = lsum + 2 * kTfRows;                        // [64]
  float* const m_peer = alpha_s + kTfRows;                          // [64]
  float* const l_peer = m_peer + kTfRows;                           // [64]
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + S + s); };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kTfRows;
  const int na = (p.D + kF32AtomCols - 1) / kF32AtomCols;  // atoms of Q and K
  const int mt = (p.D + 63) / 64;                          // m-tiles of o^T
  const int n_all = (p.Skv + kTfKeys - 1) / kTfKeys;
  // the key tiles of this block: all, or one half of them in a cluster
  uint32_t rank = 0;
  int t_begin = 0, t_end = n_all;
  if constexpr (SPLIT == 2) {
    rank = cluster_ctarank();
    const int half = (n_all + 1) / 2;
    t_begin = rank ? half : 0;
    t_end = rank ? n_all : half;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int total = (t_end - t_begin) * 2 * kChunks;

  // Chunk n: in key tile t_begin + n / (2 kChunks), chunk x = (n / 2) %
  // kChunks of warpgroup w = n % 2: for x < 2 MW the K chunk of atom
  // 2 MW w + x ([64 keys][32 head dims]), else the V chunk of m-tile
  // MW w + x - 2 MW ([64 keys][64 head dims], two atoms).  Atoms past D
  // read as zeros.
  auto issue = [&](int n) {
    const int s = n % S;
    const int j = t_begin + n / (2 * kChunks);
    const int w = n & 1;
    const int x = (n >> 1) % kChunks;
    const uint32_t dst = sRing + s * kTfStageBytes;
    if (x < 2 * MW) {
      mbar_expect_tx(full(s), kTfAtomBytes);
      tma_load(dst, &tk, full(s), (2 * MW * w + x) * kF32AtomCols, h, j * kTfKeys, b);
    } else {
      const int mti = MW * w + x - 2 * MW;
      mbar_expect_tx(full(s), kTfStageBytes);
      tma_load(dst, &tv, full(s), 2 * mti * kF32AtomCols, h, j * kTfKeys, b);
      tma_load(dst + kTfAtomBytes, &tv, full(s), (2 * mti + 1) * kF32AtomCols, h,
               j * kTfKeys, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kTfWgWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTfConsumerWarps) {
    // ---- producer: warp 8 (one thread) issues Q and warpgroup 0's chunks,
    // warp 9 warpgroup 1's, each in order: a stage takes chunk n once the 4
    // warps of its warpgroup have released chunk n - S (S is even, so the
    // same warpgroup's).  Then it waits for the release of the last chunks:
    // its waits trap after kWaitLimitClocks, and the consumers' do not (see
    // mbar_wait_spin), so a copy that never lands traps here.  Warps 10 and
    // 11 only give their registers back.
    setmaxnreg_dec<kTfProducerRegs>();
    const int w = warp - kTfConsumerWarps;
    if (w < 2 && lane == 0) {
      if (w == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        mbar_expect_tx(q_full, na * kTfAtomBytes);
        for (int a = 0; a < na; ++a)
          tma_load(sQ + a * kTfAtomBytes, &tq, q_full, a * kF32AtomCols, h, q0, b);
      }
      for (int n = w; n < total; n += 2) {
        if (n >= S) mbar_wait(empty(n % S), ((n / S) & 1) ^ 1);
        issue(n);
      }
      for (int n = total - S > w ? total - S + ((total - S - w) & 1) : w; n < total; n += 2)
        mbar_wait(empty(n % S), (n / S) & 1);
    }
    __syncwarp();
    if constexpr (SPLIT == 2) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  // ---- consumers: warpgroups 0 and 1
  setmaxnreg_inc<kTfConsumerRegs>();
  // This warp is done with chunk n: once all 4 warps of its warpgroup are,
  // the producer refills the stage.
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(n % S));
  };

  // wgmma's accumulator layout: hopper.cuh's 3xTF32 section
  const int wg = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tid = threadIdx.x & 127;  // thread of the warpgroup
  const float sl2 = p.scale * kTfLog2e;
  const uint32_t q_row = q_ldmatrix_row(sQ);

  float o[MW][32];  // o^T of this warpgroup's m-tiles: head dims x query rows
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[i][r] = 0.f;
  float m[2] = {kTfMaskLog2, kTfMaskLog2};  // rows g, g + 8 (log2 domain)
  float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums over its keys
  // s over this warpgroup's half of the head dims (all 64 keys), and the
  // tensor core's partial sum of one m-tile of o^T over a key tile (the
  // two-level sum, add_scaled: o^T accumulated in the tensor core over the
  // 6144 products of 16384 keys broke the fp32 rule).  The two accumulators
  // have registers of their own: ptxas serializes every wgmma of a kernel
  // whose accumulators share registers.
  float s[32], part[32];
  // the A fragments, split, of two k-steps: one is built while the other
  // k-step's products run
  uint32_t ah[2][4], al[2][4];

  // split K chunk n (all 64 keys): hi in place, lo 8 KiB above; fenced for
  // wgmma's reads
  auto convert = [&](int n) {
    const int st = n % S;
    mbar_wait_spin(full(st), (n / S) & 1);
    split_atom_tf32(gbase + L::kRing + st * kTfStageBytes, tid);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
  };

  mbar_wait_spin(q_full, 0);
  for (int j = t_begin; j < t_end; ++j) {
    // this warpgroup's chunk x of the tile is chunk n0 + 2 x
    const int n0 = (j - t_begin) * 2 * kChunks + wg;

    // s = q k^T over this warpgroup's half of the head dims, all 64 keys,
    // k-step by k-step: A (q's atom, split) is built while the previous
    // k-step's products run.  The first product overwrites s; setting it
    // here tells the compiler that s holds nothing between its tiles, as
    // part holds nothing between its m-tiles, so neither takes registers
    // through the other's products.
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = 0.f;
    convert(n0);
    for (int x = 0; x < 2 * MW; ++x) {
      const int n = n0 + 2 * x;
      const int atom = 2 * MW * wg + x;
      const bool live = atom < na;
      const uint32_t stage = sRing + (n % S) * kTfStageBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (live) {
          qk_kstep(s, ah[kk & 1], al[kk & 1], q_row + atom * kTfAtomBytes, stage, kk,
                   x > 0 || kk > 0);
        } else if (kk == 0) {
          wgmma_wait<0>();
        }
        if (kk == 0 && x > 0) release(n - 2);  // and with them chunk x - 1's
        if (kk == 0 && x + 1 < 2 * MW) convert(n + 2);  // under this k-step's products
      }
    }
    wgmma_wait<0>();
    reg_fence(s);
    release(n0 + 2 * (2 * MW - 1));

    // the two halves of s: each warpgroup keeps its own 32 keys, sending the
    // other warpgroup its partial sum over the other 32 (through the p hi
    // tile, once both are done with the previous tile's p)
    float sk[16];  // s of this warpgroup's 32 keys: key 8 (i >> 2) + 2 t4 + (i & 1)
    {
      float4* ex = reinterpret_cast<float4*>(gbase + L::kPHi);
      named_bar_sync(1, 256);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // the other warpgroup's keys
        float v4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v4[e] = wg ? s[4 * q + e] : s[16 + 4 * q + e];
        ex[(wg * 128 + tid) * 4 + q] = make_float4(v4[0], v4[1], v4[2], v4[3]);
      }
      named_bar_sync(1, 256);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 t = ex[((wg ^ 1) * 128 + tid) * 4 + q];
        const float th[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mine = wg ? s[16 + 4 * q + e] : s[4 * q + e];
          sk[4 * q + e] = wg ? th[e] + mine : mine + th[e];  // warpgroup 0's part first
        }
      }
    }

    // softmax: the tile's row max from both warpgroups, then p = exp2
    const int k0 = j * kTfKeys + 32 * wg;  // this warpgroup's first key
    float mx[2] = {kTfMaskLog2, kTfMaskLog2};
#pragma unroll
    for (int i = 0; i < 16; ++i) sk[i] *= sl2;
    if ((j + 1) * kTfKeys > p.Skv) {  // the last tile: keys past Skv
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= p.Skv) sk[i] = kTfMaskLog2;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sk[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const int row0 = 16 * w4 + g;
    if (t4 == 0) {
      rmax[wg * kTfRows + row0] = mx[0];
      rmax[wg * kTfRows + row0 + 8] = mx[1];
    }
    named_bar_sync(1, 256);  // the row maxima, and both have read the exchange
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float m_new = fmaxf(m[r], fmaxf(rmax[row], rmax[kTfRows + row]));
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
    // p of this warpgroup's 32 keys into its atom of the p tiles
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float p0 = exp2_approx(sk[i] - m[(i >> 1) & 1]);
      const float p1 = exp2_approx(sk[i + 1] - m[(i >> 1) & 1]);
      ls[(i >> 1) & 1] += p0;
      ls[(i >> 1) & 1] += p1;
      store_p_pair(gbase + L::kPHi, L::kPLo - L::kPHi, row0 + 8 * ((i >> 1) & 1),
                   4 * wg + (i >> 2), p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
    if (wg == 0 && t4 == 0) {
      alpha_s[row0] = alpha[0];
      alpha_s[row0 + 8] = alpha[1];
    }
    fence_proxy_async();
    named_bar_sync(1, 256);

    // o^T += v^T p^T: for each m-tile i of this warpgroup its V chunk (the
    // tile's 8 k-steps) into `part`, then o^T = o^T * alpha + part by the
    // FPU (o^T's N columns are the query rows)
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      const int n = n0 + 2 * (2 * MW + i);
      mbar_wait_spin(full(n % S), (n / S) & 1);
      if (wg * MW + i < mt) {
#pragma unroll
        for (int r = 0; r < 32; ++r) part[r] = 0.f;
        vt_p_product<8, false>(
            part, ah, al,
            reinterpret_cast<const float*>(gbase + L::kRing + (n % S) * kTfStageBytes), sPh,
            L::kPLo - L::kPHi, 0);
        release(n);  // the chunk is in registers: its stage is free
        wgmma_wait<0>();
        reg_fence(part);
        add_scaled(o[i], part, alpha_s);
      } else {
        release(n);
      }
    }
  }

  // row statistics: m in rmax[0], each warpgroup's denominator in lsum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t4 == 0) {
    const int row0 = 16 * w4 + g;
    lsum[wg * kTfRows + row0] = l[0];
    lsum[wg * kTfRows + row0 + 8] = l[1];
    if (wg == 0) {
      rmax[row0] = m[0];
      rmax[row0 + 8] = m[1];
    }
  }
  named_bar_sync(1, 256);

  // the block of a cluster that stores a warpgroup's head dims: this one
  // for warpgroup `rank`, the other block for the other warpgroup
  const bool stores = SPLIT == 1 || wg == static_cast<int>(rank);
  if constexpr (SPLIT == 2) {
    cluster_sync();  // both blocks are done with Q, p and the ring
    if (!stores) {   // send this half of o^T to the block that stores it
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4)
          st_cluster_v4(sQ + ((i * 8 + q4) * 128 + tid) * 16, rank ^ 1,
                        make_float4(o[i][4 * q4], o[i][4 * q4 + 1], o[i][4 * q4 + 2],
                                    o[i][4 * q4 + 3]));
    }
    if (threadIdx.x < kTfRows) {  // and the row statistics
      const int row = threadIdx.x;
      st_cluster_f32(smem_u32(m_peer + row), rank ^ 1, rmax[row]);
      st_cluster_f32(smem_u32(l_peer + row), rank ^ 1, lsum[row] + lsum[kTfRows + row]);
    }
    cluster_sync();
  }
  if (stores) {
    // epilogue: (o c + o' c') / (l c + l' c') over this block's and the
    // other block's halves of the keys (one block: o / l), head dims < D,
    // rows < Sq
    const float4* recv = reinterpret_cast<const float4*>(gbase + L::kQ);
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      float c_own[2], c_peer[2], inv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * jn + 2 * t4 + e;
        const float l_own = lsum[row] + lsum[kTfRows + row];
        if constexpr (SPLIT == 2) {
          const float mo = rmax[row], mp = m_peer[row];
          const float mm = fmaxf(mo, mp);
          c_own[e] = exp2_approx(mo - mm);
          c_peer[e] = exp2_approx(mp - mm);
          inv[e] = 1.f / (l_own * c_own[e] + l_peer[row] * c_peer[e]);
        } else {
          c_own[e] = 1.f;
          c_peer[e] = 0.f;
          inv[e] = 1.f / l_own;
        }
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int mti = wg * MW + i;
        if (mti >= mt) continue;
        float4 peer = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (SPLIT == 2) peer = recv[(i * 8 + jn) * 128 + tid];
        const float pv[4] = {peer.x, peer.y, peer.z, peer.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * jn + 2 * t4 + (e & 1);
          const int d = 64 * mti + 16 * w4 + g + 8 * (e >> 1);
          const float y =
              (o[i][4 * jn + e] * c_own[e & 1] + pv[e] * c_peer[e & 1]) * inv[e & 1];
          if (q0 + row < p.Sq && d < p.D) og[static_cast<long long>(q0 + row) * p.o_ss + d] = y;
        }
      }
    }
  }
}

template <int MW, int SPLIT>
cudaError_t launch_tf32(const StreamParams& p, cudaStream_t stream) {
  using L = TfLayout<MW>;
  const auto kernel = flash_stream_tf32_kernel<MW, SPLIT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  if (!sdt::encode_map_f32(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kTfRows) ||
      !sdt::encode_map_f32(&tk, p.k, p.D, p.H, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, kTfKeys) ||
      !sdt::encode_map_f32(&tv, p.v, p.D, p.H, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, kTfKeys))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.Sq + kTfRows - 1) / kTfRows, p.B * p.H, SPLIT);
  cfg.blockDim = dim3(kTfThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = SPLIT;
  cfg.attrs = cluster;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the key split across a cluster of two where the query tiles alone would
// leave SMs idle
template <int MW>
cudaError_t launch_tf32_split(const StreamParams& p, cudaStream_t stream) {
  const int blocks = (p.Sq + kTfRows - 1) / kTfRows * p.B * p.H;
  if (blocks < sdt::sm_count() && p.Skv > kTfKeys) return launch_tf32<MW, 2>(p, stream);
  return launch_tf32<MW, 1>(p, stream);
}

cudaError_t dispatch_f32(const StreamParams& p, cudaStream_t stream) {
  if (p.D <= 256) return launch_tf32_split<2>(p, stream);
  if (p.D <= 384) return launch_tf32_split<3>(p, stream);
  if (p.D <= 512) return launch_tf32_split<4>(p, stream);
  return launch_ffma(p, stream);  // no path runs D > 512
}

}  // namespace

// dtype: 0 = float32, the only one taken (the wrapper widens bf16).  Strides
// are in elements; the last dim of every tensor is contiguous, rows are
// 16-byte aligned; at D <= 512 every dimension longer than 1 steps by a
// positive stride (a TMA map reads it).  Returns the launch's cudaError_t.
extern "C" int sdt_flash_stream(const void* q, const void* k, const void* v,
                                void* o, int dtype, int B, int H, int Sq,
                                int Skv, int D, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, long long o_sb, long long o_ss,
                                long long o_sh, float scale, void* stream) {
  if (D <= 160 || D > 1024 || D % 8 != 0 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamParams p{q,    k,    v,    o,    B,    H,    Sq,   Skv,
                       D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, o_sb, o_ss, o_sh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_f32(p, s));
}
