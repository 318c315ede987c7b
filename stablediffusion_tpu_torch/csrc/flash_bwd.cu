// flash_bwd: the attention backward.  Given q, k, v, the output gradient dO,
// the forward's log-sum-exp `lse` [B, H, Sq] and di = rowsum(O * dO) [B, H, Sq]
// (both fp32), it computes dQ, dK and dV of softmax(q k^T * scale) v, for head
// dims that are multiples of 8 up to 160, fp32 or bf16 in and out, fp32
// accumulation.  Two kernels, neither with atomics, so results are
// deterministic:
//
//   flash_bwd_dkv  grid (key tile, B*H): keeps fp32 dK and dV of its key tile
//                  and loops over the query tiles.
//   flash_bwd_dq   grid (query tile, B*H): keeps fp32 dQ of its query tile
//                  and loops over the key tiles.
//
// Both recompute, for each (query tile, key tile) pair,
//   s  = q k^T,           p = exp(scale * s - lse),
//   dp = dO v^T,          ds = scale * p * (dp - di),
// and then accumulate dV += p^T dO, dK += ds^T q (dkv) or dQ += ds k (dq).
//
// Replaces: the two backward Pallas kernels of the TPU library flash kernel
// that stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) calls,
// _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
// flash_attention.py:941, kernel :796) and _flash_attention_bwd_dq (:1287,
// kernel :1146).  The TPU kernels take the row statistics l and m
// lane-broadcast to 128; here one fp32 lse per row does.  As in the forward
// (flash_fwd.cu), ragged ends are masked in the kernel and the inputs are
// read by stride in their [B, S, H, D] layout: query rows past Sq and keys
// past Skv get p = 0, and causal calls skip tiles wholly above the diagonal.
//
// What bounds it on an H100: the pair does 14*B*H*Sq*Skv*D operations (s and
// dp are recomputed by both kernels; 10 would be the least) and two
// exponentials per (query, key) pair on a few MB of input, so at the UNet's
// S=4096 it is bound by arithmetic.  No [Sq, Skv] tensor ever reaches device
// memory.
//
// bf16: FlashAttention-2's backward on mma.sync m16n8k16 (bf16 in, fp32
// accumulation), 4 warps a block.  p and ds are rounded to bf16 for their
// products, as the JAX library kernels round them (`p.T.astype(do.dtype)`,
// `ds.T.astype(do.dtype)` after `ds *= sm_scale`, `ds.astype(k.dtype)`,
// flash_attention.py:900, :913-918, :1247-1258); the scale goes on ds in
// fp32 before it is rounded.  Neither p nor ds passes through shared memory:
// the C fragments of two adjacent n8 tiles are the A fragment of one k16
// step (common.cuh).  p = exp2(s * scale * log2(e) - lse * log2(e)): one
// FFMA and one ex2.approx per pair and kernel.
//   dq: a warp owns 16 query rows.  s = Q K^T and dp = dO V^T with Q and dO
//   as A fragments, K and V rows by ldmatrix; dQ += bf16(ds) K with K by
//   ldmatrix.trans.  K/V tiles of 64 keys are double-buffered by cp.async.
//   dkv: a warp owns 16 keys and computes the transposed tiles s^T = K Q^T
//   and dp^T = V dO^T with K and V as A fragments; lse and di of the query
//   columns come from a small shared array; dV += bf16(p^T) dO and
//   dK += bf16(ds^T) Q with dO and Q by ldmatrix.trans (the query axis is
//   the k axis).  Q/dO tiles (64 rows; 32 above D = 64) and their lse/di
//   are double-buffered by cp.async.
// A warp keeps its A fragments in registers up to D = 80 (dq: Q, dO) or
// D = 48 (dkv: K, V); above, it reloads them from shared memory at every
// k16 step, so that the fp32 accumulators (dkv at D = 160: 2 x 16 x 160 per
// warp, 160 registers a thread) keep the registers; from D = 128 two warps
// share 16 keys, each with half of dK's and dV's columns.  Shared rows are DP + 8 elements
// (DP = D rounded up to 16); columns D..DP-1, keys past Skv and query rows
// past Sq are zero-filled by cp.async, so no stale bits (0 * NaN) reach a
// product, and the n8 tiles of dQ, dK, dV past D are neither computed nor
// stored.
//
// fp32: exact fp32 cannot use the bf16 tensor cores, so fp32 keeps the
// scalar kernels: the scale is folded into the staged q, which gives both
// s and scale * ds^T q (dQ takes it at the end); p and ds stay fp32 and go
// through shared memory; registers blocked 4 rows x BK/8 keys per thread for
// the scores and 4 rows (or keys) x D/lanes columns for the accumulators.
// Tiles: 64 query rows; 64 keys up to D = 80 and 32 above, so that the fp32
// tiles fit shared memory at D = 160 (dkv: K, V [32][161], Q, dO [64][161],
// P, dS [64][33]: 141 KB).  On the main path fp32 serves only the card's
// fp32 tests and the narrow train reference.
//
// Block: 128 threads (bf16 dkv from D = 128: 256).  The largest dynamic
// shared memory of each instantiation is set once, at its first launch.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per tile (dkv in bf16: see below)
constexpr int kThreads = 128;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // [B, H, Sq]
  const float* di;   // [B, H, Sq]
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Skv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kRows = 4;      // query rows per thread in the score tile

__host__ __device__ constexpr int key_tile(int maxd) { return maxd <= 80 ? 64 : 32; }

// p and ds of one (query tile at q0, key tile at k0) pair for the entries
// this thread owns: rows rg*4 + i, keys cl + 8*j.  Qs holds scale * q; rows of
// Qs/dOs past Sq and rows of Ks/Vs past Skv are zero.
template <int BK>
__device__ __forceinline__ void score_tile(
    const BwdParams& p, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, int ld, const float* lse_s, const float* di_s, int q0,
    int k0, float (&P)[kRows][BK / 8], float (&dS)[kRows][BK / 8]) {
  constexpr int kCols = BK / 8;
  const int rg = threadIdx.x >> 3;
  const int cl = threadIdx.x & 7;
  float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;

  for (int d = 0; d < p.D; ++d) {
    float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qv[i] = Qs[(rg * kRows + i) * ld + d];
      ov[i] = dOs[(rg * kRows + i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      kv[j] = Ks[(cl + 8 * j) * ld + d];
      vv[j] = Vs[(cl + 8 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg * kRows + i;
    const int qi = q0 + r;
    const float l = lse_s[r];
    const float dd = di_s[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kj = k0 + cl + 8 * j;
      const bool keep = qi < p.Sq && kj < p.Skv && !(p.causal && kj > qi);
      const float e = keep ? __expf(s[i][j] - l) : 0.f;
      P[i][j] = e;
      dS[i][j] = e * (dp[i][j] - dd);
    }
  }
}

// lse and di of query rows q0 .. q0 + kBQ - 1 into shared memory; rows past
// Sq are zero and never read their global values.
__device__ __forceinline__ void stage_row_stats(float* lse_s, float* di_s,
                                                const float* lse_g,
                                                const float* di_g, int valid) {
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    lse_s[r] = r < valid ? lse_g[r] : 0.f;
    di_s[r] = r < valid ? di_g[r] : 0.f;
  }
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BK = key_tile(MAXD);
  constexpr int kCols = BK / 8;
  constexpr int kLanes = kThreads / (BK / 4);  // threads that share 4 keys
  constexpr int kDPT = (MAXD + kLanes - 1) / kLanes;
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;  // odd row stride: conflict-free column reads
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* dOs = Qs + kBQ * ld;
  float* Ps = dOs + kBQ * ld;     // [kBQ][BK + 1]
  float* dSs = Ps + kBQ * (BK + 1);  // [kBQ][BK + 1]
  float* lse_s = dSs + kBQ * (BK + 1);
  float* di_s = lse_s + kBQ;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * BK;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_g = p.lse + static_cast<long long>(blockIdx.y) * p.Sq;
  const float* di_g = p.di + static_cast<long long>(blockIdx.y) * p.Sq;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cl = tid & 7;
  const int kg = tid / kLanes;  // keys kg*4 .. kg*4+3 of the tile
  const int ln = tid - kg * kLanes;

  const int kvalid = min(BK, p.Skv - k0);
  sdt::stage_rows(Ks, ld,
                  static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh +
                      static_cast<long long>(k0) * p.k_ss,
                  p.k_ss, BK, kvalid, D, 1.f);
  sdt::stage_rows(Vs, ld,
                  static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh +
                      static_cast<long long>(k0) * p.v_ss,
                  p.v_ss, BK, kvalid, D, 1.f);

  float dk[kRows][kDPT], dv[kRows][kDPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kDPT; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // causal: query rows below k0 see no key of this tile
  const int qt_first = p.causal ? k0 / kBQ : 0;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    const int qvalid = min(kBQ, p.Sq - q0);
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are no longer read
    sdt::stage_rows(Qs, ld, qg + static_cast<long long>(q0) * p.q_ss, p.q_ss,
                    kBQ, qvalid, D, p.scale);
    sdt::stage_rows(dOs, ld, dog + static_cast<long long>(q0) * p.do_ss,
                    p.do_ss, kBQ, qvalid, D, 1.f);
    stage_row_stats(lse_s, di_s, lse_g + q0, di_g + q0, qvalid);
    __syncthreads();

    float P[kRows][kCols], dS[kRows][kCols];
    score_tile<BK>(p, Qs, dOs, Ks, Vs, ld, lse_s, di_s, q0, k0, P, dS);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        Ps[(rg * kRows + i) * (BK + 1) + cl + 8 * j] = P[i][j];
        dSs[(rg * kRows + i) * (BK + 1) + cl + 8 * j] = dS[i][j];
      }
    __syncthreads();

    // dV += p^T dO, dK += ds^T (scale q) over the tile's valid rows
    for (int c = 0; c < qvalid; ++c) {
      float pv[kRows], sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = Ps[c * (BK + 1) + kg * kRows + i];
        sv[i] = dSs[c * (BK + 1) + kg * kRows + i];
      }
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = ln + kLanes * jj;
        if (d < D) {
          const float o = dOs[c * ld + d];
          const float qq = Qs[c * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dv[i][jj] = fmaf(pv[i], o, dv[i][jj]);
            dk[i][jj] = fmaf(sv[i], qq, dk[i][jj]);
          }
        }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + kg * kRows + i;
    if (key < p.Skv) {
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = ln + kLanes * jj;
        if (d < D) {
          sdt::store1(dkg + static_cast<long long>(key) * p.dk_ss + d, dk[i][jj]);
          sdt::store1(dvg + static_cast<long long>(key) * p.dv_ss + d, dv[i][jj]);
        }
      }
    }
  }
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BK = key_tile(MAXD);
  constexpr int kCols = BK / 8;
  constexpr int kDPT = MAXD / 8;  // accumulator columns per thread
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kBQ * ld;
  float* Ks = dOs + kBQ * ld;
  float* Vs = Ks + BK * ld;
  float* dSs = Vs + BK * ld;  // [kBQ][BK + 1]
  float* lse_s = dSs + kBQ * (BK + 1);
  float* di_s = lse_s + kBQ;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kBQ;
  const int qvalid = min(kBQ, p.Sq - q0);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cl = tid & 7;

  sdt::stage_rows(Qs, ld,
                  static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                      static_cast<long long>(q0) * p.q_ss,
                  p.q_ss, kBQ, qvalid, D, p.scale);
  sdt::stage_rows(dOs, ld,
                  static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh +
                      static_cast<long long>(q0) * p.do_ss,
                  p.do_ss, kBQ, qvalid, D, 1.f);
  const long long row0 = static_cast<long long>(blockIdx.y) * p.Sq + q0;
  stage_row_stats(lse_s, di_s, p.lse + row0, p.di + row0, qvalid);

  float acc[kRows][kDPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kDPT; ++jj) acc[i][jj] = 0.f;

  int n_tiles = (p.Skv + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / BK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int kvalid = min(BK, p.Skv - k0);
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    sdt::stage_rows(Ks, ld, kg + static_cast<long long>(k0) * p.k_ss, p.k_ss,
                    BK, kvalid, D, 1.f);
    sdt::stage_rows(Vs, ld, vg + static_cast<long long>(k0) * p.v_ss, p.v_ss,
                    BK, kvalid, D, 1.f);
    __syncthreads();

    float P[kRows][kCols], dS[kRows][kCols];
    score_tile<BK>(p, Qs, dOs, Ks, Vs, ld, lse_s, di_s, q0, k0, P, dS);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dSs[(rg * kRows + i) * (BK + 1) + cl + 8 * j] = dS[i][j];
    __syncthreads();

    // dQ += ds k over the tile's valid keys (scale applied at the end)
    for (int c = 0; c < kvalid; ++c) {
      float sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = dSs[(rg * kRows + i) * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = cl + 8 * jj;
        if (d < D) {
          const float kk = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][jj] = fmaf(sv[i], kk, acc[i][jj]);
        }
      }
    }
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
           static_cast<long long>(q0) * p.dq_ss;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg * kRows + i;
    if (r < qvalid) {
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = cl + 8 * jj;
        if (d < D) sdt::store1(dqg + static_cast<long long>(r) * p.dq_ss + d, acc[i][jj] * p.scale);
      }
    }
  }
}

template <int MAXD, bool kDKV>
cudaError_t launch_f32(const BwdParams& p, cudaStream_t stream) {
  constexpr int BK = key_tile(MAXD);
  // both kernels: Q, dO [kBQ][D+1], K, V [BK][D+1], lse and di [kBQ]; dkv
  // stages P and dS [kBQ][BK+1], dq only dS
  auto smem_bytes = [](int d) {
    return sizeof(float) * (2 * (kBQ + BK) * (d + 1) + (kDKV ? 2 : 1) * kBQ * (BK + 1) + 2 * kBQ);
  };
  void (*kernel)(const BwdParams) =
      kDKV ? flash_bwd_dkv_kernel<MAXD> : flash_bwd_dq_kernel<MAXD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes(MAXD)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(kDKV ? (p.Skv + BK - 1) / BK : (p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  kernel<<<grid, kThreads, smem_bytes(p.D), stream>>>(p);
  return cudaGetLastError();
}

template <bool kDKV>
cudaError_t dispatch_f32(const BwdParams& p, cudaStream_t stream) {
  // the forward's buckets: exact for the main path's 40/80/160
  if (p.D <= 16) return launch_f32<16, kDKV>(p, stream);
  if (p.D <= 32) return launch_f32<32, kDKV>(p, stream);
  if (p.D <= 40) return launch_f32<40, kDKV>(p, stream);
  if (p.D <= 64) return launch_f32<64, kDKV>(p, stream);
  if (p.D <= 80) return launch_f32<80, kDKV>(p, stream);
  if (p.D <= 96) return launch_f32<96, kDKV>(p, stream);
  if (p.D <= 128) return launch_f32<128, kDKV>(p, stream);
  return launch_f32<160, kDKV>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;  // keys per tile (dq: per loop step; dkv: per block)
constexpr float kLog2e = 1.4426950408889634f;

using sdt::bf16;
using sdt::cp_async_commit;
using sdt::cp_async_wait;
using sdt::exp2_approx;
using sdt::mma_bf16;

// Where the fp32 accumulators (dq: 16 x DP, dkv: 2 x 16 x DP per warp) leave
// no room, a warp reloads the A fragments of its rows (dq: Q and dO; dkv: K
// and V) from shared memory at every k16 step instead of keeping them in
// registers, dkv takes 32 query rows per tile in place of 64, and from
// DP = 128 dkv runs 8 warps, two per 16 keys, each accumulating half of the
// head dims of dK and dV (both compute the whole s^T and dp^T).  Without
// that, dkv spills at DP = 64, 80, 128 and 160 (ptxas -v, sm_90a).
__host__ __device__ constexpr bool tc_dq_resident(int dp) { return dp <= 80; }
__host__ __device__ constexpr bool tc_dkv_resident(int dp) { return dp <= 48; }
__host__ __device__ constexpr int tc_dkv_query_tile(int dp) { return dp <= 64 ? 64 : 32; }
__host__ __device__ constexpr int tc_dkv_split(int dp) { return dp >= 128 ? 2 : 1; }

// p of one (query, key) pair in the log2 domain: exp2(s * scale * log2(e) -
// lse * log2(e)), one FFMA and one ex2.approx
__device__ __forceinline__ float prob(float s, float sl2, float lse2) {
  return exp2_approx(fmaf(s, sl2, -lse2));
}

// dQ of 64 query rows, a warp 16 of them: for each tile of 64 keys,
// s = Q K^T and dp = dO V^T (Q, dO as A fragments, K, V rows by ldmatrix),
// p and ds in registers, dQ += bf16(ds) K (K by ldmatrix.trans).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const BwdParams p) {
  constexpr int ld = DP + 8;      // shared row stride, elements
  constexpr int kK16 = DP / 16;   // k16 steps of s and dp
  constexpr int kN8 = DP / 8;     // n8 tiles of dQ
  constexpr int kS8 = kTcBK / 8;  // n8 tiles of s and dp
  constexpr bool kResident = tc_dq_resident(DP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][ld]
  bf16* dOs = Qs + kBQ * ld;                     // [kBQ][ld]
  bf16* Ks = dOs + kBQ * ld;                     // [2][kTcBK][ld]
  bf16* Vs = Ks + 2 * kTcBK * ld;                // [2][kTcBK][ld]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kBQ;
  const int qvalid = min(kBQ, p.Sq - q0);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column pair
  const int wrow = warp * 16;

  int n_tiles = (p.Skv + kTcBK - 1) / kTcBK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kTcBK + 1);

  auto stage_kv = [&](int kt, int buf) {
    const int k0 = kt * kTcBK;
    const int valid = min(kTcBK, p.Skv - k0);
    sdt::stage_tile<DP, kThreads>(Ks + buf * kTcBK * ld, kg + static_cast<long long>(k0) * p.k_ss,
                                  p.k_ss, kTcBK, valid, p.D);
    sdt::stage_tile<DP, kThreads>(Vs + buf * kTcBK * ld, vg + static_cast<long long>(k0) * p.v_ss,
                                  p.v_ss, kTcBK, valid, p.D);
  };
  sdt::stage_tile<DP, kThreads>(
      Qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + static_cast<long long>(q0) * p.q_ss,
      p.q_ss, kBQ, qvalid, p.D);
  sdt::stage_tile<DP, kThreads>(
      dOs, static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh +
               static_cast<long long>(q0) * p.do_ss,
      p.do_ss, kBQ, qvalid, p.D);
  stage_kv(0, 0);
  cp_async_commit();

  // lse (log2 domain) and di of this thread's rows g and g + 8; rows past Sq
  // read nothing and keep 0, which with their zero Q and dO rows gives ds = 0
  const float sl2 = p.scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wrow + g + 8 * i;
    const long long at = static_cast<long long>(blockIdx.y) * p.Sq + r;
    lse2[i] = r < p.Sq ? p.lse[at] * kLog2e : 0.f;
    dd[i] = r < p.Sq ? p.di[at] : 0.f;
  }

  float acc[kN8][4];
#pragma unroll
  for (int n = 0; n < kN8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  unsigned qa[kResident ? kK16 : 1][4], da[kResident ? kK16 : 1][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) stage_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();
    if constexpr (kResident) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          sdt::load_a<ld>(Qs, wrow, kk, qa[kk]);
          sdt::load_a<ld>(dOs, wrow, kk, da[kk]);
        }
      }
    }

    // s = q k^T and dp = dO v^T for this warp's 16 rows and the tile's keys
    const bf16* Kb = Ks + buf * kTcBK * ld;
    const bf16* Vb = Vs + buf * kTcBK * ld;
    float s[kS8][4], dp[kS8][4];
#pragma unroll
    for (int j = 0; j < kS8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
      unsigned aq[4], ad[4];
      if constexpr (kResident) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          aq[x] = qa[kk][x];
          ad[x] = da[kk][x];
        }
      } else {
        sdt::load_a<ld>(Qs, wrow, kk, aq);
        sdt::load_a<ld>(dOs, wrow, kk, ad);
      }
#pragma unroll
      for (int jp = 0; jp < kS8 / 2; ++jp) {
        unsigned bk[4], bv[4];
        sdt::load_b_rows<ld>(Kb, jp * 16, kk, bk);
        sdt::load_b_rows<ld>(Vb, jp * 16, kk, bv);
        mma_bf16(s[2 * jp], aq, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * jp], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], ad, bv[2], bv[3]);
      }
    }

    // p = exp(s - lse), 0 for keys past Skv and past the diagonal;
    // ds = scale * p * (dp - di), kept in s
    const int k0 = kt * kTcBK;
    const bool masked = k0 + kTcBK > p.Skv || (p.causal && k0 + kTcBK - 1 > q0 + wrow);
#pragma unroll
    for (int j = 0; j < kS8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = prob(s[j][e], sl2, lse2[e >> 1]);
        if (masked) {
          const int key = k0 + j * 8 + tq * 2 + (e & 1);
          const int row = q0 + wrow + g + (e >> 1) * 8;
          if (key >= p.Skv || (p.causal && key > row)) pe = 0.f;
        }
        s[j][e] = p.scale * pe * (dp[j][e] - dd[e >> 1]);
      }
    }

    // dQ += bf16(ds) k: ds straight from the registers as A fragments
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      unsigned a[4];
      sdt::c_to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int np = 0; np < kN8 / 2; ++np) {
        unsigned bk[4];
        sdt::load_b_cols<ld>(Kb, kk * 16, np * 16, bk);
        mma_bf16(acc[2 * np], a, bk[0], bk[1]);
        if ((2 * np + 1) * 8 < p.D) mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
              static_cast<long long>(q0) * p.dq_ss;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    if (r < qvalid) {
      bf16* row = dqg + static_cast<long long>(r) * p.dq_ss;
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        const int d = n * 8 + tq * 2;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(row + d) =
              __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
}

// dK and dV of 64 keys, a warp 16 of them, over the query tiles: the
// transposed tiles s^T = K Q^T and dp^T = V dO^T (K, V as A fragments, Q, dO
// rows by ldmatrix), p^T and ds^T in registers, dV += bf16(p^T) dO and
// dK += bf16(ds^T) Q (dO, Q by ldmatrix.trans: the query axis is the k axis).
template <int DP>
__global__ void __launch_bounds__(kThreads * tc_dkv_split(DP))
flash_bwd_dkv_tc_kernel(const BwdParams p) {
  constexpr int ld = DP + 8;
  constexpr int kK16 = DP / 16;
  constexpr int kSplit = tc_dkv_split(DP);     // warps per 16 keys
  constexpr int kBlock = kThreads * kSplit;
  constexpr int kN8 = DP / 8 / kSplit;         // n8 tiles of dK and dV a warp keeps
  constexpr int BQ = tc_dkv_query_tile(DP);    // query rows per tile
  constexpr int kQ8 = BQ / 8;                  // n8 tiles of s^T and dp^T
  constexpr bool kResident = tc_dkv_resident(DP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kTcBK][ld]
  bf16* Vs = Ks + kTcBK * ld;                    // [kTcBK][ld]
  bf16* Qs = Vs + kTcBK * ld;                    // [2][BQ][ld]
  bf16* dOs = Qs + 2 * BQ * ld;                  // [2][BQ][ld]
  float* stats = reinterpret_cast<float*>(dOs + 2 * BQ * ld);  // [2][lse, di][BQ]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * kTcBK;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_g = p.lse + static_cast<long long>(blockIdx.y) * p.Sq;
  const float* di_g = p.di + static_cast<long long>(blockIdx.y) * p.Sq;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // this warp's first key in the block, and its first n8 tile of dK and dV
  const int wkey = (kSplit == 1 ? warp : warp & 3) * 16;
  const int n8_0 = kSplit == 1 ? 0 : (warp >> 2) * kN8;

  // causal: query rows below k0 see no key of this tile
  const int qt_first = p.causal ? k0 / BQ : 0;
  const int n_qt = (p.Sq + BQ - 1) / BQ;

  auto stage_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    const int valid = min(BQ, p.Sq - q0);
    sdt::stage_tile<DP, kBlock>(Qs + buf * BQ * ld, qg + static_cast<long long>(q0) * p.q_ss,
                                p.q_ss, BQ, valid, p.D);
    sdt::stage_tile<DP, kBlock>(dOs + buf * BQ * ld, dog + static_cast<long long>(q0) * p.do_ss,
                                p.do_ss, BQ, valid, p.D);
    for (int c = threadIdx.x; c < 2 * BQ; c += kBlock) {
      const int r = c % BQ;
      const bool ok = r < valid;
      const float* src = (c < BQ ? lse_g : di_g) + q0 + r;
      sdt::cp_async4(sdt::smem_u32(stats + buf * 2 * BQ + c), ok ? src : lse_g, ok);
    }
  };
  const int kvalid = min(kTcBK, p.Skv - k0);
  sdt::stage_tile<DP, kBlock>(
      Ks, static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh + static_cast<long long>(k0) * p.k_ss,
      p.k_ss, kTcBK, kvalid, p.D);
  sdt::stage_tile<DP, kBlock>(
      Vs, static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh + static_cast<long long>(k0) * p.v_ss,
      p.v_ss, kTcBK, kvalid, p.D);
  if (qt_first < n_qt) stage_q(qt_first, 0);
  cp_async_commit();

  const float sl2 = p.scale * kLog2e;
  float dk[kN8][4], dv[kN8][4];
#pragma unroll
  for (int n = 0; n < kN8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  unsigned ka[kResident ? kK16 : 1][4], va[kResident ? kK16 : 1][4];

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int buf = (qt - qt_first) & 1;
    if (qt + 1 < n_qt) stage_q(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kResident) {
      if (qt == qt_first) {
#pragma unroll
        for (int kk = 0; kk < kK16; ++kk) {
          sdt::load_a<ld>(Ks, wkey, kk, ka[kk]);
          sdt::load_a<ld>(Vs, wkey, kk, va[kk]);
        }
      }
    }

    const int q0 = qt * BQ;
    const bf16* Qb = Qs + buf * BQ * ld;
    const bf16* dOb = dOs + buf * BQ * ld;
    const float* lse_s = stats + buf * 2 * BQ;
    const float* di_s = lse_s + BQ;

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys and the tile's
    // query rows
    float s[kQ8][4], dp[kQ8][4];
#pragma unroll
    for (int j = 0; j < kQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
      unsigned ak[4], av[4];
      if constexpr (kResident) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ak[x] = ka[kk][x];
          av[x] = va[kk][x];
        }
      } else {
        sdt::load_a<ld>(Ks, wkey, kk, ak);
        sdt::load_a<ld>(Vs, wkey, kk, av);
      }
#pragma unroll
      for (int jp = 0; jp < kQ8 / 2; ++jp) {
        unsigned bq[4], bo[4];
        sdt::load_b_rows<ld>(Qb, jp * 16, kk, bq);
        sdt::load_b_rows<ld>(dOb, jp * 16, kk, bo);
        mma_bf16(s[2 * jp], ak, bq[0], bq[1]);
        mma_bf16(s[2 * jp + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * jp], av, bo[0], bo[1]);
        mma_bf16(dp[2 * jp + 1], av, bo[2], bo[3]);
      }
    }

    // p^T (kept in s) and ds^T = scale * p^T * (dp^T - di) (kept in dp);
    // p = 0 for query rows past Sq, keys past Skv and past the diagonal
    const bool masked = q0 + BQ > p.Sq || k0 + kTcBK > p.Skv ||
                        (p.causal && q0 < k0 + wkey + 15);
#pragma unroll
    for (int j = 0; j < kQ8; ++j) {
      const int c = j * 8 + tq * 2;  // this thread's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(di_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? l2.y : l2.x) * kLog2e;
        float pe = prob(s[j][e], sl2, lse2);
        if (masked) {
          const int query = q0 + c + (e & 1);
          const int key = k0 + wkey + g + (e >> 1) * 8;
          if (query >= p.Sq || key >= p.Skv || (p.causal && key > query)) pe = 0.f;
        }
        s[j][e] = pe;
        dp[j][e] = p.scale * pe * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += bf16(p^T) dO, dK += bf16(ds^T) q; p^T and ds^T are packed to
    // bf16 A fragments first, which frees their fp32 registers
    unsigned ap[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sdt::c_to_a(s[2 * kk], s[2 * kk + 1], ap[kk]);
      sdt::c_to_a(dp[2 * kk], dp[2 * kk + 1], as[kk]);
    }
#pragma unroll
    for (int np = 0; np < kN8 / 2; ++np) {
      const int n0 = (n8_0 + 2 * np) * 8;  // head dims n0 .. n0 + 15
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        unsigned bo[4], bq[4];
        sdt::load_b_cols<ld>(dOb, kk * 16, n0, bo);
        sdt::load_b_cols<ld>(Qb, kk * 16, n0, bq);
        mma_bf16(dv[2 * np], ap[kk], bo[0], bo[1]);
        mma_bf16(dk[2 * np], as[kk], bq[0], bq[1]);
        if (n0 + 8 < p.D) {
          mma_bf16(dv[2 * np + 1], ap[kk], bo[2], bo[3]);
          mma_bf16(dk[2 * np + 1], as[kk], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }
  cp_async_wait<0>();  // a causal block past the last query row copied K, V only

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + wkey + g + 8 * i;
    if (key < p.Skv) {
      bf16* krow = dkg + static_cast<long long>(key) * p.dk_ss;
      bf16* vrow = dvg + static_cast<long long>(key) * p.dv_ss;
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        const int d = (n8_0 + n) * 8 + tq * 2;
        if (d < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(krow + d) =
              __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(vrow + d) =
              __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
        }
      }
    }
  }
}

template <int DP, bool kDKV>
cudaError_t launch_tc(const BwdParams& p, cudaStream_t stream) {
  // dkv: K, V [kTcBK][ld], Q, dO [2][BQ][ld], lse and di [2][BQ] fp32;
  // dq: Q, dO [kBQ][ld], K, V [2][kTcBK][ld]
  constexpr int kBQdkv = tc_dkv_query_tile(DP);
  constexpr int kSmem =
      kDKV ? sizeof(bf16) * (2 * kTcBK + 4 * kBQdkv) * (DP + 8) + sizeof(float) * 4 * kBQdkv
           : sizeof(bf16) * (2 * kBQ + 4 * kTcBK) * (DP + 8);
  void (*kernel)(const BwdParams) =
      kDKV ? flash_bwd_dkv_tc_kernel<DP> : flash_bwd_dq_tc_kernel<DP>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(kDKV ? (p.Skv + kTcBK - 1) / kTcBK : (p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  kernel<<<grid, kDKV ? kThreads * tc_dkv_split(DP) : kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDKV>
cudaError_t dispatch_bf16(const BwdParams& p, cudaStream_t stream) {
  // D rounded up to a multiple of 16 (the k16 steps); exact for 40 -> 48,
  // 80 and 160
  if (p.D <= 16) return launch_tc<16, kDKV>(p, stream);
  if (p.D <= 32) return launch_tc<32, kDKV>(p, stream);
  if (p.D <= 48) return launch_tc<48, kDKV>(p, stream);
  if (p.D <= 64) return launch_tc<64, kDKV>(p, stream);
  if (p.D <= 80) return launch_tc<80, kDKV>(p, stream);
  if (p.D <= 96) return launch_tc<96, kDKV>(p, stream);
  if (p.D <= 128) return launch_tc<128, kDKV>(p, stream);
  return launch_tc<160, kDKV>(p, stream);
}

template <bool kDKV>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* di, void* dq, void* dk, void* dv,
        int dtype, int B, int H, int Sq, int Skv, int D, const long long* st,
        float scale, int causal, void* stream) {
  if (D <= 0 || D > 160 || D % 8 != 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,      k,      v,      dout,   lse,    di,     dq,
                    dk,     dv,     B,      H,      Sq,     Skv,    D,
                    st[0],  st[1],  st[2],  st[3],  st[4],  st[5],  st[6],
                    st[7],  st[8],  st[9],  st[10], st[11], st[12], st[13],
                    st[14], st[15], st[16], st[17], st[18], st[19], st[20],
                    scale,  causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch_f32<kDKV>(p, s) : dispatch_bf16<kDKV>(p, s);
  return static_cast<int>(err);
}

}  // namespace

// One argument list for both entries.  dtype: 0 = float32, 1 = bfloat16, for
// q, k, v, dO and the three gradients.  lse and di are contiguous fp32
// [B, H, Sq].  Strides are in elements, (batch, sequence, head) for q, k, v,
// dO, dQ, dK, dV in that order; the last dim of every tensor is contiguous.
// flash_bwd_dq writes dq only, flash_bwd_dkv dk and dv only.  Each returns
// the launch's cudaError_t.
#define SDT_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,           \
      const float *lse, const float *di, void *dq, void *dk, void *dv,      \
      int dtype, int B, int H, int Sq, int Skv, int D, long long q_sb,      \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,       \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,       \
      long long do_sb, long long do_ss, long long do_sh, long long dq_sb,   \
      long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,   \
      long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,   \
      float scale, int causal, void *stream
#define SDT_BWD_STRIDES                                                     \
  const long long st[21] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb, \
                            v_ss,  v_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss, \
                            dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh}

extern "C" int sdt_flash_bwd_dq(SDT_BWD_ARGS) {
  SDT_BWD_STRIDES;
  return run<false>(q, k, v, dout, lse, di, dq, dk, dv, dtype, B, H, Sq, Skv,
                    D, st, scale, causal, stream);
}

extern "C" int sdt_flash_bwd_dkv(SDT_BWD_ARGS) {
  SDT_BWD_STRIDES;
  return run<true>(q, k, v, dout, lse, di, dq, dk, dv, dtype, B, H, Sq, Skv,
                   D, st, scale, causal, stream);
}
