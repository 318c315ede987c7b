// flash_bwd: the attention backward.  Given q, k, v, the output gradient dO,
// the forward's log-sum-exp `lse` [B, H, Sq] and di = rowsum(O * dO) [B, H, Sq]
// (both fp32), it computes dQ, dK and dV of softmax(q k^T * scale) v, for head
// dims that are multiples of 8 up to 160, in bf16 (Hopper tensor cores:
// TMA-fed wgmma) or fp32 (scalar FMAs), with fp32 accumulation.  Two
// kernels, neither with atomics, so results are deterministic run to run:
//
//   flash_bwd_dkv  one block per key tile of one (batch, head): keeps fp32 dK
//                  and dV of its keys and loops over the query tiles.
//   flash_bwd_dq   one block per query tile of one (batch, head) (in bf16,
//                  where tiles are short, a persistent block takes several):
//                  keeps fp32 dQ of its rows and loops over the key tiles.
//
// Both recompute, for each (query tile, key tile) pair,
//   s  = q k^T,           p = exp(scale * s - lse),
//   dp = dO v^T,          ds = scale * p * (dp - di),
// and then accumulate dV += p^T dO, dK += ds^T q (dkv) or dQ += ds k (dq).
//
// Replaces: the two backward Pallas kernels of the TPU library flash kernel
// that stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) reaches
// through its custom VJP, _flash_attention_bwd_dkv (jax/experimental/pallas/
// ops/tpu/flash_attention.py:941, kernel :796) and _flash_attention_bwd_dq
// (:1287, kernel :1146).  The TPU kernels take the row statistics l and m
// lane-broadcast to 128; here one fp32 lse per row does.  As in the forward
// (flash_fwd.cu), ragged ends are masked in the kernel and the inputs are
// read by stride in their [B, S, H, D] layout: query rows past Sq and keys
// past Skv get p = 0, and causal calls skip tiles wholly past the diagonal.
//
// What bounds it on an H100: the pair does 14*B*H*Sq*Skv*D operations (s and
// dp are recomputed by both kernels; 10 would be the least) and two
// exponentials per (query, key) pair on a few MB of input, so at the UNet's
// S=4096 it is bound by arithmetic: at D=64 the products on the bf16 tensor
// cores and the exponentials on the MUFU take about as long as each other.
// No [Sq, Skv] tensor ever reaches device memory.
//
// bf16, 384 threads a block, the forward's shape (flash_fwd.cu):
//   * Warp specialisation.  Warps 0-7 are two consumer warpgroups of 64 rows
//     (wgmma's M); one producer warp (warp 8) issues every copy.  The
//     producer warpgroup gives its registers back (setmaxnreg 40, the
//     consumers 232), one block an SM.
//   * TMA.  The tile a block keeps (dq: Q and dO, 128 rows; dkv: K and V) is
//     loaded once; the tiles it loops over (dq: K and V; dkv: Q and dO)
//     flow through a ring with full and empty mbarriers.  The maps are 4-D
//     (D, H, S, B) with the tensors' own strides, encoded at each launch
//     (hopper.cuh).  TMA's zero fill supplies rows past Sq/Skv and head-dim
//     columns past D, so no stale bits reach a product (0 * NaN).
//   * lse and di rows.  A row of the [B, H, Sq] arrays starts on a 4-byte
//     boundary only (bh * Sq * 4 bytes, Sq = 4250 or 77), which no tensor
//     map takes, so every lane of the producer warp copies them into the
//     stage by 4-byte cp.async and arrives on the stage's full barrier when
//     its copies land (cp.async.mbarrier.arrive.noinc; the barrier counts
//     1 + 32 arrivals).
//   * p = exp2(s * scale * log2(e) - lse * log2(e)): one FFMA and one
//     ex2.approx per pair and kernel, in wgmma's accumulator layout.  p and
//     ds are rounded to bf16 for their products, as the JAX library kernels
//     round them (`p.T.astype(do.dtype)`, `ds.T.astype(do.dtype)` after
//     `ds *= sm_scale`, `ds.astype(k.dtype)`, flash_attention.py:900,
//     :913-918, :1247-1258); the scale goes on ds in fp32 before it is
//     rounded.  Neither passes through shared memory: the accumulator of two
//     n8 tiles is the A fragment of one k16 step (hopper.cuh acc_to_a), as
//     the forward's p.
//   dq: a block takes query tiles of 128 rows.  Per key tile of BK keys,
//   s = Q K^T and dp = dO V^T by SS wgmma m64nBKk16 (both operands K-major,
//   the 128-byte swizzle), V's stage released, ds in registers, then
//   dQ += bf16(ds) K by RS wgmma m64n64k16 per 64-column atom with K read
//   MN-major (16 keys = 2048 bytes a k16 step, as the forward reads V), and
//   K's stage released.  The epilogue stores dQ in bf16 for rows < Sq.  A
//   block a query tile, except where a tile has at most kPersistentKeyTiles
//   key tiles (the 77 text keys): there a block's start, its Q/dO copies
//   and its epilogue outweigh its products, so one persistent block an SM
//   takes tile after tile with two Q/dO buffers (one at D > 128, where two
//   do not fit), the next tile's copies under this one's work.
//   dkv: a block takes 128 or 64 keys of one (batch, head); per query tile
//   of BQ rows, s^T = K Q^T and dp^T = V dO^T by SS wgmma m64nBQk16, p^T and
//   ds^T in registers, dV += bf16(p^T) dO and dK += bf16(ds^T) Q by RS wgmma
//   with dO and Q read MN-major; dK and dV stay in fp32 registers across the
//   query loop and are stored once.  Three ways to share a block's keys
//   between the two warpgroups (DkvLayout's MODE):
//     kKeys128: 128 keys, each warpgroup 64 of them with dK and dV, D
//     registers a thread for the two accumulators plus BQ for s^T and dp^T:
//     this fits the 168 that ptxas gives a consumer (PERF.md: it allocates
//     within the launch's count whatever setmaxnreg grants) at
//     D <= 64 only;
//     kSplitGrads (every D above 64): 64 keys, warpgroup 0 accumulating dV
//     (s^T, p^T) and warpgroup 1 dK (s^T, dp^T, ds^T), D / 2 registers of
//     accumulator a thread, at the cost of s^T and p^T twice (5 products a
//     tile in place of 4; splitting the head dims instead, as the earlier
//     mma.sync kernel did, costs 6 and leaves D = 160's three atoms uneven);
//     kSplitQueries (D <= 64 where 128-key blocks would leave SMs idle: the
//     77 text keys, B * H blocks on 132 SMs): 64 keys, each warpgroup dK and
//     dV over every other query tile, which halves a block's serial chain of
//     tiles; the second warpgroup's sums go through shared memory and the
//     first adds them to its own, in a fixed order.
// Head dims are padded to whole 64-column swizzle atoms (24/40/64 -> 64,
// 80/104/128 -> 128, 160 -> 192); the products over the head dims (s, dp)
// skip the k16 steps past D, the products whose N is the head dims (dQ, dK,
// dV) compute every atom with n64, since an N narrower than the atom would
// need another swizzle for the MN-major operand; columns past D are not
// stored.  Tiles (kBwdTiles below; registers and spills from ptxas -v in
// PERF.md, printed by chip_smoke.py's phase 1):
//   DP=64:  dq BK=64, two Q/dO buffers (99 KiB); dkv BQ=64, kKeys128
//           (99 KiB) or kSplitQueries (115 KiB);
//   DP=128: dq BK=64, two buffers (195 KiB); dkv BQ=64, kSplitGrads (163 KiB);
//   DP=192: dq BK=32, one buffer (146 KiB); dkv BQ=32, kSplitGrads (146 KiB).
// A BK or BQ of 128 at D=64, or BQ=64 at D=128 without a split, would hold
// more fp32 accumulator than 168 registers.
// Where the time goes (utils/flash_bwd_ablation.py; PERF.md): the
// copies and barriers alone take a quarter to two thirds of a long shape's
// time; the rest is each warpgroup's products and softmax in series, the
// softmax issued by 2 consumer warps an SM sub-partition with little to
// hide its latency.  So it is written for instruction count: p and ds are
// computed for every element and the mask zeroes both after, in a second
// loop behind one tile-uniform branch; tested element by element inside
// the exponentials' loop, it cost a branch and its reconvergence on every
// element of the tiles that mask nothing, and a reload of the parameters
// it reads, which the register fences' memory clobbers force.  (The
// exponentials, the mask and ds as three loops spilled in the split modes;
// p and ds in one loop do not.)
// Tried and dropped (on an H100, side by side in one process): a ring of 3
// or 4 stages for dq (no change); persistent dq blocks at every shape
// (slower on the long ones, where the hardware's block scheduling balances
// better); the lse/di rows copied by the producer for dq (faster at 77
// keys, slower at the long shapes); a one-time offset of the two
// warpgroups by a named barrier, so that one's softmax would run under the
// other's products (slower); descriptors computed once a tile and advanced
// by constants (no clear gain).
// Traps checked by tests/test_torch_cuda.py and chip_smoke.py's four wrong
// backwards: the MN-major descriptors of K, Q and dO (a mismatch gives wrong
// numbers, not a fault), the mbarrier parity around the ring (a wait that
// never ends traps after about 2^33 clocks instead of hanging), the lse/di
// rows at Sq = 4250 and 77, ragged last tiles on both sides, causal tiles
// cut by the diagonal, and a block whose query loop is empty (causal, keys
// past Sq), which still waits for its K and V copies before it exits.
//
// fp32: exact fp32 cannot use the bf16 tensor cores, so fp32 keeps the
// scalar kernels: the scale is folded into the staged q, which gives both
// s and scale * ds^T q (dQ takes it at the end); p and ds stay fp32 and go
// through shared memory; registers blocked 4 rows x BK/8 keys per thread for
// the scores and 4 rows (or keys) x D/lanes columns for the accumulators.
// Tiles: 64 query rows; 64 keys up to D = 80 and 32 above, so that the fp32
// tiles fit shared memory at D = 160 (dkv: K, V [32][161], Q, dO [64][161],
// P, dS [64][33]: 141 KB).  On the main path fp32 serves only the card's
// fp32 tests and the narrow train reference.  128 threads a block.
//
// The largest dynamic shared memory of each instantiation is set once, at
// its first launch.

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per tile (fp32)
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
// bf16: warp-specialised, TMA-fed wgmma (sm_90a)
// ---------------------------------------------------------------------------

using namespace sdt;

constexpr int kWgRows = 64;         // rows of a consumer warpgroup (wgmma's M)
constexpr int kConsumerWarps = 8;   // two consumer warpgroups
constexpr int kWsThreads = 384;     // + the producer warpgroup
// registers a thread after setmaxnreg, as in flash_fwd.cu: launched at 168,
// 128 * 40 + 256 * 232 = 384 * 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
// dq runs persistent blocks where a query tile has at most this many key
// tiles (launch_dq)
constexpr int kPersistentKeyTiles = 4;
constexpr float kLog2e = 1.4426950408889634f;

// {padded head width DP, dq's key tile BK, dkv's query tile BQ} of each bf16
// instantiation: the one place the tiles are set
constexpr int kBwdTiles[][3] = {{64, 64, 64}, {128, 64, 64}, {192, 32, 32}};

constexpr int bwd_tile(int dp, int which) {
  for (const auto& t : kBwdTiles)
    if (t[0] == dp) return t[which];
  return 0;
}

// How a dkv block shares its keys between the two consumer warpgroups:
//   kKeys128: 128 keys, each warpgroup 64 of them with dK and dV over every
//     query tile;
//   kSplitGrads: 64 keys, warpgroup 0 accumulating dV and warpgroup 1 dK
//     over every query tile (where both accumulators do not fit a thread);
//   kSplitQueries: 64 keys, each warpgroup dK and dV over every other query
//     tile, the two halves summed in shared memory at the end, in a fixed
//     order (where 128-key blocks would leave SMs idle).
constexpr int kKeys128 = 0;
constexpr int kSplitGrads = 1;
constexpr int kSplitQueries = 2;

// Shared memory of a dq block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes, and the descriptors
// assume tiles start on that period): kQBufs buffers of Q and dO (128 rows
// each: this query tile's, and the next one's where two fit), the ring's K
// and V stages, the barriers.  Each tile is kNC atoms, one after the
// other.
template <int DP>
struct DqLayout {
  static constexpr int kNC = DP / kAtomCols;
  static constexpr int kBK = bwd_tile(DP, 1);
  static constexpr int kStages = 2;
  static constexpr int kRows = 2 * kWgRows;                // query rows of a tile
  static constexpr int kQBytes = kNC * kRows * kAtomBytes;  // Q, or dO
  static constexpr int kKVBytes = kNC * kBK * kAtomBytes;   // a stage of K, or of V
  static constexpr int kRing = 2 * kStages * kKVBytes;
  static constexpr int kQBufs = 2 * 2 * kQBytes + kRing + 2048 <= kSmemLimit ? 2 : 1;
  static constexpr int kQ = 0;                              // Q of buffer i at kQ + 2 i kQBytes
  static constexpr int kK = 2 * kQBufs * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // qo_full, qo_empty of each buffer, then k_full, v_full, k_empty, v_empty
  // of each stage
  static constexpr int kBytes = kBar + 8 * (2 * kQBufs + 4 * kStages) + 1024;
  static_assert(kBK == 32 || kBK == 64, "key tile");
  static_assert(kBytes <= kSmemLimit, "shared memory of one block");
};

// Shared memory of a dkv block: K and V of its keys, the ring's Q and dO
// stages, each stage's lse and di rows (fp32 [2][BQ]), with kSplitQueries
// the second warpgroup's partial sums (fp32, one slot a thread), the
// barriers.
template <int DP, int MODE>
struct DkvLayout {
  static constexpr int kNC = DP / kAtomCols;
  static constexpr int kBQ = bwd_tile(DP, 2);
  static constexpr int kStages = 4;
  static constexpr int kKeys = MODE == kKeys128 ? 2 * kWgRows : kWgRows;
  static constexpr int kKVBytes = kNC * kKeys * kAtomBytes;  // K, or V
  static constexpr int kQBytes = kNC * kBQ * kAtomBytes;     // a stage of Q, or of dO
  static constexpr int kStatBytes = 2 * kBQ * 4;             // a stage's lse and di
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kStats = kDO + kStages * kQBytes;
  static constexpr int kPartial = kStats + kStages * kStatBytes;
  static constexpr int kBar =
      kPartial + (MODE == kSplitQueries ? 2 * kNC * 32 * 128 * 4 : 0);
  // kv_full, then q_full, do_full, empty of each stage
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  // consumer warps that read each query tile
  static constexpr int kReaders = MODE == kSplitQueries ? kConsumerWarps / 2 : kConsumerWarps;
  static_assert(kBQ == 32 || kBQ == 64, "query tile");
  static_assert(MODE != kKeys128 || kNC == 1, "128 keys hold both gradients at D <= 64 only");
  static_assert(MODE != kSplitQueries || kNC == 1, "split queries at D <= 64 only");
  static_assert(kBytes <= kSmemLimit, "shared memory of one block");
};

__device__ __forceinline__ void init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the 256 consumer threads (warps 0-7) meet: named barrier 1
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// dQ of query tiles of 128 rows: block x takes tiles x, x + gridDim.x, ...
// of the Sq / 128 * B * H (one each, or several where the grid is one block
// an SM: launch_dq).  Warps 0-7 are two consumer warpgroups of 64 rows each;
// warps 8-11 are the producer warpgroup, of which one thread issues every
// TMA copy (Q and dO of each query tile into the buffer the consumers
// released, then K and V of each key tile through the ring) and the other
// warps only give their registers back.  With two Q/dO buffers a block's
// next query tile lands under this one's products and its epilogue.
template <int D16>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using L = DqLayout<atom_width(D16)>;
  constexpr int BK = L::kBK;
  constexpr int NC = L::kNC;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t bars = base + L::kBar;
  auto q_tile = [&](int buf) { return base + L::kQ + 2u * buf * L::kQBytes; };
  auto qo_full = [&](int buf) { return bars + 8u * buf; };
  auto qo_empty = [&](int buf) { return bars + 8u * (L::kQBufs + buf); };
  const uint32_t ring = bars + 8u * 2 * L::kQBufs;
  auto k_full = [&](int s) { return ring + 8u * s; };
  auto v_full = [&](int s) { return ring + 8u * (S + s); };
  auto k_empty = [&](int s) { return ring + 8u * (2 * S + s); };
  auto v_empty = [&](int s) { return ring + 8u * (3 * S + s); };

  const int n_qt = (p.Sq + L::kRows - 1) / L::kRows;  // query tiles of a (batch, head)
  const int n_items = n_qt * p.B * p.H;
  // key tiles of the query tile at q0
  auto key_tiles = [&](int q0) {
    const int n = (p.Skv + BK - 1) / BK;
    return p.causal ? min(n, (q0 + L::kRows - 1) / BK + 1) : n;
  };
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kQBufs; ++i) {
      mbar_init(qo_full(i), 1);
      mbar_init(qo_empty(i), kConsumerWarps);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer.  A Q/dO buffer is refilled once all 8 consumer warps
    // have run their last product on it, a ring stage once they have
    // released it: V's after s and dp, K's after dQ's product.  The ring
    // runs on across query tiles.
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      int t = 0;  // key tiles issued so far
      for (int item = blockIdx.x, i = 0; item < n_items; item += gridDim.x, ++i) {
        const int bh = item / n_qt;
        const int b = bh / p.H, h = bh - b * p.H;
        const int q0 = (item - bh * n_qt) * L::kRows;
        const int buf = i % L::kQBufs;
        mbar_wait(qo_empty(buf), ((i / L::kQBufs) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(qo_full(buf), 2 * L::kQBytes);
        tma_load_tile<NC>(q_tile(buf), &tq, qo_full(buf), L::kRows, h, q0, b);
        tma_load_tile<NC>(q_tile(buf) + L::kQBytes, &tdo, qo_full(buf), L::kRows, h, q0, b);
        for (int j = 0, n = key_tiles(q0); j < n; ++j, ++t) {
          const int s = t % S;
          const uint32_t parity = ((t / S) & 1) ^ 1;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), L::kKVBytes);
          tma_load_tile<NC>(sK + s * L::kKVBytes, &tk, k_full(s), BK, h, j * BK, b);
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), L::kKVBytes);
          tma_load_tile<NC>(sV + s * L::kKVBytes, &tv, v_full(s), BK, h, j * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. +63 of a query
    // tile; warp w4 of it rows 16 w4 + g and + 8 (hopper.cuh, acc_to_a)
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int g = lane >> 2;
    const int tq4 = lane & 3;
    const float sl2 = p.scale * kLog2e;  // the scale and log2(e) in one multiply
    float dq[NC][32];
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    uint32_t da[BK / 16][4];

    // lse (log2 domain) and di of this thread's rows g and g + 8 of the
    // query tile `item`; rows past Sq read nothing and their dQ is not
    // stored.  The next tile's are loaded before this one's key loop, so
    // that their latency hides under it.
    auto row_stats = [&](int item, float (&lse2)[2], float (&dd)[2]) {
      const int bh = item / n_qt;
      const int row0 = (item - bh * n_qt) * L::kRows + wg * kWgRows + (warp & 3) * 16 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long at = static_cast<long long>(bh) * p.Sq + row;
        lse2[r] = row < p.Sq ? p.lse[at] * kLog2e : 0.f;
        dd[r] = row < p.Sq ? p.di[at] : 0.f;
      }
    };
    float lse2[2], dd[2], next_lse2[2] = {0.f, 0.f}, next_dd[2] = {0.f, 0.f};
    row_stats(blockIdx.x, lse2, dd);

    int t = 0;  // key tiles consumed so far
    for (int item = blockIdx.x, i = 0; item < n_items; item += gridDim.x, ++i) {
      const int bh = item / n_qt;
      const int b = bh / p.H, h = bh - b * p.H;
      const int q0 = (item - bh * n_qt) * L::kRows;
      const int n = key_tiles(q0);
      const int wrow = q0 + wg * kWgRows + (warp & 3) * 16;  // this warp's first row
      const int buf = i % L::kQBufs;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int x = 0; x < 32; ++x) dq[c][x] = 0.f;
      const uint32_t qt = q_tile(buf) + wg * kWgRows * kAtomBytes;
      const uint32_t dot = qt + L::kQBytes;
      if (item + static_cast<int>(gridDim.x) < n_items)
        row_stats(item + gridDim.x, next_lse2, next_dd);
      mbar_wait(qo_full(buf), (i / L::kQBufs) & 1);

      for (int j = 0; j < n; ++j, ++t) {
        const int st = t % S;
        const uint32_t parity = (t / S) & 1;
        const uint32_t k_tile = sK + st * L::kKVBytes;

        // s = q k^T and dp = dO v^T (fp32), then release V's stage, and
        // after the last key tile the Q/dO buffer
        mbar_wait(k_full(st), parity);
        mbar_wait(v_full(st), parity);
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
        kmajor_product<D16, BK, L::kRows>(s, qt, k_tile);
        kmajor_product<D16, BK, L::kRows>(dp, dot, sV + st * L::kKVBytes);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);
        reg_fence(dp);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(v_empty(st));
          if (j == n - 1) mbar_arrive(qo_empty(buf));
        }

        // ds = scale p (dp - di) kept in s, then ds = 0 for keys past Skv and
        // past the diagonal (a tile-uniform branch: most tiles mask nothing),
        // then rounded to bf16 A fragments
        const int k0 = j * BK;
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int r = (x >> 1) & 1;
          s[x] = p.scale * exp2_approx(fmaf(s[x], sl2, -lse2[r])) * (dp[x] - dd[r]);
        }
        if (k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > wrow)) {
#pragma unroll
          for (int x = 0; x < BK / 2; ++x) {
            const int key = k0 + (x >> 2) * 8 + tq4 * 2 + (x & 1);
            if (key >= p.Skv || (p.causal && key > wrow + g + 8 * ((x >> 1) & 1))) s[x] = 0.f;
          }
        }
        acc_to_a<BK>(s, da);

        // dQ += bf16(ds) k with K's rows the k16 steps (read MN-major), then
        // release K's stage
        reg_fence(dq);
        reg_fence(da);
        wgmma_fence();
        mnmajor_product<NC, BK>(dq, da, k_tile);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dq);
        reg_fence(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty(st));
      }
      store_acc_bf16<NC>(static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss, wrow,
                         p.Sq, p.D, dq);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = next_lse2[r];
        dd[r] = next_dd[r];
      }
    }
  }
}

// One consumer warpgroup of a dkv block over its query tiles: s^T = K Q^T
// and (DK) dp^T = V dO^T for its 64 keys, p^T and ds^T in registers, then
// dV += bf16(p^T) dO (DV) and dK += bf16(ds^T) Q (DK).  kw: its first key;
// krow: their first row in the block's K and V tiles; the block's query
// tiles are qt_first .. qt_first + n - 1 (BQ rows each), of which it takes
// j0, j0 + step, ...  Returns with dk and dv summed over them.
template <int D16, int MODE, bool DV, bool DK>
__device__ __forceinline__ void dkv_consume(const BwdParams& p, uint32_t base,
                                            const float* stats, int kw, int krow, int qt_first,
                                            int n, int j0, int step,
                                            float (&dk)[DK ? atom_width(D16) / kAtomCols : 1][32],
                                            float (&dv)[DV ? atom_width(D16) / kAtomCols : 1][32]) {
  using L = DkvLayout<atom_width(D16), MODE>;
  constexpr int BQ = L::kBQ;
  constexpr int NC = L::kNC;
  constexpr int S = L::kStages;
  const uint32_t kv_full = base + L::kBar;
  auto q_full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto do_full = [&](int s) { return kv_full + 8u * (1 + S + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + 2 * S + s); };
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq4 = lane & 3;
  const int wkey = kw + (warp & 3) * 16;  // this warp's first key
  const float sl2 = p.scale * kLog2e;
  const uint32_t k_tile = base + L::kK + krow * kAtomBytes;
  const uint32_t v_tile = base + L::kV + krow * kAtomBytes;

  if constexpr (DV)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[c][i] = 0.f;
  if constexpr (DK)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] = 0.f;
  float s[BQ / 2], dp[DK ? BQ / 2 : 1];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DK ? BQ / 2 : 1); ++i) dp[i] = 0.f;
  uint32_t pa[DV ? BQ / 16 : 1][4], da[DK ? BQ / 16 : 1][4];

  mbar_wait(kv_full, 0);
  for (int j = j0; j < n; j += step) {
    const int st = j % S;
    const uint32_t parity = (j / S) & 1;
    const int q0 = (qt_first + j) * BQ;
    const uint32_t q_tile = base + L::kQ + st * L::kQBytes;
    const uint32_t do_tile = base + L::kDO + st * L::kQBytes;

    // s^T = k q^T and dp^T = v dO^T (fp32)
    mbar_wait(q_full(st), parity);
    if constexpr (DK) mbar_wait(do_full(st), parity);
    reg_fence(s);
    if constexpr (DK) reg_fence(dp);
    wgmma_fence();
    kmajor_product<D16, BQ, L::kKeys>(s, k_tile, q_tile);
    if constexpr (DK) kmajor_product<D16, BQ, L::kKeys>(dp, v_tile, do_tile);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    if constexpr (DK) reg_fence(dp);

    // p^T (kept in s) and ds^T = scale p^T (dp^T - di) (kept in dp), then
    // both 0 for query rows past Sq, keys past Skv and past the diagonal (a
    // tile-uniform branch: most tiles mask nothing).  The columns are query
    // rows: lse and di come from the stage.
    const float* lse_s = stats + st * 2 * BQ;
    const float* di_s = lse_s + BQ;
#pragma unroll
    for (int jn = 0; jn < BQ / 8; ++jn) {
      const int c = jn * 8 + tq4 * 2;  // this thread's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      float2 d2 = make_float2(0.f, 0.f);
      if constexpr (DK) d2 = *reinterpret_cast<const float2*>(di_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e;
        const float pe = exp2_approx(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x) * kLog2e));
        s[i] = pe;
        if constexpr (DK) dp[i] = p.scale * pe * (dp[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
    if (q0 + BQ > p.Sq || wkey + 16 > p.Skv || (p.causal && q0 < wkey + 15)) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int query = q0 + (i >> 2) * 8 + tq4 * 2 + (i & 1);
        const int key = wkey + g + 8 * ((i >> 1) & 1);
        if (query >= p.Sq || key >= p.Skv || (p.causal && key > query)) {
          s[i] = 0.f;
          if constexpr (DK) dp[i] = 0.f;
        }
      }
    }
    if constexpr (DV) acc_to_a<BQ>(s, pa);
    if constexpr (DK) acc_to_a<BQ>(dp, da);

    // dV += bf16(p^T) dO, dK += bf16(ds^T) q with dO's and Q's rows the k16
    // steps (read MN-major), then release the stage
    if constexpr (!DK) mbar_wait(do_full(st), parity);
    if constexpr (DV) {
      reg_fence(dv);
      reg_fence(pa);
    }
    if constexpr (DK) {
      reg_fence(dk);
      reg_fence(da);
    }
    wgmma_fence();
    if constexpr (DV) mnmajor_product<NC, BQ>(dv, pa, do_tile);
    if constexpr (DK) mnmajor_product<NC, BQ>(dk, da, q_tile);
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (DV) {
      reg_fence(dv);
      reg_fence(pa);
    }
    if constexpr (DK) {
      reg_fence(dk);
      reg_fence(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
}

// dK and dV of the keys of one (batch, head) (DkvLayout's MODE: 128 keys,
// or 64), over the query tiles; warps as in the dq kernel.  The producer
// warp loads K and V once, then for each query tile Q and dO by TMA (lane
// 0) and the tile's lse and di rows by 4-byte cp.async (every lane).
template <int D16, int MODE>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using L = DkvLayout<atom_width(D16), MODE>;
  constexpr int BQ = L::kBQ;
  constexpr int NC = L::kNC;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));  // generic address of base
  const float* stats = reinterpret_cast<const float*>(gbase + L::kStats);
  const uint32_t kv_full = base + L::kBar;
  auto q_full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto do_full = [&](int s) { return kv_full + 8u * (1 + S + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + 2 * S + s); };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * L::kKeys;
  // causal: query rows below k0 see no key of this block
  const int qt_first = p.causal ? k0 / BQ : 0;
  const int n = max((p.Sq + BQ - 1) / BQ - qt_first, 0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(q_full(s), 1 + 32);  // lane 0's expect_tx, every lane's cp.async
      mbar_init(do_full(s), 1);
      mbar_init(empty(s), L::kReaders);
    }
    init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer.  A stage is refilled once every consumer warp that
    // reads it has released it.
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tdo);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
        tma_load_tile<NC>(base + L::kK, &tk, kv_full, L::kKeys, h, k0, b);
        tma_load_tile<NC>(base + L::kV, &tv, kv_full, L::kKeys, h, k0, b);
      }
      const float* lse_g = p.lse + static_cast<long long>(blockIdx.y) * p.Sq;
      const float* di_g = p.di + static_cast<long long>(blockIdx.y) * p.Sq;
      for (int j = 0; j < n; ++j) {
        const int s = j % S;
        const uint32_t parity = ((j / S) & 1) ^ 1;  // round 0 passes at once
        const int q0 = (qt_first + j) * BQ;
        mbar_wait(empty(s), parity);
        if (lane == 0) {
          mbar_expect_tx(q_full(s), L::kQBytes);
          tma_load_tile<NC>(base + L::kQ + s * L::kQBytes, &tq, q_full(s), BQ, h, q0, b);
        }
        // rows past Sq are zero-filled and read nothing
        const uint32_t row_stats = base + L::kStats + s * L::kStatBytes;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < p.Sq;
          cp_async4(row_stats + 4 * r, ok ? lse_g + q0 + r : lse_g, ok);
          cp_async4(row_stats + 4 * (BQ + r), ok ? di_g + q0 + r : di_g, ok);
        }
        mbar_arrive_cp_async(q_full(s));
        if (lane == 0) {
          mbar_expect_tx(do_full(s), L::kQBytes);
          tma_load_tile<NC>(base + L::kDO + s * L::kQBytes, &tdo, do_full(s), BQ, h, q0, b);
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    bf16* const dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
    bf16* const dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
    const int wkey = k0 + (MODE == kKeys128 ? wg * kWgRows : 0) + (warp & 3) * 16;
    if constexpr (MODE == kKeys128) {
      float dk[NC][32], dv[NC][32];
      dkv_consume<D16, MODE, true, true>(p, base, stats, k0 + wg * kWgRows, wg * kWgRows,
                                         qt_first, n, 0, 1, dk, dv);
      store_acc_bf16<NC>(dkg, p.dk_ss, wkey, p.Skv, p.D, dk);
      store_acc_bf16<NC>(dvg, p.dv_ss, wkey, p.Skv, p.D, dv);
    } else if constexpr (MODE == kSplitGrads) {
      float acc[NC][32], none[1][32];
      if (wg == 0) {
        dkv_consume<D16, MODE, true, false>(p, base, stats, k0, 0, qt_first, n, 0, 1, none, acc);
        store_acc_bf16<NC>(dvg, p.dv_ss, wkey, p.Skv, p.D, acc);
      } else {
        dkv_consume<D16, MODE, false, true>(p, base, stats, k0, 0, qt_first, n, 0, 1, acc, none);
        store_acc_bf16<NC>(dkg, p.dk_ss, wkey, p.Skv, p.D, acc);
      }
    } else {
      // every other query tile; the second warpgroup's sums go through
      // shared memory (slot x of thread t at x * 128 + t: both warpgroups
      // hold the same elements in the same registers) and the first adds
      // them to its own, so the order of the sum is fixed
      float dk[NC][32], dv[NC][32];
      dkv_consume<D16, MODE, true, true>(p, base, stats, k0, 0, qt_first, n, wg, 2, dk, dv);
      float* partial = reinterpret_cast<float*>(gbase + L::kPartial);
      const int tid = threadIdx.x & 127;
      if (wg == 1) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            partial[((2 * c) * 32 + x) * 128 + tid] = dk[c][x];
            partial[((2 * c + 1) * 32 + x) * 128 + tid] = dv[c][x];
          }
      }
      consumers_sync();
      if (wg == 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            dk[c][x] += partial[((2 * c) * 32 + x) * 128 + tid];
            dv[c][x] += partial[((2 * c + 1) * 32 + x) * 128 + tid];
          }
        store_acc_bf16<NC>(dkg, p.dk_ss, wkey, p.Skv, p.D, dk);
        store_acc_bf16<NC>(dvg, p.dv_ss, wkey, p.Skv, p.D, dv);
      }
    }
  }
}

template <int D16>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  using L = DqLayout<atom_width(D16)>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_map(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, L::kRows) ||
      !encode_map(&tdo, p.dout, p.D, p.H, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb, L::kRows) ||
      !encode_map(&tk, p.k, p.D, p.H, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, L::kBK) ||
      !encode_map(&tv, p.v, p.D, p.H, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, L::kBK))
    return cudaErrorInvalidValue;
  // a block a query tile; where a tile has few key tiles (cross-attention's
  // 77 keys), whose products cannot hide a block's start and its copies, one
  // persistent block an SM (a block takes the SM's registers) that takes
  // tile after tile, the next one's copies under this one's work
  const long long items =
      static_cast<long long>((p.Sq + L::kRows - 1) / L::kRows) * p.B * p.H;
  const bool persistent = (p.Skv + L::kBK - 1) / L::kBK <= kPersistentKeyTiles;
  const int grid = persistent && items > sm_count() ? sm_count() : static_cast<int>(items);
  flash_bwd_dq_wgmma_kernel<D16><<<grid, kWsThreads, L::kBytes, stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

template <int D16, int MODE>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  using L = DkvLayout<atom_width(D16), MODE>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D16, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_map(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, L::kBQ) ||
      !encode_map(&tdo, p.dout, p.D, p.H, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb, L::kBQ) ||
      !encode_map(&tk, p.k, p.D, p.H, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, L::kKeys) ||
      !encode_map(&tv, p.v, p.D, p.H, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, L::kKeys))
    return cudaErrorInvalidValue;
  const dim3 grid((p.Skv + L::kKeys - 1) / L::kKeys, p.B * p.H);
  flash_bwd_dkv_wgmma_kernel<D16, MODE>
      <<<grid, kWsThreads, L::kBytes, stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

// dkv's mode: above 64 head columns both accumulators of 64 keys do not fit
// a thread, so the gradients split; at 64 and below 128-key blocks, unless
// they would leave SMs idle, where 64-key blocks split the query tiles
template <int D16>
cudaError_t launch_dkv_any(const BwdParams& p, cudaStream_t stream) {
  if constexpr (atom_width(D16) > kAtomCols) {
    return launch_dkv<D16, kSplitGrads>(p, stream);
  } else {
    const long long blocks =
        (p.Skv + 2 * kWgRows - 1) / (2 * kWgRows) * static_cast<long long>(p.B) * p.H;
    return blocks < sm_count() ? launch_dkv<D16, kSplitQueries>(p, stream)
                               : launch_dkv<D16, kKeys128>(p, stream);
  }
}

template <bool kDKV, int D16>
cudaError_t launch_bf16(const BwdParams& p, cudaStream_t stream) {
  if constexpr (kDKV)
    return launch_dkv_any<D16>(p, stream);
  else
    return launch_dq<D16>(p, stream);
}

template <bool kDKV>
cudaError_t dispatch_bf16(const BwdParams& p, cudaStream_t stream) {
  // one instantiation for each number of k16 steps over the head dims
  switch ((p.D + 15) / 16) {
    case 1: return launch_bf16<kDKV, 16>(p, stream);
    case 2: return launch_bf16<kDKV, 32>(p, stream);
    case 3: return launch_bf16<kDKV, 48>(p, stream);
    case 4: return launch_bf16<kDKV, 64>(p, stream);
    case 5: return launch_bf16<kDKV, 80>(p, stream);
    case 6: return launch_bf16<kDKV, 96>(p, stream);
    case 7: return launch_bf16<kDKV, 112>(p, stream);
    case 8: return launch_bf16<kDKV, 128>(p, stream);
    case 9: return launch_bf16<kDKV, 144>(p, stream);
    default: return launch_bf16<kDKV, 160>(p, stream);
  }
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
