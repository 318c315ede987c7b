// flash_bwd: the attention backward.  Given q, k, v, the output gradient dO,
// the forward's log-sum-exp `lse` [B, H, Sq] and di = rowsum(O * dO) [B, H, Sq]
// (both fp32), it computes dQ, dK and dV of softmax(q k^T * scale) v, for head
// dims that are multiples of 8 up to 160, fp32 or bf16 in and out, fp32
// inside.  Two kernels, neither with atomics, so results are deterministic:
//
//   flash_bwd_dkv  grid (key tile, B*H): keeps fp32 dK and dV of its key tile
//                  and loops over the query tiles.
//   flash_bwd_dq   grid (query tile, B*H): keeps fp32 dQ of its query tile
//                  and loops over the key tiles.
//
// Both recompute, for each (query tile, key tile) pair,
//   s  = scale * q k^T,   p = exp(s - lse),
//   dp = dO v^T,          ds = p * (dp - di),
// and then accumulate dV += p^T dO, dK += scale * ds^T q (dkv) or
// dQ += scale * ds k (dq).  The scale is folded into the staged q once, which
// gives both s and scale * ds^T q; dQ takes it at the end.
//
// Replaces: the two backward Pallas kernels of the TPU library flash kernel
// that stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) calls,
// _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
// flash_attention.py:941, kernel :796) and _flash_attention_bwd_dq (:1287,
// kernel :1146).  The TPU kernels take the row statistics l and m
// lane-broadcast to 128 and round p and ds to the input type before their
// products; here one fp32 lse per row does, and p and ds stay fp32.  As in the
// forward (flash_fwd.cu), ragged ends are masked in the kernel and the inputs
// are read by stride in their [B, S, H, D] layout: query rows past Sq are
// zero-filled and never read their lse, keys past Skv get p = 0, and causal
// calls skip tiles wholly above the diagonal.
//
// What bounds it on an H100: the pair does 14*B*H*Sq*Skv*D operations (s and
// dp are recomputed by both kernels; 10 would be the least) on a few MB of
// input, so at the UNet's S=4096 it is bound by arithmetic.  This first
// version does that arithmetic as scalar fp32 FMAs out of shared memory, as
// the forward does; tensor cores and cp.async/TMA staging are later work.
// What the design does about the bound: no [Sq, Skv] tensor ever reaches
// device memory, and the registers are blocked 4 rows x BK/8 keys per thread
// for the scores and 4 rows (or keys) x D/lanes columns for the accumulators.
//
// Tiles: 64 query rows; 64 keys up to D = 80 and 32 keys above, so that the
// fp32 tiles fit the 227 KB of shared memory at D = 160 (dkv: K, V [32][161],
// Q, dO [64][161], P, dS [64][33]: 141 KB) and the accumulators fit the
// registers (dkv at D = 160: 2 x 4 x 10 per thread).  Block: 128 threads.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;      // query rows per thread in the score tile

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

template <typename T, int MAXD>
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
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_g = p.lse + static_cast<long long>(blockIdx.y) * p.Sq;
  const float* di_g = p.di + static_cast<long long>(blockIdx.y) * p.Sq;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cl = tid & 7;
  const int kg = tid / kLanes;  // keys kg*4 .. kg*4+3 of the tile
  const int ln = tid - kg * kLanes;

  const int kvalid = min(BK, p.Skv - k0);
  sdt::stage_rows(Ks, ld,
                  static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                      static_cast<long long>(k0) * p.k_ss,
                  p.k_ss, BK, kvalid, D, 1.f);
  sdt::stage_rows(Vs, ld,
                  static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
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

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
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

template <typename T, int MAXD>
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
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cl = tid & 7;

  sdt::stage_rows(Qs, ld,
                  static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                      static_cast<long long>(q0) * p.q_ss,
                  p.q_ss, kBQ, qvalid, D, p.scale);
  sdt::stage_rows(dOs, ld,
                  static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
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

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
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

template <typename T, int MAXD, bool kDKV>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr int BK = key_tile(MAXD);
  // both kernels: Q, dO [kBQ][D+1], K, V [BK][D+1], lse and di [kBQ]; dkv
  // stages P and dS [kBQ][BK+1], dq only dS
  const size_t smem =
      sizeof(float) * (2 * (kBQ + BK) * (p.D + 1) +
                       (kDKV ? 2 : 1) * kBQ * (BK + 1) + 2 * kBQ);
  void (*kernel)(const BwdParams) =
      kDKV ? flash_bwd_dkv_kernel<T, MAXD> : flash_bwd_dq_kernel<T, MAXD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(kDKV ? (p.Skv + BK - 1) / BK : (p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kDKV>
cudaError_t dispatch(const BwdParams& p, cudaStream_t stream) {
  // the forward's buckets: exact for the main path's 40/80/160
  if (p.D <= 16) return launch<T, 16, kDKV>(p, stream);
  if (p.D <= 32) return launch<T, 32, kDKV>(p, stream);
  if (p.D <= 40) return launch<T, 40, kDKV>(p, stream);
  if (p.D <= 64) return launch<T, 64, kDKV>(p, stream);
  if (p.D <= 80) return launch<T, 80, kDKV>(p, stream);
  if (p.D <= 96) return launch<T, 96, kDKV>(p, stream);
  if (p.D <= 128) return launch<T, 128, kDKV>(p, stream);
  return launch<T, 160, kDKV>(p, stream);
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
  const cudaError_t err = dtype == 0 ? dispatch<float, kDKV>(p, s)
                                     : dispatch<__nv_bfloat16, kDKV>(p, s);
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
