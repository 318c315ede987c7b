// flash_fwd: exact attention forward, softmax(q k^T * scale) v, for head dims
// that are multiples of 8 up to 160, in fp32 or bf16 with fp32 accumulation.
//
// Replaces: the TPU library flash kernel that
// stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) calls, forward
// only.  The TPU wrapper zero-pads ragged sequences to a 256/512 grid and
// keeps the padding out with segment ids; here the ragged ends of Sq and Skv
// are masked inside the kernel, and q/k/v are read by stride in their
// [B, S, H, D] layout, so there are no transposes and no padding copies.
//
// What bounds it on an H100: at the SD1.5 UNet shapes (S=4096, D=40) the
// work is 4*B*H*Sq*Skv*D operations on a few MB of input, far above the
// card's ridge point, so it is bound by arithmetic.  This first version does
// that arithmetic as scalar fp32 FMAs out of shared memory (67 TFLOP/s peak,
// not the 989 TFLOP/s of the bf16 tensor cores): it is right and simple, and
// moving the two products onto mma.sync / wgmma is later work.  What the
// design does about the bound: it never writes the [Sq, Skv] logits to device
// memory (online softmax, one pass over K/V per 64-row query tile), blocks
// the registers 4 rows x 4 keys per thread for the logits and 4 rows x D/8
// columns for the accumulator, and skips key tiles past the diagonal when
// causal.
//
// Grid: (ceil(Sq / 64), B * H), all blocks independent.  The TPU kernel's
// sequential key-block grid axis becomes the loop over key tiles inside the
// block.  Block: 128 threads.  Thread t owns query rows 4*(t/8) .. +3 and,
// within a key tile, keys (t%8) + 8*j; the 8 threads of a row group sit in
// consecutive lanes, so row max and row sum are warp shuffles.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / 8;   // keys per thread per tile

struct FwdParams {
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
  int causal;
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdParams p) {
  constexpr int kDPT = MAXD / 8;  // accumulator columns per thread
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;  // odd row stride: conflict-free column reads
  float* Qs = smem;
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ps = Vs + kBK * ld;  // [kBQ][kBK + 1]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kBQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                static_cast<long long>(q0) * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
          static_cast<long long>(q0) * p.o_ss;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg*4 .. rg*4+3
  const int cl = tid & 7;   // lane within the row group

  // the scale is folded into Q once
  sdt::stage_rows(Qs, ld, qg, p.q_ss, kBQ, min(kBQ, p.Sq - q0), D, p.scale);

  float m[kRows], l[kRows], acc[kRows][kDPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = sdt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kDPT; ++jj) acc[i][jj] = 0.f;
  }

  int n_tiles = (p.Skv + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    const int kvalid = min(kBK, p.Skv - k0);
    sdt::stage_rows(Ks, ld, kg + static_cast<long long>(k0) * p.k_ss, p.k_ss,
                    kBK, kvalid, D, 1.f);
    sdt::stage_rows(Vs, ld, vg + static_cast<long long>(k0) * p.v_ss, p.v_ss,
                    kBK, kvalid, D, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;

    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(rg * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(cl + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + rg * kRows + i;
      float mx = sdt::kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + cl + 8 * j;
        if (kj >= p.Skv || (p.causal && kj > qi)) s[i][j] = sdt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = __expf(s[i][j] - m_new);
        s[i][j] = e;
        rs += e;
      }
      rs = group8_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Ps[(rg * kRows + i) * (kBK + 1) + cl + 8 * j] = s[i][j];
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(rg * kRows + i) * (kBK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = cl + 8 * jj;
        if (d < D) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg * kRows + i;
    if (q0 + r < p.Sq) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = cl + 8 * jj;
        if (d < D) sdt::store1(og + r * p.o_ss + d, acc[i][jj] * inv);
      }
    }
  }
}

template <typename T, int MAXD>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + 2 * kBK) * (p.D + 1) + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<T, MAXD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FwdParams& p, cudaStream_t stream) {
  // smallest bucket that holds D; exact buckets for the main path's 40/80/160
  if (p.D <= 16) return launch<T, 16>(p, stream);
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 40) return launch<T, 40>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 80) return launch<T, 80>(p, stream);
  if (p.D <= 96) return launch<T, 96>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return launch<T, 160>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every tensor is contiguous.  Returns the launch's cudaError_t.
extern "C" int sdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, int dtype, int B, int H, int Sq, int Skv,
                             int D, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, long long o_sb, long long o_ss,
                             long long o_sh, float scale, int causal,
                             void* stream) {
  if (D <= 0 || D > 160 || D % 8 != 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams p{q,    k,    v,    o,    B,    H,    Sq,   Skv,
                    D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                    v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, s)
                                     : dispatch<__nv_bfloat16>(p, s);
  return static_cast<int>(err);
}
