// flash_stream: online-softmax attention forward for wide heads, D > 160 and
// a multiple of 8, up to 1024, in fp32 or bf16 with fp32 accumulation.  On
// the main path it takes the VAE mid-block's single 512-wide head.
//
// Replaces: stablediffusion_tpu/ops/flash_attention.py:145-207
// (flash_attention_streaming; kernel body _flash_stream_kernel :67-127).  It
// keeps that kernel's semantics: fp32 running max, denominator and
// accumulator, keys past Skv masked to -1e30, no mask argument, forward only.
// The TPU version pads q and kv to its block grid and slices the result back;
// here the ragged ends are masked in the kernel and q/k/v are read by stride.
// Its _VMEM_BUDGET and 128-lane scratch are TPU artifacts and do not carry
// over.
//
// What bounds it on an H100: the 512-wide head.  Q k^T contracts over all
// 512, and a bq x 512 fp32 accumulator does not fit one thread's registers,
// nor a block's at bq >= 64.  The work (4*Sq*Skv*D operations against a few
// MB of input) is bound by arithmetic, done here as scalar fp32 FMAs
// (67 TFLOP/s peak): right and simple first; tensor-core products are later
// work.  What the design does about the width: tiles are sized from the
// 227 KB shared-memory budget.  A block takes 16 query rows and walks the
// keys in tiles of 32 (16 for D > 512); Q, K and V tiles are staged in
// shared memory as fp32 (166 KB at D = 512), and the 16 x D accumulator is
// spread over the block's 256 threads, each holding 16 rows x D/256 columns
// in registers.
//
// Grid: (ceil(Sq / 16), B * H), blocks independent; the TPU's sequential
// key-block grid axis is the loop over key tiles inside the block.

#include "common.cuh"

namespace {

constexpr int kBQ = 16;  // query rows per block
constexpr int kThreads = 256;

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

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int MAXD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_stream_kernel(const StreamParams p) {
  constexpr int kDPT = MAXD / kThreads;  // accumulator columns per thread
  constexpr int kKPT = BK / 16;          // keys per thread per tile
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;                 // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;        // [BK][ld]
  float* Vs = Ks + BK * ld;         // [BK][ld]
  float* Ps = Vs + BK * ld;         // [kBQ][BK + 1]
  float* alpha_s = Ps + kBQ * (BK + 1);  // [kBQ]
  float* l_s = alpha_s + kBQ;            // [kBQ]

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
  const int r = tid >> 4;     // the query row this thread scores
  const int lane = tid & 15;  // its lane within that row's 16 threads

  sdt::stage_rows(Qs, ld, qg, p.q_ss, kBQ, min(kBQ, p.Sq - q0), D, p.scale);

  float m = sdt::kNegInf, l = 0.f;  // row r's running max and denominator
  float acc[kBQ][kDPT];             // rows 0..15 x columns tid + 256*jj
#pragma unroll
  for (int i = 0; i < kBQ; ++i)
#pragma unroll
    for (int jj = 0; jj < kDPT; ++jj) acc[i][jj] = 0.f;

  const int n_tiles = (p.Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    const int kvalid = min(BK, p.Skv - k0);
    sdt::stage_rows(Ks, ld, kg + static_cast<long long>(k0) * p.k_ss, p.k_ss,
                    BK, kvalid, D, 1.f);
    sdt::stage_rows(Vs, ld, vg + static_cast<long long>(k0) * p.v_ss, p.v_ss,
                    BK, kvalid, D, 1.f);
    __syncthreads();

    float s[kKPT];
#pragma unroll
    for (int j = 0; j < kKPT; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * ld + d];
#pragma unroll
      for (int j = 0; j < kKPT; ++j)
        s[j] = fmaf(qv, Ks[(lane + 16 * j) * ld + d], s[j]);
    }

    float mx = sdt::kNegInf;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      if (k0 + lane + 16 * j >= p.Skv) s[j] = sdt::kNegInf;  // kv tail
      mx = fmaxf(mx, s[j]);
    }
    mx = group16_max(mx);
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      s[j] = __expf(s[j] - m_new);
      rs += s[j];
    }
    rs = group16_sum(rs);
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) Ps[r * (BK + 1) + lane + 16 * j] = s[j];
    if (lane == 0) alpha_s[r] = alpha;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kBQ; ++i) {
      const float a = alpha_s[i];
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) acc[i][jj] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      float vv[kDPT];
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = tid + kThreads * jj;
        vv[jj] = d < D ? Vs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBQ; ++i) {
        const float pv = Ps[i * (BK + 1) + c];
#pragma unroll
        for (int jj = 0; jj < kDPT; ++jj) acc[i][jj] = fmaf(pv, vv[jj], acc[i][jj]);
      }
    }
  }

  __syncthreads();
  if (lane == 0) l_s[r] = l;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kBQ; ++i) {
    if (q0 + i < p.Sq) {
      const float inv = 1.f / l_s[i];
#pragma unroll
      for (int jj = 0; jj < kDPT; ++jj) {
        const int d = tid + kThreads * jj;
        if (d < D) sdt::store1(og + i * p.o_ss + d, acc[i][jj] * inv);
      }
    }
  }
}

template <typename T, int MAXD, int BK>
cudaError_t launch(const StreamParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + 2 * BK) * (p.D + 1) +
                                       kBQ * (BK + 1) + 2 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_stream_kernel<T, MAXD, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_stream_kernel<T, MAXD, BK><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const StreamParams& p, cudaStream_t stream) {
  if (p.D <= 256) return launch<T, 256, 32>(p, stream);
  if (p.D <= 512) return launch<T, 512, 32>(p, stream);
  return launch<T, 1024, 16>(p, stream);  // 16-key tiles keep K/V in 227 KB
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every tensor is contiguous.  Returns the launch's cudaError_t.
extern "C" int sdt_flash_stream(const void* q, const void* k, const void* v,
                                void* o, int dtype, int B, int H, int Sq,
                                int Skv, int D, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, long long o_sb, long long o_ss,
                                long long o_sh, float scale, void* stream) {
  if (D <= 160 || D > 1024 || D % 8 != 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamParams p{q,    k,    v,    o,    B,    H,    Sq,   Skv,
                       D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, o_sb, o_ss, o_sh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, s)
                                     : dispatch<__nv_bfloat16>(p, s);
  return static_cast<int>(err);
}
