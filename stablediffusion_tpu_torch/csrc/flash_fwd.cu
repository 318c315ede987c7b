// flash_fwd: exact attention forward, softmax(q k^T * scale) v, for head dims
// that are multiples of 8 up to 160, in bf16 (tensor cores) or fp32 (scalar
// FMAs), with fp32 accumulation.
//
// Replaces: the TPU library flash kernel that
// stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) calls, forward
// only (jax/experimental/pallas/ops/tpu/flash_attention.py:589, kernel body
// :342).  The TPU wrapper zero-pads ragged sequences to a 256/512 grid and
// keeps the padding out with segment ids; here the ragged ends of Sq and Skv
// are masked inside the kernel, and q/k/v are read by stride in their
// [B, S, H, D] layout, so there are no transposes and no padding copies.
//
// What bounds it on an H100: at the SD1.5 UNet shapes (S=4096, D=40) the
// work is 4*B*H*Sq*Skv*D operations on a few MB of input, far above the
// card's ridge point, so it is bound by arithmetic: the two products on the
// bf16 tensor cores (989 TFLOP/s) and, at D=40, the Sq*Skv exponentials on
// the SFUs (16 a clock per SM), which take longer than the products there.
// Neither kernel writes the [Sq, Skv] logits to device memory (online
// softmax, one pass over K/V per 64-row query tile), and both skip key tiles
// past the diagonal when causal.
//
// bf16: FlashAttention-2 on mma.sync.  A block of 4 warps owns 64 query
// rows, a warp 16 of them, so the row max and row sum are shuffles within a
// quad of lanes.  Q is loaded once with ldmatrix and kept in registers as
// A fragments; K/V tiles of 64 keys are double-buffered in shared memory by
// cp.async (16-byte chunks), so the copy of tile j+1 runs under the products
// of tile j.  s = q.k^T accumulates in fp32 (m16n8k16, bf16 in); the scale
// and log2(e) go on the fp32 accumulator in one multiply, and exp2 gives p.
// p is rounded to bf16 straight out of the S accumulator registers (the C
// fragments of two adjacent n8 tiles are the A fragment of one k16 step) and
// multiplied with V, loaded by ldmatrix.trans, as the JAX kernel does
// (`p.astype(v.dtype)`, flash_attention.py:471); the row sum l takes the
// fp32 p.  Shared rows are DP + 8 elements long (DP = D rounded up to 16):
// the row stride in 16-byte units is odd, so the 8 row addresses of each
// ldmatrix hit 8 distinct bank groups.  Columns D..DP-1, keys past Skv and
// query rows past Sq are zero-filled by cp.async (source size 0): the k16
// steps read zeros, and no stale bits reach a product (0 * NaN).
//
// fp32: exact fp32 cannot use the bf16 tensor cores, so fp32 keeps the
// scalar kernel: 4 rows x 4 keys per thread for the logits and 4 rows x D/8
// columns for the accumulator, tiles staged in shared memory as fp32.  It
// runs within 6% of SDPA in fp32 (PERF.md); on the main path it serves only
// CLIP's causal [1, 77, 12, 64].
//
// With a non-null `lse` both write each row's log-sum-exp of the scaled
// logits, fp32 [B, H, Sq]: the running max plus the log of the denominator.
// The TPU kernel keeps the same two numbers (l, m) lane-broadcast to 128 for
// its backward; flash_bwd.cu reads this one array instead.  A row whose keys
// are all masked still gets a finite value (-1e30 + log of the count).
//
// Grid: (ceil(Sq / 64), B * H), all blocks independent.  The TPU kernel's
// sequential key-block grid axis becomes the loop over key tiles inside the
// block.  Block: 128 threads.  The largest dynamic shared memory of each
// instantiation is set once, at its first launch.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block (both kernels)
constexpr int kThreads = 128;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] or null
  int B, H, Sq, Skv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kBK = 32;          // keys per tile
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / 8;   // keys per thread per tile

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

// Thread t owns query rows 4*(t/8) .. +3 and, within a key tile, keys
// (t%8) + 8*j; the 8 threads of a row group sit in consecutive lanes.
template <int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const FwdParams p) {
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                    static_cast<long long>(q0) * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
              static_cast<long long>(q0) * p.o_ss;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg*4 .. rg*4+3
  const int cl = tid & 7;   // lane within the row group

  // the scale is folded into Q once (exact enough in fp32)
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
        if (d < D) og[r * p.o_ss + d] = acc[i][jj] * inv;
      }
      if (p.lse != nullptr && cl == 0)
        p.lse[static_cast<long long>(blockIdx.y) * p.Sq + q0 + r] = m[i] + logf(l[i]);
    }
  }
}

template <int MAXD>
cudaError_t launch_f32(const FwdParams& p, cudaStream_t stream) {
  constexpr int kMaxSmem = sizeof(float) * ((kBQ + 2 * kBK) * (MAXD + 1) + kBQ * (kBK + 1));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem =
      sizeof(float) * ((kBQ + 2 * kBK) * (p.D + 1) + kBQ * (kBK + 1));
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_f32_kernel<MAXD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const FwdParams& p, cudaStream_t stream) {
  // smallest bucket that holds D; exact buckets for the main path's 40/80/160
  if (p.D <= 16) return launch_f32<16>(p, stream);
  if (p.D <= 32) return launch_f32<32>(p, stream);
  if (p.D <= 40) return launch_f32<40>(p, stream);
  if (p.D <= 64) return launch_f32<64>(p, stream);
  if (p.D <= 80) return launch_f32<80>(p, stream);
  if (p.D <= 96) return launch_f32<96>(p, stream);
  if (p.D <= 128) return launch_f32<128>(p, stream);
  return launch_f32<160>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;                    // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the -1e30 mask in the log2 domain of the scaled logits
constexpr float kMaskLog2 = sdt::kNegInf * kLog2e;

using sdt::bf16;
using sdt::cp_async_commit;
using sdt::cp_async_wait;
using sdt::exp2_approx;
using sdt::mma_bf16;

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const FwdParams p) {
  constexpr int ld = DP + 8;       // shared row stride, elements
  constexpr int kK16 = DP / 16;    // k16 steps of q k^T
  constexpr int kN8 = DP / 8;      // n8 tiles of the output
  constexpr int kS8 = kTcBK / 8;   // n8 tiles of the logits
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][ld]
  bf16* Ks = Qs + kBQ * ld;                      // [2][kTcBK][ld]
  bf16* Vs = Ks + 2 * kTcBK * ld;                // [2][kTcBK][ld]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh +
                   static_cast<long long>(q0) * p.q_ss;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh +
             static_cast<long long>(q0) * p.o_ss;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column pair

  int n_tiles = (p.Skv + kTcBK - 1) / kTcBK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kTcBK + 1);

  auto stage_kv = [&](int kt, int buf) {
    const int k0 = kt * kTcBK;
    const int valid = min(kTcBK, p.Skv - k0);
    sdt::stage_tile<DP, kThreads>(Ks + buf * kTcBK * ld, kg + static_cast<long long>(k0) * p.k_ss, p.k_ss,
                   kTcBK, valid, p.D);
    sdt::stage_tile<DP, kThreads>(Vs + buf * kTcBK * ld, vg + static_cast<long long>(k0) * p.v_ss, p.v_ss,
                   kTcBK, valid, p.D);
  };
  sdt::stage_tile<DP, kThreads>(Qs, qg, p.q_ss, kBQ, min(kBQ, p.Sq - q0), p.D);
  stage_kv(0, 0);
  cp_async_commit();

  // the scale and log2(e) in one fp32 multiply of the s accumulator
  const float sl2 = p.scale * kLog2e;
  const int wrow = warp * 16;  // this warp's first row in the block
  float m[2] = {kMaskLog2, kMaskLog2};  // rows g, g + 8; log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float o[kN8][4];
#pragma unroll
  for (int n = 0; n < kN8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  unsigned qa[kK16][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) stage_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk) sdt::load_a<ld>(Qs, wrow, kk, qa[kk]);
    }

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    const bf16* Kb = Ks + buf * kTcBK * ld;
    float s[kS8][4];
#pragma unroll
    for (int j = 0; j < kS8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kS8 / 2; ++jp) {
        unsigned b[4];
        sdt::load_b_rows<ld>(Kb, jp * 16, kk, b);  // keys jp*16.., head dims of step kk
        mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }

    // scale, mask, online softmax (log2 domain)
    const int k0 = kt * kTcBK;
    const int row0 = q0 + wrow + g;
    const bool masked = k0 + kTcBK > p.Skv || (p.causal && k0 + kTcBK - 1 > q0 + wrow);
    float mx[2] = {kMaskLog2, kMaskLog2};
#pragma unroll
    for (int j = 0; j < kS8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[j][e] * sl2;
        if (masked) {
          const int key = k0 + j * 8 + tq * 2 + (e & 1);
          if (key >= p.Skv || (p.causal && key > row0 + (e >> 1) * 8)) t = kMaskLog2;
        }
        s[j][e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kS8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2_approx(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += bf16(p) v: p straight from the s registers as A fragments
    const bf16* Vb = Vs + buf * kTcBK * ld;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      unsigned a[4];
      sdt::c_to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int np = 0; np < kN8 / 2; ++np) {
        unsigned b[4];
        sdt::load_b_cols<ld>(Vb, kk * 16, np * 16, b);  // keys of step kk, head dims np*16..
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = wrow + g + 8 * i;  // row within the block
    if (q0 + r < p.Sq) {
      const float inv = 1.f / l[i];
      bf16* orow = og + static_cast<long long>(r) * p.o_ss;
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        const int d = n * 8 + tq * 2;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
      if (p.lse != nullptr && tq == 0)
        p.lse[static_cast<long long>(blockIdx.y) * p.Sq + q0 + r] = m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <int DP>
cudaError_t launch_tc(const FwdParams& p, cudaStream_t stream) {
  constexpr int kSmem = sizeof(bf16) * (kBQ + 4 * kTcBK) * (DP + 8);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_tc_kernel<DP><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const FwdParams& p, cudaStream_t stream) {
  // D rounded up to a multiple of 16 (the k16 steps); exact for 40 -> 48,
  // 80 and 160
  if (p.D <= 16) return launch_tc<16>(p, stream);
  if (p.D <= 32) return launch_tc<32>(p, stream);
  if (p.D <= 48) return launch_tc<48>(p, stream);
  if (p.D <= 64) return launch_tc<64>(p, stream);
  if (p.D <= 80) return launch_tc<80>(p, stream);
  if (p.D <= 96) return launch_tc<96>(p, stream);
  if (p.D <= 128) return launch_tc<128>(p, stream);
  return launch_tc<160>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every tensor is contiguous, rows are 16-byte aligned.  `lse` is a
// contiguous fp32 [B, H, Sq] output, or null when no backward follows.
// Returns the launch's cudaError_t.
extern "C" int sdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, int dtype, int B, int H, int Sq, int Skv,
                             int D, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, long long o_sb, long long o_ss,
                             long long o_sh, float scale, int causal,
                             float* lse, void* stream) {
  if (D <= 0 || D > 160 || D % 8 != 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams p{q,    k,    v,    o,    lse,  B,    H,    Sq,   Skv,
                    D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                    v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch_f32(p, s) : dispatch_bf16(p, s);
  return static_cast<int>(err);
}
