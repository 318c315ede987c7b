// flash_stream: online-softmax attention forward for wide heads, D > 160 and
// a multiple of 8, up to 1024, in fp32 or bf16 with fp32 accumulation.  On
// the main path it takes the VAE mid-block's single 512-wide head.
//
// Replaces: stablediffusion_tpu/ops/flash_attention.py:145-207
// (flash_attention_streaming; kernel body _flash_stream_kernel :67-127).  It
// keeps that kernel's semantics: s = (q.k^T) * scale in fp32, fp32 running
// max, denominator and accumulator, keys past Skv masked to -1e30, no mask
// argument, forward only.  The TPU version pads q and kv to its block grid
// and slices the result back; here the ragged ends are masked in the kernel
// and q/k/v are read by stride.  Its _VMEM_BUDGET and 128-lane scratch are
// TPU artifacts and do not carry over.
//
// What bounds it on an H100: the path runs it in fp32 (the decode under
// force_upcast, the trainers' encode), and exact fp32 keeps it off the
// tensor cores, so the 4*Sq*Skv*D operations run as FFMAs at 67 TFLOP/s.
// The operands come from shared memory, whose 128 bytes a clock per SM
// feed fewer FFMAs than the SM can execute unless each loaded value is used
// many times in registers.  So the design is an SGEMM's, twice per key tile:
//   * s = q k^T (32 query rows x BK keys, contracted over D): K is staged in
//     chunks of KC head dims; the block's 4 groups of 64 threads each take a
//     quarter of every chunk, a thread an 8-row x BK/16-key register tile
//     (rows rb + 4i, keys kb + 16j) fed by float4 loads along D: 8 x 8 and
//     16 loads per 256 FFMAs at BK = 128.  The four partial tiles are summed
//     through shared memory, then 8 threads a row take the softmax.
//   * o += p v (32 rows x D, contracted over the tile's keys): V is staged
//     in chunks of VK keys, and a thread holds an 8-row x D/64-column tile
//     of the fp32 accumulator in registers (8 x 8 at D = 512), reading p
//     (one address for the whole warp) and v as float4.
// Q stays in shared memory (64 KB at D = 512); K and V chunks flow through
// a cp.async double buffer, so the copy of each chunk runs under the
// products of the one before.  A block takes 32 query rows: at B=1, Sq=4096
// that is 128 blocks, one wave on 132 SMs, each rereading K and V from L2
// once (2 GB of L2 traffic at [1,4096,1,512]).  Tiles by head dim:
//   D <= 512: BK = 128, KC = 64, VK = 16 (191 KB of shared memory at 512);
//   D > 512:  BK = 64, KC = 128, VK = 8, an 8 x 4 logit tile (Q alone takes
//             128 KB at D = 1024; 229 KB in all).
//
// bf16 shares the design; its tiles are widened to fp32 by a synchronous
// load (cp.async cannot convert).  No path runs it.
//
// Grid: (ceil(Sq / 32), B * H), blocks independent; the TPU's sequential
// key-block grid axis is the loop over key tiles inside the block.  Block:
// 256 threads.  The largest dynamic shared memory of each instantiation is
// set once, at its first launch.

#include "common.cuh"

namespace {

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

// 4 elements at `g` into fp32 shared memory at `s` (16-byte aligned); zeros
// when `ok` is false.  fp32 by cp.async, bf16 by a widening 8-byte load.
__device__ __forceinline__ void copy4(float* s, const float* g, bool ok) {
  sdt::cp_async16(sdt::smem_u32(s), g, ok);
}

__device__ __forceinline__ void copy4(float* s, const __nv_bfloat16* g, bool ok) {
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    const uint2 raw = *reinterpret_cast<const uint2*>(g);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f = make_float4(a.x, a.y, b.x, b.y);
  }
  *reinterpret_cast<float4*>(s) = f;
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
template <typename T>
__device__ __forceinline__ void copy_rows(float* dst, int ld_s, const T* src, long long ld_g,
                                          int rows, int valid, int D, RowWalk w,
                                          const T* safe) {
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

template <int MAXD>
struct StreamShape {
  static constexpr bool kWide = MAXD > 512;
  static constexpr int kBK = kWide ? 64 : 128;   // keys per tile
  static constexpr int kKC = kWide ? 128 : 64;   // head dims per K chunk
  static constexpr int kVK = kWide ? 8 : 16;     // keys per V chunk
  static constexpr int kSK = kBK / 16;           // logit-tile keys per thread
  static constexpr int kLdK = kKC + 4;           // K chunk row stride: odd float4 count
  static constexpr int kKF4 = kKC / 4;           // float4s per K chunk row
  static constexpr int kKRows = kThreads / kKF4; // K chunk rows one pass copies
  static constexpr int kLdS = kBK + 16;          // partial-logit row stride
  static constexpr int kCols4 = MAXD / 256;      // float4 accumulator columns per thread
  // floats of shared memory at head dim D
  __host__ __device__ static constexpr int ring(int D) {
    return kBK * kLdK > kVK * (D + 4) ? kBK * kLdK : kVK * (D + 4);
  }
  __host__ __device__ static constexpr int floats(int D) {
    return kBQ * (D + 4) + 2 * ring(D) + 2 * kBQ * kLdS + kBK * kLdP + 2 * kBQ;
  }
};

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads, 1)
flash_stream_kernel(const StreamParams p) {
  using Shape = StreamShape<MAXD>;
  constexpr int kBK = Shape::kBK;
  constexpr int kKC = Shape::kKC;
  constexpr int kVK = Shape::kVK;
  constexpr int kSK = Shape::kSK;
  constexpr int kLdK = Shape::kLdK;
  constexpr int kKF4 = Shape::kKF4;
  constexpr int kKRows = Shape::kKRows;
  constexpr int kLdS = Shape::kLdS;
  constexpr int kC4 = Shape::kCols4;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldq = D + 4;
  const int ring = Shape::ring(D);
  float* Qs = smem;                      // [kBQ][ldq]
  float* Ring = Qs + kBQ * ldq;          // 2 x (K chunk [kBK][kLdK] | V chunk [kVK][ldq])
  float* Sred = Ring + 2 * ring;         // [2][kBQ][kLdS]
  float* Pt = Sred + 2 * kBQ * kLdS;     // [kBK][kLdP]: p transposed
  float* alpha_s = Pt + kBK * kLdP;      // [kBQ]
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
      const T* src = kg + static_cast<long long>(k0 + krow) * p.k_ss + dcol;
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
    T* orow = og + static_cast<long long>(r) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < kC4; ++jj) {
      const int d = ocb * 4 + 256 * jj;
      if (d < D) {
        const float4 y = make_float4(acc[a][4 * jj] * inv, acc[a][4 * jj + 1] * inv,
                                     acc[a][4 * jj + 2] * inv, acc[a][4 * jj + 3] * inv);
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(orow + d) = y;
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
          uint2 w;
          w.x = *reinterpret_cast<const unsigned*>(&lo);
          w.y = *reinterpret_cast<const unsigned*>(&hi);
          *reinterpret_cast<uint2*>(orow + d) = w;
        }
      }
    }
  }
}

template <typename T, int MAXD>
cudaError_t launch(const StreamParams& p, cudaStream_t stream) {
  using Shape = StreamShape<MAXD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_stream_kernel<T, MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * Shape::floats(MAXD)));
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * Shape::floats(p.D);
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_stream_kernel<T, MAXD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const StreamParams& p, cudaStream_t stream) {
  if (p.D <= 256) return launch<T, 256>(p, stream);
  if (p.D <= 512) return launch<T, 512>(p, stream);
  return launch<T, 1024>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every tensor is contiguous, rows are 16-byte aligned.  Returns the
// launch's cudaError_t.
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
