// flash_fwd: exact attention forward, softmax(q k^T * scale) v, for head dims
// that are multiples of 8 up to 160, in bf16 (Hopper tensor cores: TMA-fed
// wgmma) or fp32 (scalar FMAs), with fp32 accumulation.
//
// Replaces: the TPU library flash kernel that
// stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) calls, forward
// only (jax/experimental/pallas/ops/tpu/flash_attention.py:589, kernel body
// :342).  The TPU wrapper zero-pads ragged sequences to a 256/512 grid and
// keeps the padding out with segment ids; here the ragged ends of Sq and Skv
// are masked inside the kernel, and q/k/v are read by stride in their
// [B, S, H, D] layout, so there are no transposes and no padding copies.
//
// What bounds it on an H100: at the main path's shapes (S >= 4096) the work
// is 4*B*H*Sq*Skv*D operations on a few MB of input, far above the card's
// ridge point.  At D=64 (SD3, SDXL) the two products on the bf16 tensor
// cores (989 TFLOP/s) and the Sq*Skv exponentials on the MUFU (16 a clock
// per SM) take about as long as each other; at D=40 (SD1.5) the products,
// padded to 64 columns here, are shorter than the exponentials.  Neither
// kernel writes the [Sq, Skv] logits to device memory (online softmax, one
// pass over K/V per query tile), and both skip key tiles past the diagonal
// when causal.
//
// bf16, one block per 128 query rows of one (batch, head), 384 threads:
//   * Warp specialisation.  Warps 0-7 are two consumer warpgroups of 64 rows
//     (wgmma's M); one producer warp (warp 8, one thread of it) issues every
//     copy.  setmaxnreg counts registers by warpgroup, so warps 8-11 form
//     the producer warpgroup: it gives its registers back (setmaxnreg 40)
//     and the consumers take them (232): one block an SM.
//   * TMA.  Q's 128 rows are loaded once; K and V tiles of BK keys flow
//     through a ring of two stages, each with a full and an empty mbarrier
//     for K and for V, so q k^T starts before V lands and a stage is
//     refilled as soon as all 8 consumer warps have released it.  The
//     tensor maps are 4-D (D, H, S, B) with the tensor's own strides,
//     encoded at each launch (cuTensorMapEncodeTiled, looked up through
//     the CUDA runtime).  TMA's zero fill supplies rows past Sq/Skv and
//     head-dim columns past D, so no stale bits reach a product (0 * NaN).
//   * s = q k^T by wgmma m64nBKk16, both operands K-major in shared memory
//     with the 128-byte swizzle the maps write (descriptor layout type 1,
//     8-row groups 1024 bytes apart, a k16 step 32 bytes along the row).
//   * Online softmax in registers, in wgmma's accumulator layout: scale *
//     log2(e) in one multiply, exp2, running max and sum over a quad of
//     lanes (each in 8 independent partial chains); keys >= Skv and past
//     the diagonal masked before the max.
//   * o += p v by wgmma m64n64k16 per 64-column atom of V, A = p rounded to
//     bf16 in registers straight from s's accumulator (the C layout of two
//     n8 tiles is the A fragment of one k16 step), as the JAX kernel rounds
//     (`p.astype(v.dtype)`, flash_attention.py:471); l sums the fp32 p.  B
//     is the V tile read MN-major (transposed), 16 keys = 2048 bytes a step.
//   * Epilogue: o / l rounded to bf16, stored for rows < Sq only.
// Against the earlier design (FlashAttention-2 on Ampere's mma.sync, with
// ldmatrix and a cp.async double buffer issued by the compute warps), this
// (a) issues warpgroup products at the wgmma rate with no ldmatrix of K/V,
// (b) stages each K/V tile once for 128 rows instead of 64, (c) takes
// addressing and copy waits off the consumers' instruction stream, and (d)
// lets one warpgroup's softmax run under the other's products (the warp
// schedulers interleave the two groups).
// Head dims are padded to whole 64-column swizzle atoms (24/40/64 -> 64,
// 80/104/128 -> 128, 160 -> 192); q k^T skips the k16 steps past D, p v
// computes every atom.  Per instantiation (ptxas -v and shared memory in
// PERF.md, printed by chip_smoke.py's phase 1):
//   DP=64:  BK=128, 81 KiB of shared memory (Q 16 + 2 x (K 16 + V 16));
//   DP=128: BK=128, 161 KiB;  DP=192: BK=64, 145 KiB.
// Traps checked by tests/test_torch_cuda.py: the descriptor's swizzle and
// offsets against the maps' (a mismatch gives wrong numbers, not a fault),
// the mbarrier parity around the ring (a wait that never ends traps after
// about 2^33 clocks instead of hanging), the accumulator -> A fragment
// mapping, a ragged last key tile (4429 = 34 * 128 + 77) and query tile.
// Later work (PERF.md has what was tried on an H100): a persistent schedule
// over the tiles; the overlap of softmax with the products inside one
// warpgroup (q k^T of tile j and p v of tile j - 1 issued together), more
// rows a block (3 consumer warpgroups) and two blocks an SM, each of which
// spilled because ptxas allocates the consumers within the launch count
// whatever setmaxnreg grants; FA3's ping-pong of the two warpgroups (named
// barriers), which as tried was slower; a TMA store of O.
//
// fp32: exact fp32 cannot use the bf16 tensor cores, so fp32 keeps the
// scalar kernel: 4 rows x 4 keys per thread for the logits and 4 rows x D/8
// columns for the accumulator, tiles staged in shared memory as fp32.  It
// runs within 6% of SDPA in fp32 (PERF.md); on the main path it serves only
// CLIP's causal [1, 77, 12, 64].  Grid (ceil(Sq / 64), B * H), 128 threads.
//
// With a non-null `lse` both write each row's log-sum-exp of the scaled
// logits, fp32 [B, H, Sq]: the running max plus the log of the denominator.
// The TPU kernel keeps the same two numbers (l, m) lane-broadcast to 128 for
// its backward; flash_bwd.cu reads this one array instead.  A row whose keys
// are all masked still gets a finite value (-1e30 + log of the count).
//
// The TPU kernel's sequential key-block grid axis becomes the loop over key
// tiles inside the block.  The largest dynamic shared memory of each
// instantiation is set once, at its first launch.

#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block (fp32 kernel)
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
// bf16: warp-specialised, TMA-fed wgmma (sm_90a)
// ---------------------------------------------------------------------------

// {padded head width DP, keys a pipeline stage holds BK} of each bf16
// instantiation: the one place the key tile is set.  D is rounded up to a
// whole number of 64-column (128-byte) swizzle atoms: 24/40/64 -> 64,
// 80/104/128 -> 128, 160 -> 192.  ops/attention.flash_fwd_key_tile mirrors
// this table (tests/test_torch_kernel_tiles.py reads it from here), and the
// plain version of the kernel's p rounding takes BK as its block.
constexpr int kBf16Tiles[][2] = {{64, 128}, {128, 128}, {192, 64}};

constexpr int key_tile(int dp) {
  for (const auto& t : kBf16Tiles)
    if (t[0] == dp) return t[1];
  return 0;
}

constexpr int kWgRows = 64;                          // rows of a consumer warpgroup (wgmma M)
constexpr int kConsumerWGs = 2;
constexpr int kWsRows = kWgRows * kConsumerWGs;      // 128 query rows a block
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kWsThreads = 128 * (kConsumerWGs + 1);  // + the producer warpgroup
constexpr int kStages = 2;                           // K/V ring depth
// registers a thread after setmaxnreg, which counts them by warpgroup: the
// producer warpgroup gives its share back and the two consumer warpgroups
// take it.  Launched at 168 = 65536 / 384 rounded down to 8, and
// 128 * 40 + 256 * 232 = 384 * 168.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the -1e30 mask in the log2 domain of the scaled logits
constexpr float kMaskLog2 = sdt::kNegInf * kLog2e;

using namespace sdt;

// Shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes, and wgmma's descriptors
// assume tiles start on that period).  Each tile is stored as kNC atoms
// [rows][64 columns], one after the other.
template <int DP>
struct WsLayout {
  static constexpr int kNC = DP / kAtomCols;
  static constexpr int kBK = key_tile(DP);
  static constexpr int kQBytes = kNC * kWsRows * kAtomBytes;
  static constexpr int kKVBytes = kNC * kBK * kAtomBytes;  // one stage of K, or of V
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // q_full, then k_full, v_full, k_empty, v_empty for each stage
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
  static_assert(kBK == 64 || kBK == 128, "key tile");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// One block: 128 query rows of one (batch, head), head dims padded to D16
// for q k^T and to DP (whole swizzle atoms) in shared memory.  Warps 0-7 are
// two consumer warpgroups of 64 rows each; warps 8-11 are the producer
// warpgroup, of which one warp (one thread of it) issues every TMA copy and
// the other three only give their registers back.
template <int D16, int DP = atom_width(D16)>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using L = WsLayout<DP>;
  constexpr int BK = L::kBK;
  constexpr int NC = L::kNC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * kStages + s); };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kWsRows;
  int n_tiles = (p.Skv + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kWsRows - 1) / BK + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer: Q once, then K and V of each key tile through the ring.
    // A stage is refilled once all 8 consumer warps have released it.
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(q_full, L::kQBytes);
      tma_load_tile<NC>(sQ, &tq, q_full, kWsRows, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;  // round 0 passes at once
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::kKVBytes);
        tma_load_tile<NC>(sK + s * L::kKVBytes, &tk, k_full(s), BK, h, j * BK, b);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::kKVBytes);
        tma_load_tile<NC>(sV + s * L::kKVBytes, &tv, v_full(s), BK, h, j * BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. +63.  In wgmma's
    // accumulator layout warp w4 of the group holds rows 16 w4 + g and
    // 16 w4 + g + 8 (g = lane / 4), and for each n8 tile j the columns
    // 8 j + 2 t, +1 (t = lane % 4): registers 4 j + e, row + 8 (e >> 1),
    // column + (e & 1), as mma.sync's C fragment.
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int w4 = warp & 3;
    const int g = lane >> 2;
    const int tq4 = lane & 3;
    const int wrow = q0 + wg * kWgRows + w4 * 16;  // this warp's first row
    const float sl2 = p.scale * kLog2e;  // the scale and log2(e) in one multiply
    const uint32_t q_tile = sQ + wg * kWgRows * kAtomBytes;

    float m[2] = {kMaskLog2, kMaskLog2};  // rows g, g + 8; log2 domain
    float l[2] = {0.f, 0.f};              // this thread's share of the row sums
    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t pa[BK / 16][4];

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t parity = (j / kStages) & 1;

      // s = q k^T (fp32), then release K's stage to the producer
      mbar_wait(k_full(st), parity);
      reg_fence(s);
      wgmma_fence();
      kmajor_product<D16, BK, kWsRows>(s, q_tile, sK + st * L::kKVBytes);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(st));

      // scale, mask, online softmax in the log2 domain
      const int k0 = j * BK;
      const bool masked = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > wrow);
      // the row max and row sum in 8 partial chains (register i feeds chain
      // i % 8, of row half (i >> 1) & 1): with two warps a scheduler, one
      // chain of 32 dependent max or add instructions would stall it
      float part[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) part[c] = kMaskLog2;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float t = s[i] * sl2;
        if (masked) {
          const int key = k0 + (i >> 2) * 8 + tq4 * 2 + (i & 1);
          if (key >= p.Skv || (p.causal && key > wrow + g + ((i >> 1) & 1) * 8)) t = kMaskLog2;
        }
        s[i] = t;
        part[i & 7] = fmaxf(part[i & 7], t);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(part[2 * r], part[2 * r + 1]),
                         fmaxf(part[2 * r + 4], part[2 * r + 5]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) part[c] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float pe = exp2_approx(s[i] - m[(i >> 1) & 1]);
        s[i] = pe;
        part[i & 7] += pe;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((part[2 * r] + part[2 * r + 1]) +
                                  (part[2 * r + 4] + part[2 * r + 5]));
      // p rounded to bf16 straight from the accumulator: the C layout of the
      // two n8 tiles of k16 step kk is the A fragment of that step
      acc_to_a<BK>(s, pa);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

      // o += bf16(p) v: V's rows are the k16 steps (16 rows = 2048 bytes),
      // its 64-column atoms the n64 products
      mbar_wait(v_full(st), parity);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
      mnmajor_product<NC, BK>(o, pa, sV + st * L::kKVBytes);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      reg_fence(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(st));
    }

    // epilogue: o / l rounded to bf16, rows < Sq only; the lse when asked
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = wrow + g + 8 * r;
      if (row < p.Sq) {
        const float inv = 1.f / l[r];
        bf16* orow = og + static_cast<long long>(row) * p.o_ss;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            const int d = c * kAtomCols + jn * 8 + tq4 * 2;
            if (d < p.D)
              *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
                  o[c][4 * jn + 2 * r] * inv, o[c][4 * jn + 2 * r + 1] * inv);
          }
        if (p.lse != nullptr && tq4 == 0)
          p.lse[static_cast<long long>(blockIdx.y) * p.Sq + row] = m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

template <int D16>
cudaError_t launch_wgmma(const FwdParams& p, cudaStream_t stream) {
  using L = WsLayout<atom_width(D16)>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kWsRows) ||
      !encode_map(&tk, p.k, p.D, p.H, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, L::kBK) ||
      !encode_map(&tv, p.v, p.D, p.H, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, L::kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((p.Sq + kWsRows - 1) / kWsRows, p.B * p.H);
  flash_fwd_wgmma_kernel<D16><<<grid, kWsThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const FwdParams& p, cudaStream_t stream) {
  // one instantiation for each number of k16 steps over the head dims
  switch ((p.D + 15) / 16) {
    case 1: return launch_wgmma<16>(p, stream);
    case 2: return launch_wgmma<32>(p, stream);
    case 3: return launch_wgmma<48>(p, stream);
    case 4: return launch_wgmma<64>(p, stream);
    case 5: return launch_wgmma<80>(p, stream);
    case 6: return launch_wgmma<96>(p, stream);
    case 7: return launch_wgmma<112>(p, stream);
    case 8: return launch_wgmma<128>(p, stream);
    case 9: return launch_wgmma<144>(p, stream);
    default: return launch_wgmma<160>(p, stream);
  }
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
