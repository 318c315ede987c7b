// flash_fwd: exact attention forward, softmax(q k^T * scale) v, for head dims
// that are multiples of 8 up to 160, in bf16 or fp32, with fp32 accumulation,
// both on Hopper's tensor cores by TMA-fed wgmma (fp32 in 3xTF32).
//
// Replaces: the TPU library flash kernel that
// stablediffusion_tpu/ops/attention.py:165-226 (_lib_flash) calls, forward
// only (jax/experimental/pallas/ops/tpu/flash_attention.py:589, kernel body
// :342).  The TPU wrapper zero-pads ragged sequences to a 256/512 grid and
// keeps the padding out with segment ids; here the ragged ends of Sq and Skv
// are masked inside the kernel, and q/k/v are read by stride in their
// [B, S, H, D] layout, so there are no transposes and no padding copies.
//
// What bounds it on an H100: at the main path's bf16 shapes (S >= 4096) the
// work is 4*B*H*Sq*Skv*D operations on a few MB of input, far above the
// card's ridge point.  At D=64 (SD3, SDXL) the two products on the bf16 tensor
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
// fp32 (flash_fwd_tf32_kernel<MT, NA>): the paths run it on the text
// encoders (CLIP-L and bigG, causal over 77 tokens; with the lse in the
// SDXL trainer) and the IP-Adapter image encoders (ViT-H/14 and
// ViT-bigG/14: D = 80 and 104 over 257 tokens).  At those shapes the
// products take about a microsecond (0.34 GFLOP at [1,257,16,80]) and a
// grid of 12-80 blocks leaves most of the 132 SMs idle: the time is
// latency, of the copies, the products' chains and the softmax, which the
// design shortens.  It shares flash_stream.cu's 3xTF32 pieces (hopper.cuh):
//   * 3xTF32.  Every operand is split, x = hi + lo with hi = tf32(x) and
//     lo = tf32(x - hi), and a product is hi*hi + hi*lo + lo*hi on TF32
//     wgmma (m64n64k8): about fp32's accuracy (the fp32 rule, atol 1e-5,
//     holds) at a third of the TF32 rate.
//   * One block per 64 query rows of one (batch, head), 384 threads: two
//     consumer warpgroups that take the key tiles of 64 keys in turn, each
//     with its own running max, denominator and o^T, merged at the end
//     through shared memory (one fixed expression: the same bits every
//     run), each storing half of the rows; and a producer warpgroup whose
//     warp 8 and 9 (one thread each) feed the two warpgroups' rings.  The
//     key split halves the serial chain of tiles (257 keys: 3 and 2 tiles
//     where one warpgroup would walk 5; PERF.md has its gain).
//   * s = q k^T: A = q from registers (ldmatrix of Q's atoms, split k-step
//     by k-step, the next built while the previous runs), B = a K atom
//     [64 keys][32 head dims] as TMA wrote it, split in place (hi) and
//     8 KiB above (lo) by its warpgroup under the previous atom's products;
//     k-steps past D are skipped.
//   * Softmax in registers in wgmma's accumulator layout, scale and log2(e)
//     in one multiply, exp2; keys past Skv and past the diagonal are masked
//     in the last tile and the diagonal tile only, behind one tile-uniform
//     branch; key tiles past the diagonal are never visited.  p is split
//     into two K-major tiles [64 rows][64 keys] (hi, lo) in shared memory.
//   * o += p v as o^T += v^T p^T: TF32 wgmma takes no transposed operand
//     and V arrives MN-major, so A = v^T from registers (32-bit loads from
//     a V chunk [64 keys][64 head dims], split) with the key permutation
//     that matches s's accumulator layout, B = p^T, the p tiles.  Each
//     64-column m-tile's products over 32 keys go to an accumulator of
//     their own, added into o^T by the FPU (two-level sums: the tensor
//     core's fp32 adds truncate, a bias toward zero that grows with the
//     adds), the small products (v_hi p_lo, v_lo p_hi) before v_hi p_hi.
//     A shrunken o^T disagrees with the lse and with the p the backward
//     recomputes from it; at one flush a key tile, in k-step order, the
//     narrow fp32 train step missed its rule against the CPU (2.3e-3 of
//     the largest gradient, limit 1e-3; PERF.md).
//   * Copies: Q's atoms once, then each warpgroup's chunks (the K atoms,
//     then the V chunks, of each of its tiles) through its own ring of
//     16 KiB stages with full and empty mbarriers; 4-D fp32 maps (D, H, S,
//     B) over the tensors' own strides with the 128-byte swizzle (32 fp32
//     columns an atom); TMA's zero fill takes rows past Sq and Skv and
//     columns past D.
//   * Registers: setmaxnreg 24 (producer) / 240 (consumers).  The consumers
//     wait by mbar_wait_spin; the producer waits with the time limit up to
//     their last release, so a copy that never lands traps: a __trap()
//     reachable in the consumers would hold them to the launch's 168.
//     Three m-tiles of o^T (96 registers) spilled even at 240, so a block
//     takes at most two: MT = 1 at D <= 64, 2 at D <= 128, and above 128
//     two blocks take a query tile (grid z), each computing s whole and
//     storing its m-tiles (NA = Q's atoms: 2, 4, 5).
// Shared memory: Q 8 KiB an atom, the p tiles 64 KiB, rings of 4 stages a
// warpgroup (3 at NA = 5): 211, 227 and 203 KiB; one block an SM.
// Later work: at the path's shapes about half the time is fixed cost, not
// the products (utils/flash_fwd_ablation; PERF.md).
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

// ---------------------------------------------------------------------------
// fp32: 3xTF32 wgmma fed by TMA (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kTfStatBytes = 6 * kTfRows * 4;
constexpr int kTfPBytes = 4 * kTfAtomBytes;  // a warpgroup's p tiles, hi and lo
constexpr int tf_bytes(int q_atoms, int stages) {  // stages: a warpgroup's
  return q_atoms * kTfAtomBytes + 2 * kTfPBytes + 2 * stages * kTfStageBytes +
         kTfStatBytes + 8 * (1 + 4 * stages) + 1024;  // + alignment slack
}
constexpr int tf_stages(int q_atoms) {
  return tf_bytes(q_atoms, 4) <= 232448 ? 4 : tf_bytes(q_atoms, 3) <= 232448 ? 3 : 2;
}

// Shared memory of one block of the fp32 kernel <MT, NA>, in bytes from a
// 1024-byte aligned base: Q's NA atoms, each consumer warpgroup's p tiles
// (hi, then lo: two atoms [64 rows][64 keys] each), each warpgroup's ring of
// stages (a K atom or a V chunk each: sdt::kTfStageBytes), the row
// statistics (alpha[2][64], m[2][64], l[2][64]) and the mbarriers (q_full,
// then the full and the empty barrier of every stage).  As many stages as
// fit, up to 4 a warpgroup.
template <int MT, int NA>
struct TfLayout {
  static constexpr int kStages = tf_stages(NA);  // a warpgroup's
  static constexpr int kQ = 0;
  static constexpr int kP = kQ + NA * kTfAtomBytes;  // warpgroup w's at kP + w kTfPBytes
  static constexpr int kRing = kP + 2 * kTfPBytes;  // warpgroup w's stages from kRing + w S
  static constexpr int kStats = kRing + 2 * kStages * kTfStageBytes;
  static constexpr int kBar = kStats + kTfStatBytes;
  static constexpr int kBytes = tf_bytes(NA, kStages);
  static_assert(kBar + 8 * (1 + 4 * kStages) + 1024 == kBytes, "layout");
  static_assert(kBytes <= 232448, "shared memory of one block");
  // the half of o^T a warpgroup sends the other lands in its own ring
  static_assert(MT * 4 * 128 * 16 <= kStages * kTfStageBytes, "merge buffer");
};

// One block: 64 query rows of one (batch, head), and of o^T's 64-column
// m-tiles MT from MT * blockIdx.z (the head dims 64 MT z .. + 64 MT - 1: at
// most two a block, since three m-tiles of o^T, 96 accumulator registers,
// left ptxas too few within a consumer's 240 and it spilled; at D > 128 two
// blocks take a (batch, head, query tile), each computing s whole).  NA:
// Q's atoms, D <= 32 NA.  Warps 0-7 are two consumer warpgroups that take
// the key tiles in turn (warpgroup w the tiles j = w, w + 2, ...), each with
// its own running max, denominator and o^T; warps 8-11 the producer
// warpgroup, of which warp 8 (one thread) issues Q and warpgroup 0's copies
// and warp 9 warpgroup 1's.  At the end the two warpgroups merge their
// halves of the keys, each storing half of the rows.
template <int MT, int NA>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using L = TfLayout<MT, NA>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sQ = base + L::kQ;
  float* const alpha_s = reinterpret_cast<float*>(gbase + L::kStats);  // [2][64]
  float* const m_s = alpha_s + 2 * kTfRows;                            // [2][64]
  float* const l_s = m_s + 2 * kTfRows;                                // [2][64]
  const uint32_t q_full = base + L::kBar;
  // stage s of warpgroup w's ring, its barriers and its chunk c's stage
  auto full = [&](int w, int s) { return q_full + 8u * (1 + w * S + s); };
  auto empty = [&](int w, int s) { return q_full + 8u * (1 + 2 * S + w * S + s); };
  auto stage_off = [&](int w, int c) { return L::kRing + (w * S + c % S) * kTfStageBytes; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kTfRows;
  const int na = (p.D + kF32AtomCols - 1) / kF32AtomCols;  // atoms of Q and K
  const int mt0 = MT * blockIdx.z;                           // this block's first m-tile
  const int mt = min(MT, (p.D + 63) / 64 - mt0);             // and its m-tiles
  const int per = na + mt;  // a warpgroup's chunks a key tile: na K atoms, mt V chunks
  int n_tiles = (p.Skv + kTfKeys - 1) / kTfKeys;
  if (p.causal) n_tiles = min(n_tiles, q0 / kTfKeys + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(q_full + 8u * (1 + s), 1);
      mbar_init(q_full + 8u * (1 + 2 * S + s), 4);  // the 4 warps of the warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer: warp 8 + w (one thread) feeds warpgroup w's ring, in
    // order: chunk c of its sequence (for each of its tiles: the na K atoms,
    // then the mt V chunks) once the 4 warps of the warpgroup have released
    // chunk c - S.  Then it waits for the release of the last chunks: its
    // waits trap after kWaitLimitClocks and the consumers' do not (see
    // mbar_wait_spin), so a copy that never lands traps here.  Warps 10
    // and 11 only give their registers back.
    setmaxnreg_dec<kTfProducerRegs>();
    const int w = warp - kConsumerWarps;
    if (w < 2 && lane == 0) {
      if (w == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        mbar_expect_tx(q_full, na * kTfAtomBytes);
        for (int a = 0; a < na; ++a)
          tma_load(sQ + a * kTfAtomBytes, &tq, q_full, a * kF32AtomCols, h, q0, b);
      }
      const int total = (n_tiles - w + 1) / 2 * per;
      for (int c = 0; c < total; ++c) {
        const int s = c % S;
        if (c >= S) mbar_wait(empty(w, s), ((c / S) & 1) ^ 1);
        const int k0 = (w + 2 * (c / per)) * kTfKeys;
        const int x = c % per;
        const uint32_t dst = base + stage_off(w, c);
        if (x < na) {
          mbar_expect_tx(full(w, s), kTfAtomBytes);
          tma_load(dst, &tk, full(w, s), x * kF32AtomCols, h, k0, b);
        } else {
          const int mi = mt0 + x - na;
          mbar_expect_tx(full(w, s), kTfStageBytes);
          tma_load(dst, &tv, full(w, s), 2 * mi * kF32AtomCols, h, k0, b);
          tma_load(dst + kTfAtomBytes, &tv, full(w, s), (2 * mi + 1) * kF32AtomCols, h, k0, b);
        }
      }
      for (int c = max(total - S, 0); c < total; ++c) mbar_wait(empty(w, c % S), (c / S) & 1);
    }
    return;
  }

  // ---- consumers: warpgroup wg, in wgmma's accumulator layout (hopper.cuh's
  // 3xTF32 section): s holds rows 16 w4 + g (+8) and keys 8 j + 2 t4 (+1),
  // o^T head dims 64 i + 16 w4 + g (+8) and rows 8 jn + 2 t4 (+1)
  setmaxnreg_inc<kTfConsumerRegs>();
  const int wg = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tid = threadIdx.x & 127;  // thread of the warpgroup
  const int row0 = 16 * w4 + g;       // this thread's first row of s
  const float sl2 = p.scale * kTfLog2e;
  const uint32_t q_row = q_ldmatrix_row(sQ);
  unsigned char* const p_tiles = gbase + L::kP + wg * kTfPBytes;
  const uint32_t p_addr = base + L::kP + wg * kTfPBytes;
  constexpr int kPLo = 2 * kTfAtomBytes;  // lo tile past the hi tile
  // this warp is done with chunk c: once all 4 warps of the warpgroup are,
  // the producer refills the stage
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(wg, c % S));
  };
  // split K atom chunk c (hi in place, lo 8 KiB above), fenced for wgmma's
  // reads
  auto convert = [&](int c) {
    mbar_wait_spin(full(wg, c % S), (c / S) & 1);
    split_atom_tf32(gbase + stage_off(wg, c), tid);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
  };

  float o[MT][32];  // o^T over this warpgroup's keys: head dims x query rows
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[i][r] = 0.f;
  float m[2] = {kTfMaskLog2, kTfMaskLog2};  // rows row0, row0 + 8 (log2 domain)
  float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums over its keys
  // s of one key tile, and the tensor core's partial sum of one m-tile of
  // o^T over it (the two-level sum: add_scaled).  Registers of their own:
  // ptxas serializes every wgmma of a kernel whose accumulators share
  // registers.  Each is set to zero before its first product, so that
  // neither holds registers through the other's phase.
  float s[32], part[32];
  // the A fragments, split, of two k-steps: one is built while the other
  // k-step's products run
  uint32_t ah[2][4], al[2][4];

  mbar_wait_spin(q_full, 0);
  for (int j = wg, c = 0; j < n_tiles; j += 2, c += per) {
    // s = q k^T over the head dims' k-steps (those past D skipped), an
    // atom's split under the previous atom's first products
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = 0.f;
    convert(c);
    for (int x = 0; x < na; ++x) {
      const uint32_t k_atom = base + stage_off(wg, c + x);
      const int steps = min(4, (p.D - x * kF32AtomCols) / 8);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < steps)
          qk_kstep(s, ah[kk & 1], al[kk & 1], q_row + x * kTfAtomBytes, k_atom, kk,
                   x > 0 || kk > 0);
        if (kk == 0 && x > 0) release(c + x - 1);  // its products are done
        if (kk == 0 && x + 1 < na) convert(c + x + 1);
      }
    }
    wgmma_wait<0>();
    reg_fence(s);
    release(c + na - 1);

    // softmax in the log2 domain; keys past Skv and past the diagonal are
    // masked in the last tile and the diagonal tile only, behind one
    // tile-uniform branch
    const int k0 = j * kTfKeys;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= sl2;
    if (k0 + kTfKeys > p.Skv || (p.causal && k0 + kTfKeys - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = q0 + row0 + 8 * ((i >> 1) & 1);
        s[i] = key >= p.Skv || (p.causal && key > row) ? kTfMaskLog2 : s[i];
      }
    }
    // the row max in 4 partial chains a row half
    float part_max[4] = {kTfMaskLog2, kTfMaskLog2, kTfMaskLog2, kTfMaskLog2};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      part_max[(i >> 1) & 3] = fmaxf(part_max[(i >> 1) & 3], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(part_max[r], part_max[r + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
    // p into this warpgroup's p tiles (every warp of it passed this tile's
    // first convert barrier after its last reads of the previous tile's p
    // and alpha)
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2_approx(s[i] - m[r]);
      const float p1 = exp2_approx(s[i + 1] - m[r]);
      ls[(i >> 1) & 3] += p0 + p1;
      store_p_pair(p_tiles, kPLo, row0 + 8 * r, i >> 2, p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (ls[r] + ls[r + 2]);
    if (t4 == 0) {
      alpha_s[wg * kTfRows + row0] = alpha[0];
      alpha_s[wg * kTfRows + row0 + 8] = alpha[1];
    }
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);

    // o^T += v^T p^T, m-tile by m-tile and 32 keys at a time: the products
    // of 32 keys into part, the small ones first (vt_p_product), then added
    // into o^T by the FPU (o^T = o^T * alpha + part for the first 32).  The
    // tensor core's truncating adds shrink o^T, a bias the lse and the
    // backward's p do not share: at one flush a tile, with the products in
    // their k-step order, it broke the narrow fp32 train step's rule
    // against the CPU (PERF.md).
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mt) break;
      const int cv = c + na + i;
      mbar_wait_spin(full(wg, cv % S), (cv / S) & 1);
      const float* chunk = reinterpret_cast<const float*>(gbase + stage_off(wg, cv));
#pragma unroll
      for (int r = 0; r < 32; ++r) part[r] = 0.f;
      vt_p_product<4, true>(part, ah, al, chunk, p_addr, kPLo, 0);
      wgmma_wait<0>();
      reg_fence(part);
      add_scaled(o[i], part, alpha_s + wg * kTfRows);
      vt_p_product<4, true>(part, ah, al, chunk, p_addr, kPLo, 4);
      release(cv);  // the chunk is in registers: its stage is free
      wgmma_wait<0>();
      reg_fence(part);
#pragma unroll
      for (int r = 0; r < 32; ++r) o[i][r] += part[r];
    }
  }

  // ---- merge the two warpgroups' halves of the keys.  Row statistics: the
  // running max and the whole denominator of each row, each warpgroup's
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_s[wg * kTfRows + row0 + 8 * r] = m[r];
      l_s[wg * kTfRows + row0 + 8 * r] = l[r];
    }
  }
  // Warpgroup wg stores rows 32 wg .. +31 (o^T's n8 tiles jn = 4 wg .. +3)
  // and sends the other warpgroup its o^T of the other rows, through its own
  // ring (every chunk of it is consumed).  The loops run over all 8 n8 tiles
  // behind a warpgroup-uniform test, so that o is indexed by constants (an
  // index that depends on wg would put it in local memory).
  float4* const send = reinterpret_cast<float4*>(gbase + stage_off(wg, 0));
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    if ((jn >> 2) == wg) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i)
      send[(i * 4 + (jn & 3)) * 128 + tid] =
          make_float4(o[i][4 * jn], o[i][4 * jn + 1], o[i][4 * jn + 2], o[i][4 * jn + 3]);
  }
  named_bar_sync(1, 256);
  // (o_0 c_0 + o_1 c_1) / (l_0 c_0 + l_1 c_1), c_w = 2^(m_w - max(m_0, m_1)),
  // warpgroup 0's part first; head dims < D, rows < Sq
  const float4* const recv = reinterpret_cast<const float4*>(gbase + L::kRing +
                                                             (wg ^ 1) * S * kTfStageBytes);
  float* const og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    if ((jn >> 2) != wg) continue;
    float c0[2], c1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * jn + 2 * t4 + e;
      const float m0 = m_s[row], m1 = m_s[kTfRows + row];
      const float mm = fmaxf(m0, m1);
      const float e0 = exp2_approx(m0 - mm), e1 = exp2_approx(m1 - mm);
      const float inv = 1.f / (l_s[row] * e0 + l_s[kTfRows + row] * e1);
      c0[e] = e0 * inv;
      c1[e] = e1 * inv;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float4 peer = recv[(i * 4 + (jn & 3)) * 128 + tid];
      const float pv[4] = {peer.x, peer.y, peer.z, peer.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float own = o[i][4 * jn + e];
        const float o0 = wg ? pv[e] : own, o1 = wg ? own : pv[e];
        const int row = q0 + 8 * jn + 2 * t4 + (e & 1);
        const int d = 64 * (mt0 + i) + 16 * w4 + g + 8 * (e >> 1);
        if (row < p.Sq && d < p.D)
          og[static_cast<long long>(row) * p.o_ss + d] = o0 * c0[e & 1] + o1 * c1[e & 1];
      }
    }
  }
  // the log-sum-exp of rows 32 wg + lane, when asked (by the first block of
  // the query tile's m-tiles)
  if (p.lse != nullptr && blockIdx.z == 0 && w4 == 0) {
    const int row = 32 * wg + lane;
    const float m0 = m_s[row], m1 = m_s[kTfRows + row];
    const float mm = fmaxf(m0, m1);
    const float den = l_s[row] * exp2_approx(m0 - mm) + l_s[kTfRows + row] * exp2_approx(m1 - mm);
    if (q0 + row < p.Sq)
      p.lse[static_cast<long long>(blockIdx.y) * p.Sq + q0 + row] = mm * kLn2 + logf(den);
  }
}

template <int MT, int NA>
cudaError_t launch_tf32(const FwdParams& p, cudaStream_t stream) {
  using L = TfLayout<MT, NA>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<MT, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  if (!encode_map_f32(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kTfRows) ||
      !encode_map_f32(&tk, p.k, p.D, p.H, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, kTfKeys) ||
      !encode_map_f32(&tv, p.v, p.D, p.H, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, kTfKeys))
    return cudaErrorInvalidValue;
  const dim3 grid((p.Sq + kTfRows - 1) / kTfRows, p.B * p.H, ((p.D + 63) / 64 + MT - 1) / MT);
  flash_fwd_tf32_kernel<MT, NA><<<grid, kWsThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const FwdParams& p, cudaStream_t stream) {
  // m-tiles of o^T a block, Q atoms: D <= 64, D <= 128, and D <= 160 (two
  // blocks a query tile)
  if (p.D <= 64) return launch_tf32<1, 2>(p, stream);
  if (p.D <= 128) return launch_tf32<2, 4>(p, stream);
  return launch_tf32<2, 5>(p, stream);
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
