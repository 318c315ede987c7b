// flash_bwd: the attention backward.  Given q, k, v, the output gradient dO,
// the forward's log-sum-exp `lse` [B, H, Sq] and di = rowsum(O * dO) [B, H, Sq]
// (both fp32), it computes dQ, dK and dV of softmax(q k^T * scale) v, for head
// dims that are multiples of 8 up to 160, in bf16 or fp32 (3xTF32), on
// Hopper's tensor cores (TMA-fed wgmma), with fp32 accumulation.  Two
// kernels, neither with atomics, so results are deterministic run to run:
//
//   flash_bwd_dkv  one block per key tile of one (batch, head) (in fp32, and
//                  64-column slice of the head dims): keeps fp32 dK and dV of
//                  its keys and loops over the query tiles.
//   flash_bwd_dq   one block per query tile of one (batch, head) (in bf16,
//                  where tiles are short, a persistent block takes several;
//                  in fp32, and 64-column slice of the head dims): keeps fp32
//                  dQ of its rows and loops over the key tiles.
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
// fp32 (flash_bwd_dkv_tf32_kernel<NA>, flash_bwd_dq_tf32_kernel<NA>): the
// paths run it on the SDXL trainer's and its textual inversion's two text
// towers (CLIP-L and bigG, causal over 77 tokens) and on the narrow fp32
// train reference's UNet.  At those shapes a grid of 48-80 blocks leaves
// most of the 132 SMs idle and the time is each block's chain of products,
// which 3xTF32 on the tensor cores shortens.  The pieces are the fp32
// forward's (hopper.cuh's 3xTF32 section: TF32 wgmma m64n64k8, A split in
// registers, B split in shared memory, hi*hi + hi*lo + lo*hi):
//   * No transposed TF32 operand: every B is K-major.  dq: s = Q K^T and
//     dp = dO V^T with A = Q, dO (kept, read by ldmatrix) and B = K, V atoms
//     [64 keys][32 head dims] split in place; dQ^T += K^T ds^T with A = k^T
//     built in registers from a K chunk [64 keys][64 head dims]
//     (vt_p_product, as the forward's v^T) and B = the ds tile [64 rows][64
//     keys] (store_p_pair).  dkv: s^T = K Q^T and dp^T = V dO^T with A = K,
//     V (kept) and B = Q, dO atoms; dV^T += dO^T p^T and dK^T += Q^T ds^T
//     with A built from dO and Q chunks and B = the p^T or ds^T tile [64
//     keys][64 query rows].  K and Q are thus read twice (an atom for B, a
//     chunk for A), from L2.
//   * Blocks: 64 rows (dq: query rows; dkv: keys) and one 64-column m-tile
//     of the gradient (grid z), 384 threads.  dq: two consumer warpgroups
//     take the key tiles in turn, each with its own ring, ds tile and sum,
//     added at the end in a fixed order (warpgroup 0's first) through shared
//     memory.  dkv: over every query tile warpgroup 0 computes s^T and
//     p^T, writes p^T to its tile and accumulates dV; warpgroup 1 computes
//     dp^T, reads p^T from that tile (hi + lo: p to 2^-22) for ds^T and
//     accumulates dK, two named barriers a tile handing the tile over; each
//     has its own ring (Q's atoms and dO's chunk, dO's atoms and Q's
//     chunk), so the two chains are about as long.  Warps 8 and 9 (one
//     thread each) feed the two rings (setmaxnreg 24 / 240; consumers wait by mbar_wait_spin, the
//     producers with the time limit).  Two m-tiles of a gradient with s, dp
//     and the part accumulators would not fit a consumer's registers (three
//     m-tiles of the forward's o^T spilled), so at D > 64 each block of a
//     tile recomputes s and dp for its m-tile.
//   * Sums.  The tensor core's fp32 adds truncate.  s adds its k-steps in
//     one accumulator, as the forward's s (the same rounding, so p agrees
//     with the forward's lse).  dp adds each k-step's three products in an
//     accumulator of its own, added by the FPU: dp - di cancels, and dp in
//     one accumulator moved the narrow fp32 train step's LoRA gradients by
//     4.4e-3 of their largest element, over its 1e-3 rule
//     (utils/tf32_accumulation on the CPU; PERF.md).  The gradients add each
//     tile's products (k-step order) in an accumulator of their own, added
//     by the FPU: two-level sums over the tiles.
//   * Softmax in registers: p = exp2(s * scale * log2(e) - lse * log2(e)),
//     ds = p (dp - di), the scale applied to dK and dQ at the store; query
//     rows past Sq, keys past Skv and past the diagonal masked behind one
//     tile-uniform branch.  dq reads its rows' lse and di once; dkv stages
//     a query tile's lse (warpgroup 0) and di (1) in shared memory, loaded
//     under the products.
//   * Copies: TMA with 4-D fp32 maps (D, H, S, B) over the tensors' own
//     strides, 128-byte swizzle, 64 rows a box; the zero fill takes rows
//     past Sq and Skv and columns past D.  Rings of 16 KiB stages (4, 3 or 2
//     a warpgroup: NA = 2, 4, 5 atoms of a kept tensor; 226, 226 and 210
//     KiB of shared memory), full and empty mbarriers.
// The fp32 wrappers copy a view no TMA map can read (stride 0) before
// FlashAttnFn's launches; the kernel entries refuse it (ops/attention).
//
// The largest dynamic shared memory of each instantiation is set once, at
// its first launch.

#include "hopper.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// fp32: 3xTF32 wgmma fed by TMA (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kTfTileBytes = 4 * kTfAtomBytes;  // a B tile [64][64], hi then lo
constexpr int kTfTileLo = 2 * kTfAtomBytes;     // its lo part past its hi part
constexpr int kTfBwdStatBytes = 2 * kTfRows * 4;  // dkv's lse (warpgroup 0) and di (1)
constexpr int tf_bwd_bytes(int na, int stages) {
  return 2 * na * kTfAtomBytes + 2 * kTfTileBytes + 2 * stages * kTfStageBytes +
         kTfBwdStatBytes + 8 * (1 + 4 * stages) + 1024;  // + alignment slack
}
constexpr int tf_bwd_stages(int na) {
  return tf_bwd_bytes(na, 4) <= kSmemLimit ? 4 : tf_bwd_bytes(na, 3) <= kSmemLimit ? 3 : 2;
}

// Shared memory of one block of the fp32 kernels <NA> (NA: the head-dim
// bucket's atoms, D <= 32 NA), in bytes from a 1024-byte aligned base: the
// two tensors a block keeps (dq: Q and dO; dkv: K and V; NA atoms each, as
// TMA wrote them: the A of s and dp, read by ldmatrix), one B tile a
// consumer warpgroup (dq: its ds; dkv: p^T (warpgroup 0) or ds^T (1); hi
// then lo, two atoms [64 rows][32 columns] each), each warpgroup's ring of
// 16 KiB stages (an atom split in place, its lo 8 KiB above, or a chunk
// [64 rows][64 head dims] as TMA wrote it), dkv's row statistics of a
// query tile (warpgroup 0's lse in the log2 domain, warpgroup 1's di), the
// mbarriers (kept_full, then the full and the empty barrier of every
// stage).  As many stages as fit, up to 4 a warpgroup.
template <int NA>
struct TfBwdLayout {
  static constexpr int kStages = tf_bwd_stages(NA);  // a warpgroup's
  static constexpr int kKept = 0;  // tensor t's atom a at kKept + (t NA + a) kTfAtomBytes
  static constexpr int kTile = 2 * NA * kTfAtomBytes;  // warpgroup w's at kTile + w kTfTileBytes
  static constexpr int kRing = kTile + 2 * kTfTileBytes;  // warpgroup w's stages from kRing + w S
  static constexpr int kStats = kRing + 2 * kStages * kTfStageBytes;
  static constexpr int kBar = kStats + kTfBwdStatBytes;
  static constexpr int kBytes = tf_bwd_bytes(NA, kStages);
  static_assert(kBar + 8 * (1 + 4 * kStages) + 1024 == kBytes, "layout");
  static_assert(kBytes <= kSmemLimit, "shared memory of one block");
  // dq's warpgroups exchange half of dQ^T through their own rings
  static_assert(4 * 128 * 16 <= kStages * kTfStageBytes, "merge buffer");
};

// What the two fp32 kernels share: a block's barriers and ring, its
// producer warps, and the products of one consumer warpgroup.
template <int NA>
struct TfBwdBlock {
  using L = TfBwdLayout<NA>;
  static constexpr int S = L::kStages;
  uint32_t base;          // shared address of the aligned base
  unsigned char* gbase;   // generic pointer to it

  __device__ __forceinline__ uint32_t kept_full() const { return base + L::kBar; }
  // stage s of warpgroup w's ring: its barriers and its chunk c's stage
  __device__ __forceinline__ uint32_t full(int w, int s) const {
    return base + L::kBar + 8u * (1 + w * S + s);
  }
  __device__ __forceinline__ uint32_t empty(int w, int s) const {
    return base + L::kBar + 8u * (1 + 2 * S + w * S + s);
  }
  __device__ __forceinline__ int stage_off(int w, int c) const {
    return L::kRing + (w * S + c % S) * kTfStageBytes;
  }

  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      mbar_init(kept_full(), 1);
      for (int s = 0; s < 2 * S; ++s) {
        mbar_init(base + L::kBar + 8u * (1 + s), 1);
        mbar_init(base + L::kBar + 8u * (1 + 2 * S + s), 4);  // the 4 warps of the warpgroup
      }
      init_fence();
    }
    __syncthreads();
  }

  // The producer thread of warpgroup w's ring: `total` chunks, chunk c of
  // them once the 4 warps of the warpgroup have released chunk c - S, each
  // issued by `issue(c, dst, full barrier)`; then the wait for the release of
  // the last ones (these waits trap after kWaitLimitClocks and the
  // consumers' do not, so a copy that never lands traps here).
  template <class Issue>
  __device__ __forceinline__ void feed(int w, int total, Issue issue) const {
    for (int c = 0; c < total; ++c) {
      const int s = c % S;
      if (c >= S) mbar_wait(empty(w, s), ((c / S) & 1) ^ 1);
      issue(c, base + stage_off(w, c), full(w, s));
    }
    for (int c = max(total - S, 0); c < total; ++c) mbar_wait(empty(w, c % S), (c / S) & 1);
  }

  // the kept tensors: `na` atoms each of rows r0 of two maps
  __device__ __forceinline__ void load_kept(const CUtensorMap* m0, const CUtensorMap* m1, int na,
                                            int h, int r0, int b) const {
    mbar_expect_tx(kept_full(), 2 * na * kTfAtomBytes);
    for (int a = 0; a < na; ++a) {
      tma_load(base + L::kKept + a * kTfAtomBytes, m0, kept_full(), a * kF32AtomCols, h, r0, b);
      tma_load(base + L::kKept + (NA + a) * kTfAtomBytes, m1, kept_full(), a * kF32AtomCols, h,
               r0, b);
    }
  }

  // this warp of warpgroup wg is done with chunk c: once all 4 warps of the
  // warpgroup are, the producer refills the stage
  __device__ __forceinline__ void release(int wg, int c) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(wg, c % S));
  }

  // wait for atom chunk c of warpgroup wg and split it (hi in place, lo 8 KiB
  // above), fenced for wgmma's reads
  __device__ __forceinline__ void convert(int wg, int c) const {
    mbar_wait_spin(full(wg, c % S), (c / S) & 1);
    split_atom_tf32(gbase + stage_off(wg, c), threadIdx.x & 127);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
  }

  // acc = a b^T over the head dims (3xTF32, each k-step's products in
  // the order hi*hi, hi*lo, lo*hi) for warpgroup wg: A = its 64 rows of a
  // kept tensor (`a_row`: this lane's ldmatrix row of its first atom), B =
  // the `na` atoms chunks c0 .. c0 + na - 1 of the ring, each split under
  // the previous atom's products and released once its products are done;
  // k-steps past D are skipped.  kFlush = false: one accumulator over the
  // head dims, as the forward's s (so s has the forward's rounding).  kFlush
  // = true (dp): each k-step's products in an accumulator of their own
  // (part), added into acc by the FPU.  The tensor core's adds truncate,
  // and dp - di cancels: with one accumulator the narrow fp32 train step's
  // gradients would miss their rule (PERF.md, utils/tf32_accumulation).
  // (Two part buffers in turn, one k-step's products running while the FPU
  // adds the other's, made ptxas serialize every wgmma of the kernel:
  // C7514.)
  template <bool kFlush>
  __device__ __forceinline__ void headdim_product(int wg, float (&acc)[32], float (&part)[32],
                                                  uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                                  uint32_t a_row, int c0, int na, int D) const {
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    convert(wg, c0);
    for (int x = 0; x < na; ++x) {
      const uint32_t b_atom = base + stage_off(wg, c0 + x);
      const int steps = min(4, (D - x * kF32AtomCols) / 8);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < steps) {
          if constexpr (kFlush) {
            qk_kstep(part, ah[kk & 1], al[kk & 1], a_row + x * kTfAtomBytes, b_atom, kk, 0);
            wgmma_wait<0>();
            reg_fence(part);
#pragma unroll
            for (int r = 0; r < 32; ++r) acc[r] += part[r];
          } else {
            qk_kstep(acc, ah[kk & 1], al[kk & 1], a_row + x * kTfAtomBytes, b_atom, kk,
                     x > 0 || kk > 0);
          }
        }
        if (kk == 0 && x > 0) release(wg, c0 + x - 1);  // its products are done
        if (kk == 0 && x + 1 < na) convert(wg, c0 + x + 1);
      }
    }
    if constexpr (!kFlush) {
      wgmma_wait<0>();
      reg_fence(acc);
    }
    release(wg, c0 + na - 1);
  }

  // acc += a^T b over the 64 rows of a tile (dq: keys; dkv: query rows) for
  // one m-tile of the gradient: A = a^T built in registers from chunk cv
  // (raw [64 rows][64 head dims], split; vt_p_product), B = warpgroup wg's
  // B tile (its rows the gradient's columns, K-major).  The tile's products
  // in k-step order go to an accumulator of their own (part), added into
  // acc by the FPU: the tensor core's adds truncate, a bias that grows with
  // the adds (PERF.md: the order was chosen with utils/tf32_accumulation).
  // The chunk is released once its A is built.
  __device__ __forceinline__ void grad_product(int wg, float (&acc)[32], float (&part)[32],
                                               uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                               int cv) const {
    mbar_wait_spin(full(wg, cv % S), (cv / S) & 1);
    const float* chunk = reinterpret_cast<const float*>(gbase + stage_off(wg, cv));
#pragma unroll
    for (int r = 0; r < 32; ++r) part[r] = 0.f;
    vt_p_product<8, false>(part, ah, al, chunk, base + L::kTile + wg * kTfTileBytes, kTfTileLo,
                           0);
    release(wg, cv);
    wgmma_wait<0>();
    reg_fence(part);
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] += part[r];
  }

  // x (an m64n64 accumulator: row 16 w4 + g (+8), columns 8 j + 2 t4 (+1))
  // into warpgroup wg's B tile, split (store_p_pair), fenced for wgmma and
  // the warpgroup synced
  __device__ __forceinline__ void store_tile(int wg, const float (&x)[32]) const {
    unsigned char* const tile = gbase + L::kTile + wg * kTfTileBytes;
    const int row0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      store_p_pair(tile, kTfTileLo, row0 + 8 * ((i >> 1) & 1), i >> 2, x[i], x[i + 1]);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
  }
};

// Named barriers of a dkv block's two consumer warpgroups (1 is the 256
// consumers', 2 and 3 each warpgroup's own): warpgroup 0 has written a
// query tile's p^T (kPReady), warpgroup 1 has read it (kPFree).
constexpr int kPReady = 4;
constexpr int kPFree = 5;

// One consumer warpgroup of a dkv block, for the block's 64 keys at k0 and
// head dims 64 mi .. + 63.  Per query tile (64 rows at q0): DK = false
// (warpgroup 0), s^T = K Q^T, p^T = exp(scale s^T - lse) in registers,
// masked (query rows past Sq, keys past Skv and past the diagonal), into its
// B tile, then dV^T += dO^T p^T.  DK = true (warpgroup 1), dp^T = V dO^T,
// then ds^T = p^T (dp^T - di) with p^T read from warpgroup 0's tile (0
// where it is masked), into its B tile, then dK^T += Q^T ds^T.  So s^T is
// computed once and the two warpgroups' chains are about as long: dp^T's
// flushed sums against s^T and the softmax.  Returns the m-tile's sum over
// the query tiles, dV^T or dK^T / scale: head dims 16 w4 + g (+8) x keys
// 8 jn + 2 t4 (+1).
template <int NA, bool DK>
__device__ __forceinline__ void dkv_tf32_consume(const TfBwdBlock<NA>& blk, const BwdParams& p,
                                                 int k0, int qt_first, int n,
                                                 float (&acc)[32]) {
  using L = TfBwdLayout<NA>;
  constexpr int wg = DK ? 1 : 0;
  const int lane = threadIdx.x & 31;
  const int w4 = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  const int tid = threadIdx.x & 127;
  const int row0 = 16 * w4 + (lane >> 2);  // this thread's first key of s^T, in the tile
  const float sl2 = p.scale * kTfLog2e;
  const int na = (p.D + kF32AtomCols - 1) / kF32AtomCols;
  const int per = na + 1;  // ring chunks a query tile: na atoms and a chunk
  // A: K's rows (s^T) or V's (dp^T)
  const uint32_t a_row = q_ldmatrix_row(blk.base + L::kKept) + (DK ? NA * kTfAtomBytes : 0);
  float* const stats = reinterpret_cast<float*>(blk.gbase + L::kStats) + wg * kTfRows;
  const float* const row_g =
      (DK ? p.di : p.lse) + static_cast<long long>(blockIdx.y) * p.Sq;
  const unsigned char* const p_tile = blk.gbase + L::kTile;  // warpgroup 0's

#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;
  // s^T (warpgroup 0) or ds^T (1) and the product's part: registers of
  // their own (ptxas serializes every wgmma of a kernel whose accumulators
  // share them)
  float s[32], part[32];
  uint32_t ah[2][4], al[2][4];
  mbar_wait_spin(blk.kept_full(), 0);
  for (int t = 0, c = 0; t < n; ++t, c += per) {
    const int q0 = (qt_first + t) * kTfRows;
    // the tile's lse (log2 domain) or di of query row q0 + tid (tid < 64),
    // loaded under the products and staged after them
    const int qr = q0 + tid;
    float stat = 0.f;
    if (tid < kTfRows && qr < p.Sq) stat = DK ? row_g[qr] : row_g[qr] * kTfLog2e;
    if constexpr (DK) {
      float dp[32];
      blk.template headdim_product<true>(wg, dp, part, ah, al, a_row, c, na, p.D);
      if (tid < kTfRows) stats[tid] = stat;
      named_bar_sync(kPReady, 256);  // warpgroup 0's p^T of this tile, and the stats
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float p0, p1;
        load_p_pair(p_tile, kTfTileLo, row0 + 8 * ((i >> 1) & 1), i >> 2, p0, p1);
        const float2 d2 = *reinterpret_cast<const float2*>(stats + 8 * (i >> 2) + 2 * t4);
        s[i] = p0 * (dp[i] - d2.x);
        s[i + 1] = p1 * (dp[i + 1] - d2.y);
      }
      if (t + 1 < n) named_bar_arrive(kPFree, 256);  // warpgroup 0 may write the next
    } else {
      blk.template headdim_product<false>(wg, s, part, ah, al, a_row, c, na, p.D);
      if (tid < kTfRows) stats[tid] = stat;
      named_bar_sync(2 + wg, 128);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * jn + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          s[i] = exp2_approx(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x)));
        }
      }
      // the mask, behind one tile-uniform branch (most tiles mask nothing)
      if (q0 + kTfRows > p.Sq || k0 + kTfRows > p.Skv || (p.causal && k0 + kTfRows - 1 > q0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int query = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int key = k0 + row0 + 8 * ((i >> 1) & 1);
          if (query >= p.Sq || key >= p.Skv || (p.causal && key > query)) s[i] = 0.f;
        }
      }
      if (t > 0) named_bar_sync(kPFree, 256);  // warpgroup 1 has read the last tile's
    }
    blk.store_tile(wg, s);
    if constexpr (!DK) named_bar_arrive(kPReady, 256);
    // dV^T += dO^T p^T or dK^T += Q^T ds^T
    blk.grad_product(wg, acc, part, ah, al, c + na);
  }
}

// dK and dV of the 64 keys at 64 blockIdx.x of one (batch, head), head dims
// 64 blockIdx.z .. + 63 (a block an m-tile: at D > 64 the blocks of a key
// tile each recompute s^T and dp^T, since two m-tiles of a gradient with
// s^T, dp^T and the parts would not fit a thread's registers), over the
// query tiles that see them.  Warps 0-3 (warpgroup 0) accumulate dV, warps
// 4-7 (warpgroup 1) dK (dkv_tf32_consume); warps 8 and 9 (one thread each)
// feed their rings, warp 8 also the kept K and V.
template <int NA>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  TfBwdBlock<NA> blk;
  blk.base = (raw + 1023u) & ~1023u;
  blk.gbase = smem_raw + (blk.base - raw);
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * kTfRows;
  const int mi = blockIdx.z;
  const int na = (p.D + kF32AtomCols - 1) / kF32AtomCols;
  // causal: query rows below k0 see no key of this block
  const int qt_first = p.causal ? k0 / kTfRows : 0;
  const int n = max((p.Sq + kTfRows - 1) / kTfRows - qt_first, 0);
  const int warp = threadIdx.x >> 5;
  blk.init();

  if (warp >= kConsumerWarps) {
    // ---- producer: warp 8 + w (one thread) feeds warpgroup w, per query
    // tile warpgroup 0 Q's na atoms and dO's chunk of m-tile mi, warpgroup
    // 1 dO's na atoms and Q's chunk.  Warps 10 and 11 only give their
    // registers back.
    setmaxnreg_dec<kTfProducerRegs>();
    const int w = warp - kConsumerWarps;
    if (w < 2 && (threadIdx.x & 31) == 0) {
      if (w == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tdo);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        blk.load_kept(&tk, &tv, na, h, k0, b);
      }
      const CUtensorMap* const atoms = w == 0 ? &tq : &tdo;
      const CUtensorMap* const chunks = w == 0 ? &tdo : &tq;
      blk.feed(w, n * (na + 1), [&](int c, uint32_t dst, uint32_t bar) {
        const int q0 = (qt_first + c / (na + 1)) * kTfRows;
        const int x = c % (na + 1);
        if (x < na) {
          mbar_expect_tx(bar, kTfAtomBytes);
          tma_load(dst, atoms, bar, x * kF32AtomCols, h, q0, b);
        } else {
          mbar_expect_tx(bar, kTfStageBytes);
          tma_load(dst, chunks, bar, 2 * mi * kF32AtomCols, h, q0, b);
          tma_load(dst + kTfAtomBytes, chunks, bar, (2 * mi + 1) * kF32AtomCols, h, q0, b);
        }
      });
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<kTfConsumerRegs>();
  const int wg = warp >> 2;
  float acc[32];
  if (wg == 0)
    dkv_tf32_consume<NA, false>(blk, p, k0, qt_first, n, acc);
  else
    dkv_tf32_consume<NA, true>(blk, p, k0, qt_first, n, acc);
  // the transposed sum: keys < Skv, head dims < D; dK takes the scale
  const int lane = threadIdx.x & 31;
  const int w4 = warp & 3;
  float* const out = wg == 0 ? static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh
                             : static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  const long long ss = wg == 0 ? p.dv_ss : p.dk_ss;
  const float mul = wg == 0 ? 1.f : p.scale;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * jn + 2 * (lane & 3) + (e & 1);
      const int d = 64 * mi + 16 * w4 + (lane >> 2) + 8 * (e >> 1);
      if (key < p.Skv && d < p.D) out[static_cast<long long>(key) * ss + d] = acc[4 * jn + e] * mul;
    }
}

// dQ of the 64 query rows at 64 blockIdx.x of one (batch, head), head dims
// 64 blockIdx.z .. + 63 (as dkv: a block an m-tile).  Warpgroups 0 and 1
// take the key tiles in turn (w the tiles w, w + 2, ...), each with its own
// ring, ds tile and sum; per key tile s = Q K^T and dp = dO V^T, ds = p (dp
// - di) into its tile, dQ^T += K^T ds^T.  At the end they add their sums,
// warpgroup 0's first, each storing half of the rows.  Warps 8 and 9 (one
// thread each) feed the rings (per key tile K's na atoms, V's, K's chunk of
// m-tile z), warp 8 also the kept Q and dO.
template <int NA>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using L = TfBwdLayout<NA>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  TfBwdBlock<NA> blk;
  blk.base = (raw + 1023u) & ~1023u;
  blk.gbase = smem_raw + (blk.base - raw);
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kTfRows;
  const int mi = blockIdx.z;
  const int na = (p.D + kF32AtomCols - 1) / kF32AtomCols;
  const int per = 2 * na + 1;  // ring chunks a key tile
  int n_tiles = (p.Skv + kTfKeys - 1) / kTfKeys;
  if (p.causal) n_tiles = min(n_tiles, q0 / kTfKeys + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  blk.init();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kTfProducerRegs>();
    const int w = warp - kConsumerWarps;
    if (w < 2 && lane == 0) {
      if (w == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tdo);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        blk.load_kept(&tq, &tdo, na, h, q0, b);
      }
      blk.feed(w, (n_tiles - w + 1) / 2 * per, [&](int c, uint32_t dst, uint32_t bar) {
        const int k0 = (w + 2 * (c / per)) * kTfKeys;
        const int x = c % per;
        if (x < per - 1) {
          mbar_expect_tx(bar, kTfAtomBytes);
          tma_load(dst, x < na ? &tk : &tv, bar, (x % na) * kF32AtomCols, h, k0, b);
        } else {
          mbar_expect_tx(bar, kTfStageBytes);
          tma_load(dst, &tk, bar, 2 * mi * kF32AtomCols, h, k0, b);
          tma_load(dst + kTfAtomBytes, &tk, bar, (2 * mi + 1) * kF32AtomCols, h, k0, b);
        }
      });
    }
    return;
  }

  // ---- consumers: warpgroup wg; s and dp hold rows 16 w4 + g (+8) and keys
  // 8 j + 2 t4 (+1), dQ^T head dims 16 w4 + g (+8) and rows 8 jn + 2 t4 (+1)
  setmaxnreg_inc<kTfConsumerRegs>();
  const int wg = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tid = threadIdx.x & 127;
  const int row0 = q0 + 16 * w4 + g;  // this thread's first query row of s
  const float sl2 = p.scale * kTfLog2e;
  const uint32_t q_row = q_ldmatrix_row(blk.base + L::kKept);
  // lse (log2 domain) and di of rows row0 and row0 + 8; rows past Sq read
  // nothing (their Q and dO rows are zero, so their ds is too)
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = static_cast<long long>(blockIdx.y) * p.Sq + row0 + 8 * r;
    lse2[r] = row0 + 8 * r < p.Sq ? p.lse[at] * kTfLog2e : 0.f;
    dd[r] = row0 + 8 * r < p.Sq ? p.di[at] : 0.f;
  }

  float acc[32];  // dQ^T / scale over this warpgroup's key tiles
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;
  // s, dp and the product's part: registers of their own (as dkv's)
  float s[32], dp[32], part[32];
  uint32_t ah[2][4], al[2][4];
  mbar_wait_spin(blk.kept_full(), 0);
  for (int j = wg, c = 0; j < n_tiles; j += 2, c += per) {
    blk.template headdim_product<false>(wg, s, part, ah, al, q_row, c, na, p.D);
    blk.template headdim_product<true>(wg, dp, part, ah, al, q_row + NA * kTfAtomBytes, c + na,
                                       na, p.D);
    // ds = p (dp - di) kept in s, then 0 for keys past Skv and past the
    // diagonal (a tile-uniform branch)
    const int k0 = j * kTfKeys;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], sl2, -lse2[r])) * (dp[i] - dd[r]);
    }
    if (k0 + kTfKeys > p.Skv || (p.causal && k0 + kTfKeys - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key >= p.Skv || (p.causal && key > row0 + 8 * ((i >> 1) & 1))) s[i] = 0.f;
      }
    }
    blk.store_tile(wg, s);
    blk.grad_product(wg, acc, part, ah, al, c + per - 1);
  }

  // ---- the two warpgroups' sums: warpgroup wg stores rows 32 wg .. +31
  // (dQ^T's n8 tiles jn = 4 wg .. +3) and sends the other warpgroup its sum
  // of the other rows through its own ring (every chunk of it is consumed).
  // The loops run over all 8 n8 tiles behind a warpgroup-uniform test, so
  // that acc is indexed by constants.
  float4* const send = reinterpret_cast<float4*>(blk.gbase + blk.stage_off(wg, 0));
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    if ((jn >> 2) == wg) continue;
    send[(jn & 3) * 128 + tid] =
        make_float4(acc[4 * jn], acc[4 * jn + 1], acc[4 * jn + 2], acc[4 * jn + 3]);
  }
  named_bar_sync(1, 256);
  const float4* const recv =
      reinterpret_cast<const float4*>(blk.gbase + L::kRing + (wg ^ 1) * S * kTfStageBytes);
  float* const dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    if ((jn >> 2) != wg) continue;
    const float4 peer = recv[(jn & 3) * 128 + tid];
    const float pv[4] = {peer.x, peer.y, peer.z, peer.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float own = acc[4 * jn + e];
      const float o0 = wg ? pv[e] : own, o1 = wg ? own : pv[e];
      const int row = q0 + 8 * jn + 2 * t4 + (e & 1);
      const int d = 64 * mi + 16 * w4 + g + 8 * (e >> 1);
      if (row < p.Sq && d < p.D) dqg[static_cast<long long>(row) * p.dq_ss + d] = (o0 + o1) * p.scale;
    }
  }
}

template <int NA, bool kDKV>
cudaError_t launch_tf32(const BwdParams& p, cudaStream_t stream) {
  using L = TfBwdLayout<NA>;
  auto kernel = flash_bwd_dq_tf32_kernel<NA>;
  if constexpr (kDKV) kernel = flash_bwd_dkv_tf32_kernel<NA>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_map_f32(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kTfRows) ||
      !encode_map_f32(&tdo, p.dout, p.D, p.H, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb, kTfRows) ||
      !encode_map_f32(&tk, p.k, p.D, p.H, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, kTfKeys) ||
      !encode_map_f32(&tv, p.v, p.D, p.H, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, kTfKeys))
    return cudaErrorInvalidValue;
  // a block per 64 keys (dkv) or query rows (dq) and m-tile of the gradient
  const dim3 grid(((kDKV ? p.Skv : p.Sq) + kTfRows - 1) / kTfRows, p.B * p.H, (p.D + 63) / 64);
  kernel<<<grid, kWsThreads, L::kBytes, stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

template <bool kDKV>
cudaError_t dispatch_f32(const BwdParams& p, cudaStream_t stream) {
  // atoms of the kept tensors: D <= 64, D <= 128, D <= 160
  if (p.D <= 64) return launch_tf32<2, kDKV>(p, stream);
  if (p.D <= 128) return launch_tf32<4, kDKV>(p, stream);
  return launch_tf32<5, kDKV>(p, stream);
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
