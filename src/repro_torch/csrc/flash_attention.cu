// Hopper (sm_90a) flash attention with a plain C interface loaded through
// ctypes (repro_torch/kernels/flash_attention.py).
//
// flash_attention_fwd  replaces repro/kernels/flash_attention.py:72
//                      ::flash_attention_pallas (_kernel), together with the
//                      GQA head repeat and the 128-lane D padding that
//                      repro/kernels/ops.py::flash_attention adds around it
//
// What it computes, as _kernel does: online-softmax attention over q (B,
// Sq, H, D), k (B, Sk, Hkv, D) and v (B, Sk, Hkv, Dv), read in place
// through their strides, into o (B, Sq, H, Dv) (Dv = D but for MLA's (192,
// 128), as the reference's repro/models/blocks.py::flash_attention takes
// v's width; the Pallas kernel assumes Dv = D; Sq = Sk but for a
// non-causal call without a window, whisper-base's cross-attention of
// its decoder's tokens over the encoder's 1500 frames, which the
// reference's blocks.flash_attention computes and the Pallas kernel does
// not). The
// scores and the accumulator are float32; the scale D^-0.5 is applied to the
// float32 scores after the dot; masked scores are NEG_INF = -1e30 with the
// reference's m_safe / alpha guards; the row sum l adds the float32 p, while
// the P.V product takes p rounded to v's type (p.astype(v.dtype)); the
// output is acc / max(l, 1e-30) in q's type. With a sliding window W (the
// local attention of repro/models/blocks.py::flash_attention, `window`),
// key col is visible to query row only where row - col < W as well.
//
// Common to every kernel: the TPU's sequential kv grid axis becomes a loop
// over kv tiles inside the block, with m, l and the accumulator carried in
// registers. With `causal`, the loop ends at the last kv tile that is not
// wholly in the future of the q tile, so the causal half of the work is
// skipped, not masked; with a window it starts at the kv tile of the q
// tile's first row's oldest visible key, so the tiles wholly behind the
// window are skipped too. Query head h reads kv head h / (H / Hkv) directly:
// no repeated K/V. A ragged tail is masked: kv columns past Sk score
// NEG_INF, q rows past Sq are not stored. The q tiles (the work items and
// the grid) count Sq, and the kv tiles, the key mask and K's and V's
// tensor maps and loads Sk (FlashGeom::kv_seq). q tiles are issued
// last-first so the long causal rows start early. One kernel serves each
// (dtype, D, window or not): the window is a template flag (kWindow), so
// each kernel has an instance without it, whose code is the one it had
// before the window existed, and one with it (its bounds, its mask):
//
//  * bf16, D = 16, 32, 64, 80, 128: flash_wgmma_kernel<D>, the Hopper
//    design, one instance per head dim (D 128: every dense serving config
//    but stablelm-3b; D 80: stablelm-3b; D 64, 32, 16: the reduced
//    configs and narrow-headed models). Bound: at
//    granite-8b's prefill (B 4, S 2048, H 32, Hkv 8, D 128, causal) one
//    launch does 4*B*H*S(S+1)/2*D = 137 GFLOP, 0.139 ms at the 989 TFLOP/s
//    bf16 tensor-core peak, against 0.050 ms for the 168 MB of q, k, v and
//    o at 3.35 TB/s; at stablelm-3b's (B 4, S 2048, H 32 MHA, D 80) 86
//    GFLOP, 0.087 ms, against 0.063 ms for its 210 MB. Both are bound by
//    the tensor cores, which only wgmma reaches at full rate, as long as
//    the K and V tiles that the causal loop reads again and again come
//    from L2 (stablelm-3b's 84 MB of K and V do not fit in its 50 MB at
//    once). The mma.sync design (fragments fed by synchronous loads between
//    two block barriers per kv tile) ran at 9.5x and 14.8x those bounds. So:
//     - 3 warpgroups: a producer that keeps TMA loads in flight and two
//       consumers of 64 q rows each of a 128-row q tile; setmaxnreg moves
//       the producer's registers to the consumers;
//     - persistent: one block per SM walks pairs of (q tile, b*H) work
//       items, each pair the i-th longest and the i-th shortest causal q
//       tile of one head (equal sums of kv tiles for every block), the
//       pairs in head order, so the ~17 heads in flight keep their K and V
//       in L2; one tile's tail (last product, stores) overlaps the next
//       tile's Q and K loads;
//     - TMA with 128-byte swizzle through rank-4 tensor maps over (D, S,
//       H, B) encoded per call from the operands' strides (no copies of a
//       sliced packed projection). A tile row is ceil(D / 64) boxes of 64
//       columns (128 bytes, one swizzle row): columns D..127 of D 80's
//       second box and rows past S arrive as zeros, so a head sliced out
//       of a packed projection never reads its neighbour;
//     - shared memory: the Q tile and a ring of 3 stages of K and V tiles
//       (32 KB tiles at D 80 and 128, 225 KB in all, just under the 227 KB
//       a block may have; 16 KB tiles at D 64); full and empty mbarriers
//       for K and V apart, so S = QK^T starts before V lands and K is
//       refilled as soon as its scores are in;
//     - S = QK^T by wgmma m64n128k16 over D / 16 k-steps (5 at D 80, no
//       pad to 128), Q and K from shared memory, float32 accumulator in
//       registers; the softmax stays in registers (quad shuffles, the max
//       over raw scores, e^(scale (s - m)) as ex2.approx of one FMA with
//       the scale folded in), and the mask compare runs on the last kv
//       tile only (the diagonal and the ragged tail);
//     - O += bf16(P) V by wgmma m64nDk16 (D / 2 accumulator registers a
//       thread) with A = P straight from the registers of the first
//       product's accumulator (its fragment layout) and V from shared
//       memory through a transposed (MN-major) descriptor: no transposed
//       copy exists anywhere. At D 80 the product spans the first 64-column
//       swizzled box and 16 columns of the second;
//     - overlap: a consumer issues S of tile j + 1 before O += P_j V_j and
//       runs tile j + 1's softmax while that product is in flight, and the
//       two consumers take turns to issue (ping-pong on named barriers), so
//       one's softmax runs under the other's wgmmas.
//  * bf16, D = 256: flash_wgmma_kernel<256> (recurrentgemma-2b: 10 heads
//    over 1 kv head, a 2048-key window). The same design with a layout of
//    its own: a 128 x 256 Q tile is 64 KB, and a consumer's 64 x 256 float32
//    accumulator is 128 registers a thread. So the kv tiles have 80 rows
//    (40 KB K and V tiles, in 2 stages: 224 KB with Q), S is m64n80k16 over
//    16 k-steps (40 registers), P.V m64n256k16 over 5, and S, P and O fit
//    the consumers' 240 registers under setmaxnreg; the consumers issue
//    without taking turns. With kv tiles shorter than the q tile and not
//    aligned to it, the causal diagonal spans the last two or three kv
//    tiles, each masked. The work items are not paired: a block takes the
//    next from a counter in global memory, every head's longest q tile
//    first (its 640 items at recurrentgemma-2b's prefill are 2.42 rounds
//    of the static pairs on 132 SMs, done in 3). A call whose window hides
//    no key (S 2048 at recurrentgemma-2b's 2048-key window) runs the
//    instance without it. Bound at recurrentgemma-2b's prefill (B 4, S
//    2048, H 10, Hkv 1, causal, the window masking nothing there): 85.9
//    GFLOP, 0.087 ms at the tensor-core peak, against 0.028 ms for its 92
//    MB.
//  * bf16, D = 112: flash_wgmma_kernel<112> (kimi-k2: 64 heads over 8 kv
//    heads). The D 128 layout (a tile row is two 64-column boxes, the
//    second read 48 columns wide: its map ends at column 112, so the rest
//    arrive as zeros; 7 k-steps of m64n128k16 scores, m64n112k16 for P.V,
//    56 accumulator registers a consumer thread; 3 stages of 32 KB tiles)
//    with consumers of their own (chained_consumer, HopperLayout::kChained).
//    Bound at kimi-k2's prefill (B 4, S 2048, H 64, Hkv 8, causal): 2
//    products of 112 multiply-adds a visible pair, 240 GFLOP, 0.243 ms at
//    the tensor-core peak, against 0.079 ms for its bytes and 0.128 ms for
//    its exponentials. Timed without each stage there (scripts/flash_ab.py
//    --diagnose, H100), the D 128 design lost no more than 8% of its time
//    to the softmax, 5% to the K/V copies and 2% to the rescale; but a
//    causal call of its 4,096 work items took 0.60 of the non-causal one
//    for 0.53 of its kv tiles: the cost sat at each item's boundary, where
//    both consumers waited for the first tile's scores and softmax and the
//    tensor cores for the last tile's product and the store. So a consumer
//    chains its items: the next item's first S is issued with this item's
//    last P.V and its softmax runs under that product; the output is
//    stored with one reciprocal a row (an IEEE division an element there
//    cost 6%); and the rescale of the accumulator runs between the next
//    S's issue and the P.V's, under the S.
//  * bf16, D = 192 with Dv = 128: flash_wgmma_kernel<192> (deepseek-v2's
//    MLA prefill: q and k carry 128 nope and 64 rope columns, v 128; 128
//    heads, MHA after the latent's expansion). The only D 192 instance:
//    HopperLayout<192>::kDv is 128, the width of V, of the second product
//    and of the output, and every other instance has Dv = D. Scores over
//    12 k-steps in 3 boxes, P.V m64n128k16; a 48 KB Q tile, and stages of
//    a 48 KB K and a 32 KB V tile, 2 of them (208 KB): 3 would need 288.
//    The scale is 192^-0.5, q's width, as the reference's. Bound at its
//    prefill (B 4, S 2048, H 128, causal): 2 (192 + 128) multiply-adds a
//    visible pair, 687 GFLOP, 0.695 ms, against 0.401 ms for its bytes and
//    0.257 ms for its exponentials.
//    At D 16 and 32 one score costs 4 D = 64-128 tensor-core FLOP but one
//    exponential, so the special-function unit (16 a clock an SM), not the
//    tensor cores, sets the floor: at granite-8b's prefill traffic 0.064
//    ms for the 269 M exponentials against 0.035 (D 32) of products. The
//    same design serves it (the folded-scale ex2, the mask on the last
//    tile only), but without the consumers' turns: its products are too
//    short to cover the other consumer's softmax, and the turns only
//    delayed the issue. A D 16 or 32 row is one 64-column box whose map ends
//    at column D (zeros past it; no neighbouring head of a packed
//    projection is read), and the second product reads the first D
//    columns of that swizzled box (m64n16k16 / m64n32k16).
//  * float32, D = 16, 32, 64, 80, 128: flash_ffma_kernel<D>, IEEE FFMA (no
//    TF32, no tensor core). Bound: the FFMA peak (67 TFLOP/s): at
//    granite-8b's prefill traffic 137 GFLOP at D 128, 2.05 ms; 17 GFLOP at
//    D 16, 0.26 ms. So every operand comes in 16-byte shared loads that
//    feed 5-16 FFMA each, and nothing else waits on memory:
//     - 8 warps, each owning 16 of the block's 128 q rows: the softmax's
//       row reductions are warp shuffles, P passes through the warp's own
//       shared rows (__syncwarp, no block barrier), and a warp skips a kv
//       tile wholly in its rows' future;
//     - a lane holds 8 rows x 4 columns of a 64-column kv tile's S (each Q
//       load feeds 16 FFMA, each K load 32) and kORows x 4 kChunks of O
//       (each P load 16 kChunks FFMA, each V load 4 kORows); Q and K rows
//       padded by one float4 so 8 consecutive rows fall on 8 distinct bank
//       quads, and no P store or load meets a bank conflict;
//     - K and V by cp.async, one buffer each, staggered: K_{j+1} loads
//       under P_j V_j, V_{j+1} under S_{j+1} (three block barriers a tile);
//       at D 16 and 32 two blocks share an SM (128 registers a thread), so
//       one block's barriers and loads run under the other's products;
//     - the folded-scale ex2 of the wgmma kernel, the mask only on tiles
//       that reach past a warp's first row or past S, the row sum l kept
//       per lane and reduced once at the end.
#include <cstdint>
#include <cstdio>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

}  // namespace

// Mirror: FlashGeom in repro_torch/kernels/cuda_lib.py. Strides in elements.
// `window` and `kv_seq` come last, so the other fields keep their offsets.
// `seq` is q's (and o's) length, `kv_seq` k's and v's; they differ only
// in a non-causal call without a window (flash_attention_fwd refuses the
// rest)
struct FlashGeom {
  int32_t batch, seq, heads, kv_heads, causal;
  float scale;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int32_t window;   // > 0: the sliding window (read by kWindow instances)
  int32_t kv_seq;
};

namespace {

struct Tile {
  int q0, b, h, hk, kv0, n_kv;   // kv tiles kv0 .. kv0 + n_kv - 1
};

// q tile qi (counted from the last, so the long causal rows come first) of
// batch * head bh, for BM-row q tiles and BN-row kv tiles
template <int BM, int BN, bool kWindow>
__device__ Tile tile_of(const FlashGeom& g, int qi, int bh) {
  Tile t;
  const int n_qb = (g.seq + BM - 1) / BM;
  t.q0 = (n_qb - 1 - qi) * BM;
  t.b = bh / g.heads;
  t.h = bh % g.heads;
  t.hk = t.h / (g.heads / g.kv_heads);
  const int last_row = min(t.q0 + BM, g.seq) - 1;
  // causal: kv tiles wholly in the future of the q tile are never visited;
  // a window: nor those wholly behind its first row's oldest visible key
  t.kv0 = kWindow ? max(t.q0 - g.window + 1, 0) / BN : 0;
  t.n_kv =
      (g.causal ? last_row / BN + 1 : (g.kv_seq + BN - 1) / BN) - t.kv0;
  return t;
}

template <bool kWindow>
__device__ __forceinline__ bool visible(const FlashGeom& g, int row, int col) {
  return col < g.kv_seq && (!g.causal || row >= col) &&
         (!kWindow || row - col < g.window);
}

// ---------------------------------------------------------------------------
// bf16 D = 16, 32, 64, 80, 128: warp-specialised wgmma kernel fed by TMA
// through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kHopperBM = 128;        // q rows per block: 2 consumers x 64
constexpr int kHopperThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kBoxCols = 64;          // 128 bytes of bf16: one swizzle row

// shared-memory layout of flash_wgmma_kernel<D>: the Q tile at 0, then
// stage s's K tile at kKOff + s kStageBytes and its V tile after it, then
// the mbarriers. A tile row is kBoxes boxes of 64 columns; a box holds the
// tile's rows at 128 bytes a row (kQBoxBytes, kBoxBytes apart)
// kv rows per tile at D 256 (see HopperLayout::kBN)
constexpr int kD256KvRows = 80;
// the value width of head dim 192, deepseek-v2's MLA: q and k carry 128
// nope and 64 rope columns, v 128 (see HopperLayout::kDv)
constexpr int kMlaValueDim = 128;

template <int D>
struct HopperLayout {
  // the width of V and of the output: D, but at D 192 MLA's 128. D 192 is
  // built only as that pair, so the instance keeps the one-number name
  // flash_wgmma_kernel<192, W>; every other instance has Dv == D, and all
  // that follows equals what it was before the value width existed
  static constexpr int kDv = D == 192 ? kMlaValueDim : D;
  // kv rows per tile: 128, and kD256KvRows (80) at D 256, where a
  // consumer's 64 x 256 accumulator takes 128 registers and 128-row S (64)
  // and P (32) would not fit beside it under setmaxnreg's 240; 80-row S
  // (40) and P (20) do, and each 80-row tile pays one barrier round, one
  // softmax and one rescale of the accumulator for 80 keys where a 64-row
  // tile paid them for 64
  static constexpr int kBN = D == 256 ? kD256KvRows : 128;
  // K/V ring depth: 32 KB tiles (D 80, 112, 128) fill a block's shared
  // memory at 3 stages. 16 KB tiles (D 16 to 64) would leave room for 5 or
  // 6, but those ran no faster than 3 (scripts/flash_ab.py), so those have
  // 3. At D 256 the 64 KB Q tile leaves room for 2 stages of 40 KB K and V
  // tiles; at D 192 the 48 KB Q tile for 2 of a 48 KB K and a 32 KB V tile
  static constexpr int kStages = D == 256 || D == 192 ? 2 : 3;
  // Work items handed out at run time, longest first, from a counter in
  // global memory (flash_wgmma_kernel), in place of the static pairs. At D
  // 256 recurrentgemma-2b's prefill has 640 items, 320 pairs on 132 SMs:
  // 2.42 rounds of pairs done in 3, some 81% of the card busy; handed out
  // longest first, the short items fill the last round's gaps
  static constexpr bool kDynamic = D == 256;
  // The consumers take turns to issue their products (ping-pong), so one's
  // softmax runs under the other's wgmmas. At D 16 and 32 the products are
  // too short to cover a softmax, and the turns only delay the issue:
  // without them D 32 and 16 ran 7% and 10% faster (scripts/flash_ab.py).
  // At D 256 without the turns it ran 1.8% faster at S 2048 and 8192
  // (scripts/flash_ab.py, H100)
  static constexpr bool kPingPong = D > 32 && D < 256;
  // At D 112 (kimi-k2) a consumer chains its work items: the next item's
  // first S is issued with this item's last P V (chained_consumer; why:
  // the D 112 entry at the top of this file)
  static constexpr bool kChained = D == 112;
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;  // per row
  static constexpr int kVBoxes = (kDv + kBoxCols - 1) / kBoxCols;  // of V
  static constexpr int kQBoxBytes = kHopperBM * kBoxCols * 2;
  static constexpr int kBoxBytes = kBN * kBoxCols * 2;     // a K or V box
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;    // a K tile
  static constexpr int kVTileBytes = kVBoxes * kBoxBytes;  // a V tile
  static constexpr int kStageBytes = kTileBytes + kVTileBytes;
  static constexpr int kScores = kBN / 2;   // S registers of a consumer thread
  static constexpr int kKOff = kQTileBytes;
  static constexpr int kBarOff = kQTileBytes + kStages * kStageBytes;
  // the slot through which the producer names each work item it hands out
  static constexpr int kSlotOff = kBarOff + 8 * (2 + 4 * kStages);
  // + 2 Q and 4 per stage K/V barriers (+ the slot) + the 1024-byte
  // alignment
  static constexpr int kSmem = kSlotOff + (kDynamic ? 8 : 0) + 1024;
  static_assert(D % 16 == 0 && kSmem <= 232448, "shared memory");
};

// whether a consumer masks the scores of kv tile [k0, k0 + BN) of the q
// tile at q0: the last tile (the causal diagonal, the ragged tail) where kv
// tiles are as tall as q tiles; else also the diagonal's other tiles and,
// with a window, the tiles that reach behind some row's window
template <int BN, bool kWindow>
__device__ __forceinline__ bool masked_tile(const FlashGeom& g, int q0,
                                            int k0, bool last) {
  if constexpr (!kWindow && BN == kHopperBM) {
    return last;
  } else {
    return last || (g.causal && k0 + BN - 1 > q0) ||
           (kWindow && k0 <= q0 + kHopperBM - 1 - g.window);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one (64 columns, 128 rows) box of a rank-4 (D, S, heads, B) tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(s0),
         "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets lbo / sbo
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// the k-th work item of a persistent block (see flash_wgmma_kernel): block
// b of G takes items 2 (r G + b) and 2 (r G + b) + 1 in round r = k / 2
__device__ __forceinline__ int item_of(int k) {
  return 2 * ((k >> 1) * static_cast<int>(gridDim.x) +
              static_cast<int>(blockIdx.x)) + (k & 1);
}

// item -> tile: items run head-major (b * H + h) and, within a head, zigzag
// over its n_qb q tiles: the longest causal tile, the shortest, the second
// longest, ... (tile_of counts q tiles from the last). The map is one to one
// whatever the tiles' lengths: past a window they flatten out (every tile
// ~W / BN kv tiles), and the pairs are then merely equal already
template <int BN, bool kWindow>
__device__ __forceinline__ Tile hopper_tile(const FlashGeom& g, int item,
                                            int n_qb) {
  const int z = item % n_qb;
  const int qi = (z & 1) ? n_qb - 1 - z / 2 : z / 2;
  return tile_of<kHopperBM, BN, kWindow>(g, qi, item / n_qb);
}

// The dynamic schedule (HopperLayout::kDynamic): block b's first item is b,
// each later one comes from g_next_item (items gridDim.x + n), handed out
// in rank order over the heads (dynamic_tile): every head's longest q tile
// first, then every head's second longest, and so on, so the shortest come
// last and fill the gaps. The producer takes an item as soon as the last
// one's Q loads are issued, and names it to the consumers through a slot in
// shared memory (written before the Q barrier's arrival, read after its
// wait); n_items in the slot ends the block. The last block to finish sets
// both counters back to 0, so each launch starts from 0 with no memset of
// its own (two launches of the library must not run at once on one card)
__device__ int g_next_item = 0;
__device__ int g_blocks_done = 0;

template <int BN, bool kWindow>
__device__ __forceinline__ Tile dynamic_tile(const FlashGeom& g, int item) {
  const int bh = g.batch * g.heads;
  return tile_of<kHopperBM, BN, kWindow>(g, item / bh, item % bh);
}

template <int D, bool kWindow>
__device__ __forceinline__ Tile work_tile(const FlashGeom& g, int item,
                                          int n_qb) {
  using L = HopperLayout<D>;
  if constexpr (L::kDynamic)
    return dynamic_tile<L::kBN, kWindow>(g, item);
  else
    return hopper_tile<L::kBN, kWindow>(g, item, n_qb);
}

__device__ __forceinline__ void st_shared(uint32_t addr, int v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// the producer's k-th item: the static pairs' (item_of) or `next`, the one
// it took from the counter
template <bool kDynamic>
__device__ __forceinline__ int producer_item(int k, int next) {
  if constexpr (kDynamic)
    return k == 0 ? static_cast<int>(blockIdx.x) : next;
  else
    return item_of(k);
}

// the consumers' k-th item: the static pairs', or the slot's once Q's
// barrier for it has completed (their later wait on it returns at once)
template <bool kDynamic>
__device__ __forceinline__ int consumer_item(int k, uint32_t slot,
                                             uint32_t q_full) {
  if constexpr (kDynamic) {
    mbar_wait(q_full, k & 1);
    return ld_shared(slot);
  } else {
    return item_of(k);
  }
}

// named barriers over the 256 consumer threads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// e^(scale (s - m)) as 2^(s c - m c) with c = scale log2 e: the scale is
// applied in float32 after the dot, inside the exponent's one FMA, and the
// special-function unit's ex2.approx (about 2 ulp) does the rest, the
// flash-attention idiom; expf's exact range reduction costs several
// instructions for each score. mc is m c
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp_diff(float s, float c, float mc) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fmaf(s, c, -mc)));
  return y;
}

// Register fences: an empty asm that "reads and writes" the registers, so
// the compiler keeps their accesses on this side of the neighbouring
// (volatile) wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int NK>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e]) :: "memory");
}

// the accumulator operands of a wgmma: registers %0 .. %(n - 1), in
// pieces of 8, 8, 16, 8, 16, 8 and 64 for n = 8 (N 16), 16 (N 32), 32 (N
// 64), 40 (N 80), 56 (N 112), 64 (N 128) and 128 (N 256)
#define WG_R0_7 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R0_15 WG_R0_7 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R0_31                                                            \
  WG_R0_15 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define WG_R32_39 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R40_55                                                           \
  ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55"
#define WG_R40_63 WG_R40_55 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R64_127                                                          \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "   \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "   \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WG_D8 "{" WG_R0_7 "}"
#define WG_D16 "{" WG_R0_15 "}"
#define WG_D32 "{" WG_R0_31 "}"
#define WG_D40 "{" WG_R0_31 WG_R32_39 "}"
#define WG_D56 "{" WG_R0_31 WG_R32_39 WG_R40_55 "}"
#define WG_D64 "{" WG_R0_31 WG_R32_39 WG_R40_63 "}"
#define WG_D128 "{" WG_R0_31 WG_R32_39 WG_R40_63 WG_R64_127 "}"
#define WG_OUT0_7(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7])
#define WG_OUT0_15(d)                                                       \
  WG_OUT0_7(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_OUT0_31(d)                                                       \
  WG_OUT0_15(d),                                                            \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define WG_OUT32_39(d)                                                      \
  , "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define WG_OUT40_55(d)                                                      \
  , "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),        \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
  "+f"(d[55])
#define WG_OUT40_63(d)                                                      \
  WG_OUT40_55(d), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_OUT64_127(d)                                                     \
  , "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]),        \
  "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),          \
  "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),          \
  "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),          \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]),          \
  "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]),          \
  "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]),          \
  "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),      \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),     \
  "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),     \
  "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),     \
  "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),     \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define WG_OUT32(d) WG_OUT0_31(d)
#define WG_OUT40(d) WG_OUT0_31(d) WG_OUT32_39(d)
#define WG_OUT56(d) WG_OUT0_31(d) WG_OUT32_39(d) WG_OUT40_55(d)
#define WG_OUT64(d) WG_OUT0_31(d) WG_OUT32_39(d) WG_OUT40_63(d)
#define WG_OUT128(d) WG_OUT64(d) WG_OUT64_127(d)

// d (64 x N, f32) = [d +] A B^T: A (64 x 16) and B (N x 16) K-major in
// shared memory; scale_d = 0 overwrites d. N is the kv tile's height: 128,
// and 80 at D 256 (64 timed against it)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 80 || N == 128, "wgmma_ss: N 64, 80, 128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " WG_D40
        ", %40, %41, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT40(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x N, f32) += A B: A (64 x 16) bf16 fragments in registers, B
// (16 x N) MN-major in shared memory (the transpose bit); N = Dv. At N 16
// and 32 the product reads the first N columns of a 64-column swizzled
// box, at N 80 and 112 16 and 48 of the second
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 80 || N == 112 ||
                N == 128 || N == 256,
                "wgmma_rs: N 16, 32, 64, 80, 112, 128, 256");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " WG_D8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_OUT0_7(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_OUT0_15(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " WG_D40
        ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : WG_OUT40(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 112) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 " WG_D56
        ", {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : WG_OUT56(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_OUT64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : WG_OUT128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// issue S = Q K^T for one kv tile: D / 16 k-steps of 16 columns, 4 in each
// 64-column box (1 and 2 at D 16 and 32, 5 at D 80, 7 at D 112: the zero
// columns past D are never read; 12 over 3 boxes at D 192);
// q_rows / k_tile are the shared addresses of the consumer's 64 Q rows and
// of the K tile
template <int D>
__device__ __forceinline__ void issue_scores(
    float (&s)[HopperLayout<D>::kScores], uint32_t q_rows, uint32_t k_tile) {
  using L = HopperLayout<D>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<L::kBN>(s, smem_desc(q_rows + (kk / 4) * L::kQBoxBytes + off,
                                  16, 1024),
                     smem_desc(k_tile + (kk / 4) * L::kBoxBytes + off, 16,
                               1024), kk > 0);
  }
}

// issue O += bf16(P) V for one kv tile: V (kv rows x Dv) is MN-major for
// this product; a k-step is 16 kv rows (2048 bytes), the 64-column boxes
// lie kBoxBytes apart (the leading byte offset; at D 80 and 112 the product
// reads 16 and 48 columns of the second), 8-row groups 1024 bytes (the
// stride byte offset)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[HopperLayout<D>::kDv / 2],
    const uint32_t (&pa)[HopperLayout<D>::kBN / 16][4], uint32_t v_tile) {
  constexpr int kBoxBytes = HopperLayout<D>::kBoxBytes;
  constexpr int Dv = HopperLayout<D>::kDv;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HopperLayout<D>::kBN / 16; ++kk)
    wgmma_rs<Dv>(acc, pa[kk], smem_desc(v_tile + kk * 2048, kBoxBytes, 1024));
}

// online softmax of one tile of raw scores s (NS registers: a 2 NS-column
// kv tile), in place in registers: mask (where masked_tile says: the
// diagonal, the ragged tail, the window's back edge), the running max
// m_r of the raw scores (the scale is positive, so it commutes with the
// max), p = e^(scale (s - m)), the running sum l_r (from the float32 p) and
// the accumulator's factor alpha. Register i holds row rows[(i >> 1) & 1],
// column k0 + 8 (i / 4) + 2 tig + (i & 1).
template <int NS, bool kWindow>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NS], float (&alpha)[2], float (&m_r)[2], float (&l_r)[2],
    const FlashGeom& g, const int (&rows)[2], int k0, int tig, bool edge) {
  const float c = g.scale * kLog2e;
  float mx[2] = {kNegInf, kNegInf};
  if (edge) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
      s[i] = visible<kWindow>(g, rows[(i >> 1) & 1], col) ? s[i] : kNegInf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);
    const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
    mc[r] = m_safe * c;
    alpha[r] = m_r[r] <= kNegInf / 2 ? 0.f : exp_diff(m_r[r], c, mc[r]);
    m_r[r] = m_new;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const int col = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
      const float p = exp_diff(s[i], c, mc[r]);   // no branch around the asm
      s[i] = visible<kWindow>(g, rows[r], col) ? p : 0.f;
      rs[r] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp_diff(s[i], c, mc[r]);
      rs[r] += s[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l_r[r] = l_r[r] * alpha[r] + rs[r];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(P) as the A fragments of the second product: the accumulator layout
// of the first is the A layout of the second, k-step kk being columns
// 16 kk .. 16 kk + 15, i.e. registers 8 kk .. 8 kk + 7
template <int NK>
__device__ __forceinline__ void pack_p(const float (&p)[8 * NK],
                                       uint32_t (&pa)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// acc *= alpha by rows: register i holds row (i >> 1) & 1
template <int N>
__device__ __forceinline__ void rescale_acc(float (&acc)[N],
                                            const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// a consumer thread's two output rows of tile t, acc / max(l, 1e-30) in
// bf16, as one reciprocal a row and a product an element: the IEEE
// division an element (flash_wgmma_kernel's own store) cost kimi-k2's
// prefill 6% chained, where the store sits between two products
// (scripts/flash_ab.py, H100); rows past S are not stored
template <int Dv>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ o,
                                           const FlashGeom& g, const Tile& t,
                                           const int (&rows)[2], int tig,
                                           const float (&acc)[Dv / 2],
                                           const float (&l_r)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= g.seq) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* op = o + t.b * g.o_b + rows[r] * g.o_s + t.h * g.o_h +
                        tig * 2;
#pragma unroll
    for (int dt = 0; dt < Dv / 8; ++dt) {
      const uint32_t w = pack_bf16(acc[4 * dt + 2 * r] * inv,
                                   acc[4 * dt + 2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(op + dt * 8) = w;
    }
  }
}

// The consumers of a chained layout (HopperLayout::kChained, D 112): the
// loop of flash_wgmma_kernel's consumers, but the last kv tile of a work
// item (its O += P V) is issued together with the first S of the next
// item, whose softmax runs under that product; then the finished item's
// rows are stored and the accumulator cleared for the next. m, l and P of
// the next item live across the boundary, the finished item's l beside
// them. The accumulator's rescale by alpha runs between the issue of the
// next S and that of the P V it feeds (as FlashAttention-3 orders it), in
// the shadow of the S, not between a P V's completion and the next issue.
// Every path between a wgmma's issue and its wait is straight-line. The
// producer is flash_wgmma_kernel's: Q of the next item is loaded once the
// last S of this one is in (q_empty), under this item's last softmax
template <int D, bool kWindow>
__device__ __forceinline__ void chained_consumer(
    const FlashGeom& g, __nv_bfloat16* __restrict__ o, uint32_t base, int c,
    int n_qb, int n_items) {
  using L = HopperLayout<D>;
  static_assert(!L::kDynamic, "chained: the static pairs");
  constexpr int kTileBytes = L::kTileBytes, kStages = L::kStages;
  constexpr int kStageBytes = L::kStageBytes, Dv = L::kDv, BN = L::kBN;
  const uint32_t q_full = base + L::kBarOff;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full_k = q_empty + 8;                // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int row0 = c * 64 + warp * 16 + lane / 4;   // rows row0, row0 + 8
  const uint32_t q_rows = base + c * 64 * 128;
  const uint32_t kv_base = base + L::kKOff;   // + st kStageBytes
  const int my_turn = 1 + c, next_turn = 2 - c;
  if (L::kPingPong && c == 1) bar_arrive(1);

  float s[L::kScores], acc[Dv / 2];
  uint32_t pa[BN / 16][4];
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < Dv / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  int k = 0, it = 0;
  Tile t = work_tile<D, kWindow>(g, item_of(0), n_qb);

  {  // the block's first item: its first tile's scores and softmax
    const int kv0 = kWindow ? t.kv0 : 0;
    const int rows[2] = {t.q0 + row0, t.q0 + row0 + 8};
    mbar_wait(q_full, 0);
    mbar_wait(full_k, 0);
    if (L::kPingPong) bar_sync(my_turn);
    issue_scores<D>(s, q_rows, kv_base);
    wgmma_commit();
    if (L::kPingPong) bar_arrive(next_turn);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_k);
    if (t.n_kv == 1) mbar_arrive(q_empty);
    softmax_tile<L::kScores, kWindow>(
        s, alpha, m_r, l_r, g, rows, kv0 * BN, tig,
        masked_tile<BN, kWindow>(g, t.q0, kv0 * BN, t.n_kv == 1));
    pack_p(s, pa);
    fence_frags(pa);
  }

  while (true) {
    const int kv0 = kWindow ? t.kv0 : 0;
    const int rows[2] = {t.q0 + row0, t.q0 + row0 + 8};
    // tile j < n_kv - 1: as flash_wgmma_kernel's consumers
    for (int j = 0; j + 1 < t.n_kv; ++j) {
      const int cur = it + j, nxt = cur + 1;
      const int st = cur % kStages, st1 = nxt % kStages;
      mbar_wait(full_k + 8 * st1, (nxt / kStages) & 1);
      mbar_wait(full_v + 8 * st, (cur / kStages) & 1);
      if (L::kPingPong) bar_sync(my_turn);
      issue_scores<D>(s, q_rows, kv_base + st1 * kStageBytes);
      wgmma_commit();
      // tile j's factor, under S of tile j + 1 (pinned between the issues)
      fence_regs(acc);
      rescale_acc(acc, alpha);
      fence_regs(acc);
      issue_pv<D>(acc, pa, kv_base + st * kStageBytes + kTileBytes);
      wgmma_commit();
      if (L::kPingPong) bar_arrive(next_turn);
      wgmma_wait<1>();
      fence_regs(s);
      mbar_arrive(empty_k + 8 * st1);
      if (j + 2 == t.n_kv) mbar_arrive(q_empty);
      const int k0 = (kv0 + j + 1) * BN;
      softmax_tile<L::kScores, kWindow>(
          s, alpha, m_r, l_r, g, rows, k0, tig,
          masked_tile<BN, kWindow>(g, t.q0, k0, j + 2 == t.n_kv));
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
      mbar_arrive(empty_v + 8 * st);
      pack_p(s, pa);
      fence_frags(pa);
    }
    const int cur = it + t.n_kv - 1, st = cur % kStages;
    const int next = item_of(k + 1);
    if (next >= n_items) {  // the block's last item: its last P V alone
      mbar_wait(full_v + 8 * st, (cur / kStages) & 1);
      if (L::kPingPong) bar_sync(my_turn);
      fence_regs(acc);
      rescale_acc(acc, alpha);
      fence_regs(acc);
      issue_pv<D>(acc, pa, kv_base + st * kStageBytes + kTileBytes);
      wgmma_commit();
      if (L::kPingPong && c == 0)   // consumer 1's last turn: none
        bar_arrive(next_turn);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
      mbar_arrive(empty_v + 8 * st);
      store_rows<Dv>(o, g, t, rows, tig, acc, l_r);
      return;
    }
    // the last P V of this item with the first S of the next
    const Tile tn = work_tile<D, kWindow>(g, next, n_qb);
    const int kv0n = kWindow ? tn.kv0 : 0;
    const int rows_n[2] = {tn.q0 + row0, tn.q0 + row0 + 8};
    const int nxt = cur + 1, st1 = nxt % kStages;
    mbar_wait(q_full, (k + 1) & 1);
    mbar_wait(full_k + 8 * st1, (nxt / kStages) & 1);
    mbar_wait(full_v + 8 * st, (cur / kStages) & 1);
    if (L::kPingPong) bar_sync(my_turn);
    issue_scores<D>(s, q_rows, kv_base + st1 * kStageBytes);
    wgmma_commit();
    fence_regs(acc);
    rescale_acc(acc, alpha);
    fence_regs(acc);
    issue_pv<D>(acc, pa, kv_base + st * kStageBytes + kTileBytes);
    wgmma_commit();
    if (L::kPingPong) bar_arrive(next_turn);
    wgmma_wait<1>();   // the next item's first scores are in
    fence_regs(s);
    mbar_arrive(empty_k + 8 * st1);
    if (tn.n_kv == 1) mbar_arrive(q_empty);
    const float l_done[2] = {l_r[0], l_r[1]};
    m_r[0] = m_r[1] = kNegInf;
    l_r[0] = l_r[1] = 0.f;
    softmax_tile<L::kScores, kWindow>(
        s, alpha, m_r, l_r, g, rows_n, kv0n * BN, tig,
        masked_tile<BN, kWindow>(g, tn.q0, kv0n * BN, tn.n_kv == 1));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
    mbar_arrive(empty_v + 8 * st);
    store_rows<Dv>(o, g, t, rows, tig, acc, l_done);
#pragma unroll
    for (int i = 0; i < Dv / 2; ++i) acc[i] = 0.f;
    pack_p(s, pa);
    fence_regs(acc);
    fence_frags(pa);
    it += t.n_kv;
    ++k;
    t = tn;
  }
}

struct HopperMaps {
  CUtensorMap q, k, v;
};

template <int D, bool kWindow>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_wgmma_kernel(const __grid_constant__ HopperMaps maps,
                   __nv_bfloat16* __restrict__ o, const FlashGeom g) {
  using L = HopperLayout<D>;
  constexpr int kTileBytes = L::kTileBytes, kStages = L::kStages;
  constexpr int kStageBytes = L::kStageBytes, Dv = L::kDv;
  constexpr int BN = L::kBN, kBoxBytes = L::kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte aligned destinations
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBarOff;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full_k = q_empty + 8;                // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t slot = base + L::kSlotOff;           // kDynamic only

  // persistent: block b takes the pairs of work items b, b + G, b + 2 G, ...
  // (item_of), a pair being two q tiles of one head, the i-th longest and
  // the i-th shortest (hopper_tile): every pair holds n_qb + 1 causal kv
  // tiles, so the blocks' sums match, and the pairs in flight at once
  // cover some 17 heads, whose K and V stay in L2 (MHA at S 2048 has 84 MB
  // of K and V, more than the 50 MB of L2). One tile's tail overlaps the
  // next one's loads. At D 256 the items come longest first from a counter
  // instead (kDynamic; recurrentgemma-2b's one kv head a batch row keeps
  // all its K and V, 2 MB a row at S 2048, in L2)
  const int n_qb = (g.seq + kHopperBM - 1) / kHopperBM;
  const int n_items = n_qb * g.batch * g.heads;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);            // every consumer thread arrives
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 256);
      mbar_init(empty_v + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: one thread keeps the ring full. K and V are released apart:
    // K once its scores are in, V once its product is, so K runs two tiles
    // ahead of the consumers' need. `it` counts the block's kv tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0, k = 0, next = 0;
      for (int item = producer_item<L::kDynamic>(0, next); item < n_items;
           item = producer_item<L::kDynamic>(++k, next)) {
        const Tile t = work_tile<D, kWindow>(g, item, n_qb);
        const int kv0 = kWindow ? t.kv0 : 0;
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
        if constexpr (L::kDynamic) st_shared(slot, item);
        // the transaction count is the whole boxes': TMA counts the
        // zero-filled columns past D and rows past S too
        mbar_expect_tx(q_full, L::kQTileBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(base + x * L::kQBoxBytes, &maps.q, q_full, x * kBoxCols, t.q0,
                   t.h, t.b);
        if constexpr (L::kDynamic)
          next = static_cast<int>(gridDim.x) + atomicAdd(&g_next_item, 1);
        for (int j = 0; j < t.n_kv; ++j, ++it) {
          const int s = it % kStages, round = it / kStages;
          const uint32_t ks = base + L::kKOff + s * kStageBytes;
          const uint32_t vs = ks + kTileBytes;
          const int k0 = (kv0 + j) * BN;
          if (round > 0) mbar_wait(empty_k + 8 * s, (round - 1) & 1);
          mbar_expect_tx(full_k + 8 * s, kTileBytes);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(ks + x * kBoxBytes, &maps.k, full_k + 8 * s,
                     x * kBoxCols, k0, t.hk, t.b);
          if (round > 0) mbar_wait(empty_v + 8 * s, (round - 1) & 1);
          mbar_expect_tx(full_v + 8 * s, L::kVTileBytes);
          for (int x = 0; x < L::kVBoxes; ++x)
            tma_load(vs + x * kBoxBytes, &maps.v, full_v + 8 * s,
                     x * kBoxCols, k0, t.hk, t.b);
        }
      }
      if constexpr (L::kDynamic) {
        // no item left: once the consumers have read the last one's slot,
        // it says so, and the consumers' wait on Q ends without a load
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
        st_shared(slot, n_items);
        mbar_arrive(q_full);
        // every block's last take from the counter precedes its count here
        __threadfence();
        if (atomicAdd(&g_blocks_done, 1) == static_cast<int>(gridDim.x) - 1) {
          g_next_item = 0;
          g_blocks_done = 0;
        }
      }
    }
  } else {
    // consumers: warpgroup c owns q rows [64 c, 64 c + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if constexpr (L::kChained) {
      chained_consumer<D, kWindow>(g, o, base, warpgroup - 1, n_qb, n_items);
      return;
    }
    const int c = warpgroup - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int tig = lane % 4;
    const int row0 = c * 64 + warp * 16 + lane / 4;   // rows row0, row0 + 8
    // Q: rows of this consumer in each 64-column box, K-major
    const uint32_t q_rows = base + c * 64 * 128;
    const uint32_t kv_base = base + L::kKOff;   // + st kStageBytes
    // ping-pong: the consumers take turns to issue their products (named
    // barrier 1 + c is consumer c's turn), so one's softmax runs under the
    // other's wgmmas; consumer 0 goes first
    const int my_turn = 1 + c, next_turn = 2 - c;
    if (L::kPingPong && c == 1) bar_arrive(1);

    float s[L::kScores], acc[Dv / 2];
#pragma unroll
    for (int i = 0; i < L::kScores; ++i) s[i] = 0.f;
    uint32_t pa[BN / 16][4];
    int it = 0;
    for (int k = 0, item = consumer_item<L::kDynamic>(0, slot, q_full);
         item < n_items;
         item = consumer_item<L::kDynamic>(++k, slot, q_full)) {
      const Tile t = work_tile<D, kWindow>(g, item, n_qb);
      const int kv0 = kWindow ? t.kv0 : 0;
      const int rows[2] = {t.q0 + row0, t.q0 + row0 + 8};
      float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < Dv / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      mbar_wait(q_full, k & 1);

      // the first tile's scores and softmax
      {
        const int st = it % kStages;
        mbar_wait(full_k + 8 * st, (it / kStages) & 1);
        if (L::kPingPong) bar_sync(my_turn);
        issue_scores<D>(s, q_rows, kv_base + st * kStageBytes);
        wgmma_commit();
        if (L::kPingPong) bar_arrive(next_turn);
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(empty_k + 8 * st);
        if (t.n_kv == 1) mbar_arrive(q_empty);
        softmax_tile<L::kScores, kWindow>(
            s, alpha, m_r, l_r, g, rows, kv0 * BN, tig,
            masked_tile<BN, kWindow>(g, t.q0, kv0 * BN, t.n_kv == 1));
        pack_p(s, pa);
        fence_frags(pa);
      }

      // tile j < n_kv - 1: S of tile j + 1 is issued before O += P_j V_j,
      // and its softmax runs while that second product is in flight; P_{j+1}
      // is packed once P_j's product is done. The loop body has no branch
      // around a wgmma, so no accumulator is copied while one is in flight
      for (int j = 0; j + 1 < t.n_kv; ++j) {
        const int cur = it + j, nxt = cur + 1;
        const int st = cur % kStages, st1 = nxt % kStages;
        mbar_wait(full_k + 8 * st1, (nxt / kStages) & 1);
        mbar_wait(full_v + 8 * st, (cur / kStages) & 1);
        if (L::kPingPong) bar_sync(my_turn);
        issue_scores<D>(s, q_rows, kv_base + st1 * kStageBytes);
        wgmma_commit();
        issue_pv<D>(acc, pa, kv_base + st * kStageBytes + kTileBytes);
        wgmma_commit();
        if (L::kPingPong) bar_arrive(next_turn);
        wgmma_wait<1>();   // the scores of tile j + 1 are in
        fence_regs(s);
        mbar_arrive(empty_k + 8 * st1);
        if (j + 2 == t.n_kv) mbar_arrive(q_empty);   // Q's last read is done
        const int k0 = (kv0 + j + 1) * BN;
        softmax_tile<L::kScores, kWindow>(
            s, alpha, m_r, l_r, g, rows, k0, tig,
            masked_tile<BN, kWindow>(g, t.q0, k0, j + 2 == t.n_kv));
        wgmma_wait<0>();
        // pa is read by the product just waited for: kept live to here, it
        // cannot share registers with the next P
        fence_regs(acc);
        fence_frags(pa);
        mbar_arrive(empty_v + 8 * st);
        rescale_acc(acc, alpha);
        pack_p(s, pa);
        // pinned here: sunk below the next S issue, these writes to the next
        // second product's inputs would serialize the wgmmas
        fence_regs(acc);
        fence_frags(pa);
      }

      {  // the last tile's O += P V
        const int cur = it + t.n_kv - 1, st = cur % kStages;
        mbar_wait(full_v + 8 * st, (cur / kStages) & 1);
        if (L::kPingPong) bar_sync(my_turn);
        issue_pv<D>(acc, pa, kv_base + st * kStageBytes + kTileBytes);
        wgmma_commit();
        // consumer 1's very last turn has no successor
        if (L::kPingPong && (c == 0 || item_of(k + 1) < n_items))
          bar_arrive(next_turn);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(pa);
        mbar_arrive(empty_v + 8 * st);
      }
      it += t.n_kv;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= g.seq) continue;
        const float l = fmaxf(l_r[r], 1e-30f);
        __nv_bfloat16* op = o + t.b * g.o_b + rows[r] * g.o_s +
                            t.h * g.o_h + tig * 2;
#pragma unroll
        for (int dt = 0; dt < Dv / 8; ++dt) {
          const uint32_t w = pack_bf16(acc[4 * dt + 2 * r] / l,
                                       acc[4 * dt + 2 * r + 1] / l);
          *reinterpret_cast<uint32_t*>(op + dt * 8) = w;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 D = 16, 32, 64, 80, 128: IEEE FFMA on warp-owned rows, K and V by
// cp.async under the other product
// ---------------------------------------------------------------------------

constexpr int kFfmaBM = 128;          // q rows per block: 16 per warp
constexpr int kFfmaThreads = 256;     // 8 warps

// shared-memory layout of flash_ffma_kernel<D>, in floats: the Q tile, one
// K tile and one V tile, then each warp's P rows and its row factors.
// Score lanes hold 8 rows x kCols columns: rows score_row(rg, i) of the
// warp's 16 (rg = lane / 16), columns cg + 16 c (cg = lane % 16). Output
// lanes hold kORows rows x kChunks float4 chunks of D: rows og + kRG i (og
// = lane / kDG), chunks dg + kDG c (dg = lane % kDG), so that every
// operand comes in 16-byte loads, 5 (P V at D 16) to 16 FFMA a load, and
// no shared load or store of P meets a bank conflict.
template <int D>
struct FfmaLayout {
  static constexpr int kBN = 64;                   // kv rows per tile
  static constexpr int kBlocksPerSM = D <= 32 ? 2 : 1;
  static constexpr int kCols = kBN / 16;
  // Q and K rows padded by one float4: the 8 lanes of a 16-byte load phase
  // read 8 consecutive rows on 8 distinct bank quads
  static constexpr int kQK = D + 4;
  static constexpr int kP = kBN + 4;
  static constexpr int kRG = (D == 16 || D == 80) ? 8 : D == 32 ? 4 : 2;
  static constexpr int kDG = 32 / kRG;
  static constexpr int kORows = 16 / kRG;
  static constexpr int kChunks = D / 4 / kDG;
  static constexpr int kKOff = kFfmaBM * kQK;
  static constexpr int kVOff = kKOff + kBN * kQK;
  static constexpr int kPOff = kVOff + kBN * D;
  static constexpr int kROff = kPOff + 8 * 16 * kP;
  static constexpr int kSmem = (kROff + 8 * 16) * 4;
  static_assert(kChunks * kDG * 4 == D && kSmem <= 232448, "FFMA layout");
};

// the warp-local row of score lane half rg's i-th row: the two halves'
// rows lie 4 apart, so their scalar P stores (rows kP = 4 mod 32 floats
// apart) fall on disjoint banks
__device__ __forceinline__ int score_row(int rg, int i) {
  return (i & 3) + 4 * rg + 8 * (i >> 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  // src-size 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// returns once at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// every thread's share of rows [row0, row0 + rows) of a (seq, D) float32
// slice (q's Sq rows, or k's or v's Sk) into shared rows `stride` floats
// apart; rows past seq are zeros
template <int D>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, int stride,
                                              const float* src,
                                              int64_t row_stride, int row0,
                                              int rows, int seq) {
  constexpr int kChunks = D / 4;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += kFfmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = row0 + r < seq;
    cp_async16(dst + (r * stride + c) * 4,
               src + (ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(kFfmaThreads, FfmaLayout<D>::kBlocksPerSM)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  const FlashGeom g) {
  using L = FfmaLayout<D>;
  constexpr int BN = L::kBN, kCols = L::kCols, kORows = L::kORows;
  constexpr int kChunks = L::kChunks, kDG = L::kDG;
  extern __shared__ __align__(16) float smem_f[];
  const float* qs = smem_f;
  const float* ks = smem_f + L::kKOff;
  const float* vs = smem_f + L::kVOff;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ps = smem_f + L::kPOff + warp * 16 * L::kP;   // the warp's P rows
  float* rs_f = smem_f + L::kROff + warp * 16;         // its row factors

  const Tile t = tile_of<kFfmaBM, BN, kWindow>(g, blockIdx.x, blockIdx.y);
  const int kv0 = kWindow ? t.kv0 : 0;
  const float* qp = q + t.b * g.q_b + t.h * g.q_h;
  const float* kp = k + t.b * g.k_b + t.hk * g.k_h;
  const float* vp = v + t.b * g.v_b + t.hk * g.v_h;
  const uint32_t k_sh = smem_u32(ks), v_sh = smem_u32(vs);
  // group 0: Q and K_0; group 1: V_0. Then per kv tile j one group for
  // K_{j+1} (issued once every warp's S_j is in) and one for V_{j+1}
  // (issued once every warp's P_j V_j is in): each load runs under the
  // other product
  load_rows_f32<D>(smem_u32(qs), L::kQK, qp, g.q_s, t.q0, kFfmaBM, g.seq);
  load_rows_f32<D>(k_sh, L::kQK, kp, g.k_s, kv0 * BN, BN, g.kv_seq);
  cp_async_commit();
  load_rows_f32<D>(v_sh, D, vp, g.v_s, kv0 * BN, BN, g.kv_seq);
  cp_async_commit();

  const int rg = lane / 16, cg = lane % 16;      // score lanes
  const int og = lane / kDG, dg = lane % kDG;    // output lanes
  const int w0 = warp * 16;                      // the warp's rows in the tile
  const int first_row = t.q0 + w0, last_row = first_row + 15;
  const float c = g.scale * kLog2e;
  float m_r[8], l_r[8];     // l_r: this lane's columns only, summed at the end
  float acc[kORows][4 * kChunks];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kORows; ++r)
#pragma unroll
    for (int e = 0; e < 4 * kChunks; ++e) acc[r][e] = 0.f;

  for (int j = 0; j < t.n_kv; ++j) {
    const int k0 = (kv0 + j) * BN;
    const bool more = j + 1 < t.n_kv;
    cp_async_wait<1>();   // Q and K_j are in (V_j may not be)
    __syncthreads();
    // causal: a kv tile wholly in the future of the warp's 16 rows leaves
    // them as they are, and so does one wholly behind their window; the
    // warp only keeps to the block's barriers
    const bool active = (!g.causal || k0 <= last_row) &&
                        (!kWindow || k0 + BN - 1 > first_row - g.window);
    float s[8][kCols];
    if (active) {
      // S = Q K^T: each 16-byte Q load feeds 4 kCols FFMA, each K load 32
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) s[i][cc] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        float4 kv[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          kv[cc] = *reinterpret_cast<const float4*>(
              ks + (cg + 16 * cc) * L::kQK + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + (w0 + score_row(rg, i)) * L::kQK + d);
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            s[i][cc] = fmaf(qv.x, kv[cc].x, s[i][cc]);
            s[i][cc] = fmaf(qv.y, kv[cc].y, s[i][cc]);
            s[i][cc] = fmaf(qv.z, kv[cc].z, s[i][cc]);
            s[i][cc] = fmaf(qv.w, kv[cc].w, s[i][cc]);
          }
        }
      }
    }
    cp_async_wait<0>();   // V_j is in
    __syncthreads();      // and every warp is done with K_j
    if (more)
      load_rows_f32<D>(k_sh, L::kQK, kp, g.k_s, k0 + BN, BN, g.kv_seq);
    cp_async_commit();

    if (active) {
      // online softmax on the raw scores (the scale is positive, so it
      // commutes with the max), e^(scale (s - m)) as exp_diff; the mask
      // only where the tile reaches past the warp's first row or past Sk,
      // or behind its last row's window
      const bool edge = (g.causal && k0 + BN - 1 > first_row) ||
                        k0 + BN > g.kv_seq ||
                        (kWindow && k0 <= last_row - g.window);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = first_row + score_row(rg, i);
        float mx = kNegInf;
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          if (edge && !visible<kWindow>(g, row, k0 + cg + 16 * cc))
            s[i][cc] = kNegInf;
          mx = fmaxf(mx, s[i][cc]);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_r[i], mx);
        const float mc = (m_new <= kNegInf / 2 ? 0.f : m_new) * c;
        const float alpha =
            m_r[i] <= kNegInf / 2 ? 0.f : exp_diff(m_r[i], c, mc);
        m_r[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          float p = exp_diff(s[i][cc], c, mc);
          if (edge && !visible<kWindow>(g, row, k0 + cg + 16 * cc)) p = 0.f;
          ps[score_row(rg, i) * L::kP + cg + 16 * cc] = p;
          sum += p;
        }
        l_r[i] = l_r[i] * alpha + sum;
        if (cg == 0) rs_f[score_row(rg, i)] = alpha;
      }
      __syncwarp();

      // O = alpha O + P V_j: each 16-byte P load feeds 16 kChunks FFMA,
      // each V load 4 kORows
#pragma unroll
      for (int r = 0; r < kORows; ++r) {
        const float a = rs_f[og + L::kRG * r];
#pragma unroll
        for (int e = 0; e < 4 * kChunks; ++e) acc[r][e] *= a;
      }
#pragma unroll 2
      for (int j4 = 0; j4 < BN; j4 += 4) {
        float4 pv[kORows];
#pragma unroll
        for (int r = 0; r < kORows; ++r)
          pv[r] = *reinterpret_cast<const float4*>(
              ps + (og + L::kRG * r) * L::kP + j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vrow = vs + (j4 + jj) * D;
#pragma unroll
          for (int ch = 0; ch < kChunks; ++ch) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vrow + 4 * (dg + kDG * ch));
#pragma unroll
            for (int r = 0; r < kORows; ++r) {
              const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y
                            : jj == 2 ? pv[r].z : pv[r].w;
              acc[r][4 * ch + 0] = fmaf(p, vv.x, acc[r][4 * ch + 0]);
              acc[r][4 * ch + 1] = fmaf(p, vv.y, acc[r][4 * ch + 1]);
              acc[r][4 * ch + 2] = fmaf(p, vv.z, acc[r][4 * ch + 2]);
              acc[r][4 * ch + 3] = fmaf(p, vv.w, acc[r][4 * ch + 3]);
            }
          }
        }
      }
    }
    __syncthreads();      // every warp is done with V_j and its P
    if (more) load_rows_f32<D>(v_sh, D, vp, g.v_s, k0 + BN, BN, g.kv_seq);
    cp_async_commit();
  }

  // each row's l: the sum over its 16 score lanes, handed to its output
  // lanes through the row factors
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (cg == 0) rs_f[score_row(rg, i)] = fmaxf(l, 1e-30f);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kORows; ++r) {
    const int row = first_row + og + L::kRG * r;
    if (row >= g.seq) continue;
    const float l = rs_f[og + L::kRG * r];
    float* op = o + t.b * g.o_b + row * g.o_s + t.h * g.o_h;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
      *reinterpret_cast<float4*>(op + 4 * (dg + kDG * ch)) =
          make_float4(acc[r][4 * ch] / l, acc[r][4 * ch + 1] / l,
                      acc[r][4 * ch + 2] / l, acc[r][4 * ch + 3] / l);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D, bool kWindow>
int launch_ffma(const void* q, const void* k, const void* v, void* o,
                const FlashGeom& g, void* stream) {
  constexpr int kSmem = FfmaLayout<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_ffma_kernel<D, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.seq + kFfmaBM - 1) / kFfmaBM, g.batch * g.heads);
  flash_ffma_kernel<D, kWindow><<<grid, kFfmaThreads, kSmem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled is a driver entry point: it is looked up through
// the runtime, so the library links no libcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

constexpr int kErrNoEncoder = 9999;   // the driver has no tensor-map encoder
constexpr int kErrEncode = 10000;     // + the CUresult of a refused map

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a rank-4 (D, seq, heads, B) bf16 map read in (64 columns, `rows` rows)
// boxes; strides in elements; seq the rows it maps (q's Sq, k's and v's
// Sk). The map ends at column D, so a box reaching past it (D 80's second,
// the only one of D 16 and 32) reads zeros there, never the next head's
// columns, and at row seq: the rows past it read zeros
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, const FlashGeom& g,
               int seq, int heads, int64_t s_stride, int64_t h_stride,
               int64_t b_stride, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(g.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_stride) * 2,
                                 static_cast<cuuint64_t>(h_stride) * 2,
                                 static_cast<cuuint64_t>(b_stride) * 2};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // out-of-bounds elements read 0
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

// no fallback: a map the driver refuses is returned as an error
template <int D, bool kWindow>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const FlashGeom& g, void* stream) {
  using L = HopperLayout<D>;
  HopperMaps maps;
  int err = encode_map<D>(&maps.q, q, g, g.seq, g.heads, g.q_s, g.q_h,
                          g.q_b, kHopperBM);
  if (err == 0)
    err = encode_map<D>(&maps.k, k, g, g.kv_seq, g.kv_heads, g.k_s, g.k_h,
                        g.k_b, L::kBN);
  if (err == 0)   // V's map ends at its own width, Dv
    err = encode_map<L::kDv>(&maps.v, v, g, g.kv_seq, g.kv_heads, g.v_s,
                             g.v_h, g.v_b, L::kBN);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t dev = cudaGetDevice(&device);
  if (dev == cudaSuccess)
    dev = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (dev != cudaSuccess) return static_cast<int>(dev);
  // one persistent block per SM, or one per pair of work items (per item
  // where they are handed out at run time) where there are fewer
  const int items = (g.seq + kHopperBM - 1) / kHopperBM * g.batch * g.heads;
  const int work = L::kDynamic ? items : (items + 1) / 2;
  const int grid = work < sms ? work : sms;
  flash_wgmma_kernel<D, kWindow><<<grid, kHopperThreads, L::kSmem,
                                   static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<__nv_bfloat16*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

// the one kernel of each (dtype, D, Dv, window or not): bf16 D == Dv at 16,
// 32, 64, 80, 112, 128 and 256 and the MLA pair (192, 128) the wgmma
// kernel, float32 D == Dv at 16 to 128 the FFMA kernel
enum Route { kNoKernel, kWgmma, kFfma };

Route route_of(int dtype, int head_dim, int v_dim) {
  const bool built = head_dim == 16 || head_dim == 32 || head_dim == 64 ||
                     head_dim == 80 || head_dim == 128;
  if (dtype == 1 && head_dim == 192)
    return v_dim == kMlaValueDim ? kWgmma : kNoKernel;
  if (v_dim != head_dim) return kNoKernel;
  if (dtype == 1)
    return built || head_dim == 112 || head_dim == 256 ? kWgmma : kNoKernel;
  return dtype == 0 && built ? kFfma : kNoKernel;
}

// the design of the kernel of (dtype, D, Dv) (flash_attention_design)
constexpr int kDesignFields = 6;

template <int D>
void wgmma_design(int* out) {
  using L = HopperLayout<D>;
  const int design[kDesignFields] = {kHopperBM, L::kBN, L::kStages,
                                     L::kPingPong, L::kDynamic, L::kChained};
  for (int i = 0; i < kDesignFields; ++i) out[i] = design[i];
}

// whether a window hides any key: one of Sk or more keys hides none (row -
// col < Sk, as a window comes only with Sq = Sk), so such a call computes
// what the instance without it computes, and runs that instance, free of
// the window's bounds and tests
bool masks(int window, int kv_seq) { return window > 0 && window < kv_seq; }

template <bool kWindow>
int launch(const void* q, const void* k, const void* v, void* o, int dtype,
           int head_dim, int v_dim, const FlashGeom& g, void* stream) {
  switch (route_of(dtype, head_dim, v_dim)) {
    case kWgmma:
      switch (head_dim) {
        case 16: return launch_wgmma<16, kWindow>(q, k, v, o, g, stream);
        case 32: return launch_wgmma<32, kWindow>(q, k, v, o, g, stream);
        case 64: return launch_wgmma<64, kWindow>(q, k, v, o, g, stream);
        case 80: return launch_wgmma<80, kWindow>(q, k, v, o, g, stream);
        case 112: return launch_wgmma<112, kWindow>(q, k, v, o, g, stream);
        case 128: return launch_wgmma<128, kWindow>(q, k, v, o, g, stream);
        case 192: return launch_wgmma<192, kWindow>(q, k, v, o, g, stream);
        case 256: return launch_wgmma<256, kWindow>(q, k, v, o, g, stream);
      }
      break;
    case kFfma:
      switch (head_dim) {
        case 16: return launch_ffma<16, kWindow>(q, k, v, o, g, stream);
        case 32: return launch_ffma<32, kWindow>(q, k, v, o, g, stream);
        case 64: return launch_ffma<64, kWindow>(q, k, v, o, g, stream);
        case 80: return launch_ffma<80, kWindow>(q, k, v, o, g, stream);
        case 128: return launch_ffma<128, kWindow>(q, k, v, o, g, stream);
      }
      break;
    case kNoKernel: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16; (head_dim, v_dim) q's and k's width and
// v's and o's: equal at 16, 32, 64, 80 or 128 (and 112 and 256 in
// bfloat16), or (192, 128) in bfloat16; g->window 0 (none) or the sliding
// window (one of g->kv_seq keys or more hides none: the instance without
// it runs); g->seq != g->kv_seq only without causal and window. Returns the
// cudaError_t of the launch (0 = success), kErrNoEncoder or kErrEncode +
// CUresult when a tensor map cannot be made.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int head_dim, int v_dim, const FlashGeom* g,
                        void* stream) {
  if (g->seq <= 0 || g->kv_seq <= 0 || g->kv_heads <= 0 ||
      g->heads % g->kv_heads != 0 || g->window < 0 ||
      (g->seq != g->kv_seq && (g->causal || g->window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  return masks(g->window, g->kv_seq)
             ? launch<true>(q, k, v, o, dtype, head_dim, v_dim, *g, stream)
             : launch<false>(q, k, v, o, dtype, head_dim, v_dim, *g, stream);
}

// the demangled name of the kernel flash_attention_fwd launches for (dtype,
// D, Dv, window, kv length), e.g. "flash_wgmma_kernel<256, true>" (the MLA
// pair's "flash_wgmma_kernel<192, false>"), or null where it launches none
const char* flash_attention_kernel(int dtype, int head_dim, int v_dim,
                                   int window, int kv_seq) {
  static char name[48];
  const Route route = route_of(dtype, head_dim, v_dim);
  if (route == kNoKernel) return nullptr;
  snprintf(name, sizeof(name), "%s<%d, %s>",
           route == kWgmma ? "flash_wgmma_kernel" : "flash_ffma_kernel",
           head_dim, masks(window, kv_seq) ? "true" : "false");
  return name;
}

// the design of the kernel flash_attention_fwd launches for (dtype, D,
// Dv), as kDesignFields ints into out: q rows and kv rows a tile, K/V
// stages, whether the consumers take turns, whether the work items come
// from a counter, whether a consumer chains its items (the FFMA kernel:
// 128, 64, 1, 0, 0, 0). Returns the number of fields, 0 where no kernel
// is built
int flash_attention_design(int dtype, int head_dim, int v_dim, int* out) {
  switch (route_of(dtype, head_dim, v_dim)) {
    case kWgmma:
      switch (head_dim) {
        case 16: wgmma_design<16>(out); break;
        case 32: wgmma_design<32>(out); break;
        case 64: wgmma_design<64>(out); break;
        case 80: wgmma_design<80>(out); break;
        case 112: wgmma_design<112>(out); break;
        case 128: wgmma_design<128>(out); break;
        case 192: wgmma_design<192>(out); break;
        case 256: wgmma_design<256>(out); break;
        default: return 0;
      }
      return kDesignFields;
    case kFfma: {
      const int design[kDesignFields] = {kFfmaBM, FfmaLayout<128>::kBN, 1, 0,
                                         0, 0};
      for (int i = 0; i < kDesignFields; ++i) out[i] = design[i];
      return kDesignFields;
    }
    case kNoKernel: break;
  }
  return 0;
}

}  // extern "C"
