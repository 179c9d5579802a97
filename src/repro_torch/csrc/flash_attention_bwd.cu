// Hopper (sm_90a) flash-attention backward with a plain C interface loaded
// through ctypes (repro_torch/kernels/flash_attention.py).
//
// flash_attention_bwd  replaces no TPU kernel: the Pallas kernel of
//                      repro/kernels/flash_attention.py:72
//                      (flash_attention_pallas) has no backward, and the
//                      reference trains through XLA's autodiff of its
//                      chunked scan (repro/models/blocks.py:63
//                      flash_attention, under jax.value_and_grad in
//                      repro/train/loop.py). The port's train forward runs
//                      the forward kernel (csrc/flash_attention.cu), whose
//                      output has no autograd graph, so its gradient is this
//                      kernel, behind a torch.autograd.Function.
//
// What it computes: dq, dk and dv of o = softmax(scale q k^T + mask) v for
// q (B, S, H, D), k and v (B, S, Hkv, D) and the upstream gradient do (B, S,
// H, D), all contiguous (o itself is not read), H % Hkv == 0 (query head
// h reads kv head h / (H / Hkv); dk and dv of a kv head sum over the query
// heads of its group),
// causal or not, Sq == Sk, no window, scale D^-0.5. Every product and
// statistic is float32; the three gradients are written in the inputs'
// type. Rows of the ragged tail (past S) and masked pairs contribute zero.
//
// The split of FlashAttention-2's backward, deterministic, no atomics:
//
//  * the dq pass (a block a q tile, head and batch). First the row
//    statistics, recomputed here so the forward kernel keeps its outputs:
//    one pass over the kv tiles (up to the causal diagonal) takes each
//    row's max m, sum l of e^(s - m) and sum u of e^(s - m) dP (dP = do
//    v^T) online: the log-sum-exp and delta = u / l = rowsum(P dP) in
//    float32. Then a second pass recomputes P = e^(s - lse), dP and
//    dS = P (dP - delta), and sums dq = scale dS k over the kv tiles in
//    registers. It writes the log-sum-exp and delta (float32) for the next
//    pass;
//  * the dk / dv pass (a block a kv tile, kv head and batch). It holds its
//    K and V tiles in shared memory and loops over the query heads of its
//    group and, for each, over the q tiles that can see it (from the
//    diagonal on, causal): P from the log-sum-exp, dv += P^T do, dP = do
//    v^T, dS = P (dP - delta), dk += scale dS^T q, both sums in registers,
//    written once at the end (GQA's sum over the group in a fixed order).
//
// Why delta stays rowsum(P dP), taken in float32 from S and dP over the
// whole row (so a statistics pass over S and dP stays, and it makes the
// log-sum-exp as cheaply as it would read one from the forward):
// FlashAttention-2 takes delta = rowsum(do * o) from the stored output. In
// bf16 that output's rounding moves every dS of a row by ~2^-9 |do| |o|,
// which swamps the small gradient of a query that sees few keys (the first
// rows of a causal call). On the CPU, emulating this kernel's arithmetic
// (P and dS rounded to bf16 for their products, dq rounded to bf16) against
// a float64 gradient, the largest dq row error over its RMS (the gate's
// rule, 0.1) at causal (B, S, H, Hkv, D), seeds 0-7:
//   geometry            delta exact   from a float32 o   from the bf16 o
//   (2, 77, 4, 4, 80)       0.015          0.015              0.828
//   (1, 130, 8, 2, 80)      0.018          0.541              0.422
//   (1, 130, 8, 2, 128)     0.016          0.131              1.509
// (the first two rows seed 3 and 4, the third seed 5; the worst of the
// eight seeds 0.019, 0.541, 1.509): not even a float32 output written by
// the forward would do.
//
// Two routes, one a dtype:
//  * bf16, D 80 and 128: flash_bwd_dq_wgmma_kernel<D> and
//    flash_bwd_dkdv_wgmma_kernel<D>, the forward's Hopper design
//    (flash_wgmma_kernel): 3 warpgroups, a producer thread keeping TMA
//    loads in flight through a 4-stage ring of mbarrier pairs and two
//    consumer warpgroups of 64 rows each (setmaxnreg moves the producer's
//    registers to them); tiles by TMA with 128-byte swizzle through rank-4
//    (D, S, heads, B) tensor maps, a tile row ceil(D / 64) boxes of 64
//    columns, the map ending at column D and row S (D 80's second box and
//    the rows past S arrive as zeros). Every product is a wgmma with
//    float32 accumulators in registers:
//     - dq kernel: 128 q rows a block, its Q and do tiles loaded once, 64-row
//       K and V tiles streamed twice (the statistics pass, then the
//       gradient pass). Each consumer loads its rows of Q and do once as
//       wgmma A fragments (load_frags), so S = Q K^T and dP = do V^T are RS
//       m64n64k16 over D / 16 k-steps that read only K or V from shared
//       memory (an SS step at N 64 reads 4 KB in the 32 clocks of its
//       multiply-adds: all of the SM's 128 bytes a clock; RS took granite's
//       dq kernel from 0.731 to 0.687 ms). The statistics in registers (quad
//       shuffles, e^(scale s - lse) as 2^(s c - lse2) on the
//       special-function unit, c = scale log2 e, lse2 the base-2
//       log-sum-exp), in two register sets, so that tile j + 1's products
//       run under tile j's exponentials; dS = P (dP - delta) rounded to bf16
//       stays in registers as the A operand of dq += dS K, an RS m64nDk16
//       whose B is the K tile read MN-major (the descriptor's transpose
//       bit), as the forward keeps P for P V, tile j + 1's scores issued
//       with tile j's product (the forward's order);
//     - dk / dv kernel: 128 kv rows a block, its K and V tiles loaded once
//       and resident; 64-row q and do tiles with their lse2 and delta (bulk
//       copies) streamed over the group's query heads and, causal, the q
//       tiles from the diagonal on. S^T = K q^T and dP^T = V do^T (RS from
//       the consumer's K and V rows held as fragments at D 80, SS at D 128,
//       where the two D-wide accumulators leave no room), so that P^T and
//       dS^T, rounded to bf16, are the A operands of dV += P^T do and dK +=
//       dS^T q (RS, do and q read MN-major) straight from the accumulators'
//       registers;
//     - masks only on a consumer's diagonal tile (and the last kv tile past
//       S, non-causal); no tile wholly in a row's future is computed (the
//       consumer whose rows it hides releases it unread); the blocks run
//       longest first, the tile's rank the slowest grid dimension (every
//       head's last q tile, or first kv tile, before any head's next);
//  * float32, D 16 (the reduced configs): flash_bwd_dq_kernel<float, 16>
//    and flash_bwd_dkdv_kernel<float, 16>, IEEE FFMA (never TF32): 256
//    threads, thread (ty, tx) = (tid / 16, tid % 16) owning rows ty + 16a
//    and columns tx + 16b of a 64 x 64 score tile and columns tx + 16e of
//    a gradient tile; float32 tiles in shared memory rows D + 1 apart (an
//    odd stride: the 16 rows a warp reads at one column fall in 16 banks),
//    the P / dS tile rows 80 floats apart; row reductions are shuffles
//    over the 16 lanes of a row.
//
// Bound: at stablelm-3b's training step (B 4, S 2048, H 32 MHA, D 80,
// bf16, causal) the backward must do 5 products of D multiply-adds a
// visible pair (s, dP, dv, dk, dq): 215 GFLOP, 0.22 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 0.09 ms for its 294 MB (q, k, v, do read,
// dq, dk, dv written) at 3.35 TB/s: bound by operations. These kernels do
// 9 products a pair (the statistics pass's S and dP and the dq pass's
// recomputed S and dP on top), all on wgmma, the only instruction that
// reaches the tensor cores' full rate. What holds them at 4.7-4.8x (D 80)
// and 3.2-3.3x (D 128) the bound on an H100 (1.03-1.05 and 1.12-1.15 ms;
// scripts/flash_bwd_ab.py --diagnose):
// not the exponentials (leaving them out saves 3-6%) and not the rings'
// loads (3-4%), but the products' rate at N 64 and the latency of each
// tile's softmax and reductions, which two consumer warpgroups only partly
// hide (ping-pong turns between them, as the forward takes, cost 12-17%).
//
// dq summed across the dk / dv blocks instead (FlashAttention-3's
// deterministic mode: a statistics kernel of 2 products, the dk / dv
// kernel adding each kv tile's dq partial dS K into a float32 accumulator
// with the bulk-copy engine, in kv-tile order behind a counter a q tile,
// then a conversion kernel; 7 products a pair) was slower on an H100: 1.43
// ms against 1.08 at D 80, 1.46 against 1.21 at D 128; the ordered adds
// alone cost 0.21-0.44 ms (PERF.md).
// cuda.h: CUtensorMap and its enums (the encoder is found at run time)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

struct FlashBwdGeom {
  int32_t batch, seq, heads, kv_heads, causal;
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // q rows of a tile
constexpr int kCols = 64;      // kv rows of a tile
constexpr int kPStride = 80;   // floats between rows of the P / dS tile
constexpr float kNegInf = -1e30f;

// the FFMA kernels' element type conversions (only float is instantiated)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int D>
struct BwdLayout {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static constexpr int kStride = D + 1;   // odd: conflict-free column reads
  static constexpr int kCol = D / 16;     // gradient columns a thread
  // q, do, k, v tiles, then the P / dS tile, then lse and delta of a q tile
  static constexpr int kFloats =
      2 * kRows * kStride + 2 * kCols * kStride + kRows * kPStride + 2 * kRows;
  static constexpr int kBytes = kFloats * 4;
};

// rows row0 .. row0 + n - 1 of head hx of a contiguous (B, S, Hx, D) tensor
// into a float tile of n rows, kStride apart; rows past S as zeros
template <typename T, int D>
__device__ void load_tile(float* dst, const T* src, int b, int row0, int hx,
                          int n_heads, int seq, int n) {
  constexpr int kStride = BwdLayout<D>::kStride;
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq)
      x = to_f32(src[((static_cast<int64_t>(b) * seq + row) * n_heads + hx) *
                         D + d]);
    dst[r * kStride + d] = x;
  }
}

// acc[a][c] = sum_d x[ty + 16a][d] * y[tx + 16c][d] over two tiles of
// kStride-apart rows (the score tile's products q k^T and do v^T)
template <int D>
__device__ __forceinline__ void tile_dot(const float* x, const float* y,
                                         int ty, int tx, float acc[4][4]) {
  constexpr int kStride = BwdLayout<D>::kStride;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float xa[4], yc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xa[a] = x[(ty + 16 * a) * kStride + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) yc[c] = y[(tx + 16 * c) * kStride + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xa[a], yc[c], acc[a][c]);
  }
}

// acc[a][e] += sum_r p[r][ty + 16a] * y[r][tx + 16e] over the n rows of the
// P / dS tile (p transposed: dv += P^T do, dk += dS^T q), or with
// kRowMajor acc[a][e] += sum_r p[ty + 16a][r] * y[r][tx + 16e] (dq += dS k)
template <int D, bool kRowMajor>
__device__ __forceinline__ void tile_acc(const float* p, const float* y,
                                         int ty, int tx, int n,
                                         float acc[4][BwdLayout<D>::kCol]) {
  constexpr int kStride = BwdLayout<D>::kStride;
  constexpr int kCol = BwdLayout<D>::kCol;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    float pa[4], ye[kCol];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pa[a] = kRowMajor ? p[(ty + 16 * a) * kPStride + r]
                        : p[r * kPStride + ty + 16 * a];
#pragma unroll
    for (int e = 0; e < kCol; ++e) ye[e] = y[r * kStride + tx + 16 * e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kCol; ++e) acc[a][e] = fmaf(pa[a], ye[e], acc[a][e]);
  }
}

// over the 16 lanes of a row (lanes tx of one ty; a warp holds two rows)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int row, int col, int seq,
                                        bool causal) {
  return row < seq && col < seq && (!causal || col <= row);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ lse_out,
                        float* __restrict__ delta_out, FlashBwdGeom g) {
  using L = BwdLayout<D>;
  constexpr int kStride = L::kStride, kCol = L::kCol;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kRows * kStride;
  float* s_k = s_do + kRows * kStride;
  float* s_v = s_k + kCols * kStride;
  float* s_p = s_v + kCols * kStride;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.heads / g.kv_heads);
  const int seq = g.seq;
  const bool causal = g.causal != 0;
  const int n_kv = causal ? (min(q0 + kRows, seq) + kCols - 1) / kCols
                          : (seq + kCols - 1) / kCols;

  load_tile<T, D>(s_q, q, b, q0, h, g.heads, seq, kRows);
  load_tile<T, D>(s_do, dout, b, q0, h, g.heads, seq, kRows);

  // pass 1: each row's max m, sum l of e^(s - m) and sum u of e^(s - m)
  // dP, online over the kv tiles
  float m[4], l[4], u[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
    u[a] = 0.f;
  }
  float s[4][4], dp[4][4];
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kCols;
    __syncthreads();
    load_tile<T, D>(s_k, k, b, k0, hk, g.kv_heads, seq, kCols);
    load_tile<T, D>(s_v, v, b, k0, hk, g.kv_heads, seq, kCols);
    __syncthreads();
    tile_dot<D>(s_q, s_k, ty, tx, s);
    tile_dot<D>(s_do, s_v, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool vis = visible(row, k0 + tx + 16 * c, seq, causal);
        s[a][c] = vis ? s[a][c] * g.scale : kNegInf;
        mt = fmaxf(mt, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mt));
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float ps = 0.f, us = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p =
            s[a][c] <= kNegInf / 2 ? 0.f : expf(s[a][c] - m_safe);
        ps += p;
        us = fmaf(p, dp[a][c], us);
      }
      const float alpha = m[a] <= kNegInf / 2 ? 0.f : expf(m[a] - m_safe);
      l[a] = l[a] * alpha + row_sum(ps);
      u[a] = u[a] * alpha + row_sum(us);
      m[a] = m_new;
    }
  }
  float lse[4], delta[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float m_safe = m[a] <= kNegInf / 2 ? 0.f : m[a];
    lse[a] = m_safe + logf(fmaxf(l[a], 1e-30f));
    delta[a] = l[a] > 0.f ? u[a] / l[a] : 0.f;
  }

  // pass 2: dS = P (dP - delta), dq = scale sum_j dS_j k_j
  float acc[4][kCol];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kCol; ++e) acc[a][e] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kCols;
    __syncthreads();
    load_tile<T, D>(s_k, k, b, k0, hk, g.kv_heads, seq, kCols);
    load_tile<T, D>(s_v, v, b, k0, hk, g.kv_heads, seq, kCols);
    __syncthreads();
    tile_dot<D>(s_q, s_k, ty, tx, s);
    tile_dot<D>(s_do, s_v, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const bool vis = visible(q0 + r, k0 + col, seq, causal);
        const float p = vis ? expf(s[a][c] * g.scale - lse[a]) : 0.f;
        s_p[r * kPStride + col] = p * (dp[a][c] - delta[a]);
      }
    }
    __syncthreads();
    tile_acc<D, true>(s_p, s_k, ty, tx, kCols, acc);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= seq) continue;
    T* dq_row = dq + ((static_cast<int64_t>(b) * seq + row) * g.heads + h) * D;
#pragma unroll
    for (int e = 0; e < kCol; ++e)
      dq_row[tx + 16 * e] = from_f32<T>(acc[a][e] * g.scale);
    if (tx == 0) {
      const int64_t at = (static_cast<int64_t>(b) * g.heads + h) * seq + row;
      lse_out[at] = lse[a];
      delta_out[at] = delta[a];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse_in,
                          const float* __restrict__ delta_in,
                          T* __restrict__ dk, T* __restrict__ dv,
                          FlashBwdGeom g) {
  using L = BwdLayout<D>;
  constexpr int kStride = L::kStride, kCol = L::kCol;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kRows * kStride;
  float* s_k = s_do + kRows * kStride;
  float* s_v = s_k + kCols * kStride;
  float* s_p = s_v + kCols * kStride;
  float* s_lse = s_p + kRows * kPStride;
  float* s_delta = s_lse + kRows;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kCols, hk = blockIdx.y, b = blockIdx.z;
  const int group = g.heads / g.kv_heads;
  const int seq = g.seq;
  const bool causal = g.causal != 0;
  const int n_q = (seq + kRows - 1) / kRows;
  const int first_q = causal ? k0 / kRows : 0;

  load_tile<T, D>(s_k, k, b, k0, hk, g.kv_heads, seq, kCols);
  load_tile<T, D>(s_v, v, b, k0, hk, g.kv_heads, seq, kCols);

  float acc_k[4][kCol], acc_v[4][kCol];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kCol; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;
  float s[4][4], dp[4][4];

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    for (int i = first_q; i < n_q; ++i) {
      const int q0 = i * kRows;
      __syncthreads();
      load_tile<T, D>(s_q, q, b, q0, h, g.heads, seq, kRows);
      load_tile<T, D>(s_do, dout, b, q0, h, g.heads, seq, kRows);
      for (int r = threadIdx.x; r < kRows; r += kThreads) {
        const int row = q0 + r;
        const int64_t at = (static_cast<int64_t>(b) * g.heads + h) * seq + row;
        s_lse[r] = row < seq ? lse_in[at] : 0.f;
        s_delta[r] = row < seq ? delta_in[at] : 0.f;
      }
      __syncthreads();
      tile_dot<D>(s_q, s_k, ty, tx, s);
      tile_dot<D>(s_do, s_v, ty, tx, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const bool vis = visible(q0 + r, k0 + col, seq, causal);
          const float p = vis ? expf(s[a][c] * g.scale - s_lse[r]) : 0.f;
          s_p[r * kPStride + col] = p;
          dp[a][c] = p * (dp[a][c] - s_delta[r]);   // dS
        }
      }
      __syncthreads();
      tile_acc<D, false>(s_p, s_do, ty, tx, kRows, acc_v);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_p[(ty + 16 * a) * kPStride + tx + 16 * c] = dp[a][c];
      __syncthreads();
      tile_acc<D, false>(s_p, s_q, ty, tx, kRows, acc_k);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= seq) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * seq + row) * g.kv_heads + hk) * D;
#pragma unroll
    for (int e = 0; e < kCol; ++e) {
      dk[at + tx + 16 * e] = from_f32<T>(acc_k[a][e] * g.scale);
      dv[at + tx + 16 * e] = from_f32<T>(acc_v[a][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 route, D 80 and 128: the same two passes as warp-specialised
// wgmma kernels fed by TMA through an mbarrier ring (the forward's design,
// csrc/flash_attention.cu flash_wgmma_kernel; these are its own copies of
// the helpers, so the forward's machine code does not depend on this file)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWgThreads = 384;   // a producer warpgroup + 2 consumers
constexpr int kBoxCols = 64;      // 128 bytes of bf16: one swizzle row
constexpr int kDqRows = 128;      // dq kernel: q rows a block (2 x 64)
constexpr int kDqKv = 64;         // dq kernel: kv rows a tile
constexpr int kDkdvRows = 128;    // dk / dv kernel: kv rows a block
constexpr int kDkdvQ = 64;        // dk / dv kernel: q rows a tile
constexpr int kStages = 4;        // ring depth of both kernels
// lse and delta rows a (batch, head): S rounded up to the dq kernel's
// 128-row q tiles, every one of which it writes (rows past S included:
// their q and do are zeros, so their statistics are finite and their
// contributions to dk and dv are zero)
constexpr int kStatAlign = kDqRows;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory layout (byte offsets from a 1024-aligned base). A tile row
// is kBoxes boxes of 64 columns; a box holds the tile's rows at 128 bytes
// a row, 128-byte swizzled (the TMA's and wgmma's common layout)
template <int D>
struct WgLayout {
  static_assert(D == 80 || D == 128, "bf16 backward: D 80 or 128");
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  // dq kernel: the Q and do tiles (128 rows), then the ring of K and V
  // tiles (64 rows), then the barriers
  static constexpr int kDqBox = kDqRows * 128;
  static constexpr int kDqTile = kBoxes * kDqBox;
  static constexpr int kDqKvBox = kDqKv * 128;
  static constexpr int kDqKvTile = kBoxes * kDqKvBox;
  static constexpr int kDqDo = kDqTile;
  static constexpr int kDqRing = 2 * kDqTile;
  static constexpr int kDqStage = 2 * kDqKvTile;   // K, then V
  static constexpr int kDqBar = kDqRing + kStages * kDqStage;
  static constexpr int kDqSmem = kDqBar + 8 * (1 + 2 * kStages) + 1024;
  // dk / dv kernel: the K and V tiles (128 rows), then the ring of q, do
  // (64 rows), lse and delta (64 floats each), then the barriers
  static constexpr int kKvBox = kDkdvRows * 128;
  static constexpr int kKvTile = kBoxes * kKvBox;
  static constexpr int kQBox = kDkdvQ * 128;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kStatBytes = kDkdvQ * 4;
  static constexpr int kLse = 2 * kQTile;           // in a stage
  static constexpr int kDelta = kLse + kStatBytes;
  static constexpr int kDkdvStage = 2 * kQTile + 1024;   // 1024-aligned
  static constexpr int kDkdvV = kKvTile;
  static constexpr int kDkdvRing = 2 * kKvTile;
  static constexpr int kDkdvBar = kDkdvRing + kStages * kDkdvStage;
  static constexpr int kDkdvSmem = kDkdvBar + 8 * (1 + 2 * kStages) + 1024;
  // the dk / dv consumers hold their K and V rows as A fragments (RS
  // scores, issue_scores_rs) where registers allow: at D 80 (the two
  // accumulators 80, the fragments 40); at D 128 the accumulators take 128
  static constexpr bool kKvFrags = D == 80;
  static_assert(kDqSmem <= 232448 && kDkdvSmem <= 232448, "shared memory");
  static_assert(2 * kStatBytes <= 1024, "lse and delta in a stage's pad");
};

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

// one (64 columns, rows) box of a rank-4 (D, S, heads, B) tensor map
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

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets lbo / sbo
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group are done
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Register fences: an empty asm that "reads and writes" the registers, so
// the compiler keeps their accesses on this side of the neighbouring
// (volatile) wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e]) :: "memory");
}

// the accumulator operands of a wgmma: registers %0 .. %(n - 1) for n = 32
// (N 64), 40 (N 80) and 64 (N 128)
#define WG_R0_31                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define WG_R32_39 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R40_63                                                           \
  ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D32 "{" WG_R0_31 "}"
#define WG_D40 "{" WG_R0_31 WG_R32_39 "}"
#define WG_D64 "{" WG_R0_31 WG_R32_39 WG_R40_63 "}"
#define WG_OUT0_31(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define WG_OUT32_39(d)                                                      \
  , "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define WG_OUT40_63(d)                                                      \
  , "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),        \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define WG_SET0_31(d)                                                       \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),   \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),              \
  "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),          \
  "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),          \
  "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),          \
  "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),          \
  "=f"(d[31])

// d (64 x 64, f32) += A B^T: A (64 x 16) and B (64 x 16) K-major in shared
// memory; wgmma_ss64_set writes d = A B^T, and its outputs are write-only,
// so the old accumulator is not kept live into the product
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT0_31(d)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss64_set(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_SET0_31(d)
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x D, f32) += A B: A (64 x 16) bf16 fragments in registers, B (16 x
// D) MN-major in shared memory (the transpose bit); at D 80 the product
// reads the first 64-column box and 16 columns of the second
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_OUT0_31(d) WG_OUT32_39(d) WG_OUT40_63(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " WG_D40
        ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : WG_OUT0_31(d) WG_OUT32_39(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// d (64 x 64, f32) += A B^T: A (64 x 16) bf16 fragments in registers, B
// (64 x 16) K-major in shared memory; the _set form writes d = A B^T, its
// outputs write-only
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_OUT0_31(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs64_set(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_SET0_31(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// a consumer's 64 rows of a K-major swizzled tile (rows_addr: its first
// row in box 0, boxes box_bytes apart) as the A fragments of its D / 16
// k-steps, loaded once: fragment kk holds rows r, r + 8 (r = warp's 16
// rows + lane / 4) at columns 16 kk + 2 tig (+ 1) and 16 kk + 8 + 2 tig (+
// 1), the 16-byte chunks 2 (kk % 4) and 2 (kk % 4) + 1 of box kk / 4,
// swizzled by the row's low three bits (lane / 4)
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&a)[D / 16][4],
                                           uint32_t rows_addr,
                                           uint32_t box_bytes, int warp,
                                           int lane) {
  const int tig = lane % 4, sw = lane / 4;
  const uint32_t row = rows_addr + (warp * 16 + lane / 4) * 128 + 4 * tig;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = row + (kk / 4) * box_bytes;
    const uint32_t c0 = ((2 * (kk % 4)) ^ sw) << 4;
    const uint32_t c1 = ((2 * (kk % 4) + 1) ^ sw) << 4;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[kk][0]) : "r"(box + c0));
    asm volatile("ld.shared.b32 %0, [%1];\n"
                 : "=r"(a[kk][1]) : "r"(box + 1024 + c0));
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[kk][2]) : "r"(box + c1));
    asm volatile("ld.shared.b32 %0, [%1];\n"
                 : "=r"(a[kk][3]) : "r"(box + 1024 + c1));
  }
}

// issue T = A B^T over D for A in registers (load_frags) and B a 64-row
// K-major tile (b_tile, boxes b_box apart): the products whose A is the
// same for every tile (the dq kernel's Q and do), read from shared memory
// once, so that a k-step reads only B there (an SS step at N 64 reads 4 KB
// in the 32 clocks its multiply-adds take: all of the SM's 128 bytes a
// clock)
template <int D>
__device__ __forceinline__ void issue_scores_rs(float (&t)[32],
                                                const uint32_t (&a)[D / 16][4],
                                                uint32_t b_tile,
                                                uint32_t b_box) {
  wgmma_rs64_set(t, a[0], smem_desc(b_tile, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_rs64(t, a[kk],
               smem_desc(b_tile + (kk % 4) * 32 + (kk / 4) * b_box, 16, 1024));
}

// issue T = A B^T over D (S or dP, or their transposes): A the consumer's
// 64 rows (a_rows, boxes a_box apart), B a 64-row tile (b_tile, boxes
// b_box apart), both K-major; D / 16 k-steps of 16 columns, 4 a box (5 at
// D 80: the zero columns past D are never read)
template <int D>
__device__ __forceinline__ void issue_scores(float (&t)[32], uint32_t a_rows,
                                             uint32_t a_box, uint32_t b_tile,
                                             uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        smem_desc(a_rows + (kk % 4) * 32 + (kk / 4) * a_box, 16, 1024);
    const uint64_t db =
        smem_desc(b_tile + (kk % 4) * 32 + (kk / 4) * b_box, 16, 1024);
    if (kk == 0)
      wgmma_ss64_set(t, da, db);
    else
      wgmma_ss64(t, da, db);
  }
}

// issue acc += A B for a 64-row B tile read MN-major (rows the product's
// k, its D columns the product's n): 4 k-steps of 16 rows (2048 bytes), the
// boxes b_box apart (the leading byte offset), 8-row groups 1024 bytes
// apart (the stride byte offset)
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b_tile, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, a[kk], smem_desc(b_tile + kk * 2048, b_box, 1024));
}

// 2^x on the special-function unit (ex2.approx, about 2 ulp): the scores'
// exponentials are taken in base 2 with the scale folded in, e^(scale s -
// lse) = 2^(s c - lse2) for c = scale log2 e and lse2 = lse log2 e
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// registers 8 kk .. 8 kk + 7 of a 64 x 64 accumulator (columns 16 kk ..
// 16 kk + 15) as the A fragments of k-step kk of the next product, in bf16
__device__ __forceinline__ void pack_step(const float (&x)[32], int kk,
                                          uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// whether query row `row` sees key `col` in the dq kernel: every row of a
// tile, those past S too (their q and do are zeros: statistics that are
// finite, and no contribution to dk or dv)
__device__ __forceinline__ bool sees(int row, int col, int seq, bool causal) {
  return col < seq && (!causal || col <= row);
}

__device__ __forceinline__ int stat_rows(int seq) {
  return (seq + kStatAlign - 1) / kStatAlign * kStatAlign;
}

// q, k, v and do, each as a rank-4 (D, S, heads, B) map: the dq kernel's
// q and do in 128-row boxes, k and v in 64-row ones; the dk / dv kernel's
// the other way round
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// A consumer thread of a 64 x 64 accumulator holds register i at row
// (i >> 1) & 1 of its two (rows r, r + 8 of its warp's 16) and column
// 8 (i / 4) + 2 tig + (i & 1), tig = lane % 4.

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                          bf16* __restrict__ dq, float* __restrict__ lse_out,
                          float* __restrict__ delta_out,
                          const FlashBwdGeom g) {
  using L = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte aligned destinations
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kDqBar;
  const uint32_t full = q_full + 8;              // + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  // the longest causal q tiles first: blockIdx.z is the tile's rank from
  // the last q tile, the slowest grid dimension, so every head's last tile
  // is launched before any head's second last
  const int n_qb = (g.seq + kDqRows - 1) / kDqRows;
  const int q0 = (n_qb - 1 - static_cast<int>(blockIdx.z)) * kDqRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (g.heads / g.kv_heads);
  const bool causal = g.causal != 0;
  // kv tiles that some row of the block sees (none wholly in its future)
  const int n_kv = causal ? (min(q0 + kDqRows, g.seq) - 1) / kDqKv + 1
                          : (g.seq + kDqKv - 1) / kDqKv;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);     // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: Q and do once, then K and V of every kv tile twice (the
    // statistics pass, then the gradient pass) through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // the transaction count is the whole boxes': TMA counts the
      // zero-filled columns past D and rows past S too
      mbar_expect_tx(q_full, 2 * L::kDqTile);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(base + x * L::kDqBox, &maps.q, q_full, x * kBoxCols, q0, h,
                 b);
        tma_load(base + L::kDqDo + x * L::kDqBox, &maps.dout, q_full,
                 x * kBoxCols, q0, h, b);
      }
      for (int it = 0; it < 2 * n_kv; ++it) {
        const int j = it < n_kv ? it : it - n_kv;
        const int s = it % kStages, round = it / kStages;
        const uint32_t ks = base + L::kDqRing + s * L::kDqStage;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, L::kDqStage);
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(ks + x * L::kDqKvBox, &maps.k, full + 8 * s, x * kBoxCols,
                   j * kDqKv, hk, b);
          tma_load(ks + L::kDqKvTile + x * L::kDqKvBox, &maps.v, full + 8 * s,
                   x * kBoxCols, j * kDqKv, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns q rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = warpgroup - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int rows[2] = {q0 + c * 64 + warp * 16 + lane / 4,
                       q0 + c * 64 + warp * 16 + lane / 4 + 8};
  const uint32_t q_rows = base + c * 64 * 128;
  const uint32_t do_rows = base + L::kDqDo + c * 64 * 128;
  const uint32_t ring = base + L::kDqRing;
  // the kv tiles this consumer's rows see: causal, up to the one holding
  // its diagonal (the block's last tile is wholly in consumer 0's future),
  // masked there; else all, the last masked past S
  const int n_vis =
      causal ? min(n_kv, (q0 + c * 64) / kDqKv + 1) : n_kv;
  const float cs = g.scale * kLog2e;
  float s[32], dp[32], s1[32], dp1[32];
  mbar_wait(q_full, 0);
  // this consumer's rows of Q and do as A fragments, for every kv tile
  uint32_t qa[D / 16][4], oa[D / 16][4];
  load_frags<D>(qa, q_rows, L::kDqBox, warp, lane);
  load_frags<D>(oa, do_rows, L::kDqBox, warp, lane);

  // pass 1: each row's max m (of the raw scores), sum l of 2^(c (s - m))
  // and sum u of 2^(c (s - m)) dP, online over the kv tiles
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  // S and dP of kv tile j (ring position j) into sx, dx (issued)
  auto issue_tile = [&](float (&sx)[32], float (&dx)[32], int j) {
    const int st = j % kStages;
    const uint32_t ks = ring + st * L::kDqStage;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    wgmma_fence();
    issue_scores_rs<D>(sx, qa, ks, L::kDqKvBox);
    issue_scores_rs<D>(dx, oa, ks + L::kDqKvTile, L::kDqKvBox);
    wgmma_commit();
  };
  // m, l and u over kv tile j's S and dP (in sx, dx)
  auto update = [&](float (&sx)[32], const float (&dx)[32], int j) {
    const int k0 = j * kDqKv;
    if (j + 1 == n_vis) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
        if (!sees(rows[(i >> 1) & 1], col, g.seq, causal)) sx[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sx[i]);
    float mc[2], alpha[2], ps[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      mc[r] = m_safe * cs;
      alpha[r] = m[r] <= kNegInf / 2 ? 0.f : ex2(fmaf(m[r], cs, -mc[r]));
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float e = ex2(fmaf(sx[i], cs, -mc[r]));   // no branch round asm
      const float p = sx[i] <= kNegInf / 2 ? 0.f : e;
      ps[r] += p;
      us[r] = fmaf(p, dx[i], us[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(ps[r]);
      u[r] = u[r] * alpha[r] + quad_sum(us[r]);
    }
  };
  // tile jn's products issued into (sy, dy), tile j's statistics taken
  // from (sx, dx) while they run; no product in flight after it, so none
  // is across a branch or the loop's back edge
  auto step = [&](float (&sx)[32], float (&dx)[32], float (&sy)[32],
                  float (&dy)[32], int j, int jn) {
    issue_tile(sy, dy, jn);
    update(sx, dx, j);
    wgmma_wait0();
    fence_regs(sy);
    fence_regs(dy);
    mbar_arrive(empty + 8 * (j % kStages));
  };
  issue_tile(s, dp, 0);
  wgmma_wait0();
  fence_regs(s);
  fence_regs(dp);
  int j = 0;
  for (; j + 2 < n_vis; j += 2) {
    step(s, dp, s1, dp1, j, j + 1);
    step(s1, dp1, s, dp, j + 1, j + 2);
  }
  if (j + 1 < n_vis) {   // tiles j and j + 1 are left
    step(s, dp, s1, dp1, j, j + 1);
    update(s1, dp1, j + 1);
    mbar_arrive(empty + 8 * ((j + 1) % kStages));
  } else {               // tile j is left
    update(s, dp, j);
    mbar_arrive(empty + 8 * (j % kStages));
  }
  // the tiles wholly in this consumer's future: released unread, once
  // loaded (an arrival before the load could complete the stage's last
  // round for the other consumer)
  for (int j = n_vis; j < n_kv; ++j) {
    mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
    mbar_arrive(empty + 8 * (j % kStages));
  }
  // lse2 = log2 of sum 2^(c s) (the log-sum-exp of the scaled scores in
  // base 2) and delta = u / l = rowsum(P dP), for every row of the tile
  float lse2[2], delta[2];
  const int n_stat = stat_rows(g.seq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_safe = m[r] <= kNegInf / 2 ? 0.f : m[r];
    lse2[r] = m_safe * cs + log2f(fmaxf(l[r], 1e-30f));
    delta[r] = l[r] > 0.f ? u[r] / l[r] : 0.f;
    if (tig == 0) {
      const int64_t at =
          (static_cast<int64_t>(b) * g.heads + h) * n_stat + rows[r];
      lse_out[at] = lse2[r];
      delta_out[at] = delta[r];
    }
  }

  // pass 2: P = 2^(c s - lse2), dS = P (dP - delta) rounded to bf16 in
  // registers as the A operand of dq += dS K (K read MN-major). The
  // forward's order (flash_wgmma_kernel): the scores of kv tile j + 1 are
  // issued with tile j's product, and their dS is taken while that product
  // runs
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[4][4];
  // dS of kv tile j from its raw scores s and dP, in place in dp
  auto take_ds = [&](int j) {
    const int k0 = j * kDqKv;
    const bool edge = j + 1 == n_vis;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
      const float p = ex2(fmaf(s[i], cs, -lse2[r]));   // no branch round asm
      const float pv = edge && !sees(rows[r], col, g.seq, causal) ? 0.f : p;
      dp[i] = pv * (dp[i] - delta[r]);
    }
  };
  {  // the first tile's scores and dS
    const int st = n_kv % kStages;
    const uint32_t ks = ring + st * L::kDqStage;
    mbar_wait(full + 8 * st, (n_kv / kStages) & 1);
    wgmma_fence();
    issue_scores_rs<D>(s, qa, ks, L::kDqKvBox);
    issue_scores_rs<D>(dp, oa, ks + L::kDqKvTile, L::kDqKvBox);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    take_ds(0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_step(dp, kk, da[kk]);
    fence_frags(da);
  }
  for (int j = 0; j + 1 < n_vis; ++j) {
    const int cur = n_kv + j, nxt = cur + 1;
    const int st = cur % kStages, st1 = nxt % kStages;
    const uint32_t ks = ring + st * L::kDqStage;
    const uint32_t ks1 = ring + st1 * L::kDqStage;
    mbar_wait(full + 8 * st1, (nxt / kStages) & 1);
    wgmma_fence();
    issue_scores_rs<D>(s, qa, ks1, L::kDqKvBox);
    issue_scores_rs<D>(dp, oa, ks1 + L::kDqKvTile, L::kDqKvBox);
    wgmma_commit();
    issue_grad<D>(acc, da, ks, L::kDqKvBox);
    wgmma_commit();
    wgmma_wait1();   // the scores of tile j + 1 are in
    fence_regs(s);
    fence_regs(dp);
    take_ds(j + 1);
    wgmma_wait0();
    // da is read by the product just waited for: kept live to here
    fence_regs(acc);
    fence_frags(da);
    mbar_arrive(empty + 8 * st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_step(dp, kk, da[kk]);
    // pinned here: sunk below the next issue, these writes to the next
    // product's inputs would serialize the wgmmas
    fence_regs(acc);
    fence_frags(da);
  }
  {  // the last tile's product
    const int cur = n_kv + n_vis - 1, st = cur % kStages;
    wgmma_fence();
    issue_grad<D>(acc, da, ring + st * L::kDqStage, L::kDqKvBox);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_frags(da);
    mbar_arrive(empty + 8 * st);
  }
  for (int j = n_vis; j < n_kv; ++j) {
    const int it = n_kv + j;
    mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
    mbar_arrive(empty + 8 * (it % kStages));
  }
  // dq = scale sum dS K, rounded once; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= g.seq) continue;
    bf16* out = dq + ((static_cast<int64_t>(b) * g.seq + rows[r]) * g.heads +
                      h) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8) =
          pack_bf16(acc[4 * dt + 2 * r] * g.scale,
                    acc[4 * dt + 2 * r + 1] * g.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                            const float* __restrict__ lse_in,
                            const float* __restrict__ delta_in,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            const FlashBwdGeom g) {
  using L = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_full = base + L::kDkdvBar;
  const uint32_t full = kv_full + 8;             // + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  // the first kv rows, the longest causal work, first: blockIdx.z is the
  // kv tile, the slowest grid dimension
  const int k0 = blockIdx.z * kDkdvRows, hk = blockIdx.x, b = blockIdx.y;
  const int group = g.heads / g.kv_heads;
  const bool causal = g.causal != 0;
  const int n_q = (g.seq + kDkdvQ - 1) / kDkdvQ;
  // the first q tile that sees a key of the block (none wholly in the past
  // of its first kv row is visited)
  const int first_q = causal ? k0 / kDkdvQ : 0;
  const int n_stat = stat_rows(g.seq);
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: K and V once, then q, do, lse and delta of every q tile of
    // every query head of the group through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKvTile);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(base + x * L::kKvBox, &maps.k, kv_full, x * kBoxCols, k0, hk,
                 b);
        tma_load(base + L::kDkdvV + x * L::kKvBox, &maps.v, kv_full,
                 x * kBoxCols, k0, hk, b);
      }
      int it = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = hk * group + hh;
        const int64_t stat0 = (static_cast<int64_t>(b) * g.heads + h) * n_stat;
        for (int i = first_q; i < n_q; ++i, ++it) {
          const int s = it % kStages, round = it / kStages;
          const uint32_t qs = base + L::kDkdvRing + s * L::kDkdvStage;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          mbar_expect_tx(full + 8 * s, 2 * L::kQTile + 2 * L::kStatBytes);
          for (int x = 0; x < L::kBoxes; ++x) {
            tma_load(qs + x * L::kQBox, &maps.q, full + 8 * s, x * kBoxCols,
                     i * kDkdvQ, h, b);
            tma_load(qs + L::kQTile + x * L::kQBox, &maps.dout, full + 8 * s,
                     x * kBoxCols, i * kDkdvQ, h, b);
          }
          bulk_load(qs + L::kLse, lse_in + stat0 + i * kDkdvQ, L::kStatBytes,
                    full + 8 * s);
          bulk_load(qs + L::kDelta, delta_in + stat0 + i * kDkdvQ,
                    L::kStatBytes, full + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns kv rows [k0 + 64 c, k0 + 64 c + 64); the
  // products are transposed (S^T = K q^T, dP^T = V do^T), so that P^T and
  // dS^T are the A operands of dV += P^T do and dK += dS^T q straight from
  // the accumulators' registers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = warpgroup - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int kv_rows[2] = {k0 + c * 64 + warp * 16 + lane / 4,
                          k0 + c * 64 + warp * 16 + lane / 4 + 8};
  const uint32_t k_rows = base + c * 64 * 128;
  const uint32_t v_rows = base + L::kDkdvV + c * 64 * 128;
  // causal: consumer c's diagonal q tile, the first it sees (consumer 1's
  // rows lie wholly in the future of the block's first q tile)
  const int diag = first_q + c;
  const float cs = g.scale * kLog2e;
  float acc_k[D / 2], acc_v[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pa[4][4], dsa[4][4];
  mbar_wait(kv_full, 0);
  uint32_t ka[D / 16][4], va[D / 16][4];
  if constexpr (L::kKvFrags) {
    load_frags<D>(ka, k_rows, L::kKvBox, warp, lane);
    load_frags<D>(va, v_rows, L::kKvBox, warp, lane);
  }

  int it = 0;
  for (int hh = 0; hh < group; ++hh) {
    for (int i = first_q; i < n_q; ++i, ++it) {
      const int sg = it % kStages;
      const uint32_t qs = base + L::kDkdvRing + sg * L::kDkdvStage;
      mbar_wait(full + 8 * sg, (it / kStages) & 1);
      if (causal && i < diag) {
        mbar_arrive(empty + 8 * sg);
        continue;
      }
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      if constexpr (L::kKvFrags) {
        issue_scores_rs<D>(st, ka, qs, L::kQBox);
        issue_scores_rs<D>(dpt, va, qs + L::kQTile, L::kQBox);
      } else {
        issue_scores<D>(st, k_rows, L::kKvBox, qs, L::kQBox);
        issue_scores<D>(dpt, v_rows, L::kKvBox, qs + L::kQTile, L::kQBox);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);
      const float* s_lse = reinterpret_cast<const float*>(
          smem_raw + (qs + L::kLse - smem_u32(smem_raw)));
      const float* s_delta = s_lse + kDkdvQ;
      const bool edge = causal && i == diag;
      const int q0 = i * kDkdvQ;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // columns (q rows) 8 (2 kk + half) + 2 tig + {0, 1}
          const int cl = 8 * (2 * kk + half) + 2 * tig;
          const float2 ls = *reinterpret_cast<const float2*>(s_lse + cl);
          const float2 dl = *reinterpret_cast<const float2*>(s_delta + cl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i_ = 8 * kk + 4 * half + e;
            const float lse2 = (e & 1) ? ls.y : ls.x;
            const float del = (e & 1) ? dl.y : dl.x;
            const float p = ex2(fmaf(st[i_], cs, -lse2));
            const bool vis = !edge || q0 + cl + (e & 1) >= kv_rows[e >> 1];
            st[i_] = vis ? p : 0.f;                      // P^T
            dpt[i_] = st[i_] * (dpt[i_] - del);          // dS^T
          }
        }
        pack_step(st, kk, pa[kk]);
        pack_step(dpt, kk, dsa[kk]);
      }
      fence_frags(pa);
      fence_frags(dsa);
      fence_regs(acc_v);
      fence_regs(acc_k);
      wgmma_fence();
      issue_grad<D>(acc_v, pa, qs + L::kQTile, L::kQBox);   // dV += P^T do
      issue_grad<D>(acc_k, dsa, qs, L::kQBox);              // dK += dS^T q
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_frags(pa);
      fence_frags(dsa);
      mbar_arrive(empty + 8 * sg);
    }
  }
  // dk = scale sum dS^T q and dv = sum P^T do, rounded once; kv rows past
  // S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kv_rows[r] >= g.seq) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * g.seq + kv_rows[r]) * g.kv_heads + hk) *
            D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + at + dt * 8) =
          pack_bf16(acc_k[4 * dt + 2 * r] * g.scale,
                    acc_k[4 * dt + 2 * r + 1] * g.scale);
      *reinterpret_cast<uint32_t*>(dv + at + dt * 8) =
          pack_bf16(acc_v[4 * dt + 2 * r], acc_v[4 * dt + 2 * r + 1]);
    }
  }
}

// cuTensorMapEncodeTiled is an entry point of libcuda: it is looked up
// through the runtime, so the library links no libcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

constexpr int kErrNoEncoder = 9999;   // no tensor-map encoder was found
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

// a contiguous (B, S, heads, D) bf16 tensor as a rank-4 (D, S, heads, B)
// map read in (64 columns, `rows` rows) boxes: the map ends at column D and
// at row S, so D 80's second box reads zeros past column 80 and the rows
// past S read zeros
int encode_map(CUtensorMap* map, const void* ptr, int d, int seq, int heads,
               int batch, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row * heads, row,
                                 row * heads * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // out-of-bounds elements read 0
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

// the four maps of one kernel: q and do in boxes of q_rows rows, k and v
// in boxes of kv_rows rows
int encode_maps(BwdMaps* maps, const void* q, const void* k, const void* v,
                const void* dout, int d, const FlashBwdGeom& g, int q_rows,
                int kv_rows) {
  int err = encode_map(&maps->q, q, d, g.seq, g.heads, g.batch, q_rows);
  if (err == 0)
    err = encode_map(&maps->dout, dout, d, g.seq, g.heads, g.batch, q_rows);
  if (err == 0)
    err = encode_map(&maps->k, k, d, g.seq, g.kv_heads, g.batch, kv_rows);
  if (err == 0)
    err = encode_map(&maps->v, v, d, g.seq, g.kv_heads, g.batch, kv_rows);
  return err;
}

// no fallback: a map the encoder refuses is returned as an error
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv, void* lse,
                 void* delta, const FlashBwdGeom& g, cudaStream_t stream) {
  using L = WgLayout<D>;
  BwdMaps dq_maps, dkdv_maps;
  int err = encode_maps(&dq_maps, q, k, v, dout, D, g, kDqRows, kDqKv);
  if (err == 0)
    err = encode_maps(&dkdv_maps, q, k, v, dout, D, g, kDkdvQ, kDkdvRows);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kDkdvSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_q(g.heads, g.batch, (g.seq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_wgmma_kernel<D><<<grid_q, kWgThreads, L::kDqSmem, stream>>>(
      dq_maps, static_cast<bf16*>(dq), static_cast<float*>(lse),
      static_cast<float*>(delta), g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_kv(g.kv_heads, g.batch,
                     (g.seq + kDkdvRows - 1) / kDkdvRows);
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<grid_kv, kWgThreads, L::kDkdvSmem, stream>>>(
          dkdv_maps, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, const FlashBwdGeom& g, cudaStream_t stream) {
  constexpr int kBytes = BwdLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((g.seq + kRows - 1) / kRows, g.heads, g.batch);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((g.seq + kCols - 1) / kCols, g.kv_heads, g.batch);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: float32 (head dim 16: the FFMA kernels), 1: bfloat16 (head dim
// 80 or 128: the wgmma kernels); every operand contiguous. lse and delta
// are float32 scratch, written by the first kernel and read by the second:
// (B, H, S) for float32, (B, H, ceil(S / 128) * 128) for bfloat16 (the
// natural log-sum-exp, and its base-2 one for bfloat16). Returns the
// cudaError_t of the launches (0 = success; cudaErrorInvalidValue for an
// unbuilt instance or a bad geometry), kErrNoEncoder or kErrEncode +
// CUresult when a tensor map cannot be made.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        void* lse, void* delta, int dtype,
                        int head_dim, const FlashBwdGeom* g, void* stream) {
  if (g->seq <= 0 || g->batch <= 0 || g->kv_heads <= 0 ||
      g->heads % g->kv_heads != 0 || g->batch > 65535 || g->heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 16)
    return launch<float, 16>(q, k, v, dout, dq, dk, dv, lse, delta, *g, s);
  if (dtype == 1 && head_dim == 80)
    return launch_wgmma<80>(q, k, v, dout, dq, dk, dv, lse, delta, *g, s);
  if (dtype == 1 && head_dim == 128)
    return launch_wgmma<128>(q, k, v, dout, dq, dk, dv, lse, delta, *g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the kernels flash_attention_bwd launches for (dtype, D), as the profiler
// names them, index 0 the dq pass and 1 the dk / dv pass
// ("flash_bwd_dq_kernel<float, 16>", "flash_bwd_dkdv_wgmma_kernel<80>"), or
// null past the last or where it launches none
const char* flash_attention_bwd_kernel(int dtype, int head_dim, int which) {
  static char name[64];
  if (which < 0 || which > 1) return nullptr;
  const char* pass = which == 0 ? "dq" : "dkdv";
  if (dtype == 0 && head_dim == 16)
    snprintf(name, sizeof(name), "flash_bwd_%s_kernel<float, 16>", pass);
  else if (dtype == 1 && (head_dim == 80 || head_dim == 128))
    snprintf(name, sizeof(name), "flash_bwd_%s_wgmma_kernel<%d>", pass,
             head_dim);
  else
    return nullptr;
  return name;
}

// the design of the kernels flash_attention_bwd launches for (dtype, D),
// as kBwdDesignFields ints into out: the dq kernel's q rows a block, kv
// rows a tile and ring stages, the dk / dv kernel's kv rows a block, q
// rows a tile and ring stages, the products computed a visible pair, and
// whether dq is summed across blocks in a fixed order (0: in one block's
// registers). Returns the number of fields, 0 where no kernel is built
int flash_attention_bwd_design(int dtype, int head_dim, int* out) {
  constexpr int kBwdDesignFields = 8;
  int design[kBwdDesignFields];
  if (dtype == 0 && head_dim == 16) {
    const int ffma[kBwdDesignFields] = {kRows, kCols, 1, kCols, kRows, 1, 9,
                                        0};
    for (int i = 0; i < kBwdDesignFields; ++i) design[i] = ffma[i];
  } else if (dtype == 1 && (head_dim == 80 || head_dim == 128)) {
    const int wg[kBwdDesignFields] = {kDqRows, kDqKv, kStages, kDkdvRows,
                                      kDkdvQ, kStages, 9, 0};
    for (int i = 0; i < kBwdDesignFields; ++i) design[i] = wg[i];
  } else {
    return 0;
  }
  for (int i = 0; i < kBwdDesignFields; ++i) out[i] = design[i];
  return kBwdDesignFields;
}

}  // extern "C"
