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
//    v^T) online: lse = m + log(l) and delta = u / l = rowsum(P dP) in
//    float32. (FlashAttention-2 takes delta = rowsum(do * o) from the
//    stored output: in bf16 that output's rounding moves every dS of a row
//    by ~2^-9 |do| |o|, which swamps the small gradient of a query that
//    sees few keys, the first rows of a causal call: 0.8 of such a row's
//    RMS at S 77.) Then a second pass recomputes P = e^(s - lse), dP and
//    dS = P (dP - delta), and sums dq = scale dS k over the kv tiles in
//    registers. It writes lse and delta (float32, (B, H, S)) for the next
//    pass;
//  * the dk / dv pass (a block a kv tile, kv head and batch). It holds its
//    K and V tiles in shared memory and loops over the query heads of its
//    group and, for each, over the q tiles that can see it (from the
//    diagonal on, causal): P from lse, dv += P^T do, dP = do v^T, dS = P
//    (dP - delta), dk += scale dS^T q, both sums in registers, written
//    once at the end.
//
// Two routes, one a dtype:
//  * bf16, D 80 and 128: flash_bwd_dq_mma_kernel<D> and
//    flash_bwd_dkdv_mma_kernel<D>, every product on the tensor cores as
//    mma.sync m16n8k16 (bf16 operands, float32 sums), four warps a block
//    each owning 16 rows (64 q rows a dq block over 64-row kv tiles; 64 kv
//    rows a dk / dv block over 32-row q tiles). Q, K, V and do are copied
//    into shared memory as they are (16-byte loads, rows D + 8 apart so
//    that a fragment's 8 rows fall in 8 bank groups); a tile that is a
//    product's B operand along its rows (K in the dq pass, q and do in the
//    dk / dv pass) is read by ldmatrix's transposed load. The dk / dv pass
//    computes
//    S^T = K q^T and dP^T = V do^T, so that P^T and dS^T, rounded to bf16,
//    are the next products' A operands straight from the accumulators'
//    registers (as the forward keeps P); the dq pass does the same with dS;
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
// recomputed S and dP on top) with mma.sync, which reaches a fraction of
// the rate that only wgmma reaches, fed from shared memory by 32-bit loads
// and ldmatrix: a simple design that is right first; its time is in
// PERF.md, and a wgmma / TMA design (with the log-sum-exp taken from the
// forward) is ROADMAP queue 2(c).
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
// the bf16 route: the same two passes on the tensor cores, mma.sync
// m16n8k16 (bf16 operands, float32 sums); four warps a block, each owning
// 16 rows of its tile
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;
constexpr int kMmaQ = 64;    // dq kernel: q rows a block
constexpr int kMmaKv = 64;   // kv rows a tile (dq kernel) and a block (dk dv)
constexpr int kMmaQt = 32;   // dk dv kernel: q rows a tile

template <int D>
struct MmaLayout {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  // bf16 between rows of a [row][d] tile: D + 8 puts the 8 rows a fragment
  // load reads at one column in 8 bank groups of their own
  static constexpr int kPad = D + 8;
  // dq kernel: q, do [64][kPad], k, v [64][kPad]
  static constexpr int kDqBytes = (2 * kMmaQ * kPad + 2 * kMmaKv * kPad) * 2;
  // dk dv kernel: k, v [64][kPad], q, do [32][kPad], then lse and delta of
  // a q tile (float32)
  static constexpr int kDkdvBytes =
      (2 * kMmaKv * kPad + 2 * kMmaQt * kPad) * 2 + 2 * kMmaQt * 4;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b for a 16 x 16 A fragment and a 16 x 8 B fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment at rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a
// row-major tile (pad elements a row); lane (gq, tq) = (lane / 4, lane % 4)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int pad, int r0, int k0, int gq,
                                       int tq) {
  const bf16* p = t + (r0 + gq) * pad + k0 + 2 * tq;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pad);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pad + 8);
}

// the B fragment (16 k x 8 n) whose transpose is rows n0 .. n0 + 7,
// columns k0 .. k0 + 15 of a row-major tile
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int pad, int n0, int k0,
                                       int gq, int tq) {
  const bf16* p = t + (n0 + gq) * pad + k0 + 2 * tq;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// the B fragment (16 k x 8 n) at rows k0 .. k0 + 15, columns n0 .. n0 + 7 of
// a row-major tile (pad elements a row): ldmatrix's transposed load of its
// two 8 x 8 halves, lanes 0-15 naming their rows (the addresses 16-byte
// aligned: pad and n0 multiples of 8)
__device__ __forceinline__ void load_b_trans(uint32_t& b0, uint32_t& b1,
                                             const bf16* t, int pad, int k0,
                                             int n0, int lane) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      t + (k0 + (lane & 15)) * pad + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// the A fragment of columns 16 kc .. 16 kc + 15 of a 16-row accumulator held
// as C fragments of 8 columns each (the score tile's layout), rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// c[nt] = A B^T over D: 16 rows of a_tile from r0 against n_tiles * 8 rows
// of b_tile (both [row][d], kPad a row)
template <int D, int NT>
__device__ __forceinline__ void tile_scores(float (&c)[NT][4],
                                            const bf16* a_tile, int r0,
                                            const bf16* b_tile, int gq,
                                            int tq) {
  constexpr int kPad = MmaLayout<D>::kPad;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, kPad, r0, kk * 16, gq, tq);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      load_b(b0, b1, b_tile, kPad, nt * 8, kk * 16, gq, tq);
      mma_bf16(c[nt], a, b0, b1);
    }
  }
}

// acc[nd] += A B over the NT * 8 columns of the accumulator-held A (the
// score tile) against B, the row-major [row][d] tile b_tile (kPad a row)
template <int D, int NT>
__device__ __forceinline__ void tile_grad(float (&acc)[D / 8][4],
                                          const float (&c)[NT][4],
                                          const bf16* b_tile, int lane) {
  constexpr int kPad = MmaLayout<D>::kPad;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    uint32_t a[4];
    acc_to_a<NT>(a, c, kc);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t b0, b1;
      load_b_trans(b0, b1, b_tile, kPad, kc * 16, nd * 8, lane);
      mma_bf16(acc[nd], a, b0, b1);
    }
  }
}

// rows row0 .. row0 + n - 1 of head hx of a contiguous (B, S, Hx, D) bf16
// tensor into dst ([row][d], pad a row) in 16-byte copies; rows past S as
// zeros
template <int D>
__device__ void load_bf16_tile(bf16* dst, int pad, const bf16* src, int b,
                               int row0, int hx, int n_heads, int seq,
                               int n) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < n * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow, c = (idx - r * kPerRow) * kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < seq)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<int64_t>(b) * seq + row) * n_heads + hx) * D +
          c);
    *reinterpret_cast<uint4*>(dst + r * pad + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            bf16* __restrict__ dq,
                            float* __restrict__ lse_out,
                            float* __restrict__ delta_out, FlashBwdGeom g) {
  using L = MmaLayout<D>;
  constexpr int kPad = L::kPad, kNd = D / 8, kNt = kMmaKv / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_do = s_q + kMmaQ * kPad;
  bf16* s_k = s_do + kMmaQ * kPad;
  bf16* s_v = s_k + kMmaKv * kPad;

  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kMmaQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.heads / g.kv_heads);
  const int seq = g.seq;
  const bool causal = g.causal != 0;
  const int n_kv = causal ? (min(q0 + kMmaQ, seq) + kMmaKv - 1) / kMmaKv
                          : (seq + kMmaKv - 1) / kMmaKv;
  // this thread's two rows of the accumulators (fragment rows gq, gq + 8)
  const int rows[2] = {q0 + wr + gq, q0 + wr + gq + 8};

  load_bf16_tile<D>(s_q, kPad, q, b, q0, h, g.heads, seq, kMmaQ);
  load_bf16_tile<D>(s_do, kPad, dout, b, q0, h, g.heads, seq, kMmaQ);

  // pass 1: each row's max m, sum l of e^(s - m) and sum u of e^(s - m) dP
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float s[kNt][4], dp[kNt][4];
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kMmaKv;
    __syncthreads();
    load_bf16_tile<D>(s_k, kPad, k, b, k0, hk, g.kv_heads, seq, kMmaKv);
    load_bf16_tile<D>(s_v, kPad, v, b, k0, hk, g.kv_heads, seq, kMmaKv);
    __syncthreads();
    tile_scores<D, kNt>(s, s_q, wr, s_k, gq, tq);
    tile_scores<D, kNt>(dp, s_do, wr, s_v, gq, tq);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hf + e];
          const bool vis =
              visible(rows[hf], k0 + nt * 8 + 2 * tq + e, seq, causal);
          x = vis ? x * g.scale : kNegInf;
          mt = fmaxf(mt, x);
        }
      const float m_new = fmaxf(m[hf], quad_max(mt));
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float ps = 0.f, us = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nt][2 * hf + e];
          const float p = x <= kNegInf / 2 ? 0.f : expf(x - m_safe);
          ps += p;
          us = fmaf(p, dp[nt][2 * hf + e], us);
        }
      const float alpha = m[hf] <= kNegInf / 2 ? 0.f : expf(m[hf] - m_safe);
      l[hf] = l[hf] * alpha + quad_sum(ps);
      u[hf] = u[hf] * alpha + quad_sum(us);
      m[hf] = m_new;
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float m_safe = m[hf] <= kNegInf / 2 ? 0.f : m[hf];
    lse[hf] = m_safe + logf(fmaxf(l[hf], 1e-30f));
    delta[hf] = l[hf] > 0.f ? u[hf] / l[hf] : 0.f;
  }

  // pass 2: dS = P (dP - delta) in registers, dq = scale sum_j dS_j k_j
  float acc[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kMmaKv;
    __syncthreads();
    load_bf16_tile<D>(s_k, kPad, k, b, k0, hk, g.kv_heads, seq, kMmaKv);
    load_bf16_tile<D>(s_v, kPad, v, b, k0, hk, g.kv_heads, seq, kMmaKv);
    __syncthreads();
    tile_scores<D, kNt>(s, s_q, wr, s_k, gq, tq);
    tile_scores<D, kNt>(dp, s_do, wr, s_v, gq, tq);
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const bool vis =
            visible(rows[hf], k0 + nt * 8 + 2 * tq + (e & 1), seq, causal);
        const float p = vis ? expf(s[nt][e] * g.scale - lse[hf]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta[hf]);
      }
    tile_grad<D, kNt>(acc, s, s_k, lane);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rows[hf];
    if (row >= seq) continue;
    bf16* dq_row = dq + ((static_cast<int64_t>(b) * seq + row) * g.heads + h) * D;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(dq_row + nd * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[nd][2 * hf] * g.scale,
                                acc[nd][2 * hf + 1] * g.scale);
    if (tq == 0) {
      const int64_t at = (static_cast<int64_t>(b) * g.heads + h) * seq + row;
      lse_out[at] = lse[hf];
      delta_out[at] = delta[hf];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse_in,
                              const float* __restrict__ delta_in,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              FlashBwdGeom g) {
  using L = MmaLayout<D>;
  constexpr int kPad = L::kPad, kNd = D / 8, kNt = kMmaQt / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_v = s_k + kMmaKv * kPad;
  bf16* s_q = s_v + kMmaKv * kPad;
  bf16* s_do = s_q + kMmaQt * kPad;
  float* s_lse = reinterpret_cast<float*>(s_do + kMmaQt * kPad);
  float* s_delta = s_lse + kMmaQt;

  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kMmaKv, hk = blockIdx.y, b = blockIdx.z;
  const int group = g.heads / g.kv_heads;
  const int seq = g.seq;
  const bool causal = g.causal != 0;
  const int n_q = (seq + kMmaQt - 1) / kMmaQt;
  const int first_q = causal ? k0 / kMmaQt : 0;
  // this thread's two kv rows of the accumulators
  const int cols[2] = {k0 + wr + gq, k0 + wr + gq + 8};

  load_bf16_tile<D>(s_k, kPad, k, b, k0, hk, g.kv_heads, seq, kMmaKv);
  load_bf16_tile<D>(s_v, kPad, v, b, k0, hk, g.kv_heads, seq, kMmaKv);

  float acc_k[kNd][4], acc_v[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;
  float st[kNt][4], dpt[kNt][4];   // S^T and dP^T: kv rows x q columns

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    for (int i = first_q; i < n_q; ++i) {
      const int q0 = i * kMmaQt;
      __syncthreads();
      load_bf16_tile<D>(s_q, kPad, q, b, q0, h, g.heads, seq, kMmaQt);
      load_bf16_tile<D>(s_do, kPad, dout, b, q0, h, g.heads, seq, kMmaQt);
      for (int r = threadIdx.x; r < kMmaQt; r += kMmaThreads) {
        const int row = q0 + r;
        const int64_t at = (static_cast<int64_t>(b) * g.heads + h) * seq + row;
        s_lse[r] = row < seq ? lse_in[at] : 0.f;
        s_delta[r] = row < seq ? delta_in[at] : 0.f;
      }
      __syncthreads();
      tile_scores<D, kNt>(st, s_k, wr, s_q, gq, tq);
      tile_scores<D, kNt>(dpt, s_v, wr, s_do, gq, tq);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = nt * 8 + 2 * tq + (e & 1);
          const bool vis = visible(q0 + r, cols[e >> 1], seq, causal);
          const float p = vis ? expf(st[nt][e] * g.scale - s_lse[r]) : 0.f;
          dpt[nt][e] = p * (dpt[nt][e] - s_delta[r]);   // dS^T
          st[nt][e] = p;                                 // P^T
        }
      tile_grad<D, kNt>(acc_v, st, s_do, lane);
      tile_grad<D, kNt>(acc_k, dpt, s_q, lane);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = cols[hf];
    if (row >= seq) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * seq + row) * g.kv_heads + hk) * D;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + nd * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc_k[nd][2 * hf] * g.scale,
                                acc_k[nd][2 * hf + 1] * g.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + nd * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc_v[nd][2 * hf], acc_v[nd][2 * hf + 1]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* lse, void* delta,
               const FlashBwdGeom& g, cudaStream_t stream) {
  using L = MmaLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kDkdvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((g.seq + kMmaQ - 1) / kMmaQ, g.heads, g.batch);
  flash_bwd_dq_mma_kernel<D><<<grid_q, kMmaThreads, L::kDqBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<float*>(lse),
      static_cast<float*>(delta), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((g.seq + kMmaKv - 1) / kMmaKv, g.kv_heads, g.batch);
  flash_bwd_dkdv_mma_kernel<D>
      <<<grid_kv, kMmaThreads, L::kDkdvBytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
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
// 80 or 128: the mma.sync kernels); every
// operand contiguous; lse and delta float32 (B, H, S) scratch, written by
// the first kernel and read by the second. Returns the cudaError_t of the
// launches (0 = success; cudaErrorInvalidValue for an unbuilt instance or
// a bad geometry).
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
    return launch_mma<80>(q, k, v, dout, dq, dk, dv, lse, delta, *g, s);
  if (dtype == 1 && head_dim == 128)
    return launch_mma<128>(q, k, v, dout, dq, dk, dv, lse, delta, *g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the two kernels flash_attention_bwd launches for (dtype, D), as the
// profiler names them, index 0 the dq pass and 1 the dk / dv pass
// ("flash_bwd_dq_kernel<float, 16>", "flash_bwd_dkdv_mma_kernel<80>"), or
// null where it launches none
const char* flash_attention_bwd_kernel(int dtype, int head_dim, int which) {
  static char name[64];
  if (which < 0 || which > 1) return nullptr;
  const char* pass = which == 0 ? "dq" : "dkdv";
  if (dtype == 0 && head_dim == 16)
    snprintf(name, sizeof(name), "flash_bwd_%s_kernel<float, 16>", pass);
  else if (dtype == 1 && (head_dim == 80 || head_dim == 128))
    snprintf(name, sizeof(name), "flash_bwd_%s_mma_kernel<%d>", pass,
             head_dim);
  else
    return nullptr;
  return name;
}

}  // extern "C"
