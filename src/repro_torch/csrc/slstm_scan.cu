// The sLSTM's recurrence on Hopper (sm_90a), with a plain C interface loaded
// through ctypes (repro_torch/kernels/slstm_scan.py).
//
// slstm_cluster_kernel  replaces no TPU kernel: the reference computes the
//                       recurrence as a stepwise jax.lax.scan of _slstm_step
//                       (repro/models/recurrent.py:267-286 and 312,
//                       slstm_apply) that XLA compiles into one loop. In
//                       PyTorch ops each step is some twenty launches (four
//                       block-diagonal products h r_g and the gates'
//                       elementwise chain), which at 4 x 2048 tokens is
//                       ~40 k launches a layer; here it is one launch a
//                       layer for the whole sequence, and one a decode step.
//
// What it computes, per step t of each (batch row, head), in the reference's
// order (x_g the float32 pre-activations of the input, r_g (dh, dh) and b_g
// (dh,) the head's recurrent weights and bias in W, cast exactly to float32):
//   pre_g = x_g + (h_{t-1} r_g + b_g)       for g in z, i, f, o
//   z = tanh(pre_z), i_log = pre_i, f_log = log_sigmoid(pre_f),
//   o = 1 / (1 + e^(-pre_o))
//   m_t = max(f_log + m_{t-1}, i_log)
//   i_s = e^(i_log - m_t), f_s = e^((f_log + m_{t-1}) - m_t)
//   c_t = f_s c_{t-1} + i_s z,  n_t = f_s n_{t-1} + i_s
//   h_t = (o c_t) / max(n_t, 1)
// with log_sigmoid(x) = -(max(-x, 0) + log1p(e^(-|x|))), jax.nn.log_sigmoid's
// form. Accurate expf / tanhf / log1pf and IEEE division (no fast math), and
// the library is built with --fmad=false, so the elementwise chain rounds
// where the plain version's PyTorch ops do; each column's dot h r_g is dh
// float32 FMAs in order from d = 0 (cuBLAS sums the plain version's in the
// same order at these shapes: the two agree bit for bit).
//
// Bound: operations. At xlstm-350m's prefill (B 4, S 2048, 4 heads of 256)
// the four products are 2 x 4 x 2048 x 4 x 4 x 256 x 256 = 17.2 GFLOP of
// float32 FMA, 0.26 ms at 67 TFLOP/s, against 168 MB of operands (the four
// pre-activations and hs in float32, r and b in bf16), 0.05 ms at 3.35 TB/s.
// The steps are serial, so the floor a step is the FMAs of one step on the
// SMs a head's cluster holds, plus one exchange of h: on the 32 SMs of the
// design at that shape, 1,024 FMAs a lane a step, which is also each
// column's chain of dependent FMAs (4 cycles each), 0.52 us a step at
// 1.98 GHz and 1.06 ms a call.
//
// Design: one cluster of C blocks a (head, row group). Block k of the
// cluster owns columns [k cols, (k + 1) cols) of all four gates, so each
// gate's elementwise update stays in the block and only h crosses blocks.
// C is the largest of 1, 2, 4, 8 that leaves a block at least 32 columns
// (8 at dh 256), raised where the block's weights would not fit in shared
// memory; the last block of a cluster takes what is left of dh.
// - Weights: at the start of a launch each lane copies its column of its
//   gate (all dh rows, 128 loads in flight) into dynamic shared memory, in
//   16-byte chunks of consecutive d (64 KB of bf16 or 128 KB of float32 a
//   block at dh 256), where it stays for all S steps.
// - Rows: a row group holds up to 8 batch rows (more rows take more
//   clusters, each with its own copy of the head's weights); the instance
//   computes kRows of them, the group's size rounded up to 1, 2, 4 or 8, so
//   each weight read from shared memory serves every row of the group.
// - A step: a warp owns 8 columns of all four gates. Lane (g, c) sums column
//   c of gate g for every row, h a broadcast load of the group's rows at d,
//   the next chunk's loads issued before this chunk's FMAs; kRows x 4
//   shuffles bring the four gates of (row, column) to one lane, which runs
//   the update with its c, n and m in registers and writes h_t to hs.
// - The exchange: a column's rows, gathered into one lane, go to every block
//   of the cluster through distributed shared memory (st.async into the next
//   of two h buffers), each store counted on that buffer's mbarrier there;
//   a block starts a step once its mbarrier has counted the step's h of
//   every column. No cluster barrier a step: barrier.cluster.arrive.release
//   costs a MEMBAR.ALL.GPU (~0.5 us a step on an H100 at xlstm-350m's
//   prefill), and without .release the peers read stale h. A buffer is
//   rewritten only two steps later, which no block reaches before every
//   block has read it.
// - The pre-activations of steps t + 1 and t + 2 are in flight while step t
//   runs. A carry element is read at the start and written at the end by
//   the lane that owns it, and h_(t-1)'s full vector is read into every
//   block before the one cluster barrier at the start, so a carry written in
//   place (a decode step) is safe.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The operands of one call (mirrored by SlstmArgs in
// repro_torch/kernels/cuda_lib.py).
struct SlstmArgs {
  const float* x[4];          // z, i, f, o pre-activations (B, S, H, dh)
  const void* r[4];           // (H, dh, dh) in W
  const void* b[4];           // (H, dh) in W
  const float* carry_in[4];   // c, n, h, m (B, H, dh), null for zeros; may
                              // equal carry_out
  float* carry_out[4];
  float* hs;                  // (B, S, H, dh)
  int batch, seq, heads, dh;
  int* sm_ids;                // (blocks,) the SM each block ran on, or null
};

// What a call launches (reported by slstm_scan_design; the same rule as
// design() in repro_torch/kernels/slstm_scan.py).
struct SlstmDesign {
  int cluster;  // blocks a cluster, one cluster a (head, row group)
  int cols;     // columns of each gate a block owns (the last: what is left)
  int rows;     // batch rows a row group
  int slots;    // rows the instance computes: rows rounded up to 1, 2, 4, 8
  int groups;   // row groups
  int warps;    // warps a block: 8 columns of all four gates each
  int smem;     // dynamic shared memory a block, bytes
};

namespace {

constexpr int kMinDh = 16;   // the head dims taken: even, 16 to 256
constexpr int kMaxDh = 256;
constexpr int kMaxCluster = 8, kMinCols = 32;   // blocks a cluster; columns
                                                // a block kept by a larger C
constexpr int kMaxRows = 8;  // batch rows a row group
constexpr int kMaxWarps = 8;
constexpr int kChunk = 16;   // bytes of one lane's weights a shared load
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block can have

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The design of a call, or false for a shape the kernel does not take.
bool plan(int batch, int heads, int dh, int w_size, SlstmDesign* z) {
  if (batch <= 0 || heads <= 0 || heads > 65535 || dh < kMinDh ||
      dh > kMaxDh || dh % 2 != 0)
    return false;
  z->groups = ceil_div(batch, kMaxRows);
  if (z->groups > 65535) return false;
  z->rows = ceil_div(batch, z->groups);
  z->slots = z->rows <= 1 ? 1 : z->rows <= 2 ? 2 : z->rows <= 4 ? 4 : 8;
  const int chunks = ceil_div(dh * w_size, kChunk);
  int c = 1;
  while (c < kMaxCluster && dh >= 2 * c * kMinCols) c *= 2;
  for (;; c *= 2) {
    z->cluster = c;
    z->cols = ceil_div(dh, c);
    z->warps = ceil_div(z->cols, 8);
    z->smem = z->warps * chunks * 32 * kChunk + 2 * dh * z->slots * 4 + 16;
    if (z->smem <= kMaxSmem && z->warps <= kMaxWarps) return true;
    if (c >= kMaxCluster) return false;
  }
}

// A lane's 16-byte chunk of weights: kPer consecutive d of one column, as
// raw bits (a bf16 is the high half of its float: the cast is exact).
template <typename W>
struct Weights;
template <>
struct Weights<float> {
  using Bits = uint32_t;
  static constexpr int kPer = 4;
  __device__ static float value(Bits v) { return __uint_as_float(v); }
  __device__ static void put(uint32_t (&w)[4], int i, Bits v) { w[i] = v; }
  __device__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float(w[i]);
  }
};
template <>
struct Weights<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int kPer = 8;   // d = 2k low, 2k + 1 high in word k
  __device__ static float value(Bits v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static void put(uint32_t (&w)[4], int i, Bits v) {
    w[i / 2] |= static_cast<uint32_t>(v) << (16 * (i % 2));
  }
  __device__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
};

// h of the group's rows at one d (stored [d][kRows]): one broadcast load
template <int kRows>
__device__ __forceinline__ void load_h(const float* p, float (&h)[kRows]) {
  if constexpr (kRows >= 4) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      h[4 * q] = v.x;
      h[4 * q + 1] = v.y;
      h[4 * q + 2] = v.z;
      h[4 * q + 3] = v.w;
    }
  } else if constexpr (kRows == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    h[0] = v.x;
    h[1] = v.y;
  } else {
    h[0] = p[0];
  }
}

// One chunk's operands in registers: the lane's weights at kPer consecutive
// d and h of the group's rows at each of them
template <typename W, int kRows>
struct Chunk {
  static constexpr int kPer = Weights<W>::kPer;
  uint4 w;
  float h[kPer][kRows];

  // the first n d (all kPer unless kTail) from w_p and h_p ([d][kRows])
  template <bool kTail>
  __device__ __forceinline__ void load(const uint4* w_p, const float* h_p,
                                       int n) {
    w = *w_p;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (kTail && i >= n) break;
      load_h<kRows>(h_p + i * kRows, h[i]);
    }
  }

  // acc[r] += h[i][r] w[i] over the first n d, in order
  template <bool kTail>
  __device__ __forceinline__ void fmas(int n, float (&acc)[kRows]) const {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (kTail && i >= n) break;
      const float wv = Weights<W>::get(words, i);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h[i][r], wv, acc[r]);
    }
  }
};

// acc[r] = sum over d of h[r][d] w[d], one fmaf a d in order from d = 0; w
// the lane's chunks (32 uint4 apart), h the group's rows ([d][kRows]). The
// next chunk's loads are issued before this chunk's FMAs.
template <typename W, int kRows>
__device__ __forceinline__ void column_dots(const uint4* w, const float* h,
                                            int dh, float (&acc)[kRows]) {
  using C = Chunk<W, kRows>;
  const int full = dh / C::kPer, tail = dh % C::kPer;
  if (full > 0) {
    C cur;
    cur.template load<false>(w, h, C::kPer);
#pragma unroll 8
    for (int q = 0; q < full; ++q) {
      const int qn = q + 1 < full ? q + 1 : q;
      C next;
      next.template load<false>(w + qn * 32, h + qn * C::kPer * kRows,
                                C::kPer);
      cur.template fmas<false>(C::kPer, acc);
      cur = next;
    }
  }
  if (tail) {
    C last;
    last.template load<true>(w + full * 32, h + full * C::kPer * kRows,
                             tail);
    last.template fmas<true>(tail, acc);
  }
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

// One step's update of a (row, column) from its four pre-activations'
// products pre (the dots h r_g), its inputs x and the bias, in the
// reference's order; c, n and m advanced in place. Returns h_t.
__device__ __forceinline__ float update(const float (&x)[4],
                                        const float (&pre)[4],
                                        const float (&bias)[4], float& c,
                                        float& n, float& m) {
  const float z = tanhf(x[0] + (pre[0] + bias[0]));
  const float i_log = x[1] + (pre[1] + bias[1]);
  const float f_log = log_sigmoid(x[2] + (pre[2] + bias[2]));
  const float o = 1.f / (1.f + expf(-(x[3] + (pre[3] + bias[3]))));
  const float fm = f_log + m;
  const float m_new = fmaxf(fm, i_log);
  const float i_s = expf(i_log - m_new);
  const float f_s = expf(fm - m_new);
  c = f_s * c + i_s * z;
  n = f_s * n + i_s;
  m = m_new;
  return o * c / fmaxf(n, 1.f);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// the phase's one arrival, which also expects `bytes` of transactions
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// until the phase of `parity` has completed: every byte it expected has
// arrived, and is visible to this thread
__device__ __forceinline__ void bar_wait(const uint64_t* bar,
                                         uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    // a send lost to a fault: a launch failure after ~2 s, not a hang
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// v (N floats) to the address of p in the cluster's block `rank`, counted
// there as 4 N bytes on the mbarrier at the address of bar
template <int N>
__device__ __forceinline__ void send(const float* p, const uint64_t* bar,
                                     int rank, const float (&v)[N]) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
  if constexpr (N == 4)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0],"
        " {%1, %2, %3, %4}, [%5];\n"
        :: "r"(dst), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
           "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])),
           "r"(rbar) : "memory");
  else if constexpr (N == 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0],"
        " {%1, %2}, [%3];\n"
        :: "r"(dst), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
           "r"(rbar) : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1,"
        " [%2];\n"
        :: "r"(dst), "r"(__float_as_uint(v[0])), "r"(rbar) : "memory");
}

template <typename W, int kRows>
__global__ void __launch_bounds__(32 * kMaxWarps)
slstm_cluster_kernel(const SlstmArgs a, const SlstmDesign z) {
  using Wt = Weights<W>;
  using Bits = typename Wt::Bits;
  constexpr int kPer = Wt::kPer;
  constexpr int kSlots = kRows < 4 ? 1 : kRows / 4;   // update items a lane
  extern __shared__ uint4 smem[];
  const int dh = a.dh, chunks = (dh + kPer - 1) / kPer;
  const int rank = blockIdx.x, head = blockIdx.y;   // the cluster spans x
  const int row0 = blockIdx.z * z.rows, rows = min(z.rows, a.batch - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 8;                // the dot's gate; the update's row
  const int lc = warp * 8 + lane % 8;    // the lane's column in the block
  const int col = rank * z.cols + lc;    // ... and in the head
  const bool col_ok = lc < z.cols && col < dh;
  uint4* const w_s = smem + warp * chunks * 32 + lane;
  float* const h_s = reinterpret_cast<float*>(smem + z.warps * chunks * 32);
  // full[b]: h buffer b holds the step's h of every row and column
  uint64_t* const full = reinterpret_cast<uint64_t*>(h_s + 2 * dh * kRows);
  const int bytes = kRows * dh * 4;   // one step's h of the group

  // h_(-1) of the group's rows, all dh, in buffer 0 ([buffer][d][kRows]);
  // rows past the group stay 0 in both. Eight loads in flight a thread.
  for (int i0 = threadIdx.x; i0 < 2 * dh * kRows; i0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * blockDim.x, r = i % kRows;
      v[k] = 0.f;
      if (i < dh * kRows && r < rows && a.carry_in[2] != nullptr)
        v[k] = a.carry_in[2][(static_cast<int64_t>(row0 + r) * a.heads +
                              head) * dh + i / kRows];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k * blockDim.x < 2 * dh * kRows)
        h_s[i0 + k * blockDim.x] = v[k];
  }

  // the lane's update items: row j * 4 + g of the group at column col
  const int64_t step = static_cast<int64_t>(a.heads) * dh;
  float bias[4];
#pragma unroll
  for (int gg = 0; gg < 4; ++gg)
    bias[gg] = col_ok ? Wt::value(__ldg(static_cast<const Bits*>(a.b[gg]) +
                                        head * dh + col))
                      : 0.f;
  bool ok[kSlots];
  int64_t at[kSlots], carry_at[kSlots];   // (row, 0, head, col); (row, head,
                                          // col)
  float c[kSlots], n[kSlots], m[kSlots], h[kSlots];
  // the pre-activations of steps t and t + 1: each set, once the update of
  // its step has read it, loads the step two ahead
  float xa[kSlots][4], xb[kSlots][4];
  auto load_x = [&](int t, float (&x)[kSlots][4]) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
        x[j][gg] = ok[j] && t < a.seq ? a.x[gg][at[j] + t * step] : 0.f;
  };
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int row = row0 + j * 4 + g;
    ok[j] = col_ok && j * 4 + g < rows;
    at[j] = static_cast<int64_t>(row) * a.seq * step + head * dh + col;
    carry_at[j] = (static_cast<int64_t>(row) * a.heads + head) * dh + col;
    c[j] = n[j] = m[j] = h[j] = 0.f;                // no carry in: zeros
    if (ok[j] && a.carry_in[0] != nullptr) {
      c[j] = a.carry_in[0][carry_at[j]];
      n[j] = a.carry_in[1][carry_at[j]];
      m[j] = a.carry_in[3][carry_at[j]];
    }
  }
  load_x(0, xa);
  load_x(1, xb);
  // the lane's column of gate g into its chunks, 128 loads in flight (a
  // lane past the head's columns copies column 0, which no sum reaches)
  {
    const Bits* src = static_cast<const Bits*>(a.r[g]) +
                      static_cast<int64_t>(head) * dh * dh + (col_ok ? col : 0);
    constexpr int kBatch = 128 / kPer;    // chunks a batch
    for (int q0 = 0; q0 < chunks; q0 += kBatch) {
      Bits v[kBatch][kPer];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = (q0 + k) * kPer + i;
          v[k][i] = d < dh ? __ldg(src + d * dh) : Bits(0);
        }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (q0 + k >= chunks) break;
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < kPer; ++i) Wt::put(words, i, v[k][i]);
        w_s[(q0 + k) * 32] = make_uint4(words[0], words[1], words[2],
                                        words[3]);
      }
    }
  }
  if (threadIdx.x == 0) {
    bar_init(&full[0]);
    bar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (a.seq > 1) bar_expect(&full[1], bytes);   // step 0 sends h_0
  }
  // every block of the cluster has started, holds h_(-1) and its barriers
  cluster_arrive();
  cluster_wait();
  // a warp without a column of the head has nothing to do (and waits on
  // nothing, so that it cannot fall a phase behind)
  if (warp * 8 >= min(z.cols, dh - rank * z.cols)) return;

  auto run_step = [&](int t, float (&x)[kSlots][4]) {
    const bool more = t + 1 < a.seq;
    // h_(t-1) in buffer t & 1 (its phase (t - 1) / 2); then the buffer
    // waits for step t + 1's h, which no block can send before this one
    // has sent h_t
    if (t > 0) bar_wait(&full[t & 1], ((t - 1) >> 1) & 1);
    if (threadIdx.x == 0 && t + 2 < a.seq) bar_expect(&full[t & 1], bytes);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    column_dots<W, kRows>(w_s, h_s + (t & 1) * dh * kRows, dh, acc);
    // the four gates of (row j * 4 + g, column) to one lane
    float pre[kSlots][4] = {};
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        const float v = __shfl_sync(0xffffffffu, acc[r], gg * 8 + lane % 8);
        if ((r & 3) == g) pre[r / 4][gg] = v;
      }
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (ok[j]) h[j] = update(x[j], pre[j], bias, c[j], n[j], m[j]);
    if (more) {       // h_t into the next buffer of every block
      constexpr int kVec = kRows < 4 ? kRows : 4;
      const float* nxt = h_s + ((t + 1) & 1) * dh * kRows;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        float v[kVec];     // rows j * 4 .. j * 4 + kVec - 1 of the column
#pragma unroll
        for (int r = 0; r < kVec; ++r)
          v[r] = __shfl_sync(0xffffffffu, h[j], r * 8 + lane % 8);
        if (g == 0 && col_ok)
          for (int p = 0; p < z.cluster; ++p)
            send<kVec>(nxt + col * kRows + j * 4, &full[(t + 1) & 1], p, v);
      }
    }
    load_x(t + 2, x);
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (ok[j]) a.hs[at[j] + t * step] = h[j];
  };
  for (int t = 0; t < a.seq; t += 2) {
    run_step(t, xa);
    if (t + 1 < a.seq) run_step(t + 1, xb);
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (!ok[j]) continue;
    a.carry_out[0][carry_at[j]] = c[j];
    a.carry_out[1][carry_at[j]] = n[j];
    a.carry_out[2][carry_at[j]] = h[j];
    a.carry_out[3][carry_at[j]] = m[j];
  }
  if (a.sm_ids != nullptr && threadIdx.x == 0) {
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    a.sm_ids[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        static_cast<int>(sm);
  }
}

using Kernel = void (*)(SlstmArgs, SlstmDesign);

template <typename W>
Kernel instance(int slots) {
  switch (slots) {
    case 1: return slstm_cluster_kernel<W, 1>;
    case 2: return slstm_cluster_kernel<W, 2>;
    case 4: return slstm_cluster_kernel<W, 4>;
    default: return slstm_cluster_kernel<W, 8>;
  }
}

// The design of a call and its instance, with the instance's attributes set
// for it; a CUDA error, or cudaErrorInvalidValue for a shape it does not
// take.
cudaError_t prepare(int batch, int heads, int dh, int wdtype, SlstmDesign* z,
                    Kernel* kernel) {
  if (wdtype != 0 && wdtype != 1) return cudaErrorInvalidValue;
  if (!plan(batch, heads, dh, wdtype == 0 ? 4 : 2, z))
    return cudaErrorInvalidValue;
  *kernel = wdtype == 0 ? instance<float>(z->slots)
                        : instance<__nv_bfloat16>(z->slots);
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, z->smem);
  if (err == cudaSuccess && z->cluster > 8)
    err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(const SlstmDesign& z, int heads, void* stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(z.cluster, heads, z.groups);
  cfg.blockDim = dim3(32 * z.warps);
  cfg.dynamicSmemBytes = z.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = z.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// args: every operand contiguous; wdtype: r and b's dtype, 0 float32, 1
// bfloat16. Returns the cudaError_t of the launch (0 = success; a refused
// cluster launch, e.g. cudaErrorClusterOutOfResources, is returned too).
int slstm_scan(const SlstmArgs* args, int wdtype, void* stream) {
  const SlstmArgs& a = *args;
  if (a.seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  SlstmDesign z;
  Kernel kernel;
  cudaError_t err = prepare(a.batch, a.heads, a.dh, wdtype, &z, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(z, a.heads, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a, z);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The design a call at (batch, heads, dh, wdtype) launches, into out:
// cluster, cols, rows, slots, groups, warps, threads, smem bytes, blocks
// and the clusters of it the current card can hold at once
// (cudaOccupancyMaxActiveClusters). Returns the number of fields (10), 0 for
// a shape the kernel does not take, or minus a cudaError_t.
int slstm_scan_design(int batch, int heads, int dh, int wdtype, int* out) {
  SlstmDesign z;
  Kernel kernel;
  cudaError_t err = prepare(batch, heads, dh, wdtype, &z, &kernel);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(z, heads, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int fields[] = {z.cluster, z.cols, z.rows, z.slots, z.groups,
                        z.warps, 32 * z.warps, z.smem,
                        z.cluster * heads * z.groups, clusters};
  for (int i = 0; i < 10; ++i) out[i] = fields[i];
  return 10;
}

}  // extern "C"
