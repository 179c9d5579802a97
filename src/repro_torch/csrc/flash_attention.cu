// Hopper (sm_90a) flash attention with a plain C interface loaded through
// ctypes (repro_torch/kernels/flash_attention.py).
//
// flash_attention_fwd  replaces repro/kernels/flash_attention.py:72
//                      ::flash_attention_pallas (_kernel), together with the
//                      GQA head repeat and the 128-lane D padding that
//                      repro/kernels/ops.py::flash_attention adds around it
//
// What it computes, as _kernel does: online-softmax attention over q (B, S,
// H, D) and k, v (B, S, Hkv, D), read in place through their strides. The
// scores and the accumulator are float32; the scale D^-0.5 is applied to the
// float32 scores after the dot; masked scores are NEG_INF = -1e30 with the
// reference's m_safe / alpha guards; the row sum l adds the float32 p, while
// the P.V product takes p rounded to v's type (p.astype(v.dtype)); the
// output is acc / max(l, 1e-30) in q's type.
//
// Design. One block per (batch * head, 64-row q tile); the TPU's sequential
// kv grid axis becomes a loop over 64-row kv tiles inside the block, with m,
// l and the accumulator carried in registers. With `causal`, the loop ends at
// the last kv tile that is not wholly in the future of the q tile, so the
// causal half of the work is skipped, not masked. Query head h reads kv head
// h / (H / Hkv) directly: no repeated K/V. A ragged tail is masked: kv
// columns past S score NEG_INF, q rows past S are not stored. q tiles are
// issued last-first so the long causal rows start early.
//
//  * bf16 (the serving type): 4 warps, 16 q rows each, on mma.sync
//    m16n8k16 bf16 -> f32 tensor-core fragments (the products of two bf16
//    values are exact in f32). Q stays in registers as A fragments; K is
//    read from shared memory as B fragments; P is re-packed from the score
//    fragments as bf16 A fragments without a trip through shared memory; V
//    fragments come from ldmatrix.trans.
//  * float32: IEEE FFMA (no TF32), 8 q rows x 4 kv columns of scores and
//    8 rows x D/16 columns of the accumulator per thread, P through shared
//    memory.
//
// What bounds it: at the serving geometry (B 4, S 2048, H 32, Hkv 8, D 128,
// bf16, causal) one launch does 4*B*H*S(S+1)/2*D = 137 GFLOP against 34 MB
// of q, k, v and o, so it is bound by the tensor-core rate (0.139 ms at
// 989 TFLOP/s against 0.010 ms of bytes). mma.sync reaches a fraction of
// that rate; wgmma with TMA-fed shared-memory rings is the later step.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // kv rows per tile
constexpr int kThreads = 128;  // 4 warps

}  // namespace

// Mirror: FlashGeom in repro_torch/kernels/cuda_lib.py. Strides in elements.
struct FlashGeom {
  int32_t batch, seq, heads, kv_heads, causal;
  float scale;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

namespace {

struct Tile {
  int q0, b, h, hk, n_kv;
};

__device__ Tile tile_of(const FlashGeom& g) {
  Tile t;
  const int n_qb = (g.seq + kBlockM - 1) / kBlockM;
  t.q0 = (n_qb - 1 - static_cast<int>(blockIdx.x)) * kBlockM;
  t.b = blockIdx.y / g.heads;
  t.h = blockIdx.y % g.heads;
  t.hk = t.h / (g.heads / g.kv_heads);
  const int last_row = min(t.q0 + kBlockM, g.seq) - 1;
  // causal: kv tiles wholly in the future of the q tile are never visited
  t.n_kv = g.causal ? last_row / kBlockN + 1 : (g.seq + kBlockN - 1) / kBlockN;
  return t;
}

__device__ __forceinline__ bool visible(const FlashGeom& g, int row, int col) {
  return col < g.seq && (!g.causal || row >= col);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: the B fragments of two n-tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [row0, row0 + rows) of a (seq, D) slice into a padded shared tile;
// rows past the end are zero
template <int D>
__device__ void load_tile_bf16(__nv_bfloat16* dst, int stride,
                               const __nv_bfloat16* src, int64_t row_stride,
                               int row0, int rows, int seq) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, const FlashGeom g) {
  constexpr int kStride = D + 8;  // padded row: conflict-free fragment reads
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * kStride;
  __nv_bfloat16* vs = ks + kBlockN * kStride;

  const Tile t = tile_of(g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;  // fragment row / column pair
  const __nv_bfloat16* qp = q + t.b * g.q_b + t.h * g.q_h;
  const __nv_bfloat16* kp = k + t.b * g.k_b + t.hk * g.k_h;
  const __nv_bfloat16* vp = v + t.b * g.v_b + t.hk * g.v_h;

  load_tile_bf16<D>(qs, kStride, qp, g.q_s, t.q0, kBlockM, g.seq);
  __syncthreads();
  uint32_t qf[kKSteps][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* base = qs + (wr + gid) * kStride + kk * 16 + tig * 2;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * kStride);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * kStride + 8);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int rows[2] = {t.q0 + wr + gid, t.q0 + wr + gid + 8};

  for (int j = 0; j < t.n_kv; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<D>(ks, kStride, kp, g.k_s, k0, kBlockN, g.seq);
    load_tile_bf16<D>(vs, kStride, vp, g.v_s, k0, kBlockN, g.seq);
    __syncthreads();

    // S = Q K^T in float32
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = ks + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma_bf16(s[nt], qf[kk], ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
    }

    // scale, mask, online softmax (element e of a fragment: row e / 2,
    // column e % 2 of the thread's pair)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const float sc = visible(g, rows[e >> 1], col) ? s[nt][e] * g.scale
                                                       : kNegInf;
        s[nt][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
    float m_safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      m_safe[i] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[i] = m_r[i] <= kNegInf / 2 ? 0.f : expf(m_r[i] - m_safe[i]);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const float p = visible(g, rows[e >> 1], col)
                            ? expf(s[nt][e] - m_safe[e >> 1]) : 0.f;
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = l_r[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += bf16(P) V: the score fragments of n-tiles 2kk, 2kk+1 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // lane l addresses row l % 8 of matrix l / 8: matrices 0/1 are kv rows
      // 0-7 / 8-15 of n-tile dt, matrices 2/3 the same of n-tile dt + 1
      const __nv_bfloat16* vb = vs + (kk * 16 + ((lane / 8) % 2) * 8 +
                                      lane % 8) * kStride + (lane / 16) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vb + dt * 8);
        mma_bf16(acc[dt], pa, bf[0], bf[1]);
        mma_bf16(acc[dt + 1], pa, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= g.seq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* op = o + t.b * g.o_b + rows[i] * g.o_s + t.h * g.o_h +
                        tig * 2;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const uint32_t w = pack_bf16(acc[dt][2 * i] / l, acc[dt][2 * i + 1] / l);
      *reinterpret_cast<uint32_t*>(op + dt * 8) = w;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: IEEE FFMA
// ---------------------------------------------------------------------------

// rows [row0, row0 + rows) of a (seq, D) float32 slice into a shared tile of
// row stride `stride`; rows past the end are zero
template <int D>
__device__ void load_tile_f32(float* dst, int stride, const float* src,
                              int64_t row_stride, int row0, int rows,
                              int seq) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c);
    float* d = dst + r * stride + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const FlashGeom g) {
  constexpr int kQK = D + 1;        // odd stride: conflict-free column reads
  constexpr int kP = kBlockN + 1;
  constexpr int kCols = kBlockN / 16;
  constexpr int kDCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBlockM * kQK;
  float* vs = ks + kBlockN * kQK;
  float* ps = vs + kBlockN * D;

  const Tile t = tile_of(g);
  // 16 threads share 8 rows: kv column / d column tx + 16 * j
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qp = q + t.b * g.q_b + t.h * g.q_h;
  const float* kp = k + t.b * g.k_b + t.hk * g.k_h;
  const float* vp = v + t.b * g.v_b + t.hk * g.v_h;

  load_tile_f32<D>(qs, kQK, qp, g.q_s, t.q0, kBlockM, g.seq);
  float acc[8][kDCols];
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kDCols; ++jd) acc[i][jd] = 0.f;
  }

  for (int j = 0; j < t.n_kv; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // the previous tile (and its P) is consumed
    load_tile_f32<D>(ks, kQK, kp, g.k_s, k0, kBlockN, g.seq);
    load_tile_f32<D>(vs, D, vp, g.v_s, k0, kBlockN, g.seq);
    __syncthreads();

    float s[8][kCols];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[(tx + 16 * c) * kQK + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float qv = qs[(ty * 8 + i) * kQK + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv, kv[c], s[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = t.q0 + ty * 8 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + tx + 16 * c;
        s[i][c] = visible(g, row, col) ? s[i][c] * g.scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float alpha =
          m_r[i] <= kNegInf / 2 ? 0.f : expf(m_r[i] - m_safe);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + tx + 16 * c;
        const float p = visible(g, row, col) ? expf(s[i][c] - m_safe) : 0.f;
        ps[(ty * 8 + i) * kP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_r[i] = l_r[i] * alpha + rs;
#pragma unroll
      for (int jd = 0; jd < kDCols; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();  // P is complete

    for (int c = 0; c < kBlockN; ++c) {
      float vv[kDCols];
#pragma unroll
      for (int jd = 0; jd < kDCols; ++jd) vv[jd] = vs[c * D + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = ps[(ty * 8 + i) * kP + c];
#pragma unroll
        for (int jd = 0; jd < kDCols; ++jd)
          acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = t.q0 + ty * 8 + i;
    if (row >= g.seq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
    float* op = o + t.b * g.o_b + row * g.o_s + t.h * g.o_h;
#pragma unroll
    for (int jd = 0; jd < kDCols; ++jd) op[tx + 16 * jd] = acc[i][jd] / l;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
int launch(Kernel kernel, size_t smem, const void* q, const void* k,
           const void* v, void* o, const FlashGeom& g, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.seq + kBlockM - 1) / kBlockM, g.batch * g.heads);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const FlashGeom& g, void* stream) {
  const size_t smem = (kBlockM + 2 * kBlockN) * (D + 8) * sizeof(__nv_bfloat16);
  return launch<decltype(&flash_bf16_kernel<D>), __nv_bfloat16>(
      flash_bf16_kernel<D>, smem, q, k, v, o, g, stream);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const FlashGeom& g, void* stream) {
  const size_t smem = ((kBlockM + kBlockN) * (D + 1) + kBlockN * D +
                       kBlockM * (kBlockN + 1)) * sizeof(float);
  return launch<decltype(&flash_f32_kernel<D>), float>(
      flash_f32_kernel<D>, smem, q, k, v, o, g, stream);
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. head_dim 16, 32, 64 or 128. Returns the
// cudaError_t of the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int head_dim, const FlashGeom* g,
                        void* stream) {
  if (g->seq <= 0 || g->kv_heads <= 0 || g->heads % g->kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_bf16<16>(q, k, v, o, *g, stream);
      case 32: return launch_bf16<32>(q, k, v, o, *g, stream);
      case 64: return launch_bf16<64>(q, k, v, o, *g, stream);
      case 128: return launch_bf16<128>(q, k, v, o, *g, stream);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_f32<16>(q, k, v, o, *g, stream);
      case 32: return launch_f32<32>(q, k, v, o, *g, stream);
      case 64: return launch_f32<64>(q, k, v, o, *g, stream);
      case 128: return launch_f32<128>(q, k, v, o, *g, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
