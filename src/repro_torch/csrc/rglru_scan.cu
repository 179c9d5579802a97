// The RG-LRU's linear recurrence on Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/rglru_scan.py).
//
// rglru_scan_kernel  replaces no TPU kernel: the reference computes the
//                    recurrence with jax.lax.associative_scan
//                    (repro/models/recurrent.py:97-103, rglru_apply's train /
//                    prefill scan) and its gates as XLA elementwise ops
//                    (recurrent.py:_rglru_gates), outside any Pallas kernel.
//                    In PyTorch ops the scan is either two launches a token
//                    or an O(S log S) log-depth scan, and the gates' float32
//                    tail is some ten launches over (B, S, R) tensors, so
//                    both are a kernel of their own.
//
// One kernel, two instances:
//  * rglru_scan_kernel<float, false>: a, b (B, S, R) float32 -> h (B, S, R)
//    float32 with h[:, t] = a[:, t] h[:, t - 1] + b[:, t] from h = 0;
//  * rglru_scan_kernel<T, true> (T bf16 or float32): the gates' float32
//    tail fused in front of the same scan. From r, i, u (B, S, R) in T and
//    c = -8 softplus(lam) (R,) float32, per element in the order of the
//    eager chain (models/recurrent.py::_rglru_ab): log a = c float(r),
//    a = expf(log a), beta = sqrtf(clamp(1 - expf(2 log a), 1e-12, 1)) (NaN
//    passes the clamp as torch.clamp passes it), i u rounded to T, b = beta
//    float(i u); then the scan; out hs in T (h rounded once) and h_last
//    (B, R) float32, the unrounded h of the last step. Built with
//    --fmad=false and no fast math, so each of those steps rounds where the
//    eager chain's kernels do: the instance equals the unfused chain
//    (tail, instance 1, cast) bit for bit.
//
// Bound: bytes. At recurrentgemma-2b's prefill (B 4, S 2048, R 2560)
// instance 1 reads 2 x 83.9 MB and writes 83.9 MB, 0.075 ms at 3.35 TB/s;
// the gated bf16 instance reads 3 x 21.0 M bf16 and writes 21.0 M bf16 and
// 41 KB of h_last, 167.8 MB, 0.050 ms, against 21 M FMAs and 42 M expf.
//
// Design: parallel over the sequence as well as over channels, each operand
// read once. A block owns 32 consecutive channels (a lane each: a warp's
// row of loads is one 128-byte line of float32, 64 bytes of bf16) of one
// batch row and walks S in chunks of kChunk = kWarps x kRows steps; warp w
// owns steps [w kRows, (w + 1) kRows) of each chunk. Per chunk:
//  1. the warp's kRows steps of every operand are already in registers:
//     they were loaded while the previous chunk ran (each thread keeps 2-3
//     x kRows loads in flight: at the serving shape some 19 warps an SM,
//     30-40 KB in flight an SM). A ring of 3-4 chunks in shared memory
//     filled by cp.async, 2.5x those bytes in flight, ran instance 1 18%
//     slower and the gated one 4% faster (scripts/rglru_ab.py, H100), so
//     loads staged in registers stay: instance 1 runs at ~2.6 TB/s, and
//     the gated one's gate math (two expf and an IEEE sqrtf an element)
//     does not wholly hide under its loads;
//  2. the warp reduces its steps to (prod a, h from 0) in float32 FMAs;
//  3. the warps exchange those through shared memory (one barrier) and
//     each thread folds them in warp order from the chunk's carry-in:
//     c_{w+1} = fmaf(prod_w, c_w, h_w), the same values in every warp, so
//     the next chunk's carry needs no second exchange;
//  4. the warp re-runs its steps from c_w, the recurrence step by step,
//     and stores h. The decomposition is fixed, so the result is
//     deterministic, and the same in both instances.
// The grid is (ceil(R / 32), B): 320 blocks of 8 warps at the serving
// shape, all resident at once on 132 SMs, so no block waits for a second
// wave.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;               // channels a block
// 8 warps of 8 steps ran 2-5% faster than 4 of 16 (scripts/rglru_ab.py,
// H100): the same bytes in flight, half the registers a thread, twice the
// warps to hide each other's gate math
constexpr int kWarps = 8;                // warps a block
constexpr int kRows = 8;                 // steps a warp owns in a chunk
constexpr int kChunk = kWarps * kRows;   // steps a chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);        // round to nearest even, as .to()
}

// a and b of one element from its gates, in the eager chain's order
template <typename T>
__device__ __forceinline__ void gates(float c, T r, T i, T u, float& a,
                                      float& b) {
  const float log_a = c * to_f32(r);
  a = expf(log_a);
  const float one_minus = 1.f - expf(2.f * log_a);
  const float clamped =
      isnan(one_minus) ? one_minus : fminf(fmaxf(one_minus, 1e-12f), 1.f);
  const float iu = to_f32(from_f32<T>(to_f32(i) * to_f32(u)));
  b = sqrtf(clamped) * iu;
}

// x0, x1 (, x2): instance 1's a, b; the gated instance's r, i, u
template <typename T, int kIn>
__device__ __forceinline__ void load_rows(T (&dst)[kIn][kRows], const T* x0,
                                          const T* x1, const T* x2,
                                          int64_t base, int width, int seq,
                                          int t0, bool live) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int t = t0 + u;
    const bool ok = live && t < seq;
    const int64_t off = base + static_cast<int64_t>(ok ? t : 0) * width;
    dst[0][u] = ok ? x0[off] : from_f32<T>(0.f);
    dst[1][u] = ok ? x1[off] : from_f32<T>(0.f);
    if constexpr (kIn == 3) dst[2][u] = ok ? x2[off] : from_f32<T>(0.f);
  }
}

template <typename T, bool kGated>
__global__ void __launch_bounds__(kWarps * 32)
rglru_scan_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                  const T* __restrict__ x2, const float* __restrict__ coef,
                  T* __restrict__ h, float* __restrict__ h_last, int seq,
                  int width) {
  constexpr int kIn = kGated ? 3 : 2;
  __shared__ float2 part[2][kWarps][kLanes];   // (prod a, h) of each warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = blockIdx.x * kLanes + lane;
  const bool live = ch < width;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * width +
                       (live ? ch : 0);
  float c = 0.f;
  if constexpr (kGated) c = live ? coef[ch] : 0.f;

  T cur[kIn][kRows], nxt[kIn][kRows];
  load_rows<T, kIn>(cur, x0, x1, x2, base, width, seq, warp * kRows, live);
  float carry = 0.f;
  int buf = 0;
  for (int t0 = 0; t0 < seq; t0 += kChunk, buf ^= 1) {
    const int first = t0 + warp * kRows;    // this warp's first step
    if (t0 + kChunk < seq)
      load_rows<T, kIn>(nxt, x0, x1, x2, base, width, seq, first + kChunk,
                        live);
    float a[kRows], b[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if constexpr (kGated) {
        gates(c, cur[0][u], cur[1][u], cur[2][u], a[u], b[u]);
      } else {
        a[u] = to_f32(cur[0][u]);
        b[u] = to_f32(cur[1][u]);
      }
      if (!live || first + u >= seq) {      // the identity step
        a[u] = 1.f;
        b[u] = 0.f;
      }
    }
    float prod = 1.f, hw = 0.f;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      hw = fmaf(a[u], hw, b[u]);
      prod = prod * a[u];
    }
    part[buf][warp][lane] = make_float2(prod, hw);
    __syncthreads();
    // a fast warp can reach the next chunk's store before a slow one has
    // read this chunk's: the exchange alternates between two buffers, and
    // the next chunk's barrier keeps the one after that from racing
    float start = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) start = carry;
      const float2 p = part[buf][w][lane];
      carry = fmaf(p.x, carry, p.y);
    }
    float hv = start;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      hv = fmaf(a[u], hv, b[u]);
      const int t = first + u;
      if (live && t < seq) {
        h[base + static_cast<int64_t>(t) * width] = from_f32<T>(hv);
        if (kGated && t == seq - 1)
          h_last[static_cast<int64_t>(blockIdx.y) * width + ch] = hv;
      }
    }
#pragma unroll
    for (int k = 0; k < kIn; ++k)
#pragma unroll
      for (int u = 0; u < kRows; ++u) cur[k][u] = nxt[k][u];
  }
}

template <typename T, bool kGated>
int launch(const T* x0, const T* x1, const T* x2, const float* coef, T* h,
           float* h_last, int batch, int seq, int width, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((width + kLanes - 1) / kLanes, batch);
  rglru_scan_kernel<T, kGated><<<grid, kWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x0, x1, x2, coef, h, h_last, seq, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b, h: (batch, seq, width) float32, contiguous. Returns the cudaError_t
// of the launch (0 = success).
int rglru_scan(const float* a, const float* b, float* h, int batch, int seq,
               int width, void* stream) {
  return launch<float, false>(a, b, nullptr, nullptr, h, nullptr, batch, seq,
                              width, stream);
}

// r, i, u, hs: (batch, seq, width), contiguous, of dtype 0 (float32) or 1
// (bfloat16); c: (width,) float32; h_last: (batch, width) float32. Returns
// the cudaError_t of the launch (0 = success).
int rglru_scan_gated(const void* r, const void* i, const void* u,
                     const float* c, void* hs, float* h_last, int dtype,
                     int batch, int seq, int width, void* stream) {
  if (dtype == 0)
    return launch<float, true>(
        static_cast<const float*>(r), static_cast<const float*>(i),
        static_cast<const float*>(u), c, static_cast<float*>(hs), h_last,
        batch, seq, width, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(i),
        static_cast<const __nv_bfloat16*>(u), c,
        static_cast<__nv_bfloat16*>(hs), h_last, batch, seq, width, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
