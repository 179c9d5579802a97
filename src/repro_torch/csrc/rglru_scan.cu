// The RG-LRU's linear recurrence on Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/rglru_scan.py).
//
// rglru_scan  replaces no TPU kernel: the reference computes the recurrence
//             with jax.lax.associative_scan (repro/models/recurrent.py:97-
//             103, rglru_apply's train / prefill scan), outside any Pallas
//             kernel. In PyTorch ops that is either two launches a token
//             (some 74,000 a 4 x 2048 prefill of recurrentgemma-2b's 18
//             RG-LRU layers) or an O(S log S) log-depth scan, so it is a
//             kernel of its own.
//
// What it computes: a, b (B, S, R) float32, contiguous; h (B, S, R) float32
// with h[:, t] = a[:, t] h[:, t - 1] + b[:, t] and h[:, -1] = 0, each step
// one fused multiply-add in float32.
//
// Bound: bytes. At recurrentgemma-2b's prefill (B 4, S 2048, R 2560) it reads
// 2 x 83.9 MB and writes 83.9 MB, 0.075 ms at 3.35 TB/s, against 21 M FMAs.
// Design: one thread owns one (b, r) channel and walks S, so the carry never
// leaves a register and nothing is combined across threads; neighbouring
// threads own neighbouring r, so every load and store of a warp is one
// 128-byte line. The chain of FMAs is serial, so each thread loads kUnroll
// steps of a and b ahead of it (2 kUnroll loads in flight a thread) before
// it runs them. Blocks of 64 threads spread the B R channels (10,240 at
// recurrentgemma-2b's width) over every SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int batch, int seq, int width) {
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (ch >= static_cast<int64_t>(batch) * width) return;
  const int64_t off = ch / width * seq * width + ch % width;
  const float* ap = a + off;
  const float* bp = b + off;
  float* hp = h + off;
  float carry = 0.f;
  for (int t0 = 0; t0 < seq; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = t0 + u < seq;
      const int64_t i = static_cast<int64_t>(ok ? t0 + u : t0) * width;
      av[u] = ok ? __ldg(ap + i) : 0.f;
      bv[u] = ok ? __ldg(bp + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < seq) {
        carry = fmaf(av[u], carry, bv[u]);
        hp[static_cast<int64_t>(t0 + u) * width] = carry;
      }
    }
  }
}

}  // namespace

extern "C" {

// a, b, h: (batch, seq, width) float32, contiguous. Returns the cudaError_t
// of the launch (0 = success).
int rglru_scan(const float* a, const float* b, float* h, int batch, int seq,
               int width, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t channels = static_cast<int64_t>(batch) * width;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, b, h, batch,
                                                           seq, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
