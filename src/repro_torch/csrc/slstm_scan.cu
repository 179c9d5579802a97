// The sLSTM's recurrence on Hopper (sm_90a), with a plain C interface loaded
// through ctypes (repro_torch/kernels/slstm_scan.py).
//
// slstm_scan_kernel  replaces no TPU kernel: the reference computes the
//                    recurrence as a stepwise jax.lax.scan of _slstm_step
//                    (repro/models/recurrent.py:267-286 and 312, slstm_apply)
//                    that XLA compiles into one loop. In PyTorch ops each
//                    step is some twenty launches (four block-diagonal
//                    products h r_g and the gates' elementwise chain), which
//                    at 4 x 2048 tokens is ~40 k launches a layer; here it is
//                    one launch a layer for the whole sequence, and one a
//                    decode step.
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
// where the plain version's PyTorch ops do; the dot h r_g is float32 FMAs in
// order over the head dim (cuBLAS sums the plain version's in another
// order).
//
// Bound: operations. At xlstm-350m's prefill (B 4, S 2048, 4 heads of 256)
// the four products are 2 x 4 x 2048 x 4 x 4 x 256 x 256 = 17.2 GFLOP of
// float32 FMA, 0.26 ms at 67 TFLOP/s, against 168 MB of operands (the four
// pre-activations and hs in float32, r and b in bf16), 0.05 ms at 3.35 TB/s.
//
// Design (the simple one; far from that bound by construction): one block
// per (head, batch row), 16 blocks at the served shape, walking the sequence
// in order. h_{t-1} sits in shared memory. The block has 2 dh threads: thread
// (g, p) owns columns 2p and 2p + 1 of gate g and each step reads its two
// columns of r_g, a row at a time (a bf16 pair or a float2: a warp's row of
// loads is contiguous), from global memory, where the head's 4 dh^2 weights
// (512 KB in bf16 at dh 256, shared by the head's B blocks) stay in L2, and
// accumulates dh FMAs a column. The pre-activations go to shared memory;
// after a barrier the first dh threads (column e each, its c, n and m in
// registers) run the elementwise update and write h_t over h_{t-1} in shared
// memory (every thread has read it by then) and to hs; a second barrier ends
// the step. So a step reads 4 dh^2 weights from L2 on each of the 16 SMs in
// use: the per-SM L2 rate, not the FMAs, sets the pace. The design for
// later: r_g held in shared memory across a cluster of 4 blocks a head (128
// KB of bf16 a block), all B rows in the cluster, h exchanged through
// distributed shared memory.
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
};

namespace {

constexpr int kMinDh = 16;   // the head dims taken: even, 16 to 256
constexpr int kMaxDh = 256;

template <typename W>
struct Pair;
template <>
struct Pair<float> {
  __device__ static float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
};
template <>
struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    const __nv_bfloat162 v =
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
    return __bfloat1622float2(v);     // exact
  }
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

template <typename W>
__global__ void __launch_bounds__(2 * kMaxDh)
slstm_scan_kernel(const SlstmArgs a) {
  __shared__ float h_s[kMaxDh];
  __shared__ float pre_s[4][kMaxDh];
  const int head = blockIdx.x, row = blockIdx.y;
  const int dh = a.dh, pairs = dh / 2;
  const int tid = threadIdx.x;
  const int g = tid / pairs, e0 = 2 * (tid % pairs);
  const W* rg = static_cast<const W*>(a.r[g]) +
                static_cast<int64_t>(head) * dh * dh + e0;
  const float2 bias =
      Pair<W>::load(static_cast<const W*>(a.b[g]) + head * dh + e0);
  const float* xg = a.x[g];
  const int64_t carry_off = (static_cast<int64_t>(row) * a.heads + head) * dh;
  // step t's element (row, t, head, 0) of the (B, S, H, dh) operands
  const int64_t step = static_cast<int64_t>(a.heads) * dh;
  const int64_t base = static_cast<int64_t>(row) * a.seq * step + head * dh;

  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;    // no carry in: zeros
  if (tid < dh) {
    if (a.carry_in[0] != nullptr) {
      c = a.carry_in[0][carry_off + tid];
      n = a.carry_in[1][carry_off + tid];
      h = a.carry_in[2][carry_off + tid];
      m = a.carry_in[3][carry_off + tid];
    }
    h_s[tid] = h;
  }
  __syncthreads();
  for (int t = 0; t < a.seq; ++t) {
    const int64_t at = base + t * step;
    const float2 xv = *reinterpret_cast<const float2*>(xg + at + e0);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 16
    for (int d = 0; d < dh; ++d) {
      const float hd = h_s[d];
      const float2 rv = Pair<W>::load(rg + static_cast<int64_t>(d) * dh);
      acc0 = fmaf(hd, rv.x, acc0);
      acc1 = fmaf(hd, rv.y, acc1);
    }
    pre_s[g][e0] = xv.x + (acc0 + bias.x);
    pre_s[g][e0 + 1] = xv.y + (acc1 + bias.y);
    __syncthreads();
    if (tid < dh) {
      const float z = tanhf(pre_s[0][tid]);
      const float i_log = pre_s[1][tid];
      const float f_log = log_sigmoid(pre_s[2][tid]);
      const float o = 1.f / (1.f + expf(-pre_s[3][tid]));
      const float fm = f_log + m;
      const float m_new = fmaxf(fm, i_log);
      const float i_s = expf(i_log - m_new);
      const float f_s = expf(fm - m_new);
      c = f_s * c + i_s * z;
      n = f_s * n + i_s;
      h = o * c / fmaxf(n, 1.f);
      m = m_new;
      h_s[tid] = h;
      a.hs[at + tid] = h;
    }
    __syncthreads();
  }
  if (tid < dh) {
    a.carry_out[0][carry_off + tid] = c;
    a.carry_out[1][carry_off + tid] = n;
    a.carry_out[2][carry_off + tid] = h;
    a.carry_out[3][carry_off + tid] = m;
  }
}

template <typename W>
int launch(const SlstmArgs& a, void* stream) {
  slstm_scan_kernel<W><<<dim3(a.heads, a.batch), 2 * a.dh, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// args: every operand contiguous, the pairs of x, r and b aligned to their
// width (8 bytes for float, 4 for bf16); wdtype: r and b's dtype, 0 float32,
// 1 bfloat16. Returns the cudaError_t of the launch (0 = success).
int slstm_scan(const SlstmArgs* args, int wdtype, void* stream) {
  const SlstmArgs& a = *args;
  if (a.batch <= 0 || a.batch > 65535 || a.seq <= 0 || a.heads <= 0 ||
      a.dh < kMinDh || a.dh > kMaxDh || a.dh % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wdtype == 0) return launch<float>(a, stream);
  if (wdtype == 1) return launch<__nv_bfloat16>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
