// The P2M device chain as __device__ functions: the one copy kernel B and
// the fused streaming kernel both call (the CUDA counterpart of
// repro.kernels.p2m_conv._device_epilogue and the core/pixel.py +
// core/mtj.py expressions it traces).
//
// Every physical constant arrives in a P2MPhysics built on the host from the
// port's PixelCircuitParams / MTJParams (repro_torch/kernels/p2m_conv.py);
// nothing here is baked, and the binomial coefficients of the majority
// polynomial come from the host too (exact small integers, so the chain
// holds no integer division). Each expression keeps the reference's operation
// order, and the library is built with --fmad=false so no multiply-add is
// contracted: a float32 value rounds where the plain PyTorch version rounds.
// Transcendentals are the IEEE tanhf / expf (no fast-math intrinsics).
#pragma once

#include <cstdint>

struct P2MPhysics {
  int32_t curve;         // pixel.CURVE_IDS: 0 ideal, 1 gf22_tanh
  int32_t n_redundant;   // MTJs per neuron
  int32_t majority;      // votes needed to activate
  float saturation;      // gf22_tanh knee
  float half_vdd;        // 0.5 * VDD
  float v_sw;            // MTJ switching voltage
  float volts_per_unit;  // VDD / (2 * norm_range)
  float v_max;           // 1.2 * VDD buffer rail
  float v0, v1;          // measured voltages of the two logit segments
  float l0, l1;          // measured logits at v0, v1
  float slope_lo, slope_hi;
  float env_factor;      // clip(env / env_ref, 0, 1), computed on the host
  float binom[25];       // C(n_redundant, k) for k <= n_redundant <= 24
};

// SAME-padded implicit im2col geometry of one frontend call (NHWC frames).
struct ConvGeom {
  int32_t batch, h, w, cin;
  int32_t ho, wo;
  int32_t kernel, stride;
  int32_t pad_top, pad_left;  // low-side SAME pads; the high side is implicit
  int32_t c_out;
};

// rows of the (4, C) per-channel operand (repro_torch/variation/chip.py)
constexpr int kChanUGain = 0;
constexpr int kChanUOffset = 1;
constexpr int kChanLogitGain = 2;
constexpr int kChanLogitOffset = 3;

__device__ __forceinline__ float p2m_curve(const P2MPhysics& ph, float x) {
  return ph.curve == 1 ? ph.saturation * tanhf(x / ph.saturation) : x;
}

__device__ __forceinline__ float p2m_conv_voltage(const P2MPhysics& ph,
                                                  float u, float theta) {
  const float v_th = ph.half_vdd + ph.volts_per_unit * theta;
  const float v_ofs = ph.half_vdd + (ph.v_sw - v_th);
  const float v = v_ofs + ph.volts_per_unit * u;
  return fminf(fmaxf(v, 0.0f), ph.v_max);
}

// 1 + exp(-logit) of voltage v: the sigmoid's denominator
__device__ __forceinline__ float p2m_sigmoid_denominator(
    const P2MPhysics& ph, float v, float logit_gain, float logit_offset) {
  const float lo = ph.l0 + ph.slope_lo * (v - ph.v0);
  const float hi = ph.l1 + ph.slope_hi * (v - ph.v1);
  const float logit = logit_gain * (v < ph.v1 ? lo : hi) + logit_offset;
  return 1.0f + expf(-logit);
}

__device__ __forceinline__ float p2m_switching_probability(
    const P2MPhysics& ph, float v, float logit_gain, float logit_offset) {
  const float p_v =
      1.0f / p2m_sigmoid_denominator(ph, v, logit_gain, logit_offset);
  return p_v * ph.env_factor;
}

// x ** y by jax.lax.integer_pow's square-and-multiply order
__device__ __forceinline__ float p2m_ipow(float x, int y) {
  if (y == 0) return 1.0f;
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

// the polynomial's terms k >= majority of N devices, N known at compile
// time: the loop below unrolled, every power a fixed product chain (the same
// products in the same order, shared between terms)
template <int N>
__device__ __forceinline__ float p2m_majority_terms(const P2MPhysics& ph,
                                                    float p, float q) {
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k <= N; ++k) {
    if (k >= ph.majority) {
      out = out + ph.binom[k] * p2m_ipow(p, k) * p2m_ipow(q, N - k);
    }
  }
  return out;
}

// p2m_majority_terms<N> with the majority M compiled in too: the terms
// k >= M, each the same products, summed in the same order from 0, so the
// same value bit for bit without a test per term
template <int N, int M>
__device__ __forceinline__ float p2m_majority_terms_from(
    const P2MPhysics& ph, float p, float q) {
  float out = 0.0f;
#pragma unroll
  for (int k = M; k <= N; ++k) {
    out = out + ph.binom[k] * p2m_ipow(p, k) * p2m_ipow(q, N - k);
  }
  return out;
}

// P(Binomial(n, p) >= majority), multiply/add only. n 8 (the paper's and
// the default MTJ count) runs unrolled; any other n the loop, bit for bit
// the same arithmetic.
__device__ __forceinline__ float p2m_majority_prob_poly(const P2MPhysics& ph,
                                                        float p) {
  const int n = ph.n_redundant;
  const float q = 1.0f - p;
  if (n == 8) return p2m_majority_terms<8>(ph, p, q);
  float out = 0.0f;
  for (int k = ph.majority; k <= n; ++k) {
    out = out + ph.binom[k] * p2m_ipow(p, k) * p2m_ipow(q, n - k);
  }
  return out;
}

// murmur3's 32-bit finalizer
__device__ __forceinline__ uint32_t p2m_fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// the uint16 draw word of flat element idx: bit-exact with ops.draw_bits
__device__ __forceinline__ uint32_t p2m_draw_word(uint32_t idx, uint32_t k0,
                                                  uint32_t k1) {
  const uint32_t h = p2m_fmix32((idx + 0x9E3779B9u) ^ k0);
  return p2m_fmix32(h ^ k1) & 0xFFFFu;
}

__device__ __forceinline__ float p2m_bernoulli_from_bits(uint32_t word,
                                                         float q) {
  return (static_cast<float>(word) * (1.0f / 65536.0f)) < q ? 1.0f : 0.0f;
}

// u -> (binary draw, subtractor voltage) of flat element idx, given its
// channel's four operand values (chan4[kChan*])
__device__ __forceinline__ float p2m_chain(const P2MPhysics& ph, float u,
                                           float theta, const float* chan4,
                                           uint32_t idx, uint32_t k0,
                                           uint32_t k1, float* v_out) {
  const float uu = u * chan4[kChanUGain] + chan4[kChanUOffset];
  const float v = p2m_conv_voltage(ph, uu, theta);
  const float p_sw = p2m_switching_probability(
      ph, v, chan4[kChanLogitGain], chan4[kChanLogitOffset]);
  const float q = p2m_majority_prob_poly(ph, p_sw);
  *v_out = v;
  return p2m_bernoulli_from_bits(p2m_draw_word(idx, k0, k1), q);
}
