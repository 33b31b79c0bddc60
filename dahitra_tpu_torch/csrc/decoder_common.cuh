// Device helpers shared by the decoder-stack kernels (decoder_fwd.cu, K1, and
// decoder_bwd.cu, K2): storage-type rounding, warp sums, the fp32 LayerNorm
// and GELU of dahitra_tpu/nn/decoder_vjp.py. One warp holds one 32-wide token
// row, lane = channel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decoder {

constexpr int DIM = 32;
constexpr int MAX_HL = 128;
constexpr float CLAMP = 80.0f;               // decoder_vjp._NOSHIFT_CLAMP
constexpr float SCALE = 0.17677669529663687f;  // dim ** -0.5 at dim = 32
constexpr float RSQRT2 = 0.70710678118654752f;
constexpr float RSQRT_2PI = 0.39894228040143268f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to T and back (the identity for float).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 two-pass statistics over the warp's 32 lanes (decoder_vjp._ln_stats):
// returns x_hat = (v - mu) * rsqrt(var + 1e-5) and sets rs = rsqrt(var + 1e-5).
__device__ __forceinline__ float ln_hat(float v, float& rs) {
  const float mu = warp_sum(v) * (1.0f / DIM);
  const float dv = v - mu;
  rs = rsqrtf(warp_sum(dv * dv) * (1.0f / DIM) + 1e-5f);
  return (v - mu) * rs;
}

// LayerNorm (decoder_vjp._ln_apply): x_hat * scale + bias.
__device__ __forceinline__ float layer_norm(float v, float scale, float bias) {
  float rs;
  return ln_hat(v, rs) * scale + bias;
}

__device__ __forceinline__ float gelu(float t) {
  return 0.5f * t * (1.0f + erff(t * RSQRT2));
}

// d gelu / dt = cdf(t) + t * pdf(t) (decoder_vjp._gelu_grad).
__device__ __forceinline__ float gelu_grad(float t) {
  return 0.5f * (1.0f + erff(t * RSQRT2)) + t * (expf(-0.5f * t * t) * RSQRT_2PI);
}

}  // namespace decoder
