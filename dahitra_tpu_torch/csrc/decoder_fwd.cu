// Cross-attention decoder stack forward (production "noshift" numerics) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel dahitra_tpu/pallas/folded_decoder.py
// `_fwd_kernel` (forward without saves). Per layer d, for every token row x
// (dim = 32) of sample b, with the per-sample A_d[b] (32, hl) and
// Z_d[b] (hl, 32) that build_az derives from the memory tokens:
//
//   hn   = rnd(LN1(x))                     fp32 statistics
//   dots = rnd(hn . A) * dim**-0.5         matmul output rounded to T
//   e    = exp(clip(dots, -80, 80));  attn = rnd(e / groupsum_l(e))
//   x1   = rnd(rnd(x + rnd(attn . Z)) + rnd(bo))
//   g    = rnd(LN2(x1))
//   t    = rnd(rnd(g . W1) + rnd(b1));  h = rnd(gelu(t))
//   x    = rnd(rnd(x1 + rnd(h . W2)) + rnd(b2))
//
// rnd() rounds to the storage type T (identity for float), at the points
// where nn/decoder_vjp._layer_fwd rounds. The TPU kernel's 4-pixel lane
// fold, kron lifts and hi/lo bf16 split exist for the MXU and are dropped.
//
// Design: one warp per token row, lane = channel. A CTA owns
// WARPS * ROWS_PER_WARP consecutive rows of one sample and keeps them in
// registers across all layers, so x is read once and written once. Each
// layer's A, Z, W1, W2 and vectors are staged in shared memory as fp32.
// LN statistics are warp shuffles; values a lane must broadcast (hn, the
// attention row, g, gelu(t)) go through a per-warp shared buffer.
//
// Bound on this card: ~8.2 kFLOP per row per layer (at hl = 32) against 128
// (bf16) or 256 (fp32) bytes per row for the whole stack, so the work is
// bounded by operations, not bytes. This first version runs its products on
// the fp32 FMA pipe and reads one shared-memory operand per FMA; moving the
// row products onto tensor cores (mma/wgmma over 64-row tiles) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DIM = 32;
constexpr int MAX_HL = 128;
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_CTA = WARPS * ROWS_PER_WARP;
constexpr float CLAMP = 80.0f;

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

// LayerNorm over the warp's 32 lanes with fp32 two-pass statistics
// (decoder_vjp._ln_stats / _ln_apply).
__device__ __forceinline__ float layer_norm(float v, float scale, float bias) {
  const float mu = warp_sum(v) * (1.0f / DIM);
  const float dv = v - mu;
  const float var = warp_sum(dv * dv) * (1.0f / DIM);
  return (v - mu) * rsqrtf(var + 1e-5f) * scale + bias;
}

template <typename T>
__device__ float decoder_layer(float v, int lane, float* buf, const float* sA,
                               const float* sZ, const float* sW1,
                               const float* sW2, const float* sV, int hl,
                               int l, float scale) {
  // ---- attention ----
  const float hn = rnd<T>(layer_norm(v, sV[0 * DIM + lane], sV[1 * DIM + lane]));
  buf[lane] = hn;
  __syncwarp();
  float e[MAX_HL / 32];
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    e[k] = 0.0f;
    if (j < hl) {
      float acc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DIM; ++c) acc = fmaf(buf[c], sA[c * hl + j], acc);
      const float dots = rnd<T>(acc) * scale;
      e[k] = expf(fminf(fmaxf(dots, -CLAMP), CLAMP));
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    if (j < hl) buf[j] = e[k];
  }
  __syncwarp();
  float attn[MAX_HL / 32];
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    attn[k] = 0.0f;
    if (j < hl) {
      const int g0 = (j / l) * l;
      float den = 0.0f;
      for (int i = 0; i < l; ++i) den += buf[g0 + i];
      attn[k] = rnd<T>(e[k] / den);
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    if (j < hl) buf[j] = attn[k];
  }
  __syncwarp();
  float ao = 0.0f;
  for (int j = 0; j < hl; ++j) ao = fmaf(buf[j], sZ[j * DIM + lane], ao);
  const float x1 = rnd<T>(rnd<T>(v + rnd<T>(ao)) + sV[2 * DIM + lane]);

  // ---- feed-forward ----
  const float g = rnd<T>(layer_norm(x1, sV[3 * DIM + lane], sV[4 * DIM + lane]));
  __syncwarp();
  buf[lane] = g;
  __syncwarp();
  float t = 0.0f;
#pragma unroll 8
  for (int c = 0; c < DIM; ++c) t = fmaf(buf[c], sW1[c * DIM + lane], t);
  t = rnd<T>(rnd<T>(t) + sV[5 * DIM + lane]);
  const float h = rnd<T>(0.5f * t * (1.0f + erff(t * 0.70710678118654752f)));
  __syncwarp();
  buf[lane] = h;
  __syncwarp();
  float o = 0.0f;
#pragma unroll 8
  for (int c = 0; c < DIM; ++c) o = fmaf(buf[c], sW2[c * DIM + lane], o);
  const float x2 = rnd<T>(rnd<T>(x1 + rnd<T>(o)) + sV[6 * DIM + lane]);
  __syncwarp();
  return x2;
}

// x, y: (B, N, 32); a: (D, B, 32, hl); z: (D, B, hl, 32); w1, w2: (D, 32, 32)
// laid out (in, out); vecs: (D, 7, 32) fp32 rows
// [ln1_scale, ln1_bias, bo, ln2_scale, ln2_bias, b1, b2].
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
decoder_stack_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                         const T* __restrict__ z, const T* __restrict__ w1,
                         const T* __restrict__ w2, const float* __restrict__ vecs,
                         T* __restrict__ y, int B, int N, int depth, int hl,
                         int l) {
  __shared__ float sA[DIM * MAX_HL];
  __shared__ float sZ[MAX_HL * DIM];
  __shared__ float sW1[DIM * DIM];
  __shared__ float sW2[DIM * DIM];
  __shared__ float sV[7 * DIM];
  __shared__ float sBuf[WARPS][MAX_HL];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * ROWS_PER_CTA + warp * ROWS_PER_WARP;
  const float scale = rsqrtf(static_cast<float>(DIM));

  float xr[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + r;
    xr[r] = row < N ? to_f(x[(static_cast<int64_t>(b) * N + row) * DIM + lane]) : 0.0f;
  }

  for (int d = 0; d < depth; ++d) {
    __syncthreads();  // every warp is done with layer d-1's weights
    const int64_t az_off = (static_cast<int64_t>(d) * B + b) * DIM * hl;
    for (int i = tid; i < DIM * hl; i += WARPS * 32) {
      sA[i] = to_f(a[az_off + i]);
      sZ[i] = to_f(z[az_off + i]);
    }
    for (int i = tid; i < DIM * DIM; i += WARPS * 32) {
      sW1[i] = to_f(w1[d * DIM * DIM + i]);
      sW2[i] = to_f(w2[d * DIM * DIM + i]);
    }
    for (int i = tid; i < 7 * DIM; i += WARPS * 32) {
      const int k = i / DIM;
      const float v = vecs[d * 7 * DIM + i];
      // bo, b1, b2 enter the stack cast to T; the LN parameters stay fp32.
      sV[i] = (k == 2 || k == 5 || k == 6) ? rnd<T>(v) : v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      if (row0 + r < N)  // warp-uniform: the whole warp skips a missing row
        xr[r] = decoder_layer<T>(xr[r], lane, sBuf[warp], sA, sZ, sW1, sW2,
                                 sV, hl, l, scale);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + r;
    if (row < N) y[(static_cast<int64_t>(b) * N + row) * DIM + lane] = from_f<T>(xr[r]);
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* z, const void* w1,
           const void* w2, const void* vecs, void* y, int B, int N, int depth,
           int hl, int l, void* stream) {
  const dim3 grid((N + ROWS_PER_CTA - 1) / ROWS_PER_CTA, B);
  decoder_stack_fwd_kernel<T><<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(z),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const float*>(vecs), static_cast<T*>(y), B, N, depth, hl, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decoder_stack_fwd_f32(const void* x, const void* a, const void* z,
                                     const void* w1, const void* w2,
                                     const void* vecs, void* y, int B, int N,
                                     int depth, int hl, int l, void* stream) {
  return launch<float>(x, a, z, w1, w2, vecs, y, B, N, depth, hl, l, stream);
}

extern "C" int decoder_stack_fwd_bf16(const void* x, const void* a, const void* z,
                                      const void* w1, const void* w2,
                                      const void* vecs, void* y, int B, int N,
                                      int depth, int hl, int l, void* stream) {
  return launch<__nv_bfloat16>(x, a, z, w1, w2, vecs, y, B, N, depth, hl, l, stream);
}
