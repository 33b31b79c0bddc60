// Semantic tokenizer for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel dahitra_tpu/pallas/fused_tokenizer.py
// `_tokenizer_kernel`. For each sample b, with x (N, C = 32) and w (C, L):
//
//   logits = rnd(x . w)                     (N, L), rounded to T
//   attn   = rnd(softmax over the N pixels, in fp32)
//   tokens = attn^T . x                     (L, C), fp32 sums, stored as T
//
// rnd() rounds to the storage type T (identity for float), where the flax
// SemanticTokenizer rounds in bf16 mode (nn/blocks.py:641-645).
//
// Design: one CTA of 1024 threads per sample, warp per pixel with
// lane = channel. Pass 1 reads x once, computes the logits with warp
// shuffles and keeps them in shared memory (N * L floats) with per-warp
// maxima; an in-shared-memory pass turns them into exponentials and column
// sums; pass 2 reads x again and pools. Warp partial tokens are summed in a
// fixed order, so the result does not change from run to run.
//
// Bound on this card: 2 * N * C * L * 2 FLOP against N * C * sizeof(T)
// bytes per sample, i.e. ~4 FLOP per byte in fp32: bounded by bytes. The
// kernel reads x twice (the second read mostly from L2) and writes only the
// tiny token block. Known limit: one CTA per sample, so a batch of 16 fills
// 16 of the 132 SMs; splitting N across CTAs (needed anyway for xBD's
// N = 65536, whose logits do not fit in shared memory) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory: `work` holds max(N * L, WARPS * L * C) floats: the
// (L, N) logits / exponentials, later reused for the warp partial tokens.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tokenizer_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int N, int L) {
  extern __shared__ float work[];
  __shared__ float sW[C * MAX_L];
  __shared__ float sRed[WARPS][MAX_L];
  __shared__ float sMax[MAX_L];
  __shared__ float sSum[MAX_L];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* xb = x + static_cast<int64_t>(b) * N * C;

  for (int i = tid; i < C * L; i += THREADS) sW[i] = to_f(w[i]);
  __syncthreads();

  // ---- pass 1: logits and per-warp maxima ----
  float mx[MAX_L];
#pragma unroll
  for (int k = 0; k < MAX_L; ++k) mx[k] = __int_as_float(0xff800000);  // -inf
  for (int p = warp; p < N; p += WARPS) {
    const float xv = to_f(xb[static_cast<int64_t>(p) * C + lane]);
#pragma unroll
    for (int k = 0; k < MAX_L; ++k) {
      if (k < L) {
        const float logit = rnd<T>(warp_sum(xv * sW[lane * L + k]));
        mx[k] = fmaxf(mx[k], logit);
        if (lane == k) work[k * N + p] = logit;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < MAX_L; ++k) if (k < L) sRed[warp][k] = mx[k];
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < L; ++k) {
      const float m = warp_max(sRed[lane][k]);
      if (lane == 0) sMax[k] = m;
    }
  }
  __syncthreads();

  // ---- exponentials and column sums (shared memory only) ----
  for (int k = 0; k < L; ++k) {
    float s = 0.0f;
    for (int p = tid; p < N; p += THREADS) {
      const float e = expf(work[k * N + p] - sMax[k]);
      work[k * N + p] = e;
      s += e;
    }
    s = warp_sum(s);
    if (lane == 0) sRed[warp][k] = s;
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < L; ++k) {
      const float s = warp_sum(sRed[lane][k]);
      if (lane == 0) sSum[k] = s;
    }
  }
  __syncthreads();

  // ---- pass 2: pool ----
  float acc[MAX_L];
#pragma unroll
  for (int k = 0; k < MAX_L; ++k) acc[k] = 0.0f;
  for (int p = warp; p < N; p += WARPS) {
    const float xv = to_f(xb[static_cast<int64_t>(p) * C + lane]);
#pragma unroll
    for (int k = 0; k < MAX_L; ++k) {
      if (k < L) acc[k] = fmaf(rnd<T>(work[k * N + p] / sSum[k]), xv, acc[k]);
    }
  }
  __syncthreads();  // every warp is done reading the exponentials
#pragma unroll
  for (int k = 0; k < MAX_L; ++k) {
    if (k < L) work[(warp * L + k) * C + lane] = acc[k];
  }
  __syncthreads();
  for (int i = tid; i < L * C; i += THREADS) {
    float s = 0.0f;
    for (int v = 0; v < WARPS; ++v) s += work[v * L * C + i];
    out[static_cast<int64_t>(b) * L * C + i] = from_f<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int N, int L,
           int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tokenizer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tokenizer_kernel<T><<<B, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int semantic_tokenizer_f32(const void* x, const void* w, void* out,
                                      int B, int N, int L, int smem_bytes,
                                      void* stream) {
  return launch<float>(x, w, out, B, N, L, smem_bytes, stream);
}

extern "C" int semantic_tokenizer_bf16(const void* x, const void* w, void* out,
                                       int B, int N, int L, int smem_bytes,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, w, out, B, N, L, smem_bytes, stream);
}
