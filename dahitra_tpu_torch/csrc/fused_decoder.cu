// Fused cross-attention decoder stack (K4, TransformerDecoder(pallas=True))
// for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel dahitra_tpu/pallas/fused_decoder.py
// `_decoder_kernel`. Per layer d, for every token row x (dim = 32) of sample
// b, with the fp32 residual x kept through all layers:
//
//   mn   = LN1(m)                               memory tokens, shared LN1
//   k    = mm(mn, Wk);  v = mm(mn, Wv)          (L, heads * dim_head)
//   A    = [mm(Wq_h, k_h^T)]_h  (32, hl);  Z = [mm(v_h, Wo_h)]_h  (hl, 32)
//   dots = mm(LN1(x), A) * dim**-0.5
//   attn = exp(dots - groupmax_l(dots)) / groupsum_l(...)     exact, fp32
//   x   += mm(attn, Z) + bo
//   x   += mm(gelu_as(mm(LN2(x), W1) + b1), W2) + b2
//
// mm(a, b) rounds its operands to OP (bf16, or fp32 when PRECISE) and
// accumulates in fp32 (`_make_mm`); LayerNorm is two-pass fp32 and GELU uses
// the Abramowitz-Stegun 7.1.26 erf (`_erf`), as in the TPU kernel. x comes in
// and goes out in the storage type T.
//
// Design: two kernels on one stream. The prologue, grid (depth, B), builds A
// and Z for each layer and sample once, into a scratch buffer; it reads the
// projection weights from global memory (L2), since in fp32 they outgrow one
// SM's shared memory at DAHiTra's widths (4 x 64 KB per layer at
// heads * dim_head = 512). The row kernel has K1's layout
// (csrc/decoder_fwd.cu): one warp per token row, lane = channel, each
// layer's A, Z, W1, W2 (rounded to OP) and vectors staged in shared memory,
// and each row's fp32 residual held in registers across all layers, so x is
// read once and written once.
//
// Bound on this card: operations, as K1 (~8.2 kFLOP per row per layer at
// hl = 32 against 256 bytes per row for the whole stack in fp32), plus the
// memory side, ~0.4 MFLOP per sample and layer at the 1/4 scale. The
// products run on the fp32 FMA pipe; tensor cores are later work.
#include "decoder_common.cuh"

namespace {

using namespace decoder;

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_CTA = WARPS * ROWS_PER_WARP;
constexpr int PRO_THREADS = 256;
constexpr float SQRT2 = 1.41421356237309515f;  // np.sqrt(2.0).astype(float32)

// The operand rounding of `_make_mm`.
template <bool PRECISE> __device__ __forceinline__ float op(float v) {
  return PRECISE ? v : rnd<__nv_bfloat16>(v);
}

// Abramowitz & Stegun 7.1.26 (fused_decoder.py `_erf`).
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return sign * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float x) {
  return x * 0.5f * (1.0f + erf_as(x / SQRT2));
}

// m: (B, L, 32) fp32; wq, wk, wv: (D, 32, inner); wo: (D, inner, 32);
// vecs: (D, 7, 32). Writes a: (D, B, 32, hl) and z: (D, B, hl, 32), fp32
// and unrounded (the row kernel rounds them as operands). Dynamic shared
// memory: mn (L, 32), k and v (L, inner), each rounded to OP.
template <bool PRECISE>
__global__ void __launch_bounds__(PRO_THREADS)
fused_decoder_prologue_kernel(const float* __restrict__ m,
                              const float* __restrict__ wq,
                              const float* __restrict__ wk,
                              const float* __restrict__ wv,
                              const float* __restrict__ wo,
                              const float* __restrict__ vecs,
                              float* __restrict__ a, float* __restrict__ z,
                              int B, int L, int heads, int inner) {
  extern __shared__ float smem[];
  float* smn = smem;
  float* sk = smn + L * DIM;
  float* sv = sk + L * inner;

  const int d = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hd = inner / heads;
  const int hl = heads * L;
  const float* vd = vecs + d * 7 * DIM;
  const int64_t woff = static_cast<int64_t>(d) * DIM * inner;

  // LN1 of each memory token, one warp per token.
  for (int j = warp; j < L; j += PRO_THREADS / 32) {
    const float v = m[(static_cast<int64_t>(b) * L + j) * DIM + lane];
    smn[j * DIM + lane] = op<PRECISE>(layer_norm(v, vd[lane], vd[DIM + lane]));
  }
  __syncthreads();
  // k and v; neighbouring threads read neighbouring weight columns.
  for (int i = tid; i < L * inner; i += PRO_THREADS) {
    const int j = i / inner;
    const int col = i - j * inner;
    float ak = 0.0f, av = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DIM; ++c) {
      const float mv = smn[j * DIM + c];
      ak = fmaf(mv, op<PRECISE>(wk[woff + c * inner + col]), ak);
      av = fmaf(mv, op<PRECISE>(wv[woff + c * inner + col]), av);
    }
    sk[i] = op<PRECISE>(ak);
    sv[i] = op<PRECISE>(av);
  }
  __syncthreads();
  // A[c][h L + j] = sum_e Wq[c][h hd + e] k[j][h hd + e]. A warp shares one
  // (h, j), so its k reads are broadcasts; lane = c.
  const int64_t azoff = (static_cast<int64_t>(d) * B + b) * DIM * hl;
  for (int i = tid; i < DIM * hl; i += PRO_THREADS) {
    const int c = i % DIM;
    const int col = i / DIM;
    const int h = col / L;
    const float* wrow = wq + woff + c * inner + h * hd;
    const float* krow = sk + (col - h * L) * inner + h * hd;
    float acc = 0.0f;
    for (int e = 0; e < hd; ++e) acc = fmaf(op<PRECISE>(wrow[e]), krow[e], acc);
    a[azoff + c * hl + col] = acc;
  }
  // Z[h L + j][c] = sum_e v[j][h hd + e] Wo[h hd + e][c]; lane = c.
  for (int i = tid; i < hl * DIM; i += PRO_THREADS) {
    const int c = i % DIM;
    const int row = i / DIM;
    const int h = row / L;
    const float* vrow = sv + (row - h * L) * inner + h * hd;
    const float* wcol = wo + woff + static_cast<int64_t>(h * hd) * DIM + c;
    float acc = 0.0f;
    for (int e = 0; e < hd; ++e) acc = fmaf(vrow[e], op<PRECISE>(wcol[e * DIM]), acc);
    z[azoff + i] = acc;
  }
}

// One layer for one row; v is the fp32 residual.
template <bool PRECISE>
__device__ float fused_layer(float v, int lane, float* buf, const float* sA,
                             const float* sZ, const float* sW1,
                             const float* sW2, const float* sV, int hl, int l) {
  // ---- attention ----
  buf[lane] = op<PRECISE>(layer_norm(v, sV[0 * DIM + lane], sV[1 * DIM + lane]));
  __syncwarp();
  float dots[MAX_HL / 32];
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    dots[k] = 0.0f;
    if (j < hl) {
      float acc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DIM; ++c) acc = fmaf(buf[c], sA[c * hl + j], acc);
      dots[k] = acc * SCALE;
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    if (j < hl) buf[j] = dots[k];
  }
  __syncwarp();
  float e[MAX_HL / 32];
#pragma unroll
  for (int k = 0; k < MAX_HL / 32; ++k) {
    const int j = lane + 32 * k;
    e[k] = 0.0f;
    if (j < hl) {
      const int g0 = (j / l) * l;
      float mx = buf[g0];
      for (int i = 1; i < l; ++i) mx = fmaxf(mx, buf[g0 + i]);
      e[k] = expf(dots[k] - mx);
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
      attn[k] = op<PRECISE>(e[k] / den);
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
  const float x1 = (v + ao) + sV[2 * DIM + lane];

  // ---- feed-forward ----
  const float g = op<PRECISE>(layer_norm(x1, sV[3 * DIM + lane], sV[4 * DIM + lane]));
  __syncwarp();
  buf[lane] = g;
  __syncwarp();
  float t = 0.0f;
#pragma unroll 8
  for (int c = 0; c < DIM; ++c) t = fmaf(buf[c], sW1[c * DIM + lane], t);
  const float h = op<PRECISE>(gelu_as(t + sV[5 * DIM + lane]));
  __syncwarp();
  buf[lane] = h;
  __syncwarp();
  float o = 0.0f;
#pragma unroll 8
  for (int c = 0; c < DIM; ++c) o = fmaf(buf[c], sW2[c * DIM + lane], o);
  const float x2 = (x1 + o) + sV[6 * DIM + lane];
  __syncwarp();
  return x2;
}

// x, y: (B, N, 32) in T; a, z: the prologue's output; w1, w2: (D, 32, 32)
// fp32 laid out (in, out); vecs: (D, 7, 32) fp32 rows
// [ln1_scale, ln1_bias, bo, ln2_scale, ln2_bias, b1, b2].
template <typename T, bool PRECISE>
__global__ void __launch_bounds__(WARPS * 32)
fused_decoder_rows_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ z,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ vecs, T* __restrict__ y,
                          int B, int N, int depth, int hl, int l) {
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
      sA[i] = op<PRECISE>(a[az_off + i]);
      sZ[i] = op<PRECISE>(z[az_off + i]);
    }
    for (int i = tid; i < DIM * DIM; i += WARPS * 32) {
      sW1[i] = op<PRECISE>(w1[d * DIM * DIM + i]);
      sW2[i] = op<PRECISE>(w2[d * DIM * DIM + i]);
    }
    for (int i = tid; i < 7 * DIM; i += WARPS * 32) sV[i] = vecs[d * 7 * DIM + i];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      if (row0 + r < N) {  // warp-uniform: the whole warp skips a missing row
        xr[r] = fused_layer<PRECISE>(xr[r], lane, sBuf[warp], sA, sZ, sW1, sW2,
                                     sV, hl, l);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + r;
    if (row < N) y[(static_cast<int64_t>(b) * N + row) * DIM + lane] = from_f<T>(xr[r]);
  }
}

template <typename T, bool PRECISE>
int launch(const void* x, const void* m, const void* wq, const void* wk,
           const void* wv, const void* wo, const void* w1, const void* w2,
           const void* vecs, void* a, void* z, void* y, int B, int N,
           int depth, int L, int heads, int inner, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decoder_prologue_kernel<PRECISE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_decoder_prologue_kernel<PRECISE><<<dim3(depth, B), PRO_THREADS, smem, s>>>(
      static_cast<const float*>(m), static_cast<const float*>(wq),
      static_cast<const float*>(wk), static_cast<const float*>(wv),
      static_cast<const float*>(wo), static_cast<const float*>(vecs),
      static_cast<float*>(a), static_cast<float*>(z), B, L, heads, inner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + ROWS_PER_CTA - 1) / ROWS_PER_CTA, B);
  fused_decoder_rows_kernel<T, PRECISE><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(z), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(vecs),
      static_cast<T*>(y), B, N, depth, heads * L, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FUSED_DECODER_ENTRY(NAME, T, PRECISE)                                  \
  extern "C" int NAME(const void* x, const void* m, const void* wq,           \
                      const void* wk, const void* wv, const void* wo,         \
                      const void* w1, const void* w2, const void* vecs,       \
                      void* a, void* z, void* y, int B, int N, int depth,     \
                      int L, int heads, int inner, int smem, void* stream) {  \
    return launch<T, PRECISE>(x, m, wq, wk, wv, wo, w1, w2, vecs, a, z, y, B, \
                              N, depth, L, heads, inner, smem, stream);       \
  }

FUSED_DECODER_ENTRY(fused_decoder_f32_precise, float, true)
FUSED_DECODER_ENTRY(fused_decoder_f32_bf16ops, float, false)
FUSED_DECODER_ENTRY(fused_decoder_bf16_bf16ops, __nv_bfloat16, false)
FUSED_DECODER_ENTRY(fused_decoder_bf16_precise, __nv_bfloat16, true)
