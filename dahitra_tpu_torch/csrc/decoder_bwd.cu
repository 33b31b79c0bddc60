// Cross-attention decoder stack backward (K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel dahitra_tpu/pallas/folded_decoder.py
// `_bwd_kernel` (called through `_folded_bwd_call` and `_fds_bwd`). It
// consumes what the forward with saves (decoder_fwd.cu, SAVE) wrote: each
// layer's input x_in (D, B, N, 32) and attention (D, B, N, hl), both in T.
// The numerics are those of dahitra_tpu/nn/decoder_vjp.py `_layer_bwd`, not
// the Pallas kernel's MXU shortcuts (its LN-backward lane means come from
// single bf16 matmuls). Per layer, in reverse, for each token row:
//
//   recompute   hn = rnd(LN1(x)), x1, g = rnd(LN2(x1)), t, hg = rnd(gelu(t))
//               with the forward's exact operations;
//   dhg  = rnd(dy . W2^T);     dt32 = dhg * gelu'(t);   dt = rnd(dt32)
//   dg   = rnd(dt . W1^T);     dx1  = rnd(dy + rnd(LN2^T(dg)))
//   dattn = rnd(dx1 . Z^T);    dl   = rnd(attn * (dattn - segsum_l(attn * dattn)) * scale)
//   dhn  = rnd(dl . A^T);      dx   = rnd(dx1 + rnd(LN1^T(dhn)))
//
// and the sums over rows: dW2 += hg^T dy, dW1 += g^T dt, dA[b] += hn^T dl,
// dZ[b] += attn^T dx1 and the seven vector gradients (dls1 and dlb1 from the
// x side only; the memory side is added by autograd outside), in VEC order
// [ln1_scale, ln1_bias, bo, ln2_scale, ln2_bias, b1, b2].
//
// Design. The TPU kernel accumulates over a sequential grid; here CTAs run in
// parallel, so each CTA owns a contiguous range of rows of one sample, loops
// over the layers in reverse (staging A, A^T, Z, Z^T, W1, W1^T, W2^T of the
// layer in shared memory as fp32) and within a layer over tiles of 32 rows:
// one warp per row, lane = channel, as in the forward. A row's cotangent
// crosses layers through dx in device memory (every value is a T value, so
// nothing is lost). Each tile's per-row factors go to shared memory, then
// every thread adds its fixed share of the weight-side sums over the tile's
// rows into registers. At the end of a layer the CTA writes its partial sums
// to a scratch buffer; a second kernel sums the partials in a fixed order
// (no float atomics, so a rerun gives the same bits) and rounds dA and dZ to
// T per sample, as _layer_bwd does.
//
// Bound on this card: about 10 kFLOP + 320 * hl FLOP per row per layer
// (ten row products) against 2 * (32 + hl) bytes of saves per row and layer
// in bf16, so operations bound it. This first version runs everything on the
// fp32 FMA pipe; tensor cores are later work.
#include "decoder_common.cuh"

namespace {

using namespace decoder;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int TILE = WARPS * ROWS_PER_WARP;
constexpr int NW = DIM * DIM;               // one 32 x 32 weight
constexpr int NV = 7 * DIM;                 // the seven vectors
constexpr int KW = NW / THREADS;            // weight-sum entries per thread
constexpr int KAZ = MAX_HL * DIM / THREADS; // dA or dZ entries per thread, at most

// Floats of one (CTA, layer) partial: [dW1 | dW2 | dA | dZ | dvec].
__host__ __device__ __forceinline__ int64_t part_size(int hl) {
  return 2 * NW + 2 * DIM * hl + NV;
}

__host__ __device__ __forceinline__ size_t smem_floats(int hl) {
  return 4 * DIM * hl          // A, A^T, Z, Z^T
         + 3 * NW + NV         // W1, W1^T, W2^T, vectors
         + WARPS * MAX_HL      // per-warp broadcast rows
         + TILE * (6 * DIM + 2 * hl)  // tile factors
         + WARPS * NV;         // per-warp vector sums
}

// xsave: (D, B, N, 32), attnsave: (D, B, N, hl), dy, dx: (B, N, 32), all T;
// a: (D, B, 32, hl), z: (D, B, hl, 32), w1, w2: (D, 32, 32) (in, out), T;
// vecs: (D, 7, 32) fp32; part: (B * cps, D, part_size(hl)) fp32 scratch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decoder_stack_bwd_rows(const T* __restrict__ xsave, const T* __restrict__ attnsave,
                       const T* __restrict__ dy_in, const T* __restrict__ a,
                       const T* __restrict__ z, const T* __restrict__ w1,
                       const T* __restrict__ w2, const float* __restrict__ vecs,
                       T* __restrict__ dx, float* __restrict__ part, int B,
                       int N, int depth, int hl, int l, int rows_per_cta) {
  extern __shared__ float smem[];
  float* sA = smem;                   // A[c * hl + j]
  float* sAT = sA + DIM * hl;         // A[c, j] at [j * 32 + c]
  float* sZ = sAT + DIM * hl;         // Z[j * 32 + c]
  float* sZT = sZ + DIM * hl;         // Z[j, c] at [c * hl + j]
  float* sW1 = sZT + DIM * hl;        // W1[c * 32 + m]
  float* sW1T = sW1 + NW;             // W1[c, m] at [m * 32 + c]
  float* sW2T = sW1T + NW;            // W2[m, c] at [c * 32 + m]
  float* sV = sW2T + NW;
  float* sBuf = sV + NV;              // WARPS x MAX_HL
  float* tHg = sBuf + WARPS * MAX_HL; // TILE x 32 each
  float* tDy = tHg + TILE * DIM;
  float* tG = tDy + TILE * DIM;
  float* tDt = tG + TILE * DIM;
  float* tHn = tDt + TILE * DIM;
  float* tDx1 = tHn + TILE * DIM;
  float* tAttn = tDx1 + TILE * DIM;   // TILE x hl
  float* tDl = tAttn + TILE * hl;     // TILE x hl
  float* sRed = tDl + TILE * hl;      // WARPS x 7 x 32

  const int b = blockIdx.y;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int r_begin = blockIdx.x * rows_per_cta;
  const int r_end = min(N, r_begin + rows_per_cta);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* buf = sBuf + warp * MAX_HL;
  const int n_az = DIM * hl;
  const int64_t ps = part_size(hl);

  // This thread's dA entries e = tid + THREADS * k at [c * hl + j].
  int cA[KAZ], jA[KAZ];
#pragma unroll
  for (int k = 0; k < KAZ; ++k) {
    const int e = tid + THREADS * k;
    cA[k] = e / hl;
    jA[k] = e - cA[k] * hl;
  }

  for (int d = depth - 1; d >= 0; --d) {
    __syncthreads();  // every thread is done with layer d+1's shared data
    const int64_t az_off = (static_cast<int64_t>(d) * B + b) * n_az;
    for (int i = tid; i < n_az; i += THREADS) {
      const float av = to_f(a[az_off + i]);  // i = c * hl + j
      const int c = i / hl, j = i - (i / hl) * hl;
      sA[i] = av;
      sAT[j * DIM + c] = av;
      const float zv = to_f(z[az_off + i]);  // i = j * 32 + c
      sZ[i] = zv;
      sZT[(i & (DIM - 1)) * hl + (i >> 5)] = zv;
    }
    for (int i = tid; i < NW; i += THREADS) {
      const float v1 = to_f(w1[d * NW + i]);
      const float v2 = to_f(w2[d * NW + i]);
      const int r = i >> 5, c = i & (DIM - 1);
      sW1[i] = v1;
      sW1T[c * DIM + r] = v1;
      sW2T[c * DIM + r] = v2;
    }
    for (int i = tid; i < NV; i += THREADS) {
      const int k = i / DIM;
      const float v = vecs[d * NV + i];
      sV[i] = (k == 2 || k == 5 || k == 6) ? rnd<T>(v) : v;  // as the forward
    }
    float accW1[KW], accW2[KW], accA[KAZ], accZ[KAZ], vacc[7];
#pragma unroll
    for (int k = 0; k < KW; ++k) accW1[k] = accW2[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < KAZ; ++k) accA[k] = accZ[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) vacc[k] = 0.0f;
    __syncthreads();

    const float s1 = sV[0 * DIM + lane], b1n = sV[1 * DIM + lane];
    const float bo = sV[2 * DIM + lane], s2 = sV[3 * DIM + lane];
    const float b2n = sV[4 * DIM + lane], bf1 = sV[5 * DIM + lane];

    for (int t0 = r_begin; t0 < r_end; t0 += TILE) {
#pragma unroll 1
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int slot = warp * ROWS_PER_WARP + r;
        const int row = t0 + slot;
        if (row >= r_end) {  // warp-uniform: an empty slot adds zeros
          tHg[slot * DIM + lane] = tDy[slot * DIM + lane] = 0.0f;
          tG[slot * DIM + lane] = tDt[slot * DIM + lane] = 0.0f;
          tHn[slot * DIM + lane] = tDx1[slot * DIM + lane] = 0.0f;
          for (int j = lane; j < hl; j += 32)
            tAttn[slot * hl + j] = tDl[slot * hl + j] = 0.0f;
          continue;
        }
        const int64_t srow = (static_cast<int64_t>(d) * B + b) * N + row;
        const int64_t xrow = (static_cast<int64_t>(b) * N + row) * DIM + lane;
        const float x = to_f(xsave[srow * DIM + lane]);
        const float dyv = to_f(d == depth - 1 ? dy_in[xrow] : dx[xrow]);
        float at[MAX_HL / 32];
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k) {
          const int j = lane + 32 * k;
          at[k] = j < hl ? to_f(attnsave[srow * hl + j]) : 0.0f;
        }

        // ---- recompute the forward (decoder_fwd.cu decoder_layer) ----
        float rs;
        const float xhat = ln_hat(x, rs);
        const float hn = rnd<T>(xhat * s1 + b1n);
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k)
          if (lane + 32 * k < hl) buf[lane + 32 * k] = at[k];
        __syncwarp();
        float ao = 0.0f;
        for (int j = 0; j < hl; ++j) ao = fmaf(buf[j], sZ[j * DIM + lane], ao);
        const float x1 = rnd<T>(rnd<T>(x + rnd<T>(ao)) + bo);
        float rs1;
        const float xhat1 = ln_hat(x1, rs1);
        const float g = rnd<T>(xhat1 * s2 + b2n);
        __syncwarp();
        buf[lane] = g;
        __syncwarp();
        float t = 0.0f;
#pragma unroll 8
        for (int c = 0; c < DIM; ++c) t = fmaf(buf[c], sW1[c * DIM + lane], t);
        t = rnd<T>(rnd<T>(t) + bf1);
        const float hg = rnd<T>(gelu(t));

        // ---- feed-forward backward ----
        __syncwarp();
        buf[lane] = dyv;
        __syncwarp();
        float dhg = 0.0f;
#pragma unroll 8
        for (int c = 0; c < DIM; ++c) dhg = fmaf(buf[c], sW2T[c * DIM + lane], dhg);
        const float dt32 = rnd<T>(dhg) * gelu_grad(t);
        const float dt = rnd<T>(dt32);
        __syncwarp();
        buf[lane] = dt;
        __syncwarp();
        float dg = 0.0f;
#pragma unroll 8
        for (int m = 0; m < DIM; ++m) dg = fmaf(buf[m], sW1T[m * DIM + lane], dg);
        dg = rnd<T>(dg);
        // LN2 backward (decoder_vjp._ln_bwd)
        const float dxh2 = dg * s2;
        const float mean_a = warp_sum(dxh2) * (1.0f / DIM);
        const float mean_b = warp_sum(dxh2 * xhat1) * (1.0f / DIM);
        const float dx1 = rnd<T>(dyv + rnd<T>(rs1 * (dxh2 - mean_a - xhat1 * mean_b)));
        vacc[2] += dx1;
        vacc[3] += dg * xhat1;
        vacc[4] += dg;
        vacc[5] += dt32;
        vacc[6] += dyv;

        // ---- attention backward ----
        __syncwarp();
        buf[lane] = dx1;
        __syncwarp();
        float dat[MAX_HL / 32], p[MAX_HL / 32];
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k) {
          const int j = lane + 32 * k;
          dat[k] = p[k] = 0.0f;
          if (j < hl) {
            float acc = 0.0f;
#pragma unroll 8
            for (int c = 0; c < DIM; ++c) acc = fmaf(buf[c], sZT[c * hl + j], acc);
            dat[k] = rnd<T>(acc);
            p[k] = at[k] * dat[k];
          }
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k)
          if (lane + 32 * k < hl) buf[lane + 32 * k] = p[k];
        __syncwarp();
        float dl[MAX_HL / 32];
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k) {
          const int j = lane + 32 * k;
          dl[k] = 0.0f;
          if (j < hl) {
            const int g0 = (j / l) * l;
            float srow_sum = 0.0f;
            for (int i = 0; i < l; ++i) srow_sum += buf[g0 + i];
            dl[k] = rnd<T>(at[k] * (dat[k] - srow_sum) * SCALE);
          }
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k)
          if (lane + 32 * k < hl) buf[lane + 32 * k] = dl[k];
        __syncwarp();
        float dhn = 0.0f;
        for (int j = 0; j < hl; ++j) dhn = fmaf(buf[j], sAT[j * DIM + lane], dhn);
        dhn = rnd<T>(dhn);
        // LN1 backward, x side
        const float dxh1 = dhn * s1;
        const float mean_c = warp_sum(dxh1) * (1.0f / DIM);
        const float mean_d = warp_sum(dxh1 * xhat) * (1.0f / DIM);
        const float dxv = rnd<T>(dx1 + rnd<T>(rs * (dxh1 - mean_c - xhat * mean_d)));
        vacc[0] += dhn * xhat;
        vacc[1] += dhn;
        __syncwarp();

        tHg[slot * DIM + lane] = hg;
        tDy[slot * DIM + lane] = dyv;
        tG[slot * DIM + lane] = g;
        tDt[slot * DIM + lane] = dt;
        tHn[slot * DIM + lane] = hn;
        tDx1[slot * DIM + lane] = dx1;
#pragma unroll
        for (int k = 0; k < MAX_HL / 32; ++k) {
          const int j = lane + 32 * k;
          if (j < hl) {
            tAttn[slot * hl + j] = at[k];
            tDl[slot * hl + j] = dl[k];
          }
        }
        dx[xrow] = from_f<T>(dxv);
      }
      __syncthreads();
      // Weight-side sums over the tile's rows, each thread its own entries.
      for (int rr = 0; rr < TILE; ++rr) {
        const float* hgr = tHg + rr * DIM;
        const float* gr = tG + rr * DIM;
        const float* hnr = tHn + rr * DIM;
        const float* atr = tAttn + rr * hl;
        const float* dlr = tDl + rr * hl;
        const float dyl = tDy[rr * DIM + lane];
        const float dtl = tDt[rr * DIM + lane];
        const float dx1l = tDx1[rr * DIM + lane];
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          accW2[k] = fmaf(hgr[warp + WARPS * k], dyl, accW2[k]);  // [m, c]
          accW1[k] = fmaf(gr[warp + WARPS * k], dtl, accW1[k]);   // [c, m]
        }
#pragma unroll
        for (int k = 0; k < KAZ; ++k) {
          if (tid + THREADS * k < n_az) {
            accA[k] = fmaf(hnr[cA[k]], dlr[jA[k]], accA[k]);          // [c, j]
            accZ[k] = fmaf(atr[warp + WARPS * k], dx1l, accZ[k]);     // [j, c]
          }
        }
      }
      __syncthreads();
    }

    float* out = part + (static_cast<int64_t>(cta) * depth + d) * ps;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      out[tid + THREADS * k] = accW1[k];
      out[NW + tid + THREADS * k] = accW2[k];
    }
#pragma unroll
    for (int k = 0; k < KAZ; ++k) {
      const int e = tid + THREADS * k;
      if (e < n_az) {
        out[2 * NW + e] = accA[k];
        out[2 * NW + n_az + e] = accZ[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) sRed[warp * NV + k * DIM + lane] = vacc[k];
    __syncthreads();
    for (int i = tid; i < NV; i += THREADS) {
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += sRed[w * NV + i];
      out[2 * NW + 2 * n_az + i] = s;
    }
  }
}

// Sums the partials in a fixed order: dW1, dW2 and dvecs over every CTA of
// every sample (fp32 out); dA and dZ over the CTAs of each sample, rounded to
// T per sample.
template <typename T>
__global__ void decoder_stack_bwd_reduce(const float* __restrict__ part,
                                         T* __restrict__ da, T* __restrict__ dz,
                                         float* __restrict__ dw1,
                                         float* __restrict__ dw2,
                                         float* __restrict__ dvecs, int B,
                                         int cps, int depth, int hl) {
  const int n_az = DIM * hl;
  const int64_t ps = part_size(hl);
  const int64_t n_glob = static_cast<int64_t>(depth) * (2 * NW + NV);
  const int64_t n_all = n_glob + static_cast<int64_t>(depth) * B * 2 * n_az;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n_all; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n_glob) {
      const int d = static_cast<int>(i / (2 * NW + NV));
      const int e = static_cast<int>(i - static_cast<int64_t>(d) * (2 * NW + NV));
      const int64_t off = e < 2 * NW ? e : e + 2 * n_az;
      float s = 0.0f;
      for (int c = 0; c < B * cps; ++c)
        s += part[(static_cast<int64_t>(c) * depth + d) * ps + off];
      if (e < NW) dw1[d * NW + e] = s;
      else if (e < 2 * NW) dw2[d * NW + e - NW] = s;
      else dvecs[d * NV + e - 2 * NW] = s;
    } else {
      const int64_t k = i - n_glob;
      const int e = static_cast<int>(k % (2 * n_az));
      const int64_t db = k / (2 * n_az);  // d * B + b
      const int d = static_cast<int>(db / B), b = static_cast<int>(db % B);
      float s = 0.0f;
      for (int c = 0; c < cps; ++c)
        s += part[(static_cast<int64_t>(b * cps + c) * depth + d) * ps + 2 * NW + e];
      if (e < n_az) da[db * n_az + e] = from_f<T>(s);
      else dz[db * n_az + e - n_az] = from_f<T>(s);
    }
  }
}

template <typename T>
int launch(const void* xsave, const void* attnsave, const void* dy,
           const void* a, const void* z, const void* w1, const void* w2,
           const void* vecs, void* dx, void* da, void* dz, void* dw1, void* dw2,
           void* dvecs, void* part, int B, int N, int depth, int hl, int l,
           int rows_per_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_floats(hl) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_stack_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cps = (N + rows_per_cta - 1) / rows_per_cta;
  decoder_stack_bwd_rows<T><<<dim3(cps, B), THREADS, smem, s>>>(
      static_cast<const T*>(xsave), static_cast<const T*>(attnsave),
      static_cast<const T*>(dy), static_cast<const T*>(a), static_cast<const T*>(z),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const float*>(vecs), static_cast<T*>(dx),
      static_cast<float*>(part), B, N, depth, hl, l, rows_per_cta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_all = static_cast<int64_t>(depth) * (2 * NW + NV)
                        + static_cast<int64_t>(depth) * B * 2 * DIM * hl;
  const int64_t want = (n_all + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  decoder_stack_bwd_reduce<T><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(da), static_cast<T*>(dz),
      static_cast<float*>(dw1), static_cast<float*>(dw2),
      static_cast<float*>(dvecs), B, cps, depth, hl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DECODER_BWD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* xsave, const void* attnsave, const void* dy,      \
                      const void* a, const void* z, const void* w1, const void* w2, \
                      const void* vecs, void* dx, void* da, void* dz, void* dw1,    \
                      void* dw2, void* dvecs, void* part, int B, int N, int depth,  \
                      int hl, int l, int rows_per_cta, void* stream) {              \
    return launch<T>(xsave, attnsave, dy, a, z, w1, w2, vecs, dx, da, dz, dw1, dw2, \
                     dvecs, part, B, N, depth, hl, l, rows_per_cta, stream);        \
  }

DECODER_BWD_ENTRY(decoder_stack_bwd_f32, float)
DECODER_BWD_ENTRY(decoder_stack_bwd_bf16, __nv_bfloat16)
