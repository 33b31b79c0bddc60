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
// Both instances. The TPU kernel accumulates over a sequential grid; here
// CTAs run in parallel, so each CTA owns a contiguous range of rows of one
// sample and loops over the layers in reverse, staging the layer's weights
// in shared memory, and within a layer over tiles of rows. A row's cotangent
// crosses layers through dx in device memory (every value is a T value, so
// nothing is lost; each thread reads back exactly what it wrote). Each
// tile's per-row factors go to shared memory, then every thread adds its
// fixed share of the weight-side sums over the tile's rows. At the end of a
// layer the CTA's partial sums are in a scratch buffer; a second kernel sums
// the partials in a fixed order (no float atomics, so a rerun gives the same
// bits) and rounds dA and dZ to T per sample, as _layer_bwd does.
//
// Bound on this card: about 10 kFLOP + 320 * hl FLOP per row per layer
// (ten products) against 2 * (32 + hl) bytes of saves per row and layer in
// bf16, so operations bound it (0.30 ms per batch-8 training step at 256 px
// on the fp32 pipe, 0.04 ms by bytes in bf16).
//
// fp32 (decoder_stack_bwd_rows<float>): one warp per row, lane = channel,
// as in the forward, with fp32 copies of A, A^T, Z, Z^T, W1, W1^T and W2^T
// in shared memory and tiles of 32 rows. Every FMA of a row product reads a
// shared-memory operand, so the shared-memory pipe (one 32-lane load a
// cycle) caps the products near 1/8 of the FMA rate.
//
// bf16 (decoder_stack_bwd_rows_mma): the six per-row products (attn.Z,
// g.W1, dy.W2^T, dt.W1^T, dx1.Z^T, dl.A^T) run on the tensor cores as
// mma.sync m16n8k16 with bf16 operands and fp32 accumulation. Every operand
// is a bf16 value at _layer_bwd's rounding points, so each product is exact
// and only the summation order differs; every result is rounded where the
// fp32 instance rounds it. A warp owns 16 rows; a product's fp32
// accumulators, packed to bf16 pairs, are the A fragment of the next
// product, so the chain attn -> ao -> x1 -> g -> t and dy -> dhg -> dt ->
// dg -> dx1 -> dattn -> dl -> dhn -> dx stays in registers. Row reductions
// (LayerNorm statistics and backward means, the softmax group sums) are
// shuffles inside the quad of lanes that holds a row. The weights are staged
// once per layer in bf16 (hl zero-padded to a multiple of 16: whole zero
// heads, whose attn, dattn and dl are zero) and read as B fragments with
// ldmatrix (.trans for the k-major orientation), rows padded to stay free
// of bank conflicts. The four weight-side sums (dW1 += g^T dt, dW2 += hg^T
// dy, dA += hn^T dl, dZ += attn^T dx1) run on the tensor cores too: each
// 16-row tile's factors go to shared memory in bf16 (exact: all are bf16
// values), and the warps take 16 x 16 output blocks in index order, 16 rows
// per k-step, both operands read with ldmatrix.trans.
#include <type_traits>

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

// ---------------------------------------------------------------------------
// bf16: the per-row products on tensor cores.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): a thread's
// accumulators of an n8 tile are rows g and g + 8, columns 2t and 2t + 1.
// A 32-wide row vector of the warp's 16 rows is float v[16], v[4n + 2r + q]
// at row g + 8r, column 8n + 2t + q; a 16-column slice of an hl-wide one is
// float c[8], c[4h + 2r + q] at row g + 8r, column 8h + 2t + q. The A
// fragment of k-step kk is then a[q] = bf16x2(v[8kk + 2q], v[8kk + 2q + 1]).

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_TILE = MMA_WARPS * 16;  // rows per CTA tile
constexpr int WLD = DIM + 8;              // padded row of a staged 32-wide weight

__host__ __device__ __forceinline__ int pad16(int hl) { return (hl + 15) & ~15; }

__host__ __device__ __forceinline__ size_t mma_smem_bytes(int hl) {
  const int hlp = pad16(hl);
  return 2 * (DIM * (hlp + 8)             // A [c][j]
              + hlp * WLD + 2 * DIM * WLD  // Z [j][c], W1 [c][m], W2 [m][c]
              + MMA_TILE * (6 * WLD + 2 * (hlp + 8)))  // tile factors
         + 4 * (NV + MMA_WARPS * NV);     // vectors, per-warp vector sums
}

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D += A . B for two neighbouring n8 tiles (c[0..3] at columns n0, c[4..7]
// at n0 + 8) over the k-step k0..k0+15. B lies in shared memory as bf16
// rows of ldb: k-major ([k][n], read with ldmatrix.trans) or n-major.
template <bool KMAJOR>
__device__ __forceinline__ void mma_pair(float* c, const uint32_t (&a)[4],
                                         const __nv_bfloat16* sb, int ldb,
                                         int k0, int n0, int lane) {
  const __nv_bfloat16* p =
      KMAJOR ? sb + (k0 + (lane & 15)) * ldb + n0 + 8 * (lane >> 4)
             : sb + (n0 + (lane & 7) + 8 * (lane >> 4)) * ldb + k0 + 8 * ((lane >> 3) & 1);
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t b[4];
  if (KMAJOR)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
#pragma unroll
  for (int h = 0; h < 2; ++h)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[4 * h]), "+f"(c[4 * h + 1]), "+f"(c[4 * h + 2]), "+f"(c[4 * h + 3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[2 * h]), "r"(b[2 * h + 1]));
}

// v (16 x 32, fragment layout) += A (16 x 32) . B (32 x 32).
template <bool KMAJOR>
__device__ __forceinline__ void mma_row32(float (&v)[16], const uint32_t (&a)[2][4],
                                          const __nv_bfloat16* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    mma_pair<KMAJOR>(v, a[kk], sb, WLD, 16 * kk, 0, lane);
    mma_pair<KMAJOR>(v + 8, a[kk], sb, WLD, 16 * kk, 16, lane);
  }
}

__device__ __forceinline__ void frag32(uint32_t (&a)[2][4], const float (&v)[16]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = pack2(v[8 * kk + 2 * q], v[8 * kk + 2 * q + 1]);
}

// Per-row mean over 32 columns of v (fragment layout), for rows g and g + 8.
__device__ __forceinline__ void row_means(const float (&v)[16], float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) s += v[4 * n + 2 * r] + v[4 * n + 2 * r + 1];
    m[r] = quad_sum(s) * (1.0f / DIM);
  }
}

// Two-pass LayerNorm statistics (ln_hat): xhat and rs for both rows.
__device__ __forceinline__ void ln_rows(const float (&x)[16], float (&xhat)[16],
                                        float (&rs)[2]) {
  float mu[2], var[2], dv[16];
  row_means(x, mu);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float c = x[i] - mu[(i >> 1) & 1];
    dv[i] = c * c;
  }
  row_means(dv, var);
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = rsqrtf(var[r] + 1e-5f);
#pragma unroll
  for (int i = 0; i < 16; ++i) xhat[i] = (x[i] - mu[(i >> 1) & 1]) * rs[(i >> 1) & 1];
}

// LayerNorm backward, x side (decoder_vjp._ln_bwd): rs (dg s - mean(dg s)
// - xhat mean(dg s xhat)) per element.
__device__ __forceinline__ void ln_bwd_rows(const float (&dgv)[16], const float (&xhat)[16],
                                            const float (&rs)[2], const float* s,
                                            int t, float (&out)[16]) {
  float dxh[16], dxx[16], ma[2], mb[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dxh[i] = dgv[i] * s[8 * (i >> 2) + 2 * t + (i & 1)];
    dxx[i] = dxh[i] * xhat[i];
  }
  row_means(dxh, ma);
  row_means(dxx, mb);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i >> 1) & 1;
    out[i] = rs[r] * (dxh[i] - ma[r] - xhat[i] * mb[r]);
  }
}

// Adds one vector gradient's contribution of the warp's 16 rows: both rows,
// then the 8 row groups (lanes 4 apart), in a fixed order; lane group k
// keeps vector k's 8 columns.
__device__ __forceinline__ void vec_sum(const float (&v)[16], float (&keep)[8], int k,
                                        int g) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = v[4 * n + q] + v[4 * n + 2 + q];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == k) keep[2 * n + q] += s;
    }
}

// Stores a 32-wide vector of the warp's rows to a bf16 tile (rows of WLD).
__device__ __forceinline__ void tile_store(__nv_bfloat16* tile, int row0, int t,
                                           const float (&v)[16]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = p >> 1, r = p & 1;
    *reinterpret_cast<uint32_t*>(tile + (row0 + 8 * r) * WLD + 8 * n + 2 * t) =
        pack2(v[2 * p], v[2 * p + 1]);
  }
}

// Loads a 32-wide bf16 row vector of rows (row0, row0 + 8) into fragment
// layout; a row that is not ok reads zeros.
__device__ __forceinline__ void row_load(const __nv_bfloat16* src, int64_t row0, bool ok0,
                                         bool ok1, int t, float (&v)[16]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = p >> 1, r = p & 1;
    const uint32_t u = (r ? ok1 : ok0)
        ? *reinterpret_cast<const uint32_t*>(src + (row0 + 8 * r) * DIM + 8 * n + 2 * t)
        : 0u;
    v[2 * p] = lo_f(u);
    v[2 * p + 1] = hi_f(u);
  }
}

// One 16 x 16 block (rows m0.., columns n0..) of a weight-side sum over the
// tile's first `ksteps` 16-row steps, out (+)= X^T . Y, with X [r][m] and Y
// [r][n] bf16 tiles: both operands k-major, read with ldmatrix.trans.
// Entries at rows >= m_lim or columns >= n_lim are not written; the block
// is written when `first`, else added.
__device__ __forceinline__ void mma_block(float* out, int ldo, int m_lim, int n_lim,
                                          const __nv_bfloat16* X, int ldx,
                                          const __nv_bfloat16* Y, int ldy, int m0,
                                          int n0, int ksteps, bool first, int lane) {
  float c[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ks = 0; ks < ksteps; ++ks) {
    const __nv_bfloat16* p =
        X + (16 * ks + (lane & 7) + 8 * (lane >> 4)) * ldx + m0 + 8 * ((lane >> 3) & 1);
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    uint32_t a[4];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
    mma_pair<true>(c, a, Y, ldy, 16 * ks, n0, lane);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r, col = n0 + 8 * h + 2 * t;
      if (row < m_lim && col < n_lim) {
        float2* o = reinterpret_cast<float2*>(out + row * ldo + col);
        const float2 prev = first ? make_float2(0.0f, 0.0f) : *o;
        *o = make_float2(prev.x + c[4 * h + 2 * r], prev.y + c[4 * h + 2 * r + 1]);
      }
    }
}

// Operands as decoder_stack_bwd_rows with T = bf16; l, the tokens per head,
// is 1, 2, 4 or 8 and hl is even.
__global__ void __launch_bounds__(MMA_THREADS)
decoder_stack_bwd_rows_mma(const __nv_bfloat16* __restrict__ xsave,
                           const __nv_bfloat16* __restrict__ attnsave,
                           const __nv_bfloat16* __restrict__ dy_in,
                           const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ z,
                           const __nv_bfloat16* __restrict__ w1,
                           const __nv_bfloat16* __restrict__ w2,
                           const float* __restrict__ vecs, __nv_bfloat16* dx,
                           float* __restrict__ part, int B, int N, int depth, int hl,
                           int l, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hlp = pad16(hl);
  const int ald = hlp + 8;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [c][j]
  __nv_bfloat16* sZ = sA + DIM * ald;                               // [j][c]
  __nv_bfloat16* sW1 = sZ + hlp * WLD;                              // [c][m]
  __nv_bfloat16* sW2 = sW1 + DIM * WLD;                             // [m][c]
  __nv_bfloat16* tHg = sW2 + DIM * WLD;  // MMA_TILE rows of WLD each
  __nv_bfloat16* tDy = tHg + MMA_TILE * WLD;
  __nv_bfloat16* tG = tDy + MMA_TILE * WLD;
  __nv_bfloat16* tDt = tG + MMA_TILE * WLD;
  __nv_bfloat16* tHn = tDt + MMA_TILE * WLD;
  __nv_bfloat16* tDx1 = tHn + MMA_TILE * WLD;
  __nv_bfloat16* tAttn = tDx1 + MMA_TILE * WLD;  // MMA_TILE rows of ald
  __nv_bfloat16* tDl = tAttn + MMA_TILE * ald;   // MMA_TILE rows of ald
  float* sV = reinterpret_cast<float*>(tDl + MMA_TILE * ald);
  float* sRed = sV + NV;  // MMA_WARPS x 7 x 32

  const int b = blockIdx.y;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int r_begin = blockIdx.x * rows_per_cta;
  const int r_end = min(N, r_begin + rows_per_cta);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_az = DIM * hl;
  const int64_t ps = part_size(hl);

  for (int d = depth - 1; d >= 0; --d) {
    __syncthreads();  // every thread is done with layer d+1's shared data
    const int64_t az_off = (static_cast<int64_t>(d) * B + b) * n_az;
    for (int i = tid; i < DIM * hlp; i += MMA_THREADS) {
      const int c = i / hlp, j = i - c * hlp;  // A[c][j], zero past hl
      sA[c * ald + j] = j < hl ? a[az_off + c * hl + j] : __float2bfloat16(0.0f);
      const int jz = i >> 5, cz = i & (DIM - 1);  // Z[j][c], zero rows past hl
      sZ[jz * WLD + cz] = jz < hl ? z[az_off + i] : __float2bfloat16(0.0f);
    }
    for (int i = tid; i < NW; i += MMA_THREADS) {
      sW1[(i >> 5) * WLD + (i & (DIM - 1))] = w1[d * NW + i];
      sW2[(i >> 5) * WLD + (i & (DIM - 1))] = w2[d * NW + i];
    }
    for (int i = tid; i < NV; i += MMA_THREADS) {
      const int k = i / DIM;
      const float v = vecs[d * NV + i];
      sV[i] = (k == 2 || k == 5 || k == 6) ? rnd<__nv_bfloat16>(v) : v;
    }
    float keep[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) keep[i] = 0.0f;
    __syncthreads();

    for (int t0 = r_begin; t0 < r_end; t0 += MMA_TILE) {
      const int wrow = t0 + warp * 16;  // the warp's first row
      const int lrow = warp * 16 + g;   // this thread's first row in the tile
      if (wrow < r_end) {               // warp-uniform
        const bool ok0 = wrow + g < r_end, ok1 = wrow + g + 8 < r_end;
        const int64_t srow = (static_cast<int64_t>(d) * B + b) * N + wrow + g;
        const int64_t xrow = static_cast<int64_t>(b) * N + wrow + g;
        float x[16], xhat[16], rs[2], v[16], acc[16];
        uint32_t fr[2][4];

        // ---- recompute the forward (decoder_fwd.cu decoder_layer) ----
        row_load(xsave, srow, ok0, ok1, t, x);
        ln_rows(x, xhat, rs);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          v[i] = rnd<__nv_bfloat16>(xhat[i] * sV[ch] + sV[DIM + ch]);  // hn
          acc[i] = 0.0f;
        }
        tile_store(tHn, lrow, t, v);
        for (int kk = 0; kk < hlp / 16; ++kk) {  // ao = attn . Z
          uint32_t at[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q & 1, col = 16 * kk + 8 * (q >> 1) + 2 * t;
            at[q] = ((r ? ok1 : ok0) && col < hl)
                ? *reinterpret_cast<const uint32_t*>(attnsave + (srow + 8 * r) * hl + col)
                : 0u;
            *reinterpret_cast<uint32_t*>(tAttn + (lrow + 8 * r) * ald + col) = at[q];
          }
          mma_pair<true>(acc, at, sZ, WLD, 16 * kk, 0, lane);
          mma_pair<true>(acc + 8, at, sZ, WLD, 16 * kk, 16, lane);
        }
        float xhat1[16], rs1[2], tt[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          v[i] = rnd<__nv_bfloat16>(
              rnd<__nv_bfloat16>(x[i] + rnd<__nv_bfloat16>(acc[i])) + sV[2 * DIM + ch]);
        }
        ln_rows(v, xhat1, rs1);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          v[i] = rnd<__nv_bfloat16>(xhat1[i] * sV[3 * DIM + ch] + sV[4 * DIM + ch]);  // g
          tt[i] = 0.0f;
        }
        tile_store(tG, lrow, t, v);
        frag32(fr, v);
        mma_row32<true>(tt, fr, sW1, lane);  // g . W1
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          tt[i] = rnd<__nv_bfloat16>(rnd<__nv_bfloat16>(tt[i]) + sV[5 * DIM + ch]);
          v[i] = rnd<__nv_bfloat16>(gelu(tt[i]));  // hg
        }
        tile_store(tHg, lrow, t, v);

        // ---- feed-forward backward ----
        float dyv[16];
        row_load(d == depth - 1 ? dy_in : dx, xrow, ok0, ok1, t, dyv);
        tile_store(tDy, lrow, t, dyv);
        vec_sum(dyv, keep, 6, g);
        frag32(fr, dyv);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
        mma_row32<false>(acc, fr, sW2, lane);  // dy . W2^T
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          acc[i] = rnd<__nv_bfloat16>(acc[i]) * gelu_grad(tt[i]);  // dt32
          v[i] = rnd<__nv_bfloat16>(acc[i]);                         // dt
        }
        vec_sum(acc, keep, 5, g);
        tile_store(tDt, lrow, t, v);
        frag32(fr, v);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
        mma_row32<false>(acc, fr, sW1, lane);  // dt . W1^T
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = rnd<__nv_bfloat16>(acc[i]);  // dg
        vec_sum(acc, keep, 4, g);
        ln_bwd_rows(acc, xhat1, rs1, sV + 3 * DIM, t, v);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float p = acc[i] * xhat1[i];
          acc[i] = p;
          v[i] = rnd<__nv_bfloat16>(dyv[i] + rnd<__nv_bfloat16>(v[i]));  // dx1
        }
        vec_sum(acc, keep, 3, g);
        vec_sum(v, keep, 2, g);
        tile_store(tDx1, lrow, t, v);
        frag32(fr, v);

        // ---- attention backward, 16 columns of hl at a time ----
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;  // dhn
        for (int jj = 0; jj < hlp / 16; ++jj) {
          float dat[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          mma_pair<false>(dat, fr[0], sZ, WLD, 0, 16 * jj, lane);  // dx1 . Z^T
          mma_pair<false>(dat, fr[1], sZ, WLD, 16, 16 * jj, lane);
          float at[8], s[8];
          uint32_t dl[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int off = (lrow + 8 * (q & 1)) * ald + 16 * jj + 8 * (q >> 1) + 2 * t;
            const uint32_t u = *reinterpret_cast<const uint32_t*>(tAttn + off);
            at[2 * q] = lo_f(u);
            at[2 * q + 1] = hi_f(u);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dat[i] = rnd<__nv_bfloat16>(dat[i]);
            s[i] = at[i] * dat[i];
          }
          // segsum_l over groups of l consecutive columns: the pair a thread
          // holds, then lanes 1 and 2 apart.
          if (l >= 2) {
#pragma unroll
            for (int q = 0; q < 4; ++q) s[2 * q] = s[2 * q + 1] = s[2 * q] + s[2 * q + 1];
          }
          if (l >= 4) {
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
          }
          if (l >= 8) {
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dl[q] = pack2(rnd<__nv_bfloat16>(at[2 * q] * (dat[2 * q] - s[2 * q]) * SCALE),
                          rnd<__nv_bfloat16>(at[2 * q + 1] * (dat[2 * q + 1] - s[2 * q + 1])
                                             * SCALE));
            const int off = (lrow + 8 * (q & 1)) * ald + 16 * jj + 8 * (q >> 1) + 2 * t;
            *reinterpret_cast<uint32_t*>(tDl + off) = dl[q];
          }
          mma_pair<false>(acc, dl, sA, ald, 16 * jj, 0, lane);  // dl . A^T
          mma_pair<false>(acc + 8, dl, sA, ald, 16 * jj, 16, lane);
        }
        float dxv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = rnd<__nv_bfloat16>(acc[i]);  // dhn
        vec_sum(acc, keep, 1, g);
        ln_bwd_rows(acc, xhat, rs, sV, t, dxv);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          dxv[i] = rnd<__nv_bfloat16>(v[i] + rnd<__nv_bfloat16>(dxv[i]));
          acc[i] *= xhat[i];
        }
        vec_sum(acc, keep, 0, g);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int n = p >> 1, r = p & 1;
          if (r ? ok1 : ok0)
            *reinterpret_cast<uint32_t*>(dx + (xrow + 8 * r) * DIM + 8 * n + 2 * t) =
                pack2(dxv[2 * p], dxv[2 * p + 1]);
        }
      }
      __syncthreads();

      // Weight-side sums over the tile's rows on tensor cores: 16 x 16
      // blocks of dW1 += g^T dt, dW2 += hg^T dy, dA += hn^T dl and
      // dZ += attn^T dx1, dealt to the warps in index order.
      {
        const int ksteps = (min(MMA_TILE, r_end - t0) + 15) >> 4;
        const bool first = t0 == r_begin;
        float* out = part + (static_cast<int64_t>(cta) * depth + d) * ps;
        const int nb = hlp >> 4;  // 16-column blocks of hl
        for (int job = warp; job < 8 + 4 * nb; job += MMA_WARPS) {
          if (job < 8) {  // dW1 [c][m], dW2 [m][c]
            const int w = job >> 2, m0 = 16 * ((job >> 1) & 1), n0 = 16 * (job & 1);
            mma_block(out + w * NW, DIM, DIM, DIM, w ? tHg : tG, WLD, w ? tDy : tDt,
                      WLD, m0, n0, ksteps, first, lane);
          } else if (job < 8 + 2 * nb) {  // dA [c][j]
            const int k = job - 8;
            mma_block(out + 2 * NW, hl, DIM, hl, tHn, WLD, tDl, ald, 16 * (k & 1),
                      16 * (k >> 1), ksteps, first, lane);
          } else {  // dZ [j][c]
            const int k = job - 8 - 2 * nb;
            mma_block(out + 2 * NW + n_az, DIM, hl, DIM, tAttn, ald, tDx1, WLD,
                      16 * (k >> 1), 16 * (k & 1), ksteps, first, lane);
          }
        }
      }
      __syncthreads();
    }

    float* out = part + (static_cast<int64_t>(cta) * depth + d) * ps;
    if (g < 7) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sRed[(warp * 7 + g) * DIM + 8 * (i >> 1) + 2 * t + (i & 1)] = keep[i];
    }
    __syncthreads();
    for (int i = tid; i < NV; i += MMA_THREADS) {
      float s = 0.0f;
      for (int w = 0; w < MMA_WARPS; ++w) s += sRed[w * NV + i];
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
using RowsKernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*,
                            const T*, const float*, T*, float*, int, int, int, int, int,
                            int);

// The row kernel of each instance: fp32 on the FMA pipe, bf16 on tensor cores.
RowsKernel<float> rows_kernel(const float*) { return decoder_stack_bwd_rows<float>; }
RowsKernel<__nv_bfloat16> rows_kernel(const __nv_bfloat16*) { return decoder_stack_bwd_rows_mma; }

template <typename T>
int launch(const void* xsave, const void* attnsave, const void* dy,
           const void* a, const void* z, const void* w1, const void* w2,
           const void* vecs, void* dx, void* da, void* dz, void* dw1, void* dw2,
           void* dvecs, void* part, int B, int N, int depth, int hl, int l,
           int rows_per_cta, void* stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowsKernel<T> kernel = rows_kernel(static_cast<const T*>(nullptr));
  const size_t smem = kMma ? mma_smem_bytes(hl) : smem_floats(hl) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cps = (N + rows_per_cta - 1) / rows_per_cta;
  kernel<<<dim3(cps, B), kMma ? MMA_THREADS : THREADS, smem, s>>>(
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

// CTAs of the bf16 row kernel that one SM holds at once for this hl (its
// registers and shared memory decide), written to *out: the wrapper sizes
// the grid to one full wave.
extern "C" int decoder_stack_bwd_ctas_per_sm_bf16(int hl, int* out) {
  const size_t smem = mma_smem_bytes(hl);
  cudaError_t err = cudaFuncSetAttribute(decoder_stack_bwd_rows_mma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, decoder_stack_bwd_rows_mma, MMA_THREADS, smem));
}

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
