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
//   x    = (x + mm(attn, Z)) + bo
//   x    = (x + mm(gelu_as(mm(LN2(x), W1) + b1), W2)) + b2
//
// mm(a, b) rounds its operands to OP (bf16, or fp32 when PRECISE) and
// accumulates in fp32 (`_make_mm`); nothing else is rounded. LayerNorm is
// two-pass fp32 and GELU uses the Abramowitz-Stegun 7.1.26 erf (`_erf`), as
// in the TPU kernel. x comes in and goes out in the storage type T.
//
// Bound on this card: operations. Per row and layer the four products take
// ~8 kFLOP at hl = 32 and the elementwise work (two LayerNorms, the
// max-shifted exp and the divide, the erf) ~1.5 k more, against 256 bytes
// per row for the whole stack in fp32 I/O. The memory side is ~0.4 MFLOP
// per sample and layer at the 1/4 scale, under 1 % of the rows' work.
//
// Design: two kernels on one stream, A and Z passing through a scratch
// buffer in fp32.
//
// The prologue, grid (depth, heads, ceil(B / PRO_SAMPLES)), builds one
// head's columns of A and rows of Z for PRO_SAMPLES samples of one layer. It
// stages that head's slices of Wq, Wk, Wv (32 x dim_head) and Wo
// (dim_head x 32) in shared memory, with 16-byte loads, rounded to OP; then
// takes the samples' memory tokens PRO_ROWS at a time: LN1, k_h and v_h
// (rounded to OP), and A's columns and Z's rows (fp32, unrounded; the row
// kernel rounds them as operands). Each weight is read ceil(B / PRO_SAMPLES)
// times a call, from L2, and no shared-memory size grows with B or N. Its
// work is a few microseconds of plain FMA.
//
// The row kernel is K1's (csrc/decoder_fwd.cu, `layer_rows`) with K4's
// numerics. A warp owns 16 rows, whose fp32 residual stays in registers in
// the fragment layout of decoder_mma.cuh across all layers, so x is read
// once and y written once. The four per-row products (hn.A, attn.Z, g.W1,
// h.W2) run on the tensor cores as mma.sync m16n8k16 with fp32
// accumulation: with bf16 operands one bf16 piece each, which is exactly
// `_make_mm`'s operand rounding; when PRECISE each fp32 operand split
// exactly into three bf16 pieces (hi, mid, lo) and a product taken as the
// six piece products down to 2^-16 (mma_split). The pieces follow PRECISE,
// not T. dots come 16 columns of hl at a time; each row's group maximum and
// then group sum over l consecutive columns (the pair a thread holds, the
// quad's shuffles 1 and 2 lanes apart, and for l = 16 the thread's two
// 8-column halves) stay inside the quad of lanes that holds the row; each
// normalised 16-column slice is at once a k-step of attn.Z. A, Z, W1 and W2
// are staged once per layer and CTA as P bf16 planes, hl zero-padded to a
// multiple of 16: whole zero heads (l divides 16), whose logits are 0, so
// their attention is 1 / l inside their own group and meets zero rows of Z.
// Grid (row tiles of TILE rows, B), 8 warps, as K1's.
//
// Other token counts run in the row kernel's PAD instances. The wrapper
// (kernels/fused_decoder.py) pads the lr memory tokens with zero tokens to
// l: the next of 1, 2, 4, 8 and 16, or above 16 the next multiple of 16, so
// a group is part of one 16-column slice or whole slices. The prologue runs
// on the l tokens as on any others, and the PAD instance sets the logits of
// the columns j with j % l >= lr to -inf, so they drop out of the group's
// max and sum and their attention is 0. A group of more than 16 columns
// spans l / 16 slices: its max and then its sum come from passes of their
// own over its slices (the products hn . A recomputed each time), then the
// normalised slices go into attn . Z. For l <= 16 this gives the one-pass
// instance's bits. Padded this way hl can reach 2 * 128 - 2; the shared
// memory grows with it (the wrapper checks it).
//
// The hidden width MLP is a template parameter of the row kernel: 32, or 64
// (BIT's decoder), whose b1 (D, 64) comes as an fp32 argument of its own.
// The 64 instance runs the hidden layer in two 32-column halves c, h_c =
// gelu_as(mm(LN2(x), W1[:, c]) + b1[c]), and accumulates mm(h_c, W2[c, :])
// into the one fp32 sum of mm(h, W2), as K1's 64 instance does. The
// prologue does not depend on MLP.
#include "decoder_mma.cuh"

namespace {

using namespace decoder;

constexpr int NV = 7 * DIM;  // the seven vectors
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = WARPS * 16;  // rows per CTA
constexpr int PRO_THREADS = 256;
constexpr int PRO_SAMPLES = 4;  // samples per prologue CTA
constexpr int PRO_ROWS = 16;    // memory tokens per prologue pass
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

// ---------------------------------------------------------------- prologue

// Floats of the prologue's shared memory: Wq_h^T (rows of DIM + 1), Wk_h,
// Wv_h, Wo_h; LN1(m), k_h and v_h of PRO_ROWS tokens.
__host__ __device__ __forceinline__ int pro_smem_floats(int hd) {
  return hd * (DIM + 1) + 3 * DIM * hd + PRO_ROWS * (DIM + 2 * hd);
}

// Calls f(r, c, v) for every element of the rows x cols fp32 slice at src
// (rows ld floats apart), the CTA's threads on neighbouring elements, with
// 16-byte loads where cols, ld and src's alignment allow them.
template <typename F>
__device__ __forceinline__ void load_slice(const float* src, int rows, int cols, int ld,
                                           F f) {
  if (((cols | ld) & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int r = i / c4, c = 4 * (i - r * c4);
      const float4 v = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r) * ld + c);
      f(r, c, v.x);
      f(r, c + 1, v.y);
      f(r, c + 2, v.z);
      f(r, c + 3, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      f(r, c, src[static_cast<int64_t>(r) * ld + c]);
    }
  }
}

// m: (B, L, 32) fp32; wq, wk, wv: (D, 32, inner); wo: (D, inner, 32);
// vecs: (D, 7, 32). Writes head h's columns of a: (D, B, 32, hl) and rows
// of z: (D, B, hl, 32) for layer d and samples b0 .. b0 + PRO_SAMPLES - 1.
template <bool PRECISE>
__global__ void __launch_bounds__(PRO_THREADS)
fused_decoder_prologue(const float* __restrict__ m, const float* __restrict__ wq,
                       const float* __restrict__ wk, const float* __restrict__ wv,
                       const float* __restrict__ wo, const float* __restrict__ vecs,
                       float* __restrict__ a, float* __restrict__ z, int B, int L,
                       int heads, int inner) {
  extern __shared__ float smem[];
  const int d = blockIdx.x, h = blockIdx.y, b0 = blockIdx.z * PRO_SAMPLES;
  const int hd = inner / heads, hl = heads * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* sQ = smem;                  // Wq_h^T [e][c], rows of DIM + 1
  float* sK = sQ + hd * (DIM + 1);   // Wk_h [c][e]
  float* sV = sK + DIM * hd;         // Wv_h [c][e]
  float* sO = sV + DIM * hd;         // Wo_h [e][c]
  float* sMn = sO + hd * DIM;        // LN1(m) [r][c]
  float* sk = sMn + PRO_ROWS * DIM;  // k_h [r][e]
  float* sv = sk + PRO_ROWS * hd;    // v_h [r][e]

  const int64_t w_off = static_cast<int64_t>(d) * DIM * inner + h * hd;
  load_slice(wq + w_off, DIM, hd, inner,
             [&](int c, int e, float w) { sQ[e * (DIM + 1) + c] = op<PRECISE>(w); });
  load_slice(wk + w_off, DIM, hd, inner,
             [&](int c, int e, float w) { sK[c * hd + e] = op<PRECISE>(w); });
  load_slice(wv + w_off, DIM, hd, inner,
             [&](int c, int e, float w) { sV[c * hd + e] = op<PRECISE>(w); });
  load_slice(wo + (static_cast<int64_t>(d) * inner + h * hd) * DIM, hd, DIM, DIM,
             [&](int e, int c, float w) { sO[e * DIM + c] = op<PRECISE>(w); });
  const float ln_s = vecs[d * NV + lane], ln_b = vecs[d * NV + DIM + lane];

  // The CTA's (sample, token) rows, PRO_ROWS a pass.
  const int rows = min(PRO_SAMPLES, B - b0) * L;
  for (int r0 = 0; r0 < rows; r0 += PRO_ROWS) {
    const int nr = min(PRO_ROWS, rows - r0);
    __syncthreads();  // the weights are staged; the last pass is done
    for (int r = warp; r < nr; r += PRO_THREADS / 32) {
      const float x = m[(static_cast<int64_t>(b0) * L + r0 + r) * DIM + lane];
      sMn[r * DIM + lane] = op<PRECISE>(layer_norm(x, ln_s, ln_b));
    }
    __syncthreads();
    for (int i = tid; i < nr * hd; i += PRO_THREADS) {
      const int r = i / hd, e = i - r * hd;
      float ak = 0.0f, av = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DIM; ++c) {
        const float mv = sMn[r * DIM + c];
        ak = fmaf(mv, sK[c * hd + e], ak);
        av = fmaf(mv, sV[c * hd + e], av);
      }
      sk[i] = op<PRECISE>(ak);
      sv[i] = op<PRECISE>(av);
    }
    __syncthreads();
    // A[c][h L + j] = sum_e Wq[c][h hd + e] k[j][h hd + e] and
    // Z[h L + j][c] = sum_e v[j][h hd + e] Wo[h hd + e][c]; lane = c.
    for (int i = tid; i < nr * DIM; i += PRO_THREADS) {
      const int r = i / DIM, c = i & (DIM - 1);
      const int s = (r0 + r) / L, j = r0 + r - s * L;
      float acc_a = 0.0f, acc_z = 0.0f;
      for (int e = 0; e < hd; ++e) {
        acc_a = fmaf(sQ[e * (DIM + 1) + c], sk[r * hd + e], acc_a);
        acc_z = fmaf(sv[r * hd + e], sO[e * DIM + c], acc_z);
      }
      const int64_t az_off = (static_cast<int64_t>(d) * B + b0 + s) * DIM * hl;
      a[az_off + c * hl + h * L + j] = acc_a;
      z[az_off + (h * L + j) * DIM + c] = acc_z;
    }
  }
}

// -------------------------------------------------------------- row kernel

// The logits of 16-column slice jj, dots = hn . A * dim**-0.5, with -inf
// at the columns j of a padded token (j % l >= lr).
template <int P>
__device__ __forceinline__ void padded_dots(float (&e)[8], const uint32_t (&fr)[2][P][4],
                                            const __nv_bfloat16* sA, int plane, int hlp,
                                            int jj, int l, int lr, int t, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = 0.0f;
  mma_pair<true, P>(e, fr[0], sA, plane, hlp + 8, 0, 16 * jj, lane);
  mma_pair<true, P>(e, fr[1], sA, plane, hlp + 8, 16, 16 * jj, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = slice_col(jj, i, t) % l < lr ? e[i] * SCALE : __int_as_float(0xff800000);
}

// One layer for the warp's 16 rows, v (fragment layout) in and out. b1
// lies in sV's row 5 for MLP = 32 and at sV + NV otherwise. PAD: groups of
// l columns (up to 16, or a multiple of 16), of which the first lr are
// tokens.
template <int P, int MLP, bool PAD>
__device__ __forceinline__ void fused_layer_rows(float (&v)[16], const __nv_bfloat16* sA,
                                                 const __nv_bfloat16* sZ,
                                                 const __nv_bfloat16* sW1,
                                                 const __nv_bfloat16* sW2, const float* sV,
                                                 int plane, int hl, int l, int lr, int lane) {
  const int t = lane & 3;
  const int hlp = pad16(hl);
  float xhat[16], rs[2], u[16], acc[16];
  uint32_t fr[2][P][4];

  // ---- attention: dots = hn . A and attn . Z, 16 columns of hl at a time ----
  ln_rows(v, xhat, rs);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    u[i] = xhat[i] * sV[ch] + sV[DIM + ch];  // hn
    acc[i] = 0.0f;
  }
  frag32<P>(fr, u);
  if constexpr (PAD) {
    const int spg = l > 16 ? l / 16 : 1;  // slices per group
    const int lg = l > 16 ? 16 : l;       // a group's columns in one slice
    for (int j0 = 0; j0 < hlp / 16; j0 += spg) {
      float e[8], mx[8], s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx[i] = __int_as_float(0xff800000);
        s[i] = 0.0f;
      }
      for (int k = 0; k < spg; ++k) {  // the group max
        padded_dots<P>(e, fr, sA, plane, hlp, j0 + k, l, lr, t, lane);
        group_reduce<true>(e, lg);
#pragma unroll
        for (int i = 0; i < 8; ++i) mx[i] = fmaxf(mx[i], e[i]);
      }
      for (int k = 0; k < spg; ++k) {  // the group sum
        padded_dots<P>(e, fr, sA, plane, hlp, j0 + k, l, lr, t, lane);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = expf(e[i] - mx[i]);
        group_reduce<false>(e, lg);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += e[i];
      }
      for (int k = 0; k < spg; ++k) {  // attn . Z
        padded_dots<P>(e, fr, sA, plane, hlp, j0 + k, l, lr, t, lane);
        uint32_t at[P][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_pair<P>(expf(e[2 * q] - mx[2 * q]) / s[2 * q],
                        expf(e[2 * q + 1] - mx[2 * q + 1]) / s[2 * q + 1], at, q);
        mma_pair<true, P>(acc, at, sZ, plane, WLD, 16 * (j0 + k), 0, lane);
        mma_pair<true, P>(acc + 8, at, sZ, plane, WLD, 16 * (j0 + k), 16, lane);
      }
    }
  } else {
    for (int jj = 0; jj < hlp / 16; ++jj) {
      float e[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, mx[8], s[8];
      mma_pair<true, P>(e, fr[0], sA, plane, hlp + 8, 0, 16 * jj, lane);
      mma_pair<true, P>(e, fr[1], sA, plane, hlp + 8, 16, 16 * jj, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i] = e[i] = e[i] * SCALE;  // dots
      group_reduce<true>(mx, l);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = e[i] = expf(e[i] - mx[i]);
      group_reduce<false>(s, l);
      uint32_t at[P][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_pair<P>(e[2 * q] / s[2 * q], e[2 * q + 1] / s[2 * q + 1], at, q);
      mma_pair<true, P>(acc, at, sZ, plane, WLD, 16 * jj, 0, lane);  // ao = attn . Z
      mma_pair<true, P>(acc + 8, at, sZ, plane, WLD, 16 * jj, 16, lane);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    v[i] = (v[i] + acc[i]) + sV[2 * DIM + ch];  // x1
  }

  // ---- feed-forward ----
  ln_rows(v, xhat, rs);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    u[i] = xhat[i] * sV[3 * DIM + ch] + sV[4 * DIM + ch];  // g
    acc[i] = 0.0f;
  }
  frag32<P>(fr, u);
  if constexpr (MLP == DIM) {
    mma_row32<true, P>(acc, fr, sW1, plane, lane);  // g . W1
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
      u[i] = gelu_as(acc[i] + sV[5 * DIM + ch]);  // h
      acc[i] = 0.0f;
    }
    frag32<P>(fr, u);
    mma_row32<true, P>(acc, fr, sW2, plane, lane);  // h . W2
  } else {
#pragma unroll
    for (int c = 0; c < MLP / DIM; ++c) {
      float hc[16];
      uint32_t fh[2][P][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) hc[i] = 0.0f;
      mma_row32<true, P>(hc, fr, sW1 + DIM * c, plane, lane, MLP + 8);  // g . W1[:, c]
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ch = DIM * c + 8 * (i >> 2) + 2 * t + (i & 1);
        hc[i] = gelu_as(hc[i] + sV[NV + ch]);  // h_c
      }
      frag32<P>(fh, hc);
      mma_row32<true, P>(acc, fh, sW2 + DIM * c * WLD, plane, lane);  // h_c . W2[c, :]
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    v[i] = (v[i] + acc[i]) + sV[6 * DIM + ch];  // x2
  }
}

template <bool PRECISE>
__host__ __device__ constexpr int op_pieces() {
  return PRECISE ? 3 : 1;
}

template <bool PRECISE, int MLP>
__host__ __device__ __forceinline__ size_t rows_smem_bytes(int hl) {
  return 2 * op_pieces<PRECISE>() * plane_size(hl, MLP) + 4 * (NV + b1_floats<MLP>());  // planes, vectors
}

// x, y: (B, N, 32) in T; a: (D, B, 32, hl) and z: (D, B, hl, 32), the
// prologue's fp32 output; w1: (D, 32, MLP) and w2: (D, MLP, 32) fp32 laid
// out (in, out); vecs: (D, 7, 32) fp32 rows [ln1_scale, ln1_bias, bo,
// ln2_scale, ln2_bias, b1, b2]; where MLP != 32, b1: (D, MLP) fp32 and vecs'
// row 5 unused. l, the tokens per head, is 1, 2, 4, 8 or 16 (PAD: or a
// multiple of 16, lr <= l of them tokens). Grid (row tiles of TILE, B).
template <typename T, bool PRECISE, int MLP, bool PAD>
__global__ void __launch_bounds__(THREADS)
fused_decoder_rows_mma(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ z, const float* __restrict__ w1,
                       const float* __restrict__ w2, const float* __restrict__ vecs,
                       T* __restrict__ y, int B, int N, int depth, int hl, int l,
                       const float* __restrict__ b1, int lr) {
  constexpr int P = op_pieces<PRECISE>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hlp = pad16(hl);
  const int ald = hlp + 8;
  const int plane = plane_size(hl, MLP);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [c][j]
  __nv_bfloat16* sZ = sA + DIM * ald;                               // [j][c]
  __nv_bfloat16* sW1 = sZ + hlp * WLD;                              // [c][m]
  __nv_bfloat16* sW2 = sW1 + DIM * (MLP + 8);                       // [m][c]
  float* sV = reinterpret_cast<float*>(sA + P * plane);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = blockIdx.x * TILE + warp * 16;  // the warp's first row
  const bool active = wrow < N;                    // warp-uniform
  const bool ok0 = wrow + g < N, ok1 = wrow + g + 8 < N;
  const int64_t xrow = static_cast<int64_t>(b) * N + wrow + g;
  const int n_az = DIM * hl;

  float v[16];
  row_load(x, xrow, ok0, ok1, t, v);
  for (int d = 0; d < depth; ++d) {
    __syncthreads();  // every warp is done with layer d-1's weights
    const int64_t az_off = (static_cast<int64_t>(d) * B + b) * n_az;
    for (int i = tid; i < DIM * hlp; i += THREADS) {
      const int c = i / hlp, j = i - c * hlp;  // A[c][j], zero past hl
      stage<P>(sA + c * ald + j, plane, j < hl ? a[az_off + c * hl + j] : 0.0f);
      const int jz = i >> 5, cz = i & (DIM - 1);  // Z[j][c], zero rows past hl
      stage<P>(sZ + jz * WLD + cz, plane, jz < hl ? z[az_off + i] : 0.0f);
    }
    for (int i = tid; i < DIM * MLP; i += THREADS) {
      stage<P>(sW1 + (i >> mlp_shift<MLP>()) * (MLP + 8) + (i & (MLP - 1)), plane,
               w1[d * DIM * MLP + i]);
      stage<P>(sW2 + (i >> 5) * WLD + (i & (DIM - 1)), plane, w2[d * DIM * MLP + i]);
    }
    for (int i = tid; i < NV; i += THREADS) sV[i] = vecs[d * NV + i];
    if constexpr (MLP != DIM) {
      for (int i = tid; i < MLP; i += THREADS) sV[NV + i] = b1[d * MLP + i];
    }
    __syncthreads();
    if (active) fused_layer_rows<P, MLP, PAD>(v, sA, sZ, sW1, sW2, sV, plane, hl, l, lr, lane);
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = p >> 1, r = p & 1;
    if (r ? ok1 : ok0)
      st_pair(y + (xrow + 8 * r) * DIM + 8 * n + 2 * t, v[2 * p], v[2 * p + 1]);
  }
}

// ------------------------------------------------------------------ launch

template <bool PRECISE>
int launch_prologue(const void* m, const void* wq, const void* wk, const void* wv,
                    const void* wo, const void* vecs, void* a, void* z, int B, int depth,
                    int L, int heads, int inner, void* stream) {
  const int smem = 4 * pro_smem_floats(inner / heads);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_decoder_prologue<PRECISE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(depth, heads, (B + PRO_SAMPLES - 1) / PRO_SAMPLES);
  fused_decoder_prologue<PRECISE>
      <<<grid, PRO_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(m), static_cast<const float*>(wq),
          static_cast<const float*>(wk), static_cast<const float*>(wv),
          static_cast<const float*>(wo), static_cast<const float*>(vecs),
          static_cast<float*>(a), static_cast<float*>(z), B, L, heads, inner);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PRECISE, int MLP, bool PAD>
cudaError_t set_rows_smem(int hl) {
  return cudaFuncSetAttribute(fused_decoder_rows_mma<T, PRECISE, MLP, PAD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(rows_smem_bytes<PRECISE, MLP>(hl)));
}

template <typename T, bool PRECISE, int MLP, bool PAD>
int launch_rows(const void* x, const void* a, const void* z, const void* w1,
                const void* w2, const void* vecs, const void* b1, void* y, int B, int N,
                int depth, int hl, int l, int lr, void* stream) {
  const cudaError_t err = set_rows_smem<T, PRECISE, MLP, PAD>(hl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, B);
  fused_decoder_rows_mma<T, PRECISE, MLP, PAD>
      <<<grid, THREADS, rows_smem_bytes<PRECISE, MLP>(hl),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(a),
          static_cast<const float*>(z), static_cast<const float*>(w1),
          static_cast<const float*>(w2), static_cast<const float*>(vecs),
          static_cast<T*>(y), B, N, depth, hl, l, static_cast<const float*>(b1), lr);
  return static_cast<int>(cudaGetLastError());
}

// The PAD instance where lr < l tokens are real or l > 16.
template <typename T, bool PRECISE, int MLP>
int launch_group(const void* x, const void* a, const void* z, const void* w1,
                 const void* w2, const void* vecs, const void* b1, void* y, int B, int N,
                 int depth, int hl, int l, int lr, void* stream) {
  if (lr < l || l > 16)
    return launch_rows<T, PRECISE, MLP, true>(x, a, z, w1, w2, vecs, b1, y, B, N, depth, hl,
                                              l, lr, stream);
  return launch_rows<T, PRECISE, MLP, false>(x, a, z, w1, w2, vecs, b1, y, B, N, depth, hl,
                                             l, lr, stream);
}

// CTAs of the row kernel that one SM holds at once for this hl (its
// registers and shared memory decide), written to *out.
template <typename T, bool PRECISE, int MLP, bool PAD>
int ctas_per_sm(int hl, int* out) {
  const cudaError_t err = set_rows_smem<T, PRECISE, MLP, PAD>(hl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fused_decoder_rows_mma<T, PRECISE, MLP, PAD>, THREADS,
      rows_smem_bytes<PRECISE, MLP>(hl)));
}

template <typename T, bool PRECISE, int MLP>
int ctas_per_sm_group(int hl, int pad, int* out) {
  return pad ? ctas_per_sm<T, PRECISE, MLP, true>(hl, out)
             : ctas_per_sm<T, PRECISE, MLP, false>(hl, out);
}

}  // namespace

#define FUSED_DECODER_AZ_ENTRY(SUFFIX, PRECISE)                                         \
  extern "C" int fused_decoder_az_##SUFFIX(                                             \
      const void* m, const void* wq, const void* wk, const void* wv, const void* wo,    \
      const void* vecs, void* a, void* z, int B, int depth, int L, int heads, int inner, \
      void* stream) {                                                                   \
    return launch_prologue<PRECISE>(m, wq, wk, wv, wo, vecs, a, z, B, depth, L, heads,  \
                                    inner, stream);                                     \
  }

// The row entries take the hidden width mlp (32 or 64) and dispatch to its
// instance; b1 is read only where mlp != 32.
#define FUSED_DECODER_ROWS_ENTRY(SUFFIX, T, PRECISE)                                      \
  extern "C" int fused_decoder_##SUFFIX(const void* x, const void* a, const void* z,      \
                                        const void* w1, const void* w2, const void* vecs, \
                                        const void* b1, void* y, int B, int N, int depth, \
                                        int hl, int l, int lr, int mlp, void* stream) {   \
    if (mlp == 64)                                                                        \
      return launch_group<T, PRECISE, 64>(x, a, z, w1, w2, vecs, b1, y, B, N, depth, hl,  \
                                          l, lr, stream);                                 \
    if (mlp != DIM) return static_cast<int>(cudaErrorInvalidValue);                       \
    return launch_group<T, PRECISE, DIM>(x, a, z, w1, w2, vecs, b1, y, B, N, depth, hl,   \
                                         l, lr, stream);                                  \
  }                                                                                       \
  extern "C" int fused_decoder_ctas_per_sm_##SUFFIX(int hl, int mlp, int pad, int* out) { \
    if (mlp == 64) return ctas_per_sm_group<T, PRECISE, 64>(hl, pad, out);                \
    if (mlp != DIM) return static_cast<int>(cudaErrorInvalidValue);                       \
    return ctas_per_sm_group<T, PRECISE, DIM>(hl, pad, out);                              \
  }

FUSED_DECODER_AZ_ENTRY(precise, true)
FUSED_DECODER_AZ_ENTRY(bf16ops, false)
FUSED_DECODER_ROWS_ENTRY(f32_precise, float, true)
FUSED_DECODER_ROWS_ENTRY(f32_bf16ops, float, false)
FUSED_DECODER_ROWS_ENTRY(bf16_bf16ops, __nv_bfloat16, false)
FUSED_DECODER_ROWS_ENTRY(bf16_precise, __nv_bfloat16, true)
