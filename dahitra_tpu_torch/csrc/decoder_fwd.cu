// Cross-attention decoder stack forward (production "noshift" numerics) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel dahitra_tpu/pallas/folded_decoder.py
// `_fwd_kernel`, without saves (eval, `decoder_stack_fwd_*`) and with them
// (training, `decoder_stack_fwd_save_*`: each layer's input x_in and its
// attention row, which the backward kernel csrc/decoder_bwd.cu reads). The
// two are one template; the saves are stores beside the same arithmetic, so
// y is the same bit for bit. Per layer d, for every token row x
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
// Bound on this card: ~8.2 kFLOP per row per layer (at hl = 32) against 128
// (bf16) or 256 (fp32) bytes per row for the whole stack, so the work is
// bounded by operations, not bytes: the fp32 FMA pipe's rate gives the
// bound quoted in PERF.md; on the tensor cores the bf16 products take a
// twelfth of it and the elementwise work (two LayerNorms, the clamped exp
// and the divide, GELU, roundings) is the larger part.
//
// Design, both instances: the four per-row products (hn.A, attn.Z, g.W1,
// h.W2) run on the tensor cores as mma.sync m16n8k16 with bf16 operands
// and fp32 accumulation. In bf16 every operand is a bf16 value at
// _layer_fwd's rounding points, so each product is exact up to its
// summation order. In fp32 every operand v is split exactly into three
// bf16 pieces (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid))
// and a product is the six piece products lo.hi, hi.lo, mid.mid, mid.hi,
// hi.mid, hi.hi, small terms first (K2's mma_split). A warp owns 16 rows,
// kept in registers across all layers in the fragment layout of
// decoder_mma.cuh, so x is read once and y written once. A product's
// accumulators, rounded where _layer_fwd rounds and packed to bf16 pairs
// (one piece or three), are the A fragment of the next product: hn ->
// dots, 16 columns of hl at a time -> softmax -> attn, whose 16 columns
// are at once one k-step of attn.Z; then x1 -> g -> t -> h -> x2.
// LayerNorm statistics and the softmax group sums (l = 1, 2, 4 or 8
// consecutive columns: the pair a thread holds, then shuffles 1 and 2
// lanes apart; decoder_mma.cuh group_reduce) stay inside the quad of lanes
// that holds a row. Each
// layer's A, Z, W1 and W2 are staged once per CTA as one bf16 plane or
// three, rows padded for ldmatrix, hl zero-padded to a multiple of 16:
// whole zero heads (l divides 16), whose attention stays in its own group
// and meets zero rows of Z. attn.Z and g.W1 take K2's k-step order, so
// K2's recomputed x1 and g are these bits. With SAVE, x_in and the first
// hl columns of attn are stored from the fragments beside the same
// arithmetic, so y is K1's bit for bit.
//
// Token counts beside 1, 2, 4 and 8 run in the PAD instances. The wrapper
// (kernels/folded_decoder.py) pads each head's group of lr tokens to the next
// count l in {1, 2, 4, 8, 16} with zero columns of A and zero rows of Z (an
// odd hl, one token at odd heads, gains a zero head instead), and passes both
// counts. Padded, the JAX gate's counts reach hl 224; hl is a run-time
// argument and only the staged planes grow with it (124.5 KB in fp32 at hl
// 256, 3 planes of plane_size), so the same instances take it. Since the
// softmax clamps rather than shifts, a padded logit of 0 would add exp(0) = 1
// to its group: the PAD instance zeroes the exp terms of the columns j with
// j % l >= lr before the group sum, which for l = 16 also adds the thread's
// two 8-column halves. The padded columns' attention is then 0, so they
// meet Z's zero rows and their saves are 0. The other instances' code does
// not test lr or sum 16 columns.
//
// The hidden width MLP is a template parameter: 32 (DAHiTra), or 64 (BIT's
// decoder, mlp_dim = 2 * dim), whose b1 (D, 64) comes as an fp32 argument of
// its own. The 64 instance runs the hidden layer in two 32-column halves c:
// h_c = rnd(gelu(rnd(rnd(g . W1[:, c]) + b1[c]))) on the same 16 x 32 tiles,
// then h_c . W2[c, :] accumulates into the one fp32 sum of h . W2, rounded
// once, as the JAX product with fp32 accumulation rounds it. So a thread
// holds what the 32 instance holds plus one 32-wide half; W1 and W2 are
// staged whole, their planes sized by MLP (58 KB in fp32 at hl = 64, past
// the 48 KB default, which set_smem raises).
//
// Grid: (row tiles of TILE rows, B), a 16-row tile per warp, 8 warps. Each
// CTA stages every layer's weights, so larger CTAs stage less. Against 4
// warps (64 rows) on the H100, in two runs, 8 warps took 11-12 % less time
// in fp32 (three planes to stage) at N = 16384 and at B = 8, N = 4096
// (-12 % and +2 % at B = 16, N = 4096), 4-6 % less in bf16 at N >= 4096,
// and between 11 % less and 13 % more at N = 256 and 1024, whose grids are
// below one wave; per batch-8 forward at 256 px 2-9 % less in fp32 and 2 %
// in bf16 (PERF.md, PR 9). Staging the split planes once per call is the
// next step if it matters.
#include "decoder_mma.cuh"

namespace {

using namespace decoder;

constexpr int NV = 7 * DIM;    // the seven vectors
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = WARPS * 16;  // rows per CTA

// One layer for the warp's 16 rows, v (fragment layout) in and out; rows
// whose ok flag is false compute on zeros and store nothing. With SAVE, x_in
// is stored at xsave (row srow and srow + 8) and the attention row at
// attnsave, its first hl columns. MLP is the hidden width: 32, with b1 in
// sV's row 5, or 64, with b1 at sV + NV. PAD: groups of l up to 16 columns,
// of which the first lr are tokens.
template <typename T, bool SAVE, int MLP, bool PAD>
__device__ __forceinline__ void layer_rows(float (&v)[16], const __nv_bfloat16* sA,
                                           const __nv_bfloat16* sZ,
                                           const __nv_bfloat16* sW1,
                                           const __nv_bfloat16* sW2, const float* sV,
                                           int plane, int hl, int l, int lr, bool ok0,
                                           bool ok1, int64_t srow, T* xsave, T* attnsave,
                                           int lane) {
  constexpr int P = pieces<T>();
  const int t = lane & 3;
  const int hlp = pad16(hl);
  if (SAVE) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int n = p >> 1, r = p & 1;
      if (r ? ok1 : ok0)
        st_pair(xsave + (srow + 8 * r) * DIM + 8 * n + 2 * t, v[2 * p], v[2 * p + 1]);
    }
  }
  float xhat[16], rs[2], u[16], acc[16];
  uint32_t fr[2][P][4];

  // ---- attention: dots = hn . A and attn . Z, 16 columns of hl at a time ----
  ln_rows(v, xhat, rs);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    u[i] = rnd<T>(xhat[i] * sV[ch] + sV[DIM + ch]);  // hn
    acc[i] = 0.0f;
  }
  frag32<P>(fr, u);
  for (int jj = 0; jj < hlp / 16; ++jj) {
    float e[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, s[8];
    mma_pair<true, P>(e, fr[0], sA, plane, hlp + 8, 0, 16 * jj, lane);
    mma_pair<true, P>(e, fr[1], sA, plane, hlp + 8, 16, 16 * jj, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dots = rnd<T>(e[i]) * SCALE;
      e[i] = expf(fminf(fmaxf(dots, -CLAMP), CLAMP));
      if (PAD && (slice_col(jj, i, t) & (l - 1)) >= lr) e[i] = 0.0f;  // a padded token
      s[i] = e[i];
    }
    group_reduce<false, PAD ? 16 : 8>(s, l);  // the group sum over l columns
    uint32_t at[P][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float a0 = rnd<T>(e[2 * q] / s[2 * q]);
      const float a1 = rnd<T>(e[2 * q + 1] / s[2 * q + 1]);
      const int r = q & 1, col = 16 * jj + 8 * (q >> 1) + 2 * t;
      if (SAVE && (r ? ok1 : ok0) && col < hl)
        st_pair(attnsave + (srow + 8 * r) * hl + col, a0, a1);
      split_pair<P>(a0, a1, at, q);
    }
    mma_pair<true, P>(acc, at, sZ, plane, WLD, 16 * jj, 0, lane);  // ao = attn . Z
    mma_pair<true, P>(acc + 8, at, sZ, plane, WLD, 16 * jj, 16, lane);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    v[i] = rnd<T>(rnd<T>(v[i] + rnd<T>(acc[i])) + sV[2 * DIM + ch]);  // x1
  }

  // ---- feed-forward ----
  ln_rows(v, xhat, rs);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    u[i] = rnd<T>(xhat[i] * sV[3 * DIM + ch] + sV[4 * DIM + ch]);  // g
    acc[i] = 0.0f;
  }
  frag32<P>(fr, u);
  if constexpr (MLP == DIM) {
    mma_row32<true, P>(acc, fr, sW1, plane, lane);  // g . W1
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
      u[i] = rnd<T>(gelu(rnd<T>(rnd<T>(acc[i]) + sV[5 * DIM + ch])));  // h
      acc[i] = 0.0f;
    }
    frag32<P>(fr, u);
    mma_row32<true, P>(acc, fr, sW2, plane, lane);  // h . W2
  } else {
    // The hidden layer in 32-column halves c: h_c = rnd(gelu(rnd(rnd(g .
    // W1[:, c]) + b1[c]))), and h_c . W2[c, :] into the one fp32 sum of
    // h . W2, rounded once below.
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
        hc[i] = rnd<T>(gelu(rnd<T>(rnd<T>(hc[i]) + sV[NV + ch])));  // h_c
      }
      frag32<P>(fh, hc);
      mma_row32<true, P>(acc, fh, sW2 + DIM * c * WLD, plane, lane);  // h_c . W2[c, :]
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
    v[i] = rnd<T>(rnd<T>(v[i] + rnd<T>(acc[i])) + sV[6 * DIM + ch]);  // x2
  }
}

template <typename T, int MLP>
__host__ __device__ __forceinline__ size_t smem_bytes(int hl) {
  return 2 * pieces<T>() * plane_size(hl, MLP) + 4 * (NV + b1_floats<MLP>());  // planes, vectors
}

// x, y: (B, N, 32); a: (D, B, 32, hl); z: (D, B, hl, 32); w1: (D, 32, MLP)
// and w2: (D, MLP, 32) laid out (in, out); vecs: (D, 7, 32) fp32 rows
// [ln1_scale, ln1_bias, bo, ln2_scale, ln2_bias, b1, b2]; where MLP != 32,
// b1: (D, MLP) fp32 and vecs' row 5 unused. With SAVE, xsave: (D, B, N, 32)
// and attnsave: (D, B, N, hl) in T. l, the tokens per head, is 1, 2, 4 or 8
// (PAD: or 16, lr <= l of them tokens) and hl is even. Grid (row tiles of
// TILE, B).
template <typename T, bool SAVE, int MLP, bool PAD>
__global__ void __launch_bounds__(THREADS)
decoder_stack_fwd_rows_mma(const T* __restrict__ x, const T* __restrict__ a,
                           const T* __restrict__ z, const T* __restrict__ w1,
                           const T* __restrict__ w2, const float* __restrict__ vecs,
                           T* __restrict__ y, T* __restrict__ xsave,
                           T* __restrict__ attnsave, int B, int N, int depth, int hl,
                           int l, const float* __restrict__ b1, int lr) {
  constexpr int P = pieces<T>();
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
      stage<P>(sA + c * ald + j, plane, j < hl ? to_f(a[az_off + c * hl + j]) : 0.0f);
      const int jz = i >> 5, cz = i & (DIM - 1);  // Z[j][c], zero rows past hl
      stage<P>(sZ + jz * WLD + cz, plane, jz < hl ? to_f(z[az_off + i]) : 0.0f);
    }
    for (int i = tid; i < DIM * MLP; i += THREADS) {
      stage<P>(sW1 + (i >> mlp_shift<MLP>()) * (MLP + 8) + (i & (MLP - 1)), plane,
               to_f(w1[d * DIM * MLP + i]));
      stage<P>(sW2 + (i >> 5) * WLD + (i & (DIM - 1)), plane, to_f(w2[d * DIM * MLP + i]));
    }
    for (int i = tid; i < NV; i += THREADS) {
      const int k = i / DIM;
      const float val = vecs[d * NV + i];
      // bo, b1, b2 enter the stack cast to T; the LN parameters stay fp32.
      sV[i] = (k == 2 || k == 5 || k == 6) ? rnd<T>(val) : val;
    }
    if constexpr (MLP != DIM) {
      for (int i = tid; i < MLP; i += THREADS) sV[NV + i] = rnd<T>(b1[d * MLP + i]);
    }
    __syncthreads();
    if (active)
      layer_rows<T, SAVE, MLP, PAD>(v, sA, sZ, sW1, sW2, sV, plane, hl, l, lr, ok0, ok1,
                          (static_cast<int64_t>(d) * B + b) * N + wrow + g, xsave,
                          attnsave, lane);
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = p >> 1, r = p & 1;
    if (r ? ok1 : ok0)
      st_pair(y + (xrow + 8 * r) * DIM + 8 * n + 2 * t, v[2 * p], v[2 * p + 1]);
  }
}

template <typename T, bool SAVE, int MLP, bool PAD>
cudaError_t set_smem(int hl) {
  return cudaFuncSetAttribute(decoder_stack_fwd_rows_mma<T, SAVE, MLP, PAD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<T, MLP>(hl)));
}

template <typename T, bool SAVE, int MLP, bool PAD>
int launch(const void* x, const void* a, const void* z, const void* w1,
           const void* w2, const void* vecs, const void* b1, void* y, void* xsave,
           void* attnsave, int B, int N, int depth, int hl, int l, int lr, void* stream) {
  const cudaError_t err = set_smem<T, SAVE, MLP, PAD>(hl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, B);
  decoder_stack_fwd_rows_mma<T, SAVE, MLP, PAD>
      <<<grid, THREADS, smem_bytes<T, MLP>(hl), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(z),
          static_cast<const T*>(w1), static_cast<const T*>(w2),
          static_cast<const float*>(vecs), static_cast<T*>(y),
          static_cast<T*>(xsave), static_cast<T*>(attnsave), B, N, depth, hl, l,
          static_cast<const float*>(b1), lr);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the hidden width mlp (32 or 64) and the group: the PAD
// instance where lr < l tokens are real or l = 16.
template <typename T, bool SAVE, int MLP>
int launch_group(const void* x, const void* a, const void* z, const void* w1,
                 const void* w2, const void* vecs, const void* b1, void* y, void* xsave,
                 void* attnsave, int B, int N, int depth, int hl, int l, int lr,
                 void* stream) {
  if (lr < l || l > 8)
    return launch<T, SAVE, MLP, true>(x, a, z, w1, w2, vecs, b1, y, xsave, attnsave, B, N,
                                      depth, hl, l, lr, stream);
  return launch<T, SAVE, MLP, false>(x, a, z, w1, w2, vecs, b1, y, xsave, attnsave, B, N,
                                     depth, hl, l, lr, stream);
}

template <typename T, bool SAVE>
int launch_mlp(const void* x, const void* a, const void* z, const void* w1,
               const void* w2, const void* vecs, const void* b1, void* y, void* xsave,
               void* attnsave, int B, int N, int depth, int hl, int l, int lr, int mlp,
               void* stream) {
  if (mlp == 64)
    return launch_group<T, SAVE, 64>(x, a, z, w1, w2, vecs, b1, y, xsave, attnsave, B, N,
                                     depth, hl, l, lr, stream);
  if (mlp != DIM) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group<T, SAVE, DIM>(x, a, z, w1, w2, vecs, b1, y, xsave, attnsave, B, N,
                                    depth, hl, l, lr, stream);
}

// CTAs of the kernel that one SM holds at once for this hl (its registers
// and shared memory decide), written to *out.
template <typename T, bool SAVE, int MLP, bool PAD>
int ctas_per_sm(int hl, int* out) {
  const cudaError_t err = set_smem<T, SAVE, MLP, PAD>(hl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, decoder_stack_fwd_rows_mma<T, SAVE, MLP, PAD>, THREADS, smem_bytes<T, MLP>(hl)));
}

template <typename T, bool SAVE>
int ctas_per_sm_mlp(int hl, int mlp, int pad, int* out) {
  if (mlp == 64)
    return pad ? ctas_per_sm<T, SAVE, 64, true>(hl, out)
               : ctas_per_sm<T, SAVE, 64, false>(hl, out);
  if (mlp != DIM) return static_cast<int>(cudaErrorInvalidValue);
  return pad ? ctas_per_sm<T, SAVE, DIM, true>(hl, out)
             : ctas_per_sm<T, SAVE, DIM, false>(hl, out);
}

}  // namespace

#define DECODER_FWD_ENTRY(SUFFIX, T)                                                     \
  extern "C" int decoder_stack_fwd_##SUFFIX(                                            \
      const void* x, const void* a, const void* z, const void* w1, const void* w2,      \
      const void* vecs, const void* b1, void* y, int B, int N, int depth, int hl, int l, \
      int lr, int mlp, void* stream) {                                                  \
    return launch_mlp<T, false>(x, a, z, w1, w2, vecs, b1, y, nullptr, nullptr, B, N,   \
                                depth, hl, l, lr, mlp, stream);                         \
  }                                                                                     \
  extern "C" int decoder_stack_fwd_save_##SUFFIX(                                       \
      const void* x, const void* a, const void* z, const void* w1, const void* w2,      \
      const void* vecs, const void* b1, void* y, void* xsave, void* attnsave, int B,    \
      int N, int depth, int hl, int l, int lr, int mlp, void* stream) {                 \
    return launch_mlp<T, true>(x, a, z, w1, w2, vecs, b1, y, xsave, attnsave, B, N,     \
                               depth, hl, l, lr, mlp, stream);                          \
  }                                                                                     \
  extern "C" int decoder_stack_fwd_ctas_per_sm_##SUFFIX(int hl, int save, int mlp,      \
                                                        int pad, int* out) {            \
    return save ? ctas_per_sm_mlp<T, true>(hl, mlp, pad, out)                           \
                : ctas_per_sm_mlp<T, false>(hl, mlp, pad, out);                         \
  }

DECODER_FWD_ENTRY(f32, float)
DECODER_FWD_ENTRY(bf16, __nv_bfloat16)
