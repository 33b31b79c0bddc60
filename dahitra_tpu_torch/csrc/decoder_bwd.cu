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
// The TPU kernel accumulates over a sequential grid; here CTAs run in
// parallel, so each CTA owns a contiguous range of rows of one sample and
// loops over the layers in reverse, staging the layer's weights in shared
// memory, and within a layer over tiles of rows. A row's cotangent crosses
// layers through dx in device memory (every value is a T value, so nothing
// is lost; each thread reads back exactly what it wrote). At the end of a
// layer the CTA's partial sums are in a scratch buffer; a second kernel sums
// the partials in a fixed order (no float atomics, so a rerun gives the same
// bits) and rounds dA and dZ to T per sample, as _layer_bwd does.
//
// Bound on this card: about 10 kFLOP + 320 * hl FLOP per row per layer
// (ten products) against 2 * (32 + hl) bytes of saves per row and layer in
// bf16, so operations bound it (0.30 ms per batch-8 training step at 256 px
// on the fp32 pipe, 0.04 ms by bytes in bf16).
//
// Design, both instances: the six per-row products (attn.Z, g.W1, dy.W2^T,
// dt.W1^T, dx1.Z^T, dl.A^T) run on the tensor cores as mma.sync m16n8k16
// with bf16 operands and fp32 accumulation. In bf16 every operand is a bf16
// value at _layer_bwd's rounding points, so each product is exact and only
// the summation order differs. In fp32 every operand v is split exactly
// into three bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v -
// hi - mid), and a product becomes the six piece products lo.hi, hi.lo,
// mid.mid, mid.hi, hi.mid, hi.hi, small terms first; the three it drops are
// below 2^-23 of it. A warp owns 16 rows; a product's fp32 accumulators,
// packed to bf16 pairs (one piece or three), are the A fragment of the next
// product, so the chain attn -> ao -> x1 -> g -> t and dy -> dhg -> dt -> dg
// -> dx1 -> dattn -> dl -> dhn -> dx stays in registers. Row reductions
// (LayerNorm statistics and backward means, the softmax group sums) are
// shuffles inside the quad of lanes that holds a row. The weights are staged
// once per layer as one bf16 plane or three (hl zero-padded to a multiple of
// 16: whole zero heads, whose attn, dattn and dl are zero) and read as B
// fragments with ldmatrix (.trans for the k-major orientation), rows padded
// to stay free of bank conflicts. Each 16-row tile's factors of the four
// weight-side sums (dW1 += g^T dt, dW2 += hg^T dy, dA += hn^T dl, dZ +=
// attn^T dx1) go to shared memory in T, and the sums run on the tensor cores
// too: the warps take 16 x 16 output blocks in index order, 16 rows per
// k-step, both operands read with ldmatrix.trans in bf16, read by hand and
// split into three pieces in fp32.
//
// 16 tokens per head run in the PAD instances, whose group sum also adds the
// thread's two 8-column halves (decoder_mma.cuh group_reduce); the others'
// code stops at 8. Counts the tiles do not hold come padded by the wrapper
// (kernels/folded_decoder.py) to the next one they do, with zero columns of A,
// zero rows of Z and zero attention: dl = attn * (...) is then 0 at the
// padded columns, so they change no gradient and their dA and dZ are 0. No
// mask is needed. Padded, the JAX gate's counts (heads * tokens <= 128, up to
// 16 tokens per head) reach hl 224 (14 heads of 9 tokens, each group padded
// to 16).
//
// Shared memory grows with hl: the weight planes (three in fp32) and the two
// hl-wide factor tiles (attn, dl). In fp32 the 64-row tiles pass the 227 KB
// a block may have above hl 160 (mlp_dim 32) or 128 (64): 309 KB at hl 256.
// There the WIDE instances run, CTAs of 2 warps whose factor tiles hold 32
// rows (at most 225 KB at hl 224), one CTA per SM. The factor tiles kept as
// bf16 pieces would not help: three pieces take 6 bytes where the fp32 value
// takes 4. bf16 fits at 64 rows up to hl 256 (159 KB), and every instance
// below those hl keeps its code (WIDE is a last template flag).
//
// The hidden width MLP is a template parameter: 32 (DAHiTra) or 64 (BIT's
// decoder), whose b1 (D, 64) comes as an fp32 argument of its own and whose
// db1 (D, 64) is returned beside dvecs (row 5 of dvecs is then zero). The 64
// instance runs the feed-forward backward in two 32-column halves c of the
// hidden layer: it recomputes t_c = rnd(rnd(g . W1[:, c]) + b1[c]) and
// hg_c, then dhg_c = rnd(dy . W2[c, :]^T), dt_c = rnd(dhg_c * gelu'(t_c)),
// and accumulates dt_c . W1[:, c]^T into dg's one fp32 sum, rounded once. A
// thread holds the 32 instance's vectors plus one half. The factor tiles of
// hg and dt, the weight planes and the (CTA, layer) partials grow with MLP;
// db1's halves take vector rows 5 and 7 of the per-warp sums (row 7 is free:
// seven vectors, eight row groups), and the second pass sums them in the
// same fixed order.
#include "decoder_mma.cuh"

namespace {

using namespace decoder;

constexpr int NV = 7 * DIM;    // the seven vectors
// Shared memory one block may opt in to on sm_90 (227 KB).
constexpr size_t SMEM_OPTIN = 232448;

// Warps of a CTA, 16 rows each: 4 (a 64-row tile), or 2 (a 32-row tile) in
// the WIDE instances, whose factor tiles are half as tall.
template <bool WIDE>
__host__ __device__ constexpr int warps() {
  return WIDE ? 2 : 4;
}

// Vector rows of the per-warp sums: the seven, and db1's second half as row
// 7 where MLP != DIM.
template <int MLP>
__host__ __device__ constexpr int n_vrows() {
  return MLP == DIM ? 7 : 8;
}

// Floats of one (CTA, layer) partial: [dW1 | dW2 | dA | dZ | dvec | db1].
template <int MLP>
__host__ __device__ __forceinline__ int64_t part_size(int hl) {
  return 2 * DIM * MLP + 2 * DIM * hl + NV + b1_floats<MLP>();
}

// Padded row of a factor tile of width w (a multiple of 16), in T: w + 8
// bf16 keeps ldmatrix free of bank conflicts; w + 4 floats (2 * row = 8
// mod 32 words) keeps the reads of a fragment's row pairs free of them.
template <typename T>
__host__ __device__ __forceinline__ int tile_ld(int w) {
  return std::is_same<T, float>::value ? w + 4 : w + 8;
}

template <typename T, int MLP, bool WIDE>
__host__ __device__ __forceinline__ size_t smem_bytes(int hl) {
  return 2 * pieces<T>() * plane_size(hl, MLP)  // weight planes
         + sizeof(T) * 16 * warps<WIDE>() * (4 * tile_ld<T>(DIM) + 2 * tile_ld<T>(MLP)
                                             + 2 * tile_ld<T>(pad16(hl)))  // factors
         + 4 * (NV + b1_floats<MLP>() + warps<WIDE>() * n_vrows<MLP>() * DIM);  // vectors, sums
}

// Whether this hl needs the WIDE instance: the 64-row tiles' shared memory
// is past what a block may have (fp32 above hl 160 at mlp_dim 32, above
// 128 at 64; bf16 fits up to hl 256).
template <typename T, int MLP>
bool needs_wide(int hl) {
  return smem_bytes<T, MLP, false>(hl) > SMEM_OPTIN;
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

// Writes (when `first`) or adds a 16 x 16 block c (rows m0.., columns n0..,
// fragment layout) to out, rows of ldo; entries at rows >= m_lim or columns
// >= n_lim are not written.
__device__ __forceinline__ void block_store(float* out, int ldo, int m_lim, int n_lim,
                                            int m0, int n0, const float (&c)[8],
                                            bool first, int lane) {
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

// One 16 x 16 block (rows m0.., columns n0..) of a weight-side sum over the
// tile's first `ksteps` 16-row steps, out (+)= X^T . Y, with X [r][m] and Y
// [r][n] factor tiles (block_store writes it). bf16: both operands k-major,
// read with ldmatrix.trans.
__device__ __forceinline__ void mma_block(float* out, int ldo, int m_lim, int n_lim,
                                          const __nv_bfloat16* X, int ldx,
                                          const __nv_bfloat16* Y, int ldy, int m0,
                                          int n0, int ksteps, bool first, int lane) {
  float c[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ks = 0; ks < ksteps; ++ks) {
    const __nv_bfloat16* p =
        X + (16 * ks + (lane & 7) + 8 * (lane >> 4)) * ldx + m0 + 8 * ((lane >> 3) & 1);
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    uint32_t a[1][4];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0][0]), "=r"(a[0][1]), "=r"(a[0][2]), "=r"(a[0][3]) : "r"(addr));
    mma_pair<true, 1>(c, a, Y, 0, ldy, 16 * ks, n0, lane);
  }
  block_store(out, ldo, m_lim, n_lim, m0, n0, c, first, lane);
}

// fp32: each fragment element is read by hand (a pair of k rows; rows of
// ld = 4 mod 16 floats keep each read free of bank conflicts) and split
// into three pieces, six piece products per k-step.
__device__ __forceinline__ void mma_block(float* out, int ldo, int m_lim, int n_lim,
                                          const float* X, int ldx, const float* Y, int ldy,
                                          int m0, int n0, int ksteps, bool first, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float c[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ks = 0; ks < ksteps; ++ks) {
    const float* x = X + (16 * ks + 2 * t) * ldx + m0 + g;
    const float* y = Y + (16 * ks + 2 * t) * ldy + n0 + g;
    uint32_t a[3][4], b[2][3][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // A[m][k] = X[k][m]: m = m0 + g + 8 (q & 1)
      const float* p = x + 8 * (q >> 1) * ldx + 8 * (q & 1);
      split_pair<3>(p[0], p[ldx], a, q);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // B[k][n] = Y[k][n]: n = n0 + 8h + g
        const float* p = y + 8 * q * ldy + 8 * h;
        split_pair<3>(p[0], p[ldy], b[h], q);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) mma_split<3>(c + 4 * h, a, b[h]);
  }
  block_store(out, ldo, m_lim, n_lim, m0, n0, c, first, lane);
}

// xsave: (D, B, N, 32), attnsave: (D, B, N, hl), dy, dx: (B, N, 32), all T;
// a: (D, B, 32, hl), z: (D, B, hl, 32), w1: (D, 32, MLP), w2: (D, MLP, 32)
// (in, out), T; vecs: (D, 7, 32) fp32 and, where MLP != 32, b1: (D, MLP)
// fp32; part: (B * cps, D, part_size<MLP>(hl)) fp32 scratch. l, the tokens
// per head, is 1, 2, 4 or 8 (PAD: or 16) and hl is even. WIDE: CTAs of
// 2 warps (warps<WIDE>()).
template <typename T, int MLP, bool PAD, bool WIDE = false>
__global__ void __launch_bounds__(WIDE ? 64 : 128)
decoder_stack_bwd_rows_mma(const T* __restrict__ xsave, const T* __restrict__ attnsave,
                           const T* __restrict__ dy_in, const T* __restrict__ a,
                           const T* __restrict__ z, const T* __restrict__ w1,
                           const T* __restrict__ w2, const float* __restrict__ vecs,
                           T* dx, float* __restrict__ part, int B, int N, int depth,
                           int hl, int l, int rows_per_cta,
                           const float* __restrict__ b1) {
  constexpr int P = pieces<T>();
  constexpr int NWM = DIM * MLP;  // one weight
  constexpr int VR = n_vrows<MLP>();
  constexpr int WARPS = warps<WIDE>();
  constexpr int THREADS = WARPS * 32;
  constexpr int TILE = WARPS * 16;  // rows per CTA tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hlp = pad16(hl);
  const int ald = hlp + 8;
  const int plane = plane_size(hl, MLP);
  const int tld = tile_ld<T>(DIM), tlh = tile_ld<T>(hlp), tlm = tile_ld<T>(MLP);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [c][j]
  __nv_bfloat16* sZ = sA + DIM * ald;                               // [j][c]
  __nv_bfloat16* sW1 = sZ + hlp * WLD;                              // [c][m]
  __nv_bfloat16* sW2 = sW1 + DIM * (MLP + 8);                       // [m][c]
  T* tHg = reinterpret_cast<T*>(sA + P * plane);  // TILE rows of tlm
  T* tDy = tHg + TILE * tlm;                      // TILE rows of tld
  T* tG = tDy + TILE * tld;
  T* tDt = tG + TILE * tld;     // TILE rows of tlm
  T* tHn = tDt + TILE * tlm;    // TILE rows of tld
  T* tDx1 = tHn + TILE * tld;
  T* tAttn = tDx1 + TILE * tld;  // TILE rows of tlh
  T* tDl = tAttn + TILE * tlh;   // TILE rows of tlh
  float* sV = reinterpret_cast<float*>(tDl + TILE * tlh);  // NV, then b1
  float* sRed = sV + NV + b1_floats<MLP>();  // WARPS x VR x 32

  const int b = blockIdx.y;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int r_begin = blockIdx.x * rows_per_cta;
  const int r_end = min(N, r_begin + rows_per_cta);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_az = DIM * hl;
  const int64_t ps = part_size<MLP>(hl);

  for (int d = depth - 1; d >= 0; --d) {
    __syncthreads();  // every thread is done with layer d+1's shared data
    const int64_t az_off = (static_cast<int64_t>(d) * B + b) * n_az;
    for (int i = tid; i < DIM * hlp; i += THREADS) {
      const int c = i / hlp, j = i - c * hlp;  // A[c][j], zero past hl
      stage<P>(sA + c * ald + j, plane, j < hl ? to_f(a[az_off + c * hl + j]) : 0.0f);
      const int jz = i >> 5, cz = i & (DIM - 1);  // Z[j][c], zero rows past hl
      stage<P>(sZ + jz * WLD + cz, plane, jz < hl ? to_f(z[az_off + i]) : 0.0f);
    }
    for (int i = tid; i < NWM; i += THREADS) {
      stage<P>(sW1 + (i >> mlp_shift<MLP>()) * (MLP + 8) + (i & (MLP - 1)), plane,
               to_f(w1[d * NWM + i]));
      stage<P>(sW2 + (i >> 5) * WLD + (i & (DIM - 1)), plane, to_f(w2[d * NWM + i]));
    }
    for (int i = tid; i < NV; i += THREADS) {
      const int k = i / DIM;
      const float v = vecs[d * NV + i];
      sV[i] = (k == 2 || k == 5 || k == 6) ? rnd<T>(v) : v;
    }
    if constexpr (MLP != DIM) {
      for (int i = tid; i < MLP; i += THREADS) sV[NV + i] = rnd<T>(b1[d * MLP + i]);
    }
    float keep[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) keep[i] = 0.0f;
    __syncthreads();

    for (int t0 = r_begin; t0 < r_end; t0 += TILE) {
      const int wrow = t0 + warp * 16;  // the warp's first row
      const int lrow = warp * 16 + g;   // this thread's first row in the tile
      if (wrow < r_end) {               // warp-uniform
        const bool ok0 = wrow + g < r_end, ok1 = wrow + g + 8 < r_end;
        const int64_t srow = (static_cast<int64_t>(d) * B + b) * N + wrow + g;
        const int64_t xrow = static_cast<int64_t>(b) * N + wrow + g;
        float x[16], xhat[16], rs[2], v[16], acc[16];
        uint32_t fr[2][P][4];

        // ---- recompute the forward (decoder_fwd.cu, the same operations) ----
        row_load(xsave, srow, ok0, ok1, t, x);
        ln_rows(x, xhat, rs);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          v[i] = rnd<T>(xhat[i] * sV[ch] + sV[DIM + ch]);  // hn
          acc[i] = 0.0f;
        }
        tile_store(tHn, tld, lrow, t, v);
        for (int kk = 0; kk < hlp / 16; ++kk) {  // ao = attn . Z
          uint32_t at[P][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q & 1, col = 16 * kk + 8 * (q >> 1) + 2 * t;
            const float2 u = ((r ? ok1 : ok0) && col < hl)
                                 ? ld_pair(attnsave + (srow + 8 * r) * hl + col)
                                 : make_float2(0.0f, 0.0f);
            st_pair(tAttn + (lrow + 8 * r) * tlh + col, u.x, u.y);
            split_pair<P>(u.x, u.y, at, q);
          }
          mma_pair<true, P>(acc, at, sZ, plane, WLD, 16 * kk, 0, lane);
          mma_pair<true, P>(acc + 8, at, sZ, plane, WLD, 16 * kk, 16, lane);
        }
        float xhat1[16], rs1[2], tt[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          v[i] = rnd<T>(rnd<T>(x[i] + rnd<T>(acc[i])) + sV[2 * DIM + ch]);
        }
        ln_rows(v, xhat1, rs1);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
          v[i] = rnd<T>(xhat1[i] * sV[3 * DIM + ch] + sV[4 * DIM + ch]);  // g
          tt[i] = 0.0f;
        }
        tile_store(tG, tld, lrow, t, v);
        float dyv[16];
        if constexpr (MLP == DIM) {
          frag32<P>(fr, v);
          mma_row32<true, P>(tt, fr, sW1, plane, lane);  // g . W1
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
            tt[i] = rnd<T>(rnd<T>(tt[i]) + sV[5 * DIM + ch]);
            v[i] = rnd<T>(gelu(tt[i]));  // hg
          }
          tile_store(tHg, tld, lrow, t, v);

          // ---- feed-forward backward ----
          row_load(d == depth - 1 ? dy_in : dx, xrow, ok0, ok1, t, dyv);
          tile_store(tDy, tld, lrow, t, dyv);
          vec_sum(dyv, keep, 6, g);
          frag32<P>(fr, dyv);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
          mma_row32<false, P>(acc, fr, sW2, plane, lane);  // dy . W2^T
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            acc[i] = rnd<T>(acc[i]) * gelu_grad(tt[i]);  // dt32
            v[i] = rnd<T>(acc[i]);                       // dt
          }
          vec_sum(acc, keep, 5, g);
          tile_store(tDt, tld, lrow, t, v);
          frag32<P>(fr, v);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
          mma_row32<false, P>(acc, fr, sW1, plane, lane);  // dt . W1^T
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = rnd<T>(acc[i]);  // dg
        } else {
          // ---- feed-forward, recomputed and reversed in 32-column halves ----
          row_load(d == depth - 1 ? dy_in : dx, xrow, ok0, ok1, t, dyv);
          tile_store(tDy, tld, lrow, t, dyv);
          vec_sum(dyv, keep, 6, g);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = 0.0f;  // dg
          // The fragments of g, dy and dt_c are made where each product
          // needs them, one at a time, from the 32-wide vectors.
#pragma unroll
          for (int c = 0; c < MLP / DIM; ++c) {
            float tc[16], hc[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) tc[i] = 0.0f;
            frag32<P>(fr, v);  // g
            mma_row32<true, P>(tc, fr, sW1 + DIM * c, plane, lane, MLP + 8);  // g . W1[:, c]
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int ch = DIM * c + 8 * (i >> 2) + 2 * t + (i & 1);
              tc[i] = rnd<T>(rnd<T>(tc[i]) + sV[NV + ch]);  // t_c
              hc[i] = rnd<T>(gelu(tc[i]));                  // hg_c
            }
            tile_store(tHg + DIM * c, tlm, lrow, t, hc);
#pragma unroll
            for (int i = 0; i < 16; ++i) hc[i] = 0.0f;
            frag32<P>(fr, dyv);
            mma_row32<false, P>(hc, fr, sW2 + DIM * c * WLD, plane, lane);  // dy . W2[c, :]^T
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              hc[i] = rnd<T>(hc[i]) * gelu_grad(tc[i]);  // dt32_c
              tc[i] = rnd<T>(hc[i]);                      // dt_c
            }
            vec_sum(hc, keep, c ? 7 : 5, g);
            tile_store(tDt + DIM * c, tlm, lrow, t, tc);
            frag32<P>(fr, tc);
            mma_row32<false, P>(acc, fr, sW1 + DIM * c, plane, lane, MLP + 8);  // dt_c . W1[:, c]^T
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = rnd<T>(acc[i]);  // dg
        }
        vec_sum(acc, keep, 4, g);
        ln_bwd_rows(acc, xhat1, rs1, sV + 3 * DIM, t, v);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float p = acc[i] * xhat1[i];
          acc[i] = p;
          v[i] = rnd<T>(dyv[i] + rnd<T>(v[i]));  // dx1
        }
        vec_sum(acc, keep, 3, g);
        vec_sum(v, keep, 2, g);
        tile_store(tDx1, tld, lrow, t, v);
        frag32<P>(fr, v);

        // ---- attention backward, 16 columns of hl at a time ----
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;  // dhn
        for (int jj = 0; jj < hlp / 16; ++jj) {
          float dat[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          mma_pair<false, P>(dat, fr[0], sZ, plane, WLD, 0, 16 * jj, lane);  // dx1 . Z^T
          mma_pair<false, P>(dat, fr[1], sZ, plane, WLD, 16, 16 * jj, lane);
          float at[8], s[8];
          uint32_t dl[P][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int off = (lrow + 8 * (q & 1)) * tlh + 16 * jj + 8 * (q >> 1) + 2 * t;
            const float2 u = ld_pair(tAttn + off);
            at[2 * q] = u.x;
            at[2 * q + 1] = u.y;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dat[i] = rnd<T>(dat[i]);
            s[i] = at[i] * dat[i];
          }
          group_reduce<false, PAD ? 16 : 8>(s, l);  // segsum_l over groups of l columns
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float d0 = rnd<T>(at[2 * q] * (dat[2 * q] - s[2 * q]) * SCALE);
            const float d1 = rnd<T>(at[2 * q + 1] * (dat[2 * q + 1] - s[2 * q + 1]) * SCALE);
            const int off = (lrow + 8 * (q & 1)) * tlh + 16 * jj + 8 * (q >> 1) + 2 * t;
            st_pair(tDl + off, d0, d1);
            split_pair<P>(d0, d1, dl, q);
          }
          mma_pair<false, P>(acc, dl, sA, plane, ald, 16 * jj, 0, lane);  // dl . A^T
          mma_pair<false, P>(acc + 8, dl, sA, plane, ald, 16 * jj, 16, lane);
        }
        float dxv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = rnd<T>(acc[i]);  // dhn
        vec_sum(acc, keep, 1, g);
        ln_bwd_rows(acc, xhat, rs, sV, t, dxv);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          dxv[i] = rnd<T>(v[i] + rnd<T>(dxv[i]));
          acc[i] *= xhat[i];
        }
        vec_sum(acc, keep, 0, g);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int n = p >> 1, r = p & 1;
          if (r ? ok1 : ok0)
            st_pair(dx + (xrow + 8 * r) * DIM + 8 * n + 2 * t, dxv[2 * p], dxv[2 * p + 1]);
        }
      }
      __syncthreads();

      // Weight-side sums over the tile's rows on tensor cores: 16 x 16
      // blocks of dW1 += g^T dt, dW2 += hg^T dy, dA += hn^T dl and
      // dZ += attn^T dx1, dealt to the warps in index order.
      {
        const int ksteps = (min(TILE, r_end - t0) + 15) >> 4;
        const bool first = t0 == r_begin;
        float* out = part + (static_cast<int64_t>(cta) * depth + d) * ps;
        const int nb = hlp >> 4;  // 16-column blocks of hl
        constexpr int WJ = MLP / 4;  // 16 x 16 blocks of dW1 and dW2 together
        for (int job = warp; job < WJ + 4 * nb; job += WARPS) {
          if (job < WJ) {  // dW1 [c][m], dW2 [m][c]
            if constexpr (MLP == DIM) {
              const int w = job >> 2, m0 = 16 * ((job >> 1) & 1), n0 = 16 * (job & 1);
              mma_block(out + w * NWM, DIM, DIM, DIM, w ? tHg : tG, tld, w ? tDy : tDt,
                        tld, m0, n0, ksteps, first, lane);
            } else if (job < WJ / 2) {  // dW1: 2 x MLP / 16 blocks
              mma_block(out, MLP, DIM, MLP, tG, tld, tDt, tlm, 16 * (job / (MLP / 16)),
                        16 * (job % (MLP / 16)), ksteps, first, lane);
            } else {  // dW2: MLP / 16 x 2 blocks
              const int k = job - WJ / 2;
              mma_block(out + NWM, DIM, MLP, DIM, tHg, tlm, tDy, tld, 16 * (k >> 1),
                        16 * (k & 1), ksteps, first, lane);
            }
          } else if (job < WJ + 2 * nb) {  // dA [c][j]
            const int k = job - WJ;
            mma_block(out + 2 * NWM, hl, DIM, hl, tHn, tld, tDl, tlh, 16 * (k & 1),
                      16 * (k >> 1), ksteps, first, lane);
          } else {  // dZ [j][c]
            const int k = job - WJ - 2 * nb;
            mma_block(out + 2 * NWM + n_az, DIM, hl, DIM, tAttn, tlh, tDx1, tld,
                      16 * (k >> 1), 16 * (k & 1), ksteps, first, lane);
          }
        }
      }
      __syncthreads();
    }

    float* out = part + (static_cast<int64_t>(cta) * depth + d) * ps;
    if (g < VR) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sRed[(warp * VR + g) * DIM + 8 * (i >> 1) + 2 * t + (i & 1)] = keep[i];
    }
    __syncthreads();
    for (int i = tid; i < VR * DIM; i += THREADS) {
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += sRed[w * VR * DIM + i];
      if constexpr (MLP == DIM) {
        out[2 * NWM + 2 * n_az + i] = s;
      } else {
        // dvec's row 5 is zero (b1 lies outside vecs); db1's halves are the
        // sums of rows 5 and 7.
        const int k = i >> 5, ch = i & (DIM - 1);
        if (k < 7) out[2 * NWM + 2 * n_az + i] = k == 5 ? 0.0f : s;
        if (k == 5 || k == 7) out[2 * NWM + 2 * n_az + NV + (k == 7 ? DIM : 0) + ch] = s;
      }
    }
  }
}

// Sums the partials in a fixed order: dW1, dW2, dvecs and (where MLP !=
// DIM) db1 over every CTA of every sample (fp32 out); dA and dZ over the
// CTAs of each sample, rounded to T per sample.
template <typename T, int MLP>
__global__ void decoder_stack_bwd_reduce(const float* __restrict__ part,
                                         T* __restrict__ da, T* __restrict__ dz,
                                         float* __restrict__ dw1,
                                         float* __restrict__ dw2,
                                         float* __restrict__ dvecs, int B,
                                         int cps, int depth, int hl,
                                         float* __restrict__ db1) {
  constexpr int NWM = DIM * MLP;
  constexpr int NG = 2 * NWM + NV + b1_floats<MLP>();  // per layer, summed over samples
  const int n_az = DIM * hl;
  const int64_t ps = part_size<MLP>(hl);
  const int64_t n_glob = static_cast<int64_t>(depth) * NG;
  const int64_t n_all = n_glob + static_cast<int64_t>(depth) * B * 2 * n_az;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n_all; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n_glob) {
      const int d = static_cast<int>(i / NG);
      const int e = static_cast<int>(i - static_cast<int64_t>(d) * NG);
      const int64_t off = e < 2 * NWM ? e : e + 2 * n_az;
      float s = 0.0f;
      for (int c = 0; c < B * cps; ++c)
        s += part[(static_cast<int64_t>(c) * depth + d) * ps + off];
      if (e < NWM) dw1[d * NWM + e] = s;
      else if (e < 2 * NWM) dw2[d * NWM + e - NWM] = s;
      else if (MLP == DIM || e < 2 * NWM + NV) dvecs[d * NV + e - 2 * NWM] = s;
      else db1[d * MLP + e - 2 * NWM - NV] = s;
    } else {
      const int64_t k = i - n_glob;
      const int e = static_cast<int>(k % (2 * n_az));
      const int64_t db = k / (2 * n_az);  // d * B + b
      const int d = static_cast<int>(db / B), b = static_cast<int>(db % B);
      float s = 0.0f;
      for (int c = 0; c < cps; ++c)
        s += part[(static_cast<int64_t>(b * cps + c) * depth + d) * ps + 2 * NWM + e];
      if (e < n_az) da[db * n_az + e] = from_f<T>(s);
      else dz[db * n_az + e - n_az] = from_f<T>(s);
    }
  }
}

template <typename T, int MLP, bool PAD, bool WIDE>
cudaError_t set_smem(int hl) {
  return cudaFuncSetAttribute(decoder_stack_bwd_rows_mma<T, MLP, PAD, WIDE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<T, MLP, WIDE>(hl)));
}

template <typename T, int MLP, bool PAD, bool WIDE>
int launch(const void* xsave, const void* attnsave, const void* dy,
           const void* a, const void* z, const void* w1, const void* w2,
           const void* vecs, const void* b1, void* dx, void* da, void* dz, void* dw1,
           void* dw2, void* dvecs, void* db1, void* part, int B, int N, int depth,
           int hl, int l, int rows_per_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem<T, MLP, PAD, WIDE>(hl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cps = (N + rows_per_cta - 1) / rows_per_cta;
  decoder_stack_bwd_rows_mma<T, MLP, PAD, WIDE>
      <<<dim3(cps, B), 32 * warps<WIDE>(), smem_bytes<T, MLP, WIDE>(hl), s>>>(
          static_cast<const T*>(xsave), static_cast<const T*>(attnsave),
          static_cast<const T*>(dy), static_cast<const T*>(a), static_cast<const T*>(z),
          static_cast<const T*>(w1), static_cast<const T*>(w2),
          static_cast<const float*>(vecs), static_cast<T*>(dx),
          static_cast<float*>(part), B, N, depth, hl, l, rows_per_cta,
          static_cast<const float*>(b1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_all = static_cast<int64_t>(depth) * (2 * DIM * MLP + NV + b1_floats<MLP>())
                        + static_cast<int64_t>(depth) * B * 2 * DIM * hl;
  const int64_t want = (n_all + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  decoder_stack_bwd_reduce<T, MLP><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(da), static_cast<T*>(dz),
      static_cast<float*>(dw1), static_cast<float*>(dw2),
      static_cast<float*>(dvecs), B, cps, depth, hl, static_cast<float*>(db1));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the row kernel that one SM holds at once for this hl (its
// registers and shared memory decide), written to *out: the wrapper sizes
// the grid to one full wave.
template <typename T, int MLP, bool PAD, bool WIDE>
int ctas_per_sm(int hl, int* out) {
  const cudaError_t err = set_smem<T, MLP, PAD, WIDE>(hl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, decoder_stack_bwd_rows_mma<T, MLP, PAD, WIDE>, 32 * warps<WIDE>(),
      smem_bytes<T, MLP, WIDE>(hl)));
}

// The instance for the group and hl: PAD where l = 16; WIDE (fp32 only)
// where the 64-row tiles do not fit in shared memory.
template <typename T, int MLP, bool PAD>
int launch_fit(const void* xsave, const void* attnsave, const void* dy,
               const void* a, const void* z, const void* w1, const void* w2,
               const void* vecs, const void* b1, void* dx, void* da, void* dz, void* dw1,
               void* dw2, void* dvecs, void* db1, void* part, int B, int N, int depth,
               int hl, int l, int rows_per_cta, void* stream) {
  if constexpr (pieces<T>() == 3) {
    if (needs_wide<T, MLP>(hl))
      return launch<T, MLP, PAD, true>(xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da,
                                       dz, dw1, dw2, dvecs, db1, part, B, N, depth, hl, l,
                                       rows_per_cta, stream);
  }
  return launch<T, MLP, PAD, false>(xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da,
                                    dz, dw1, dw2, dvecs, db1, part, B, N, depth, hl, l,
                                    rows_per_cta, stream);
}

template <typename T, int MLP>
int launch_group(const void* xsave, const void* attnsave, const void* dy,
                 const void* a, const void* z, const void* w1, const void* w2,
                 const void* vecs, const void* b1, void* dx, void* da, void* dz, void* dw1,
                 void* dw2, void* dvecs, void* db1, void* part, int B, int N, int depth,
                 int hl, int l, int rows_per_cta, void* stream) {
  if (l > 8)
    return launch_fit<T, MLP, true>(xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da, dz,
                                    dw1, dw2, dvecs, db1, part, B, N, depth, hl, l,
                                    rows_per_cta, stream);
  return launch_fit<T, MLP, false>(xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da, dz,
                                   dw1, dw2, dvecs, db1, part, B, N, depth, hl, l,
                                   rows_per_cta, stream);
}

template <typename T, int MLP, bool PAD>
int ctas_per_sm_fit(int hl, int* out) {
  if constexpr (pieces<T>() == 3) {
    if (needs_wide<T, MLP>(hl)) return ctas_per_sm<T, MLP, PAD, true>(hl, out);
  }
  return ctas_per_sm<T, MLP, PAD, false>(hl, out);
}

template <typename T, int MLP>
int ctas_per_sm_group(int hl, int pad, int* out) {
  return pad ? ctas_per_sm_fit<T, MLP, true>(hl, out) : ctas_per_sm_fit<T, MLP, false>(hl, out);
}

}  // namespace

// The C entries take the hidden width mlp (32 or 64) and dispatch to its
// instance; b1 and db1 are read and written only where mlp != 32.
#define DECODER_BWD_ENTRY(SUFFIX, T)                                                    \
  extern "C" int decoder_stack_bwd_##SUFFIX(                                           \
      const void* xsave, const void* attnsave, const void* dy, const void* a,          \
      const void* z, const void* w1, const void* w2, const void* vecs, const void* b1, \
      void* dx, void* da, void* dz, void* dw1, void* dw2, void* dvecs, void* db1,      \
      void* part, int B, int N, int depth, int hl, int l, int rows_per_cta, int mlp,   \
      void* stream) {                                                                  \
    if (mlp == 64)                                                                     \
      return launch_group<T, 64>(xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da,  \
                                 dz, dw1, dw2, dvecs, db1, part, B, N, depth, hl, l,   \
                                 rows_per_cta, stream);                                \
    if (mlp != DIM) return static_cast<int>(cudaErrorInvalidValue);                    \
    return launch_group<T, DIM>(xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da,   \
                                dz, dw1, dw2, dvecs, db1, part, B, N, depth, hl, l,    \
                                rows_per_cta, stream);                                 \
  }                                                                                    \
  extern "C" int decoder_stack_bwd_ctas_per_sm_##SUFFIX(int hl, int mlp, int pad,      \
                                                        int* out) {                    \
    if (mlp == 64) return ctas_per_sm_group<T, 64>(hl, pad, out);                      \
    if (mlp != DIM) return static_cast<int>(cudaErrorInvalidValue);                    \
    return ctas_per_sm_group<T, DIM>(hl, pad, out);                                    \
  }

DECODER_BWD_ENTRY(f32, float)
DECODER_BWD_ENTRY(bf16, __nv_bfloat16)
