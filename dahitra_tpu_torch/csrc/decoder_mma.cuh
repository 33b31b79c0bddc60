// Tensor-core fragment code shared by the decoder-stack kernels on mma.sync
// (decoder_fwd.cu, K1 and K1-save, and decoder_bwd.cu, K2): a warp owns 16
// token rows, each 32-wide row vector in the accumulator layout of
// mma.m16n8k16; products run as bf16 mma.sync with fp32 accumulation, an
// fp32 operand split exactly into three bf16 pieces (hi, mid, lo).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): a thread's
// accumulators of an n8 tile are rows g and g + 8, columns 2t and 2t + 1.
// A 32-wide row vector of the warp's 16 rows is float v[16], v[4n + 2r + q]
// at row g + 8r, column 8n + 2t + q; a 16-column slice of an hl-wide one is
// float c[8], c[4h + 2r + q] at row g + 8r, column 8h + 2t + q. The A
// fragment of k-step kk is then a[q] = bf16x2(v[8kk + 2q], v[8kk + 2q + 1]),
// one such word per piece.
#pragma once

#include <type_traits>

#include "decoder_common.cuh"

namespace decoder {

constexpr int WLD = DIM + 8;  // padded row of a staged 32-wide weight

__host__ __device__ __forceinline__ int pad16(int hl) { return (hl + 15) & ~15; }

// bf16 pieces of an operand: one in bf16, three (hi, mid, lo) in fp32.
template <typename T>
__host__ __device__ constexpr int pieces() {
  return std::is_same<T, float>::value ? 3 : 1;
}

// bf16 elements of one plane of staged weights: A [c][j], Z [j][c], W1
// [c][m] (rows of mlp + 8) and W2 [m][c], m over the hidden width mlp.
__host__ __device__ __forceinline__ int plane_size(int hl, int mlp = DIM) {
  const int hlp = pad16(hl);
  return DIM * (hlp + 8) + hlp * WLD + DIM * (mlp + 8) + mlp * WLD;
}

// log2 of the hidden widths the kernels are built for (32 and 64).
template <int MLP>
__host__ __device__ constexpr int mlp_shift() {
  static_assert(MLP == 32 || MLP == 64, "the kernels take mlp_dim 32 or 64");
  return MLP == 64 ? 6 : 5;
}

// Floats of b1 kept beside the seven vectors: none at MLP = DIM, where b1
// is their row 5.
template <int MLP>
__host__ __device__ constexpr int b1_floats() {
  return MLP == DIM ? 0 : MLP;
}

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two neighbouring T values as floats, and back.
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(lo_f(u), hi_f(u));
}
__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack2(x, y);
}

// The P pieces of the pair (x, y) as bf16x2 words a[p][q]: x and y rounded
// for P = 1; for P = 3 each word holds what the earlier ones left, so the
// three sum to (x, y) exactly.
template <int P, int W>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&a)[P][W], int q) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p][q] = pack2(x, y);
    if (p + 1 < P) {
      x -= lo_f(a[p][q]);
      y -= hi_f(a[p][q]);
    }
  }
}

// Splits v into the P pieces of a staged weight, one per plane.
template <int P>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int plane, float v) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat16 h = __float2bfloat16(v);
    dst[p * plane] = h;
    v -= __bfloat162float(h);
  }
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (one n8 tile) += A . B from P pieces of each: the product itself, or
// for P = 3 the six piece products down to 2^-16, small terms first.
template <int P>
__device__ __forceinline__ void mma_split(float* c, const uint32_t (&a)[P][4],
                                          const uint32_t (&b)[P][2]) {
  if constexpr (P == 1) {
    mma16816(c, a[0], b[0][0], b[0][1]);
  } else {
    mma16816(c, a[2], b[0][0], b[0][1]);  // lo . hi
    mma16816(c, a[0], b[2][0], b[2][1]);  // hi . lo
    mma16816(c, a[1], b[1][0], b[1][1]);  // mid . mid
    mma16816(c, a[1], b[0][0], b[0][1]);  // mid . hi
    mma16816(c, a[0], b[1][0], b[1][1]);  // hi . mid
    mma16816(c, a[0], b[0][0], b[0][1]);  // hi . hi
  }
}

// D += A . B for two neighbouring n8 tiles (c[0..3] at columns n0, c[4..7]
// at n0 + 8) over the k-step k0..k0+15. B lies in shared memory as P bf16
// planes `plane` elements apart, rows of ldb: k-major ([k][n], read with
// ldmatrix.trans) or n-major.
template <bool KMAJOR, int P>
__device__ __forceinline__ void mma_pair(float* c, const uint32_t (&a)[P][4],
                                         const __nv_bfloat16* sb, int plane, int ldb,
                                         int k0, int n0, int lane) {
  const __nv_bfloat16* p =
      KMAJOR ? sb + (k0 + (lane & 15)) * ldb + n0 + 8 * (lane >> 4)
             : sb + (n0 + (lane & 7) + 8 * (lane >> 4)) * ldb + k0 + 8 * ((lane >> 3) & 1);
  uint32_t b[2][P][2];
#pragma unroll
  for (int pc = 0; pc < P; ++pc) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p + pc * plane));
    if (KMAJOR)
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(b[0][pc][0]), "=r"(b[0][pc][1]), "=r"(b[1][pc][0]),
                     "=r"(b[1][pc][1])
                   : "r"(addr));
    else
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(b[0][pc][0]), "=r"(b[0][pc][1]), "=r"(b[1][pc][0]),
                     "=r"(b[1][pc][1])
                   : "r"(addr));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) mma_split<P>(c + 4 * h, a, b[h]);
}

// v (16 x 32, fragment layout) += A (16 x 32) . B (32 x 32), B's rows ldb
// apart (a 32 x 32 block of a wider staged weight, for ldb > WLD).
template <bool KMAJOR, int P>
__device__ __forceinline__ void mma_row32(float (&v)[16], const uint32_t (&a)[2][P][4],
                                          const __nv_bfloat16* sb, int plane, int lane,
                                          int ldb = WLD) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    mma_pair<KMAJOR, P>(v, a[kk], sb, plane, ldb, 16 * kk, 0, lane);
    mma_pair<KMAJOR, P>(v + 8, a[kk], sb, plane, ldb, 16 * kk, 16, lane);
  }
}

template <int P>
__device__ __forceinline__ void frag32(uint32_t (&a)[2][P][4], const float (&v)[16]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) split_pair<P>(v[8 * kk + 2 * q], v[8 * kk + 2 * q + 1], a[kk], q);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// Stores a 32-wide vector of the warp's rows to a factor tile (rows of ld).
template <typename T>
__device__ __forceinline__ void tile_store(T* tile, int ld, int row0, int t,
                                           const float (&v)[16]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = p >> 1, r = p & 1;
    st_pair(tile + (row0 + 8 * r) * ld + 8 * n + 2 * t, v[2 * p], v[2 * p + 1]);
  }
}

// Loads a 32-wide T row vector of rows (row0, row0 + 8) into fragment
// layout; a row that is not ok reads zeros.
template <typename T>
__device__ __forceinline__ void row_load(const T* src, int64_t row0, bool ok0, bool ok1,
                                         int t, float (&v)[16]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = p >> 1, r = p & 1;
    const float2 u = (r ? ok1 : ok0) ? ld_pair(src + (row0 + 8 * r) * DIM + 8 * n + 2 * t)
                                     : make_float2(0.0f, 0.0f);
    v[2 * p] = u.x;
    v[2 * p + 1] = u.y;
  }
}

}  // namespace decoder
