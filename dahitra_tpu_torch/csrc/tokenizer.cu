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
// Bound on this card: 4 * C * L FLOP against C * sizeof(T) bytes per pixel,
// ~4 FLOP per byte of x in fp32 at L = 4: bounded by bytes, and at the
// model's shapes (0.5-34 MB of x) by the latency of a launch.
//
// Design: the N pixels of a sample are split into chunks, one CTA of 128
// threads per (sample, chunk), so that the grid covers the card about twice
// and no CTA's shared memory depends on N. The softmax needs statistics over
// all N, so there are two passes:
//
//   stats_kernel  each CTA: per token the chunk maximum m_c and
//                 s_c = sum exp(l - m_c), to scratch (B, chunks, L, 2);
//   pool_kernel   prologue: every CTA combines its sample's chunk statistics
//                 in index order, M = max m_c, S = sum s_c * exp(m_c - M);
//                 then pools rnd(exp(l - M) / S) * x over its pixels into a
//                 partial (L, C), to scratch (B, chunks, L, C); the last CTA
//                 of a sample to finish (a ticket per sample) sums the
//                 partials in index order and stores the tokens as T.
//
// Split over the ranks of a row-sharded grid, each rank holding some of a
// sample's pixels, the same two kernels run through two more entry points:
// semantic_tokenizer_stats_* launches stats_kernel on the rank's pixels; the
// caller gathers every rank's statistics and lays them out (B, ranks *
// chunks, L, 2) in (rank, chunk) order; semantic_tokenizer_pool_* launches
// pool_kernel, whose prologue combines all of them in that order (every rank
// gets the same M and S bits), on the rank's pixels, and writes the rank's
// fp32 partial tokens and M and S; the caller sums the ranks' partials in
// rank order. The one-process entry points run the same code with the
// sample's own chunk statistics and store the tokens as T.
//
// M and S are global because T rounds attn after it is normalised. Both
// passes form the logits with one inlined function, so they are the same
// bits. In both, a thread owns a pixel of a 128-pixel tile: the tile of x is
// staged in shared memory with 16-byte cp.async copies, double-buffered
// along the chunk, its 16-byte granules XOR-swizzled by row so that threads
// reading different rows hit different banks; w sits in shared memory and is
// read as a broadcast. The pooling turns the layout around (a warp owns 32
// pixels, lane = channel) and reads attn from shared memory. Every sum has a
// fixed order, so two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;
constexpr int TILE = 128;  // pixels per tile = threads per CTA
constexpr int THREADS = TILE;
constexpr int WARPS = THREADS / 32;

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

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// A tile row is C values of T: G granules of 16 bytes, E values each.
// Granule g of row r sits at position g ^ sw(r). A 16-byte shared-memory
// read is served eight threads at a time, and eight consecutive rows get
// eight different bank groups.
template <typename T> struct Row;
template <> struct Row<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ int sw(int r) { return r & 7; }
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};
template <> struct Row<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ int sw(int r) { return (r >> 1) & 3; }
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// Offset of channel c of tile row r.
template <typename T> __device__ __forceinline__ int elem(int r, int c) {
  constexpr int E = Row<T>::E;
  return r * C + (((c / E) ^ Row<T>::sw(r)) * E) + (c % E);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// Start the copy of pixels [p, p + TILE) of a sample into `tile`; rows at or
// beyond p1 are zero-filled (a copy of 0 source bytes). p < p1.
template <typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* xb, int p, int p1,
                                           int tid) {
  constexpr int E = Row<T>::E, G = C / E;
  for (int i = tid; i < TILE * G; i += THREADS) {
    const int r = i / G, g = i % G;
    const bool ok = p + r < p1;
    const T* src = xb + static_cast<int64_t>(ok ? p + r : p) * C + g * E;
    cp_async16(tile + r * C + ((g ^ Row<T>::sw(r)) * E), src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 or 1) of this thread's copy groups are in
// flight.
__device__ __forceinline__ void wait_tiles(bool one_pending) {
  if (one_pending) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// w (C, L) as float into sW (C, LT), zero beyond L.
template <typename T, int LT>
__device__ __forceinline__ void load_w(float* sW, const T* w, int L, int tid) {
  for (int i = tid; i < C * LT; i += THREADS) {
    const int c = i / LT, k = i % LT;
    sW[i] = k < L ? to_f(w[c * L + k]) : 0.0f;
  }
}

// The LT logits of tile row r: fp32 FMAs over the channels in index order,
// rounded to T. Both passes call this, so their logits are the same bits.
template <typename T, int LT>
__device__ __forceinline__ void pixel_logits(const T* tile, int r, const float* sW,
                                             float (&lg)[LT]) {
  constexpr int E = Row<T>::E, G = C / E;
#pragma unroll
  for (int k = 0; k < LT; ++k) lg[k] = 0.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v[E];
    Row<T>::unpack(*reinterpret_cast<const uint4*>(
                       tile + r * C + ((g ^ Row<T>::sw(r)) * E)), v);
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int k = 0; k < LT; ++k)
        lg[k] = fmaf(v[e], sW[(g * E + e) * LT + k], lg[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < LT; ++k) lg[k] = rnd<T>(lg[k]);
}

// exp(a - b) for a <= b, 0 for a = -inf (an empty part) whatever b is.
__device__ __forceinline__ float rescale(float a, float b) {
  return a == neg_inf() ? 0.0f : expf(a - b);
}

// (m, s) <- the statistics of the union of (m, s) and (mo, so); symmetric in
// its two parts to the bit.
__device__ __forceinline__ void merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  s = __fadd_rn(__fmul_rn(s, rescale(m, mn)), __fmul_rn(so, rescale(mo, mn)));
  m = mn;
}

template <typename T, int LT>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
             float* __restrict__ stats, int* __restrict__ ticket, int N, int L,
             int chunk, int n_chunks) {
  __shared__ __align__(16) T sX[2][TILE * C];
  __shared__ float sW[C * LT];
  __shared__ float sRed[WARPS][LT][2];

  const int b = blockIdx.x / n_chunks, ch = blockIdx.x % n_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = ch * chunk, p1 = min(N, p0 + chunk);
  const int n_tiles = (p1 - p0 + TILE - 1) / TILE;
  const T* xb = x + static_cast<int64_t>(b) * N * C;

  stage_tile(sX[0], xb, p0, p1, tid);
  if (ch == 0 && tid == 0) ticket[b] = 0;  // pool_kernel counts from 0
  load_w<T, LT>(sW, w, L, tid);

  // Each thread's running maximum and sum over its own pixels.
  float m[LT], s[LT];
#pragma unroll
  for (int k = 0; k < LT; ++k) { m[k] = neg_inf(); s[k] = 0.0f; }
  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    if (more) stage_tile(sX[(t + 1) & 1], xb, p0 + (t + 1) * TILE, p1, tid);
    wait_tiles(more);
    __syncthreads();
    if (p0 + t * TILE + tid < p1) {
      float lg[LT];
      pixel_logits<T, LT>(sX[t & 1], tid, sW, lg);
#pragma unroll
      for (int k = 0; k < LT; ++k) {
        if (lg[k] <= m[k]) {
          s[k] += expf(lg[k] - m[k]);
        } else {
          s[k] = s[k] * expf(m[k] - lg[k]) + 1.0f;
          m[k] = lg[k];
        }
      }
    }
    __syncthreads();  // the buffer is free for the copy after next
  }

  // Threads -> warp (butterfly) -> CTA (warps in index order).
#pragma unroll
  for (int k = 0; k < LT; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[k], o);
      const float so = __shfl_xor_sync(0xffffffffu, s[k], o);
      merge(m[k], s[k], mo, so);
    }
    if (lane == 0) { sRed[warp][k][0] = m[k]; sRed[warp][k][1] = s[k]; }
  }
  __syncthreads();
  if (tid < L) {
    float mm = sRed[0][tid][0], ss = sRed[0][tid][1];
    for (int v = 1; v < WARPS; ++v) merge(mm, ss, sRed[v][tid][0], sRed[v][tid][1]);
    float* dst = stats + (static_cast<int64_t>(blockIdx.x) * L + tid) * 2;
    dst[0] = mm;
    dst[1] = ss;
  }
}

// Sum a sample's partial tokens over its chunks in index order; store as
// OutT (T, or float for a rank's partial tokens). The loads bypass L1: other
// CTAs of this launch may have written `part`.
template <typename OutT>
__device__ __forceinline__ void sum_partials(const float* part, OutT* out, int b,
                                             int n_chunks, int L, int tid) {
  const float* pb = part + static_cast<int64_t>(b) * n_chunks * L * C;
  for (int i = tid; i < L * C; i += THREADS) {
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s += __ldcg(pb + c * L * C + i);
    out[static_cast<int64_t>(b) * L * C + i] = from_f<OutT>(s);
  }
}

// stats: (B, n_stat, L, 2), combined in index order; ms (nullable): the
// combined (B, L, 2), written by each sample's first CTA.
template <typename T, int LT, typename OutT>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ stats, int n_stat, float* part,
            int* ticket, OutT* out, float* ms, int N, int L, int chunk,
            int n_chunks) {
  __shared__ __align__(16) T sX[2][TILE * C];
  __shared__ float sW[C * LT];
  // (LT, TILE) attention of the tile; later the (WARPS, LT, C) warp partials.
  __shared__ float sAttn[LT * TILE];
  __shared__ float sM[LT];
  __shared__ float sS[LT];
  __shared__ int sLast;
  static_assert(TILE == WARPS * C, "the warp partials reuse sAttn");

  const int b = blockIdx.x / n_chunks, ch = blockIdx.x % n_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = ch * chunk, p1 = min(N, p0 + chunk);
  const int n_tiles = (p1 - p0 + TILE - 1) / TILE;
  const T* xb = x + static_cast<int64_t>(b) * N * C;

  stage_tile(sX[0], xb, p0, p1, tid);
  load_w<T, LT>(sW, w, L, tid);
  // The sample's M and S from its statistics, in index order; every CTA of
  // the sample gets the same bits.
  if (tid < L) {
    const float* st = stats + (static_cast<int64_t>(b) * n_stat * L + tid) * 2;
    float mm = neg_inf();
    for (int c = 0; c < n_stat; ++c) mm = fmaxf(mm, st[c * L * 2]);
    float ss = 0.0f;
    for (int c = 0; c < n_stat; ++c)
      ss = fmaf(st[c * L * 2 + 1], rescale(st[c * L * 2], mm), ss);
    sM[tid] = mm;
    sS[tid] = ss;
    if (ms != nullptr && ch == 0) {
      ms[(static_cast<int64_t>(b) * L + tid) * 2] = mm;
      ms[(static_cast<int64_t>(b) * L + tid) * 2 + 1] = ss;
    }
  }

  float acc[LT];
#pragma unroll
  for (int k = 0; k < LT; ++k) acc[k] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    if (more) stage_tile(sX[(t + 1) & 1], xb, p0 + (t + 1) * TILE, p1, tid);
    wait_tiles(more);
    __syncthreads();  // the tile; at t = 0 also sW, sM, sS
    const T* tile = sX[t & 1];
    {
      // thread = pixel: its attention, 0 beyond the chunk's end
      const bool live = p0 + t * TILE + tid < p1;
      float lg[LT];
      pixel_logits<T, LT>(tile, tid, sW, lg);
#pragma unroll
      for (int k = 0; k < LT; ++k) {
        if (k < L)
          sAttn[k * TILE + tid] =
              live ? rnd<T>(expf(lg[k] - sM[k]) / sS[k]) : 0.0f;
      }
    }
    __syncthreads();
    // warp = 32 pixels, lane = channel
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int r = warp * 32 + j;
      const float xv = to_f(tile[elem<T>(r, lane)]);
#pragma unroll
      for (int k = 0; k < LT; ++k) {
        if (k < L) acc[k] = fmaf(sAttn[k * TILE + r], xv, acc[k]);
      }
    }
    __syncthreads();  // sAttn and the buffer are free again
  }

  // Warps in index order -> this chunk's partial tokens.
#pragma unroll
  for (int k = 0; k < LT; ++k) {
    if (k < L) sAttn[(warp * LT + k) * C + lane] = acc[k];
  }
  __syncthreads();
  for (int i = tid; i < L * C; i += THREADS) {
    const int k = i / C, c = i % C;
    float s = 0.0f;
    for (int v = 0; v < WARPS; ++v) s += sAttn[(v * LT + k) * C + c];
    part[static_cast<int64_t>(blockIdx.x) * L * C + i] = s;
  }

  // The last CTA of the sample to get here sums the partials.
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(ticket + b, 1) == n_chunks - 1;
  __syncthreads();
  if (sLast) {
    __threadfence();
    sum_partials<OutT>(part, out, b, n_chunks, L, tid);
  }
}

// The scratch of one call: the chunk statistics (B, n_chunks, L, 2), the
// partial tokens (B, n_chunks, L, C) and a ticket per sample.
struct Scratch {
  float* stats;
  float* part;
  int* ticket;
  Scratch(void* scratch, int64_t ctas, int L) {
    stats = static_cast<float*>(scratch);
    part = stats + ctas * L * 2;
    ticket = reinterpret_cast<int*>(part + ctas * L * C);
  }
};

// What a launch does: the statistics, the pool, or both (one process).
enum Pass { STATS = 1, POOL = 2 };

// stats: the pool's statistics (B, n_stat, L, 2); null in the one-process
// call, which pools with its own chunks' statistics and stores T.
template <typename T, int LT, typename OutT>
int launch_lt(const T* x, const T* w, OutT* out, void* scratch,
              const float* stats, int n_stat, float* ms, int B, int N, int L,
              int chunk, int passes, cudaStream_t stream) {
  const int n_chunks = (N + chunk - 1) / chunk;
  const int64_t ctas = static_cast<int64_t>(B) * n_chunks;
  const Scratch sc(scratch, ctas, L);
  const unsigned grid = static_cast<unsigned>(ctas);
  if (passes & STATS) {
    stats_kernel<T, LT><<<grid, THREADS, 0, stream>>>(x, w, sc.stats, sc.ticket,
                                                      N, L, chunk, n_chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & POOL) {
    if (stats == nullptr) {
      stats = sc.stats;
      n_stat = n_chunks;
    }
    pool_kernel<T, LT, OutT><<<grid, THREADS, 0, stream>>>(
        x, w, stats, n_stat, sc.part, sc.ticket, out, ms, N, L, chunk,
        n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT>
int launch(const void* x, const void* w, void* out, void* scratch,
           const void* stats, int n_stat, void* ms, int B, int N, int L,
           int chunk, int passes, void* stream) {
  if (B < 1 || N < 1 || L < 1 || L > 16 || chunk < TILE || chunk % TILE ||
      (stats != nullptr && n_stat < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  OutT* ot = static_cast<OutT*>(out);
  const float* st = static_cast<const float*>(stats);
  float* m = static_cast<float*>(ms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L <= 4 ? launch_lt<T, 4, OutT>(xt, wt, ot, scratch, st, n_stat, m, B, N,
                                        L, chunk, passes, s)
                : launch_lt<T, 16, OutT>(xt, wt, ot, scratch, st, n_stat, m, B,
                                         N, L, chunk, passes, s);
}

}  // namespace

// scratch: 4 * (B * n_chunks * L * (2 + C) + B) bytes, n_chunks =
// ceil(N / chunk); chunk a multiple of 128.
extern "C" int semantic_tokenizer_f32(const void* x, const void* w, void* out,
                                      void* scratch, int B, int N, int L,
                                      int chunk, void* stream) {
  return launch<float, float>(x, w, out, scratch, nullptr, 0, nullptr, B, N, L,
                              chunk, STATS | POOL, stream);
}

extern "C" int semantic_tokenizer_bf16(const void* x, const void* w, void* out,
                                       void* scratch, int B, int N, int L,
                                       int chunk, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, scratch, nullptr, 0,
                                              nullptr, B, N, L, chunk,
                                              STATS | POOL, stream);
}

// A rank's pixels, first pass: its chunks' statistics, at the start of
// scratch ((B, n_chunks, L, 2) fp32); scratch as above.
extern "C" int semantic_tokenizer_stats_f32(const void* x, const void* w,
                                            void* scratch, int B, int N, int L,
                                            int chunk, void* stream) {
  return launch<float, float>(x, w, nullptr, scratch, nullptr, 0, nullptr, B, N,
                              L, chunk, STATS, stream);
}

extern "C" int semantic_tokenizer_stats_bf16(const void* x, const void* w,
                                             void* scratch, int B, int N, int L,
                                             int chunk, void* stream) {
  return launch<__nv_bfloat16, float>(x, w, nullptr, scratch, nullptr, 0,
                                      nullptr, B, N, L, chunk, STATS, stream);
}

// Second pass, after the statistics pass on the same scratch: every rank's
// statistics (B, n_stat, L, 2) in (rank, chunk) order combined, the rank's
// fp32 partial tokens (B, L, C) into `part`, the combined M and S into ms
// (B, L, 2).
extern "C" int semantic_tokenizer_pool_f32(const void* x, const void* w,
                                           const void* stats, int n_stat,
                                           void* part, void* ms, void* scratch,
                                           int B, int N, int L, int chunk,
                                           void* stream) {
  return launch<float, float>(x, w, part, scratch, stats, n_stat, ms, B, N, L,
                              chunk, POOL, stream);
}

extern "C" int semantic_tokenizer_pool_bf16(const void* x, const void* w,
                                            const void* stats, int n_stat,
                                            void* part, void* ms, void* scratch,
                                            int B, int N, int L, int chunk,
                                            void* stream) {
  return launch<__nv_bfloat16, float>(x, w, part, scratch, stats, n_stat, ms, B,
                                      N, L, chunk, POOL, stream);
}
