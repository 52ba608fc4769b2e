// Zipformer2 rel-pos attention scores for Hopper (sm_90a), float32 (B3), on
// float32 tensors, and the two-pass route of both dtypes.
//
// Replaces relpos_scores_pallas (audiojax/ops/attention_pallas.py:195, its
// kernel _relpos_kernel :161) with the contract of relpos_scores_jnp (:142),
// the function the model runs:
//
//   out[n, h, i, j] = softmax_j( q[n, i, h, :] . k[n, j, h, :]
//                                + sum_p pp[n, i, h, p] * pe[h, p, i, j] )
//
// q and k are (N, S, H*D) and pp is (N, S, H*pstride) with each head's slot
// holding P <= pstride positional terms; all three may be lane slices of one
// projection, so each comes with its own row stride (floats) and no copy is
// made.  pe (H, P, S, S) and out (N, H, S, S) are contiguous.  Everything is
// true float32: pe is not rounded (the Pallas kernel rounds it to bf16), the
// probabilities are written in float32, and the softmax subtracts its row
// maximum, as jax.nn.softmax does, and scales by one reciprocal of the row sum.
//
// What bounds it: bytes, mostly the output.  At ZipEnhancer's (964, 101) the
// probabilities are 157 MB and q, k and pp's P used terms 106 MB, 0.079 ms
// at 3.35 TB/s; at (404, 241) 375 MB of probabilities, 0.145 ms; the
// operations, ~2D + 2P + 5 a probability, take less.  The first design read
// P values of pe from L2 for every probability (~1.5 GB through L2 a call at
// (404, 241), three times the byte bound's traffic) because no block shared
// pe rows across n.
//
// Design (relpos_batched_kernel, rows of at most 256 keys).  A block of R/4
// warps owns (h, R query rows, a range of nb batch rows n).  It copies
// pe[h, :, rows, :] (P*R*S floats) into shared memory once and loops over its
// n.  For each n it stages that n's keys (S x D, row stride round_up(D, 8) + 4
// floats, so that a lane's 16-byte reads of keys lane + 32t meet no bank
// conflict), its R query rows and their P positional terms, by cp.async into
// one of two buffers while the other one computes: the next n's copies
// overlap this n's arithmetic.  Each warp forms the scores of its 4 rows
// against NJ keys a lane (j = lane + 32t): a float4 of q (broadcast) and one
// of k feed 16 FMAs a key, in the order d = 0, 1, ...; the positional bias
// (pe from shared memory, lanes on neighbouring j) is formed apart and added,
// as in the first design.  The row's maximum and sum go by warp shuffles,
// expf is kept, and the probabilities are e * (1 / sum), one reciprocal a
// row, written with neighbouring lanes on neighbouring j (a row starts at a
// 4*S-byte offset, 16-byte aligned only where S % 4 == 0, so the stores are
// scalar; 32 lanes still fill 128-byte segments) and marked evict-first, so
// that the output stream does not push pe and the keys out of L2.
//
// The count at the chosen points (ops/attention_cuda.py:relpos_launch
// computes the same shared-memory bytes).  Floats of pe and keys through L2 a
// probability: P / nb + D / R (q and pp add (D + P) / S, reads that the byte
// bound counts too).  (404, 241): R 32, nb 101 (8 row tiles x 4 heads x 4
// batch ranges = 128 blocks, one an SM), shared memory pe 131.1 KB + 2 x 42.0
// KB = 215.0 KB, 8 warps an SM; 1.04 floats a probability, against ~4.3 in
// the first design.  (964, 101): R 16, nb 69 (7 x 4 x 14 = 392 blocks, three an
// SM), 32.8 + 2 x 21.0 = 74.8 KB, 12 warps an SM; 2.06 floats a probability
// (R 28 read 1.21 but was 7 % slower in attention_geometry_sweep.py: the
// keys come from L2 at this size, and more, smaller blocks hide more latency).
//
// Rows of more than 256 keys take relpos_tiled_kernel, the first design's
// two-pass route (no served shape has them): a running maximum and sum over
// 256-key tiles, then the write, with the scores recomputed in the same order
// and pe read from L2.
//
// bfloat16 (the bf16 serving plan, the Pallas kernel's own dtypes: its pe is
// bf16, attention_pallas.py:208, and its probabilities are written in q's
// dtype by default, :205): rows of at most 256 keys run on the tensor cores
// (relpos_scores_bf16.cu); the two-pass route takes the rest (longer rows,
// and the shapes that kernel does not take: ops/attention_cuda.py:
// relpos_mma_route), with q, k, pp, pe and out bf16, the float32 arithmetic
// above between (the bf16 products exact in f32, the softmax with its row
// maximum in f32), and each probability rounded once to bf16, to nearest
// even.
//
// The launchers take the geometry from the host, check it, and return
// cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

// A read-only load through the texture path, widened to f32.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(&p->u) << 16);
}

// An output store (bf16: rounded); _cs: evict-first, for the output stream.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { p->u = (unsigned short)bf16_bits(v); }
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }

// ── the two-pass route (the first design), for rows of more than 256 keys ──

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                   // query rows per warp
constexpr int kGroup = kWarps * kRows;     // query rows per block step
constexpr int kMaxNJ = 8;                  // keys per lane in one pass: S <= 256

template <class E>
struct Args {
  const E* q;
  const E* k;
  const E* pp;
  const E* pe;
  E* out;
  long long ldq, ldk, ldpp;  // row strides, in elements
  int S, H, D, P, pstride;
  int chunks;                // row ranges per (n, h)
  int groups_per_chunk;      // 32-row groups per row range
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory floats of the transposed key tile, rounded up to a float4.
__host__ __device__ constexpr int keys_floats(int nj, int d) {
  return (d * (32 * nj + 1) + 3) / 4 * 4;
}

// Keys [j0, j0 + 32*NJ) of this head into kt[d * (32*NJ + 1) + j], zero past S.
template <int NJ, class E>
__device__ __forceinline__ void load_keys(const E* __restrict__ kn, long long ldk, int S, int D,
                                          int j0, float* kt) {
  constexpr int kTile = 32 * NJ, kKS = kTile + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    kt[d * kKS + j] = (j0 + j < S) ? widen(kn[(size_t)(j0 + j) * ldk + d]) : 0.f;
  }
}

// This warp's query rows i0 .. i0+3 into qw[d*4 + r] and their positional
// terms into pw[p*4 + r], zero past S.
template <class E>
__device__ __forceinline__ void load_rows(const Args<E>& a, const E* __restrict__ qn,
                                          const E* __restrict__ pn, int i0, int lane, float* qw,
                                          float* pw) {
  __syncwarp();  // the previous rows are no longer read
  for (int e = lane; e < kRows * a.D; e += 32) {
    const int r = e / a.D, d = e - r * a.D;
    qw[d * kRows + r] = (i0 + r < a.S) ? widen(qn[(size_t)(i0 + r) * a.ldq + d]) : 0.f;
  }
  for (int e = lane; e < kRows * a.P; e += 32) {
    const int r = e / a.P, p = e - r * a.P;
    pw[p * kRows + r] = (i0 + r < a.S) ? widen(pn[(size_t)(i0 + r) * a.ldpp + p]) : 0.f;
  }
  __syncwarp();
}

// Scores of rows i0 + r against keys j0 + 32 t + lane; -inf past S.
template <int NJ, class E>
__device__ __forceinline__ void scores(const Args<E>& a, const float* kt, const float* qw,
                                       const float* pw, const E* __restrict__ peh, int i0,
                                       int j0, int lane, float (&acc)[kRows][NJ]) {
  constexpr int kKS = 32 * NJ + 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < NJ; ++t) acc[r][t] = 0.f;
#pragma unroll 4
  for (int d = 0; d < a.D; ++d) {
    const float4 q4 = *reinterpret_cast<const float4*>(qw + d * kRows);
    const float qv[kRows] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      const float kv = kt[d * kKS + t * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][t] = fmaf(qv[r], kv, acc[r][t]);
    }
  }
  // positional bias sum_p pp * pe, formed apart and then added.  The loads
  // of one row go out together (NJ per term, P terms unrolled by 4), so the
  // warp waits on L2 about once a row, not once a load.
  const size_t plane = (size_t)a.S * a.S;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(i0 + r, a.S - 1);  // rows past S are computed, never written
    const E* pei = peh + (size_t)i * a.S + j0 + lane;
    const int valid = a.S - j0 - lane;  // t * 32 < valid: key j0 + t*32 + lane exists
    float b[NJ];
#pragma unroll
    for (int t = 0; t < NJ; ++t) b[t] = 0.f;
#pragma unroll 4
    for (int p = 0; p < a.P; ++p) {
      const float w = pw[p * kRows + r];
      float v[NJ];
#pragma unroll
      for (int t = 0; t < NJ; ++t) v[t] = t * 32 < valid ? ldg_f(pei + p * plane + t * 32) : 0.f;
#pragma unroll
      for (int t = 0; t < NJ; ++t) b[t] = fmaf(w, v[t], b[t]);
    }
#pragma unroll
    for (int t = 0; t < NJ; ++t) acc[r][t] = t * 32 < valid ? acc[r][t] + b[t] : -INFINITY;
  }
}

template <class E>
struct Head {
  const E* kn;
  const E* qn;
  const E* pn;
  const E* peh;
  E* on;
  int row0, row_end;  // this block's query rows
};

template <class E>
__device__ __forceinline__ Head<E> locate(const Args<E>& a) {
  const int chunk = blockIdx.x % a.chunks;
  const int nh = blockIdx.x / a.chunks;
  const int h = nh % a.H, n = nh / a.H;
  Head<E> hd;
  hd.kn = a.k + (size_t)n * a.S * a.ldk + (size_t)h * a.D;
  hd.qn = a.q + (size_t)n * a.S * a.ldq + (size_t)h * a.D;
  hd.pn = a.pp + (size_t)n * a.S * a.ldpp + (size_t)h * a.pstride;
  hd.peh = a.pe + (size_t)h * a.P * a.S * a.S;
  hd.on = a.out + (size_t)nh * a.S * a.S;
  hd.row0 = chunk * a.groups_per_chunk * kGroup;
  hd.row_end = min(a.S, hd.row0 + a.groups_per_chunk * kGroup);
  return hd;
}

// Two passes over 256-key tiles, for rows longer than 256 keys.
template <class E>
__global__ void __launch_bounds__(kThreads, 2) relpos_tiled_kernel(const Args<E> a) {
  constexpr int NJ = kMaxNJ, kTile = 32 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* kt = smem;
  float* qw = smem + keys_floats(NJ, a.D) + warp * kRows * (a.D + a.P);
  float* pw = qw + kRows * a.D;
  const Head<E> hd = locate(a);

  for (int g = hd.row0; g < hd.row_end; g += kGroup) {
    const int i0 = g + warp * kRows;
    const bool active = i0 < hd.row_end;  // warp-uniform; every warp meets the barriers
    if (active) load_rows(a, hd.qn, hd.pn, i0, lane, qw, pw);
    float acc[kRows][NJ];

    // pass 1: running maximum and sum of each lane's share of each row
    float m[kRows], s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -INFINITY;
      s[r] = 0.f;
    }
    for (int j0 = 0; j0 < a.S; j0 += kTile) {
      __syncthreads();  // the previous tile is no longer read
      load_keys<NJ>(hd.kn, a.ldk, a.S, a.D, j0, kt);
      __syncthreads();
      if (!active) continue;
      scores<NJ>(a, kt, qw, pw, hd.peh, i0, j0, lane, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float mt = acc[r][0];
#pragma unroll
        for (int t = 1; t < NJ; ++t) mt = fmaxf(mt, acc[r][t]);
        const float mn = fmaxf(m[r], mt);
        if (mn == -INFINITY) continue;  // no key of this lane yet
        float st = 0.f;
#pragma unroll
        for (int t = 0; t < NJ; ++t) st += expf(acc[r][t] - mn);
        s[r] = s[r] * expf(m[r] - mn) + st;
        m[r] = mn;
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float mw = warp_max(m[r]);
        s[r] = warp_sum(m[r] == -INFINITY ? 0.f : s[r] * expf(m[r] - mw));
        m[r] = mw;
      }
    }

    // pass 2: the same scores again, written as probabilities
    for (int j0 = 0; j0 < a.S; j0 += kTile) {
      __syncthreads();
      load_keys<NJ>(hd.kn, a.ldk, a.S, a.D, j0, kt);
      __syncthreads();
      if (!active) continue;
      scores<NJ>(a, kt, qw, pw, hd.peh, i0, j0, lane, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i >= hd.row_end) break;
        E* orow = hd.on + (size_t)i * a.S;
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          const int j = j0 + t * 32 + lane;
          if (j < a.S) store(orow + j, expf(acc[r][t] - m[r]) / s[r]);
        }
      }
    }
  }
}

// ── the batched one-pass route (S <= 256) ──────────────────────────────────

template <class E>
struct Batched {
  const E* q;
  const E* k;
  const E* pp;
  const E* pe;
  E* out;
  long long ldq, ldk, ldpp;  // row strides, in elements
  int N, S, H, D, P, pstride;
  int R;          // query rows per block, a multiple of 4 (R / 4 warps)
  int row_tiles;  // ceil(S / R)
  int nb;         // batch rows per block
  int chunks;     // ceil(N / nb)
  int ds;         // row stride of staged q and k rows: round_up(D, 8) + 4
  int vec;        // q and k copied 4 elements at a time (D % 4 == 0, aligned rows)
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Bytes of one staging buffer of E: keys (32 NJ rows), R query rows (row
// stride round_up(D, 8) + 4 elements), R x P terms; a multiple of 16.
__host__ __device__ constexpr size_t batched_buffer_bytes(int nj, int r, int d, int p,
                                                          int esize) {
  return ((size_t)((32 * nj + r) * (round_up(d, 8) + 4) + r * p) * esize + 15) / 16 * 16;
}

// Shared-memory bytes: pe[h, :, rows, :] in f32 (row stride 32 NJ), two buffers.
__host__ __device__ constexpr size_t batched_bytes(int nj, int r, int d, int p, int esize) {
  return (size_t)p * r * 32 * nj * 4 + 2 * batched_buffer_bytes(nj, r, d, p, esize);
}

// 4 or 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// 4 consecutive floats, or one, asynchronously.
__device__ __forceinline__ void cp_async_4e(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void copy1(float* dst, const float* src) { cp_async4(dst, src); }

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f(r, c) for every cell of a rows x cols grid, spread over the block's
// threads, with no division a cell.
template <typename F>
__device__ __forceinline__ void grid_for(int rows, int cols, F&& f) {
  const int step = blockDim.x, dr = step / cols, dc = step - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Batch row n's keys, the block's query rows and their positional terms into
// buf (keys [32 NJ][ds], then q [R][ds], then pp [R][P], all of E); rows past
// S are not copied (the zeros written at the start stay).
template <int NJ, class E>
__device__ __forceinline__ void stage_batch_row(const Batched<E>& a, int n, int h, int row0,
                                                E* buf) {
  E* ks = buf;
  E* qs = ks + 32 * NJ * a.ds;
  E* ps = qs + a.R * a.ds;
  const E* kn = a.k + (size_t)n * a.S * a.ldk + (size_t)h * a.D;
  const E* qn = a.q + ((size_t)n * a.S + row0) * a.ldq + (size_t)h * a.D;
  const E* pn = a.pp + ((size_t)n * a.S + row0) * a.ldpp + (size_t)h * a.pstride;
  const int rows = min(a.R, a.S - row0);
  if (a.vec) {
    grid_for(a.S, a.D / 4, [&](int r, int c) {
      cp_async_4e(ks + r * a.ds + 4 * c, kn + r * a.ldk + 4 * c);
    });
    grid_for(rows, a.D / 4, [&](int r, int c) {
      cp_async_4e(qs + r * a.ds + 4 * c, qn + r * a.ldq + 4 * c);
    });
  } else {
    grid_for(a.S, a.D, [&](int r, int c) { copy1(ks + r * a.ds + c, kn + r * a.ldk + c); });
    grid_for(rows, a.D, [&](int r, int c) { copy1(qs + r * a.ds + c, qn + r * a.ldq + c); });
  }
  grid_for(rows, a.P, [&](int r, int c) { copy1(ps + r * a.P + c, pn + r * a.ldpp + c); });
}

// pe[h, :, rows, :] into the f32 table pes[P][R][kSP], by 4-byte cp.async.
template <int NJ, class E>
__device__ __forceinline__ void stage_pe(const Batched<E>& a, const E* peh, int nrows,
                                         float* pes) {
  constexpr int kSP = 32 * NJ;
  grid_for(a.P * nrows, a.S, [&](int pr, int j) {
    const int p = pr / nrows, r = pr - p * nrows;
    cp_async4(pes + ((size_t)p * a.R + r) * kSP + j, peh + ((size_t)p * a.S + r) * a.S + j);
  });
}

template <int NJ, class E>
__global__ void __launch_bounds__(256, 1) relpos_batched_kernel(const Batched<E> a) {
  constexpr int kSP = 32 * NJ;  // row stride of the staged pe rows; keys a buffer
  extern __shared__ __align__(16) float smem[];
  const size_t buf_elems =
      batched_buffer_bytes(NJ, a.R, a.D, a.P, (int)sizeof(E)) / sizeof(E);
  float* pes = smem;  // [P][R][kSP], f32
  E* bufs = reinterpret_cast<E*>(smem + (size_t)a.P * a.R * kSP);

  int b = blockIdx.x;
  const int chunk = b % a.chunks;
  b /= a.chunks;
  const int row0 = (b % a.row_tiles) * a.R, h = b / a.row_tiles;
  const int row_end = min(a.S, row0 + a.R);
  const int n_lo = chunk * a.nb, n_hi = min(a.N, n_lo + a.nb);
  if (n_lo >= n_hi) return;  // whole block: no barrier is skipped by part of it

  // zeros where no copy lands (keys past S, feature pads, rows past S), then
  // this head's pe rows (once) and the first batch row
  const size_t total = batched_bytes(NJ, a.R, a.D, a.P, (int)sizeof(E)) / 4;
  for (size_t e = threadIdx.x; e < total; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();
  stage_pe<NJ>(a, a.pe + ((size_t)h * a.P * a.S + row0) * a.S, row_end - row0, pes);
  stage_batch_row<NJ>(a, n_lo, h, row0, bufs);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 4, i0 = row0 + r0;  // this warp's 4 rows
  const int d4 = round_up(a.D, 4);
  for (int n = n_lo; n < n_hi; ++n) {
    const int cur = (n - n_lo) & 1;
    if (n + 1 < n_hi) {
      stage_batch_row<NJ>(a, n + 1, h, row0, bufs + (cur ^ 1) * buf_elems);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (i0 < row_end) {  // warp-uniform
      const E* ks = bufs + cur * buf_elems;
      const E* qs = ks + kSP * a.ds;
      const E* ps = qs + a.R * a.ds;
      float acc[4][NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < NJ; ++t) acc[r][t] = 0.f;
#pragma unroll 2
      for (int d = 0; d < d4; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = ld4(qs + (r0 + r) * a.ds + d);
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          const float4 kv = ld4(ks + (t * 32 + lane) * a.ds + d);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][t] = fmaf(qv[r].x, kv.x, acc[r][t]);
            acc[r][t] = fmaf(qv[r].y, kv.y, acc[r][t]);
            acc[r][t] = fmaf(qv[r].z, kv.z, acc[r][t]);
            acc[r][t] = fmaf(qv[r].w, kv.w, acc[r][t]);
          }
        }
      }
      // positional bias sum_p pp * pe, formed apart and then added; the four
      // rows go together through every step below, so that their shuffle
      // chains and exponentials overlap
      float bias[4][NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < NJ; ++t) bias[r][t] = 0.f;
#pragma unroll 4
      for (int p = 0; p < a.P; ++p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float w = widen(ps[(r0 + r) * a.P + p]);
          const float* pe_r = pes + ((size_t)p * a.R + r0 + r) * kSP + lane;
#pragma unroll
          for (int t = 0; t < NJ; ++t) bias[r][t] = fmaf(w, pe_r[t * 32], bias[r][t]);
        }
      }
      float m[4], sum[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m[r] = -INFINITY;
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          acc[r][t] = t * 32 + lane < a.S ? acc[r][t] + bias[r][t] : -INFINITY;
          m[r] = fmaxf(m[r], acc[r][t]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum[r] = 0.f;
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          acc[r][t] = expf(acc[r][t] - m[r]);  // 0 past S
          sum[r] += acc[r][t];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i >= row_end) break;
        const float inv = 1.f / sum[r];
        E* orow = a.out + (((size_t)n * a.H + h) * a.S + i) * a.S;
#pragma unroll
        for (int t = 0; t < NJ; ++t)
          if (t * 32 + lane < a.S) store_cs(orow + t * 32 + lane, acc[r][t] * inv);
      }
    }
    __syncthreads();  // the next copy overwrites this buffer
  }
}

template <typename Kernel, typename A>
cudaError_t launch(Kernel kernel, const A& a, long long blocks, int threads, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool bad_common(int n, int s, int h, int d, int p, int pstride, long long ldq, long long ldk,
                long long ldpp) {
  return n <= 0 || s <= 0 || h <= 0 || d <= 0 || p <= 0 || p > pstride ||
         ldq < (long long)h * d || ldk < (long long)h * d || ldpp < (long long)h * pstride;
}

}  // namespace

extern "C" {

const char* ajt_relpos_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

namespace {

template <class E>
int relpos_batched(const void* q, const void* k, const void* pp, const void* pe, void* out,
                   int n, int s, int h, int d, int p, int pstride, long long ldq, long long ldk,
                   long long ldpp, int nj, int rows, int nb, long long smem, void* stream) {
  if (bad_common(n, s, h, d, p, pstride, ldq, ldk, ldpp)) return (int)cudaErrorInvalidValue;
  if ((nj != 1 && nj != 2 && nj != 4 && nj != 8) || 32 * nj < s || rows < 4 || rows > 32 ||
      rows % 4 || nb < 1 || smem < (long long)batched_bytes(nj, rows, d, p, (int)sizeof(E)))
    return (int)cudaErrorInvalidConfiguration;
  Batched<E> a{static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(pp),
               static_cast<const E*>(pe), static_cast<E*>(out), ldq, ldk, ldpp, n, s, h, d, p,
               pstride, rows, (s + rows - 1) / rows, nb, (n + nb - 1) / nb,
               round_up(d, 8) + 4, 0};
  a.vec = d % 4 == 0 && ldq % 4 == 0 && ldk % 4 == 0 &&
          ((uintptr_t)q | (uintptr_t)k) % (4 * sizeof(E)) == 0;
  const long long blocks = (long long)h * a.row_tiles * a.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 8 * rows;
  switch (nj) {
    case 1: return (int)launch(relpos_batched_kernel<1, E>, a, blocks, threads, (size_t)smem, st);
    case 2: return (int)launch(relpos_batched_kernel<2, E>, a, blocks, threads, (size_t)smem, st);
    case 4: return (int)launch(relpos_batched_kernel<4, E>, a, blocks, threads, (size_t)smem, st);
    default:
      return (int)launch(relpos_batched_kernel<8, E>, a, blocks, threads, (size_t)smem, st);
  }
}

template <class E>
int relpos_two_pass(const void* q, const void* k, const void* pp, const void* pe, void* out,
                    int n, int s, int h, int d, int p, int pstride, long long ldq, long long ldk,
                    long long ldpp, int groups_per_chunk, long long smem, void* stream) {
  if (bad_common(n, s, h, d, p, pstride, ldq, ldk, ldpp)) return (int)cudaErrorInvalidValue;
  const size_t need = ((size_t)keys_floats(kMaxNJ, d) + (size_t)kWarps * kRows * (d + p)) *
                      sizeof(float);
  if (groups_per_chunk < 1 || smem < (long long)need) return (int)cudaErrorInvalidConfiguration;
  Args<E> a{static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(pp),
            static_cast<const E*>(pe), static_cast<E*>(out), ldq, ldk, ldpp, s, h, d, p,
            pstride, 1, groups_per_chunk};
  const int groups = (s + kGroup - 1) / kGroup;
  a.chunks = (groups + groups_per_chunk - 1) / groups_per_chunk;
  const long long blocks = (long long)n * h * a.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return (int)launch(relpos_tiled_kernel<E>, a, blocks, kThreads, (size_t)smem,
                     (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// q, k (n, s, h*d) with row strides ldq, ldk; pp (n, s, h*pstride) with row
// stride ldpp, p <= pstride terms a head; pe (h, p, s, s) and out
// (n, h, s, s) contiguous; all float32 (_f32) or all bfloat16 (_bf16).
// The batched route, float32: rows of s <= 32 nj <= 256 keys; rows query
// rows a block (a multiple of 4, at most 32; rows / 4 warps), nb batch rows
// a block, smem bytes at least batched_bytes(nj, rows, d, p, 4).
#define AJT_RELPOS_ARGS                                                                   \
  const void *q, const void *k, const void *pp, const void *pe, void *out, int n, int s, \
      int h, int d, int p, int pstride, long long ldq, long long ldk, long long ldpp
int ajt_relpos_batched_f32(AJT_RELPOS_ARGS, int nj, int rows, int nb, long long smem,
                           void* stream) {
  return relpos_batched<float>(q, k, pp, pe, out, n, s, h, d, p, pstride, ldq, ldk, ldpp, nj,
                               rows, nb, smem, stream);
}

// The two-pass route, for any s: groups_per_chunk 32-row groups a block,
// smem bytes at least (keys_floats(8, d) + 32 (d + p)) * 4.
int ajt_relpos_two_pass_f32(AJT_RELPOS_ARGS, int groups_per_chunk, long long smem,
                            void* stream) {
  return relpos_two_pass<float>(q, k, pp, pe, out, n, s, h, d, p, pstride, ldq, ldk, ldpp,
                                groups_per_chunk, smem, stream);
}
int ajt_relpos_two_pass_bf16(AJT_RELPOS_ARGS, int groups_per_chunk, long long smem,
                             void* stream) {
  return relpos_two_pass<bf16>(q, k, pp, pe, out, n, s, h, d, p, pstride, ldq, ldk, ldpp,
                               groups_per_chunk, smem, stream);
}

}  // extern "C"
