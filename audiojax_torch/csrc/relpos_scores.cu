// Zipformer2 rel-pos attention scores for Hopper (sm_90a), float32 (B3).
//
// Replaces relpos_scores_pallas (audiojax/ops/attention_pallas.py:195) with
// the contract of relpos_scores_jnp (:142), the function the model runs:
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
// maximum and divides by the row sum, as jax.nn.softmax does.
//
// What bounds it: bytes, mostly the output.  At ZipEnhancer's (964, 101) the
// probabilities are 157 MB and q/k/pp ~112 MB, ~0.08 ms at 3.35 TB/s, against
// ~3 GFLOP, ~0.045 ms at 67 TFLOP/s.  This first design is far from that
// bound (PERF.md has its times): it reads P values of pe from L2 for every
// probability, since no block shares pe rows across n, and spends some forty
// instructions a probability on the scores and the softmax.
//
// Design.  A block of 8 warps owns one (n, h) and a range of query-row groups
// of 32 rows, 4 rows per warp.  The head's keys go into shared memory once,
// transposed (kt[d][j], row stride 32*NJ + 1 so that the transposing stores
// meet no bank conflicts).  Each warp stages its 4 query rows (transposed,
// read as one float4 broadcast per d) and their positional terms in its own
// shared-memory slot, then every lane forms the scores of the 4 rows against
// NJ keys j = lane + 32 t: per d one float4 and NJ key loads feed 4*NJ FMAs.
// The positional bias is read from pe (at most a few MB, L2-resident) with
// neighbouring lanes on neighbouring j, formed apart and added.  The row
// stays in registers; its maximum and sum go by warp shuffles (expf, not
// __expf), and the probabilities are written with neighbouring lanes on
// neighbouring j.  Rows of up to 256 keys take this one pass (NJ = 1, 2, 4
// or 8 by S).  Longer rows take two passes over 256-key tiles: a running
// maximum and sum first, then the write, with the scores recomputed in the
// same order.
//
// The launcher returns cudaGetLastError() (or the error of the shared-memory
// opt-in) after its launch.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                   // query rows per warp
constexpr int kGroup = kWarps * kRows;     // query rows per block step
constexpr int kMaxNJ = 8;                  // keys per lane in one pass: S <= 256

struct Args {
  const float* q;
  const float* k;
  const float* pp;
  const float* pe;
  float* out;
  long long ldq, ldk, ldpp;  // row strides, in floats
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
template <int NJ>
__device__ __forceinline__ void load_keys(const float* __restrict__ kn, long long ldk, int S,
                                          int D, int j0, float* kt) {
  constexpr int kTile = 32 * NJ, kKS = kTile + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    kt[d * kKS + j] = (j0 + j < S) ? kn[(size_t)(j0 + j) * ldk + d] : 0.f;
  }
}

// This warp's query rows i0 .. i0+3 into qw[d*4 + r] and their positional
// terms into pw[p*4 + r], zero past S.
__device__ __forceinline__ void load_rows(const Args& a, const float* __restrict__ qn,
                                          const float* __restrict__ pn, int i0, int lane,
                                          float* qw, float* pw) {
  __syncwarp();  // the previous rows are no longer read
  for (int e = lane; e < kRows * a.D; e += 32) {
    const int r = e / a.D, d = e - r * a.D;
    qw[d * kRows + r] = (i0 + r < a.S) ? qn[(size_t)(i0 + r) * a.ldq + d] : 0.f;
  }
  for (int e = lane; e < kRows * a.P; e += 32) {
    const int r = e / a.P, p = e - r * a.P;
    pw[p * kRows + r] = (i0 + r < a.S) ? pn[(size_t)(i0 + r) * a.ldpp + p] : 0.f;
  }
  __syncwarp();
}

// Scores of rows i0 + r against keys j0 + 32 t + lane; -inf past S.
template <int NJ>
__device__ __forceinline__ void scores(const Args& a, const float* kt, const float* qw,
                                       const float* pw, const float* __restrict__ peh, int i0,
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
    const float* pei = peh + (size_t)i * a.S + j0 + lane;
    const int valid = a.S - j0 - lane;  // t * 32 < valid: key j0 + t*32 + lane exists
    float b[NJ];
#pragma unroll
    for (int t = 0; t < NJ; ++t) b[t] = 0.f;
#pragma unroll 4
    for (int p = 0; p < a.P; ++p) {
      const float w = pw[p * kRows + r];
      float v[NJ];
#pragma unroll
      for (int t = 0; t < NJ; ++t) v[t] = t * 32 < valid ? __ldg(pei + p * plane + t * 32) : 0.f;
#pragma unroll
      for (int t = 0; t < NJ; ++t) b[t] = fmaf(w, v[t], b[t]);
    }
#pragma unroll
    for (int t = 0; t < NJ; ++t) acc[r][t] = t * 32 < valid ? acc[r][t] + b[t] : -INFINITY;
  }
}

struct Head {
  const float* kn;
  const float* qn;
  const float* pn;
  const float* peh;
  float* on;
  int row0, row_end;  // this block's query rows
};

__device__ __forceinline__ Head locate(const Args& a) {
  const int chunk = blockIdx.x % a.chunks;
  const int nh = blockIdx.x / a.chunks;
  const int h = nh % a.H, n = nh / a.H;
  Head hd;
  hd.kn = a.k + (size_t)n * a.S * a.ldk + (size_t)h * a.D;
  hd.qn = a.q + (size_t)n * a.S * a.ldq + (size_t)h * a.D;
  hd.pn = a.pp + (size_t)n * a.S * a.ldpp + (size_t)h * a.pstride;
  hd.peh = a.pe + (size_t)h * a.P * a.S * a.S;
  hd.on = a.out + (size_t)nh * a.S * a.S;
  hd.row0 = chunk * a.groups_per_chunk * kGroup;
  hd.row_end = min(a.S, hd.row0 + a.groups_per_chunk * kGroup);
  return hd;
}

// One pass: the whole row (S <= 32*NJ) in registers.  The launch bounds ask
// for two blocks an SM (at most 128 registers a thread): where a lane holds 8
// keys of 4 rows that costs a few spills, which cost less than one block an SM.
template <int NJ>
__global__ void __launch_bounds__(kThreads, 2) relpos_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* kt = smem;
  float* qw = smem + keys_floats(NJ, a.D) + warp * kRows * (a.D + a.P);
  float* pw = qw + kRows * a.D;
  const Head hd = locate(a);

  load_keys<NJ>(hd.kn, a.ldk, a.S, a.D, 0, kt);
  __syncthreads();

  for (int g = hd.row0; g < hd.row_end; g += kGroup) {
    const int i0 = g + warp * kRows;
    if (i0 >= hd.row_end) break;  // warp-uniform; no block barrier follows
    load_rows(a, hd.qn, hd.pn, i0, lane, qw, pw);
    float acc[kRows][NJ];
    scores<NJ>(a, kt, qw, pw, hd.peh, i0, 0, lane, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= hd.row_end) break;
      float m = acc[r][0];
#pragma unroll
      for (int t = 1; t < NJ; ++t) m = fmaxf(m, acc[r][t]);
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        acc[r][t] = expf(acc[r][t] - m);  // 0 past S
        s += acc[r][t];
      }
      s = warp_sum(s);
      float* orow = hd.on + (size_t)i * a.S;
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        const int j = t * 32 + lane;
        if (j < a.S) orow[j] = acc[r][t] / s;
      }
    }
  }
}

// Two passes over 256-key tiles, for rows longer than 256 keys.
__global__ void __launch_bounds__(kThreads, 2) relpos_tiled_kernel(const Args a) {
  constexpr int NJ = kMaxNJ, kTile = 32 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* kt = smem;
  float* qw = smem + keys_floats(NJ, a.D) + warp * kRows * (a.D + a.P);
  float* pw = qw + kRows * a.D;
  const Head hd = locate(a);

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
        float* orow = hd.on + (size_t)i * a.S;
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          const int j = j0 + t * 32 + lane;
          if (j < a.S) orow[j] = expf(acc[r][t] - m[r]) / s[r];
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int nj, const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem =
      ((size_t)keys_floats(nj, a.D) + (size_t)kWarps * kRows * (a.D + a.P)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ajt_relpos_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k (n, s, h*d) with row strides ldq, ldk; pp (n, s, h*pstride) with row
// stride ldpp, p <= pstride terms a head; pe (h, p, s, s) and out
// (n, h, s, s) contiguous; all float32.
int ajt_relpos_scores_f32(const float* q, const float* k, const float* pp, const float* pe,
                          float* out, int n, int s, int h, int d, int p, int pstride,
                          long long ldq, long long ldk, long long ldpp, void* stream) {
  if (n <= 0 || s <= 0 || h <= 0 || d <= 0 || p <= 0 || p > pstride || ldq < (long long)h * d ||
      ldk < (long long)h * d || ldpp < (long long)h * pstride)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, pp, pe, out, ldq, ldk, ldpp, s, h, d, p, pstride, 1, 1};
  const int groups = (s + kGroup - 1) / kGroup;
  // split a row's groups over several blocks only while there are too few
  // (n, h) pairs to fill the card
  const long long pairs = (long long)n * h;
  const long long want = (4096 + pairs - 1) / pairs;
  a.groups_per_chunk = (int)((groups + want - 1) / want);
  if (a.groups_per_chunk < 1) a.groups_per_chunk = 1;
  a.chunks = (groups + a.groups_per_chunk - 1) / a.groups_per_chunk;
  const long long blocks = pairs * a.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nj = (s + 31) / 32;
  if (nj <= 1) return (int)launch(relpos_kernel<1>, 1, a, (int)blocks, st);
  if (nj <= 2) return (int)launch(relpos_kernel<2>, 2, a, (int)blocks, st);
  if (nj <= 4) return (int)launch(relpos_kernel<4>, 4, a, (int)blocks, st);
  if (nj <= kMaxNJ) return (int)launch(relpos_kernel<kMaxNJ>, kMaxNJ, a, (int)blocks, st);
  return (int)launch(relpos_tiled_kernel, kMaxNJ, a, (int)blocks, st);
}

}  // extern "C"
