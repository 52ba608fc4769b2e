// Fused relu^2 quadratic attention for Hopper (sm_90a), float32 FMA (B6).
//
// Replaces quad_attention_pallas (audiojax/ops/attention_pallas.py:61):
//
//   out[n, i, :] = sum_j relu(scale * q[n, i, :] . k[n, j, :])^2 * v[n, j, :]
//
// with the (i == j) terms dropped when mask_diag; q, k (N, S, K), v and out
// (N, S, V), contiguous float32.  Scores and the PV product are true f32 (no
// TF32), and no (N, S, S) tensor reaches device memory.
//
// What bounds it: f32 operations.  At the MossFormerGAN GAU shapes the
// function does N*S^2*(2K + 2V) flops against N*S*(2K + 2V) floats moved:
// (964, 101, K=V=128) is ~5.0 GFLOP, ~75 us at 67 TFLOP/s, against ~200 MB,
// ~60 us at 3.35 TB/s; (404, 241) is ~12 GFLOP, ~179 us.
//
// Design.  There is no softmax, so no running maximum: a block owns (row n,
// 64 query rows, 128 value columns) and loops over tiles of 32 keys.  The
// query tile stays in shared memory, transposed, for the whole loop.  Each
// iteration stages the key tile (transposed) and the value tile in shared
// memory, forms the 64x32 score tile (4x2 per thread, float4/float2 reads
// that the warp shares), applies scale, relu^2 and the diagonal mask, writes
// it transposed to shared memory, and adds score tile x value tile to the
// output tile, which lives in registers (4 rows x 8 columns per thread).
// Each key tile's PV sum is formed apart and then added to the total, so the
// rounding of the long contraction over keys stays that of 32-term sums plus
// one add per tile.  Rows past S load as zeros, so ragged S (101, 241) needs
// no other masking; threads whose 4 query rows all lie past S skip the
// arithmetic (still loading and meeting the barriers), and the PV loop of a
// partial key tile stops at S.  78 KB of shared memory at K = 128 (above
// 48 KB, so the launcher opts in) leaves room for two blocks per SM.
//
// The launcher returns cudaGetLastError() (or the error of the shared-memory
// opt-in) after its launch.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 32;        // keys per tile
constexpr int kBV = 128;       // value columns per block
constexpr int kQS = kBM + 4;   // row stride of the transposed query and score tiles
constexpr int kKS = kBN + 4;   // row stride of the transposed key tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [r0, r0 + rows) of a row-major (S, D) matrix, D % 4 == 0, into
// dst[d * ld + row] (transposed), zero past S.  rows % 8 == 0: a warp reads 8
// rows x 4 float4 (full 32-byte sectors) and its stores meet 2-way bank
// conflicts at most.
__device__ __forceinline__ void load_transposed(const float* src, int r0, int rows, int S, int D,
                                                float* dst, int ld) {
  const int d4 = D / 4;
  for (int e = threadIdx.x; e < rows * d4; e += kThreads) {
    const int m = (e / (8 * d4)) * 8 + e % 8;
    const int c = (e / 8) % d4 * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + m < S) v = ld4(src + (size_t)(r0 + m) * D + c);
    dst[(c + 0) * ld + m] = v.x;
    dst[(c + 1) * ld + m] = v.y;
    dst[(c + 2) * ld + m] = v.z;
    dst[(c + 3) * ld + m] = v.w;
  }
}

// The scores of query rows m0 + ty*4 + i against keys j0 + tx*2 + jj,
// scaled, relu^2'd and masked, into pt[jj][i] (transposed).
__device__ __forceinline__ void score_tile(const float* qt, const float* kt, float* pt, int K,
                                           int S, int m0, int j0, float scale, int mask_diag,
                                           int tx, int ty) {
  float s[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < K; ++d) {
    const float4 a4 = ld4(qt + d * kQS + ty * 4);
    const float2 b2 = *reinterpret_cast<const float2*>(kt + d * kKS + tx * 2);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = fmaf(a[i], b2.x, s[i][0]);
      s[i][1] = fmaf(a[i], b2.y, s[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int m = m0 + ty * 4 + i, j = j0 + tx * 2 + jj;
      float p = fmaxf(s[i][jj] * scale, 0.f);
      p *= p;
      if (j >= S || (mask_diag && m == j)) p = 0.f;
      pt[(tx * 2 + jj) * kQS + ty * 4 + i] = p;
    }
}

// This key tile's PV sum over its first j_end keys, for rows ty*4 + i and
// columns tx*4 + c and kBV/2 + tx*4 + c, formed apart and added to o.
__device__ __forceinline__ void add_pv_tile(const float* pt, const float* vs, int j_end, int tx,
                                            int ty, float (&o)[4][8]) {
  float part[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) part[i][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < j_end; ++j) {
    const float4 p4 = ld4(pt + j * kQS + ty * 4);
    const float4 va = ld4(vs + j * kBV + tx * 4);
    const float4 vb = ld4(vs + j * kBV + kBV / 2 + tx * 4);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
    const float vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) part[i][c] = fmaf(p[i], vv[c], part[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] += part[i][c];
}

__global__ void __launch_bounds__(kThreads, 2)
quad_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int S, int K, int V,
                      float scale, int mask_diag) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [K][kQS]   query tile, transposed
  float* kt = qt + K * kQS;     // [K][kKS]   key tile, transposed
  float* vs = kt + K * kKS;     // [kBN][kBV] value tile
  float* pt = vs + kBN * kBV;   // [kBN][kQS] score tile, transposed

  const size_t n = blockIdx.x;
  const int m0 = blockIdx.y * kBM, v0 = blockIdx.z * kBV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qn = q + n * S * K;
  const float* kn = k + n * S * K;
  const float* vn = v + n * S * V;
  const bool active = m0 + ty * 4 < S;  // any of this thread's query rows is real

  load_transposed(qn, m0, kBM, S, K, qt, kQS);

  float o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;

  for (int j0 = 0; j0 < S; j0 += kBN) {
    load_transposed(kn, j0, kBN, S, K, kt, kKS);
    for (int e = threadIdx.x; e < kBN * (kBV / 4); e += kThreads) {
      const int j = e / (kBV / 4), c = e % (kBV / 4) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + j < S && v0 + c < V) val = ld4(vn + (size_t)(j0 + j) * V + v0 + c);
      *reinterpret_cast<float4*>(vs + j * kBV + c) = val;
    }
    __syncthreads();

    if (active) score_tile(qt, kt, pt, K, S, m0, j0, scale, mask_diag, tx, ty);
    __syncthreads();
    if (active) add_pv_tile(pt, vs, min(kBN, S - j0), tx, ty, o);
    __syncthreads();  // the next tile overwrites kt, vs and pt
  }

  float* on = out + n * S * V;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= S) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = v0 + h * (kBV / 2) + tx * 4;
      if (c < V)
        *reinterpret_cast<float4*>(on + (size_t)m * V + c) =
            make_float4(o[i][4 * h], o[i][4 * h + 1], o[i][4 * h + 2], o[i][4 * h + 3]);
    }
  }
}

}  // namespace

extern "C" {

const char* ajt_quad_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k (n, s, dk), v and out (n, s, dv); dk and dv multiples of 4, every
// pointer 16-byte aligned.
int ajt_quad_attention_f32(const float* q, const float* k, const float* v, float* out, int n,
                           int s, int dk, int dv, float scale, int mask_diag, void* stream) {
  if (n <= 0 || s <= 0 || dk <= 0 || dv <= 0 || dk % 4 || dv % 4)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = ((size_t)dk * (kQS + kKS) + kBN * kBV + kBN * kQS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quad_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n, (s + kBM - 1) / kBM, (dv + kBV - 1) / kBV);
  quad_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(q, k, v, out, s, dk, dv,
                                                                        scale, mask_diag);
  return (int)cudaGetLastError();
}

}  // extern "C"
