// Fused relu^2 quadratic attention for Hopper (sm_90a), float32 FMA (B6), on
// float32 tensors.
//
// Replaces quad_attention_pallas (audiojax/ops/attention_pallas.py:61, its
// kernel _kernel :44):
//
//   out[n, i, :] = sum_j relu(scale * q[n, i, :] . k[n, j, :])^2 * v[n, j, :]
//
// with the (i == j) terms dropped when mask_diag; q, k (N, S, K), v and out
// (N, S, V), contiguous float32.  Scores and the PV product are true f32 on
// the CUDA cores (FFMA, no TF32), and no (N, S, S) tensor reaches device
// memory.
//
// What bounds it: f32 operations.  The function does N*S^2*(2K + 2V) flops
// against N*S*(2K + 2V) floats moved: MossFormer2-SS's FLASH group (64, 256,
// K 128, V 2048) is 18.25 GFLOP, 0.272 ms at 67 TFLOP/s, against ~0.2 ms of
// bytes; MossFormerGAN's (964, 101, 128, 128) is 5.0 GFLOP, 0.075 ms.  So the
// design is that of a SIMT SGEMM: register tiles of 8 x 8 a thread, operands
// staged in shared memory by cp.async while the previous tile computes, and
// warp tiles of 32 rows x 64 columns, whose 16-byte shared loads take one
// wavefront each (4 distinct row addresses, 8 distinct column addresses), so
// that the SM spends its cycles on FMAs, not shared-memory reads.  Each copy
// a thread makes walks its source and destination by constant strides.
//
// Design.  A block owns (n, BM = 32*WM query rows, a range of value tiles of
// VT = 64*WN columns) and has WM x WN warps.
//  1. Scores, once.  The block forms its BM x S relu^2 score tile, scaled and
//     masked, into shared memory (pt, key-major, row stride BM + 4 so that
//     the scattered epilogue stores meet no bank conflict).  It is an SGEMM
//     of q's rows against key blocks of 64*WN keys, over chunks of 16
//     features; each chunk's q rows and keys go into shared memory by
//     cp.async (row stride 20 floats: the strided rows of a thread tile fall
//     on distinct 16-byte bank groups), double-buffered.
//  2. PV, by value tile.  For each value tile the block sweeps the keys in
//     chunks of 32; each (key chunk x value tile) piece of v is copied by
//     cp.async into one of two buffers while the other one computes, with
//     one barrier a piece, and a piece's 32 keys are unrolled whole so that
//     the compiler runs the shared loads ahead of the FMAs.  The output tile
//     stays in registers and is written once, with float4 stores, after the
//     last chunk.
// Keys are padded to a multiple of 8 (scores past S are zero, v rows past S
// load as zeros); query rows to the 32 of a warp tile, the warp tile that
// keeps shared-memory reads below the FMA rate.  At V = 2048 the score tile
// costs 1/16 of the PV product instead of the first design's once per 128
// value columns (34.4 -> 18.25 GFLOP a call at (64, 256)).
// Summation order: each score sums its features in order; each output sums
// its keys in order, straight into the output tile.  That is the order of
// cuBLAS's SGEMM: on the H100 the output equals the plain version's (two
// torch.matmul) bit for bit at the served shapes.  The first design formed
// each 32-key chunk's sum apart and added it; that cost 64 registers, and
// its float64 error was 1.11x the plain version's at V = 2048 (chip_smoke.py
// on the H100).
// Rows of more keys than the shared memory holds (S_pad*(BM + 4) floats
// beside the staging buffers) take key segments: each segment's score tile,
// then its PV sums, with the output tile kept in registers across segments;
// the host then gives every block one value tile (kMulti).
//
// Shared memory and occupancy at the served shapes (ops/attention_cuda.py:
// quad_launch computes the same bytes; WM = WN = 2, 128 threads, the fastest
// layout at SS and within 1.5 % of 4 x 2 at the GAN's in
// attention_geometry_sweep.py's tables): SS
// (S 256) pt 69.6 KB + staging max(30.7, 32.8) KB = 102.4 KB, two blocks (8
// warps) an SM, at most 255 registers a thread; GAN (S 101, keys padded to
// 104) 28.3 + 32.8 KB.  Bytes through L2 a call: q, k once per block, v once
// per (block, value tile): at SS 4 row tiles read each v row 4 times, 0.54
// GB, against 18.25 GFLOP.
//
// The kernel is written for an element type E, but only its float32
// instance is built: the bf16 serving plan's B6 runs on the tensor cores
// (quad_attention_bf16.cu), which replaced this design's bf16 instances.
//
// The launcher takes the geometry from the host (WM, WN, row tiles, value
// splits, key segment, shared-memory bytes), checks it, and returns
// cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace {

constexpr int kDC = 16;       // features of q and k staged at a time
constexpr int kDS = kDC + 4;  // row stride of a staged q / k chunk (floats)
constexpr int kSB = 2;        // q/k feature chunks in the ring

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared-memory floats: the score tile of `seg` keys, then the staging
// buffers (score chunks in phase 1, two v pieces of 32 keys x 64 WN columns
// in phase 2).
__host__ __device__ constexpr size_t smem_floats(int wm, int wn, int seg) {
  return (size_t)seg * (32 * wm + 4) +
         ((kSB * (32 * wm + 64 * wn) * kDS > 2 * 32 * 64 * wn) ? kSB * (32 * wm + 64 * wn) * kDS
                                                                : 2 * 32 * 64 * wn);
}

// 4 f32 values stored as 4 consecutive elements (bf16: rounded).
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// 4 elements (16 bytes of float, 8 of bf16) from global to shared memory
// (shared-window address dst), asynchronously; zeros where !valid.
template <class E>
__device__ __forceinline__ void cp_async4e(unsigned dst, const E* src, bool valid) {
  if constexpr (sizeof(E) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 8 : 0));
  }
}
template <class E>
__device__ __forceinline__ unsigned smem_addr(const E* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// WM x WN warps of 32 rows x 64 columns (scores: 64 keys); a thread's tile
// is 8 x 8.
template <int WM, int WN>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kBM = 32 * WM;   // query rows per block
  static constexpr int kVT = 64 * WN;   // value columns per tile
  static constexpr int kKB = 64 * WN;   // keys per score block
  static constexpr int kPTS = kBM + 4;  // row stride of the score tile
  static constexpr int kJC = 32;        // keys of a staged v piece
  static constexpr int kVP = kJC * kVT;
};

// Features [d0, d0 + 16) of query rows [m0, m0 + BM) and keys [j0, j0 + KB)
// into buf (rows: BM query rows, then KB keys), zero past S and past K.  A
// thread copies 4 elements of every kRows-th row, walking its source and
// destination by constant strides (no index arithmetic a copy).
template <class T, class E>
__device__ __forceinline__ void stage_qk(const E* qn, const E* kn, int S, int K, int m0, int j0,
                                         int d0, E* buf) {
  constexpr int kC4 = kDC / 4, kRows = T::kThreads / kC4;
  constexpr unsigned kStep = kRows * kDS * sizeof(E);
  static_assert(T::kBM % kRows == 0 && T::kKB % kRows == 0, "passes split q from k");
  const int r0 = threadIdx.x / kC4, c = threadIdx.x % kC4 * 4;
  const bool col_ok = d0 + c < K;
  unsigned dst = smem_addr(buf + r0 * kDS + c);
  const E* src = qn + (size_t)(m0 + r0) * K + d0 + c;
#pragma unroll
  for (int r = r0; r < T::kBM; r += kRows, src += (size_t)kRows * K, dst += kStep) {
    const bool ok = col_ok && m0 + r < S;
    cp_async4e(dst, ok ? src : qn, ok);
  }
  src = kn + (size_t)(j0 + r0) * K + d0 + c;
#pragma unroll
  for (int r = r0; r < T::kKB; r += kRows, src += (size_t)kRows * K, dst += kStep) {
    const bool ok = col_ok && j0 + r < S;
    cp_async4e(dst, ok ? src : kn, ok);
  }
}

// Keys [j0, j0 + kJC) x columns [c0, c0 + VT) of v into buf, zero past S and
// V, by constant strides as in stage_qk.
template <class T, class E>
__device__ __forceinline__ void stage_v(const E* vn, int S, int V, int j0, int c0, E* buf) {
  constexpr int kC4 = T::kVT / 4, kRows = T::kThreads / kC4;
  constexpr unsigned kStep = kRows * T::kVT * sizeof(E);
  static_assert(T::kJC % kRows == 0, "whole passes");
  const int r0 = threadIdx.x / kC4, c = threadIdx.x % kC4 * 4;
  const bool col_ok = c0 + c < V;
  unsigned dst = smem_addr(buf + r0 * T::kVT + c);
  const E* src = vn + (size_t)(j0 + r0) * V + c0 + c;
#pragma unroll
  for (int r = r0; r < T::kJC; r += kRows, src += (size_t)kRows * V, dst += kStep) {
    const bool ok = col_ok && j0 + r < S;
    cp_async4e(dst, ok ? src : vn, ok);
  }
}

// Phase 1: relu^2 scores of the block's rows against keys [k_lo, k_lo + k_n)
// into pt[key - k_lo][row].
template <class T, int WN, class E>
__device__ __forceinline__ void score_tile(const E* qn, const E* kn, int S, int K, int m0,
                                           int k_lo, int k_n, float scale, int mask_diag,
                                           float* pt, E* work) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WN, wc = warp % WN, ty = lane >> 3, tx = lane & 7;
  const int nd = (K + kDC - 1) / kDC;
  constexpr int kBuf = (T::kBM + T::kKB) * kDS;
  for (int kb0 = 0; kb0 < k_n; kb0 += T::kKB) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // chunks of features in a ring of kSB buffers, kSB - 1 ahead; one
    // barrier a chunk: after it, every thread is done with the chunk before,
    // whose buffer the next copy takes
#pragma unroll
    for (int q = 0; q < kSB - 1; ++q) {
      if (q < nd) stage_qk<T>(qn, kn, S, K, m0, k_lo + kb0, q * kDC, work + q * kBuf);
      cp_commit();  // an empty group past the last chunk keeps the count uniform
    }
    for (int dc = 0; dc < nd; ++dc) {
      cp_wait<kSB - 2>();  // chunk dc has landed (this thread's copies)
      __syncthreads();
      if (dc + kSB - 1 < nd)
        stage_qk<T>(qn, kn, S, K, m0, k_lo + kb0, (dc + kSB - 1) * kDC,
                    work + (dc + kSB - 1) % kSB * kBuf);
      cp_commit();
      const E* qs = work + dc % kSB * kBuf + (wr * 32 + ty) * kDS;
      const E* ks = work + dc % kSB * kBuf + (T::kBM + wc * 64 + tx) * kDS;
#pragma unroll
      for (int d = 0; d < kDC; d += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ld4(qs + 4 * i * kDS + d);  // row ty + 4i
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = ld4(ks + 8 * j * kDS + d);  // key tx + 8j
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every chunk is read: the next key block's copies may start
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = wr * 32 + ty + 4 * i, key = kb0 + wc * 64 + tx + 8 * j;
        if (key >= k_n) continue;
        float p = fmaxf(acc[i][j] * scale, 0.f);
        p *= p;
        if (k_lo + key >= S || (mask_diag && m0 + row == k_lo + key)) p = 0.f;
        pt[key * T::kPTS + row] = p;
      }
  }
}

template <class E, class O, int WM, int WN, bool kMulti>
__global__ void __launch_bounds__(32 * WM * WN, 1)
quad_attention_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                      O* __restrict__ out, int S, int K, int V, float scale, int mask_diag,
                      int row_tiles, int vsplit, int seg) {
  using T = Tile<WM, WN>;
  constexpr int kJC = T::kJC, kVP = T::kVP;
  extern __shared__ __align__(16) float smem[];
  float* pt = smem;  // [seg][kPTS] relu^2 scores, key-major, f32
  // staging: q/k chunks, then v pieces, of E (the float32 buffers' bytes)
  E* work = reinterpret_cast<E*>(smem + (size_t)seg * T::kPTS);

  int b = blockIdx.x;
  const int vs = b % vsplit;
  b /= vsplit;
  const int m0 = (b % row_tiles) * T::kBM;
  const size_t n = b / row_tiles;
  const int tiles = (V + T::kVT - 1) / T::kVT, per = (tiles + vsplit - 1) / vsplit;
  const int t_lo = vs * per, t_hi = min(tiles, t_lo + per);
  if (t_lo >= t_hi) return;  // whole block: no barrier is skipped by part of it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WN, wc = warp % WN, ty = lane >> 3, tx = lane & 7;
  const E* qn = q + n * S * K;
  const E* kn = k + n * S * K;
  const E* vn = v + n * S * V;
  O* on = out + n * S * V;
  const int s_pad = round_up(S, 8);
  const int nseg = kMulti ? (s_pad + seg - 1) / seg : 1;

  float o[8][8];  // output tile: rows wr*32 + ty*8 + i, columns wc*64 + tx*4 (+32)

  for (int sg = 0; sg < nseg; ++sg) {
    const int k_lo = sg * seg, k_n = min(seg, s_pad - k_lo);  // a multiple of 8
    score_tile<T, WN>(qn, kn, S, K, m0, k_lo, k_n, scale, mask_diag, pt, work);
    __syncthreads();  // pt complete; the staging buffers are free

    const int nj = (k_n + kJC - 1) / kJC, steps = (t_hi - t_lo) * nj;
    stage_v<T>(vn, S, V, k_lo, t_lo * T::kVT, work);
    cp_commit();
    for (int t = t_lo; t < t_hi; ++t) {
      if (!kMulti || sg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) o[i][cc] = 0.f;
      }
      for (int c = 0; c < nj; ++c) {
        const int st = (t - t_lo) * nj + c;
        cp_wait<0>();     // piece st has landed (this thread's copies)
        __syncthreads();  // everyone's; everyone is done with piece st - 1
        if (st + 1 < steps) {  // the next piece, into piece st - 1's buffer
          const int t1 = c + 1 < nj ? t : t + 1, c1 = c + 1 < nj ? c + 1 : 0;
          stage_v<T>(vn, S, V, k_lo + c1 * kJC, t1 * T::kVT, work + ((st + 1) & 1) * kVP);
          cp_commit();
        }
        const float* ps = pt + (size_t)c * kJC * T::kPTS + wr * 32 + ty * 8;
        const E* vb = work + (st & 1) * kVP + wc * 64 + tx * 4;
        const int j_hi = min(kJC, k_n - c * kJC);  // a multiple of 8
#pragma unroll
        for (int j0 = 0; j0 < kJC; j0 += 8) {  // unrolled whole: loads run ahead of the FMAs
          if (j0 >= j_hi) break;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = j0 + jj;
            const float4 p0 = ld4(ps + j * T::kPTS), p1 = ld4(ps + j * T::kPTS + 4);
            const float4 v0 = ld4(vb + j * T::kVT), v1 = ld4(vb + j * T::kVT + 32);
            const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
            const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) o[i][cc] = fmaf(pr[i], vv[cc], o[i][cc]);
          }
        }
      }
      if (sg == nseg - 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + wr * 32 + ty * 8 + i;
          if (m >= S) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = t * T::kVT + wc * 64 + h * 32 + tx * 4;
            if (col < V)
              st4(on + (size_t)m * V + col,
                  make_float4(o[i][4 * h], o[i][4 * h + 1], o[i][4 * h + 2], o[i][4 * h + 3]));
          }
        }
      }
    }
    __syncthreads();  // the last piece is read: the next segment's copies may start
  }
}

template <class E, class O, int WM, int WN, bool kMulti>
cudaError_t launch(const E* q, const E* k, const E* v, O* out, int n, int s, int dk, int dv,
                   float scale, int mask_diag, int row_tiles, int vsplit, int seg, size_t smem,
                   cudaStream_t stream) {
  auto kernel = quad_attention_kernel<E, O, WM, WN, kMulti>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)n * row_tiles * vsplit;
  kernel<<<(unsigned)blocks, 32 * WM * WN, smem, stream>>>(q, k, v, out, s, dk, dv, scale,
                                                          mask_diag, row_tiles, vsplit, seg);
  return cudaGetLastError();
}

// The warp layouts the kernel is built for: (WM, WN) = (2, 2), (4, 2).
template <class E, class O, bool kMulti>
cudaError_t dispatch(int wm, int wn, const E* q, const E* k, const E* v, O* out, int n, int s,
                     int dk, int dv, float scale, int mask_diag, int row_tiles, int vsplit,
                     int seg, size_t smem, cudaStream_t st) {
  if (wm == 2 && wn == 2)
    return launch<E, O, 2, 2, kMulti>(q, k, v, out, n, s, dk, dv, scale, mask_diag, row_tiles,
                                   vsplit, seg, smem, st);
  if (wm == 4 && wn == 2)
    return launch<E, O, 4, 2, kMulti>(q, k, v, out, n, s, dk, dv, scale, mask_diag, row_tiles,
                                   vsplit, seg, smem, st);
  return cudaErrorInvalidConfiguration;
}

template <class E, class O>
int quad_attention(const void* qv, const void* kv, const void* vv, void* outv, int n, int s,
                   int dk, int dv, float scale, int mask_diag, int wm, int wn, int row_tiles,
                   int vsplit, int seg, long long smem, void* stream) {
  const E* q = static_cast<const E*>(qv);
  const E* k = static_cast<const E*>(kv);
  const E* v = static_cast<const E*>(vv);
  O* out = static_cast<O*>(outv);
  if (n <= 0 || s <= 0 || dk <= 0 || dv <= 0 || dk % 4 || dv % 4 || wm <= 0 || wn <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int s_pad = round_up(s, 8), tiles = (dv + 64 * wn - 1) / (64 * wn);
  const bool multi = seg < s_pad;
  if (row_tiles != (s + 32 * wm - 1) / (32 * wm) || vsplit < 1 || vsplit > tiles || seg <= 0 ||
      seg % 8 || seg > s_pad || (multi && vsplit != tiles) ||
      smem < (long long)(smem_floats(wm, wn, seg) * sizeof(float)) ||
      (long long)n * row_tiles * vsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  return multi ? (int)dispatch<E, O, true>(wm, wn, q, k, v, out, n, s, dk, dv, scale, mask_diag,
                                        row_tiles, vsplit, seg, (size_t)smem, st)
               : (int)dispatch<E, O, false>(wm, wn, q, k, v, out, n, s, dk, dv, scale, mask_diag,
                                         row_tiles, vsplit, seg, (size_t)smem, st);
}

}  // namespace

extern "C" {

const char* ajt_quad_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k (n, s, dk), v and out (n, s, dv), all float32; dk and dv multiples
// of 4, every pointer 16-byte aligned.  Geometry from the host:
// wm x wn warps (a layout of dispatch), row_tiles = ceil(s / (32 wm)),
// vsplit value-tile ranges a row tile, seg keys of score tile held (a
// multiple of 8; below round_up(s, 8) only with one value tile a block),
// smem bytes (at least smem_floats).
#define AJT_QUAD_ENTRY(NAME, E, O)                                                            \
  int NAME(const void* q, const void* k, const void* v, void* out, int n, int s, int dk, int dv, \
           float scale, int mask_diag, int wm, int wn, int row_tiles, int vsplit, int seg,      \
           long long smem, void* stream) {                                                      \
    return quad_attention<E, O>(q, k, v, out, n, s, dk, dv, scale, mask_diag, wm, wn,           \
                                row_tiles, vsplit, seg, smem, stream);                          \
  }
AJT_QUAD_ENTRY(ajt_quad_attention_f32, float, float)
#undef AJT_QUAD_ENTRY

}  // extern "C"
