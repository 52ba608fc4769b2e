// Fused STFT and ISTFT kernels for Hopper (sm_90a), float32 FMA throughout.
//
// Both are matrix products whose operands are never written to device memory:
//
//   STFT   out[b, t, c]      = sum_n  xpad[b, t*hop + n] * basis[n, c]
//          (implicit GEMM: M = frames, N = 2F packed [re | im], K = n_fft;
//           frame rows are gathered from the padded audio chunk by chunk)
//   ISTFT  raw[b, r*hop + j] = sum_k sum_f spec[b, r-k, f] * ibasis[f, k*hop + j]
//          (iDFT fused with overlap-add: each output hop-row r sums the
//           k_seg = ceil(n_fft/hop) frames that cover it; no atomics)
//
// At the GTCRN serving shape (16 windows of 32000 samples, 512/256) each
// direction does 2*16*126*512*514 = 1.06 GFLOP as a dense product, so this
// design is bound by float32 arithmetic (no tensor cores: the int16 contract
// needs true f32, not TF32), about 16 us at the H100's 67 TFLOP/s.  The
// functions' own bound is their ~6 MB of traffic (~2 us): an FFT needs far
// fewer operations, which is later work.
//
// Both kernels share one tiled product: a 16x16 thread block computes a
// 64x64 output tile, 4x4 per thread, over 32-deep contraction chunks staged
// in shared memory.  The A chunk is stored
// transposed, so each thread reads its 4 rows and its 4 columns as one float4
// each per step (3 shared-memory wavefronts per 16 FMA per warp, below the
// FMA issue rate); the next chunk's operands are loaded into registers while
// the current chunk is multiplied, hiding global-memory latency, and the
// launch bounds keep registers at two blocks per SM.  The audio and spectra
// are re-read per chunk from L2, far below the arithmetic floor.  (A first
// version staged each block's audio strip in shared memory and read frames
// from it with scalar loads; it was bound by shared-memory issue and ran
// 1.4-1.6x slower on the H100.)
//
// Each chunk sums into its own partial accumulators, which are added to the
// total with Kahan compensation; the rounding error then stays that of a
// 32-term dot product however long the contraction is (a plain running sum
// over 10250 terms at 2048/441 doubled the ISTFT's error against a float64
// DFT, measured on the H100).
//
// Every launcher returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;               // 16 x 16
constexpr int kBM = 64, kBN = 64, kBK = 32;  // block tile and contraction chunk
constexpr int kAStride = kBM + 4;           // transposed A rows: float4-aligned
constexpr int kPer = kBM * kBK / kThreads;  // operand elements per thread per chunk
static_assert(kBM * kBK == kBK * kBN, "A and B chunks share one load pattern size");

struct Chunk {
  float a[kBK][kAStride];  // a[kk][m]: row m of the A chunk, transposed
  float b[kBK][kBN];       // b[kk][n]
};

// acc += x with Kahan compensation.
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float x) {
  const float y = x - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// The tiled product shared by both kernels.  ``Op::load(chunk, ra, rb)``
// gathers this thread's kPer elements of A (element e is row tid/32 + 8e,
// depth tid%32) and of B (depth tid/64 + 4e, column tid%64) for one chunk,
// zero outside the problem.  On return acc[i][j] holds output row
// ty*4 + i, column tx*4 + j of the block's tile.
template <class Op>
__device__ __forceinline__ void tile_product(const Op& op, int n_chunks, float (&acc)[4][4]) {
  __shared__ __align__(16) Chunk s;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float ra[kPer], rb[kPer];
  float comp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = comp[i][j] = 0.f;

  op.load(0, ra, rb);
  for (int c = 0; c < n_chunks; ++c) {
    float* sa = &s.a[threadIdx.x % kBK][threadIdx.x / kBK];
    float* sb = &s.b[threadIdx.x / kBN][threadIdx.x % kBN];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      sa[e * (kThreads / kBK)] = ra[e];
      sb[e * (kThreads / kBN) * kBN] = rb[e];
    }
    __syncthreads();
    if (c + 1 < n_chunks) op.load(c + 1, ra, rb);  // in flight during the product

    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s.a[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kahan_add(acc[i][j], comp[i][j], part[i][j]);
    __syncthreads();  // the next chunk overwrites the tiles
  }
}

// STFT operands: A = frames (row t0+m, sample k) gathered from the padded
// audio, B = windowed DFT basis rows.
struct StftOp {
  const float* x;  // this batch row of xpad
  const float* basis;
  long long lpad;
  int n_fft, hop, f2, t0, c0;

  // Element e of this thread is A row tid/32 + 8e, depth tid%32, and B depth
  // tid/64 + 4e, column tid%64: one base offset and a constant stride each.
  __device__ __forceinline__ void load(int c, float (&ra)[kPer], float (&rb)[kPer]) const {
    const int k0 = c * kBK;
    const long long a0 = (long long)(t0 + threadIdx.x / kBK) * hop + k0 + threadIdx.x % kBK;
    const long long a_step = (long long)(kThreads / kBK) * hop;
    const int kb = k0 + threadIdx.x / kBN, col = c0 + threadIdx.x % kBN;
    const long long b_off = (long long)kb * f2 + col;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      // samples past the signal only reach frames t >= n_t (never stored) or
      // rows n >= n_fft (zero basis rows), so they load as zeros
      const long long s = a0 + e * a_step;
      ra[e] = s < lpad ? x[s] : 0.f;
      const int k = kb + e * (kThreads / kBN);
      rb[e] = (k < n_fft && col < f2) ? basis[b_off + (long long)e * (kThreads / kBN) * f2] : 0.f;
    }
  }
};

// ISTFT operands for chunk c = (segment k, bins f0..): A = frame r - k of
// output hop-row r0+m, B = columns j0.. of segment k of the iDFT basis.
struct IstftOp {
  const float* spec;  // this batch row of spec
  const float* ibasis;
  int n_t, n_fft, hop, f2, r0, j0, f_chunks;

  __device__ __forceinline__ void load(int c, float (&ra)[kPer], float (&rb)[kPer]) const {
    const int k = c / f_chunks, f0 = (c % f_chunks) * kBK;
    const int t_first = r0 + threadIdx.x / kBK - k, f = f0 + threadIdx.x % kBK;
    const long long a_off = (long long)t_first * f2 + f;
    const int fb = f0 + threadIdx.x / kBN, j = j0 + threadIdx.x % kBN, n = k * hop + j;
    const bool col_ok = j < hop && n < n_fft;
    const long long b_off = (long long)fb * n_fft + n;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = t_first + e * (kThreads / kBK);
      ra[e] = (t >= 0 && t < n_t && f < f2)
                  ? spec[a_off + (long long)e * (kThreads / kBK) * f2] : 0.f;
      rb[e] = (col_ok && fb + e * (kThreads / kBN) < f2)
                  ? ibasis[b_off + (long long)e * (kThreads / kBN) * n_fft] : 0.f;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2)
stft_kernel(const float* __restrict__ xpad, const float* __restrict__ basis,
            float* __restrict__ out, int lpad, int n_t, int n_fft, int hop, int f2) {
  const int t0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const StftOp op{xpad + (size_t)blockIdx.z * lpad, basis, lpad, n_fft, hop, f2, t0, c0};
  float acc[4][4];
  tile_product(op, (n_fft + kBK - 1) / kBK, acc);

  float* ob = out + (size_t)blockIdx.z * n_t * f2;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= n_t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col < f2) ob[(size_t)t * f2 + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
istft_kernel(const float* __restrict__ spec, const float* __restrict__ ibasis,
             float* __restrict__ raw, int n_t, int n_rows, int n_fft, int hop, int f2) {
  const int r0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int f_chunks = (f2 + kBK - 1) / kBK;
  const int k_seg = (n_fft + hop - 1) / hop;
  const IstftOp op{spec + (size_t)blockIdx.z * n_t * f2, ibasis, n_t, n_fft, hop, f2, r0, j0,
                   f_chunks};
  float acc[4][4];
  tile_product(op, k_seg * f_chunks, acc);

  float* rb = raw + (size_t)blockIdx.z * n_rows * hop;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      if (jj < hop) rb[(size_t)r * hop + jj] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* ajt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// xpad (batch, lpad) centre-padded audio, basis (n_fft, f2), out (batch, n_t, f2).
int ajt_stft_packed_f32(const float* xpad, const float* basis, float* out, int batch, int lpad,
                        int n_t, int n_fft, int hop, int f2, void* stream) {
  if (batch <= 0 || n_t <= 0 || n_fft <= 0 || hop <= 0 || f2 <= 0 ||
      (long long)(n_t - 1) * hop + n_fft > lpad)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((f2 + kBN - 1) / kBN, (n_t + kBM - 1) / kBM, batch);
  stft_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(xpad, basis, out, lpad, n_t, n_fft,
                                                           hop, f2);
  return (int)cudaGetLastError();
}

// spec (batch, n_t, f2), ibasis (f2, n_fft), raw (batch, n_rows * hop) with
// n_rows = n_t + ceil(n_fft / hop) - 1: every element is written exactly once.
int ajt_istft_raw_f32(const float* spec, const float* ibasis, float* raw, int batch, int n_t,
                      int n_fft, int hop, int f2, void* stream) {
  if (batch <= 0 || n_t <= 0 || n_fft <= 0 || hop <= 0 || f2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_rows = n_t + (n_fft + hop - 1) / hop - 1;
  const dim3 grid((hop + kBN - 1) / kBN, (n_rows + kBM - 1) / kBM, batch);
  istft_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(spec, ibasis, raw, n_t, n_rows,
                                                            n_fft, hop, f2);
  return (int)cudaGetLastError();
}

}  // extern "C"
