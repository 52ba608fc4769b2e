// Depthwise and grouped 2-in/1-out 1-D convolution for Hopper (sm_90a),
// float32 FMA (B4 and B5).
//
// One output channel per group, M input lanes per group (M = 1 or 2):
//
//   y[b, t, g] = sum_{i<k} sum_{m<M} xpad[b, t + i*dil, g*M + m] * w[i, m, g]
//                                                        (taps outer, m inner)
//
// x (B, T, M*G) and y (B, T_out, G) are channel-last and contiguous, w is
// (k, M, G), xpad is x with lo zero rows before and hi after, and
// T_out = T + lo + hi - dil*(k-1).  The lanes of group g are interleaved,
// [M*g, M*g + M), as torch's groups= and lax's feature_group_count read them.
//
//   M = 1 (dwconv_kernel): the true depthwise conv, dwconv1d_pallas
//     (audiojax/ops/dwconv_pallas.py:52), plus a dilation.
//   M = 2 (dwconv_grouped_kernel): the grouped 2-in/1-out dilated conv of
//     MossFormer2-SS's FSMN memory, which the TPU runs on
//     dwconv1d_pallas_tiled (:120) as a stride-2 channel deinterleave into
//     two time-tiled depthwise calls (audiojax/nn/core.py:235-252).  Here it
//     is one kernel: no deinterleaved copies, one output write.
//
// What bounds it: bytes.  Each output needs M*k FMA and each input element is
// read by k outputs, so a kernel that reads x from device memory once is
// memory-bound whenever k is below ~20 (f32 rate / memory rate in flops per
// float); at the MossFormerGAN shapes (k = 31, 39) the two are close:
// (964, 101, 256) reads and writes ~200 MB, ~60 us at 3.35 TB/s, against
// 1.5 GFLOP, ~23 us at 67 TFLOP/s.  The MossFormer2-SS grouped shape
// (4, 3999, 512 -> 256), k = 39, d = 2 moves ~49 MB, ~15 us, against 0.32 GFLOP.
//
// Design.  A block owns (batch row, time tile, tile of output channels).  It
// stages its halo strip, tile + dil*(k-1) rows of its input lanes, in shared
// memory with the zero padding filled in, and the block's taps beside it;
// loads run along the channels, which are contiguous.  For M = 2 the staging
// deinterleaves: strip row r holds plane m = 0 (the even lanes) and then
// plane m = 1 (the odd lanes), each laid out like a depthwise row, so the
// arithmetic below is the depthwise loop run over both planes.  Each thread
// owns one channel vector over a run of kR consecutive outputs and keeps
// their sums in registers.  For dilation 1 and 2 the taps are taken
// kTapBlock at a time from a register window of the strip (one window a
// plane), so one strip load feeds several FMA; any other dilation reads the
// strip once per FMA.  Every input element is read from device memory once
// per time tile (the halo rows of the next tile come from L2) and every
// output is written once.  The grid puts the batch row on x (no 65535 limit).
//
// Tiles.  M = 1 takes float4 vectors where C % 4 == 0 (64 channels a block)
// and time tiles of at most 64 outputs.  M = 2 takes single lanes (32 output
// channels, 64 input lanes a block) and tiles of at most 256 outputs: at
// MossFormer2-SS's k = 39, d = 2 the halo is 76 rows, and a float4 block of
// two planes over a 140-row strip would need 92 KB of shared memory for 4
// warps; single lanes over a 332-row strip need 95 KB for 32 warps, two
// blocks an SM.  PERF.md has the times of both.
//
// Every launcher returns cudaGetLastError() (or the error of the shared-
// memory opt-in) after its launch.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kR = 8;          // outputs per thread along time
constexpr int kTapBlock = 4;   // taps per register window
constexpr int kMaxGroups = 8;  // thread rows per block for M = 1, 4x as many for M = 2

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static constexpr int kLanes = 16;  // threads across a 64-channel tile
};
template <>
struct Vec<1> {
  using T = float;
  static constexpr int kLanes = 32;  // threads across a 32-channel tile
};

__device__ __forceinline__ float4 vfma(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}
__device__ __forceinline__ float vfma(float a, float b, float c) { return fmaf(a, b, c); }

template <class T>
__device__ __forceinline__ T vzero();
template <>
__device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }

template <class T>
__device__ __forceinline__ T vld(const float* p) { return *reinterpret_cast<const T*>(p); }
template <class T>
__device__ __forceinline__ void vst(float* p, T v) { *reinterpret_cast<T*>(p) = v; }

// The block's work.  C is the number of output channels (groups), the input
// has M*C lanes.  D: the dilation when known at compile time (1 or 2), 0 for
// any other.
template <int V, int D, int M>
__device__ __forceinline__ void dwconv_block(const float* __restrict__ x,
                                             const float* __restrict__ w, float* __restrict__ y,
                                             int T, int C, int k, int lo, int t_out, int dil_rt,
                                             int tile_t, int strip_rows) {
  static_assert(M == 1 || V == 1, "M = 2 stages single lanes");
  using VT = typename Vec<V>::T;
  constexpr int kLanes = Vec<V>::kLanes;
  constexpr int kCT = kLanes * V;  // output channels per tile
  constexpr int kRow = M * kCT;    // floats per strip row: M planes of kCT
    extern __shared__ __align__(16) float smem[];
  float* strip = smem;                     // [strip_rows][M][kCT]
  float* taps = smem + strip_rows * kRow;  // [k][M][kCT]

  const int dil = D > 0 ? D : dil_rt;
  const size_t b = blockIdx.x;
  const int t0 = blockIdx.y * tile_t;
  const int c0 = blockIdx.z * kCT;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int nthreads = kLanes * blockDim.y;
  const int cin = M * C;

  // Stage the halo strip (row r is input time t0 + r - lo; zero outside
  // [0, T) and past the input's lanes; input lane M*c0 + j goes to plane
  // j % M, column j / M) and the taps of this channel tile.
  const float* xb = x + b * T * cin;
  for (int e = tid; e < strip_rows * M * kLanes; e += nthreads) {
    const int r = e / (M * kLanes), l = e % (M * kLanes);
    const int t = t0 + r - lo, c = M * c0 + l * V;
    VT v = vzero<VT>();
    if (t >= 0 && t < T && c < cin) v = vld<VT>(xb + (size_t)t * cin + c);
    if constexpr (M == 1) {
      vst(strip + r * kCT + l * V, v);
    } else {
      strip[r * kRow + (l % M) * kCT + l / M] = v;
    }
  }
  for (int e = tid; e < k * M * kLanes; e += nthreads) {
    const int im = e / kLanes, l = e % kLanes;  // im = i*M + m
    const int c = c0 + l * V;
    vst(taps + im * kCT + l * V, c < C ? vld<VT>(w + (size_t)im * C + c) : vzero<VT>());
  }
  __syncthreads();

  const int lane = threadIdx.x;
  const float* sp = strip + threadIdx.y * kR * kRow + lane * V;  // this thread's first row
  const float* wp = taps + lane * V;
  VT acc[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = vzero<VT>();

  int i = 0;
  if constexpr (D > 0) {
    constexpr int kWin = kR + (kTapBlock - 1) * D;
    for (; i + kTapBlock <= k; i += kTapBlock) {
      VT win[M][kWin];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int r = 0; r < kWin; ++r) win[m][r] = vld<VT>(sp + (i * D + r) * kRow + m * kCT);
#pragma unroll
      for (int ii = 0; ii < kTapBlock; ++ii) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const VT wv = vld<VT>(wp + ((i + ii) * M + m) * kCT);
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[j] = vfma(win[m][j + ii * D], wv, acc[j]);
        }
      }
    }
  }
  for (; i < k; ++i) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const VT wv = vld<VT>(wp + (i * M + m) * kCT);
#pragma unroll
      for (int j = 0; j < kR; ++j)
        acc[j] = vfma(vld<VT>(sp + (j + i * dil) * kRow + m * kCT), wv, acc[j]);
    }
  }

  const int c = c0 + lane * V;
  if (c >= C) return;
  float* yb = y + b * t_out * C + c;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int t = t0 + threadIdx.y * kR + j;
    if (t < t_out) vst(yb + (size_t)t * C, acc[j]);
  }
}

// Two kernels by name, so that a trace tells B4's launches from B5's.
template <int V, int D>
__global__ void dwconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              float* __restrict__ y, int T, int C, int k, int lo, int t_out,
                              int dil_rt, int tile_t, int strip_rows) {
  dwconv_block<V, D, 1>(x, w, y, T, C, k, lo, t_out, dil_rt, tile_t, strip_rows);
}

template <int V, int D>
__global__ void dwconv_grouped_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                      float* __restrict__ y, int T, int C, int k, int lo,
                                      int t_out, int dil_rt, int tile_t, int strip_rows) {
  dwconv_block<V, D, 2>(x, w, y, T, C, k, lo, t_out, dil_rt, tile_t, strip_rows);
}

template <int V, int D, int M>
int launch(const float* x, const float* w, float* y, int batch, int T, int C, int k, int lo,
           int t_out, int dil, cudaStream_t stream) {
  constexpr int kCT = Vec<V>::kLanes * V;
  auto kernel = dwconv_kernel<V, D>;
  if constexpr (M == 2) kernel = dwconv_grouped_kernel<V, D>;
  // Time tiles of ny * kR outputs, ny <= kMaxRows, sized so that the tiles
  // cover t_out with little waste (98 outputs: two tiles of 56).
  constexpr int kMaxRows = M * M * kMaxGroups;
  const int n_tiles0 = (t_out + kR * kMaxRows - 1) / (kR * kMaxRows);
  const int per_tile = (t_out + n_tiles0 - 1) / n_tiles0;
  const int ny = (per_tile + kR - 1) / kR;
  const int tile_t = ny * kR;
  const int n_tiles = (t_out + tile_t - 1) / tile_t;
  const int strip_rows = tile_t + dil * (k - 1);
  const size_t smem = (size_t)(strip_rows + k) * M * kCT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(batch, n_tiles, (C + kCT - 1) / kCT);
  const dim3 block(Vec<V>::kLanes, ny);
  kernel<<<grid, block, smem, stream>>>(x, w, y, T, C, k, lo, t_out, dil, tile_t, strip_rows);
  return (int)cudaGetLastError();
}

template <int V, int M>
int launch_dil(const float* x, const float* w, float* y, int batch, int T, int C, int k, int lo,
               int t_out, int dil, cudaStream_t stream) {
  if (dil == 1) return launch<V, 1, M>(x, w, y, batch, T, C, k, lo, t_out, dil, stream);
  if (dil == 2) return launch<V, 2, M>(x, w, y, batch, T, C, k, lo, t_out, dil, stream);
  return launch<V, 0, M>(x, w, y, batch, T, C, k, lo, t_out, dil, stream);
}

template <int M>
int dwconv1d(const float* x, const float* w, float* y, int batch, int T, int C, int k, int lo,
             int hi, int dil, void* stream) {
  const long long t_out = (long long)T + lo + hi - (long long)dil * (k - 1);
  if (batch <= 0 || T <= 0 || C <= 0 || k <= 0 || lo < 0 || hi < 0 || dil <= 0 || t_out <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (M == 1) {
    if (C % 4 == 0 && ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16 == 0)
      return launch_dil<4, 1>(x, w, y, batch, T, C, k, lo, (int)t_out, dil, s);
  }
  return launch_dil<1, M>(x, w, y, batch, T, C, k, lo, (int)t_out, dil, s);
}

}  // namespace

extern "C" {

const char* ajt_dwconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// B4: x (batch, T, C), w (k, C), y (batch, T + lo + hi - dil*(k-1), C); all float32.
int ajt_dwconv1d_f32(const float* x, const float* w, float* y, int batch, int T, int C, int k,
                     int lo, int hi, int dil, void* stream) {
  return dwconv1d<1>(x, w, y, batch, T, C, k, lo, hi, dil, stream);
}

// B5: x (batch, T, 2*G), w (k, 2, G), y (batch, T + lo + hi - dil*(k-1), G); all float32.
int ajt_dwconv1d_grouped2_f32(const float* x, const float* w, float* y, int batch, int T, int G,
                              int k, int lo, int hi, int dil, void* stream) {
  return dwconv1d<2>(x, w, y, batch, T, G, k, lo, hi, dil, stream);
}

}  // extern "C"
