// True depthwise 1-D convolution for Hopper (sm_90a), float32 FMA (B4).
//
// Replaces dwconv1d_pallas (audiojax/ops/dwconv_pallas.py:52), and takes a
// dilation so that dwconv1d_pallas_tiled (B5, :120) can be routed here later:
//
//   y[b, t, c] = sum_{i<k} xpad[b, t + i*dil, c] * w[i, c]      (taps in order)
//
// x (B, T, C) and y (B, T_out, C) are channel-last and contiguous, w is
// (k, C), xpad is x with lo zero rows before and hi after, and
// T_out = T + lo + hi - dil*(k-1).
//
// What bounds it: bytes.  Each output needs k FMA and each input element is
// read by k outputs, so a kernel that reads x from device memory once is
// memory-bound whenever k is below ~20 (f32 rate / memory rate in flops per
// float); at the MossFormerGAN shapes (k = 31, 39) the two are close:
// (964, 101, 256) reads and writes ~200 MB, ~60 us at 3.35 TB/s, against
// 1.5 GFLOP, ~23 us at 67 TFLOP/s.
//
// Design.  A block owns (batch row, time tile, channel tile).  It stages its
// halo strip, tile + dil*(k-1) rows of its channels, in shared memory with
// the zero padding filled in, and the block's taps beside it; loads run along
// C, which is contiguous, as float4 where C % 4 == 0.  Each thread owns one
// channel vector (4 channels, or 1) over a run of kR consecutive outputs and
// keeps their sums in registers.  For dilation 1 and 2 the taps are taken
// kTapBlock at a time from a register window of the strip, so one strip
// load feeds up to kTapBlock FMA; any other dilation reads the strip once per
// FMA.  Every input element is read from device memory once per time tile
// (the halo rows of the next tile come from L2) and every output is written
// once.  The grid puts the batch row on x (no 65535 limit).
//
// Every launcher returns cudaGetLastError() (or the error of the shared-
// memory opt-in) after its launch.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kR = 8;          // outputs per thread along time
constexpr int kTapBlock = 4;   // taps per register window
constexpr int kMaxGroups = 8;  // thread rows per block: time tiles of <= 64 outputs

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

// D: the dilation when known at compile time (1 or 2), 0 for any other.
template <int V, int D>
__global__ void dwconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              float* __restrict__ y, int T, int C, int k, int lo, int t_out,
                              int dil_rt, int tile_t, int strip_rows) {
  using VT = typename Vec<V>::T;
  constexpr int kLanes = Vec<V>::kLanes;
  constexpr int kCT = kLanes * V;  // channels per tile
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;                    // [strip_rows][kCT]
  float* taps = smem + strip_rows * kCT;  // [k][kCT]

  const int dil = D > 0 ? D : dil_rt;
  const size_t b = blockIdx.x;
  const int t0 = blockIdx.y * tile_t;
  const int c0 = blockIdx.z * kCT;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int nthreads = kLanes * blockDim.y;

  // Stage the halo strip (row r is input time t0 + r - lo; zero outside
  // [0, T) and past C) and the taps of this channel tile.
  const float* xb = x + b * T * C;
  for (int e = tid; e < strip_rows * kLanes; e += nthreads) {
    const int r = e / kLanes, l = e % kLanes;
    const int t = t0 + r - lo, c = c0 + l * V;
    VT v = vzero<VT>();
    if (t >= 0 && t < T && c < C) v = vld<VT>(xb + (size_t)t * C + c);
    vst(strip + r * kCT + l * V, v);
  }
  for (int e = tid; e < k * kLanes; e += nthreads) {
    const int i = e / kLanes, l = e % kLanes;
    const int c = c0 + l * V;
    vst(taps + i * kCT + l * V, c < C ? vld<VT>(w + (size_t)i * C + c) : vzero<VT>());
  }
  __syncthreads();

  const int lane = threadIdx.x;
  const float* sp = strip + threadIdx.y * kR * kCT + lane * V;  // this thread's first row
  const float* wp = taps + lane * V;
  VT acc[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = vzero<VT>();

  int i = 0;
  if constexpr (D > 0) {
    constexpr int kWin = kR + (kTapBlock - 1) * D;
    for (; i + kTapBlock <= k; i += kTapBlock) {
      VT win[kWin];
#pragma unroll
      for (int r = 0; r < kWin; ++r) win[r] = vld<VT>(sp + (i * D + r) * kCT);
#pragma unroll
      for (int ii = 0; ii < kTapBlock; ++ii) {
        const VT wv = vld<VT>(wp + (i + ii) * kCT);
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[j] = vfma(win[j + ii * D], wv, acc[j]);
      }
    }
  }
  for (; i < k; ++i) {
    const VT wv = vld<VT>(wp + i * kCT);
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = vfma(vld<VT>(sp + (j + i * dil) * kCT), wv, acc[j]);
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

template <int V, int D>
int launch(const float* x, const float* w, float* y, int batch, int T, int C, int k, int lo,
           int t_out, int dil, cudaStream_t stream) {
  constexpr int kCT = Vec<V>::kLanes * V;
  // Time tiles of ny * kR outputs, ny <= kMaxGroups, sized so that the tiles
  // cover t_out with little waste (98 outputs: two tiles of 56).
  const int n_tiles0 = (t_out + kR * kMaxGroups - 1) / (kR * kMaxGroups);
  const int per_tile = (t_out + n_tiles0 - 1) / n_tiles0;
  const int ny = (per_tile + kR - 1) / kR;
  const int tile_t = ny * kR;
  const int n_tiles = (t_out + tile_t - 1) / tile_t;
  const int strip_rows = tile_t + dil * (k - 1);
  const size_t smem = (size_t)(strip_rows + k) * kCT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dwconv_kernel<V, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(batch, n_tiles, (C + kCT - 1) / kCT);
  const dim3 block(Vec<V>::kLanes, ny);
  dwconv_kernel<V, D><<<grid, block, smem, stream>>>(x, w, y, T, C, k, lo, t_out, dil, tile_t,
                                                     strip_rows);
  return (int)cudaGetLastError();
}

template <int V>
int launch_dil(const float* x, const float* w, float* y, int batch, int T, int C, int k, int lo,
               int t_out, int dil, cudaStream_t stream) {
  if (dil == 1) return launch<V, 1>(x, w, y, batch, T, C, k, lo, t_out, dil, stream);
  if (dil == 2) return launch<V, 2>(x, w, y, batch, T, C, k, lo, t_out, dil, stream);
  return launch<V, 0>(x, w, y, batch, T, C, k, lo, t_out, dil, stream);
}

}  // namespace

extern "C" {

const char* ajt_dwconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x (batch, T, C), w (k, C), y (batch, T + lo + hi - dil*(k-1), C); all float32.
int ajt_dwconv1d_f32(const float* x, const float* w, float* y, int batch, int T, int C, int k,
                     int lo, int hi, int dil, void* stream) {
  const long long t_out = (long long)T + lo + hi - (long long)dil * (k - 1);
  if (batch <= 0 || T <= 0 || C <= 0 || k <= 0 || lo < 0 || hi < 0 || dil <= 0 || t_out <= 0)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = C % 4 == 0 && ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec4 ? launch_dil<4>(x, w, y, batch, T, C, k, lo, (int)t_out, dil, s)
              : launch_dil<1>(x, w, y, batch, T, C, k, lo, (int)t_out, dil, s);
}

}  // extern "C"
