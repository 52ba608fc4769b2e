// STFT and ISTFT kernels for Hopper (sm_90a): one launch a call, each an FFT
// in shared memory.
//
// B1, stft_kernel, replaces stft_packed_pallas (audiojax/ops/stft_pallas.py:207,
// kernels _kernel and _kernel_kchunk); B2, istft_kernel, replaces
// istft_packed_pallas (stft_pallas.py:361, kernels _ikernel and _ikernel_kchunk).
//
// What bounds them: bytes.  An FFT does about 2.5·n·log2(n) operations a
// frame, so at the MossFormerGAN serving shape (32 windows of 24000 samples,
// 400/100) the functions need ~1 µs of the card's float32 rate (~2 µs of its
// float64 rate) against ~4.6 µs to read their input and write their output
// once at 3.35 TB/s.  So each kernel reads every input byte from device
// memory once and writes every output byte once, and keeps everything
// between in shared memory:
//
//   B1  One block takes a tile of frames of one batch row.  It stages the
//       tile's audio strip ((frames − 1)·hop + n_fft samples) into shared
//       memory with cp.async, resolving the centre pad as it goes (reflect
//       mirrors the index as dsp.pad_center does, constant pads zeros).  Its
//       first FFT stage reads the frames out of the strip times the window;
//       the last pass writes the packed [re | im] rows coalesced.  (The
//       Nyquist bin's imaginary part, rounding noise, is the plain version's
//       dense product: see the end of stft_kernel.)
//   B2  One block takes a tile of output hop-rows of one batch row.  It
//       transforms the frames that cover the tile (halo frames are
//       recomputed by both neighbouring blocks: no atomics), its first FFT
//       stage reading the spectra from device memory, multiplies by
//       window / n_fft, overlap-adds them in shared memory in frame order (a
//       deterministic sum), and in its epilogue multiplies by the COLA
//       reciprocal and writes only the samples in [start, end) of the final
//       (B, L_out) tensor.
//
// The FFT is a Stockham mixed-radix transform over a plan made on the host
// (dsp/stft.py: FftPlan and its twiddle table, computed in float64): radices
// 2, 3, 4, 5 and 8 have their own butterflies, any other prime runs a generic
// radix-p stage with one thread an output, so every n_fft works (319 =
// 11·29; a prime n_fft is one dense stage).  Even n_fft transforms the
// n_fft/2 complex points x[2i] + j·x[2i+1] and splits the result into the
// real spectrum (B1), or builds that half-length spectrum from the one-sided
// one (B2, the imaginary parts of DC and Nyquist ignored, as irfft and the
// plain basis do).  B2 runs the forward transform on the conjugate:
// ifft(Z) = conj(fft(conj(Z))).  The work buffers are skewed by one slot
// every 16 complex values, so the strided writes of the early stages do not
// pile onto a few banks.
//
// Precision: B1 computes in float32 with the table rounded once to float32.
// B2 computes in float64 (table, work buffers, overlap-add): an FFT spreads
// its rounding evenly over a frame, and where the COLA envelope is small (the
// two ends of an uncentred signal) the ISTFT divides it by the window, so a
// float32 FFT lost several times the plain dense product's accuracy there.
//
// Every launcher returns cudaGetLastError() after its launch, or the error of
// the shared-memory opt-in above 48 KB.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

struct Plan {
  int m;         // complex FFT length
  int n_stages;
  int radix[kMaxStages];
  int tw_off[kMaxStages];  // each stage's first twiddle in the table
  int post_off;            // W_{n_fft}^k, 0 <= k <= m (even n_fft)
};

// Skewed index into a work buffer row.
__host__ __device__ constexpr int sk(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int row_stride(int m) { return sk(m - 1) + 1; }

// Complex arithmetic on float2 (B1) and double2 (B2).
template <class C>
struct Cx;
template <>
struct Cx<float2> {
  using R = float;
  static __device__ __forceinline__ float2 make(float a, float b) { return make_float2(a, b); }
};
template <>
struct Cx<double2> {
  using R = double;
  static __device__ __forceinline__ double2 make(double a, double b) { return make_double2(a, b); }
};

template <class C>
__device__ __forceinline__ C cmul(C a, C b) {
  return Cx<C>::make(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
template <class C>
__device__ __forceinline__ C cadd(C a, C b) { return Cx<C>::make(a.x + b.x, a.y + b.y); }
template <class C>
__device__ __forceinline__ C csub(C a, C b) { return Cx<C>::make(a.x - b.x, a.y - b.y); }
template <class C>
__device__ __forceinline__ C cscale(C a, typename Cx<C>::R s) { return Cx<C>::make(a.x * s, a.y * s); }
// -i·a
template <class C>
__device__ __forceinline__ C mul_mi(C a) { return Cx<C>::make(a.y, -a.x); }

// n / d by one multiply-high, exact for 0 <= n < 2^32 / d: the index
// arithmetic of every loop below, where a hardware division would cost
// about as much as a butterfly.
struct FastDiv {
  unsigned d, mul;
  __device__ explicit FastDiv(int div)
      : d(div), mul(div > 1 ? 0xFFFFFFFFu / (unsigned)div + 1u : 0u) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : (int)__umulhi((unsigned)n, mul);
  }
};

// In-place forward DFTs of R points (W = e^{-2πi/R}); constants in double,
// rounded once to the element type.
template <class C>
__device__ __forceinline__ void dft(C (&v)[2]) {
  const C a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <class C>
__device__ __forceinline__ void dft(C (&v)[3]) {
  using S = typename Cx<C>::R;
  const S kS = S(0.86602540378443865);  // sin(2π/3)
  const C t = cadd(v[1], v[2]);
  const C m = csub(v[0], cscale(t, S(0.5)));
  const C d = cscale(mul_mi(csub(v[1], v[2])), kS);
  v[0] = cadd(v[0], t);
  v[1] = cadd(m, d);
  v[2] = csub(m, d);
}

template <class C>
__device__ __forceinline__ void dft(C (&v)[4]) {
  const C t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const C t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

template <class C>
__device__ __forceinline__ void dft(C (&v)[5]) {
  using S = typename Cx<C>::R;
  const S kC1 = S(0.30901699437494742), kC2 = S(-0.80901699437494742);  // cos 2π/5, 4π/5
  const S kS1 = S(0.95105651629515357), kS2 = S(0.58778525229247313);   // sin 2π/5, 4π/5
  const C b1 = cadd(v[1], v[4]), b2 = cadd(v[2], v[3]);
  const C d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const C r1 = cadd(v[0], cadd(cscale(b1, kC1), cscale(b2, kC2)));
  const C r2 = cadd(v[0], cadd(cscale(b1, kC2), cscale(b2, kC1)));
  const C u = mul_mi(cadd(cscale(d1, kS1), cscale(d2, kS2)));
  const C w = mul_mi(csub(cscale(d1, kS2), cscale(d2, kS1)));
  v[0] = cadd(v[0], cadd(b1, b2));
  v[1] = cadd(r1, u);
  v[4] = csub(r1, u);
  v[2] = cadd(r2, w);
  v[3] = csub(r2, w);
}

// 8 = 2 × 4: DFTs of the even and odd points, the odd ones times W8^k.
template <class C>
__device__ __forceinline__ void dft(C (&v)[8]) {
  using S = typename Cx<C>::R;
  const S kR = S(0.70710678118654752);  // √½
  C e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft(e);
  dft(o);
  o[1] = Cx<C>::make(kR * (o[1].x + o[1].y), kR * (o[1].y - o[1].x));   // · W8
  o[2] = mul_mi(o[2]);                                                  // · W8^2
  o[3] = Cx<C>::make(kR * (o[3].y - o[3].x), -kR * (o[3].x + o[3].y));  // · W8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// One Stockham stage of radix R on n_rows rows: butterfly j of a row reads
// its inputs at j + r·m/R, twiddles input r by W_{ns·R}^{k·r} (k = j mod ns),
// and writes output r at (j − k)·R + k + r·ns.
template <int R, class C>
__device__ void stage_fixed(const C* src, C* dst, const C* __restrict__ tw, int m, int ns,
                            int n_rows, int stride) {
  const int nb = m / R;
  const FastDiv by_nb(nb), by_ns(ns);
  for (int u = threadIdx.x; u < n_rows * nb; u += blockDim.x) {
    const int f = by_nb(u), j = u - f * nb, k = j - by_ns(j) * ns;
    const C* s = src + f * stride;
    C v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[sk(j + r * nb)];
    if (k > 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(&tw[k * (R - 1) + r - 1]));
    }
    dft(v);
    C* d = dst + f * stride;
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) d[sk(base + r * ns)] = v[r];
  }
}

// The same stage for any radix, one thread an output: the inputs are
// twiddled in place first, then output q of butterfly j is their dot
// product with the roots W_R^{r·q} that follow the twiddles in the table.
template <class C>
__device__ void stage_generic(C* src, C* dst, const C* __restrict__ tw, int radix, int m, int ns,
                              int n_rows, int stride) {
  const int nb = m / radix;
  const C* roots = tw + ns * (radix - 1);
  const FastDiv by_m(m), by_nb(nb), by_ns(ns);
  if (ns > 1) {
    for (int u = threadIdx.x; u < n_rows * m; u += blockDim.x) {
      const int f = by_m(u), i = u - f * m, r = by_nb(i), j = i - r * nb, k = j - by_ns(j) * ns;
      if (r > 0) {
        C* s = src + f * stride + sk(i);
        *s = cmul(*s, __ldg(&tw[k * (radix - 1) + r - 1]));
      }
    }
    __syncthreads();
  }
  for (int u = threadIdx.x; u < n_rows * m; u += blockDim.x) {
    const int f = by_m(u), v = u - f * m, q = by_nb(v), j = v - q * nb, k = j - by_ns(j) * ns;
    const C* s = src + f * stride;
    C acc = s[sk(j)];
    int e = 0;  // r·q mod radix
    for (int r = 1; r < radix; ++r) {
      e += q;
      if (e >= radix) e -= radix;
      const C x = s[sk(j + r * nb)], w = __ldg(&roots[e]);
      acc = Cx<C>::make(fma(x.x, w.x, fma(-x.y, w.y, acc.x)), fma(x.x, w.y, fma(x.y, w.x, acc.y)));
    }
    dst[f * stride + sk((j - k) * radix + k + q * ns)] = acc;
  }
}

// The first stage (ns = 1, no twiddles) of radix R, its inputs taken
// straight from the kernel's source through load(f, i): point i of row f.
template <int R, class C, class Load>
__device__ void stage_first(const Load& load, C* dst, int m, int n_rows, int stride) {
  const int nb = m / R;
  const FastDiv by_nb(nb);
  for (int u = threadIdx.x; u < n_rows * nb; u += blockDim.x) {
    const int f = by_nb(u), j = u - f * nb;
    C v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = load(f, j + r * nb);
    dft(v);
    C* d = dst + f * stride;
#pragma unroll
    for (int r = 0; r < R; ++r) d[sk(j * R + r)] = v[r];
  }
}

// Runs the plan on n_rows rows whose points load(f, i) gives; a and b are
// the work buffers.  Returns the buffer that holds the spectra, in natural
// order.  Every thread of the block calls it.
template <class C, class Load>
__device__ C* run_fft(const Load& load, C* a, C* b, const Plan& p, const C* __restrict__ tw,
                      int n_rows, int stride) {
  int s = 1, ns = p.radix[0];
  switch (ns) {  // the first stage reads the source itself ...
    case 2: stage_first<2>(load, a, p.m, n_rows, stride); break;
    case 3: stage_first<3>(load, a, p.m, n_rows, stride); break;
    case 4: stage_first<4>(load, a, p.m, n_rows, stride); break;
    case 5: stage_first<5>(load, a, p.m, n_rows, stride); break;
    case 8: stage_first<8>(load, a, p.m, n_rows, stride); break;
    default: {  // ... unless it is generic, which starts from the loaded rows
      const FastDiv by_m(p.m);
      for (int u = threadIdx.x; u < n_rows * p.m; u += blockDim.x) {
        const int f = by_m(u), i = u - f * p.m;
        a[f * stride + sk(i)] = load(f, i);
      }
      s = 0;
      ns = 1;
    }
  }
  __syncthreads();
  for (; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    const C* t = tw + p.tw_off[s];
    switch (r) {
      case 2: stage_fixed<2>(a, b, t, p.m, ns, n_rows, stride); break;
      case 3: stage_fixed<3>(a, b, t, p.m, ns, n_rows, stride); break;
      case 4: stage_fixed<4>(a, b, t, p.m, ns, n_rows, stride); break;
      case 5: stage_fixed<5>(a, b, t, p.m, ns, n_rows, stride); break;
      case 8: stage_fixed<8>(a, b, t, p.m, ns, n_rows, stride); break;
      default: stage_generic(a, b, t, r, p.m, ns, n_rows, stride); break;
    }
    __syncthreads();
    C* c = a;
    a = b;
    b = c;
    ns *= r;
  }
  return a;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

// B1's points: point i of frame f read out of the strip, times the window.
struct StripLoad {
  const float* strip;
  const float* win;
  int hop;
  bool even;
  __device__ __forceinline__ float2 operator()(int f, int i) const {
    const float* s = strip + f * hop;
    return even ? make_float2(s[2 * i] * __ldg(&win[2 * i]), s[2 * i + 1] * __ldg(&win[2 * i + 1]))
                : make_float2(s[i] * __ldg(&win[i]), 0.f);
  }
};

// B2's points: the conjugate of the spectrum that frame f's inverse
// transforms.  For even n_fft the half-length one,
// Z[k] = (X[k] + conj X[m−k]) + i·W^−k·(X[k] − conj X[m−k]); for odd n_fft
// the Hermitian extension.  Im X[0] and Im X[n_fft/2] are ignored.
struct SpecLoad {
  const float* rows;    // the group's first packed frame
  const double2* post;  // W_{n_fft}^k
  int f_bins, m, n_fft;
  bool even;
  __device__ __forceinline__ double2 operator()(int f, int k) const {
    const float* row = rows + (size_t)f * 2 * f_bins;
    if (even) {
      const int kc = m - k;  // in (0, m]
      const double2 a = make_double2(row[k], k == 0 ? 0.f : row[f_bins + k]);
      const double2 c = make_double2(row[kc], kc == m ? 0.f : -row[f_bins + kc]);
      const double2 w = __ldg(&post[k]);
      const double2 wd = cmul(make_double2(w.x, -w.y), csub(a, c));
      return make_double2(a.x + c.x - wd.y, -(a.y + c.y + wd.x));
    }
    if (k < f_bins) return make_double2(row[k], k == 0 ? 0.f : -row[f_bins + k]);
    return make_double2(row[n_fft - k], row[f_bins + n_fft - k]);
  }
};

// Shared memory: two work buffers of `rows` rows of C, then `extra` bytes.
template <class C>
size_t smem_bytes(int m, int rows, long long extra) {
  return 2 * sizeof(C) * (size_t)rows * row_stride(m) + (size_t)extra;
}

__global__ void __launch_bounds__(kThreads)
stft_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float* __restrict__ nyq, const float2* __restrict__ tw,
            float* __restrict__ out, const Plan p, int len, int n_t, int n_fft, int hop,
            int half, int reflect, int frames, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * frames;
  const int nf = min(frames, n_t - t0), m = p.m, stride = row_stride(m);
  float2* buf_a = reinterpret_cast<float2*>(smem);
  float2* buf_b = buf_a + frames * stride;
  float* strip = reinterpret_cast<float*>(buf_b + frames * stride);

  // the audio strip of this tile, centre pad resolved: strip[i] is padded
  // sample t0·hop + i, that is x[t0·hop − half + i]
  const float* xb = x + (size_t)b * len;
  const int strip_len = (nf - 1) * hop + n_fft, i0 = t0 * hop - half;
  for (int i = threadIdx.x; i < strip_len; i += blockDim.x) {
    const int s = i0 + i;
    if (s >= 0 && s < len)
      cp_async4(&strip[i], xb + s);
    else if (reflect)
      strip[i] = xb[s < 0 ? -s : 2 * len - 2 - s];
    else
      strip[i] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const bool even = (n_fft & 1) == 0;
  const float2* z = run_fft(StripLoad{strip, win, hop, even}, buf_a, buf_b, p, tw, nf, stride);

  // spectra, packed [re | im]; for even n_fft from Z (the half-length FFT):
  // X[k] = (Z[k] + conj Z[m−k]) / 2 − i·W^k·(Z[k] − conj Z[m−k]) / 2
  const int f_bins = n_fft / 2 + 1, f2 = 2 * f_bins;
  float* ob = out + ((size_t)b * n_t + t0) * f2;
  const FastDiv by_bins(f_bins);
  for (int u = threadIdx.x; u < nf * f_bins; u += blockDim.x) {
    const int f = by_bins(u), k = u - f * f_bins;
    const float2* zr = z + f * stride;
    float2 X;
    if (even) {
      const float2 a = zr[sk(k == m ? 0 : k)], c0 = zr[sk(k == 0 ? 0 : m - k)];
      const float2 c = make_float2(c0.x, -c0.y);
      const float2 wd = cmul(__ldg(&tw[p.post_off + k]), csub(a, c));
      X = make_float2(0.5f * (a.x + c.x + wd.y), 0.5f * (a.y + c.y - wd.x));
    } else {
      X = zr[sk(k)];
    }
    ob[(size_t)f * f2 + k] = X.x;
    if (!even || k < m) ob[(size_t)f * f2 + f_bins + k] = X.y;
  }

  // Im X[n_fft/2]: zero for real input, so its value is rounding noise in
  // any implementation, and a model's phase feature (ZipEnhancer's atan2)
  // takes that noise's sign.  It is the dot product with the plain basis's
  // own column, one warp a frame, so that the sign is the plain version's.
  if (even) {
    const int lane = threadIdx.x & 31;
    for (int f = threadIdx.x >> 5; f < nf; f += blockDim.x >> 5) {
      const float* s = strip + f * hop;
      float acc = 0.f;
      for (int n = lane; n < n_fft; n += 32) acc = fmaf(s[n], __ldg(&nyq[n]), acc);
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) ob[(size_t)f * f2 + f_bins + m] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
istft_kernel(const float* __restrict__ spec, const float* __restrict__ win,
             const double2* __restrict__ tw, const float* __restrict__ cola,
             float* __restrict__ out, const Plan p, int n_t, int n_fft, int hop, int start,
             int out_len, int row_first, int rows, int group, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / tiles, r0 = row_first + (blockIdx.x % tiles) * rows;
  const int m = p.m, stride = row_stride(m);
  double2* buf_a = reinterpret_cast<double2*>(smem);
  double2* buf_b = buf_a + group * stride;
  double* acc = reinterpret_cast<double*>(buf_b + group * stride);

  // this tile's output samples [p_lo, p_hi) of the overlap-added signal, and
  // the frames that cover them
  const int p_lo = max(r0 * hop, start), p_hi = min((r0 + rows) * hop, start + out_len);
  const int t_lo = max(0, floor_div(p_lo - n_fft, hop) + 1), t_hi = min(n_t - 1, (p_hi - 1) / hop);
  for (int q = p_lo + threadIdx.x; q < p_hi; q += blockDim.x) acc[q - p_lo] = 0.0;

  const bool even = (n_fft & 1) == 0;
  const int f_bins = n_fft / 2 + 1, f2 = 2 * f_bins, k_seg = (n_fft + hop - 1) / hop;
  const float* sb = spec + (size_t)b * n_t * f2;
  const FastDiv by_hop(hop);
  for (int g0 = t_lo; g0 <= t_hi; g0 += group) {
    const int ng = min(group, t_hi - g0 + 1);
    const SpecLoad load{sb + (size_t)g0 * f2, tw + p.post_off, f_bins, m, n_fft, even};
    const double2* z = run_fft(load, buf_a, buf_b, p, tw, ng, stride);

    // overlap-add, frame by frame in order: sample n of frame t is
    // Re z[n] (odd n_fft), or Re / −Im of z[n/2] (even n_fft).  Frames
    // t·hop <= q < t·hop + n_fft, counted from r0 (q − r0·hop >= 0).
    for (int q = p_lo + threadIdx.x; q < p_hi; q += blockDim.x) {
      const int ql = q - r0 * hop;
      const int fl = max(g0, r0 + by_hop(ql + k_seg * hop - n_fft) + 1 - k_seg);
      const int fh = min(g0 + ng - 1, r0 + by_hop(ql));
      double s = acc[q - p_lo];
      for (int t = fl; t <= fh; ++t) {
        const int n = q - t * hop;
        const double2* zr = z + (t - g0) * stride;
        const double y = even ? ((n & 1) ? -zr[sk(n >> 1)].y : zr[sk(n >> 1)].x) : zr[sk(n)].x;
        s = fma(y, (double)__ldg(&win[n]), s);
      }
      acc[q - p_lo] = s;
    }
    __syncthreads();  // the next group overwrites the work buffers
  }

  float* ob = out + (size_t)b * out_len;
  for (int q = p_lo + threadIdx.x; q < p_hi; q += blockDim.x)
    ob[q - start] = (float)(acc[q - p_lo] * __ldg(&cola[q - start]));
}

// The plan's stages from the host's arrays; false if they do not make m.
bool make_plan(Plan& p, int m, int n_stages, const int* radices, const int* offsets,
               int post_off) {
  if (m <= 0 || n_stages < 0 || n_stages > kMaxStages) return false;
  p.m = m;
  p.n_stages = n_stages;
  p.post_off = post_off;
  long long prod = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    p.radix[s] = s < n_stages ? radices[s] : 1;
    p.tw_off[s] = s < n_stages ? offsets[s] : 0;
    if (s < n_stages) {
      if (radices[s] < 2) return false;
      prod *= radices[s];
    }
  }
  return prod == m;
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* ajt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x (batch, len) audio, win (n_fft) analysis window, nyq (n_fft) the plain
// basis's column of Im X[n_fft/2] (read for even n_fft only), tw the plan's
// float32 twiddle table, out (batch, n_t, 2F).  half = n_fft/2 with centre padding,
// else 0; reflect selects the reflect pad (else zeros).  One block per
// `frames` frames of a batch row.
int ajt_stft_packed_f32(const float* x, const float* win, const float* nyq, const float* tw,
                        float* out, int batch,
                        int len, int n_t, int n_fft, int hop, int half, int reflect, int frames,
                        int m, int n_stages, const int* radices, const int* offsets, int post_off,
                        void* stream) {
  Plan p;
  if (batch <= 0 || n_t <= 0 || n_fft <= 0 || hop <= 0 || frames <= 0 || half < 0 ||
      (long long)(n_t - 1) * hop + n_fft > (long long)len + 2 * half ||
      (reflect && half >= len) || !make_plan(p, m, n_stages, radices, offsets, post_off) ||
      m != ((n_fft & 1) ? n_fft : n_fft / 2))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_t + frames - 1) / frames;
  const size_t smem = smem_bytes<float2>(m, frames, 4LL * ((frames - 1) * hop + n_fft));
  cudaError_t e = opt_in(stft_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  stft_kernel<<<batch * tiles, kThreads, smem, (cudaStream_t)stream>>>(
      x, win, nyq, reinterpret_cast<const float2*>(tw), out, p, len, n_t, n_fft, hop, half,
      reflect, frames, tiles);
  return (int)cudaGetLastError();
}

// spec (batch, n_t, 2F), win (n_fft) synthesis window / n_fft, tw the plan's
// float64 twiddle table, cola (out_len) the COLA reciprocal of
// [start, start + out_len), out (batch, out_len).  One block per `rows`
// hop-rows of a batch row, from row start / hop; `group` frames are
// transformed at a time.
int ajt_istft_packed_f32(const float* spec, const float* win, const double* tw, const float* cola,
                         float* out, int batch, int n_t, int n_fft, int hop, int start,
                         int out_len, int rows, int group, int m, int n_stages,
                         const int* radices, const int* offsets, int post_off, void* stream) {
  Plan p;
  if (batch <= 0 || n_t <= 0 || n_fft <= 0 || hop <= 0 || start < 0 || out_len <= 0 ||
      rows <= 0 || group <= 0 ||
      (long long)start + out_len > (long long)n_fft + (long long)hop * (n_t - 1) ||
      !make_plan(p, m, n_stages, radices, offsets, post_off) ||
      m != ((n_fft & 1) ? n_fft : n_fft / 2))
    return (int)cudaErrorInvalidValue;
  const int row_first = start / hop, row_last = (start + out_len - 1) / hop;
  const int tiles = (row_last - row_first + rows) / rows;
  const size_t smem = smem_bytes<double2>(m, group, 8LL * rows * hop);
  cudaError_t e = opt_in(istft_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  istft_kernel<<<batch * tiles, kThreads, smem, (cudaStream_t)stream>>>(
      spec, win, reinterpret_cast<const double2*>(tw), cola, out, p, n_t, n_fft, hop, start,
      out_len, row_first, rows, group, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
