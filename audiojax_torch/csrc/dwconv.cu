// Depthwise and grouped 2-in/1-out 1-D convolution for Hopper (sm_90a),
// float32 FMA (B4 and B5), on float32 or bfloat16 tensors.
//
// One output channel per group, M input lanes per group (M = 1 or 2):
//
//   y[b, t, g] = sum_{i<k} sum_{m<M} xpad[b, t + i*dil, g*M + m] * w[i, m, g]
//                                                        (taps outer, m inner)
//
// x (B, T, M*G) and y (B, T_out, G) are channel-last and contiguous; w is
// (k, M, G) read through its strides (si, sm, sg), so the model's (G, M, k)
// weight reaches the kernel as a permuted view with no copy; xpad is x with
// lo zero rows before and hi after, and T_out = T + lo + hi - dil*(k-1).
// The lanes of group g are interleaved, [M*g, M*g + M), as torch's groups=
// and lax's feature_group_count read them.
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
// (964, 98, 256) k31 moves ~194 MB, 57.8 us at 3.35 TB/s, against 1.5 GFLOP,
// 22 us at 67 TFLOP/s.  So the arithmetic must run under the loads, not
// after them, and must not itself be held back by shared memory.
//
// Design.  A block owns a channel tile of 32 input floats (a float4 or, for
// rows of at most 64 outputs, one float a thread: VC; the tile's row is 128
// bytes) and walks
// several work items (ipb), each one batch row's span of outputs:
//
//   - short rows (carry = 0; every MossFormerGAN and ZipEnhancer shape, T_out
//     <= 256): an item is a whole batch row, so no row is staged twice, and
//     the block walks ipb consecutive batch rows;
//   - long rows (carry = 1; MossFormer2-SS, T = 3999): an item is a time tile
//     of `tile` outputs, and the block walks ipb consecutive tiles of one
//     batch row (a chunk), carrying the dil*(k-1) halo rows from one tile to
//     the next in the ring instead of loading them again.
//
// The channel tiles of one item group are neighbours in the launch order
// (block i is tile i % n_ct), so the blocks that read a row's bytes run
// together.  Strip rows go into a ring of nb rows in shared memory by
// cp.async (16-byte copies on the vector path, 4-byte on the scalar one),
// the zero padding and the channels past C coming from the copy's zero-fill
// (src-size 0).  Items n+1 .. n+depth-1 are in flight while item n's FMAs
// run (depth 2 or 3): the ring holds depth items (nb = depth*(tile + H) for
// short rows, none wrapping; nb >= depth*tile + H for long ones; H =
// dil*(k-1)), and two barriers an item keep a slot from being refilled
// while it is read.  The block's taps are staged once, for all its items,
// by 4-byte cp.async from w's strides, neighbouring threads on neighbouring
// addresses, after item 0's strip copies (dwconv_geometry_sweep.py times
// the model's weight view against a contiguous weight).
//
// Each thread owns R outputs of one channel vector at stride dil, t = q +
// j*dil (j < R), in groups of dil threads: its dilated conv is then a dense
// one over its own decimated rows q + r*dil.  B5 (and B4 with k < R) slides
// a register window of R rows over all k taps: tap i loads ONE new strip row
// (row i + R - 1 into slot (i + R - 1) mod R of the window, the tap loop
// unrolled by R so the slot is a compile-time register) and one tap vector,
// and feeds R FMA vectors: 2/R shared floats a FMA (R = 8: 0.25, R = 16:
// 0.125), for M = 2 too (its float4 holds two groups' lane pairs and feeds 4
// FMA).  B4 at R = 8 with k >= R turns it round: a window of R taps slides
// over the rows, row r feeding output j with tap r - j, one new row and one
// new tap a row for R FMA vectors again; the last R - 1 rows read their
// R(R-1)/2 taps from shared memory.  In trial comparisons it beat the row
// window at R = 8 (the MossFormerGAN and ZipEnhancer shapes, alone and in a
// served request) and lost at R = 16 (MossFormer2-SS in a served request,
// where those tap reads are 120 an item) and at B5's shapes, so each keeps
// the faster.  The first
// design reloaded R + 3*dil rows every 4 taps (~0.47 floats a FMA; B5's
// scalar planes ~0.56), at the limit of shared memory's 32 floats a clock
// against 128 FMA lanes.  Where no group of dil threads fits a block (a
// dilation past 32 to 64, by R and VC), a thread takes R consecutive outputs
// instead and reads each row at its use (direct).
//
// What holds it now: the FFMAs.  Each reads the window row and the sum
// (the tap comes from the operand reuse cache), both in aligned register
// quads (the vector load, the vector store), so the two sit in the same
// register bank (register n is in bank n % 2) in every FFMA, and it issues
// at a reduced rate.  dwconv_probe.py times the loop on registers alone, and
// a loop of FFMAs whose non-reused sources share a bank against one whose
// sources do not.  Taps taken in pairs to reuse the row's register, and
// taps or rows rotated in shared memory against the sums' banks, were each
// tried and were no faster: ptxas reorders the FFMAs and moves the sums and
// rows between registers (PERF.md, §6).
//
// B5 stages the interleaved lanes as they lie (a float4 is groups g, g+1's
// [lane 0, lane 1] pairs) and its taps as matching pairs (w[i,0,g], w[i,1,g],
// w[i,0,g+1], w[i,1,g+1]): no deinterleave, no scalar shared stores.  Every
// output adds its taps in order i = 0 .. k-1 (B5: lane 0 then lane 1 of each
// tap) with fmaf, from zero.
//
// bfloat16 (the bf16 serving plan; the only dtype dwconv1d_pallas_tiled ever
// sees, audiojax/nn/core.py:219-252): x, w and y are bf16 and everything
// else is as above.  Strip rows stay bf16 in the ring, 8 elements a 16-byte
// cp.async (the vector path needs C % 8 and x 16-byte aligned; cp.async has
// no 2-byte copy, so the scalar path's copies are ordinary loads and shared
// stores), and a thread widens its VC elements to f32 in registers as it
// reads them (one 8-byte read for VC = 4).  The taps are widened once, as the
// block stages them (ordinary loads: w is read through its strides, 2 bytes
// an element), and stay f32 in shared memory.  The sums are the f32 FMA
// chain above; each output is rounded once to bf16, to nearest even, as
// astype does.  A bf16 ring row is 64 bytes, so a ring holds twice the rows
// in the same bytes; the rest of the design is unchanged.  B4's and B5's
// bf16 calls on the vector path with k <= 49 (every served one) run on the
// tensor cores instead (dwconv_bf16.cu; ops/dwconv_cuda.py:mma_route); this
// instance serves the rest of their bf16 calls (C % 8 != 0, an unaligned x,
// longer kernels).
//
// The geometry (copy width, VC, R, time threads, items, ring depth, grid,
// shared memory) comes from dwconv_launch in ops/dwconv_cuda.py, whose picks
// come from dwconv_geometry_sweep.py; the launcher only checks it and
// returns cudaErrorInvalidValue for a plan that does not fit, or the error
// of the shared-memory opt-in, or cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace {

template <int N>
struct VecT;
template <>
struct VecT<1> {
  using T = float;
};
template <>
struct VecT<2> {
  using T = float2;
};
template <>
struct VecT<4> {
  using T = float4;
};

__device__ __forceinline__ void vzero(float& a) { a = 0.f; }
__device__ __forceinline__ void vzero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void vzero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }

template <class T>
__device__ __forceinline__ T vld(const float* p) {
  return *reinterpret_cast<const T*>(p);
}

// A vector T (float, float2, float4) of consecutive elements of E, widened
// to f32: one load of 4, 8 or 16 bytes (bf16: 2, 4 or 8).
template <class T, class E>
__device__ __forceinline__ T ldw(const E* p) {
  if constexpr (std::is_same_v<E, float>) {
    return *reinterpret_cast<const T*>(p);
  } else if constexpr (std::is_same_v<T, float4>) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y), hi_bf16(u.y));
  } else if constexpr (std::is_same_v<T, float2>) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    return make_float2(lo_bf16(u), hi_bf16(u));
  } else {
    return widen(*p);
  }
}

// Store an f32 vector T as consecutive elements of E (bf16: rounded).
template <class E, class T>
__device__ __forceinline__ void stw(E* p, T v) {
  if constexpr (std::is_same_v<E, float>) {
    *reinterpret_cast<T*>(p) = v;
  } else if constexpr (std::is_same_v<T, float4>) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  } else if constexpr (std::is_same_v<T, float2>) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v.x, v.y);
  } else {
    p->u = (unsigned short)bf16_bits(v);
  }
}

// acc += x * w for one tap: M = 1 lane by lane; M = 2 a group's lane 0, then
// its lane 1.
__device__ __forceinline__ void tap_fma(float& acc, float x, float w) { acc = fmaf(x, w, acc); }
__device__ __forceinline__ void tap_fma(float4& acc, float4 x, float4 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
  acc.z = fmaf(x.z, w.z, acc.z);
  acc.w = fmaf(x.w, w.w, acc.w);
}
__device__ __forceinline__ void tap_fma(float& acc, float2 x, float2 w) {
  acc = fmaf(x.y, w.y, fmaf(x.x, w.x, acc));
}
__device__ __forceinline__ void tap_fma(float2& acc, float4 x, float4 w) {
  acc.x = fmaf(x.y, w.y, fmaf(x.x, w.x, acc.x));
  acc.y = fmaf(x.w, w.w, fmaf(x.z, w.z, acc.y));
}

// One copy of N elements from global to shared memory, asynchronously;
// zeros where !valid (src-size 0, src then only a valid address).  16 or 4
// bytes; a single bf16 (2 bytes, which cp.async cannot copy) is an ordinary
// load and shared store, which the barrier after the ring's wait publishes.
template <int N, class E>
__device__ __forceinline__ void cp_async(E* dst, const E* src, bool valid) {
  constexpr int kBytes = N * (int)sizeof(E);
  static_assert(kBytes == 16 || kBytes == 4 || kBytes == 2, "a 16-, 4- or 2-byte copy");
  if constexpr (kBytes == 2) {
    *dst = valid ? *src : E{};
  } else {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(valid ? 16 : 0));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                   "r"(valid ? 4 : 0));
    }
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most depth - 1 groups of this thread's copies are in flight.
__device__ __forceinline__ void cp_wait(int depth) {
  if (depth == 2) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

template <class E>
struct Args {
  const E* x;
  const E* w;
  E* y;
  long long si, sm, sg;  // w's strides, in elements
  int batch, T, cin, cout, k, lo, t_out, dil;
  int ntt;      // time threads: blockDim.x = 32 / VC * ntt
  int tile;     // outputs of a work item: ntt * R
  int carry;    // 1: items are time tiles of one batch row, halo carried
  int ipb;      // items a block
  int depth;    // items in the ring: depth - 1 in flight while one computes
  int direct;   // 1: a thread's outputs are consecutive, each row read at its use
  int chunks;   // carry: chunks of ipb tiles a batch row
  int n_tiles;  // carry: tiles a batch row
  int nb;       // ring rows
  int n_ct;     // channel tiles: block i is channel tile i % n_ct of item group i / n_ct
};

// Item n of this block: its batch row, its first output, its ring slot base
// and the first of its rows that is not in the ring yet.
struct Item {
  int b, t0, sb, first;
};

template <class E>
__device__ __forceinline__ Item item_of(const Args<E>& a, int grp, int n) {
  const int span = a.tile + a.dil * (a.k - 1);
  Item it;
  if (a.carry) {
    it.b = grp / a.chunks;
    it.t0 = ((grp % a.chunks) * a.ipb + n) * a.tile;
    it.sb = (n * a.tile) % a.nb;
    it.first = n > 0 ? span - a.tile : 0;  // the halo is carried
  } else {
    it.b = grp * a.ipb + n;
    it.t0 = 0;
    it.sb = (n * span) % a.nb;
    it.first = 0;
  }
  return it;
}

constexpr int kCT = 32;  // input elements of a strip row: the channel tile

// The block's work.  E the element type (float or bf16), GRAN elements a
// copy (16 bytes: 4 floats or 8 bf16; or 1), VC input elements a thread in
// the FMA loop (32 / VC threads across the channel tile), R outputs a
// thread; CARRY: items are time tiles (a.carry), whose rows wrap around the
// ring.
template <class E, int M, int GRAN, int VC, int R, bool CARRY>
__device__ __forceinline__ void dwconv_block(const Args<E>& a) {
  using VI = typename VecT<VC>::T;
  using VO = typename VecT<VC / M>::T;
  constexpr int kLanes = kCT / VC;
  constexpr int kCopies = kCT / GRAN;  // copies a row
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);                           // [nb][kCT] of E
  float* taps = reinterpret_cast<float*>(ring + (size_t)a.nb * kCT);  // [k][kCT], f32

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % kLanes, tt = tid / kLanes;
  // the channel tiles of one item group are neighbours in the launch order,
  // so the blocks reading one row's bytes run together
  const int grp = blockIdx.x / a.n_ct;
  const int g0 = blockIdx.x % a.n_ct * (kCT / M);  // first output channel of the tile
  const int c0 = M * g0;                  // its first input lane
  const int span = a.tile + a.dil * (a.k - 1);
  const int n_items = a.carry ? min(a.ipb, a.n_tiles - grp % a.chunks * a.ipb)
                              : min(a.ipb, a.batch - grp * a.ipb);

  // Rows [first, span) of item n into the ring: row q is input time
  // t0 + q - lo, zero outside [0, T) and past the input's lanes.
  auto stage = [&](int n) {
    const Item it = item_of(a, grp, n);
    const E* xb = a.x + (size_t)it.b * a.T * a.cin;
    const int count = (span - it.first) * kCopies;
    for (int e = tid; e < count; e += nthreads) {
      const int q = it.first + e / kCopies, l = e % kCopies;
      int s = it.sb + q;
      if (s >= a.nb) s -= a.nb;
      const int t = it.t0 + q - a.lo, c = c0 + l * GRAN;
      const bool ok = t >= 0 && t < a.T && c < a.cin;
      cp_async<GRAN>(ring + (size_t)s * kCT + l * GRAN,
                     ok ? xb + (size_t)t * a.cin + c : a.x, ok);
    }
  };

  // Group 0: item 0's strip, first so that it is in flight while the taps'
  // indices are worked out, then the block's taps, once, by 4-byte cp.async
  // (bf16: ordinary loads, widened): taps[i][M*gl + m] = w[i, m, g0 + gl].  Where i is w's unit stride (the
  // model's (G, M, k) weight seen as (k, M, G)) neighbouring threads take
  // neighbouring taps, a lane's k taps then the next lane's, each thread
  // stepping its (lane, tap) by nthreads with a carry, not a division by k;
  // else neighbouring lanes.
  if (n_items > 0) stage(0);
  auto tap_copy = [&](int i, int cl) {
    const int g = g0 + cl / M, m = cl % M;
    const bool ok = g < a.cout;
    const E* src = ok ? a.w + i * a.si + m * a.sm + g * a.sg : a.w;
    if constexpr (std::is_same_v<E, float>) {
      cp_async<1>(taps + i * kCT + cl, src, ok);
    } else {
      taps[i * kCT + cl] = ok ? widen(*src) : 0.f;
    }
  };
  if (a.si == 1) {
    const int dl = nthreads / a.k, di = nthreads % a.k;
    for (int cl = tid / a.k, i = tid % a.k; cl < kCT;) {
      tap_copy(i, cl);
      i += di;
      cl += dl;
      if (i >= a.k) {
        i -= a.k;
        ++cl;
      }
    }
  } else {
    for (int e = tid; e < a.k * kCT; e += nthreads) tap_copy(e / kCT, e % kCT);
  }
  cp_commit();
  for (int n = 1; n < a.depth - 1; ++n) {
    if (n < n_items) stage(n);
    cp_commit();
  }

  const int gl = lane * (VC / M);  // this thread's first output channel in the tile
  const bool g_ok = g0 + gl < a.cout;
  const E* rp = ring + lane * VC;
  const float* tp = taps + lane * VC;
  const int dil = a.dil, nb = a.nb;

  for (int n = 0; n < n_items; ++n) {
    __syncthreads();  // item n-1's rows are read: their slots may be refilled
    if (n + a.depth - 1 < n_items) stage(n + a.depth - 1);
    cp_commit();
    cp_wait(a.depth);  // item n's rows (and the taps) have landed
    __syncthreads();

    const Item it = item_of(a, grp, n);
    E* yb = a.y + (size_t)it.b * a.t_out * a.cout + g0 + gl;
    // outputs q + j*os of the item, j < R: at stride os = dil, or
    // consecutive (os = 1) where the dilation is too large for threads at
    // stride dil
    const int os = a.direct ? 1 : dil;
    const int q = a.direct ? tt * R : tt / dil * dil * R + tt % dil;
    if (it.t0 + q < a.t_out && a.direct) {
      // any dilation: output j reads row q + j + i*dil of tap i from the ring
      VO acc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) vzero(acc[j]);
      for (int i = 0; i < a.k; ++i) {
        const VI wv = vld<VI>(tp + i * kCT);
        int s = it.sb + q + i * dil;
        if (CARRY && s >= nb) s -= nb;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int sj = CARRY && s + j >= nb ? s + j - nb : s + j;
          tap_fma(acc[j], ldw<VI>(rp + sj * kCT), wv);
        }
      }
      if (g_ok) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int t = it.t0 + q + j;
          if (t < a.t_out) stw(yb + (size_t)t * a.cout, acc[j]);
        }
      }
    } else if (it.t0 + q < a.t_out) {
      // ring slot of the thread's next row; a whole-row item never wraps
      int s = it.sb + q;
      if (CARRY && s >= nb) s -= nb;
      VO acc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) vzero(acc[j]);
      auto row = [&]() {
        const VI x = ldw<VI>(rp + s * kCT);
        s += dil;
        if (CARRY && s >= nb) s -= nb;
        return x;
      };
      bool row_stationary = false;
      if constexpr (M == 1 && R == 8) row_stationary = a.k >= R;
      if (row_stationary) {
        if constexpr (M == 1 && R == 8) {
          // B4, R = 8, k >= R: row r (r = 0 .. R+k-2 of the thread's rows)
          // adds x_r * w[r - j] to output j for 0 <= r - j < k, so every
          // output still takes its taps in order.  A register window holds
          // the R taps w[r-R+1 .. r] (tap i in slot i mod R) and each row
          // loads one new tap: one row and one tap vector feed R FMA
          // vectors.  Rows 0 .. R-2 feed outputs 0 .. r; rows R-1 .. k-1 all
          // outputs, in branch-free groups of R; rows k .. k+R-2 outputs
          // r-k+1 .. R-1, their taps read from shared memory (whose window
          // slot would depend on k mod R).
          VI tw[R];
#pragma unroll
          for (int r = 0; r < R - 1; ++r) {
            tw[r] = vld<VI>(tp + r * kCT);
            const VI x = row();
#pragma unroll
            for (int j = 0; j <= r; ++j) tap_fma(acc[j], x, tw[r - j]);
          }
          auto steady = [&](int i, int mm) {  // row and tap i = R - 1 + m
            tw[(mm + R - 1) % R] = vld<VI>(tp + i * kCT);
            const VI x = row();
#pragma unroll
            for (int j = 0; j < R; ++j) tap_fma(acc[j], x, tw[(mm + R - 1 - j) % R]);
          };
          const int n_steady = a.k - R + 1;
          int m0 = 0;
          for (; m0 + R <= n_steady; m0 += R) {
#pragma unroll
            for (int mm = 0; mm < R; ++mm) steady(R - 1 + m0 + mm, mm);
          }
#pragma unroll
          for (int mm = 0; mm < R - 1; ++mm) {
            if (m0 + mm >= n_steady) break;
            steady(R - 1 + m0 + mm, mm);
          }
#pragma unroll
          for (int sp = 0; sp < R - 1; ++sp) {
            const VI x = row();
#pragma unroll
            for (int j = sp + 1; j < R; ++j)
              tap_fma(acc[j], x, vld<VI>(tp + (a.k + sp - j) * kCT));
          }
        }
      } else {
        // Tap i: row i + R - 1 into window slot (i + R - 1) mod R, then R
        // FMA vectors, output j reading slot (i + j) mod R.  Whole groups of
        // R taps run without a branch, so the compiler can issue a group's
        // shared loads ahead of its FMAs; the last, partial group stops at k.
        VI win[R];
#pragma unroll
        for (int r = 0; r < R - 1; ++r) win[r] = row();
        auto tap = [&](int i, int ii) {
          win[(ii + R - 1) % R] = row();
          const VI wv = vld<VI>(tp + i * kCT);
#pragma unroll
          for (int j = 0; j < R; ++j) tap_fma(acc[j], win[(ii + j) % R], wv);
        };
        int i0 = 0;
        for (; i0 + R <= a.k; i0 += R) {
#pragma unroll
          for (int ii = 0; ii < R; ++ii) tap(i0 + ii, ii);
        }
#pragma unroll
        for (int ii = 0; ii < R - 1; ++ii) {
          if (i0 + ii >= a.k) break;
          tap(i0 + ii, ii);
        }
      }
      if (g_ok) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int t = it.t0 + q + j * os;
          if (t < a.t_out) stw(yb + (size_t)t * a.cout, acc[j]);
        }
      }
    }
  }
}

// Two kernels by name, so that a trace tells B4's launches from B5's.
// Threads a block at most: 256 at R = 16, 512 at R = 8, so that ptxas keeps
// the registers of a thread within what a full block leaves it.
constexpr int max_threads(int R) { return R == 8 ? 512 : 256; }

template <class E, int GRAN, int VC, int R, bool CARRY>
__global__ void __launch_bounds__(max_threads(R)) dwconv_kernel(const Args<E> a) {
  dwconv_block<E, 1, GRAN, VC, R, CARRY>(a);
}

template <class E, int GRAN, int VC, int R, bool CARRY>
__global__ void __launch_bounds__(max_threads(R)) dwconv_grouped_kernel(const Args<E> a) {
  dwconv_block<E, 2, GRAN, VC, R, CARRY>(a);
}

constexpr int kSmemMax = 232448;  // dynamic shared memory a block can have on sm_90

// Only `if constexpr` keeps the other kernel from being instantiated (a B4
// kernel with two lanes a thread does not exist).
template <class E, int M, int GRAN, int VC, int R, bool CARRY>
constexpr auto kernel_of() {
  if constexpr (M == 1) {
    return dwconv_kernel<E, GRAN, VC, R, CARRY>;
  } else {
    return dwconv_grouped_kernel<E, GRAN, VC, R, CARRY>;
  }
}

// Shared-memory bytes of a plan: the ring of E, then the f32 taps.
template <class E>
long long smem_bytes(int nb, int k) {
  return (long long)nb * kCT * (long long)sizeof(E) + (long long)k * kCT * 4;
}

template <class E, int M, int GRAN, int VC, int R, bool CARRY>
int launch(const Args<E>& a, int grid_x, int grid_y, int smem, cudaStream_t stream) {
  auto kernel = kernel_of<E, M, GRAN, VC, R, CARRY>();
  constexpr int kThreadsRow = kCT / VC;  // threads across the channel tile
  if (a.ntt < 1 || kThreadsRow * a.ntt > max_threads(R) || (!a.direct && a.ntt % a.dil != 0) ||
      a.direct < 0 || a.direct > 1 || a.tile != a.ntt * R ||
      a.depth < 2 || a.depth > 3 || a.ipb < 1 || grid_y != (a.cin + kCT - 1) / kCT ||
      (long long)smem != smem_bytes<E>(a.nb, a.k) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int halo = a.dil * (a.k - 1);
  if (a.carry) {  // depth tiles and one halo in the ring; every tile owned by one block
    if (a.n_tiles != (a.t_out + a.tile - 1) / a.tile || a.chunks < 1 ||
        (long long)a.chunks * a.ipb < a.n_tiles || (a.chunks - 1) * a.ipb >= a.n_tiles ||
        a.nb < a.depth * a.tile + halo || (long long)grid_x != (long long)a.batch * a.chunks)
      return (int)cudaErrorInvalidValue;
  } else {  // depth whole rows with their halos, none wrapping around the ring
    if (a.tile < a.t_out || a.nb != a.depth * (a.tile + halo) ||
        grid_x != (a.batch + a.ipb - 1) / a.ipb)
      return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if ((long long)grid_x * grid_y > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args<E> b = a;
  b.n_ct = grid_y;
  kernel<<<grid_x * grid_y, kThreadsRow * a.ntt, smem, stream>>>(b);
  return (int)cudaGetLastError();
}

template <class E, int M, int GRAN, int VC>
int launch_r(const Args<E>& a, int r, int grid_x, int grid_y, int smem, cudaStream_t s) {
  if (r == 8 && a.carry) return launch<E, M, GRAN, VC, 8, true>(a, grid_x, grid_y, smem, s);
  if (r == 8) return launch<E, M, GRAN, VC, 8, false>(a, grid_x, grid_y, smem, s);
  if (r == 16 && a.carry) return launch<E, M, GRAN, VC, 16, true>(a, grid_x, grid_y, smem, s);
  if (r == 16) return launch<E, M, GRAN, VC, 16, false>(a, grid_x, grid_y, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The plan's (gran, vc, r) among the built ones: 16-byte copies (gran 4
// floats or 8 bf16, vc 4, or 1 for M = 1) need C % gran == 0 and x 16-byte
// aligned, and y aligned to the output vector of vc; single-element copies
// (gran 1, vc = M) take any C and any element alignment.
template <class E, int M>
int dwconv1d(Args<E> a, int hi, int gran, int vc, int r, int grid_x, int grid_y, int smem,
             void* stream) {
  const long long t_out = (long long)a.T + a.lo + hi - (long long)a.dil * (a.k - 1);
  if (a.batch <= 0 || a.T <= 0 || a.cout <= 0 || a.k <= 0 || a.lo < 0 || hi < 0 ||
      a.dil <= 0 || t_out <= 0 || t_out != a.t_out || a.cin != M * a.cout)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int kVec = 16 / (int)sizeof(E);  // elements a 16-byte copy
  if (gran == kVec) {
    if (a.cin % kVec != 0 || (uintptr_t)a.x % 16 != 0 ||
        (uintptr_t)a.y % (sizeof(E) * vc / M) != 0)
      return (int)cudaErrorInvalidValue;
    if (vc == 4) return launch_r<E, M, kVec, 4>(a, r, grid_x, grid_y, smem, s);
    if constexpr (M == 1) {
      if (vc == 1) return launch_r<E, M, kVec, 1>(a, r, grid_x, grid_y, smem, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (gran == 1 && vc == M) return launch_r<E, M, 1, M>(a, r, grid_x, grid_y, smem, s);
  return (int)cudaErrorInvalidValue;
}

template <class E>
Args<E> make_args(const void* x, const void* w, void* y, long long si, long long sm,
                  long long sg, int batch, int T, int cin, int cout, int k, int lo, int hi,
                  int dil, int ntt, int tile, int carry, int ipb, int depth, int direct,
                  int chunks, int n_tiles, int nb) {
  Args<E> a;
  a.x = static_cast<const E*>(x);
  a.w = static_cast<const E*>(w);
  a.y = static_cast<E*>(y);
  a.si = si;
  a.sm = sm;
  a.sg = sg;
  a.batch = batch;
  a.T = T;
  a.cin = cin;
  a.cout = cout;
  a.k = k;
  a.lo = lo;
  a.dil = dil;
  a.t_out = (int)((long long)T + lo + hi - (long long)dil * (k - 1));
  a.ntt = ntt;
  a.tile = tile;
  a.carry = carry;
  a.ipb = ipb;
  a.depth = depth;
  a.direct = direct;
  a.chunks = chunks;
  a.n_tiles = n_tiles;
  a.nb = nb;
  return a;
}

}  // namespace

extern "C" {

const char* ajt_dwconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#define AJT_DWCONV_PLAN                                                                    \
  int gran, int vc, int r, int ntt, int tile, int carry, int ipb, int depth, int direct,  \
      int chunks, int n_tiles, int nb, int grid_x, int grid_y, int smem, void *stream

// B4: x (batch, T, C), w (k, C) with strides (si, sc), y (batch, T + lo + hi -
// dil*(k-1), C); all float32 (_f32) or all bfloat16 (_bf16).  The rest is
// dwconv_launch's plan.
int ajt_dwconv1d_f32(const void* x, const void* w, void* y, int batch, int T, int C, int k,
                     int lo, int hi, int dil, long long si, long long sc, AJT_DWCONV_PLAN) {
  const auto a = make_args<float>(x, w, y, si, 0, sc, batch, T, C, C, k, lo, hi, dil, ntt,
                                  tile, carry, ipb, depth, direct, chunks, n_tiles, nb);
  return dwconv1d<float, 1>(a, hi, gran, vc, r, grid_x, grid_y, smem, stream);
}
int ajt_dwconv1d_bf16(const void* x, const void* w, void* y, int batch, int T, int C, int k,
                      int lo, int hi, int dil, long long si, long long sc, AJT_DWCONV_PLAN) {
  const auto a = make_args<bf16>(x, w, y, si, 0, sc, batch, T, C, C, k, lo, hi, dil, ntt,
                                 tile, carry, ipb, depth, direct, chunks, n_tiles, nb);
  return dwconv1d<bf16, 1>(a, hi, gran, vc, r, grid_x, grid_y, smem, stream);
}

// B5: x (batch, T, 2*G), w (k, 2, G) with strides (si, sm, sg), y (batch, T +
// lo + hi - dil*(k-1), G); all float32 (_f32) or all bfloat16 (_bf16).  The
// rest is dwconv_launch's plan.
int ajt_dwconv1d_grouped2_f32(const void* x, const void* w, void* y, int batch, int T, int G,
                              int k, int lo, int hi, int dil, long long si, long long sm,
                              long long sg, AJT_DWCONV_PLAN) {
  const auto a = make_args<float>(x, w, y, si, sm, sg, batch, T, 2 * G, G, k, lo, hi, dil,
                                  ntt, tile, carry, ipb, depth, direct, chunks, n_tiles, nb);
  return dwconv1d<float, 2>(a, hi, gran, vc, r, grid_x, grid_y, smem, stream);
}
int ajt_dwconv1d_grouped2_bf16(const void* x, const void* w, void* y, int batch, int T, int G,
                               int k, int lo, int hi, int dil, long long si, long long sm,
                               long long sg, AJT_DWCONV_PLAN) {
  const auto a = make_args<bf16>(x, w, y, si, sm, sg, batch, T, 2 * G, G, k, lo, hi, dil,
                                 ntt, tile, carry, ipb, depth, direct, chunks, n_tiles, nb);
  return dwconv1d<bf16, 2>(a, hi, gran, vc, r, grid_x, grid_y, smem, stream);
}

}  // extern "C"
