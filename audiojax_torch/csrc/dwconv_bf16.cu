// Depthwise 1-D convolution for Hopper (sm_90a) on bfloat16 tensors, on the
// tensor cores (B4's bf16 instance), and the grouped 2-in/1-out conv (B5's).
//
// Replaces dwconv1d_pallas (audiojax/ops/dwconv_pallas.py:52, its kernel
// _kernel) as the bf16 serving plan calls it, plus a dilation:
//
//   y[b, t, c] = sum_{i<k} xpad[b, t + i*dil, c] * w[i, c]
//
// and dwconv1d_pallas_tiled (dwconv_pallas.py:120, its kernel _kernel_tiled)
// on the one path that reaches it, MossFormer2-SS's dilated FSMN memory,
// which the TPU deinterleaves into two tiled depthwise calls
// (audiojax/nn/core.py:235-252); here M = 2 lanes a group, as they lie:
//
//   y[b, t, g] = sum_{i<k} sum_{r<2} xpad[b, t + i*dil, 2g + r] * w[i, r, g]
//
// with x (B, T, 2G), y (B, T_out, G) and w (k, 2, G) read through its
// strides (si, sr, sg), the model's (G, 2, k) weight as a view; the contract
// is dwconv1d_grouped_plain's (_grouped_single_out_conv1d, nn/core.py:171):
// bf16 products, f32 sums, one rounding.
//
// x (B, T, C) and y (B, T_out, C) bfloat16, channel-last and contiguous, C a
// multiple of 8 and x 16-byte aligned; w (k, C) bfloat16 read through its
// strides (si, sc), so the model's (C, 1, k) weight arrives as a view; xpad
// is x with lo zero rows before and hi after, T_out = T + lo + hi -
// dil*(k-1).  The contract (dwconv1d_jnp, dwconv_pallas.py:31-42): bf16
// products, exact in f32, summed in f32, each output rounded once to bf16.
//
// What bounds it: bytes.  At MossFormerGAN's (964, 98, 256) k31, x read once
// and y written once are 96.9 MB, 0.0289 ms at 3.35 TB/s, against 0.75 G
// multiply-adds (1.5 GFLOP, 0.0015 ms at the bf16 rate).  The float32 FMA
// design (dwconv.cu), whose bf16 instance this replaces on the served
// shapes, issues those multiply-adds on the CUDA cores at a reduced rate
// (register bank conflicts); here they go to the tensor cores.
//
// Design.  For one channel, 16 consecutive outputs are a Toeplitz matrix of
// its taps times a column of its input: D[r][n] = sum_s A[r][s] B[s][n] with
// A[r][s] = w[s - r] (0 where s - r is outside [0, k)), s < 16*KS (KS =
// ceil((15 + k)/16) k16 steps: k17 2, k31 3, k39 4), and B[s][n] the input
// window of output tile n, xdec[16n + s].  One mma.sync.m16n8k16 (bf16
// products, f32 sums) a k16 step: the 8 columns N are 8 output tiles of 16,
// one work item of 128 outputs of one channel.  A channel's A fragments are
// the same for every item, and of a lane's 4 KS registers only 2 KS + 1
// differ (a pair of taps each): a warp builds its channels' pairs once, from
// the block's taps staged in shared memory, and keeps them in registers.
// A work item is (batch row, residue rho mod dil, 128 outputs t = rho +
// dil*(u0 + r)): with dilation the outputs of one residue are a dense conv
// over the decimated rows rho + dil*v, so every dilation is a dense conv here
// (dense: dil = 1, one residue).  A block owns a channel tile of 16 channels
// (32-byte rows; 4 warps, 4 channels each; five blocks an SM) and ipb
// consecutive items; the channel tiles of one item group are neighbours in
// the launch order.  For each item:
//  1. Stage: its window of W = 112 + 16*KS decimated rows x 16 channels, as
//     they lie (channel-last), by 16-byte cp.async into a ring of depth item
//     slots (items n+1 .. n+depth-1 in flight while item n computes; item
//     n+depth-1's copies issued after item n's transposes), the zero padding
//     and the rows outside x from the copy's zero-fill.
//  2. Transpose: ldmatrix.trans reads 8 x 8 blocks (8 rows x 8 channels),
//     stmatrix writes them to xs, time-contiguous per channel.
//  3. Products: ldmatrix gives the B fragments (8 tile windows, each a
//     16-byte-aligned slice of xs) of a warp's 4 channels, then their KS
//     mma.sync each, interleaved; the f32 sums rounded once to bf16 and
//     stored to ys, channel-last, an output's 4 channels a store.
//  4. Write: 16 bytes (8 channels) a thread, a row's 32 bytes by two.
// Shared rows are padded by 16 bytes (ring and ys rows 48 bytes, xs rows W +
// 8 elements), so that the 8 rows of every ldmatrix and stmatrix fall on
// distinct bank groups (the tile windows of step 3: two-way; the 8-byte
// stores of step 3: four-way).
// B5 (M = 2, dwconv_grouped_kernel_bf16_mma) is the same body over the
// block's 16 input lanes, 8 groups:
// the window staged and transposed as for 16 channels, each lane's Toeplitz
// fragments from its own taps (w[:, r, g]), the products a group (two lanes)
// at a time, each lane's KS mma.sync into its own accumulator, the two added
// in f32 and rounded once, an output row's 8 groups written as two 8-byte
// stores (G is a multiple of 4).  128 registers a thread, four blocks an SM
// (at 96, five, the window's fragments spilled).  At MossFormer2-SS's (4,
// 3999, 512 -> 256) k39 d2 the bytes are 24.6 MB, 0.0073 ms; an item of 128
// outputs stages 176 decimated rows, so 1.375 times the input passes through
// the staging, the halo rows from L2 (the input, 16.4 MB, stays there); they
// are not carried from item to item, since the per-item chain below, not
// the bytes, holds B5 as it holds B4 (bf16_kernel_probe.py: B5 at 0.0275 ms,
// each of its parts switched off saves 10 to 15 %).
//
// What holds it: not the bytes but the chain of each item (three barriers,
// the copies' issue, the transposes, the products, the stores), of which
// the SM overlaps five blocks' worth; bf16_kernel_probe.py times each part
// and the cycles of each phase.  So the next item's copies are issued after
// this one's transposes (issued before them, they delayed them), the
// items are stepped without divisions, an output's 4 channels go to ys in
// one store, and the plan (ops/dwconv_cuda.py:dwconv_mma_launch) splits
// each channel tile's items over one wave of blocks so that a block's
// set-up (its taps) is paid once.  Tiles of 32 and 64 channels (more warps
// a block, fewer blocks an SM), tiles of 8, two items a round between
// barriers, and one pipeline a warp without barriers were slower in trial
// builds on the card.
// Products done at (964, 98, 256) k31: 8 tiles of 16 a row (98 outputs) x 48
// window positions, 2.5 G multiply-adds for 0.75 G of the function's.
//
// The launcher takes the plan from the host (ops/dwconv_cuda.py:
// dwconv_plan, the tensor-core route), checks it, and returns
// cudaErrorInvalidValue for a plan that does not fit, or the error of the
// shared-memory opt-in, or cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kCT = 16;            // channels a block: 32-byte rows, one sector
constexpr int kCW = 4;             // channels a warp, products interleaved 4 at a time
constexpr int kWarps = kCT / kCW;
constexpr int kRS = kCT + 8;     // ring and ys row stride (elements): 16 bytes of padding
constexpr int kTO = 128;         // outputs a work item: 8 tiles of 16
constexpr int kMinBlocks = 5;    // blocks an SM the registers are held to (M = 2: 4)

__host__ __device__ constexpr int window(int ks) { return 112 + 16 * ks; }

// Shared-memory bytes: the ring of depth windows (channel-last), the window
// time-contiguous (W + 8 a channel), the outputs channel-last.
__host__ __device__ constexpr long long smem_bytes(int ks, int depth) {
  return 2LL * ((long long)depth * window(ks) * kRS + kCT * (window(ks) + 8) + kTO * kRS);
}

struct Args {
  const bf16* x;
  const bf16* w;
  bf16* y;
  long long si, sr, sg;  // w's strides, in elements: tap, lane of a group (M = 2), group
  int batch, T, C, k, lo, dil, t_out;  // C: input lanes (M per output)
  int ipr;    // items a residue: ceil(ceil(t_out / dil) / 128)
  int items;  // batch * dil * ipr
  int ipb;    // items a block
  int depth;  // item slots in the ring
  int n_ct;   // channel tiles: block i is channel tile i % n_ct of item group i / n_ct
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(unsigned dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most depth - 2 groups of this thread's copies are in flight.
__device__ __forceinline__ void cp_wait(int depth) {
  if (depth == 2) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (depth == 3) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void stsm_x4(unsigned addr, const unsigned (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
// d += a * b (m16n8k16, bf16 products, f32 sums).
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A work item: its batch row, residue and first decimated output; next()
// steps to the following item without a division.
struct Item {
  int b, rho, u0;
  __device__ __forceinline__ void next(const Args& a) {
    u0 += kTO;
    if (u0 == a.ipr * kTO) {
      u0 = 0;
      if (++rho == a.dil) {
        rho = 0;
        ++b;
      }
    }
  }
};
__device__ __forceinline__ Item item_of(const Args& a, int idx) {
  const int per_row = a.dil * a.ipr, rem = idx % per_row;
  return {idx / per_row, rem / a.ipr, rem % a.ipr * kTO};
}

// M input lanes an output: 1 (B4, depthwise) or 2 (B5, the grouped 2-in/1-out
// conv, its lanes interleaved as they lie: lane 2g + r of x is lane r of
// group g, w[i, r, g] at i si + r sr + g sg).  The body of both kernels below.
template <int KS, int M>
__device__ __forceinline__ void conv_mma(const Args& a) {
  constexpr int W = window(KS), LX = W + 8, kOct = kCT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [depth][W][kRS], channel-last
  bf16* xs = ring + (size_t)a.depth * W * kRS;  // [kCT][LX], time-contiguous
  bf16* ys = xs + kCT * LX;                     // [kTO][kRS], channel-last

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = blockIdx.x / a.n_ct;
  const int c0 = blockIdx.x % a.n_ct * kCT;
  const int item0 = grp * a.ipb, n_items = min(a.ipb, a.items - item0);

  // Item n's window into ring slot n % depth: row v is input time rho +
  // dil*(u0 + v) - lo, zero outside [0, T) and past C (C % 8 == 0).  Items
  // are staged in order: `ahead` is the next one to stage.
  Item ahead = item_of(a, item0);
  auto stage = [&](int n) {
    const Item it = ahead;
    ahead.next(a);
    const bf16* xb = a.x + (size_t)it.b * a.T * a.C + c0;
    bf16* slot = ring + (size_t)(n % a.depth) * W * kRS;
    for (int e = tid; e < W * kOct; e += blockDim.x) {
      const int v = e / kOct, part = e % kOct;
      const int t = it.rho + a.dil * (it.u0 + v) - a.lo;
      const bool ok = t >= 0 && t < a.T && c0 + 8 * part < a.C;
      cp_async16(smem_addr(slot + v * kRS + 8 * part), ok ? xb + (size_t)t * a.C + 8 * part : a.x,
                 ok);
    }
  };
  for (int n = 0; n < a.depth - 1; ++n) {
    if (n < n_items) stage(n);
    cp_commit();
  }

  // The block's taps, zero-padded: tz[ch][16 + i] = the tap i of lane c0 +
  // ch for i in [0, k), 0 for i in [-16, 16 KS) outside it; in ys, which the
  // first item fills only after the loop's first barrier.
  constexpr int TZ = 16 * KS + 16;
  unsigned short* tz = reinterpret_cast<unsigned short*>(ys);
  for (int e = tid; e < kCT * TZ; e += blockDim.x) {
    const int ch = e / TZ, i = e % TZ - 16, l = c0 + ch;
    tz[e] = i >= 0 && i < a.k && l < a.C ? a.w[i * a.si + (l % M) * a.sr + (l / M) * a.sg].u : 0;
  }
  __syncthreads();
  // A[r][s] = w[16 ks + s - r] for the warp's 4 channels.  Register q of k16
  // step ks holds rows g + 8 (q & 1), window positions 2 tq + 8 (q >> 1) and
  // the next: taps 2 tq - g + 16 ks + 8 ((q >> 1) - (q & 1)) and the next,
  // the pair pr[2 ks + 1 + (q >> 1) - (q & 1)] below (two of the four
  // registers are the same pair, and a step's third is the next step's second).
  const int g = lane >> 2, tq = lane & 3;
  unsigned pr[kCW][2 * KS + 1];
#pragma unroll
  for (int j = 0; j < kCW; ++j) {
    const unsigned short* tc = tz + (kCW * warp + j) * TZ + 16 + 2 * tq - g - 8;
#pragma unroll
    for (int m = 0; m < 2 * KS + 1; ++m) pr[j][m] = tc[8 * m] | ((unsigned)tc[8 * m + 1] << 16);
  }

  Item it = item_of(a, item0);  // item n
  for (int n = 0; n < n_items; ++n, it.next(a)) {
    __syncthreads();  // item n-1 is written out: its ring slot, xs and ys are free
    cp_wait(a.depth);  // item n's rows have landed (this thread's copies)
    __syncthreads();
    // 2. the window, time-contiguous per channel: 8 x 8 blocks (8 rows, 8
    // channels) read by ldmatrix.trans and written by stmatrix, four a step
    const bf16* slot = ring + (size_t)(n % a.depth) * W * kRS;
    for (int i4 = 4 * warp; i4 < W / 8 * kOct; i4 += 4 * kWarps) {
      const int mi = i4 + (lane >> 3), v0 = 8 * (mi / kOct), ch = 8 * (mi % kOct);
      unsigned r[4];  // r[m]: block i4 + m's channel g, rows 2tq, 2tq + 1
      ldsm_x4_trans(smem_addr(slot + (v0 + (lane & 7)) * kRS + ch), r);
      stsm_x4(smem_addr(xs + (ch + (lane & 7)) * LX + v0), r);
    }
    // item n + depth - 1 into item n-1's slot, behind the transposes
    if (n + a.depth - 1 < n_items) stage(n + a.depth - 1);
    cp_commit();
    __syncthreads();
    // 3. the products of the warp's 4 channels, interleaved: the B
    // fragments of 8 tile windows (lane's ldmatrix row: tile lane & 7, half
    // (lane >> 3) & 1, k16 step + (lane >> 4)), KS mma.sync a channel
    const unsigned xa = smem_addr(xs + kCW * warp * LX + 16 * (lane & 7) +
                                  8 * ((lane >> 3) & 1) + 16 * (lane >> 4));
    unsigned short* yc = reinterpret_cast<unsigned short*>(ys) + kCW / M * warp;
    if constexpr (M == 1) {
#pragma unroll
      for (int j0 = 0; j0 < kCW; j0 += 4) {
        unsigned bfr[4][KS][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int ks = 0; ks + 1 < KS; ks += 2) {
            unsigned r[4];
            ldsm_x4(xa + 2 * ((j0 + j) * LX + 16 * ks), r);
            bfr[j][ks][0] = r[0], bfr[j][ks][1] = r[1], bfr[j][ks + 1][0] = r[2],
            bfr[j][ks + 1][1] = r[3];
          }
          if constexpr (KS % 2) ldsm_x2(xa + 2 * ((j0 + j) * LX + 16 * (KS - 1)), bfr[j][KS - 1]);
        }
        float d[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned* p = pr[j0 + j];
            const unsigned af[4] = {p[2 * ks + 1], p[2 * ks], p[2 * ks + 2], p[2 * ks + 1]};
            mma(d[j], af, bfr[j][ks][0], bfr[j][ks][1]);
          }
        // d[j][e]: output 32 tq + g + {0, 16, 8, 24}[e] of channel j0 + j,
        // rounded once; the 4 channels of an output into ys, 8 bytes a store
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 32 * tq + g + ((e & 1) << 4) + ((e >> 1) << 3);
          *reinterpret_cast<uint2*>(yc + o * kRS + j0) =
              make_uint2(pack_bf16(d[0][e], d[1][e]), pack_bf16(d[2][e], d[3][e]));
        }
      }
    } else {
      // M = 2: a group (two lanes) at a time, which holds half the B
      // fragments of four lanes in registers; each lane's KS products into
      // its own accumulator, the group's two added in f32 and rounded once;
      // an output's 2 groups into ys, 4 bytes a store
      float y[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        unsigned bfr[2][KS][2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
#pragma unroll
          for (int ks = 0; ks + 1 < KS; ks += 2) {
            unsigned r[4];
            ldsm_x4(xa + 2 * ((2 * q + r2) * LX + 16 * ks), r);
            bfr[r2][ks][0] = r[0], bfr[r2][ks][1] = r[1], bfr[r2][ks + 1][0] = r[2],
            bfr[r2][ks + 1][1] = r[3];
          }
          if constexpr (KS % 2)
            ldsm_x2(xa + 2 * ((2 * q + r2) * LX + 16 * (KS - 1)), bfr[r2][KS - 1]);
        }
        float d[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const unsigned* p = pr[2 * q + r2];
            const unsigned af[4] = {p[2 * ks + 1], p[2 * ks], p[2 * ks + 2], p[2 * ks + 1]};
            mma(d[r2], af, bfr[r2][ks][0], bfr[r2][ks][1]);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) y[q][e] = d[0][e] + d[1][e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 32 * tq + g + ((e & 1) << 4) + ((e >> 1) << 3);
        *reinterpret_cast<unsigned*>(yc + o * kRS) = pack_bf16(y[0][e], y[1][e]);
      }
    }
    __syncthreads();
    if constexpr (M == 1) {
      // 4. write: 16 bytes (8 channels) a thread, a row's kCT channels by kOct threads
      bf16* yb = a.y + (size_t)it.b * a.t_out * a.C + c0;
      for (int e = tid; e < kTO * kOct; e += blockDim.x) {
        const int r = e / kOct, part = e % kOct;
        const int t = it.rho + a.dil * (it.u0 + r);
        if (t < a.t_out && c0 + 8 * part < a.C)
          *reinterpret_cast<uint4*>(yb + (size_t)t * a.C + 8 * part) =
              *reinterpret_cast<const uint4*>(ys + r * kRS + 8 * part);
      }
    } else {
      // 4. write: 8 bytes (4 groups) a thread, a row's kCT / 2 groups by two
      // threads (the output's G = C / 2 is a multiple of 4, not always of 8)
      const int G = a.C / 2, q0 = c0 / 2;
      bf16* yb = a.y + (size_t)it.b * a.t_out * G + q0;
      for (int e = tid; e < kTO * 2; e += blockDim.x) {
        const int r = e >> 1, part = e & 1;
        const int t = it.rho + a.dil * (it.u0 + r);
        if (t < a.t_out && q0 + 4 * part < G)
          *reinterpret_cast<uint2*>(yb + (size_t)t * G + 4 * part) =
              *reinterpret_cast<const uint2*>(ys + r * kRS + 4 * part);
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) dwconv_kernel_bf16_mma(const Args a) {
  conv_mma<KS, 1>(a);
}
// B5's own kernel (its own name in a trace, 128 registers: four blocks an SM)
template <int KS>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks - 1)
    dwconv_grouped_kernel_bf16_mma(const Args a) {
  conv_mma<KS, 2>(a);
}

template <int KS, int M>
int launch(const Args& a, int grid, long long smem, cudaStream_t stream) {
  auto kernel = M == 1 ? dwconv_kernel_bf16_mma<KS> : dwconv_grouped_kernel_bf16_mma<KS>;
  if (smem != smem_bytes(KS, a.depth) || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, 32 * kWarps, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M>
int mma_conv(const void* x, const void* w, void* y, int batch, int T, int C, int k, int lo,
             int hi, int dil, long long si, long long sr, long long sg, int ks, int ipr, int ipb,
             int depth, int grid_x, int grid_y, long long smem, void* stream) {
  const long long t_out = (long long)T + lo + hi - (long long)dil * (k - 1);
  if (batch <= 0 || T <= 0 || C <= 0 || C % 8 || k <= 0 || lo < 0 || hi < 0 || dil <= 0 ||
      t_out <= 0 || t_out > 0x7fffffffLL || (uintptr_t)x % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  const long long u = (t_out + dil - 1) / dil;
  const long long items = (long long)batch * dil * ipr;
  if (ks < 1 || ks > 4 || 16 * ks < 15 + k || ipr != (u + kTO - 1) / kTO || ipb < 1 ||
      depth < 2 || depth > 4 || items > 0x7fffffffLL || grid_x != (items + ipb - 1) / ipb ||
      grid_y != (C + kCT - 1) / kCT || (long long)grid_x * grid_y > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.y = static_cast<bf16*>(y);
  a.si = si;
  a.sr = sr;
  a.sg = sg;
  a.batch = batch;
  a.T = T;
  a.C = C;
  a.k = k;
  a.lo = lo;
  a.dil = dil;
  a.t_out = (int)t_out;
  a.ipr = ipr;
  a.items = (int)items;
  a.ipb = ipb;
  a.depth = depth;
  a.n_ct = grid_y;
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_x * grid_y;
  switch (ks) {
    case 1: return launch<1, M>(a, grid, smem, s);
    case 2: return launch<2, M>(a, grid, smem, s);
    case 3: return launch<3, M>(a, grid, smem, s);
    default: return launch<4, M>(a, grid, smem, s);
  }
}

}  // namespace

extern "C" {

const char* ajt_dwconv_bf16_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// B4 bf16 on the tensor cores: x (batch, T, C), w (k, C) with strides (si,
// sc), y (batch, T + lo + hi - dil*(k-1), C), all bfloat16; C % 8 == 0, x
// and y 16-byte aligned.  The plan (dwconv_launch's "mma"
// route): ks k16 steps (16 ks >= 15 + k, at most 4), ipr items a residue,
// ipb items a block, depth ring slots (2 to 4), grid_x item groups x grid_y
// channel tiles, smem bytes (exactly smem_bytes).
int ajt_dwconv1d_mma_bf16(const void* x, const void* w, void* y, int batch, int T, int C, int k,
                          int lo, int hi, int dil, long long si, long long sc, int ks, int ipr,
                          int ipb, int depth, int grid_x, int grid_y, long long smem,
                          void* stream) {
  return mma_conv<1>(x, w, y, batch, T, C, k, lo, hi, dil, si, 0, sc, ks, ipr, ipb, depth,
                     grid_x, grid_y, smem, stream);
}

// B5 bf16 on the tensor cores, the grouped 2-in/1-out conv: x (batch, T, C =
// 2G), w (k, 2, G) with strides (si, sr, sg), y (batch, T + lo + hi -
// dil*(k-1), G), all bfloat16; the plan and its checks as B4's, C the input
// lanes (channel tiles of 16 lanes, 8 groups).
int ajt_dwconv1d_grouped2_mma_bf16(const void* x, const void* w, void* y, int batch, int T,
                                   int C, int k, int lo, int hi, int dil, long long si,
                                   long long sr, long long sg, int ks, int ipr, int ipb,
                                   int depth, int grid_x, int grid_y, long long smem,
                                   void* stream) {
  return mma_conv<2>(x, w, y, batch, T, C, k, lo, hi, dil, si, sr, sg, ks, ipr, ipb, depth,
                     grid_x, grid_y, smem, stream);
}

}  // extern "C"
