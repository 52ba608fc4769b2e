// Fused relu^2 quadratic attention for Hopper (sm_90a) on bfloat16 tensors,
// on the tensor cores (B6's bf16 instance).
//
// Replaces quad_attention_pallas (audiojax/ops/attention_pallas.py:61, its
// kernel _kernel :44) as the bf16 serving plan calls it:
//
//   out[n, i, :] = sum_j relu(scale * q[n, i, :] . k[n, j, :])^2 * v[n, j, :]
//
// with the (i == j) terms dropped when mask_diag; q, k (N, S, K) and v (N, S,
// V) bfloat16, contiguous, K and V multiples of 4; out (N, S, V) float32 (the
// served layers add the linear attention to the f32 sums and round once) or
// bfloat16 (the Pallas kernel's own output: the same sums rounded once).
// The contract (attention_pallas.py:44-58): the scores are f32 sums of exact
// bf16 products; scale, relu^2 and the mask are f32; the PV product takes the
// f32 score, never the score rounded to bf16.
//
// What bounds it: bytes, at the served shapes.  Every product of the function
// at the bf16 rate, N*S^2*(2K + 2V) operations at 989 TFLOP/s, is 0.0051 ms
// at MossFormerGAN's (964, 101, 128, 128) against 124.6 MB moved (q, k, v in
// bf16, out in f32), 0.0372 ms at 3.35 TB/s; at MossFormer2-SS's (64, 256,
// K 128, V 2048) 18.25 GFLOP, 0.0185 ms, against 210 MB, 0.0626 ms.  The
// design's own products are more (below); mma.sync has them to spare.
// What holds it: the latency of each warp's chains (ldmatrix, then mma, then
// the f32 adds) at two blocks an SM, whose 128 registers a thread (64 of
// them the output tile) leave no room for more warps or deeper overlap; a
// third piece in flight was slower (attention_geometry_sweep.py).
//
// Design (the flash-attention layout; relu^2 has no row normalisation, so
// key blocks only accumulate: no rescaling, no score tile in shared memory).
// A block owns (n, 16*W query rows, a range of value tiles of 128 columns)
// and has W warps, 16 rows each.  Its q rows are staged once; then, for each
// value tile, it walks the keys in blocks of KB (32 or 64), each block's
// keys and v rows (the tile's 128 columns) a piece copied by cp.async into
// one of two buffers while the other one computes.  A warp, for each piece:
//  1. Scores: its 16 rows x KB keys with mma.sync.m16n8k16 (bf16 products,
//     f32 sums), q by ldmatrix from the staged rows, k by ldmatrix from the
//     piece (a key row is the B operand's column as it lies).  Each k16 step
//     of features is its own product into a zero accumulator, added to the
//     running sum by an f32 add.  Then scale, relu^2, the mask and the keys
//     past S (only in the chunks of 32 keys that meet them), in f32, in the
//     accumulator registers.
//  2. PV: the C fragment of two n8 score tiles is the A fragment of one k16
//     step of keys.  The f32 score a is split into three bf16 terms, hi =
//     rn(a), mid = rn(a - hi), lo = rn(a - hi - mid): a = hi + mid + lo
//     exactly (each remainder is exact in f32 and has at most 16, then 8,
//     significant bits).  mma.sync against v's fragment (ldmatrix.trans from
//     the piece) takes every product exactly; two k16 steps of keys go into
//     one zero accumulator, their lo terms first, then mid, then hi (four
//     value tiles' chains interleaved), which an f32 add then adds to the
//     output tile: the f32 function up to the order of the sums.  The
//     output tile, 16 rows x 128 columns, stays in registers and is written
//     once a value tile.  A k16 step of keys that holds padding alone (past
//     S rounded up to 16) is skipped.
// With scores kept (keep), the first value tile stores each warp's three
// split fragments in shared memory, in its own lanes' order (16-byte stores,
// no conflict), and the block's other value tiles read them back instead of
// forming the scores again (their pieces then carry only v rows).
// S and K are padded with zeros in shared memory to multiples of 16 (cp.async
// zero-fill): a padded feature adds 0 to a score, a padded key's score is
// set to 0 and its v row is 0.  Shared rows are padded by 16 bytes, so that
// the 8 rows of an ldmatrix fall on distinct bank groups.
//
// Products done, at the GAN's shape (S padded to 112, one row tile of 7
// warps): 2*964*112^2*(128 + 3*128) = 12.4 GFLOP; at SS's, the scores kept:
// 2*64*256^2*(128 + 3*2048) = 52.6 GFLOP (68.7 with the scores formed again
// for each of the 16 value tiles).  The launch plan (ops/attention_cuda.py:
// quad_bf16_launch, from attention_geometry_sweep.py's tables) picks the
// warps, the value split, the key block and keep.  The float64 error of the
// sums' order (kQkChain, kPvChain below) is held there too: at the served
// shapes below the plain version's (cuBLAS SGEMM); longer chains in the mma
// raise it.
//
// The launcher takes the geometry from the host, checks it, and returns
// cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kVT = 128;         // value columns a tile
constexpr int kVS = kVT + 8;     // row stride of a staged v row (elements)
constexpr int kMaxWarps = 7;
// k16 steps summed in one mma accumulator, from zero, before an f32 add to
// the running sums: of features, in a score (kQkChain); of keys, in the PV
// product (kPvChain, 1 or 2; its lo products first).  The mma's own sum need
// not round to nearest: attention_geometry_sweep.py holds these choices and
// longer chains against float64.
constexpr int kQkChain = 1;
constexpr int kPvChain = 2;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared-memory bytes: the q rows, two pieces (kb keys of k, kb rows of v),
// and, with keep, each warp's split score fragments (3 x 512 bytes a k16
// step of the pieces' keys, S rounded up to kb).
__host__ __device__ constexpr long long smem_bytes(int warps, int s, int dk, int kb, int keep) {
  return 2LL * (16 * warps + 2 * kb) * (round_up(dk, 16) + 8) + 2LL * 2 * kb * kVS +
         (keep ? (long long)warps * (round_up(s, kb) / 16) * 3 * 512 : 0);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  void* out;
  int s, dk, dv;
  float scale;
  int mask_diag;
  int row_tiles, vsplit, kb, keep;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// G elements (16 or 8 bytes) from global to shared memory, zeros where !valid.
template <int G>
__device__ __forceinline__ void cp_async(unsigned dst, const bf16* src, bool valid) {
  if constexpr (G == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d = a * b + 0 (m16n8k16, bf16 products, f32 sums).
__device__ __forceinline__ void mma0(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                     unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
// d += a * b.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 scores as three pairs of bf16 terms (hi, mid, lo), each pair packed
// as an A-fragment register (the first score in the low half); cvt rounds to
// nearest even.
__device__ __forceinline__ unsigned cvt2(float lo_half, float hi_half) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi_half), "f"(lo_half));
  return r;
}
__device__ __forceinline__ void split3(float x0, float x1, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  hi = cvt2(x0, x1);
  const float r0 = x0 - lo_bf16(hi), r1 = x1 - hi_bf16(hi);
  mid = cvt2(r0, r1);
  lo = cvt2(r0 - lo_bf16(mid), r1 - hi_bf16(mid));
}

// Rows [0, rows) x columns [0, width) of a row-major matrix (row r at src +
// r*ld) into shared rows of stride ss, G elements a copy, by the block's
// threads; zeros from row rows_ok and column valid on.  A thread steps its
// (row, column) by blockDim with a carry, not a division.
template <int G>
__device__ __forceinline__ void stage_rows(bf16* dst, int ss, const bf16* src, size_t ld,
                                           int rows, int rows_ok, int width, int valid,
                                           const bf16* any) {
  const int cpr = width / G, step = blockDim.x;
  const int dr = step / cpr, dc = step % cpr * G;
  int r = threadIdx.x / cpr, c = threadIdx.x % cpr * G;
  for (int e = threadIdx.x; e < rows * cpr; e += step) {
    const bool ok = r < rows_ok && c < valid;
    cp_async<G>(smem_addr(dst + r * ss + c), ok ? src + r * ld + c : any, ok);
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

template <class O>
__device__ __forceinline__ void store2(O* p, float a, float b) {
  if constexpr (sizeof(O) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
  }
}

// O the output element, G elements a copy, KB keys a piece.  At most 7
// warps, two blocks an SM: at most 146 registers a thread.
template <class O, int G, int KB>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) quad_attention_kernel_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, bm = 16 * warps;
  const int kpad = round_up(a.dk, 16), qs = kpad + 8;  // row stride of q and k rows
  const int s16 = round_up(a.s, 16);
  bf16* qsm = reinterpret_cast<bf16*>(smem);        // [bm][qs]
  bf16* ring = qsm + (size_t)bm * qs;               // 2 x ([KB][qs] k, [KB][kVS] v)
  const int piece = KB * (qs + kVS);
  // [warps][k16 steps of the pieces' keys][3][32]
  uint4* kept = reinterpret_cast<uint4*>(ring + 2 * (size_t)piece);

  int blk = blockIdx.x;
  const int vs = blk % a.vsplit;
  blk /= a.vsplit;
  const int m0 = (blk % a.row_tiles) * bm;
  const size_t n = blk / a.row_tiles;
  const int tiles = (a.dv + kVT - 1) / kVT, per = (tiles + a.vsplit - 1) / a.vsplit;
  const int t_lo = vs * per, t_hi = min(tiles, t_lo + per);
  if (t_lo >= t_hi) return;  // the whole block: no barrier is skipped by part of it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* qn = a.q + n * a.s * a.dk;
  const bf16* kn = a.k + n * a.s * a.dk;
  const bf16* vn = a.v + n * a.s * a.dv;
  const int nkb = (s16 + KB - 1) / KB;
  const int steps = (t_hi - t_lo) * nkb;

  // q rows [m0, m0 + bm) x features [0, kpad), zero past S and K
  stage_rows<G>(qsm, qs, qn + (size_t)m0 * a.dk, a.dk, bm, a.s - m0, kpad, a.dk, a.q);
  // Piece st: keys [j0, j0 + KB) of value tile t: their k rows (not where the
  // scores are kept and t is past the first tile) and their v rows, zero
  // past S, K and V (so a piece past S computes zeros)
  auto stage = [&](int st) {
    const int t = t_lo + st / nkb, j0 = st % nkb * KB;
    bf16* kbuf = ring + (st & 1) * (size_t)piece;
    if (!a.keep || t == t_lo)
      stage_rows<G>(kbuf, qs, kn + (size_t)j0 * a.dk, a.dk, KB, a.s - j0, kpad, a.dk, a.k);
    stage_rows<G>(kbuf + KB * qs, kVS, vn + (size_t)j0 * a.dv + t * kVT, a.dv, KB, a.s - j0, kVT,
                  a.dv - t * kVT, a.v);
  };
  stage(0);  // with the q rows
  cp_commit();

  const int row0 = m0 + 16 * warp;  // the warp's first query row
  const bool live = row0 < a.s;     // a warp past the last row only stages
  float o[16][4];                   // output tile: n8 tile j, rows g, g + 8, columns 2tq, 2tq+1
  uint4* mine = kept + (size_t)warp * (nkb * KB / 16) * 3 * 32 + lane;
  // the lane's ldmatrix rows: q (A), k (B, two key tiles), v (B, trans, two column tiles)
  const unsigned qa = smem_addr(qsm + (16 * warp + (lane & 15)) * qs + (lane >> 4) * 8);
  const unsigned ka0 = smem_addr(ring + ((lane & 7) + ((lane >> 4) << 3)) * qs +
                                 ((lane >> 3) & 1) * 8);
  const unsigned va0 = smem_addr(ring + KB * qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kVS +
                                 (lane >> 4) * 8);

  for (int st = 0; st < steps; ++st) {
    const int t = t_lo + st / nkb, j0 = st % nkb * KB;
    cp_wait_all();    // piece st (and the q rows) landed: this thread's copies
    __syncthreads();  // everyone's; everyone is done with piece st - 1
    if (st + 1 < steps) {
      stage(st + 1);  // into piece st - 1's buffer
      cp_commit();
    }
    if (!live) continue;
    if (j0 == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    }
    const unsigned ka = ka0 + (st & 1) * 2 * piece, va = va0 + (st & 1) * 2 * piece;
    const bool form = !a.keep || t == t_lo;
#pragma unroll
    for (int c32 = 0; c32 < KB; c32 += 32) {  // 32 keys at a time: two k16 steps
      // the second k16 step of keys only where it holds a key below S
      const bool upper = j0 + c32 + 16 < s16;
      unsigned hi[2][4], mid[2][4], lo[2][4];
      if (form) {
        float sc[4][4] = {};  // scores: key tile j, rows g, g + 8, keys 2tq, 2tq + 1
#pragma unroll 2
        for (int d = 0; d < kpad; d += 16 * kQkChain) {
          float p[4][4];
#pragma unroll
          for (int h = 0; h < kQkChain; ++h) {
            const int dd = d + 16 * h;
            if (h > 0 && dd >= kpad) break;
            unsigned af[4], bfr[2][4];
            ldsm_x4(qa + 2 * dd, af);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp)
              if (jp == 0 || upper) ldsm_x4(ka + 2 * ((c32 + 16 * jp) * qs + dd), bfr[jp]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= 2 && !upper) continue;
              if (h == 0) {
                mma0(p[j], af, bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
              } else {
                mma(p[j], af, bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < (upper ? 4 : 2); ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += p[j][e];
        }
        // scale and relu^2; the keys past S and the diagonal only in the
        // chunks that meet them
        const int key0 = j0 + c32;
        const bool edge = key0 + 32 > a.s ||
                          (a.mask_diag && row0 < key0 + 32 && key0 < row0 + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fmaxf(sc[j][e] * a.scale, 0.f);
            p *= p;
            if (edge) {
              const int row = row0 + g + (e >> 1) * 8, key = key0 + 8 * j + 2 * tq + (e & 1);
              if (key >= a.s || (a.mask_diag && row == key)) p = 0.f;
            }
            sc[j][e] = p;
          }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)  // A register r: key tile 2kk + r/2, rows g + 8(r%2)
            split3(sc[2 * kk + (r >> 1)][2 * (r & 1)], sc[2 * kk + (r >> 1)][2 * (r & 1) + 1],
                   hi[kk][r], mid[kk][r], lo[kk][r]);
          if (a.keep) {
            uint4* slot = mine + (size_t)((j0 + c32) / 16 + kk) * 3 * 32;
            slot[0] = make_uint4(hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3]);
            slot[32] = make_uint4(mid[kk][0], mid[kk][1], mid[kk][2], mid[kk][3]);
            slot[64] = make_uint4(lo[kk][0], lo[kk][1], lo[kk][2], lo[kk][3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint4* slot = mine + (size_t)((j0 + c32) / 16 + kk) * 3 * 32;
          const uint4 h = slot[0], m = slot[32], l = slot[64];
          hi[kk][0] = h.x, hi[kk][1] = h.y, hi[kk][2] = h.z, hi[kk][3] = h.w;
          mid[kk][0] = m.x, mid[kk][1] = m.y, mid[kk][2] = m.z, mid[kk][3] = m.w;
          lo[kk][0] = l.x, lo[kk][1] = l.y, lo[kk][2] = l.z, lo[kk][3] = l.w;
        }
      }
      // PV: four value tiles of 8 columns at a time (four independent
      // chains), kPvChain k16 steps of keys into one accumulator, their lo
      // products first, then mid, then hi, then one f32 add to the output
#pragma unroll
      for (int k0 = 0; k0 < 2; k0 += kPvChain) {
        if (k0 == 1 && !upper) break;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          unsigned bfr[kPvChain][2][4];
#pragma unroll
          for (int kc = 0; kc < kPvChain; ++kc)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (k0 + kc == 0 || upper)
                ldsm_x4_trans(va + 2 * ((c32 + 16 * (k0 + kc)) * kVS + 32 * c4 + 16 * h),
                            bfr[kc][h]);
          float p[4][4];
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int kc = 0; kc < kPvChain; ++kc) {
              if (k0 + kc == 1 && !upper) continue;
              const unsigned(&af)[4] = term == 0 ? lo[k0 + kc] : term == 1 ? mid[k0 + kc]
                                                                            : hi[k0 + kc];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const unsigned b0 = bfr[kc][j >> 1][2 * (j & 1)];
                const unsigned b1 = bfr[kc][j >> 1][2 * (j & 1) + 1];
                if (term == 0 && kc == 0) {
                  mma0(p[j], af, b0, b1);
                } else {
                  mma(p[j], af, b0, b1);
                }
              }
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * c4 + j][e] += p[j][e];
        }
      }
    }
    if (j0 + KB >= s16) {  // the value tile's last piece: write it
      O* on = static_cast<O*>(a.out) + n * a.s * a.dv;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = t * kVT + 8 * j + 2 * tq;
        if (col >= a.dv) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + g + 8 * h;
          if (row < a.s) store2(on + (size_t)row * a.dv + col, o[j][2 * h], o[j][2 * h + 1]);
        }
      }
    }
  }
}

template <class O, int G, int KB>
cudaError_t launch(const Args& a, int n, int warps, long long smem, cudaStream_t stream) {
  auto kernel = quad_attention_kernel_bf16<O, G, KB>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)n * a.row_tiles * a.vsplit;
  kernel<<<(unsigned)blocks, 32 * warps, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

template <class O, int G>
cudaError_t launch_kb(const Args& a, int n, int warps, long long smem, cudaStream_t stream) {
  if (a.kb == 64) return launch<O, G, 64>(a, n, warps, smem, stream);
  return launch<O, G, 32>(a, n, warps, smem, stream);
}

template <class O>
int quad_bf16(const void* q, const void* k, const void* v, void* out, int n, int s, int dk,
              int dv, float scale, int mask_diag, int warps, int row_tiles, int vsplit, int kb,
              int keep, long long smem, void* stream) {
  if (n <= 0 || s <= 0 || dk <= 0 || dv <= 0 || dk % 4 || dv % 4) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int tiles = (dv + kVT - 1) / kVT;
  if (warps < 1 || warps > kMaxWarps || row_tiles != (s + 16 * warps - 1) / (16 * warps) ||
      vsplit < 1 || vsplit > tiles || (kb != 32 && kb != 64) || keep < 0 ||
      keep > 1 || smem != smem_bytes(warps, s, dk, kb, keep) || smem > 232448 ||
      (long long)n * row_tiles * vsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = out;
  a.s = s;
  a.dk = dk;
  a.dv = dv;
  a.scale = scale;
  a.mask_diag = mask_diag;
  a.row_tiles = row_tiles;
  a.vsplit = vsplit;
  a.kb = kb;
  a.keep = keep;
  const cudaStream_t st = (cudaStream_t)stream;
  // 16-byte copies where every row starts on 16 bytes, else 8-byte ones
  return (dk % 8 == 0 && dv % 8 == 0) ? (int)launch_kb<O, 8>(a, n, warps, smem, st)
                                      : (int)launch_kb<O, 4>(a, n, warps, smem, st);
}

}  // namespace

extern "C" {

const char* ajt_quad_bf16_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k (n, s, dk), v (n, s, dv) bfloat16, out (n, s, dv) float32 (_f32) or
// bfloat16 (_bf16); dk and dv multiples of 4, every pointer 16-byte aligned.
// Geometry from the host (quad_bf16_launch): warps of 16 query rows,
// row_tiles = ceil(s / (16 warps)), vsplit value-tile ranges a row tile, kb
// keys a piece (32 or 64), keep (1: the split scores kept in shared
// memory across value tiles), smem bytes (exactly smem_bytes).
#define AJT_QUAD_BF16_ENTRY(NAME, O)                                                           \
  int NAME(const void* q, const void* k, const void* v, void* out, int n, int s, int dk, int dv, \
           float scale, int mask_diag, int warps, int row_tiles, int vsplit, int kb, int keep,  \
           long long smem, void* stream) {                                                      \
    return quad_bf16<O>(q, k, v, out, n, s, dk, dv, scale, mask_diag, warps, row_tiles, vsplit, \
                        kb, keep, smem, stream);                                                \
  }
AJT_QUAD_BF16_ENTRY(ajt_quad_attention_bf16_f32, float)
AJT_QUAD_BF16_ENTRY(ajt_quad_attention_bf16_bf16, bf16)
#undef AJT_QUAD_BF16_ENTRY

}  // extern "C"
