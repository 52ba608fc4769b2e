// Zipformer2 rel-pos attention scores for Hopper (sm_90a) on bfloat16
// tensors, on the tensor cores (B3's bf16 instance).
//
// Replaces relpos_scores_pallas (audiojax/ops/attention_pallas.py:195, its
// kernel _relpos_kernel :161) as the bf16 serving plan calls it, with its
// bf16 pe (:208) and bf16 probabilities (out_dtype q's dtype, :205):
//
//   out[n, h, i, j] = softmax_j( q[n, i, h, :] . k[n, j, h, :]
//                                + sum_p pp[n, i, h, p] * pe[h, p, i, j] )
//
// q and k (N, S, H*D) and pp (N, S, H*pstride) bfloat16, lane slices of one
// projection (their own row strides); pe (H, P, S, S) and out (N, H, S, S)
// bfloat16, contiguous.  The contract (relpos_scores_jnp, :142-158, on bf16
// inputs): the scores and the bias are f32 sums of exact bf16 products, the
// softmax subtracts its row maximum in f32, and each probability is rounded
// once to bf16, to nearest even.
//
// What bounds it: bytes, mostly the probabilities.  At ZipEnhancer's (964,
// 101) H4 D32 P4 they are 78.7 MB and q, k and pp's P used terms 53.0 MB
// (pp's padded slots are not read), 0.0394 ms at 3.35 TB/s; the products (2.5 G multiply-adds of q.k, 0.3 G of the bias) take
// 0.0057 ms at the bf16 rate.  The design it replaces (relpos_scores.cu's
// float32 kernel reading bf16) spent its time on the CUDA cores: the products
// as FFMAs of widened operands (a third of its time), the probabilities as
// 2-byte stores, one a lane (a sixth), and the bias from an f32 table.
//
// Design.  A block owns (h, a row tile of 16*WR query rows, a range of nb
// batch rows) and has WR*KW warps: warp w owns the 16 query rows of row group
// w % WR and the kw-th of KW equal ranges of their 8-key tiles, kw = w / WR,
// at most 8 tiles a warp (32 f32 scores a thread; the plan takes the fewest
// warps that hold them: 2 at S = 101, 4 at S = 241).
// The block stages its pe rows once, for all its batch rows:
// pe_s[row group][key][16 rows x P terms, padded to 4] (128 bytes a key; its
// eight 16-byte chunks XOR-swizzled by key & 7, so that ldmatrix meets no bank
// conflict), read as the aligned 16-byte chunks that cover each term's run of
// rows.  Then, for each batch row, double-buffered by 16-byte cp.async (the
// next row's copies in flight while this one computes; rows past S and
// features past D zero-filled by the copy): the keys (row stride D padded to
// 16, plus 8), the block's query rows and their positional terms (8 bytes a
// row).  A warp, two 8-key tiles at a time:
//  1. q.k^T: mma.sync.m16n8k16 (bf16 products, f32 sums), the q fragments
//     loaded once a batch row by ldmatrix, the keys' by ldmatrix, D/16 k16
//     steps chained in one accumulator from zero.
//  2. The bias, on the tensor cores too: a k16 step of 4 query rows x 4
//     terms, A[r][4 (r' - 4s) + p] = pp[r, p] where r' == r (block-diagonal:
//     a thread's nonzero A elements are its own rows' pp pairs) times B =
//     pe_s's 16 values of the key, four k16 steps for 16 rows into one zero
//     accumulator, added to the scores by an f32 add.  The two tiles' four
//     chains (q.k and bias of each) are issued step by step, interleaved.
//  3. The softmax in the fragment layout: a thread holds rows g and g + 8 and
//     keys 2tq, 2tq + 1 of each tile; keys past S are set to -inf; a row's
//     maximum and sum need two quad shuffles and, KW > 1, an exchange
//     through shared memory among the row group's warps alone (a named
//     barrier, 1 + row group); one reciprocal a row; each probability
//     rounded once to bf16.
//  4. The probabilities go to a shared stage laid out as the output lies:
//     the block's rows of one (n, h) are one contiguous run of rows*S
//     elements of out, staged at the run's own offset mod 16 bytes.  Each
//     row group's rows are one piece of that run, which its warps write
//     once they have staged it (the named barrier again): 16-byte
//     evict-first stores, but for the piece's unaligned head and tail
//     (2-byte stores).  One block barrier a batch row hands the staging
//     buffers over.
// What holds it (bf16_kernel_probe.py, H100): not the bytes but each batch
// row's chain of phases, the same in every warp: the copies' issue, the
// products (the bias's block-diagonal steps are 2/3 of the mma, at a
// sixteenth of their products' use), the exponentials, the 2-byte stores to
// the stage and the piece's write; at (964, 101) each switched off saves 5
// to 25 %.  Two batch rows a step (their chains interleaved, the pe
// fragments shared) spilled its registers and was slower; a second output
// stage (a row group writing batch row n - 1 while n computes), blocks of
// fewer row groups (more blocks an SM) and 16 tiles a warp (fewer warps, no
// exchange) gained nothing or lost (attention_geometry_sweep.py's tables).
// The launch plan (ops/attention_cuda.py:relpos_bf16_launch) picks WR, KW
// and nb (one wave at the blocks an SM that the shared memory allows); its
// shared memory is smem_bytes below.
//
// The launcher takes the geometry from the host, checks it, and returns
// cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kKT = 8;         // 8-key tiles a warp at most
constexpr int kMaxWarps = 16;
constexpr int kPE = 64;      // pe_s elements a key of a row group: 16 rows x 4 terms

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared-memory bytes, in this order: pe_s (WR row groups x S8 keys x 128
// bytes), two staging buffers (S8 keys and 16 WR query rows at row stride
// D16 + 8 elements, 16 WR rows of 4 terms), the output stage (the run of 16
// WR rows of S elements and 8 elements of slack for its offset), the row
// exchange (WR x KW x 2 x 16 floats).
__host__ __device__ constexpr long long buf_bytes(int wr, int s, int d) {
  return 2LL * ((long long)(round_up(s, 8) + 16 * wr) * (round_up(d, 16) + 8) + 16LL * wr * 4);
}
__host__ __device__ constexpr long long out_bytes(int wr, int s) {
  return round_up(2 * (16 * wr * s + 8), 16);
}
__host__ __device__ constexpr long long smem_bytes(int wr, int kw, int s, int d) {
  return 128LL * wr * round_up(s, 8) + 2 * buf_bytes(wr, s, d) + out_bytes(wr, s) +
         128LL * wr * kw;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* pp;
  const bf16* pe;
  bf16* out;
  long long ldq, ldk, ldpp;  // row strides, in elements
  int N, S, H, D, P, pstride;
  int wr;         // row groups of 16 query rows a block
  int kw;         // warps a row group, each tpw 8-key tiles of its keys
  int tpw;        // ceil(ceil(S / 8) / kw) <= kKT
  int row_tiles;  // ceil(S / (16 wr))
  int nb;         // batch rows a block
  int chunks;     // ceil(N / nb)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// B bytes (16 or 8) from global to shared memory, zeros where !valid.
template <int B>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, bool valid) {
  if constexpr (B == 16) {
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
__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d = a * b + 0 (m16n8k16, bf16 products, f32 sums).  Not volatile: the
// compiler may interleave the independent products of several tiles.
__device__ __forceinline__ void mma0(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                     unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
// d += a * b.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warps of one row group meet: named barrier 1 + rg (0 is __syncthreads).
__device__ __forceinline__ void bar_group(int rg, int kw) {
  if (kw > 1) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(32 * kw) : "memory");
  } else {
    __syncwarp();
  }
}

// Two f32 as a bf16 pair (the first in the low half), rounded to nearest even.
__device__ __forceinline__ unsigned cvt2(float lo_half, float hi_half) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi_half), "f"(lo_half));
  return r;
}

__device__ __forceinline__ void store_cs16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Rows [0, rows) x 16-byte chunks [0, cpr) of a row-major bf16 matrix (row r
// at src + r*ld) into shared rows of stride ss elements, zeros from row
// rows_ok and chunk valid on; the block's threads step (row, chunk) with a
// carry, not a division.
__device__ __forceinline__ void stage_rows(bf16* dst, int ss, const bf16* src, long long ld,
                                           int rows, int rows_ok, int cpr, int valid,
                                           const bf16* any) {
  const int step = blockDim.x, dr = step / cpr, dc = step % cpr;
  int r = threadIdx.x / cpr, c = threadIdx.x % cpr;
  while (r < rows) {
    const bool ok = r < rows_ok && c < valid;
    cp_async<16>(smem_addr(dst + r * ss + 8 * c), ok ? src + r * ld + 8 * c : any, ok);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// DS k16 steps of features.
template <int DS>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) relpos_mma_kernel_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, S8 = round_up(S, 8), wr = a.wr, R = 16 * wr;
  constexpr int KS = 16 * DS + 8;  // row stride of staged keys and query rows (elements)
  bf16* pes = reinterpret_cast<bf16*>(smem);                          // [wr][S8][64], swizzled
  unsigned char* bufs = smem + 128LL * wr * S8;                       // two staging buffers
  const long long bb = buf_bytes(wr, S, a.D);                         // bytes of one
  unsigned char* ost = bufs + 2 * bb;                                 // the output run
  float* red = reinterpret_cast<float*>(ost + out_bytes(wr, S));      // [wr][kw][2][16]

  int blk = blockIdx.x;
  const int chunk = blk % a.chunks;
  blk /= a.chunks;
  const int row0 = (blk % a.row_tiles) * R, h = blk / a.row_tiles;
  const int rows = min(R, S - row0);
  const int n_lo = chunk * a.nb, n_hi = min(a.N, n_lo + a.nb);
  if (n_lo >= n_hi) return;  // the whole block: no barrier is skipped by part of it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp % wr, kw = warp / wr;
  const bool active = 16 * rg < rows;  // warp-uniform
  const int j0 = a.tpw * kw, nt = min(a.tpw, S8 / 8 - j0);  // this warp's key tiles

  // zeros where nothing is staged: pe of rows past S and terms past P, the
  // bias's padding
  for (int e = tid; e < (int)(smem_bytes(wr, a.kw, S, a.D) / 16); e += blockDim.x)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // pe[h, p, row0 + i, j] into pe_s[i / 16][j][4 (i % 16) + p], chunk c of a
  // key's 128 bytes at c ^ (j & 7).  The block's rows of one term p are one
  // run of rows*S elements of pe, read as the aligned 16-byte chunks that
  // cover it (a chunk never crosses a page, so its bytes outside the run are
  // readable), four in flight a thread, one division a chunk
  unsigned short* pe16 = reinterpret_cast<unsigned short*>(pes);
  for (int p = 0; p < a.P; ++p) {
    const bf16* src = a.pe + (((size_t)h * a.P + p) * S + row0) * S;
    const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 1) & 7);
    const int len = rows * S, nch = (shift + len + 7) / 8;
    const uint4* s16 = reinterpret_cast<const uint4*>(src - shift);
    for (int c0 = tid; c0 < nch; c0 += 4 * blockDim.x) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * (int)blockDim.x < nch) v[u] = __ldg(s16 + c0 + u * blockDim.x);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * blockDim.x;
        if (c >= nch) break;
        const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        const int e = 8 * c - shift, t0 = e < 0 ? -e : 0;
        int i = (e + t0) / S, j = e + t0 - i * S;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (t < t0 || e + t >= len) continue;
          const int el = 4 * (i & 15) + p;
          pe16[((size_t)(i >> 4) * S8 + j) * kPE + (((el >> 3) ^ (j & 7)) << 3) + (el & 7)] =
              (unsigned short)(w[t >> 1] >> (16 * (t & 1)));
          if (++j == S) j = 0, ++i;
        }
      }
    }
  }

  // batch row n's keys, query rows and positional terms into buffer b
  const int dch = a.D / 8, cpr = DS * 2;  // 16-byte chunks of a row: data, staged
  auto stage = [&](int n, int b) {
    bf16* ks = reinterpret_cast<bf16*>(bufs + b * bb);
    bf16* qs = ks + S8 * KS;
    bf16* ps = qs + R * KS;
    const bf16* kn = a.k + (size_t)n * S * a.ldk + (size_t)h * a.D;
    const bf16* qn = a.q + ((size_t)n * S + row0) * a.ldq + (size_t)h * a.D;
    const bf16* pn = a.pp + ((size_t)n * S + row0) * a.ldpp + (size_t)h * a.pstride;
    stage_rows(ks, KS, kn, a.ldk, S8, S, cpr, dch, a.k);
    stage_rows(qs, KS, qn, a.ldq, R, rows, cpr, dch, a.q);
    for (int r = tid; r < R; r += blockDim.x)
      cp_async<8>(smem_addr(ps + 4 * r), r < rows ? pn + r * a.ldpp : a.pp, r < rows);
  };
  stage(n_lo, 0);
  cp_commit();

  // the lane's ldmatrix rows: q (A), keys (B, one 8-key tile x 32 features),
  // pe_s (B, one 8-key tile x two k16 steps of terms)
  const unsigned qa0 = smem_addr(bufs) + 2 * ((S8 + 16 * rg + (lane & 15)) * KS + 8 * (lane >> 4));
  const unsigned ka0 = smem_addr(bufs) + 2 * ((8 * j0 + (lane & 7)) * KS + 8 * (lane >> 3));
  const unsigned pa0 = smem_addr(pes) + 128 * (rg * S8 + 8 * j0 + (lane & 7));
  const int pchunk = lane >> 3, psw = lane & 7;
  // a thread's rows in the output run, and its terms' pair 2 (tq & 1), 2 (tq & 1) + 1
  const int r_lo = 16 * rg + g, r_hi = r_lo + 8;
  const int p0 = 2 * (tq & 1);
  const unsigned pmask = (p0 < a.P ? 0xffffu : 0u) | (p0 + 1 < a.P ? 0xffff0000u : 0u);

  for (int n = n_lo; n < n_hi; ++n) {
    const int cur = (n - n_lo) & 1;
    cp_wait_all();    // batch row n landed: this thread's copies
    __syncthreads();  // everyone's; the previous row's buffer and output run are free
    if (n + 1 < n_hi) stage(n + 1, cur ^ 1);
    cp_commit();

    float acc[kKT][4];  // tile j: rows g, g + 8 x keys 2tq, 2tq + 1
    float m_lo = -INFINITY, m_hi = -INFINITY;
    if (active) {
      const unsigned boff = cur * (unsigned)bb;
      unsigned qf[DS][4];
#pragma unroll
      for (int s = 0; s < DS; ++s) ldsm_x4(qa0 + boff + 32 * s, qf[s]);
      // the bias's A fragments: step s holds rows 4s .. 4s + 3; a thread's
      // row g (steps 0, 1) or g + 8 (steps 2, 3) at columns 2tq, 2tq + 1
      // (a0, a1) when its row is 4s + tq / 2, at 2tq + 8, 2tq + 9 (a2, a3)
      // when it is 4s + 2 + tq / 2
      const bf16* ps = reinterpret_cast<const bf16*>(bufs + cur * bb) + (S8 + R) * KS;
      const unsigned pl = *reinterpret_cast<const unsigned*>(ps + 4 * r_lo + p0) & pmask;
      const unsigned ph = *reinterpret_cast<const unsigned*>(ps + 4 * r_hi + p0) & pmask;
      unsigned af[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // steps 0, 1: rows 0-7; steps 2, 3: rows 8-15
        const int rl = 4 * (s & 1) + (tq >> 1), rh = rl + 2;
        af[s][0] = s < 2 && g == rl ? pl : 0u;
        af[s][1] = s >= 2 && g == rl ? ph : 0u;
        af[s][2] = s < 2 && g == rh ? pl : 0u;
        af[s][3] = s >= 2 && g == rh ? ph : 0u;
      }
      // two tiles at a time: their fragments loaded, then their products
      // step by step, four independent chains (two of q.k, two of the bias)
#pragma unroll
      for (int j2 = 0; j2 < kKT; j2 += 2) {
        if (j2 >= nt) break;
        const bool two = j2 + 1 < nt;  // warp-uniform
        unsigned kb[2][DS][2], pb[2][4][2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !two) break;
          const int j = j2 + t;
#pragma unroll
          for (int s = 0; s + 1 < DS; s += 2) {
            unsigned r[4];
            ldsm_x4(ka0 + boff + 2 * (8 * j * KS + 16 * s), r);
            kb[t][s][0] = r[0], kb[t][s][1] = r[1], kb[t][s + 1][0] = r[2], kb[t][s + 1][1] = r[3];
          }
          if constexpr (DS % 2)
            ldsm_x2(ka0 + boff + 2 * (8 * j * KS + 16 * (DS - 1)), kb[t][DS - 1]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            unsigned r[4];
            ldsm_x4(pa0 + 128 * 8 * j + ((((4 * hh + pchunk) ^ psw)) << 4), r);
            pb[t][2 * hh][0] = r[0], pb[t][2 * hh][1] = r[1], pb[t][2 * hh + 1][0] = r[2],
            pb[t][2 * hh + 1][1] = r[3];
          }
        }
        float bias[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !two) break;
          mma0(acc[j2 + t], qf[0], kb[t][0][0], kb[t][0][1]);
          mma0(bias[t], af[0], pb[t][0][0], pb[t][0][1]);
        }
#pragma unroll
        for (int s = 1; s < 4; ++s)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            if (t == 1 && !two) break;
            if (s < DS) mma(acc[j2 + t], qf[s], kb[t][s][0], kb[t][s][1]);
            mma(bias[t], af[s], pb[t][s][0], pb[t][s][1]);
          }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !two) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j2 + t][e] += bias[t][e];
        }
      }
      // keys past S to -inf (only in the tile that holds S), the rows' maxima
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        if (j >= nt) break;
        const int key = 8 * (j0 + j) + 2 * tq;
        if (key + 2 > S) {  // warp-uniform but for the lanes' own keys
          if (key >= S) acc[j][0] = acc[j][2] = -INFINITY;
          if (key + 1 >= S) acc[j][1] = acc[j][3] = -INFINITY;
        }
        m_lo = fmaxf(m_lo, fmaxf(acc[j][0], acc[j][1]));
        m_hi = fmaxf(m_hi, fmaxf(acc[j][2], acc[j][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
        m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
      }
    }
    // the row group's other warps' keys (kw > 1): the partial maxima and sums
    // of its warps exchanged through shared memory, red[rg][w][max, sum][row],
    // the row group's warps alone meeting (a named barrier)
    float* rg_red = red + rg * a.kw * 32;
    if (active && a.kw > 1) {  // warp-uniform, and the same in all of a row group's warps
      if (tq == 0) rg_red[kw * 32 + g] = m_lo, rg_red[kw * 32 + g + 8] = m_hi;
      bar_group(rg, a.kw);
      for (int w = 0; w < a.kw; ++w)
        m_lo = fmaxf(m_lo, rg_red[w * 32 + g]), m_hi = fmaxf(m_hi, rg_red[w * 32 + g + 8]);
    }
    float s_lo = 0.f, s_hi = 0.f;
    if (active) {
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        if (j >= nt) break;
        acc[j][0] = __expf(acc[j][0] - m_lo);  // 0 past S
        acc[j][1] = __expf(acc[j][1] - m_lo);
        acc[j][2] = __expf(acc[j][2] - m_hi);
        acc[j][3] = __expf(acc[j][3] - m_hi);
        s_lo += acc[j][0] + acc[j][1];
        s_hi += acc[j][2] + acc[j][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
      }
    }
    if (active && a.kw > 1) {
      if (tq == 0) rg_red[kw * 32 + 16 + g] = s_lo, rg_red[kw * 32 + 24 + g] = s_hi;
      bar_group(rg, a.kw);
      s_lo = s_hi = 0.f;  // in the warps' order, the same in every warp of the group
      for (int w = 0; w < a.kw; ++w) s_lo += rg_red[w * 32 + 16 + g], s_hi += rg_red[w * 32 + 24 + g];
    }
    // batch row n's run of out: its element e staged at ost[shift + e]
    if (active) {
      bf16* run = a.out + (((size_t)n * a.H + h) * S + row0) * S;
      const int shift = (int)((reinterpret_cast<uintptr_t>(run) >> 1) & 7);
      const float i_lo = 1.f / s_lo, i_hi = 1.f / s_hi;
      unsigned short* o_lo = reinterpret_cast<unsigned short*>(ost) + shift + r_lo * S;
      unsigned short* o_hi = o_lo + 8 * S;
      const bool w_lo = r_lo < rows, w_hi = r_hi < rows;
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        if (j >= nt) break;
        const int key = 8 * (j0 + j) + 2 * tq;
        const unsigned lo = cvt2(acc[j][0] * i_lo, acc[j][1] * i_lo);
        const unsigned hi = cvt2(acc[j][2] * i_hi, acc[j][3] * i_hi);
        if (key < S) {
          if (w_lo) o_lo[key] = (unsigned short)lo;
          if (w_hi) o_hi[key] = (unsigned short)hi;
        }
        if (key + 1 < S) {
          if (w_lo) o_lo[key + 1] = (unsigned short)(lo >> 16);
          if (w_hi) o_hi[key + 1] = (unsigned short)(hi >> 16);
        }
      }
      // the row group's rows are one piece of the run: once its warps have
      // staged them, they write it, 16-byte evict-first stores but for its
      // unaligned head and tail (2-byte stores); the next batch row's
      // barrier frees the stage
      bar_group(rg, a.kw);
      const int beg = shift + 16 * rg * S, end = shift + min(16 * rg + 16, rows) * S;
      unsigned char* base = reinterpret_cast<unsigned char*>(run) - 2 * shift;
      for (int c = beg / 8 + kw * 32 + lane; c < (end + 7) / 8; c += 32 * a.kw) {
        if (8 * c >= beg && 8 * c + 8 <= end) {
          store_cs16(base + 16 * c, reinterpret_cast<const uint4*>(ost)[c]);
        } else {
          for (int e = max(8 * c, beg); e < min(8 * c + 8, end); ++e)
            reinterpret_cast<unsigned short*>(base)[e] =
                reinterpret_cast<const unsigned short*>(ost)[e];
        }
      }
    }
  }
}

template <int DS>
cudaError_t launch(const Args& a, int threads, long long smem, cudaStream_t stream) {
  auto kernel = relpos_mma_kernel_bf16<DS>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)a.H * a.row_tiles * a.chunks;
  kernel<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ajt_relpos_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q, k (n, s, h*d) with row strides ldq, ldk; pp (n, s, h*pstride) with row
// stride ldpp, p <= 4 terms a head; pe (h, p, s, s) and out (n, h, s, s)
// contiguous; all bfloat16.  s <= 256, d a multiple of 8 up to 64, pstride a
// multiple of 4, ldq and ldk multiples of 8, ldpp of 4, q and k 16-byte and
// pp 8-byte aligned.  Geometry from the host (relpos_bf16_launch): wr row
// groups of 16 query rows a block, kw warps a row group (each at most 8
// tiles of 8 keys: kw >= ceil(s / 64)), at most 16 warps, row_tiles =
// ceil(s / (16 wr)), nb batch rows a block, chunks = ceil(n / nb), smem
// bytes (exactly smem_bytes).
int ajt_relpos_mma_bf16(const void* q, const void* k, const void* pp, const void* pe, void* out,
                        int n, int s, int h, int d, int p, int pstride, long long ldq,
                        long long ldk, long long ldpp, int wr, int kw, int row_tiles, int nb,
                        int chunks, long long smem, void* stream) {
  if (n <= 0 || s <= 0 || s > 256 || h <= 0 || d <= 0 || d % 8 || d > 64 || p <= 0 || p > 4 ||
      pstride < p || pstride % 4 || ldq < (long long)h * d || ldk < (long long)h * d ||
      ldpp < (long long)h * pstride || ldq % 8 || ldk % 8 || ldpp % 4 ||
      ((uintptr_t)q | (uintptr_t)k) % 16 || (uintptr_t)pp % 8)
    return (int)cudaErrorInvalidValue;
  const int tiles = (s + 7) / 8;
  const int tpw = (tiles + kw - 1) / kw;
  if (kw < 1 || wr < 1 || wr * kw > kMaxWarps || tpw > kKT ||
      row_tiles != (s + 16 * wr - 1) / (16 * wr) || nb < 1 || chunks != (n + nb - 1) / nb ||
      smem != smem_bytes(wr, kw, s, d) || smem > 232448 ||
      (long long)h * row_tiles * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.pp = static_cast<const bf16*>(pp);
  a.pe = static_cast<const bf16*>(pe);
  a.out = static_cast<bf16*>(out);
  a.ldq = ldq;
  a.ldk = ldk;
  a.ldpp = ldpp;
  a.N = n;
  a.S = s;
  a.H = h;
  a.D = d;
  a.P = p;
  a.pstride = pstride;
  a.wr = wr;
  a.kw = kw;
  a.tpw = tpw;
  a.row_tiles = row_tiles;
  a.nb = nb;
  a.chunks = chunks;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 32 * wr * kw;
  switch ((d + 15) / 16) {
    case 1: return (int)launch<1>(a, threads, smem, st);
    case 2: return (int)launch<2>(a, threads, smem, st);
    case 3: return (int)launch<3>(a, threads, smem, st);
    default: return (int)launch<4>(a, threads, smem, st);
  }
}

}  // extern "C"
