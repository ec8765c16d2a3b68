// The tensor-core mainloop of the port's searches: the class-blocked search
// (search_classed.cu, K1, over a range tile's whole class segment), its
// split form (search_classed2d.cu, K2, over one split of it) and the dense
// search (search_dense.cu, K3, over all columns, with an optional class
// mask).  Each row's first-occurrence argmax of search_common.cuh's keys,
// with or without its frontier, bit for bit the plain version's.  The
// pair-list step microbenchmark (micro_step.cu, K4 and K5) runs K1's step on
// it with parts of the argmax removed (Policy) and, for K5, its operands
// staged from the [K, M] layout.
//
// Every key is a function of one exact integer per (row, column) pair,
// dot = sum_k ai * (8 ch + cl).  An s8 x s8 -> s32 tensor-core product gives
// dh = ai . ch and dl = ai . cl exactly (mma.sync m16n8k32, m16n8k16 at
// K = 16), and dot = 8 dh + dl as in the plain version; the epilogue calls
// search_common.cuh's rank_key on it, so there is one definition of each key.
//
// A block takes 128 range rows: four warps of 32 rows (two m16 tiles) at
// K <= 64, eight warps of 16 rows at K = 256, each warp's A fragments loaded
// once and kept in registers.  The rows' sums come from one more product
// against a B of ones (row_sums), so the kernels hold no dp4a.  Columns
// stream through dynamic shared memory in chunks of kCols<K>, two buffers
// filled by cp.async while the previous chunk is searched; the B fragments
// come from ldmatrix, over rows padded to kStride<K> bytes so that its eight
// row addresses fall in distinct banks.  Every warp walks all of a chunk's
// columns in ascending n8 tiles.
//
// The argmax.  In an m16n8 accumulator, lane (g, t) holds rows g and g + 8
// and columns 2t and 2t + 1 of each n8 tile, so a row's columns lie within
// one quad (the four lanes of one g).  Each lane keeps a running best per row
// with the strict '>' over its own columns in ascending order; at the end the
// quad merges: the larger q, the lower idx on equal q (+0 and -0 compare
// equal, as in the scan).  Each lane holds the first occurrence of its own
// maximum, so the merge gives the sequential first-occurrence argmax of the
// whole row, its (-3e38, 0) start included.  A step's keys rarely improve a
// best, so a row's step maximum is compared first and the exact sequential
// update runs only where some row of the warp improves.  With K3's class
// mask a column of another class never competes, and under the frontier it
// takes the key -3e38 before the hit test, so it is never a hit either.
//
// The frontier (the `_thr` instances).  Sub-blocks and chunks hold whole
// groups of t_n columns (one domain's isometries, counted from the scan's
// start) and whole n8 tiles.  A row's sub-blocks up to its frontier split in
// two kinds.  Where it has no hit, every group ends without one, so all its
// columns compete: the sub-block continues the lane's best as above.  The
// sub-block where it first hits is scanned in column order, from shared
// memory where the warp staged the sub-block's keys, by one lane per row
// with search_common.cuh's group logic (the group-local best restarting at
// each hit, merged at the group's end; a trailing partial group closed at
// the scan's end, as the plain version closes it), and the row stops; its
// result is merged after the lanes' bests (later columns win only a larger
// key).  A warp whose rows are all done stops, and the block stops at a
// chunk's end once all its rows are (__syncthreads_or).

// Padded instances (search_common.cuh's Geom) run this loop at their K over
// operands zero past n.  The K-slab form (K = 256, n > 256) cannot keep a
// row's A fragments in registers (K / 8 words a lane and m16 tile: 128 at
// n = 1024) nor stage a chunk of whole rows (64 columns of 1040 bytes, two
// operands, two buffers: 266,240 B at n = 1024, past the 227 KB a block may
// hold).  So it walks each chunk slab by slab, 256 bytes of K at a time:
// it stages the chunk's slab of ch and cl with cp.async, loads the warp's
// rows' A fragments of that slab from device memory, and adds the products
// into dh and dl, kept per lane in shared memory (each lane reads back only
// what it wrote); then the chunk's keys and argmax run as above on those
// sums.  dh stays exact in int32 while n <= 132,104; the key's dot = 8 dh +
// dl is formed in int64.

// What bounds it on the card: the epilogue.  The products cost 2 K int8
// operations a pair on the tensor cores; the key and the argmax cost about
// eight to forty more instructions a pair on the FP32 and integer pipes.
#pragma once

#include <climits>

#include "search_common.cuh"

namespace fe {
namespace mma {

constexpr int kBlockRows = 128;  // range rows per block (K1/K2/K4: a tile slice)
// m16 tiles of rows per warp, warps and threads per block
template <int K>
constexpr int kTiles = K == 256 ? 1 : 2;
template <int K>
constexpr int kWarps = kBlockRows / (16 * kTiles<K>);
template <int K>
constexpr int kThreads = 32 * kWarps<K>;
// columns per chunk (the frontier's K = 16 chunk is a quarter, which leaves
// room for its staged keys and more blocks an SM, and lets a block stop
// sooner), and the bytes of one staged
// column of ch or cl: K padded by 16 above K = 16, so that ldmatrix's eight
// rows fall in distinct banks
template <int K, bool Frontier = false>
constexpr int kCols = K == 16 ? (Frontier ? 128 : 512) : (K == 64 ? 128 : 64);
template <int K>
constexpr int kStride = K == 16 ? 16 : K + 16;
// the frontier: columns whose keys a warp stages at a time, stored column by
// column with a stride of the warp's rows plus 4 floats, so that the
// fragments' stores (columns 2t + e, rows g and g + 8) and the scanning
// lanes' loads (one row each) fall in distinct banks
constexpr int kSub = 64;
template <int K>
constexpr int kKeyStride = 16 * kTiles<K> + 4;
// int8 words of A per lane and m16 tile
template <int K>
constexpr int kAWords = K / 8;

// The 'ls' and 'raw' keys at K <= 64 skip the integer dot and its I2F: the
// accumulators start at the bits of kMagic = 1.5 * 2^23, so that they read
// as the float kMagic + d, exact for |d| < 2^22 (|dh| <= 64 * 128 * 127,
// |dl| <= 64 * 128 * 7); at K = 16 the integer 8 dh + (dl + kMagic) reads
// as kMagic + dot (|dot| <= 16 * 128 * 1020 < 2^21).  Every step below is a
// fused multiply-add or add whose exact result is representable, or the
// single rounding that rank_key makes, so the keys are rank_key's bit for
// bit (fast_key).
template <int K, int M, int G = kFixed>
constexpr bool kFastKey = (M == kLs || M == kRaw) && K <= 64 && G == kFixed;
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.0f;

// What a lane keeps of a row's keys and how the quad merges it: the searches'
// own first-occurrence argmax, or the step microbenchmark's variants
// (micro_step.cu), each with a part of it removed.
//   Argmax     the strict '>' per lane behind the step-maximum check, then
//              merge_best (K1, K2, K3; K4 'full' and K5);
//   MaxOnly    the key's maximum by fmaxf, idx the first column `start`
//              (K4 'noargpass');
//   PackedMax  the int maximum of (bits(q) & ~4095) | (4095 - lane), lane
//              the column's offset from `start` (below 4096), in one pass;
//              the quad merges by the same maximum (K4 'packed');
//   DotMax     f32(dot) in place of the key, read off the accumulators at
//              K = 16, its maximum by fmaxf, idx `start`; no row sums and no
//              column values are staged (K4 'matmul').
enum class Policy : int { Argmax = 0, MaxOnly = 1, PackedMax = 2, DotMax = 3 };

// The per-column values of one chunk (stage_column).
template <int K, int M, int G, bool Masked, int N>
struct Cols {
  static constexpr bool kX = kExact<K, M>;
  double var_bd[kX && M == kGeneral ? N : 1];  // Exact 'general': var16 / 16
  int sb4[M == kRaw && !kX ? 1 : N];           // 4 SumB (exact)
  float aux[kX ? 1 : N];                       // ls: inv_var_b / 16; raw, general: SumB2
  float sb[M == kLs || kX ? 1 : N];            // SumB
  float var_b[M == kGeneral && !kX ? N : 1];   // n SumB2 - SumB SumB
  Wide<G> sb2_16[kX ? N : 1];                  // Exact: 16 SumB2
  int cls[Masked ? N : 1];                     // column class (K3's class mask)
  float fb[kFastKey<K, M, G> ? N : 1];         // fast_key: ls 4 SumB, raw 128 SumB - kMagic / 4
};

// rank_key's 'ls' and 'raw' keys at K <= 64 from the accumulators dh and dl
// (started at kMagicBits: dl always, dh above K = 16) of a row, whose
// 128 K - SumA is base_f, against staged column j.
//   ls   c = f32(K dot + base 4SumB): K dot exact as a float (at K = 64 the
//        sum of 512 dh and 64 dl, each exact, and 64 dot is exact as
//        |dot| < 2^23), then one fused multiply-add that rounds once, as
//        __int2float_rn does (exact at K = 16: |c| < 2^24);
//        q = (c c) (inv_var_b / 16).
//   raw  ab = f32(dot / 4 + 128 SumB) by one rounding (the plain version's
//        two inner products are exact), q = f32(2 ab - SumB2).
template <int K, int M, class S>
__device__ __forceinline__ float fast_key(int dh, int dl, int j, const S& s, float base_f) {
  if constexpr (M == kLs) {
    float kdot;
    if constexpr (K == 16) {
      kdot = __fmaf_rn(__int_as_float(8 * dh + dl), 16.0f, -16.0f * kMagic);
    } else {
      kdot = __fadd_rn(__fmaf_rn(__int_as_float(dh), 8.0f * K, -8.0f * K * kMagic),
                       __fmaf_rn(__int_as_float(dl), static_cast<float>(K), -K * kMagic));
    }
    const float c = __fmaf_rn(base_f, s.fb[j], kdot);
    return __fmul_rn(__fmul_rn(c, c), s.aux[j]);
  } else {
    float ab;
    if constexpr (K == 16) {
      ab = __fmaf_rn(__int_as_float(8 * dh + dl), 0.25f, s.fb[j]);
    } else {  // 2 dh + (dl / 4 + 128 SumB), both exact
      ab = __fadd_rn(__fmaf_rn(__int_as_float(dh), 2.0f, -2.0f * kMagic),
                     __fmaf_rn(__int_as_float(dl), 0.25f, s.fb[j]));
    }
    return __fmaf_rn(2.0f, ab, -s.aux[j]);  // 2 ab is exact
  }
}

// The K-slab form's sums of a chunk's products over the slabs, each lane's
// dh and dl: [warp][n8 tile][m16 tile][dh, dl][register][lane], flat.  An
// empty base elsewhere, so that the other instances' layout is unchanged.
template <bool On, int N>
struct SlabSums {
  alignas(16) int acc[N];
};
template <int N>
struct SlabSums<false, N> {};

// The block's dynamic shared memory.
template <int K, int M, bool Masked, bool Frontier, int G = kFixed>
struct Smem : SlabSums<G == kSlab, kWarps<K> * (kCols<K, Frontier> / 8) * kTiles<K> * 2 * 4 * 32> {
  static constexpr int kN = kCols<K, Frontier>;
  alignas(16) signed char ch[2][kN * kStride<K>];
  alignas(16) signed char cl[2][kN * kStride<K>];
  Cols<K, M, G, Masked, kN> cols[2];
  float keys[Frontier ? kWarps<K> : 1][Frontier ? kSub : 1][Frontier ? kKeyStride<K> : 1];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 matrices of 16-bit elements: lanes 8i..8i+7 give matrix i's row
// addresses, and lane (g, t) receives word t of row g of each.
__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a . b over 32 int8 (a: rows g, g + 8 at bytes 4t and 16 + 4t; b:
// column g at bytes 4t and 16 + 4t).
__device__ __forceinline__ void mma_k32(int (&d)[4], const int* a, int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b over 16 int8 (a: rows g, g + 8 at byte 4t; b: column g at 4t).
__device__ __forceinline__ void mma_k16(int (&d)[4], const int* a, int b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// d = A . B for one m16 tile's A fragments against one n8 tile whose B
// fragments are b (per k32 step: b0, b1; at K = 16 one word).
template <int K>
__device__ __forceinline__ void tile_dot(int (&d)[4], const int* a, const int* b, int init = 0) {
  d[0] = d[1] = d[2] = d[3] = init;
  if constexpr (K == 16) {
    mma_k16(d, a, b[0]);
  } else {
#pragma unroll
    for (int ks = 0; ks < K / 32; ++ks) mma_k32(d, a + 4 * ks, b[2 * ks], b[2 * ks + 1]);
  }
}

// Columns 4g..4g+3 of a [16, m] int8 operand from its 16 rows' words w[k]
// (bytes: columns 4g..4g+3 of row k): the four columns' 16-byte words, byte
// k of column j being w[k]'s byte j.
__device__ __forceinline__ void transpose_4cols(const int (&w)[16], int4 (&col)[4]) {
  int out[4][4];  // [column][group of 4 rows]
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int w0 = w[4 * g], w1 = w[4 * g + 1], w2 = w[4 * g + 2], w3 = w[4 * g + 3];
    const int lo01 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
    const int hi01 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
    const int lo23 = __byte_perm(w2, w3, 0x5140);
    const int hi23 = __byte_perm(w2, w3, 0x7362);
    out[0][g] = __byte_perm(lo01, lo23, 0x5410);  // w0.b0 w1.b0 w2.b0 w3.b0
    out[1][g] = __byte_perm(lo01, lo23, 0x7632);  // w0.b1 w1.b1 w2.b1 w3.b1
    out[2][g] = __byte_perm(hi01, hi23, 0x5410);
    out[3][g] = __byte_perm(hi01, hi23, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) col[j] = make_int4(out[j][0], out[j][1], out[j][2], out[j][3]);
}

// The larger q, the lower idx on equal q.
__device__ __forceinline__ void merge_best(float& q, int& idx, float oq, int oidx) {
  if (oq > q || (oq == q && oidx < idx)) {
    q = oq;
    idx = oidx;
  }
}

// Searches the block's range rows [row0, row0 + n_load) of `ai` (rows past
// n_load are not loaded) against the columns [start, end), the same for the
// whole block.  With the frontier only the rows below n_active search; the
// others count as stopped.  Calls write(local row, q, idx, hit) once for each
// loaded row, `hit` whether its scan met the frontier.  Masked: a column
// competes only where ccls[j] == rcls[row]; with the frontier, one of
// another class is never a hit either (its key is -3e38 before the test).  Pol: what each lane keeps and
// how the quad merges it (Policy).  Transposed: ch and cl are stored as
// [16, m_t] (K = 16), and each chunk is staged through registers by
// transpose_4cols into the layout that ldmatrix reads, in place of cp.async
// (which cannot transpose): its words are loaded before the previous chunk
// is searched and stored after it, as the column values are.
template <int K, int M, bool Masked, bool Frontier, Policy Pol = Policy::Argmax,
          bool Transposed = false, int G = kFixed, class Write>
__device__ __forceinline__ void search_rows(
    Smem<K, M, Masked, Frontier, G>& sm, const int* __restrict__ ai, long long row0, int n_load,
    int n_active, const int* __restrict__ rcls, const signed char* __restrict__ ch,
    const signed char* __restrict__ cl, const float* __restrict__ sb,
    const void* __restrict__ aux, const int* __restrict__ ccls, int start, int end,
    const KeyParams& p, Write write, long long m_t = 0) {
  static_assert(Pol == Policy::Argmax || !(Masked || Frontier),
                "the step's variants search unmasked columns without the frontier");
  static_assert(Pol != Policy::DotMax || (K == 16 && kFastKey<K, M>),
                "DotMax reads f32(dot) off accumulators started at kMagicBits");
  static_assert(!Transposed || (K == 16 && !Frontier), "the [16, m] layout is K5's");
  static_assert(G != kSlab || (K == 256 && Pol == Policy::Argmax && !Transposed),
                "the K-slab form walks slabs of 256 bytes");
  constexpr bool kSlabbed = G == kSlab;
  constexpr int kT = kTiles<K>;
  constexpr int kRW = 16 * kT;  // rows per warp
  constexpr int kN = kCols<K, Frontier>;
  constexpr int kS = kStride<K>;
  constexpr int kAW = kAWords<K>;
  // n8 tiles a step: one ldmatrix.x4 gives two at K = 16 (ch and cl), one
  // per k32 step above; two a step but for the frontier's single-tile steps
  // above K = 16 (its sub-blocks hold whole groups, multiples of 8 columns)
  constexpr int kNT = K == 16 || !Frontier ? 2 : 1;
  constexpr int kBW = K == 16 ? 1 : K / 16;  // B words per n8 tile and operand
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the operands' row width in bytes, and the slabs of K bytes in it
  const int kp = kSlabbed ? p.kp : K;
  const int n_slabs = kSlabbed ? p.kp / K : 1;

  // A fragments, straight from device memory: word w of a row (of slab
  // `slab`) is bytes 4w..
  int a[kT][kAW];
  int rows_local[kT][2];
#pragma unroll
  for (int mt = 0; mt < kT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows_local[mt][h] = warp * kRW + mt * 16 + g + 8 * h;
  auto load_a = [&](int slab) {
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = rows_local[mt][h];
        const bool in = local < n_load;
        const int* src = ai + (row0 + local) * (kSlabbed ? kp / 4 : K / 4) + slab * (K / 4);
#pragma unroll
        for (int ks = 0; ks < (K == 16 ? 1 : K / 32); ++ks) {
          a[mt][(K == 16 ? 0 : 4 * ks) + h] = in ? src[8 * ks + t] : 0;
          if constexpr (K != 16) a[mt][4 * ks + 2 + h] = in ? src[8 * ks + 4 + t] : 0;
        }
      }
    }
  };
  load_a(0);
  // the rows' byte sums: A against a B of ones (slab by slab in the K-slab
  // form)
  Row<K, G> rw[kT][2];
  float base_f[kT][2];
  int rc[kT][2];
  if constexpr (Pol != Policy::DotMax) {
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
      int ones[2 * (K == 16 ? 1 : K / 32)];
#pragma unroll
      for (int i = 0; i < 2 * (K == 16 ? 1 : K / 32); ++i) ones[i] = 0x01010101;
      int s[4];
      tile_dot<K>(s, a[mt], ones);
      if constexpr (kSlabbed) {
        for (int slab = 1; slab < n_slabs; ++slab) {
          load_a(slab);
          int d[4];
          tile_dot<K>(d, a[mt], ones);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i] += d[i];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = rows_local[mt][h];
        rw[mt][h] = row_sums<K, M, G, false>(s[2 * h], row0 + local, local < n_load, p);
        base_f[mt][h] = static_cast<float>(rw[mt][h].base);  // exact
        rc[mt][h] = Masked && local < n_load ? rcls[row0 + local] : 0;
      }
    }
  }

  // the frontier: lane l < kRW scans the warp's row l where it hits; the
  // fragments' lanes keep each of their rows' least hitting key and done flag
  const int scan_local = warp * kRW + lane;
  const bool scan_active = Frontier && lane < kRW && scan_local < n_active;
  float hit_q = 0.0f;
  if constexpr (Frontier) {
    if (scan_active) hit_q = row_sums<K, M, G, true>(0, row0 + scan_local, true, p).hit_q;
  }
  bool done = !scan_active;  // the scanning lane's row has met its frontier
  float cand_q = kInitQ;     // its best over the sub-block where it hit
  int cand_idx = 0;
  float hq[kT][2];
  bool dn[kT][2];
#pragma unroll
  for (int mt = 0; mt < kT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hq[mt][h] = Frontier ? __shfl_sync(0xffffffffu, hit_q, mt * 16 + g + 8 * h) : 0.0f;
      dn[mt][h] = !(rows_local[mt][h] < n_active);
    }
  // the frontier's sub-blocks and chunks hold whole groups and whole n8
  // tiles: multiples of lcm(8, t_n)
  int sub = kSub, chunk = kN;
  if constexpr (Frontier) {
    int lcm = p.t_n;
    while (lcm % 8) lcm += p.t_n;
    sub = kSub / lcm * lcm;
    chunk = kN / sub * sub;
  }

  // each lane's best per row over its columns in ascending order (with the
  // frontier: over the sub-blocks where the row had no hit)
  float bq[kT][2];
  int bi[kT][2];
#pragma unroll
  for (int mt = 0; mt < kT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bq[mt][h] = kInitQ;
      bi[mt][h] = Pol == Policy::PackedMax ? INT_MIN : 0;
    }

  // columns [c0, c0 + n_cols) -> buf (their slab `slab` in the K-slab form)
  auto stage = [&](int buf, int c0, int n_cols, int slab = 0) {
    if constexpr (!Transposed) {
      for (int i = threadIdx.x; i < n_cols * (K / 16); i += kThreads<K>) {
        const int j = i / (K / 16);
        const int w = i - j * (K / 16);
        const long long src = kSlabbed ? (static_cast<long long>(c0) + j) * kp + slab * K + 16 * w
                                       : (static_cast<long long>(c0) + j) * K + 16 * w;
        cp_async16(&sm.ch[buf][j * kS + 16 * w], ch + src);
        cp_async16(&sm.cl[buf][j * kS + 16 * w], cl + src);
      }
      cp_async_commit();
    }
  };
  // the column values a thread stages per chunk: loaded into registers
  // before the previous chunk is searched, staged after it
  constexpr int kPer = (kN + kThreads<K> - 1) / kThreads<K>;
  ColumnIn<G> col_in[kPer];
  // Transposed: the groups of 4 columns a thread stages per chunk, and their
  // 16 rows' words of ch and cl
  constexpr int kPerT = Transposed ? (kN / 4 + kThreads<K> - 1) / kThreads<K> : 1;
  int words[kPerT][2][16];
  auto load_cols = [&](int c0, int n_cols) {
    if constexpr (Pol != Policy::DotMax) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = threadIdx.x + i * kThreads<K>;
        if (j < n_cols) {
          col_in[i] = load_column<K, M, G, Masked>(static_cast<long long>(c0) + j, sb, aux, ccls);
        }
      }
    }
    if constexpr (Transposed) {  // a warp reads 128 adjacent bytes of a row at a time
      const int* __restrict__ wh = reinterpret_cast<const int*>(ch);
      const int* __restrict__ wl = reinterpret_cast<const int*>(cl);
#pragma unroll
      for (int i = 0; i < kPerT; ++i) {
        const int g = threadIdx.x + i * kThreads<K>;
        if (4 * g < n_cols) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const long long at = k * (m_t / 4) + c0 / 4 + g;  // c0, m_t: multiples of 4
            words[i][0][k] = wh[at];
            words[i][1][k] = wl[at];
          }
        }
      }
    }
  };
  auto stage_cols = [&](int buf, int n_cols) {
    if constexpr (Pol != Policy::DotMax) {
      auto& cs = sm.cols[buf];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = threadIdx.x + i * kThreads<K>;
        if (j < n_cols) {
          stage_column<K, M, G, Masked>(cs, j, col_in[i], p);
          if constexpr (kFastKey<K, M, G> && M == kLs) {
            cs.fb[j] = static_cast<float>(cs.sb4[j]);  // exact
          } else if constexpr (kFastKey<K, M, G>) {  // both steps exact
            cs.fb[j] = __fsub_rn(__fmul_rn(128.0f, cs.sb[j]), 0.25f * kMagic);
          }
        }
      }
    }
    if constexpr (Transposed) {
#pragma unroll
      for (int i = 0; i < kPerT; ++i) {
        const int g = threadIdx.x + i * kThreads<K>;
        if (4 * g < n_cols) {
#pragma unroll
          for (int op = 0; op < 2; ++op) {
            int4 col[4];
            transpose_4cols(words[i][op], col);
            signed char* dst = op ? sm.cl[buf] : sm.ch[buf];
#pragma unroll
            for (int j = 0; j < 4; ++j) *reinterpret_cast<int4*>(dst + (4 * g + j) * kS) = col[j];
          }
        }
      }
    }
  };

  // ldmatrix's row address of this lane for the n8 tile(s) at column n0:
  // at K = 16 matrices (ch, cl) of tile n0 then of tile n0 + 8; above, per
  // k32 step, ch bytes 0-15 and 16-31, then cl's
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const int lm_col = K == 16 ? lr + 8 * (lm >> 1) : lr;
  const int lm_off = K == 16 ? 0 : 16 * (lm & 1);
  const bool lm_cl = K == 16 ? (lm & 1) : (lm >> 1);

  // the products of n8 tiles [n0, n0 + 8 kNT) against the warp's rows
  auto mma_products = [&](int buf, int n0, int (&dh)[kNT][kT][4], int (&dl)[kNT][kT][4]) {
    const signed char* base = (lm_cl ? sm.cl[buf] : sm.ch[buf]) + (n0 + lm_col) * kS + lm_off;
    int b[kNT][2][kBW];  // [tile][ch, cl][words]
    if constexpr (K == 16) {
#pragma unroll
      for (int pair = 0; pair < kNT / 2; ++pair) {
        int r[4];
        ldmatrix_x4(r, base + 16 * pair * kS);
        b[2 * pair][0][0] = r[0];
        b[2 * pair][1][0] = r[1];
        b[2 * pair + 1][0][0] = r[2];
        b[2 * pair + 1][1][0] = r[3];
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int ks = 0; ks < K / 32; ++ks) {
          int r[4];
          ldmatrix_x4(r, base + 8 * nt * kS + 32 * ks);
          b[nt][0][2 * ks] = r[0];
          b[nt][0][2 * ks + 1] = r[1];
          b[nt][1][2 * ks] = r[2];
          b[nt][1][2 * ks + 1] = r[3];
        }
    }
    constexpr bool kFast = kFastKey<K, M, G>;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < kT; ++mt) {
        tile_dot<K>(dh[nt][mt], a[mt], b[nt][0], kFast && K != 16 ? kMagicBits : 0);
        tile_dot<K>(dl[nt][mt], a[mt], b[nt][1], kFast ? kMagicBits : 0);
      }
  };
  // the K-slab form's per-lane sum of n8 tile `tile`'s products (generic, so
  // that only the K-slab form instantiates it)
  auto acc_at = [&](auto& smem, int tile, int mt, int op, int i) -> int& {
    return smem.acc[((((warp * (kN / 8) + tile) * kT + mt) * 2 + op) * 4 + i) * 32 + lane];
  };
  // what a step reads: the products, or the K-slab form's sums over the slabs
  auto products = [&](int buf, int n0, int (&dh)[kNT][kT][4], int (&dl)[kNT][kT][4]) {
    if constexpr (kSlabbed) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dh[nt][mt][i] = acc_at(sm, n0 / 8 + nt, mt, 0, i);
            dl[nt][mt][i] = acc_at(sm, n0 / 8 + nt, mt, 1, i);
          }
    } else {
      mma_products(buf, n0, dh, dl);
    }
  };

  // One step: the keys of columns [n0, n0 + 8 kNT) of chunk buffer buf (the
  // tail step masks those at or past n1) into the running bests (q, idx)
  // with the strict '>', in each lane's column order.  Most steps improve
  // no row's best: a row's step maximum is checked first (fmaxf ignores
  // NaN, as '>' does), and only where some row of the warp improves do the
  // lanes run the exact sequential update.  With the frontier each key also
  // goes to the warp's staging at column j - s0, and `hits` collects, per
  // row, whether a key met its frontier.
  auto step = [&](bool tail, int buf, int c0, int n0, int n1, int s0,
                  float (&q_best)[kT][2], int (&i_best)[kT][2], bool (&hits)[kT][2]) {
    const auto& cs = sm.cols[buf];
    int dh[kNT][kT][4], dl[kNT][kT][4];
    products(buf, n0, dh, dl);
    float q[kT][2][kNT][2];  // [m16 tile][half][tile][parity]: the lane's column order
    float top[kT][2];
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        top[mt][h] = kInitQ;
        // the frontier: a row that is done needs no 'general' key (the
        // branch is uniform once the warp's eight rows of this slice are
        // done; for the cheaper keys it costs more than it saves)
        const bool skip = Frontier && M == kGeneral && dn[mt][h];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // column parity: 2t, then 2t + 1
            const int j = n0 + 8 * nt + 2 * t + e;
            float v = kInitQ;
            if (!skip) {
              if constexpr (Pol == Policy::DotMax) {  // kMagic + dot, exact: f32(dot)
                v = __fsub_rn(__int_as_float(8 * dh[nt][mt][2 * h + e] + dl[nt][mt][2 * h + e]),
                              kMagic);
              } else if constexpr (kFastKey<K, M, G>) {
                v = fast_key<K, M>(dh[nt][mt][2 * h + e], dl[nt][mt][2 * h + e], j, cs,
                                   base_f[mt][h]);
              } else {
                const Wide<G> dot =
                    8 * static_cast<Wide<G>>(dh[nt][mt][2 * h + e]) + dl[nt][mt][2 * h + e];
                v = rank_key<K, M, G, Masked>(dot, j, cs, rw[mt][h], p);
              }
              if constexpr (Frontier) {
                // (class mask) a column of another class takes -3e38 before
                // the hit test, as in the plain version: it is never a hit,
                // and the group logic's scan never takes it
                if constexpr (Masked) v = cs.cls[j] == rc[mt][h] ? v : kInitQ;
                // within the staging: a sub-block's steps cover at most kSub
                // columns (kSub is a multiple of 8 kNT)
                sm.keys[warp][j - s0][mt * 16 + g + 8 * h] = v;
                hits[mt][h] |= (!tail || j < n1) && v >= hq[mt][h];
              }
            }
            // a column past the end, or (class mask) of another class,
            // never competes: -3e38 never passes the strict '>'
            bool admit = !tail || j < n1;
            if constexpr (Masked) admit = admit && cs.cls[j] == rc[mt][h];
            q[mt][h][nt][e] = admit ? v : kInitQ;
            top[mt][h] = fmaxf(top[mt][h], q[mt][h][nt][e]);
            if constexpr (Pol == Policy::PackedMax) {  // lane: the offset from start
              const int key = (__float_as_int(v) & ~4095) | (4095 - (c0 + j - start));
              if (admit) i_best[mt][h] = max(i_best[mt][h], key);
            }
          }
      }
    if constexpr (Pol == Policy::Argmax) {
      bool up = false;
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) up |= top[mt][h] > q_best[mt][h];
      if (__any_sync(0xffffffffu, up)) {
#pragma unroll
        for (int mt = 0; mt < kT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (q[mt][h][nt][e] > q_best[mt][h]) {  // strict: the first occurrence wins
                  q_best[mt][h] = q[mt][h][nt][e];
                  i_best[mt][h] = c0 + n0 + 8 * nt + 2 * t + e;
                }
              }
      }
    } else if constexpr (Pol != Policy::PackedMax) {  // MaxOnly, DotMax
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) q_best[mt][h] = fmaxf(q_best[mt][h], top[mt][h]);
    }
  };
  // the columns [n0_begin, n1) of chunk buffer buf, in steps (the last one
  // masked where it passes n1)
  auto search_cols = [&](int buf, int c0, int n0_begin, int n1, int s0, float (&q_best)[kT][2],
                         int (&i_best)[kT][2], bool (&hits)[kT][2]) {
    int n0 = n0_begin;
#pragma unroll 2
    for (; n0 + 8 * kNT <= n1; n0 += 8 * kNT) {
      step(false, buf, c0, n0, n1, s0, q_best, i_best, hits);
    }
    if (n0 < n1) step(true, buf, c0, n0, n1, s0, q_best, i_best, hits);
  };

  // one chunk [c0, c0 + n_cols) in buffer buf
  auto search_chunk = [&](int buf, int c0, int n_cols) {
    bool no_hits[kT][2];
    if constexpr (!Frontier) {
      search_cols(buf, c0, 0, n_cols, 0, bq, bi, no_hits);
    } else {
      for (int s0 = 0; s0 < n_cols; s0 += sub) {
        if (__all_sync(0xffffffffu, done)) break;
        const int s1 = min(s0 + sub, n_cols);
        // the bests continued over the sub-block, and its hits: kept apart
        // until it is known which rows hit in it
        float tq[kT][2];
        int ti[kT][2];
        bool rh[kT][2];
#pragma unroll
        for (int mt = 0; mt < kT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rh[mt][h] = false;
            tq[mt][h] = bq[mt][h];
            ti[mt][h] = bi[mt][h];
          }
        search_cols(buf, c0, s0, s1, s0, tq, ti, rh);
        // a row without a hit here takes the sub-block into its bests (its
        // groups all end without a hit: their columns all compete); a row
        // with one has its frontier here
        bool any = false;
#pragma unroll
        for (int mt = 0; mt < kT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int r = rh[mt][h];
            r |= __shfl_xor_sync(0xffffffffu, r, 1);
            r |= __shfl_xor_sync(0xffffffffu, r, 2);
            rh[mt][h] = r && !dn[mt][h];
            if (!r && !dn[mt][h]) {
              bq[mt][h] = tq[mt][h];
              bi[mt][h] = ti[mt][h];
            }
            any |= rh[mt][h];
          }
        if (__any_sync(0xffffffffu, any)) {
          __syncwarp();  // the staged keys
          // whether the scanning lane's row (m16 tile l / 16, half l / 8 % 2,
          // quad l % 8) hit here
          bool mine = false;
#pragma unroll
          for (int mt = 0; mt < kT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool v = __shfl_sync(0xffffffffu, static_cast<int>(rh[mt][h]), 4 * (lane & 7));
              if ((lane >> 4) == mt && ((lane >> 3) & 1) == h) mine = v;
            }
          if (lane < kRW && mine) {
            // search_common.cuh's group logic over the row's keys, from the
            // sub-block's start (a group boundary): the columns before its
            // first group with a hit, and that group's from its last hit on
            float group_q = kInitQ;
            int group_idx = 0;
            bool group_hit = false;
            bool stop = false;
            int left = p.t_n;
            // predicated, with no exit from the unrolled loop, so that the
            // staged keys' loads run ahead of the group logic
#pragma unroll 4
            for (int j = s0; j < s1; ++j) {
              const float q = sm.keys[warp][j - s0][lane];
              const bool hit = q >= hit_q;
              if (!stop) {
                if (hit || q > group_q) {  // a hit restarts the group-local best
                  group_q = q;
                  group_idx = c0 + j;
                }
                group_hit |= hit;
                if (--left == 0) {  // the group ends here
                  if (group_q > cand_q) {
                    cand_q = group_q;
                    cand_idx = group_idx;
                  }
                  stop = group_hit;
                  group_q = kInitQ;
                  left = p.t_n;
                }
              }
            }
            if (!stop && left != p.t_n && group_q > cand_q) {  // a trailing partial
              cand_q = group_q;                                // group: the scan's
              cand_idx = group_idx;                            // end closes it
            }
            done = true;
          }
          __syncwarp();
#pragma unroll
          for (int mt = 0; mt < kT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              dn[mt][h] = __shfl_sync(0xffffffffu, static_cast<int>(done), mt * 16 + g + 8 * h);
            }
        }
      }
    }
  };

  if constexpr (kSlabbed) {
    // chunk by chunk, one buffer: the sums of the products over the slabs,
    // then the chunk's column values, then its keys
    for (int c0 = start; c0 < end; c0 += chunk) {
      const int n = min(chunk, end - c0);
      for (int slab = 0; slab < n_slabs; ++slab) {
        stage(0, c0, n, slab);
        load_a(slab);
        cp_async_wait_all();
        __syncthreads();
        // the n8 tiles that the chunk's steps read (step() rounds n up to 8 kNT)
        for (int n0 = 0; n0 < n; n0 += 8 * kNT) {
          int dh[kNT][kT][4], dl[kNT][kT][4];
          mma_products(0, n0, dh, dl);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int mt = 0; mt < kT; ++mt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                int& sh = acc_at(sm, n0 / 8 + nt, mt, 0, i);
                int& sl = acc_at(sm, n0 / 8 + nt, mt, 1, i);
                sh = (slab ? sh : 0) + dh[nt][mt][i];
                sl = (slab ? sl : 0) + dl[nt][mt][i];
              }
        }
        __syncthreads();  // the buffer is staged again
      }
      load_cols(c0, n);
      stage_cols(0, n);
      __syncthreads();
      search_chunk(0, c0, n);
      if constexpr (Frontier) {  // the block stops once all its rows are done
        if (!__syncthreads_or(!done)) break;
      }
      __syncthreads();
    }
  } else {
  if (start < end) {
    const int n = min(chunk, end - start);
    stage(0, start, n);
    load_cols(start, n);
    stage_cols(0, n);
    cp_async_wait_all();
    __syncthreads();
  }
  int buf = 0;
  for (int c0 = start; c0 < end; c0 += chunk, buf ^= 1) {
    const int next = c0 + chunk;
    const int n_next = min(chunk, end - next);
    // the next chunk is in flight while this one is searched; with the
    // frontier, after the first chunk only (most blocks stop within it)
    const bool ahead = next < end && (!Frontier || c0 != start);
    if (ahead) {
      stage(buf ^ 1, next, n_next);
      load_cols(next, n_next);
    }
    search_chunk(buf, c0, min(chunk, end - c0));
    if constexpr (Frontier) {  // the block stops once all its rows are done
      if (!__syncthreads_or(!done)) {
        cp_async_wait_all();
        break;
      }
      if (next < end && !ahead) {
        stage(buf ^ 1, next, n_next);
        load_cols(next, n_next);
      }
    }
    if (next < end) stage_cols(buf ^ 1, n_next);
    cp_async_wait_all();
    __syncthreads();
  }
  }

  // the quad's lanes
  if constexpr (Pol == Policy::Argmax) {
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          merge_best(bq[mt][h], bi[mt][h], __shfl_xor_sync(0xffffffffu, bq[mt][h], x),
                     __shfl_xor_sync(0xffffffffu, bi[mt][h], x));
        }
  } else {
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          if constexpr (Pol == Policy::PackedMax) {
            bi[mt][h] = max(bi[mt][h], __shfl_xor_sync(0xffffffffu, bi[mt][h], x));
          } else {
            bq[mt][h] = fmaxf(bq[mt][h], __shfl_xor_sync(0xffffffffu, bq[mt][h], x));
          }
        }
        if constexpr (Pol == Policy::PackedMax) {  // the key's q, and its column
          bq[mt][h] = __int_as_float(bi[mt][h] & ~4095);
          bi[mt][h] = 4095 - (bi[mt][h] & 4095) + start;
        } else {
          bi[mt][h] = start;
        }
      }
  }
  if constexpr (Frontier) {
    // the scanning lane's row: its bests from its quad, then the sub-block
    // where it hit (later columns: they win only a strictly larger key)
    float q = kInitQ;
    int idx = 0;
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float vq = __shfl_sync(0xffffffffu, bq[mt][h], 4 * (lane & 7));
        const int vi = __shfl_sync(0xffffffffu, bi[mt][h], 4 * (lane & 7));
        if ((lane >> 4) == mt && ((lane >> 3) & 1) == h) {
          q = vq;
          idx = vi;
        }
      }
    merge_best(q, idx, cand_q, cand_idx);
    if (lane < kRW && scan_local < n_load) write(scan_local, q, idx, scan_active && done);
  } else {
    // lane t of each quad writes its row t: (m16 tile, half) = (t / 2, t % 2)
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t == 2 * mt + h && rows_local[mt][h] < n_load) {
          write(rows_local[mt][h], bq[mt][h], bi[mt][h], false);
        }
      }
  }
}

// The most n the K-slab form takes: its dh sums, up to n * 128 * 127, stay
// below 2^31 (ops/matcher_kernels.py's MAX_SLAB_N).
constexpr int kMaxSlabN = 132104;

// Whether an instance takes p's n and row width kp: n = K (fixed); n <= K,
// kp = K (padded); 256 < n <= kMaxSlabN, kp = n rounded up to K = 256 (the
// K-slab form).  cudaErrorInvalidValue otherwise.
template <int K, int G>
__host__ int check_geometry(const KeyParams& p) {
  bool ok;
  if constexpr (G == kFixed) {
    ok = p.n == K && p.kp == K;
  } else if constexpr (G == kPadded) {
    ok = p.n >= 1 && p.n <= K && p.kp == K;
  } else {
    ok = p.n > 256 && p.n <= kMaxSlabN && p.kp % K == 0 && p.kp >= p.n && p.kp - p.n < K;
  }
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of an instance, set as the kernel's limit where
// it passes the default 48 KB; returns cudaGetLastError()-style codes.
template <class Kernel>
__host__ int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace mma
}  // namespace fe
