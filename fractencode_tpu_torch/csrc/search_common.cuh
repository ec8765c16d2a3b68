// Device code shared by the port's two search kernels: search_classed.cu (K1,
// the class-blocked search) and search_dense.cu (K3, the dense search).
//
// Both give one thread one range row (its K int8 values in K/16 int4
// registers) and stream a column segment through shared memory in chunks.
// Each thread scans the columns in ascending order and keeps the best key with
// a strict '>', so the first occurrence of the max wins, exactly as in the TPU
// kernels' min-index-of-max, and no reduction across threads is needed.
//
// The rank keys are bit for bit those of the plain PyTorch version
// (ops/matcher_kernels.py, `_rank_ls_int8` and `_rank_tile`):
//   * every integer is exact: dot = sum_k ai * (8 ch + cl) by dp4a, and
//     cov4 = n * dot + (128 n - SumA) * sb4, in int32 for K <= 64 and int64 at
//     K = 256;
//   * every float operation is written as an explicitly rounded intrinsic
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts
//     into a fused multiply-add, in the evaluation order of the plain
//     version's Python expressions (torch eager rounds after every operation
//     and evaluates left to right: 2.0 * s * cov is (2 s) cov);
//   * host constants (1/n, inv_norm, s_max) arrive as the f32 values that
//     torch rounds the Python doubles to.
//
// Keys ('ls', 'raw', 'general'; matcher_pallas.rank_mode):
//   ls      q = f32(cov4)^2 * (aux / 16), aux = inv_var_b;
//   raw     ab = f32(dot) * 0.25 + 128 SumB (exact for K <= 64),
//           q = 2 ab - SumB2, aux = SumB2;
//   general q = -(max(e, 0) * inv_norm), e the residual under the mode's
//           (s, o) with the |s| clamp, aux = SumB2 (matcher_pallas._rank_tile).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fe {

constexpr int kRows = 128;  // threads per block, one range row each
constexpr float kInitQ = -3.0e38f;

enum Mode : int { kLs = 0, kRaw = 1, kGeneral = 2 };

// Columns staged in shared memory per pass: 2K bytes of operands plus up to
// 20 bytes of per-column sums, kept under the 48 KB of static shared memory.
template <int K>
constexpr int kChunkCols = K == 16 ? 512 : (K == 64 ? 256 : 64);

// Per-call inputs of the 'general' key (unused by the other keys).
struct KeyParams {
  const float* sa;   // [rows] SumA
  const float* sa2;  // [rows] SumA2
  float s_max;       // |s| clamp; <= 0 is off
  float inv_n;       // f32(1 / n)
  float inv_norm;    // f32(inv_norm)
  int so_reference;  // 1: so_mode 'reference' ((SumA - 1) SumA denominator)
};

// One shared-memory chunk of columns; arrays a key does not read shrink to 1.
template <int K, int M, bool Masked>
struct Chunk {
  static constexpr int kW = K / 16;  // int4 words per row
  static constexpr int kN = kChunkCols<K>;
  int4 ch[kN * kW];
  int4 cl[kN * kW];
  int sb4[M == kRaw ? 1 : kN];        // 4 SumB (exact)
  float aux[kN];                      // ls: inv_var_b / 16; raw, general: SumB2
  float sb[M == kLs ? 1 : kN];        // SumB
  float var_b[M == kGeneral ? kN : 1];  // n SumB2 - SumB SumB
  int cls[Masked ? kN : 1];           // column class (K3's class mask)
};

template <int K>
struct Row {
  int4 a[K / 16];
  int base;                   // 128 n - SumA ('ls', 'general')
  float sa, sa2, var_a, den;  // 'general' only
};

// Loads one range row.  SumA is the row's byte sum (dp4a against 0x01010101)
// plus 128 n for 'ls'; 'general' reads SumA and SumA2 from its inputs, as
// the plain version does (they differ on the layout's padding rows, whose
// ai is 0 but whose sums are 0).
template <int K, int M>
__device__ __forceinline__ Row<K> load_row(const int4* __restrict__ ai, long long row,
                                           bool active, const KeyParams& p) {
  constexpr int kW = K / 16;
  constexpr float n = static_cast<float>(K);
  Row<K> r;
  int rowsum = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    r.a[w] = active ? ai[row * kW + w] : make_int4(0, 0, 0, 0);
    rowsum = __dp4a(r.a[w].x, 0x01010101, rowsum);
    rowsum = __dp4a(r.a[w].y, 0x01010101, rowsum);
    rowsum = __dp4a(r.a[w].z, 0x01010101, rowsum);
    rowsum = __dp4a(r.a[w].w, 0x01010101, rowsum);
  }
  r.base = 128 * K - (rowsum + 128 * K);
  r.sa = r.sa2 = r.var_a = r.den = 0.0f;
  if constexpr (M == kGeneral) {
    r.sa = active ? p.sa[row] : 0.0f;
    r.sa2 = active ? p.sa2[row] : 0.0f;
    r.base = 128 * K - static_cast<int>(r.sa);
    // var_a = n*sa2 - sa*sa;  den = n*sa2 - (sa - 1.0)*sa
    r.var_a = __fsub_rn(__fmul_rn(n, r.sa2), __fmul_rn(r.sa, r.sa));
    r.den = __fsub_rn(__fmul_rn(n, r.sa2), __fmul_rn(__fsub_rn(r.sa, 1.0f), r.sa));
  }
  return r;
}

// s = 0 where |den| < 1e-5, else cov / den; then the |s| clamp.
__device__ __forceinline__ float solve_s(float cov, float den, const KeyParams& p) {
  float s = fabsf(den) < 1e-5f ? 0.0f : __fdiv_rn(cov, den == 0.0f ? 1.0f : den);
  if (p.s_max > 0.0f) s = fminf(fmaxf(s, -p.s_max), p.s_max);
  return s;
}

// The rank key of row `r` against staged column j, from the exact dot.
template <int K, int M, bool Masked>
__device__ __forceinline__ float rank_key(int dot, int j, const Chunk<K, M, Masked>& s,
                                          const Row<K>& r, const KeyParams& p) {
  constexpr float n = static_cast<float>(K);
  if constexpr (M == kLs) {
    float c;
    if constexpr (K <= 64) {
      c = __int2float_rn(K * dot + r.base * s.sb4[j]);
    } else {  // cov4 reaches ~9e9 at K = 256: int64, then one rounding
      c = __ll2float_rn(static_cast<long long>(K) * dot +
                        static_cast<long long>(r.base) * s.sb4[j]);
    }
    return __fmul_rn(__fmul_rn(c, c), s.aux[j]);
  } else {
    static_assert(K <= 64, "the raw and general keys need exact f32 SumAB (K <= 64)");
    const float sb = s.sb[j];
    const float sb2 = s.aux[j];
    // ab = dot*0.25 + 128.0*sb
    const float ab = __fadd_rn(__fmul_rn(__int2float_rn(dot), 0.25f), __fmul_rn(128.0f, sb));
    if constexpr (M == kRaw) {
      return __fsub_rn(__fmul_rn(2.0f, ab), sb2);  // 2.0*ab - sb2
    } else {
      const float cov = __fmul_rn(__int2float_rn(K * dot + r.base * s.sb4[j]), 0.25f);
      float e;
      if (!p.so_reference) {
        const float var_b = s.var_b[j];
        const float sv = solve_s(cov, var_b, p);
        // e = (var_a - 2.0*s*cov + (s*s)*var_b) * (1.0/n)
        e = __fmul_rn(__fadd_rn(__fsub_rn(r.var_a, __fmul_rn(__fmul_rn(2.0f, sv), cov)),
                                __fmul_rn(__fmul_rn(sv, sv), var_b)),
                      p.inv_n);
      } else {
        const float sv = solve_s(cov, r.den, p);
        // o = (sb - s*sa) * (1.0/n)
        const float o = __fmul_rn(__fsub_rn(sb, __fmul_rn(sv, r.sa)), p.inv_n);
        // e = sa2 + (s*s)*sb2 + n*o*o + 2.0*s*o*sb - 2.0*s*ab - 2.0*o*sa
        const float two_s = __fmul_rn(2.0f, sv);
        e = __fadd_rn(r.sa2, __fmul_rn(__fmul_rn(sv, sv), sb2));
        e = __fadd_rn(e, __fmul_rn(__fmul_rn(n, o), o));
        e = __fadd_rn(e, __fmul_rn(__fmul_rn(two_s, o), sb));
        e = __fsub_rn(e, __fmul_rn(two_s, ab));
        e = __fsub_rn(e, __fmul_rn(__fmul_rn(2.0f, o), r.sa));
      }
      return -__fmul_rn(fmaxf(e, 0.0f), p.inv_norm);  // -(max(e, 0)*inv_norm)
    }
  }
}

// Scans columns [start, end) (the same for every thread of the block) for
// row `r`, updating (best_q, best_idx) with a strict '>'.  With Masked, only
// columns whose class equals `row_cls` compete: the TPU kernel gives the
// others q = -3e38, which can never pass the strict '>' against a best that
// starts there, so skipping them is the same.
template <int K, int M, bool Masked>
__device__ __forceinline__ void scan_columns(
    Chunk<K, M, Masked>& s, const Row<K>& r, bool active, int row_cls,
    const int4* __restrict__ ch, const int4* __restrict__ cl,
    const float* __restrict__ sb, const float* __restrict__ aux,
    const int* __restrict__ ccls, int start, int end, const KeyParams& p,
    float& best_q, int& best_idx) {
  constexpr int kW = K / 16;
  constexpr int kN = kChunkCols<K>;
  constexpr float n = static_cast<float>(K);
  for (int c0 = start; c0 < end; c0 += kN) {
    const int n_cols = min(kN, end - c0);
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = threadIdx.x; j < n_cols * kW; j += kRows) {
      s.ch[j] = ch[(long long)c0 * kW + j];
      s.cl[j] = cl[(long long)c0 * kW + j];
    }
    for (int j = threadIdx.x; j < n_cols; j += kRows) {
      const float b = sb[c0 + j];
      if constexpr (M != kRaw) s.sb4[j] = static_cast<int>(4.0f * b);  // exact
      if constexpr (M == kLs) {
        s.aux[j] = aux[c0 + j] * 0.0625f;  // exact: power-of-two scale
      } else {
        s.aux[j] = aux[c0 + j];
        s.sb[j] = b;
      }
      if constexpr (M == kGeneral) {  // var_b = n*sb2 - sb*sb
        s.var_b[j] = __fsub_rn(__fmul_rn(n, aux[c0 + j]), __fmul_rn(b, b));
      }
      if constexpr (Masked) s.cls[j] = ccls[c0 + j];
    }
    __syncthreads();
    if (!active) continue;
    // Four columns in flight per thread: the scan is one thread's serial
    // chain, so where few warps share an SM (the quadtree's levels) it is
    // latency-bound.  On an H100 80GB HBM3 (700 W) this took K1 at K = 256 on the 2048^2 16 px
    // level from 2.94 to 1.91 ms, at K = 64 from 3.17 to 2.78 ms, and left
    // K = 16 within 1%.
#pragma unroll 4
    for (int j = 0; j < n_cols; ++j) {
      if constexpr (Masked) {
        if (s.cls[j] != row_cls) continue;
      }
      // two accumulators per operand so consecutive dp4a do not wait
      int dh[2] = {0, 0};
      int dl[2] = {0, 0};
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const int4 h = s.ch[j * kW + w];
        const int4 l = s.cl[j * kW + w];
        int& eh = dh[w & 1];
        int& el = dl[w & 1];
        eh = __dp4a(r.a[w].x, h.x, eh);
        eh = __dp4a(r.a[w].y, h.y, eh);
        eh = __dp4a(r.a[w].z, h.z, eh);
        eh = __dp4a(r.a[w].w, h.w, eh);
        el = __dp4a(r.a[w].x, l.x, el);
        el = __dp4a(r.a[w].y, l.y, el);
        el = __dp4a(r.a[w].z, l.z, el);
        el = __dp4a(r.a[w].w, l.w, el);
      }
      const int dot = 8 * (dh[0] + dh[1]) + (dl[0] + dl[1]);
      const float q = rank_key<K, M, Masked>(dot, j, s, r, p);
      if (q > best_q) {  // strict: the first occurrence of the max wins
        best_q = q;
        best_idx = c0 + j;
      }
    }
  }
}

}  // namespace fe
