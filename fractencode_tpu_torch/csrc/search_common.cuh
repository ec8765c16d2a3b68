// Device code shared by the port's search kernels: search_classed.cu (K1,
// the class-blocked search), search_classed2d.cu (K2, the same search split
// across blocks), search_dense.cu (K3, the dense search) and micro_step.cu
// (K4/K5, the pair-list step microbenchmark).  The keys, the row sums and
// the frontier's hit test here serve all of them; each forms its dots on
// the tensor cores, in search_mma.cuh's mainloop.
//
// The rank keys are bit for bit those of the plain PyTorch version
// (ops/matcher_kernels.py, `_rank_ls_int8`, `_rank_tile` and `_rank_exact`):
//   * every integer is exact: dot = sum_k ai * (8 ch + cl) (by s8
//     tensor-core products), and
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
// At K = 256 'raw' and 'general' rank from exact integers (the `Exact` keys;
// aux is then the exact SumB2 as float64, 16 SumB2 <= 266,342,400):
//   raw     q = f32(8 (4 SumAB) - 16 SumB2) / 16, the integer in int32
//           (<= 532,684,800) with 4 SumAB = dot + 128 sb4, one rounding;
//   general cov4, var16 = n (16 SumB2) - sb4^2, var_a and the 'reference'
//           denominator n SumA2 - (SumA - 1) SumA in int64, then s, o and e
//           in double with __dmul_rn/__dadd_rn/__dsub_rn/__ddiv_rn (nvcc
//           contracts doubles into FMAs too), q = -f32(max(e, 0) inv_norm).
// rank_key forms every key from the integer dot; search_mma.cuh's fast_key
// forms 'ls' and 'raw' at K <= 64 from the tensor cores' accumulators with
// the same single roundings (the other steps exact), so bit for bit alike.
//
// K and n (the `Geom` of an instance).  K is the width the instance stages:
// its operand rows, its products' depth.  n is the range's pixel count, which
// every key formula reads.  Fixed instances have n = K at compile time.
// Padded ones (K = 16, 64, 256 for n up to it) take n at run time, their
// operands zero past n: ai = 0 and ch = cl = 0 there add nothing to the dot
// or to the rows' byte sums, so every integer is n's.  Their 'ls' key forms
// cov4 in integers and rounds it once (rank_key; fast_key's 'ls' form is
// exact only for n a power of two).  The K-slab form (n > 256) stages slabs of
// K = 256 bytes of rows kp = n rounded up to 256 bytes wide, and sums the
// products over the slabs (search_mma.cuh); it ranks with the Exact keys, its
// integers in int64 (16 SumB2 <= n * 1,040,400, 'raw''s 16q <= n * 2,080,800),
// and reads SumA, SumA2 and SumB as float64, which holds them exactly
// (SumA2 <= n * 65,025 leaves f32's 2^24 above n = 258).  Its dh sums stay
// exact in int32 while n * 128 * 127 < 2^31: n <= 132,104.
//
// The early-accept frontier (the `Frontier` instantiations; the TPU kernels'
// `_apply_frontier`, matcher_pallas.py:103-129): columns come in groups of
// t_n, one domain's isometries, counted from the start of the scan.  A column
// hits when its distance (rank_to_dist's expression: 'ls'
// max(var_a - q, 0) * f32(inv_norm / n), var_a exact; 'raw'
// (SumA2 - q) * f32(inv_norm); 'general' -q) is <= f32(threshold).  In the
// first group with a hit, the winner is the first-occurrence argmax over the
// columns before the group and those from its LAST hit column on; nothing
// after the group is scanned.  The scan keeps that without a second pass: a
// group-local best restarts at every hit column (so it ranges over the
// columns from the group's last hit on, or the whole group without one) and
// merges into the running best at the group's end with a strict '>' (the
// earlier groups hold the lower columns).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fe {

constexpr float kInitQ = -3.0e38f;

enum Mode : int { kLs = 0, kRaw = 1, kGeneral = 2 };

// An instance's geometry: n = K (fixed), n <= K at run time (padded), or
// n > 256 over slabs of K = 256 (the K-slab form).
enum Geom : int { kFixed = 0, kPadded = 1, kSlab = 2 };

// The per-row and per-column sums an instance reads (SumA, SumA2, SumB):
// f32, exact up to K = 256, or float64 for the K-slab form.
template <int G>
using Sum = typename std::conditional<G == kSlab, double, float>::type;
// The integers that leave int32 in the K-slab form: dot, 4 SumAB, 16 SumB2.
template <int G>
using Wide = typename std::conditional<G == kSlab, long long, int>::type;

// 'raw' and 'general' above K = 64 rank from exact integers.
template <int K, int M>
constexpr bool kExact = K > 64 && M != kLs;

// Per-call inputs of the 'general' key and of the frontier (unused otherwise),
// and the instance's n and row width.
struct KeyParams {
  const float* sa;   // [rows] SumA ('general', frontier); float64 (K-slab form)
  const float* sa2;  // [rows] SumA2 ('general', frontier); float64 (K-slab form)
  float s_max;       // |s| clamp; <= 0 is off
  float inv_n;       // f32(1 / n)
  float inv_norm;    // f32(inv_norm)
  int so_reference;  // 1: so_mode 'reference' ((SumA - 1) SumA denominator)
  float threshold;   // frontier: f32(rms_threshold)
  float dist_scale;  // frontier: 'ls' f32(inv_norm / n), 'raw' f32(inv_norm)
  int t_n;           // frontier: columns per group (isometries per domain)
  int n;             // padded and K-slab instances: the range's pixel count
  int kp;            // K-slab form: the operands' row width in bytes (n rounded up to 256)
};

// The n of an instance's keys.
template <int K, int G>
__device__ __forceinline__ int n_of(const KeyParams& p) {
  if constexpr (G == kFixed) {
    return K;
  } else {
    return p.n;
  }
}

// A row's sum from a KeyParams array (f32, or float64 in the K-slab form).
template <int G>
__device__ __forceinline__ Sum<G> row_in(const float* a, long long row) {
  return reinterpret_cast<const Sum<G>*>(a)[row];
}

__device__ __forceinline__ float to_f(int x) { return __int2float_rn(x); }
__device__ __forceinline__ float to_f(long long x) { return __ll2float_rn(x); }
__device__ __forceinline__ double to_d(int x) { return __int2double_rn(x); }
__device__ __forceinline__ double to_d(long long x) { return __ll2double_rn(x); }

template <int K, int G = kFixed>
struct Row {
  // the row's K int8 values: the mainloop keeps them in its A fragments and
  // never sets these, but the field stays, as Row's layout steers how nvcc
  // allocates the searches' registers
  int4 a[K / 16];
  int base;                   // 128 n - SumA ('ls', 'general')
  Sum<G> sa, sa2;             // 'general', the frontier
  float var_a, den;           // 'general'
  double var_ad, den_d;       // Exact 'general': var_a and den, exact
  float hit_a;                // frontier: 'ls' f32(exact var_a), 'raw' SumA2
  float hit_q;                // frontier: the least key that hits (hit_key)
};

// The frontier's hit test: rank_to_dist's distance of key q, <= threshold.
template <int K, int M, int G>
__device__ __forceinline__ bool hits(float q, const Row<K, G>& r, const KeyParams& p) {
  float dist;
  if constexpr (M == kLs) {
    dist = __fmul_rn(fmaxf(__fsub_rn(r.hit_a, q), 0.0f), p.dist_scale);
  } else if constexpr (M == kRaw) {
    dist = __fmul_rn(__fsub_rn(r.hit_a, q), p.dist_scale);
  } else {
    dist = -q;
  }
  return dist <= p.threshold;
}

// The least key that hits.  rank_to_dist's distance is a chain of correctly
// rounded operations, each monotone in q, so it never increases with q: the
// hit test is q >= hit_key, one compare per pair.  'general' hits where
// -q <= t, i.e. q >= -t (negation is exact); the other keys find the key by
// bisection over the f32 values in order (their bit patterns mapped to
// ordered integers; +0 and -0 give the same distance).  At q = FLT_MAX the
// distance is <= 0 < threshold, so the search always ends on a hit.
template <int K, int M, int G>
__device__ __forceinline__ float hit_key(const Row<K, G>& r, const KeyParams& p) {
  if constexpr (M == kGeneral) {
    return -p.threshold;
  } else {
    auto ordered = [](float x) {
      const unsigned u = __float_as_uint(x);
      return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    };
    auto value = [](unsigned o) {
      return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
    };
    unsigned lo = ordered(-3.4028234663852886e38f), hi = ordered(3.4028234663852886e38f);
    while (lo < hi) {
      const unsigned mid = lo + (hi - lo) / 2;
      if (hits<K, M, G>(value(mid), r, p)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    return value(lo);
  }
}

// A range row's sums from its byte sum `rowsum` (sum of its K int8 values):
// the key's per-row values, and for the frontier its least hitting key.
// SumA is rowsum plus 128 n for 'ls' (a padded row's zero bytes add
// nothing); 'general' and the frontier read SumA and SumA2 from their
// inputs, as the plain version does (they differ on the layout's padding
// rows, whose ai is 0 but whose sums are 0).
template <int K, int M, int G, bool Frontier>
__device__ __forceinline__ Row<K, G> row_sums(int rowsum, long long row, bool active,
                                              const KeyParams& p) {
  const int n = n_of<K, G>(p);
  const float nf = static_cast<float>(n);  // exact
  Row<K, G> r;
  r.base = 128 * n - (rowsum + 128 * n);
  r.sa = r.sa2 = 0.0f;
  r.var_a = r.den = r.hit_a = 0.0f;
  r.var_ad = r.den_d = 0.0;
  if constexpr (M == kGeneral || Frontier) {
    r.sa = active ? row_in<G>(p.sa, row) : 0.0f;
    r.sa2 = active ? row_in<G>(p.sa2, row) : 0.0f;
  }
  if constexpr (Frontier) {
    if constexpr (M == kLs) {  // var_a = n*SumA2 - SumA^2, exact in int64, one rounding
      const long long sa = static_cast<long long>(r.sa);
      r.hit_a = __ll2float_rn(n * static_cast<long long>(r.sa2) - sa * sa);
    } else if constexpr (M == kRaw) {
      r.hit_a = static_cast<float>(r.sa2);  // K-slab form: SumA2 rounded once
    }
  }
  r.hit_q = 0.0f;
  if constexpr (Frontier) r.hit_q = hit_key<K, M, G>(r, p);
  if constexpr (M == kGeneral) {
    r.base = 128 * n - static_cast<int>(r.sa);
    if constexpr (kExact<K, M>) {  // exact in int64, then exact in double
      const long long sa = static_cast<long long>(r.sa);
      const long long sa2 = static_cast<long long>(r.sa2);
      r.var_ad = __ll2double_rn(n * sa2 - sa * sa);
      r.den_d = __ll2double_rn(n * sa2 - (sa - 1) * sa);
    } else {
      // var_a = n*sa2 - sa*sa;  den = n*sa2 - (sa - 1.0)*sa
      r.var_a = __fsub_rn(__fmul_rn(nf, r.sa2), __fmul_rn(r.sa, r.sa));
      r.den = __fsub_rn(__fmul_rn(nf, r.sa2), __fmul_rn(__fsub_rn(r.sa, 1.0f), r.sa));
    }
  }
  return r;
}

// s = 0 where |den| < 1e-5, else cov / den; then the |s| clamp.
__device__ __forceinline__ float solve_s(float cov, float den, const KeyParams& p) {
  float s = fabsf(den) < 1e-5f ? 0.0f : __fdiv_rn(cov, den == 0.0f ? 1.0f : den);
  if (p.s_max > 0.0f) s = fminf(fmaxf(s, -p.s_max), p.s_max);
  return s;
}

// The 'general' key above K = 64 from the exact integers (matcher_kernels.
// _rank_exact): s, o and the residual in double in the plain version's
// order, one rounding to f32 at the end.  D: int, or long long in the K-slab
// form.
template <int K, int M, int G, bool Masked, class S, class D>
__device__ __forceinline__ float general_exact(D dot, D ab4, int j, const S& s,
                                               const Row<K, G>& r, const KeyParams& p) {
  const int n = n_of<K, G>(p);
  // 1.0 / n, correctly rounded
  const double inv_n = G == kFixed ? 1.0 / K : __ddiv_rn(1.0, static_cast<double>(n));
  const int sb4 = s.sb4[j];
  // cov = (n*dot + (128n - SumA)*sb4) * 0.25, exact (|cov4| < 2^53)
  const double cov = __dmul_rn(__ll2double_rn(static_cast<long long>(n) * dot +
                                              static_cast<long long>(r.base) * sb4), 0.25);
  const double den = p.so_reference ? r.den_d : s.var_bd[j];
  double sv = den == 0.0 ? 0.0 : __ddiv_rn(cov, den);
  if (p.s_max > 0.0f) {
    const double s_max = p.s_max;
    sv = fmin(fmax(sv, -s_max), s_max);
  }
  const double two_s = __dmul_rn(2.0, sv);
  double e;
  if (!p.so_reference) {
    // e = (var_a - 2.0*s*cov + (s*s)*var_b) * (1.0/n)
    e = __dmul_rn(__dadd_rn(__dsub_rn(r.var_ad, __dmul_rn(two_s, cov)),
                            __dmul_rn(__dmul_rn(sv, sv), den)),
                  inv_n);
  } else {
    const double sa = r.sa, sa2 = r.sa2;  // exact
    const double sb = __dmul_rn(__int2double_rn(sb4), 0.25);
    const double sb2 = __dmul_rn(to_d(s.sb2_16[j]), 0.0625);
    const double ab = __dmul_rn(to_d(ab4), 0.25);
    // o = (sb - s*sa) * (1.0/n)
    const double o = __dmul_rn(__dsub_rn(sb, __dmul_rn(sv, sa)), inv_n);
    // e = sa2 + (s*s)*sb2 + n*o*o + 2.0*s*o*sb - 2.0*s*ab - 2.0*o*sa
    e = __dadd_rn(sa2, __dmul_rn(__dmul_rn(sv, sv), sb2));
    e = __dadd_rn(e, __dmul_rn(__dmul_rn(static_cast<double>(n), o), o));
    e = __dadd_rn(e, __dmul_rn(__dmul_rn(two_s, o), sb));
    e = __dsub_rn(e, __dmul_rn(two_s, ab));
    e = __dsub_rn(e, __dmul_rn(__dmul_rn(2.0, o), sa));
  }
  // -f32(max(e, 0) * inv_norm)
  return -__double2float_rn(__dmul_rn(fmax(e, 0.0), static_cast<double>(p.inv_norm)));
}

// The rank key of row `r` against staged column j, from the exact dot (D:
// int, or long long in the K-slab form).  `s` is a staging with its
// per-column arrays (search_mma.cuh's Cols).
template <int K, int M, int G, bool Masked, class S, class D>
__device__ __forceinline__ float rank_key(D dot, int j, const S& s, const Row<K, G>& r,
                                          const KeyParams& p) {
  const int n = n_of<K, G>(p);
  const float nf = static_cast<float>(n);  // exact
  if constexpr (M == kLs) {
    float c;
    if constexpr (K <= 64) {
      c = __int2float_rn(n * dot + r.base * s.sb4[j]);
    } else {  // cov4 reaches ~9e9 at K = 256: int64, then one rounding
      c = __ll2float_rn(static_cast<long long>(n) * dot +
                        static_cast<long long>(r.base) * s.sb4[j]);
    }
    return __fmul_rn(__fmul_rn(c, c), s.aux[j]);
  } else if constexpr (kExact<K, M>) {
    const D ab4 = dot + 128 * s.sb4[j];  // 4 SumAB <= 66,585,600 at n = 256
    if constexpr (M == kRaw) {
      // 16q = 8*(4 SumAB) - 16 SumB2, exact in int32 (int64 in the K-slab
      // form); one rounding, exact scale
      return __fmul_rn(to_f(8 * ab4 - s.sb2_16[j]), 0.0625f);
    } else {
      return general_exact<K, M, G, Masked>(dot, ab4, j, s, r, p);
    }
  } else {
    const float sb = s.sb[j];
    const float sb2 = s.aux[j];
    // ab = dot*0.25 + 128.0*sb
    const float ab = __fadd_rn(__fmul_rn(__int2float_rn(dot), 0.25f), __fmul_rn(128.0f, sb));
    if constexpr (M == kRaw) {
      return __fsub_rn(__fmul_rn(2.0f, ab), sb2);  // 2.0*ab - sb2
    } else {
      const float cov = __fmul_rn(__int2float_rn(n * dot + r.base * s.sb4[j]), 0.25f);
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
        e = __fadd_rn(e, __fmul_rn(__fmul_rn(nf, o), o));
        e = __fadd_rn(e, __fmul_rn(__fmul_rn(two_s, o), sb));
        e = __fsub_rn(e, __fmul_rn(two_s, ab));
        e = __fsub_rn(e, __fmul_rn(__fmul_rn(2.0f, o), r.sa));
      }
      return -__fmul_rn(fmaxf(e, 0.0f), p.inv_norm);  // -(max(e, 0)*inv_norm)
    }
  }
}

// One column's inputs: SumB, the key's aux (f32 inv_var_b or SumB2; the
// exact SumB2 as double for the Exact keys) and, for the class mask, its
// class.
template <int G>
struct ColumnIn {
  Sum<G> b;
  float a;
  double ad;
  int cls;
};

template <int K, int M, int G, bool Masked>
__device__ __forceinline__ ColumnIn<G> load_column(long long c, const float* __restrict__ sb,
                                                   const void* __restrict__ aux_v,
                                                   const int* __restrict__ ccls) {
  ColumnIn<G> in;
  in.b = reinterpret_cast<const Sum<G>*>(sb)[c];
  in.a = 0.0f;
  in.ad = 0.0;
  if constexpr (kExact<K, M>) {
    in.ad = static_cast<const double*>(aux_v)[c];
  } else {
    in.a = static_cast<const float*>(aux_v)[c];
  }
  in.cls = Masked ? ccls[c] : 0;
  return in;
}

// Stages a column's values at slot j of `s` (a staging with its per-column
// arrays, search_mma.cuh's Cols): 4 SumB and the key's aux, and what the key
// derives from them once per column.
template <int K, int M, int G, bool Masked, class S>
__device__ __forceinline__ void stage_column(S& s, int j, const ColumnIn<G>& in,
                                             const KeyParams& p) {
  const int n = n_of<K, G>(p);
  const float nf = static_cast<float>(n);  // exact
  const Sum<G> b = in.b;
  // exact for the encoder's SumB (a multiple of 0.25); truncated toward zero
  // otherwise, as the plain version's int32 cast truncates
  if constexpr (M != kRaw || kExact<K, M>) s.sb4[j] = static_cast<int>(4.0f * b);
  if constexpr (kExact<K, M>) {
    const Wide<G> sb2_16 = static_cast<Wide<G>>(__dmul_rn(in.ad, 16.0));  // exact
    s.sb2_16[j] = sb2_16;
    if constexpr (M == kGeneral) {  // var_b = (n*16 SumB2 - sb4^2) / 16, exact
      const long long sb4 = s.sb4[j];
      s.var_bd[j] = __dmul_rn(__ll2double_rn(n * static_cast<long long>(sb2_16) - sb4 * sb4),
                              0.0625);
    }
  } else if constexpr (M == kLs) {
    s.aux[j] = in.a * 0.0625f;  // exact: power-of-two scale
  } else {
    s.aux[j] = in.a;
    s.sb[j] = b;
  }
  if constexpr (M == kGeneral && !kExact<K, M>) {  // var_b = n*sb2 - sb*sb
    s.var_b[j] = __fsub_rn(__fmul_rn(nf, in.a), __fmul_rn(b, b));
  }
  if constexpr (Masked) s.cls[j] = in.cls;
}

}  // namespace fe
