// Dense search with int8 operands, optionally masked by class: the 'ls',
// 'raw' and 'general' keys at K = 16, 64 and 256; each also with the
// early-accept frontier, without the class mask.
//
// Replaces the TPU kernel `_search_kernel` (fractencode_tpu/ops/matcher_pallas.py,
// reached through `fused_search`), which serves the search without the
// classifier (`search_pallas`: --noclassifier, and the quadtree without it).
// For each range row r it returns the first-occurrence argmax over the columns
// [0, m_valid) of the rank key q (search_common.cuh), in search order
// m = d*T + (T-1-t), bit for bit against the plain version.  With the class
// mask (rcls, ccls non-null) only columns with ccls[j] == rcls[r] compete, the
// TPU kernel's per-element `rcls == ccls` compare; a row with no such column
// gets q = -3e38, idx = 0, the TPU kernel's initial value.  The TPU kernel
// pads its grid and masks the tail with `col < m_valid`; this one needs no
// padding and stops at m_valid and at the last row.  At K = 256 every key is
// formed from exact integers, the port's rule where the TPU kernel ranks in
// f32 (ROADMAP.md, parity contract).
//
// The `_thr` entry points add the TPU kernel's early-accept frontier
// (`_apply_frontier` at matcher_pallas.py:227-231 and the freeze at :244-248;
// search_common.cuh), groups of t_n columns from column 0.  They take no
// class mask: no path asks for it (the encoder sends classed work to K1).
//
// What bounds it on the card: arithmetic issue.  Every row meets every column
// (6.8e10 pairs for a 2048^2 plane at the default geometry), each pair K/2
// dp4a plus the key's epilogue, while the codebook is 2K bytes a column that
// every row reuses.  The design is K1's (search_classed.cu): one thread per
// range row, every block streaming the whole codebook through shared memory
// in chunks, each thread scanning in ascending order with a strict '>'.
// Tensor-core tiling and splitting a row's scan across threads are left for a
// later change.

#include "search_common.cuh"

namespace {

using namespace fe;

template <int K, int M, bool Masked, bool Frontier>
__global__ void __launch_bounds__(kRows)
search_dense_kernel(const int4* __restrict__ ai,    // [rows] rows of K int8
                    const int4* __restrict__ ch,    // [>= m_valid] rows of K int8
                    const int4* __restrict__ cl,    // [>= m_valid] rows of K int8
                    const float* __restrict__ sb,   // SumB per column
                    const void* __restrict__ aux,   // per column: f32 inv_var_b or SumB2;
                                                    // double SumB2 (exact keys)
                    const int* __restrict__ rcls,   // [rows] (Masked only)
                    const int* __restrict__ ccls,   // per column (Masked only)
                    int rows, int m_valid, KeyParams p,
                    float* __restrict__ q_out,      // [rows]
                    int* __restrict__ idx_out) {    // [rows]
  __shared__ Chunk<K, M, Masked> s;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool active = row < rows;
  const Row<K> r = load_row<K, M, Frontier>(ai, row, active, p);
  const int cls = Masked && active ? rcls[row] : 0;
  float best_q = kInitQ;
  int best_idx = 0;
  scan_columns<K, M, Masked, Frontier>(s, r, active, cls, ch, cl, sb, aux, ccls, 0,
                                       m_valid, p, best_q, best_idx);
  if (active) {
    q_out[row] = best_q;
    idx_out[row] = best_idx;
  }
}

template <int K, int M, bool Masked, bool Frontier>
int launch(const void* ai, const void* ch, const void* cl, const void* sb,
           const void* aux, const void* rcls, const void* ccls, int rows, int m_valid,
           const KeyParams& p, void* q_out, void* idx_out, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kRows - 1) / kRows;
  search_dense_kernel<K, M, Masked, Frontier><<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(ai), static_cast<const int4*>(ch),
      static_cast<const int4*>(cl), static_cast<const float*>(sb),
      aux, static_cast<const int*>(rcls),
      static_cast<const int*>(ccls), rows, m_valid, p, static_cast<float*>(q_out),
      static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Two entry points per (key, K), `fe_search_dense_<key><K>` and its `_thr`
// form with the frontier, all with one signature; rcls and ccls both null
// means no class mask (the `_thr` form refuses one).  sa, sa2 [rows] are read
// by the 'general' key and by the frontier; s_max, inv_n, inv_norm and
// so_reference by 'general'; threshold, dist_scale and t_n by the frontier.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
#define FE_SEARCH_DENSE_SIGNATURE(NAME, K, SUFFIX)                                      \
  extern "C" int fe_search_dense_##NAME##K##SUFFIX(                                     \
      const void* ai, const void* ch, const void* cl, const void* sb, const void* aux,  \
      const void* rcls, const void* ccls, int rows, int m_valid, const void* sa,        \
      const void* sa2, float s_max, float inv_n, float inv_norm, int so_reference,      \
      float threshold, float dist_scale, int t_n, void* q_out, void* idx_out,           \
      void* stream)
#define FE_KEY_PARAMS                                                                   \
  const fe::KeyParams p{static_cast<const float*>(sa), static_cast<const float*>(sa2), \
                        s_max, inv_n, inv_norm, so_reference, threshold, dist_scale,    \
                        t_n}
#define FE_SEARCH_DENSE_ENTRIES(NAME, MODE, K)                                          \
  FE_SEARCH_DENSE_SIGNATURE(NAME, K, ) {                                                \
    FE_KEY_PARAMS;                                                                      \
    if (ccls != nullptr) {                                                              \
      return launch<K, MODE, true, false>(ai, ch, cl, sb, aux, rcls, ccls, rows,        \
                                          m_valid, p, q_out, idx_out, stream);          \
    }                                                                                   \
    return launch<K, MODE, false, false>(ai, ch, cl, sb, aux, rcls, ccls, rows,         \
                                         m_valid, p, q_out, idx_out, stream);           \
  }                                                                                     \
  FE_SEARCH_DENSE_SIGNATURE(NAME, K, _thr) {                                            \
    FE_KEY_PARAMS;                                                                      \
    if (ccls != nullptr) return static_cast<int>(cudaErrorInvalidValue);                \
    return launch<K, MODE, false, true>(ai, ch, cl, sb, aux, rcls, ccls, rows, m_valid, \
                                        p, q_out, idx_out, stream);                     \
  }

FE_SEARCH_DENSE_ENTRIES(ls, fe::kLs, 16)
FE_SEARCH_DENSE_ENTRIES(ls, fe::kLs, 64)
FE_SEARCH_DENSE_ENTRIES(ls, fe::kLs, 256)
FE_SEARCH_DENSE_ENTRIES(raw, fe::kRaw, 16)
FE_SEARCH_DENSE_ENTRIES(raw, fe::kRaw, 64)
FE_SEARCH_DENSE_ENTRIES(raw, fe::kRaw, 256)
FE_SEARCH_DENSE_ENTRIES(general, fe::kGeneral, 16)
FE_SEARCH_DENSE_ENTRIES(general, fe::kGeneral, 64)
FE_SEARCH_DENSE_ENTRIES(general, fe::kGeneral, 256)
