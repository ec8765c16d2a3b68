// Dense search with int8 operands, optionally masked by class: the 'ls',
// 'raw' and 'general' keys at K = 16, 64 and 256, padded to them for the
// other n up to 256, and in the K-slab form above (search_common.cuh's
// Geom); each also with the early-accept frontier, with or without the class
// mask.
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
// search_common.cuh), groups of t_n columns from column 0 (search_mma.cuh).
// With the class mask, a column of another class takes the key -3e38 before
// the hit test, as the TPU kernel masks before `_apply_frontier`
// (matcher_pallas.py:215-231): it is never a hit and never ends a group's
// scan.  The sharded searches ask for it: they express the domains a shard
// must skip (padding rows, rows off the image) as a class that no range has
// (parallel/sharded.py's `_search_any`).
//
// What bounds it on the card: the epilogue.  Every row meets every column
// (6.8e10 pairs for a 2048^2 plane at the default geometry), each pair 2K
// int8 operations on the tensor cores and the key's epilogue on the FP32 and
// integer pipes, while the codebook is 2K bytes a column that every row
// reuses.  The design is search_mma.cuh's: 128 rows a block, their A
// fragments in registers, the whole codebook streamed through shared memory
// in double-buffered chunks, s8 mma.sync products, rank_key and a
// per-lane strict '>' merged across each quad.

#include "search_mma.cuh"

namespace {

using namespace fe;

template <int K, int M, int G, bool Masked, bool Frontier>
__global__ void __launch_bounds__(mma::kThreads<K>)
search_dense_kernel(const int* __restrict__ ai,            // [rows] rows of K int8
                    const signed char* __restrict__ ch,    // [>= m_valid] rows of K int8
                    const signed char* __restrict__ cl,    // [>= m_valid] rows of K int8
                    const float* __restrict__ sb,          // SumB per column
                    const void* __restrict__ aux,          // per column: f32 inv_var_b or SumB2;
                                                           // double SumB2 (exact keys)
                    const int* __restrict__ rcls,          // [rows] (Masked only)
                    const int* __restrict__ ccls,          // per column (Masked only)
                    int rows, int m_valid, KeyParams p,
                    float* __restrict__ q_out,             // [rows]
                    int* __restrict__ idx_out) {           // [rows]
  extern __shared__ int4 smem[];
  auto& sm = *reinterpret_cast<mma::Smem<K, M, Masked, Frontier, G>*>(smem);
  const long long row0 = static_cast<long long>(blockIdx.x) * mma::kBlockRows;
  const int n = static_cast<int>(min(static_cast<long long>(mma::kBlockRows), rows - row0));
  mma::search_rows<K, M, Masked, Frontier, mma::Policy::Argmax, false, G>(
      sm, ai, row0, n, n, rcls, ch, cl, sb, aux, ccls, 0, m_valid, p,
      [&](int local, float q, int idx, bool) {
        q_out[row0 + local] = q;
        idx_out[row0 + local] = idx;
      });
}

template <int K, int M, int G, bool Masked, bool Frontier>
int launch(const void* ai, const void* ch, const void* cl, const void* sb,
           const void* aux, const void* rcls, const void* ccls, int rows, int m_valid,
           const KeyParams& p, void* q_out, void* idx_out, void* stream) {
  if (const int err = mma::check_geometry<K, G>(p)) return err;
  if (rows <= 0) return 0;
  const auto kernel = search_dense_kernel<K, M, G, Masked, Frontier>;
  constexpr size_t smem = sizeof(mma::Smem<K, M, Masked, Frontier, G>);
  if (const int err = mma::allow_smem(kernel, smem)) return err;
  const int blocks = (rows + mma::kBlockRows - 1) / mma::kBlockRows;
  kernel<<<blocks, mma::kThreads<K>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ai), static_cast<const signed char*>(ch),
      static_cast<const signed char*>(cl), static_cast<const float*>(sb),
      aux, static_cast<const int*>(rcls),
      static_cast<const int*>(ccls), rows, m_valid, p, static_cast<float*>(q_out),
      static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Two entry points per (key, K), `fe_search_dense_<key><K>` and its `_thr`
// form with the frontier, all with one signature; rcls and ccls both null
// means no class mask.  sa, sa2 [rows] are read
// by the 'general' key and by the frontier; s_max, inv_n, inv_norm and
// so_reference by 'general'; threshold, dist_scale and t_n by the frontier.
// The padded instances (`<key><K>p`) and the K-slab form (`<key>_slab`) take
// n and the row width kp after t_n, as K1's.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
#define FE_SEARCH_DENSE_PARAMS                                                          \
  const void *ai, const void *ch, const void *cl, const void *sb, const void *aux,      \
      const void *rcls, const void *ccls, int rows, int m_valid, const void *sa,        \
      const void *sa2, float s_max, float inv_n, float inv_norm, int so_reference,      \
      float threshold, float dist_scale, int t_n
#define FE_SEARCH_DENSE_CALL(MODE, K, G, FRONTIER, N, KP)                               \
  const fe::KeyParams p{static_cast<const float*>(sa), static_cast<const float*>(sa2), \
                        s_max, inv_n, inv_norm, so_reference, threshold, dist_scale,    \
                        t_n, N, KP};                                                    \
  if (ccls != nullptr) {                                                                \
    return launch<K, MODE, G, true, FRONTIER>(ai, ch, cl, sb, aux, rcls, ccls, rows,    \
                                              m_valid, p, q_out, idx_out, stream);      \
  }                                                                                     \
  return launch<K, MODE, G, false, FRONTIER>(ai, ch, cl, sb, aux, rcls, ccls, rows,     \
                                             m_valid, p, q_out, idx_out, stream)
#define FE_SEARCH_DENSE_ENTRY(NAME, MODE, K, SUFFIX, FRONTIER)                          \
  extern "C" int fe_search_dense_##NAME##K##SUFFIX(FE_SEARCH_DENSE_PARAMS, void* q_out, \
                                                   void* idx_out, void* stream) {       \
    FE_SEARCH_DENSE_CALL(MODE, K, fe::kFixed, FRONTIER, K, K);                          \
  }
#define FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, TAG, K, G, SUFFIX, FRONTIER)             \
  extern "C" int fe_search_dense_##NAME##TAG##SUFFIX(FE_SEARCH_DENSE_PARAMS, int n,     \
                                                     int kp, void* q_out,               \
                                                     void* idx_out, void* stream) {     \
    FE_SEARCH_DENSE_CALL(MODE, K, G, FRONTIER, n, kp);                                  \
  }
#define FE_SEARCH_DENSE_ENTRIES(NAME, MODE)                                             \
  FE_SEARCH_DENSE_ENTRY(NAME, MODE, 16, , false)                                        \
  FE_SEARCH_DENSE_ENTRY(NAME, MODE, 16, _thr, true)                                     \
  FE_SEARCH_DENSE_ENTRY(NAME, MODE, 64, , false)                                        \
  FE_SEARCH_DENSE_ENTRY(NAME, MODE, 64, _thr, true)                                     \
  FE_SEARCH_DENSE_ENTRY(NAME, MODE, 256, , false)                                       \
  FE_SEARCH_DENSE_ENTRY(NAME, MODE, 256, _thr, true)                                    \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, 16p, 16, fe::kPadded, , false)                 \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, 16p, 16, fe::kPadded, _thr, true)              \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, 64p, 64, fe::kPadded, , false)                 \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, 64p, 64, fe::kPadded, _thr, true)              \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, 256p, 256, fe::kPadded, , false)               \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, 256p, 256, fe::kPadded, _thr, true)            \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, _slab, 256, fe::kSlab, , false)                \
  FE_SEARCH_DENSE_WIDE_ENTRY(NAME, MODE, _slab, 256, fe::kSlab, _thr, true)

FE_SEARCH_DENSE_ENTRIES(ls, fe::kLs)
FE_SEARCH_DENSE_ENTRIES(raw, fe::kRaw)
FE_SEARCH_DENSE_ENTRIES(general, fe::kGeneral)
