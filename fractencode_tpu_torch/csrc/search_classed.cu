// Class-blocked all-pairs search with int8 operands: the 'ls', 'raw' and
// 'general' keys at K = 16, 64 and 256 (4x4, 8x8 and 16x16 range blocks),
// padded to K = 16, 64 and 256 for every other n up to 256 (2x2, 3x3, 5x5,
// 6x6, 7x7, 9x9 to 15x15 ranges), and in the K-slab form above (17x17 and
// larger; search_common.cuh's Geom), each with and without the early-accept
// frontier.
//
// Replaces the TPU kernel `_pairs_kernel` (fractencode_tpu/ops/matcher_pallas.py,
// reached through `fused_search_pairs`): its `ls_fast` int8 branch ('ls' at
// K = 16 and 64), its generic int8 branch (`_pair_ab_int8` + `_rank_tile`:
// 'raw' and 'general' at K = 16 and 64) and its f32 branch (`_pair_ab_f32` +
// `_rank_tile`, every key) at K = 256.  For each class-sorted range row r,
// with class c = tile_class[r / block_r], it returns the first-occurrence
// argmax over the columns [col_tile_start[c] * block_m, col_end[c]) of the
// rank key q (search_common.cuh), bit for bit against the plain version.  At
// K = 256 the key is formed from exact integers, each key rounded once to f32
// (the 'general' residual evaluated in double from them): that is the port's
// exact-integer rule for K = 256, where the TPU kernel computes the key in
// f32 (ROADMAP.md, parity contract).  The int8
// operands serve K = 256 too: 4B <= 1020 keeps ch = 4B >> 3 <= 127, and
// |dot| <= 256 * 128 * 1020 < 2^31.  A row whose class has no columns gets
// q = -3e38, idx = 0, the TPU kernel's initial value.  Without the frontier
// every row of a tile is searched, the layout's padding rows too, as the TPU
// kernel does; with it only the rows below row_end[c] (class c's real rows),
// so the padding rows keep that initial value and never hold a block's scan
// open.
//
// The `_thr` entry points add the TPU kernel's early-accept frontier
// (`_apply_frontier` at matcher_pallas.py:581-585 and the per-row freeze
// after it; search_common.cuh): groups of t_n columns counted from the class
// segment's start, which is also where the TPU kernel's groups start when
// block_m % t_n == 0, and which keeps a domain's columns together in the
// per-column layout (block_m % t_n != 0) that the TPU kernel refuses.
//
// The design: a block takes one 128-row slice of a range tile, so all its
// rows share the tile's class segment, and searches it whole with
// search_mma.cuh's tensor-core mainloop (the one K2 runs over a split of the
// segment and K3 over all columns), writing each row's (q, idx) directly:
// one launch, nothing read back, no partials.  What bounds it on the card:
// the epilogue, about eight to forty instructions of key and argmax a pair
// after the 2K int8 operations on the tensor cores, not memory.  A search
// with few range tiles (a quadtree level, a small plane) leaves SMs idle:
// K1 cannot split a segment, which is K2's work.

#include "search_mma.cuh"

namespace {

using namespace fe;

template <int K, int M, int G, bool Frontier>
__global__ void __launch_bounds__(mma::kThreads<K>)
search_classed_kernel(const int* __restrict__ ai,            // [r_pad] rows of K int8
                      const signed char* __restrict__ ch,    // [m_pad] rows of K int8
                      const signed char* __restrict__ cl,    // [m_pad] rows of K int8
                      const float* __restrict__ sb,          // [m_pad] SumB
                      const void* __restrict__ aux,          // [m_pad] f32 inv_var_b or SumB2;
                                                             // double SumB2 (exact keys)
                      const int* __restrict__ tile_class,      // [nrt]
                      const int* __restrict__ col_tile_start,  // [nc]
                      const int* __restrict__ col_end,         // [nc]
                      const int* __restrict__ row_end,         // [nc]
                      int block_r, int block_m, KeyParams p,
                      float* __restrict__ q_out,        // [r_pad]
                      int* __restrict__ idx_out) {      // [r_pad]
  extern __shared__ int4 smem[];
  auto& sm = *reinterpret_cast<mma::Smem<K, M, false, Frontier, G>*>(smem);
  const int cls = tile_class[blockIdx.x];
  const int slice = blockIdx.y * mma::kBlockRows;  // the block's first row in the tile
  const long long row0 = static_cast<long long>(blockIdx.x) * block_r + slice;
  const int n_load = min(mma::kBlockRows, block_r - slice);
  const int n_active = Frontier ? static_cast<int>(max(0LL, min(static_cast<long long>(n_load),
                                                                row_end[cls] - row0)))
                                : n_load;
  float* __restrict__ q = q_out + row0;
  int* __restrict__ idx = idx_out + row0;
  mma::search_rows<K, M, false, Frontier, mma::Policy::Argmax, false, G>(
      sm, ai, row0, n_load, n_active, nullptr, ch, cl, sb, aux, nullptr,
      col_tile_start[cls] * block_m, col_end[cls], p,
      [&](int local, float best_q, int best_idx, bool) {
        q[local] = best_q;
        idx[local] = best_idx;
      });
}

template <int K, int M, int G, bool Frontier>
int launch(const void* ai, const void* ch, const void* cl, const void* sb,
           const void* aux, const void* tile_class, const void* col_tile_start,
           const void* col_end, const void* row_end, int nrt, int block_r, int block_m, const KeyParams& p,
           void* q_out, void* idx_out, void* stream) {
  if (const int err = mma::check_geometry<K, G>(p)) return err;
  if (nrt <= 0 || block_r <= 0) return 0;
  const auto kernel = search_classed_kernel<K, M, G, Frontier>;
  constexpr size_t smem = sizeof(mma::Smem<K, M, false, Frontier, G>);
  if (const int err = mma::allow_smem(kernel, smem)) return err;
  const dim3 grid(nrt, (block_r + mma::kBlockRows - 1) / mma::kBlockRows);
  kernel<<<grid, mma::kThreads<K>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ai), static_cast<const signed char*>(ch),
      static_cast<const signed char*>(cl), static_cast<const float*>(sb),
      aux, static_cast<const int*>(tile_class),
      static_cast<const int*>(col_tile_start), static_cast<const int*>(col_end),
      static_cast<const int*>(row_end), block_r, block_m, p, static_cast<float*>(q_out),
      static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Two entry points per (key, K), `fe_search_classed_<key><K>` and its `_thr`
// form with the frontier, all with one signature.  sa, sa2 [r_pad] are read
// by the 'general' key and by the frontier; s_max, inv_n, inv_norm and
// so_reference by 'general'; row_end, threshold, dist_scale and t_n by the
// frontier.  The padded instances (`<key><K>p`, K = 16, 64, 256) and the
// K-slab form (`<key>_slab`) take n and the operands' row width kp (K, or
// n rounded up to 256 bytes) after t_n; the K-slab form's sa, sa2 and sb are
// float64.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
#define FE_SEARCH_CLASSED_PARAMS                                                        \
  const void *ai, const void *ch, const void *cl, const void *sb, const void *aux,      \
      const void *tile_class, const void *col_tile_start, const void *col_end,          \
      const void *row_end, int nrt, int block_r, int block_m, const void *sa,           \
      const void *sa2, float s_max, float inv_n, float inv_norm, int so_reference,      \
      float threshold, float dist_scale, int t_n
#define FE_SEARCH_CLASSED_CALL(MODE, K, G, FRONTIER, N, KP)                              \
  const fe::KeyParams p{static_cast<const float*>(sa),                                  \
                        static_cast<const float*>(sa2), s_max, inv_n, inv_norm,         \
                        so_reference, threshold, dist_scale, t_n, N, KP};               \
  return launch<K, MODE, G, FRONTIER>(ai, ch, cl, sb, aux, tile_class, col_tile_start,  \
                                      col_end, row_end, nrt, block_r, block_m, p, q_out,\
                                      idx_out, stream)
#define FE_SEARCH_CLASSED_ENTRY(NAME, MODE, K, SUFFIX, FRONTIER)                        \
  extern "C" int fe_search_classed_##NAME##K##SUFFIX(FE_SEARCH_CLASSED_PARAMS,          \
                                                     void* q_out, void* idx_out,        \
                                                     void* stream) {                    \
    FE_SEARCH_CLASSED_CALL(MODE, K, fe::kFixed, FRONTIER, K, K);                        \
  }
#define FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, TAG, K, G, SUFFIX, FRONTIER)           \
  extern "C" int fe_search_classed_##NAME##TAG##SUFFIX(FE_SEARCH_CLASSED_PARAMS, int n, \
                                                       int kp, void* q_out,             \
                                                       void* idx_out, void* stream) {   \
    FE_SEARCH_CLASSED_CALL(MODE, K, G, FRONTIER, n, kp);                                \
  }
#define FE_SEARCH_CLASSED_ENTRIES(NAME, MODE)                                            \
  FE_SEARCH_CLASSED_ENTRY(NAME, MODE, 16, , false)                                       \
  FE_SEARCH_CLASSED_ENTRY(NAME, MODE, 16, _thr, true)                                    \
  FE_SEARCH_CLASSED_ENTRY(NAME, MODE, 64, , false)                                       \
  FE_SEARCH_CLASSED_ENTRY(NAME, MODE, 64, _thr, true)                                    \
  FE_SEARCH_CLASSED_ENTRY(NAME, MODE, 256, , false)                                      \
  FE_SEARCH_CLASSED_ENTRY(NAME, MODE, 256, _thr, true)                                   \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, 16p, 16, fe::kPadded, , false)                \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, 16p, 16, fe::kPadded, _thr, true)             \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, 64p, 64, fe::kPadded, , false)                \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, 64p, 64, fe::kPadded, _thr, true)             \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, 256p, 256, fe::kPadded, , false)              \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, 256p, 256, fe::kPadded, _thr, true)           \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, _slab, 256, fe::kSlab, , false)               \
  FE_SEARCH_CLASSED_WIDE_ENTRY(NAME, MODE, _slab, 256, fe::kSlab, _thr, true)

FE_SEARCH_CLASSED_ENTRIES(ls, fe::kLs)
FE_SEARCH_CLASSED_ENTRIES(raw, fe::kRaw)
FE_SEARCH_CLASSED_ENTRIES(general, fe::kGeneral)

// The port's trace marks (utils/profiling.py): empty one-thread kernels whose
// names show in a device trace where a graph body begins and ends and where
// each encode stage starts.  They touch no memory; a stage runs from its mark
// to the next one on the stream.  The order is profiling.py's MARKS.
extern "C" __global__ void fractencode_mark_begin() {}
extern "C" __global__ void fractencode_mark_end() {}
extern "C" __global__ void fractencode_mark_inputs() {}
extern "C" __global__ void fractencode_mark_prep() {}
extern "C" __global__ void fractencode_mark_search() {}
extern "C" __global__ void fractencode_mark_post() {}

namespace {

void (*const kMarks[])() = {fractencode_mark_begin,  fractencode_mark_end,
                            fractencode_mark_inputs, fractencode_mark_prep,
                            fractencode_mark_search, fractencode_mark_post};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Launches mark `which` on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fe_mark(int which, void* stream) {
  if (which < 0 || which >= kNumMarks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[which]),
                                           dim3(1), dim3(1), nullptr, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// Loads every mark's code on the current device, so that the first launch,
// which may fall inside a graph's capture, loads nothing (lazy loading).
extern "C" int fe_mark_load() {
  for (int i = 0; i < kNumMarks; ++i) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kMarks[i]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
