// Class-blocked all-pairs search split across blocks (K2): the function of
// search_classed.cu (K1) on the same class-sorted layout, for the 'ls', 'raw'
// and 'general' keys at K = 16, 64 and 256, padded to them for the other n
// up to 256, and in the K-slab form above (search_common.cuh's Geom), each
// with and without the early-accept frontier.
//
// Replaces the TPU kernel `_classed_kernel` (fractencode_tpu/ops/matcher_pallas.py,
// reached through `fused_search_classed`): its ls_fast int8 branch ('ls' at
// K = 16 and 64), its generic int8 branch ('raw' and 'general' at K = 16 and
// 64), its f32 branch at K = 256 (every key, here from exact integers as in
// K1: ROADMAP.md, parity contract) and its `_apply_frontier` with the per-row
// freeze after it.  The TPU kernel walks a 2-D grid (range tile, column tile
// of the class) in order, carrying each row's best and its frozen flag in
// scratch from one column tile to the next.  Blocks here run in no order, so
// the second grid axis becomes a split of the class segment that a block
// searches alone, and the carry becomes a second pass:
//
//   * the split kernel, grid (work item, row slice): the grid's x runs over
//     `work`, (range tile, class, first column, end column) of each split
//     that has columns, in tile then split order; a block at or past their
//     count `*n_work` returns before it stages anything.  The list, its
//     count and the split width `*width` stay on the device (the wrapper
//     builds them with torch ops), so a launch reads nothing back: the
//     grid's x is a bound on the work items that the shapes give, and a
//     block past the list costs a start.  Split z of class c covers the
//     columns [s + z * width, min(s + (z + 1) * width, col_end[c])) of c's
//     segment, s = col_tile_start[c] * block_m.  A block searches its 128
//     rows over them with search_mma.cuh's tensor-core mainloop (K1's keys
//     and argmax, bit for bit), and writes each row's partial (q, idx) and
//     whether its scan met the frontier at [x * block_r + row in tile].
//     `width` is a multiple of t_n with the frontier, so the frontier's
//     groups, counted from each split's start, are the segment's own groups
//     and none straddles two splits;
//   * the reduce kernel, one thread per row of r_pad (its tile's first work
//     item from `first`): the strict-'>' max of the row's partials in split
//     order, up to and including the first split that hit.
//     An earlier split holds lower columns, so ties go to the lowest column,
//     and nothing after the row's frontier counts: exactly K1's result.
//
// What bounds it on the card: the epilogue (search_mma.cuh): 2K int8
// operations a pair on the tensor cores, then eight to forty instructions
// of key and argmax a pair, not memory.  What the split adds is
// parallelism: K1 gives a range tile one block, so a search with few range
// tiles (the quadtree's fine levels, small planes) leaves most SMs idle,
// while here the wrapper picks `width` on the device from the columns the
// tiles search, so that the work items give the card a few blocks per SM:
// on a large plane that is one split a segment.  The partials cost 9 bytes
// per row of a work item.  The split kernel reads nothing per tile after
// its scan: a per-tile slot read there made the 8192^2 scan about 4% slower
// on an H100 (nvcc allocates the loop's registers differently); its work
// item, one 16-byte load, is read before it.  With the frontier a split
// cannot see that an earlier one hit, so it scans on; its block still stops
// once all its rows have hit within the split.

#include "search_mma.cuh"

namespace {

using namespace fe;

// The number of splits of class c's segment (0 for an empty one).
__device__ __forceinline__ int splits_of(int cls, const int* __restrict__ col_tile_start,
                                         const int* __restrict__ col_end, int block_m,
                                         int width) {
  const long long seg = static_cast<long long>(col_end[cls]) -
                        static_cast<long long>(col_tile_start[cls]) * block_m;
  return seg > 0 ? static_cast<int>((seg + width - 1) / width) : 0;
}

template <int K, int M, int G, bool Frontier>
__global__ void __launch_bounds__(mma::kThreads<K>)
search_classed2d_kernel(const int* __restrict__ ai,            // [r_pad] rows of K int8
                        const signed char* __restrict__ ch,    // [m_pad] rows of K int8
                        const signed char* __restrict__ cl,    // [m_pad] rows of K int8
                        const float* __restrict__ sb,          // [m_pad] SumB
                        const void* __restrict__ aux,          // [m_pad] as in K1
                        const int* __restrict__ n_work,          // [1] work items
                        const int4* __restrict__ work,           // [items] see above
                        const int* __restrict__ row_end,         // [nc]
                        int block_r, KeyParams p,
                        float* __restrict__ part_q,       // [items * block_r]
                        int* __restrict__ part_idx,       // [items * block_r]
                        unsigned char* __restrict__ part_hit) {  // [items * block_r]
  extern __shared__ int4 smem[];
  auto& sm = *reinterpret_cast<mma::Smem<K, M, false, Frontier, G>*>(smem);
  if (static_cast<int>(blockIdx.x) >= *n_work) return;  // block-uniform
  const int4 w = work[blockIdx.x];
  const int tile = w.x;
  const int cls = w.y;
  const int slice = blockIdx.y * mma::kBlockRows;  // the block's first row in the tile
  const long long row0 = static_cast<long long>(tile) * block_r + slice;
  const int n_load = min(mma::kBlockRows, block_r - slice);
  const int n_active = Frontier ? static_cast<int>(max(0LL, min(static_cast<long long>(n_load),
                                                                row_end[cls] - row0)))
                                : n_load;
  const int start = w.z;
  const int end = w.w;
  const long long at0 = static_cast<long long>(blockIdx.x) * block_r + slice;
  mma::search_rows<K, M, false, Frontier, mma::Policy::Argmax, false, G>(
      sm, ai, row0, n_load, n_active, nullptr, ch, cl, sb, aux, nullptr, start, end, p,
      [&](int local, float q, int idx, bool hit) {
        part_q[at0 + local] = q;
        part_idx[at0 + local] = idx;
        part_hit[at0 + local] = hit;
      });
}

__global__ void classed2d_reduce_kernel(const float* __restrict__ part_q,
                                        const int* __restrict__ part_idx,
                                        const unsigned char* __restrict__ part_hit,
                                        const int* __restrict__ first,
                                        const int* __restrict__ tile_class,
                                        const int* __restrict__ col_tile_start,
                                        const int* __restrict__ col_end,
                                        const int* __restrict__ width_p, int block_r,
                                        int block_m, long long r_pad,
                                        float* __restrict__ q_out, int* __restrict__ idx_out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= r_pad) return;
  const long long tile = row / block_r;
  const long long local = row - tile * block_r;
  const int n = splits_of(tile_class[tile], col_tile_start, col_end, block_m, *width_p);
  const long long at0 = n > 0 ? (long long)first[tile] * block_r + local : 0;
  float best_q = kInitQ;  // a row with no columns: the TPU kernel's initial value
  int best_idx = 0;
  for (int z = 0; z < n; ++z) {
    const long long at = at0 + (long long)z * block_r;
    const float q = part_q[at];
    if (q > best_q) {  // strict: the lower split, so the lower column, wins a tie
      best_q = q;
      best_idx = part_idx[at];
    }
    if (part_hit[at]) break;  // the row's frontier lies in split z
  }
  q_out[row] = best_q;
  idx_out[row] = best_idx;
}

constexpr int kReduceThreads = 256;

template <int K, int M, int G, bool Frontier>
int launch(const void* ai, const void* ch, const void* cl, const void* sb,
           const void* aux, const void* tile_class, const void* col_tile_start,
           const void* col_end, const void* row_end, int nrt, int block_r, int block_m,
           int items, const KeyParams& p, const void* width, const void* n_work,
           const void* work, const void* first, void* part_q, void* part_idx,
           void* part_hit, void* q_out, void* idx_out, void* stream) {
  if (const int err = mma::check_geometry<K, G>(p)) return err;
  if (nrt <= 0 || block_r <= 0) return 0;
  if (items <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long r_pad = static_cast<long long>(nrt) * block_r;
  const auto kernel = search_classed2d_kernel<K, M, G, Frontier>;
  constexpr size_t smem = sizeof(mma::Smem<K, M, false, Frontier, G>);
  if (const int err = mma::allow_smem(kernel, smem)) return err;
  const dim3 grid(items, (block_r + mma::kBlockRows - 1) / mma::kBlockRows);
  kernel<<<grid, mma::kThreads<K>, smem, st>>>(
      static_cast<const int*>(ai), static_cast<const signed char*>(ch),
      static_cast<const signed char*>(cl), static_cast<const float*>(sb), aux,
      static_cast<const int*>(n_work), static_cast<const int4*>(work),
      static_cast<const int*>(row_end), block_r, p, static_cast<float*>(part_q),
      static_cast<int*>(part_idx), static_cast<unsigned char*>(part_hit));
  if (const cudaError_t err = cudaGetLastError(); err != cudaSuccess)
    return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((r_pad + kReduceThreads - 1) / kReduceThreads);
  classed2d_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      static_cast<const float*>(part_q), static_cast<const int*>(part_idx),
      static_cast<const unsigned char*>(part_hit), static_cast<const int*>(first),
      static_cast<const int*>(tile_class), static_cast<const int*>(col_tile_start),
      static_cast<const int*>(col_end), static_cast<const int*>(width), block_r, block_m,
      r_pad, static_cast<float*>(q_out), static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Two entry points per (key, K), `fe_search_classed2d_<key><K>` and its `_thr`
// form with the frontier, all with one signature: K1's arguments, then the
// grid's work items (a bound on the (range tile, split) pairs); after the
// key arguments, on the device: the split width ([1] i32, columns, a
// multiple of t_n with the frontier), the number of work items ([1] i32),
// the work items in order ([items, 4] i32: tile, class, first and end
// column; rows from that number on are not read), each tile's first work
// item ([nrt] i32, read for tiles with columns only) and the partials'
// buffers ([items * block_r] f32, i32 and u8), then the outputs.  The padded instances (`<key><K>p`)
// and the K-slab form (`<key>_slab`) take n and the row width kp after t_n,
// as K1's.  Each launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success).
#define FE_SEARCH_CLASSED2D_HEAD                                                             \
  const void *ai, const void *ch, const void *cl, const void *sb, const void *aux,           \
      const void *tile_class, const void *col_tile_start, const void *col_end,               \
      const void *row_end, int nrt, int block_r, int block_m, int items, const void *sa,     \
      const void *sa2, float s_max, float inv_n, float inv_norm, int so_reference,           \
      float threshold, float dist_scale, int t_n
#define FE_SEARCH_CLASSED2D_TAIL                                                             \
  const void *width, const void *n_work, const void *work, const void *first, void *part_q, \
      void *part_idx, void *part_hit, void *q_out, void *idx_out, void *stream
#define FE_SEARCH_CLASSED2D_CALL(MODE, K, G, FRONTIER, N, KP)                                 \
  const fe::KeyParams p{static_cast<const float*>(sa),                                       \
                        static_cast<const float*>(sa2), s_max, inv_n, inv_norm,              \
                        so_reference, threshold, dist_scale, t_n, N, KP};                    \
  return launch<K, MODE, G, FRONTIER>(ai, ch, cl, sb, aux, tile_class, col_tile_start,       \
                                      col_end, row_end, nrt, block_r, block_m, items, p,     \
                                      width, n_work, work, first, part_q, part_idx,          \
                                      part_hit, q_out, idx_out, stream)
#define FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, K, SUFFIX, FRONTIER)                           \
  extern "C" int fe_search_classed2d_##NAME##K##SUFFIX(FE_SEARCH_CLASSED2D_HEAD,             \
                                                       FE_SEARCH_CLASSED2D_TAIL) {           \
    FE_SEARCH_CLASSED2D_CALL(MODE, K, fe::kFixed, FRONTIER, K, K);                           \
  }
#define FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, TAG, K, G, SUFFIX, FRONTIER)              \
  extern "C" int fe_search_classed2d_##NAME##TAG##SUFFIX(FE_SEARCH_CLASSED2D_HEAD, int n,    \
                                                         int kp, FE_SEARCH_CLASSED2D_TAIL) { \
    FE_SEARCH_CLASSED2D_CALL(MODE, K, G, FRONTIER, n, kp);                                   \
  }
#define FE_SEARCH_CLASSED2D_ENTRIES(NAME, MODE)                                              \
  FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, 16, , false)                                         \
  FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, 16, _thr, true)                                      \
  FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, 64, , false)                                         \
  FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, 64, _thr, true)                                      \
  FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, 256, , false)                                        \
  FE_SEARCH_CLASSED2D_ENTRY(NAME, MODE, 256, _thr, true)                                     \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, 16p, 16, fe::kPadded, , false)                  \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, 16p, 16, fe::kPadded, _thr, true)               \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, 64p, 64, fe::kPadded, , false)                  \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, 64p, 64, fe::kPadded, _thr, true)               \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, 256p, 256, fe::kPadded, , false)                \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, 256p, 256, fe::kPadded, _thr, true)             \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, _slab, 256, fe::kSlab, , false)                 \
  FE_SEARCH_CLASSED2D_WIDE_ENTRY(NAME, MODE, _slab, 256, fe::kSlab, _thr, true)

FE_SEARCH_CLASSED2D_ENTRIES(ls, fe::kLs)
FE_SEARCH_CLASSED2D_ENTRIES(raw, fe::kRaw)
FE_SEARCH_CLASSED2D_ENTRIES(general, fe::kGeneral)
