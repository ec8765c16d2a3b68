// The pair-list step microbenchmark's kernels (K4 and K5): one step of K1's
// 'ls' search at K = 16 over a packed pair list, with parts removed, in five
// instances: 'full', 'noargpass', 'packed' and 'matmul' with ch and cl in the
// row layout [M, 16], and 'full' with them stored as [16, M] ('full_t').
//
// Replaces the TPU kernels `kernel` (through `run`, K4) and `kernel_t`
// (through `run_t`, K5) of scripts/micro_kernel.py.  The function, one
// definition for this kernel and its plain version, is in
// ops/micro_kernels.py: the first n_pairs words are folded in list order;
// a word rt << 14 | ct << 2 | first << 1 | compute takes the rows of range
// tile rt against the columns of column tile ct; `first` resets the tile's
// rows to (-3e38, 0) first; a row takes the step's (tile_q, tile_arg) only
// where tile_q is strictly above its current q.  The keys are bit for bit
// the plain version's (`_rank_ls_int8`); sb4 = (int)(4 sb) truncates toward
// zero (stage_column), as the plain version's int32 cast does, for any sb.
//
// The TPU walks the list in order on one core, carrying each row's best in
// its output block from one step to the next.  Blocks here run in no order,
// so the carry becomes a second pass:
//   * the step kernel, grid (list position p, 128-row slice of the tile):
//     the block decodes word p itself (nothing is read back to the host) and
//     runs K1's step on search_mma.cuh's tensor-core mainloop, the same
//     mma::search_rows call as search_classed.cu's over the column tile
//     [ct * block_m, (ct + 1) * block_m): s8 mma.sync products, chunks of
//     512 columns double-buffered by cp.async, fast_key, per-lane bests and
//     the quad merge.  The variants remove parts of that step (mma::Policy):
//     'full' and 'full_t' are K1's step instruction for instruction
//     (Argmax); 'noargpass' keeps the key and takes its max by fmaxf
//     (MaxOnly); 'packed' takes the one-pass int max of the packed key
//     (PackedMax); 'matmul' keeps the products and a max of f32(dot) read
//     off the accumulators (DotMax).  It writes each row's partial
//     (tile_q, tile_arg) at [p, row in tile].  At the script's shapes a list
//     of 512 steps gives 2,048 blocks, so the card is full from one
//     repetition of the list on;
//   * the reduce kernel, one thread per row of R: it walks the list in order
//     (staged in shared memory), restarts at each `first` of its tile and
//     takes each partial of its tile with a strict '>'.
// An out-of-range word (rt or ct beyond the operands) names no tile: the step
// block returns before any barrier and the reduce skips it, as the plain
// version does.
//
// fast_key's conditions hold for the script's draws (ai in [-128, 128), ch
// in [0, 128), cl in [0, 8), sb in [0, 100), aux in [0, 1)): |dot| <=
// 16 * 128 * 1023 < 2^21, so the accumulator read as a float is kMagic + dot
// and 16 dot is exact; |(128 n - SumA) sb4| <= 2048 * 399 is exact, and c is
// the one rounding of the exact cov4 (up to ~2^25 here), as __int2float_rn
// rounds it.  So every instance keeps fast_key; none needs rank_key.
//
// What bounds it on the card: the epilogue, as for K1.  A step is 2.1e6
// pairs of 32 int8 operations on the tensor cores (the smoke script's bound,
// 0.034 us a step at 1,979 TOP/s); the key ('ls' by fast_key: an integer
// multiply-add, two float multiply-adds and two multiplies) and the
// argmax's maximum, check and update cost some ten instructions a pair on
// the FP32 and integer pipes.  The variants take them apart: 'matmul' is
// the products' own step, 'noargpass' minus 'matmul' the key, 'full' minus
// 'noargpass' the argmax (PERF.md has the split measured on an H100).  A
// column tile (4096 columns, 160 KB with its sums) is reused by the tile's
// 512 rows, and the script's 10.6 MB of operands stay in the 50 MB L2.
//
// K5's layout: ch and cl as [16, M] int8.  mma.sync takes s8 operands only
// as .row.col and ldmatrix .trans moves 16-bit elements only, so [16, M]
// cannot feed the B fragments directly.  Each chunk is staged through
// registers instead of cp.async: a thread loads, for 4 adjacent columns, one
// 32-bit word from each of the 16 rows (a warp reads 128 adjacent bytes of a
// row at a time) before the previous chunk is searched, and after it
// transposes the 4 x 4 byte blocks with __byte_perm (mma::transpose_4cols)
// into the columns' 16-byte rows that ldmatrix reads.  Everything after
// staging is K4 'full''s.

#include "search_mma.cuh"

namespace {

using namespace fe;

using mma::Policy;  // a variant is its mainloop policy

constexpr int kK = 16;
constexpr int kRtShift = 14;   // 2 + CT_BITS (ops/matcher_kernels.py)
constexpr int kCtMask = 4095;  // CT_BITS = 12
constexpr int kReduceThreads = 128;
constexpr int kReduceWords = 1024;  // list words staged per pass of the reduce

using StepSmem = mma::Smem<kK, kLs, false, false>;

template <Policy Pol, bool Transposed>
__global__ void __launch_bounds__(mma::kThreads<kK>)
micro_step_kernel(const int* __restrict__ pairs,         // [>= n_pairs] packed words
                  const int* __restrict__ ai,            // [n_rt * block_r] rows of 16 int8
                  const signed char* __restrict__ ch,    // [m, 16] or (Transposed) [16, m] int8
                  const signed char* __restrict__ cl,    // as ch
                  const float* __restrict__ sb,          // [m] SumB
                  const float* __restrict__ aux,         // [m] inv_var_b
                  int n_rt, int n_ct, int block_r, int block_m,
                  float* __restrict__ part_q,            // [n_pairs, block_r]
                  int* __restrict__ part_idx) {          // [n_pairs, block_r]
  static_assert(!Transposed || Pol == Policy::Argmax, "K5 is the 'full' step");
  extern __shared__ int4 smem[];
  auto& sm = *reinterpret_cast<StepSmem*>(smem);
  const int p = blockIdx.x;
  const int word = pairs[p];
  const int rt = word >> kRtShift;
  const int ct = (word >> 2) & kCtMask;
  if (rt < 0 || rt >= n_rt || ct >= n_ct) return;  // names no tile (block-uniform)
  const int slice = blockIdx.y * mma::kBlockRows;  // the block's first row in the tile
  const long long row0 = static_cast<long long>(rt) * block_r + slice;
  const int n_load = min(mma::kBlockRows, block_r - slice);
  const int start = ct * block_m;
  float* __restrict__ q = part_q + static_cast<long long>(p) * block_r + slice;
  int* __restrict__ idx = part_idx + static_cast<long long>(p) * block_r + slice;
  mma::search_rows<kK, kLs, false, false, Pol, Transposed>(
      sm, ai, row0, n_load, n_load, nullptr, ch, cl, sb, aux, nullptr, start, start + block_m,
      KeyParams{}, [&](int local, float best_q, int best_idx, bool) {
        q[local] = best_q;
        idx[local] = best_idx;
      },
      static_cast<long long>(n_ct) * block_m);
}

__global__ void __launch_bounds__(kReduceThreads)
micro_reduce_kernel(const int* __restrict__ pairs, int n_pairs, int n_rt, int n_ct,
                    int block_r, const float* __restrict__ part_q,
                    const int* __restrict__ part_idx, float* __restrict__ q_out,
                    int* __restrict__ idx_out) {
  __shared__ int words[kReduceWords];
  const long long row = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const bool active = row < static_cast<long long>(n_rt) * block_r;
  const int rt = static_cast<int>(row / block_r);
  const int local = static_cast<int>(row - static_cast<long long>(rt) * block_r);
  float best_q = kInitQ;  // a row no word visits keeps the initial value
  int best_idx = 0;
  for (int p0 = 0; p0 < n_pairs; p0 += kReduceWords) {
    const int n = min(kReduceWords, n_pairs - p0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kReduceThreads) words[i] = pairs[p0 + i];
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const int w = words[i];
      if ((w >> kRtShift) != rt || ((w >> 2) & kCtMask) >= n_ct) continue;
      if ((w >> 1) & 1) {  // `first`: the tile's rows restart
        best_q = kInitQ;
        best_idx = 0;
      }
      const long long at = static_cast<long long>(p0 + i) * block_r + local;
      const float q = part_q[at];
      if (q > best_q) {  // strict: an equal later step never replaces an earlier one
        best_q = q;
        best_idx = part_idx[at];
      }
    }
  }
  if (active) {
    q_out[row] = best_q;
    idx_out[row] = best_idx;
  }
}

template <Policy Pol, bool Transposed>
int launch(const void* pairs, int n_pairs, const void* ai, const void* ch, const void* cl,
           const void* sb, const void* aux, int n_rt, int n_ct, int block_r, int block_m,
           void* part_q, void* part_idx, void* q_out, void* idx_out, void* stream) {
  if (n_pairs < 0 || n_rt < 0 || n_ct < 0 || block_r <= 0 || block_m <= 0 || block_m % 4 ||
      (Pol == Policy::PackedMax && block_m > 4096))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_rt) * block_r;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pairs > 0 && n_ct > 0) {
    const auto kernel = micro_step_kernel<Pol, Transposed>;
    constexpr size_t smem = sizeof(StepSmem);
    if (const int err = mma::allow_smem(kernel, smem)) return err;
    const dim3 grid(n_pairs, (block_r + mma::kBlockRows - 1) / mma::kBlockRows);
    kernel<<<grid, mma::kThreads<kK>, smem, st>>>(
        static_cast<const int*>(pairs), static_cast<const int*>(ai),
        static_cast<const signed char*>(ch), static_cast<const signed char*>(cl),
        static_cast<const float*>(sb), static_cast<const float*>(aux), n_rt, n_ct, block_r,
        block_m, static_cast<float*>(part_q), static_cast<int*>(part_idx));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((rows + kReduceThreads - 1) / kReduceThreads);
  micro_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      static_cast<const int*>(pairs), n_pairs, n_rt, n_ct, block_r,
      static_cast<const float*>(part_q), static_cast<const int*>(part_idx),
      static_cast<float*>(q_out), static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per instance, `fe_micro_step_<variant>`, all with one
// signature: the list and n_pairs; ai [n_rt * block_r, 16], ch and cl
// ([m, 16], or [16, m] for full_t), sb and aux [m], m = n_ct * block_m; the
// tile counts and sizes; the partials' buffers ([n_pairs, block_r] f32 and
// i32); the outputs ([n_rt * block_r] f32 and i32); the stream.  Each
// launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success).
#define FE_MICRO_STEP_ENTRY(NAME, POLICY, TRANSPOSED)                                        \
  extern "C" int fe_micro_step_##NAME(                                                       \
      const void* pairs, int n_pairs, const void* ai, const void* ch, const void* cl,        \
      const void* sb, const void* aux, int n_rt, int n_ct, int block_r, int block_m,         \
      void* part_q, void* part_idx, void* q_out, void* idx_out, void* stream) {              \
    return launch<POLICY, TRANSPOSED>(pairs, n_pairs, ai, ch, cl, sb, aux, n_rt, n_ct,       \
                                      block_r, block_m, part_q, part_idx, q_out, idx_out,    \
                                      stream);                                               \
  }

FE_MICRO_STEP_ENTRY(full, Policy::Argmax, false)
FE_MICRO_STEP_ENTRY(noargpass, Policy::MaxOnly, false)
FE_MICRO_STEP_ENTRY(packed, Policy::PackedMax, false)
FE_MICRO_STEP_ENTRY(matmul, Policy::DotMax, false)
FE_MICRO_STEP_ENTRY(full_t, Policy::Argmax, true)
