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
// where tile_q is strictly above its current q.  The keys are
// search_common.cuh's 'ls' key (rank_key), bit for bit the plain version's
// (`_rank_ls_int8`); sb4 = (int)(4 sb) truncates toward zero, as the plain
// version's int32 cast does, for any sb.
//
// The TPU walks the list in order on one core, carrying each row's best in
// its output block from one step to the next.  Blocks here run in no order,
// so the carry becomes a second pass:
//   * the step kernel, grid (list position p, 128-row slice of the tile):
//     the block decodes word p itself (nothing is read back to the host),
//     streams the column tile through shared memory in chunks of 512
//     columns, and one thread per row scans them (load_row and rank_key of
//     search_common.cuh, as in K1), keeping the variant's tile best; it
//     writes the row's partial (tile_q, tile_arg) at [p, row in tile].  At
//     the script's shapes a list of 512 steps gives 2,048 blocks, so the
//     card is full from one repetition of the list on;
//   * the reduce kernel, one thread per row of R: it walks the list in order
//     (staged in shared memory), restarts at each `first` of its tile and
//     takes each partial of its tile with a strict '>'.
// An out-of-range word (rt or ct beyond the operands) names no tile: the step
// block returns and the reduce skips it, as the plain version does.
//
// What bounds it on the card: arithmetic issue.  A pair costs 8 dp4a and,
// for the key, about ten integer and float operations; a column tile (4096
// columns, 160 KB with its sums) is reused by the tile's 512 rows, and the
// script's 10.6 MB of operands stay in the 50 MB L2.  The bound the smoke
// script states is the int8 tensor-core rate (2 K operations per pair); this
// first kernel runs on the dp4a path, as K1 does, so it sits far from it.
//
// K5's layout: ch and cl as [16, M] int8.  The kernel reads it itself: a
// thread loads, for 4 adjacent columns, one 32-bit word from each of the 16
// rows (a warp reads 128 adjacent bytes of a row at a time), transposes the
// 4 x 4 byte blocks with __byte_perm into the columns' 16-byte words, and
// stores them in the row layout's shared chunk, so the scan is K4 'full''s.

#include <climits>

#include "search_common.cuh"

namespace {

using namespace fe;

enum Variant : int { kFull = 0, kNoArgPass = 1, kPacked = 2, kMatmul = 3 };

constexpr int kK = 16;
constexpr int kRtShift = 14;   // 2 + CT_BITS (ops/matcher_kernels.py)
constexpr int kCtMask = 4095;  // CT_BITS = 12
constexpr int kCols = kChunkCols<kK>;  // columns staged per pass
constexpr int kReduceThreads = 128;
constexpr int kReduceWords = 1024;  // list words staged per pass of the reduce

using StepChunk = Chunk<kK, kLs, false>;

// Columns 4g..4g+3 of a [16, m] int8 operand from its 16 rows' words
// w[k] (bytes: columns 4g..4g+3 of row k): the four columns' 16-byte words,
// byte k of column j being w[k]'s byte j.
__device__ __forceinline__ void transpose_4cols(const int (&w)[kK], int4 (&col)[4]) {
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

// Stages one operand's columns [c0, c0 + n) into dst (a 16-byte word per
// column): from the row layout a copy, from the [16, m] layout (Transposed)
// 4 columns per thread through transpose_4cols.  c0 and n are multiples of 4.
template <bool Transposed>
__device__ __forceinline__ void stage_operand(int4* __restrict__ dst, const void* __restrict__ src,
                                              long long m, long long c0, int n) {
  if constexpr (!Transposed) {
    const int4* __restrict__ s = static_cast<const int4*>(src);
    for (int j = threadIdx.x; j < n; j += kRows) dst[j] = s[c0 + j];
  } else {
    const int* __restrict__ s = static_cast<const int*>(src);
    const long long row_words = m / 4;
    for (int g = threadIdx.x; g < n / 4; g += kRows) {
      int w[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) w[k] = s[k * row_words + c0 / 4 + g];
      int4 col[4];
      transpose_4cols(w, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[4 * g + j] = col[j];
    }
  }
}

template <int V, bool Transposed>
__global__ void __launch_bounds__(kRows)
micro_step_kernel(const int* __restrict__ pairs,  // [>= n_pairs] packed words
                  const int4* __restrict__ ai,    // [n_rt * block_r] rows of 16 int8
                  const void* __restrict__ ch,    // [m, 16] or (Transposed) [16, m] int8
                  const void* __restrict__ cl,    // as ch
                  const float* __restrict__ sb,   // [m] SumB
                  const float* __restrict__ aux,  // [m] inv_var_b
                  int n_rt, int n_ct, int block_r, int block_m,
                  float* __restrict__ part_q,     // [n_pairs, block_r]
                  int* __restrict__ part_idx) {   // [n_pairs, block_r]
  static_assert(!Transposed || V == kFull, "K5 is the 'full' step");
  __shared__ StepChunk s;
  const int p = blockIdx.x;
  const int word = pairs[p];
  const int rt = word >> kRtShift;
  const int ct = (word >> 2) & kCtMask;
  if (rt < 0 || rt >= n_rt || ct >= n_ct) return;  // names no tile (block-uniform)
  const int local = blockIdx.y * kRows + threadIdx.x;
  const bool active = local < block_r;
  const long long row = static_cast<long long>(rt) * block_r + local;
  const KeyParams kp{};  // the 'ls' key reads no per-call inputs
  const Row<kK> r = load_row<kK, kLs, false>(ai, row, active, kp);
  const long long m = static_cast<long long>(n_ct) * block_m;
  const long long col0 = static_cast<long long>(ct) * block_m;
  float best_q = kInitQ;
  int best_idx = 0;
  int best_key = INT_MIN;  // 'packed'
  for (int t0 = 0; t0 < block_m; t0 += kCols) {
    const int n = min(kCols, block_m - t0);
    const long long c0 = col0 + t0;
    __syncthreads();  // the previous chunk is no longer being read
    stage_operand<Transposed>(s.ch, ch, m, c0, n);
    stage_operand<Transposed>(s.cl, cl, m, c0, n);
    if constexpr (V != kMatmul) {
      for (int j = threadIdx.x; j < n; j += kRows) {
        s.sb4[j] = static_cast<int>(4.0f * sb[c0 + j]);  // truncates toward zero
        s.aux[j] = aux[c0 + j] * 0.0625f;                // exact: power-of-two scale
      }
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int4 h = s.ch[j];
      const int4 l = s.cl[j];
      int dh = __dp4a(r.a[0].x, h.x, 0);
      int dh2 = __dp4a(r.a[0].y, h.y, 0);
      int dl = __dp4a(r.a[0].x, l.x, 0);
      int dl2 = __dp4a(r.a[0].y, l.y, 0);
      dh = __dp4a(r.a[0].z, h.z, dh);
      dh2 = __dp4a(r.a[0].w, h.w, dh2);
      dl = __dp4a(r.a[0].z, l.z, dl);
      dl2 = __dp4a(r.a[0].w, l.w, dl2);
      const int dot = 8 * (dh + dh2) + (dl + dl2);
      if constexpr (V == kMatmul) {
        best_q = fmaxf(best_q, __int2float_rn(dot));  // exact: |dot| < 2^24
      } else {
        const float q = rank_key<kK, kLs, false>(dot, j, s, r, kp);
        if constexpr (V == kFull) {
          if (q > best_q) {  // strict: the lowest column of the max wins
            best_q = q;
            best_idx = static_cast<int>(c0) + j;
          }
        } else if constexpr (V == kNoArgPass) {
          best_q = fmaxf(best_q, q);
        } else {  // kPacked: the lane in the low 12 bits, the lowest lane the largest
          best_key = max(best_key, (__float_as_int(q) & ~4095) | (4095 - (t0 + j)));
        }
      }
    }
  }
  if (!active) return;
  if constexpr (V == kPacked) {
    best_q = __int_as_float(best_key & ~4095);
    best_idx = 4095 - (best_key & 4095) + static_cast<int>(col0);
  } else if constexpr (V != kFull) {
    best_idx = static_cast<int>(col0);  // 'noargpass', 'matmul': the tile's first column
  }
  const long long at = static_cast<long long>(p) * block_r + local;
  part_q[at] = best_q;
  part_idx[at] = best_idx;
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

template <int V, bool Transposed>
int launch(const void* pairs, int n_pairs, const void* ai, const void* ch, const void* cl,
           const void* sb, const void* aux, int n_rt, int n_ct, int block_r, int block_m,
           void* part_q, void* part_idx, void* q_out, void* idx_out, void* stream) {
  if (n_pairs < 0 || n_rt < 0 || n_ct < 0 || block_r <= 0 || block_m <= 0 || block_m % 4 ||
      (V == kPacked && block_m > 4096))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_rt) * block_r;
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pairs > 0 && n_ct > 0) {
    const dim3 grid(n_pairs, (block_r + kRows - 1) / kRows);
    micro_step_kernel<V, Transposed><<<grid, kRows, 0, st>>>(
        static_cast<const int*>(pairs), static_cast<const int4*>(ai), ch, cl,
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
#define FE_MICRO_STEP_ENTRY(NAME, V, TRANSPOSED)                                              \
  extern "C" int fe_micro_step_##NAME(                                                       \
      const void* pairs, int n_pairs, const void* ai, const void* ch, const void* cl,        \
      const void* sb, const void* aux, int n_rt, int n_ct, int block_r, int block_m,         \
      void* part_q, void* part_idx, void* q_out, void* idx_out, void* stream) {              \
    return launch<V, TRANSPOSED>(pairs, n_pairs, ai, ch, cl, sb, aux, n_rt, n_ct, block_r,   \
                                 block_m, part_q, part_idx, q_out, idx_out, stream);         \
  }

FE_MICRO_STEP_ENTRY(full, kFull, false)
FE_MICRO_STEP_ENTRY(noargpass, kNoArgPass, false)
FE_MICRO_STEP_ENTRY(packed, kPacked, false)
FE_MICRO_STEP_ENTRY(matmul, kMatmul, false)
FE_MICRO_STEP_ENTRY(full_t, kFull, true)
