// Class-blocked all-pairs search, rank key 'ls' with int8 operands, K = 16.
//
// Replaces the TPU kernel `_pairs_kernel` (fractencode_tpu/ops/matcher_pallas.py,
// reached through `fused_search_pairs`) on its `ls_fast` int8 branch.  For each
// class-sorted range row r, with class c = tile_class[r / block_r], it returns
// the first-occurrence argmax over the columns
// [col_tile_start[c] * block_m, col_end[c]) of
//
//     q = f32(cov4)^2 * (aux / 16),   cov4 = n * dot + (128 n - SumA) * sb4,
//     dot = sum_k ai[r,k] * (8 ch[j,k] + cl[j,k]),   SumA = rowsum(ai) + 128 n,
//     sb4 = (int)(4 sb[j]),
//
// bit for bit: every integer is exact in int32 and the two float products
// are single IEEE roundings (no fast-math, no contraction: there is no add).
// A row whose class has no columns gets q = -3e38, idx = 0, the TPU kernel's
// initial value.
//
// What bounds it on the card: arithmetic issue, not memory.  Each (row,
// column) pair costs 8 dp4a plus about a dozen integer and float operations,
// while a column is 40 bytes that every row of the class reuses.  The design
// gives one thread one range row (its 16 int8 values stay in 4 registers) and
// one block of threads one slice of a range tile, so all rows of a block share
// the class segment.  The block streams that segment through shared memory in
// chunks; every thread reads the same column at once, which shared memory
// serves as a broadcast.  Each thread scans its columns in ascending order and
// keeps the best with a strict '>', so the first occurrence wins exactly as in
// the TPU kernel's min-index-of-max, and no reduction across threads is needed.
// Tensor-core (mma s8) tiling is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 16;          // contraction length (4x4 range blocks)
constexpr int kRows = 128;      // threads per block, one range row each
constexpr int kChunk = 512;     // columns staged in shared memory per pass
constexpr float kInitQ = -3.0e38f;

__global__ void __launch_bounds__(kRows)
search_classed_ls16_kernel(const int4* __restrict__ ai,      // [r_pad] rows of 16 int8
                           const int4* __restrict__ ch,      // [m_pad] rows of 16 int8
                           const int4* __restrict__ cl,      // [m_pad] rows of 16 int8
                           const float* __restrict__ sb,     // [m_pad] SumB
                           const float* __restrict__ aux,    // [m_pad] inv_var_b
                           const int* __restrict__ tile_class,      // [nrt]
                           const int* __restrict__ col_tile_start,  // [nc]
                           const int* __restrict__ col_end,         // [nc]
                           int block_r, int block_m,
                           float* __restrict__ q_out,        // [r_pad]
                           int* __restrict__ idx_out) {      // [r_pad]
  __shared__ int4 s_ch[kChunk];
  __shared__ int4 s_cl[kChunk];
  __shared__ int s_sb4[kChunk];
  __shared__ float s_aux16[kChunk];

  const int tile = blockIdx.x;
  const int local = blockIdx.y * kRows + threadIdx.x;
  const bool active = local < block_r;
  const long long row = (long long)tile * block_r + local;
  const int cls = tile_class[tile];
  const int start = col_tile_start[cls] * block_m;
  const int end = col_end[cls];

  int4 a = make_int4(0, 0, 0, 0);
  if (active) a = ai[row];
  // SumA = rowsum(ai) + 128 n; dp4a against 0x01010101 sums the signed bytes
  int rowsum = __dp4a(a.x, 0x01010101, 0);
  rowsum = __dp4a(a.y, 0x01010101, rowsum);
  rowsum = __dp4a(a.z, 0x01010101, rowsum);
  rowsum = __dp4a(a.w, 0x01010101, rowsum);
  const int sum_a = rowsum + 128 * kK;
  const int base = 128 * kK - sum_a;

  float best_q = kInitQ;
  int best_idx = 0;
  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n_cols = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = threadIdx.x; j < n_cols; j += kRows) {
      s_ch[j] = ch[c0 + j];
      s_cl[j] = cl[c0 + j];
      s_sb4[j] = (int)(4.0f * sb[c0 + j]);  // exact: sb is a multiple of 0.25
      s_aux16[j] = aux[c0 + j] * 0.0625f;   // exact: power-of-two scale
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n_cols; ++j) {
        const int4 h = s_ch[j];
        const int4 l = s_cl[j];
        int dh = __dp4a(a.x, h.x, 0);
        dh = __dp4a(a.y, h.y, dh);
        dh = __dp4a(a.z, h.z, dh);
        dh = __dp4a(a.w, h.w, dh);
        int dl = __dp4a(a.x, l.x, 0);
        dl = __dp4a(a.y, l.y, dl);
        dl = __dp4a(a.z, l.z, dl);
        dl = __dp4a(a.w, l.w, dl);
        const int cov4 = kK * (8 * dh + dl) + base * s_sb4[j];
        const float c = __int2float_rn(cov4);
        const float q = __fmul_rn(__fmul_rn(c, c), s_aux16[j]);
        if (q > best_q) {  // strict: the first occurrence of the max wins
          best_q = q;
          best_idx = c0 + j;
        }
      }
    }
  }
  if (active) {
    q_out[row] = best_q;
    idx_out[row] = best_idx;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fe_search_classed_ls16(const void* ai, const void* ch, const void* cl,
                                      const void* sb, const void* aux,
                                      const void* tile_class, const void* col_tile_start,
                                      const void* col_end, int nrt, int block_r,
                                      int block_m, void* q_out, void* idx_out,
                                      void* stream) {
  if (nrt <= 0 || block_r <= 0) return 0;
  const dim3 grid(nrt, (block_r + kRows - 1) / kRows);
  search_classed_ls16_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(ai), static_cast<const int4*>(ch),
      static_cast<const int4*>(cl), static_cast<const float*>(sb),
      static_cast<const float*>(aux), static_cast<const int*>(tile_class),
      static_cast<const int*>(col_tile_start), static_cast<const int*>(col_end),
      block_r, block_m, static_cast<float*>(q_out), static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}
