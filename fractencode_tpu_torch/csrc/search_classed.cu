// Class-blocked all-pairs search, rank key 'ls' with int8 operands, for
// K = 16, 64 and 256 (4x4, 8x8 and 16x16 range blocks).
//
// Replaces the TPU kernel `_pairs_kernel` (fractencode_tpu/ops/matcher_pallas.py,
// reached through `fused_search_pairs`): its `ls_fast` int8 branch at K = 16
// and 64, and its f32 branch (`_pair_ab_f32` + `_rank_tile`, 'ls' key) at
// K = 256.  For each class-sorted range row r, with class
// c = tile_class[r / block_r], it returns the first-occurrence argmax over the
// columns [col_tile_start[c] * block_m, col_end[c]) of
//
//     q = f32(cov4)^2 * (aux / 16),   cov4 = n * dot + (128 n - SumA) * sb4,
//     dot = sum_k ai[r,k] * (8 ch[j,k] + cl[j,k]),   SumA = rowsum(ai) + 128 n,
//     sb4 = (int)(4 sb[j]),
//
// bit for bit against the plain version: every integer is exact and the float
// operations are single IEEE roundings (no fast-math, no contraction: there is
// no add).  cov4 is an int32 for K <= 64, as in the TPU kernel; at K = 256 it
// reaches ~9e9 and is formed in int64, then rounded once to f32.  That is the
// port's exact-integer rule for K = 256, where the TPU kernel computes the key
// in f32 (ROADMAP.md, parity contract).  The int8 operands serve K = 256 too:
// 4B <= 1020 keeps ch = 4B >> 3 <= 127, and |dot| <= 256 * 128 * 1020 < 2^31.
// A row whose class has no columns gets q = -3e38, idx = 0, the TPU kernel's
// initial value.
//
// What bounds it on the card: arithmetic issue, not memory.  Each (row,
// column) pair costs K/2 dp4a plus about a dozen integer and float operations,
// while a column is 2K + 8 bytes that every row of the class reuses.  The
// design gives one thread one range row (its K int8 values stay in K/4
// registers: 4, 16 or 64) and one block of threads one slice of a range tile,
// so all rows of a block share the class segment.  The block streams that
// segment through shared memory in chunks; every thread reads the same column
// at once, which shared memory serves as a broadcast.  Each thread scans its
// columns in ascending order and keeps the best with a strict '>', so the
// first occurrence wins exactly as in the TPU kernel's min-index-of-max, and
// no reduction across threads is needed.  The dot runs on two accumulators
// per operand so consecutive dp4a do not wait on each other.  Tensor-core
// (mma s8) tiling is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;      // threads per block, one range row each
constexpr float kInitQ = -3.0e38f;

// Columns staged in shared memory per pass: 2K + 8 bytes each, kept under the
// 48 KB of static shared memory (20 KB at K = 16, 34 KB at 64 and 256).
template <int K>
constexpr int kChunkCols = K == 16 ? 512 : (K == 64 ? 256 : 64);

template <int K>
__global__ void __launch_bounds__(kRows)
search_classed_ls_kernel(const int4* __restrict__ ai,      // [r_pad] rows of K int8
                         const int4* __restrict__ ch,      // [m_pad] rows of K int8
                         const int4* __restrict__ cl,      // [m_pad] rows of K int8
                         const float* __restrict__ sb,     // [m_pad] SumB
                         const float* __restrict__ aux,    // [m_pad] inv_var_b
                         const int* __restrict__ tile_class,      // [nrt]
                         const int* __restrict__ col_tile_start,  // [nc]
                         const int* __restrict__ col_end,         // [nc]
                         int block_r, int block_m,
                         float* __restrict__ q_out,        // [r_pad]
                         int* __restrict__ idx_out) {      // [r_pad]
  constexpr int kW = K / 16;  // int4 words per row
  constexpr int kChunk = kChunkCols<K>;
  __shared__ int4 s_ch[kChunk * kW];
  __shared__ int4 s_cl[kChunk * kW];
  __shared__ int s_sb4[kChunk];
  __shared__ float s_aux16[kChunk];

  const int tile = blockIdx.x;
  const int local = blockIdx.y * kRows + threadIdx.x;
  const bool active = local < block_r;
  const long long row = (long long)tile * block_r + local;
  const int cls = tile_class[tile];
  const int start = col_tile_start[cls] * block_m;
  const int end = col_end[cls];

  int4 a[kW];
  // SumA = rowsum(ai) + 128 n; dp4a against 0x01010101 sums the signed bytes
  int rowsum = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    a[w] = active ? ai[row * kW + w] : make_int4(0, 0, 0, 0);
    rowsum = __dp4a(a[w].x, 0x01010101, rowsum);
    rowsum = __dp4a(a[w].y, 0x01010101, rowsum);
    rowsum = __dp4a(a[w].z, 0x01010101, rowsum);
    rowsum = __dp4a(a[w].w, 0x01010101, rowsum);
  }
  const int sum_a = rowsum + 128 * K;
  const int base = 128 * K - sum_a;

  float best_q = kInitQ;
  int best_idx = 0;
  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n_cols = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = threadIdx.x; j < n_cols * kW; j += kRows) {
      s_ch[j] = ch[(long long)c0 * kW + j];
      s_cl[j] = cl[(long long)c0 * kW + j];
    }
    for (int j = threadIdx.x; j < n_cols; j += kRows) {
      s_sb4[j] = (int)(4.0f * sb[c0 + j]);  // exact: sb is a multiple of 0.25 below 2^22
      s_aux16[j] = aux[c0 + j] * 0.0625f;   // exact: power-of-two scale
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n_cols; ++j) {
        int dh[2] = {0, 0};
        int dl[2] = {0, 0};
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          const int4 h = s_ch[j * kW + w];
          const int4 l = s_cl[j * kW + w];
          int& eh = dh[w & 1];
          int& el = dl[w & 1];
          eh = __dp4a(a[w].x, h.x, eh);
          eh = __dp4a(a[w].y, h.y, eh);
          eh = __dp4a(a[w].z, h.z, eh);
          eh = __dp4a(a[w].w, h.w, eh);
          el = __dp4a(a[w].x, l.x, el);
          el = __dp4a(a[w].y, l.y, el);
          el = __dp4a(a[w].z, l.z, el);
          el = __dp4a(a[w].w, l.w, el);
        }
        const int dot = 8 * (dh[0] + dh[1]) + (dl[0] + dl[1]);
        float c;
        if constexpr (K <= 64) {
          c = __int2float_rn(K * dot + base * s_sb4[j]);
        } else {
          c = __ll2float_rn((long long)K * dot + (long long)base * s_sb4[j]);
        }
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

template <int K>
int launch(const void* ai, const void* ch, const void* cl, const void* sb,
           const void* aux, const void* tile_class, const void* col_tile_start,
           const void* col_end, int nrt, int block_r, int block_m, void* q_out,
           void* idx_out, void* stream) {
  if (nrt <= 0 || block_r <= 0) return 0;
  const dim3 grid(nrt, (block_r + kRows - 1) / kRows);
  search_classed_ls_kernel<K><<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(ai), static_cast<const int4*>(ch),
      static_cast<const int4*>(cl), static_cast<const float*>(sb),
      static_cast<const float*>(aux), static_cast<const int*>(tile_class),
      static_cast<const int*>(col_tile_start), static_cast<const int*>(col_end),
      block_r, block_m, static_cast<float*>(q_out), static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per K.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
#define FE_SEARCH_CLASSED_ENTRY(K)                                                   \
  extern "C" int fe_search_classed_ls##K(                                            \
      const void* ai, const void* ch, const void* cl, const void* sb,                \
      const void* aux, const void* tile_class, const void* col_tile_start,           \
      const void* col_end, int nrt, int block_r, int block_m, void* q_out,           \
      void* idx_out, void* stream) {                                                 \
    return launch<K>(ai, ch, cl, sb, aux, tile_class, col_tile_start, col_end, nrt,  \
                     block_r, block_m, q_out, idx_out, stream);                      \
  }

FE_SEARCH_CLASSED_ENTRY(16)
FE_SEARCH_CLASSED_ENTRY(64)
FE_SEARCH_CLASSED_ENTRY(256)
