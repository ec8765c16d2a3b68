// The decoder step: one application of the whole map set, from the u8 image
// of one scale to the u8 image of the next step, in one pass.
//
// Replaces no TPU kernel: the JAX package's step
// (fractencode_tpu/decode/decoder.py:_decode_step) is a gather through static
// tap tables, s*v + o, a clamp, a floor and a reshape, which XLA lowers and
// fuses on its own.  The port ran it as about ten torch ops a step, each
// writing its result to memory: [H/2, W/2] i32 box sums, the [D, U] patch
// pool, the [D*T, K] isometry gather, the [R, K] row gather, its f32 copy, a
// float64 [R, K] product and sum, the f32 cast, clamp, floor and u8 cast, and
// a permute back to image layout.  This kernel writes none of them.
//
// For each output pixel it finds its range r and that range's (domain,
// isometry), reads the sample's 2x2 tap cell of u8 pixels straight from the
// image through the [8, K] table of cell corners (the min corner of the four
// taps of core/sampler.py's all_tap_tables, which are always the isometry
// image of an axis-aligned 2x2 cell), sums the taps as an integer and forms
// v = f32(sum) * 0.25 (exact).  With `mean` (the FTC1/FTQ1 files' mean-offset
// maps) it subtracts the range's sample mean, formed as the plain version
// and the JAX package form it: the exact sum of the K samples times f32(1/K)
// (XLA:CPU turns the JAX package's division by the constant K into that
// product).  Then s*v + o in float64, the product exact and one rounded add,
// rounded once to f32 (the fused multiply-add XLA:CPU emits), clamped to
// [0, 255], floored and stored as u8 in image layout: bitwise the plain torch
// step (decode/decoder.py's _decode_step_torch) for every table kind, every
// range size and every isometry count.  Measured on an H100 (700 W): 0.0234 ms
// a 2048^2 step, 0.0115 ms a 1024^2 one, ~6x their byte bounds below; the
// plain step took 0.4036 and 0.2331 ms.
//
// What bounds it on the card: bytes.  A step must read the u8 image and the
// maps (i32 domain, i32 isometry, f32 s and o: 16 B a range) and write the
// u8 image: at 2048^2 with 4x4 ranges ~12.6 MB, at 1024^2 with 2x2 ranges
// ~6.2 MB, ~3.8 us and ~1.9 us at 3.35 TB/s; the image and the maps of a
// frame fit in the 50 MB L2, so the true floor of a pyramid's 14 steps is
// lower still.  What the design does about it:
//  * a thread writes one row of one range (ts pixels) as whole words (a u32
//    at ts = 4, a u16 at ts = 2), and the threads of a warp hold neighbouring
//    ranges of one row (of two or more rows above ts = 8), so the maps' reads
//    and the image's stores coalesce;
//  * a block holds whole ranges (nb ranges x ts rows), so the mean of a
//    range is one exchange through shared memory, not a second pass;
//  * the [8, K] corner table sits in shared memory, its rows padded to an
//    odd stride so that the 8 isometries of a warp fall in distinct banks;
//  * a 2x2 tap cell is read as two u16 loads where it is 2-byte aligned (the
//    pyramid's cells always are) and as four bytes where not;
//  * nothing is staged: the image of the step before is read at random
//    domain positions from L2, where the frame's image and maps stay across
//    its steps.  That sets the pace: a thread's 2x2 cells fall on 32 B
//    sectors it shares with no neighbour, so the L2 moves several times the
//    bytes the bound counts.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// rows of the corner table: every isometry id a map may hold
constexpr int kTransforms = 8;
// threads a block aims at (a block holds nb = kThreads / ts whole ranges)
constexpr int kThreads = 256;

// The sum of the 2x2 cell of u8 taps whose min corner is img[c] (row stride w).
__device__ __forceinline__ int cell_sum(const uint8_t* __restrict__ img, int c, int w) {
  const uint8_t* p = img + c;
  if (((reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(w)) & 1) == 0) {
    const uint32_t a = __ldg(reinterpret_cast<const unsigned short*>(p));
    const uint32_t b = __ldg(reinterpret_cast<const unsigned short*>(p + w));
    return static_cast<int>((a & 0xff) + (a >> 8) + (b & 0xff) + (b >> 8));
  }
  return __ldg(p) + __ldg(p + 1) + __ldg(p + w) + __ldg(p + w + 1);
}

// floor(clip(s*v + o, 0, 255)) as a byte: s*v + o in float64 (the product
// is exact: v has at most 24 significant bits, s 24), rounded once to f32.
__device__ __forceinline__ uint32_t affine_u8(float s, float v, float o) {
  const double y = __dadd_rn(__dmul_rn(static_cast<double>(s), static_cast<double>(v)),
                             static_cast<double>(o));
  const float f = fminf(fmaxf(__double2float_rn(y), 0.0f), 255.0f);
  return static_cast<uint32_t>(floorf(f));
}

// Stores the n (1 to 4) low bytes of `word` at p, as one word where p is
// aligned for it.
__device__ __forceinline__ void put(uint8_t* p, uint32_t word, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == 4 && (a & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = word;
  } else if (n == 2 && (a & 1) == 0) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(word);
  } else {
    for (int b = 0; b < n; ++b) p[b] = static_cast<uint8_t>(word >> (8 * b));
  }
}

// Block (column block bx, range row ry): nb ranges of range row ry, thread
// i * nb + j on row i of range bx * nb + j.  TS: the range size, or 0 to
// read it from ts.
template <int TS, bool Mean>
__global__ void __launch_bounds__(1024)
decode_step_kernel(const uint8_t* __restrict__ img,  // [H, W] u8, the step's input
                   const int* __restrict__ dom,      // [R] domain index
                   const int* __restrict__ tr,       // [R] isometry id, < 8
                   const float* __restrict__ s,      // [R]
                   const float* __restrict__ o,      // [R] (the range mean with Mean)
                   const int* __restrict__ cells,    // [8, K] cell corners
                   int w, int nxr, int ts_, int nxd, int step, int nb,
                   uint8_t* __restrict__ out) {      // [H, W] u8
  const int ts = TS ? TS : ts_;
  const int k_n = ts * ts;
  const int kp = k_n | 1;
  extern __shared__ int sh[];
  for (int e = threadIdx.x; e < kTransforms * k_n; e += blockDim.x) {
    sh[(e / k_n) * kp + e % k_n] = cells[e];
  }
  __syncthreads();

  const int i = threadIdx.x / nb;
  const int j = threadIdx.x - i * nb;
  const int ry = blockIdx.x;
  const int rx = blockIdx.y * nb + j;
  const bool live = rx < nxr;
  const int r = ry * nxr + rx;
  int origin = 0, t = 0;
  float sv = 0.0f, ov = 0.0f;
  if (live) {
    const int d = __ldg(dom + r);
    t = __ldg(tr + r);
    origin = (d / nxd) * step * w + (d % nxd) * step;
    sv = __ldg(s + r);
    ov = __ldg(o + r);
  }
  const int* row = sh + t * kp + i * ts;

  float mean = 0.0f;
  if constexpr (Mean) {
    int* part = sh + kTransforms * kp;  // [ts, nb] tap sums of each row
    int acc = 0;
    if (live) {
      for (int q = 0; q < ts; ++q) acc += cell_sum(img, origin + row[q], w);
    }
    part[threadIdx.x] = acc;
    __syncthreads();
    int total = 0;
    for (int q = 0; q < ts; ++q) total += part[q * nb + j];
    // the K samples' sum, exact in f32 (a multiple of 0.25, 1020 K < 2^24),
    // times f32(1/K)
    mean = __fmul_rn(__fmul_rn(__int2float_rn(total), 0.25f),
                     __fdiv_rn(1.0f, static_cast<float>(k_n)));
  }
  if (!live) return;

  uint8_t* dst = out + (ry * ts + i) * w + rx * ts;
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < ts; ++q) {
    float v = __fmul_rn(__int2float_rn(cell_sum(img, origin + row[q], w)), 0.25f);
    if constexpr (Mean) v = __fsub_rn(v, mean);
    word |= affine_u8(sv, v, ov) << (8 * (q & 3));
    if ((q & 3) == 3 || q == ts - 1) {
      put(dst + (q & ~3), word, (q & 3) + 1);
      word = 0;
    }
  }
}

template <int TS, bool Mean>
cudaError_t launch(const void* img, const void* dom, const void* tr, const void* s,
                   const void* o, const void* cells, int w, int nyr, int nxr, int ts,
                   int nxd, int step, void* out, cudaStream_t stream) {
  const int nb = ts >= kThreads ? 1 : kThreads / ts;
  const int threads = nb * ts;
  if (threads > 1024 || (nxr + nb - 1) / nb > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(kTransforms) * ((ts * ts) | 1) + (Mean ? threads : 0));
  auto kernel = decode_step_kernel<TS, Mean>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nyr, (nxr + nb - 1) / nb);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(dom),
      static_cast<const int*>(tr), static_cast<const float*>(s), static_cast<const float*>(o),
      static_cast<const int*>(cells), w, nxr, ts, nxd, step, nb, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

template <bool Mean>
cudaError_t dispatch(const void* img, const void* dom, const void* tr, const void* s,
                     const void* o, const void* cells, int w, int nyr, int nxr, int ts,
                     int nxd, int step, void* out, cudaStream_t stream) {
  // fixed instances for the pyramid's range sizes at the default geometry
  // (2 px at half scale, 4 px at full); every other size the generic one
  switch (ts) {
    case 2: return launch<2, Mean>(img, dom, tr, s, o, cells, w, nyr, nxr, ts, nxd, step, out, stream);
    case 4: return launch<4, Mean>(img, dom, tr, s, o, cells, w, nyr, nxr, ts, nxd, step, out, stream);
    default: return launch<0, Mean>(img, dom, tr, s, o, cells, w, nyr, nxr, ts, nxd, step, out, stream);
  }
}

}  // namespace

// One decoder step on `stream`: `out` [nyr * ts, nxr * ts] u8 from `img` of
// the same shape, the maps `dom`, `tr`, `s`, `o` [nyr * nxr] and the corner
// table `cells` [8, ts * ts] (offsets for a domain anchored at 0 of an image
// nxr * ts wide), domains on a grid of nxd columns at `step` pixels; `mean`:
// the maps' o is the range mean.  Returns cudaGetLastError() (0 on success).
extern "C" int fe_decode_step(const void* img, const void* dom, const void* tr, const void* s,
                              const void* o, const void* cells, int nyr, int nxr, int ts,
                              int nxd, int step, int mean, void* out, void* stream) {
  if (nyr <= 0 || nxr <= 0 || ts <= 0 || nxd <= 0 || step <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = nxr * ts;
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mean ? dispatch<true>(img, dom, tr, s, o, cells, w, nyr, nxr, ts, nxd, step, out, st)
                               : dispatch<false>(img, dom, tr, s, o, cells, w, nyr, nxr, ts, nxd, step, out, st));
}
