"""The port's search kernels: K1 and K2 (class-blocked) and K3 (dense).

Counterpart of ``fractencode_tpu/ops/matcher_pallas.py``.  For every range
row a search returns ``(q, idx)``: the first-occurrence argmax of the rank
key ``q`` over the row's columns, and its column index.

  * K1, the class-blocked search.  There the TPU kernel ``_pairs_kernel``
    (through ``fused_search_pairs``) walks a list of (range tile, column
    tile) pairs.  Here each range tile scans its own class's column segment,
    which ``encode.matcher.classed_prep`` lays out, so there is no pair list.
  * K2, the 2-D class-blocked search (the TPU kernel ``_classed_kernel``,
    through ``fused_search_classed``): K1's function over the same layout,
    with each class segment cut into splits of whole groups.  A block
    searches one range tile against one split, writing a partial (q, idx,
    hit) per row; a second pass reduces a row's partials in split order (see
    ``search_classed2d_torch``).  It gives few-row searches more blocks, and
    it is the route the JAX package takes where its pair list overflows
    (``encode.matcher.classed_prep``).
  * K3, the dense search (the TPU kernel ``_search_kernel``, through
    ``fused_search``): every row against the columns ``[0, m_valid)`` in
    search order, optionally masked by a per-element class compare.  It
    serves the search without the classifier.

Each has two versions of the same function:

  * the plain PyTorch version (``search_classed_torch``,
    ``search_classed2d_torch``, ``search_dense_torch``), for the three rank
    modes ('ls', 'raw', 'general') at every n up to MAX_SLAB_N;
  * the wrapper of the hand-written CUDA kernel (``search_classed_cuda`` on
    ``csrc/search_classed.cu``, ``search_classed2d_cuda`` on
    ``csrc/search_classed2d.cu``, ``search_dense_cuda`` on
    ``csrc/search_dense.cu``), whose instances cover the same n
    (``KERNEL_KEYS``).  It routes on the tensors' device: CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise.

n and K.  n is the range's pixel count; K (``kernel_width``) the width of
the int8 operand rows the searches take: n itself at n = 16, 64, 256 (the
fixed instances), else n padded with zero bytes to 16, 64 or 256 (the padded
instances, ``<K>p``), or above 256 to a multiple of 256 (the K-slab form,
``_slab``).  Zero bytes add nothing to the dot or to a row's byte sum, so
every key reads n, which each search takes as an argument, never from a
shape.  Both versions take the very same padded tensors.

Both take the early-accept frontier (``threshold > 0``, the TPU kernels'
``_apply_frontier``), the reference's scan exits
(``TransformEstimator2.hpp:40-41``, ``transformmatcher.h:55-56``).  Columns
come in groups of ``t_n``, the isometries of one domain, counted from the
start of the row's scan (its class segment, or column 0).  A column *hits*
when its distance (``rank_to_dist`` of its key) is ``<= f32(threshold)``.
In a row's first group g that holds a hit, let c* be its last hit column
(the first hit isometry in ascending order); the row's winner is then the
first-occurrence argmax over the columns before g and those of g from c* on,
and the row scans nothing after g.  A row with no hit takes the plain
argmax.  The definition does not depend on how the scan is tiled.

The rank-key helpers below keep the JAX package's expression order, so that
every key is the same f32 value (see ``rank_mode``).  One rule per range of
n:

  * n <= INT8_MAX_K: the JAX package's expressions on the same f32 sums.
    Its integers (4*SumB, 16*SumB2, 4*SumAB) are rebuilt from those f32
    values, so where an f32 sum is rounded (SumB2 at n = 64) the rounded
    value is what enters the key, as in the JAX package.
  * n > INT8_MAX_K: exact integers, each rounded once.  The JAX
    package computes these keys in f32, where their value depends on the
    summation order and on FMA contraction; the port departs from it on
    purpose (ROADMAP.md, parity contract).  The sums f32 cannot hold
    exactly there (SumAB, SumB2) are passed as float64, which holds them
    exactly; all integer arithmetic is int64.  'ls' is f32(cov4)^2 * aux/16
    as below; 'raw' is f32(16q) / 16 with the integer 16q = 8*(4*SumAB) -
    16*SumB2; 'general' evaluates its residual in float64 from the exact
    sums, in one fixed order, and rounds once to f32 (``_rank_exact``).
    Above F32_SUMS_MAX_K (the K-slab form) SumA2 leaves f32's 2^24, so
    SumA, SumA2 and SumB come as float64 too (``sum_dtype``).
"""
from __future__ import annotations

import ctypes
import struct

import torch

__all__ = ["INT8_MAX_K", "F32_SUMS_MAX_K", "MAX_SLAB_N", "WIDTHS", "KERNEL_KEYS",
           "DEFAULT_BR", "DEFAULT_BM", "PAIR_TILE_R", "PAIR_TILE_M", "PAIR_CAP", "CT_BITS",
           "kernel_width", "instance_width", "sum_dtype", "rank_mode",
           "inv_var_b", "key_sum_sq", "rank_to_dist", "search_classed_torch",
           "search_classed_cuda", "search_classed2d_torch", "search_classed2d_cuda",
           "search_dense_torch", "search_dense_cuda"]

# Largest n for which the JAX package's keys are exact integers in i32 and
# it searches with int8 operands (matcher_pallas.py:41-44).
INT8_MAX_K = 64
# Largest n whose sums SumA, SumA2 and SumB f32 holds exactly (SumA2 <=
# 256 * 255^2 < 2^24); above, they are float64 (``sum_dtype``).
F32_SUMS_MAX_K = 256
# Largest n the searches take: the K-slab form sums ai . ch over its slabs in
# int32, exact while n * 128 * 127 < 2^31 (csrc/search_mma.cuh kMaxSlabN).
MAX_SLAB_N = 132104
# The instances' widths (csrc/search_*.cu): the fixed K = 16, 64, 256 (n = K),
# the padded ones (n below K, operands zero past n) and the K-slab form.
WIDTHS = (16, 64, 256, "16p", "64p", "256p", "_slab")
# The widths of each CUDA kernel's instances by rank mode.
KERNEL_KEYS = {"ls": WIDTHS, "raw": WIDTHS, "general": WIDTHS}

# The port's layout tiles: range rows and codebook columns per class-segment
# alignment unit.  Results do not depend on them (only the padding does);
# the CUDA kernel scans each segment only up to its last real column, so a
# small column tile wastes no work, and 128-row range tiles are one kernel
# block each.
DEFAULT_BR = 128
DEFAULT_BM = 128

# The JAX package's route between its pair-list kernel (K1) and its 2-D
# classed kernel (K2), copied so that the port takes K2 where it does
# (encode.matcher.classed_prep).  Its tiles, which size the pair list
# (fractencode_tpu/ops/matcher_pallas.py:36-37): they decide the route only,
# never the port's layout.
PAIR_TILE_R = 512
PAIR_TILE_M = 4096
# The pair list's length cap and its column-tile field width
# (matcher_pallas.py:496-498).
PAIR_CAP = 196608
CT_BITS = 12

# Columns K2 stages in shared memory per pass, by K (mma::kCols in
# csrc/search_mma.cuh; the K-slab form's chunk is K = 256's): its splits hold
# at least one.
_CHUNK_COLS = {16: 512, 64: 128}
_SLAB_CHUNK_COLS = 64
# Range rows per K1 and K2 block (mma::kBlockRows in csrc/search_mma.cuh)
_KROWS = 128
# K2's blocks per SM when it chooses its split width (search_classed2d_cuda)
_BLOCKS_PER_SM = 4

_BIG = 3.0e38
_BIG_I = 2**31 - 1


def rank_mode(criterion: str, so_mode: str, s_max: float) -> str:
    """Which ranking key a (criterion, so_mode, s_max) combo uses.

    'raw'     — q = 2*SumAB - SumB2; dist = (SumA2 - q)*inv_norm.
    'ls'      — q = cov^2 * inv_var_b; dist = max(var_a - q, 0)*(inv_norm/n).
    'general' — the full residual with the mode's (s, o); q = -dist.
    Every key is maximized; ties go to the lowest column.
    """
    if criterion == "raw":
        return "raw"
    if so_mode == "ls" and s_max <= 0.0:
        return "ls"
    return "general"


def kernel_width(n: int) -> int:
    """K, the width of the int8 operand rows for ranges of n pixels: 16, 64
    or 256, the least of them >= n, and above 256 n rounded up to a multiple
    of 256 (the K-slab form's slabs).  Raises past MAX_SLAB_N."""
    n = int(n)
    if not 1 <= n <= MAX_SLAB_N:
        raise ValueError(f"n = {n} pixels a range: the searches take 1 to {MAX_SLAB_N} "
                         f"(the K-slab form's int32 sums of ai . ch, up to n * 128 * 127, "
                         f"must stay below 2^31)")
    for k in (16, 64, 256):
        if n <= k:
            return k
    return -(-n // 256) * 256


def instance_width(n: int, k: int):
    """The width of the instance that searches ranges of n pixels on operand
    rows of K bytes (``WIDTHS``): K itself where n = K in (16, 64, 256),
    "<K>p" for n padded to K <= 256, "_slab" above; a ValueError where K is
    not ``kernel_width(n)``."""
    if k != kernel_width(n):
        raise ValueError(f"operand rows of {k} bytes for n = {n}: the kernels take "
                         f"{kernel_width(n)}")
    if n == k and k <= F32_SUMS_MAX_K:
        return k
    return f"{k}p" if k <= F32_SUMS_MAX_K else "_slab"


def sum_dtype(n: float) -> torch.dtype:
    """The dtype of SumA, SumA2 and SumB for ranges of n pixels: f32, exact
    up to F32_SUMS_MAX_K, and float64 above (exact: integers and quarters
    below 2^53)."""
    return torch.float32 if n <= F32_SUMS_MAX_K else torch.float64


def _width_n(x: torch.Tensor, n) -> int:
    """n, the range's pixel count: given, or (unpadded operands) the width of
    the operand rows ``x``."""
    n = x.shape[1] if n is None else int(n)
    if not 1 <= n <= x.shape[1]:
        raise ValueError(f"n = {n} on operand rows of {x.shape[1]} bytes")
    return n


def _require_exact_sums(n: float, **sums) -> None:
    """Above INT8_MAX_K, SumAB and SumB2 must come exact, as float64."""
    if n > INT8_MAX_K:
        for name, x in sums.items():
            if x.dtype != torch.float64:
                raise TypeError(f"K = {int(n)} > {INT8_MAX_K}: {name} must be "
                                f"the exact float64 sum, got {x.dtype}")


def key_sum_sq(sb2_16: torch.Tensor, n: float) -> torch.Tensor:
    """SumB2 as the keys and the solve read it, from the exact integer
    16*SumB2 (int64: it passes 2^31 above n = 2064): rounded once to f32 for
    n <= INT8_MAX_K (the JAX package's f32 sum, which is exact for n <= 16),
    exact float64 above."""
    if n <= INT8_MAX_K:
        return sb2_16.to(torch.float32) * 0.0625
    return sb2_16.to(torch.float64) * 0.0625


def inv_var_b(sb: torch.Tensor, sb2: torch.Tensor, n: float) -> torch.Tensor:
    """Per-column guarded reciprocal 1/var_b, s = 0 semantics for var_b = 0.

    16*var_b = n*(16*SumB2) - (4*SumB)^2 is an integer (samples are
    multiples of 0.25), formed here in int64, so the only roundings are the
    int -> f32 cast and the division.  For K <= INT8_MAX_K, 16*SumB2 is
    rebuilt from the f32 ``sb2`` as the JAX package does (its i32 products
    wrap at K = 64, its difference does not); above, ``sb2`` is the exact
    float64 sum.
    """
    _require_exact_sums(n, sb2=sb2)
    sb4 = (4.0 * sb).to(torch.int64)
    sb2_16 = (16.0 * sb2).to(torch.int64)
    var16 = int(n) * sb2_16 - sb4 * sb4
    var_b = var16.to(torch.float32) * 0.0625
    zero = var16 == 0
    return torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, var_b))


def _cov_exact(ab, sa, sb, n: float):
    """cov = n*SumAB - SumA*SumB from the integers 4*cov, one rounding."""
    _require_exact_sums(n, ab=ab)
    ab4 = (4.0 * ab).to(torch.int64)
    cov4 = int(n) * ab4 - sa.to(torch.int64) * (4.0 * sb).to(torch.int64)
    return cov4.to(torch.float32) * 0.25


def _f32(x: float) -> float:
    """The f32 value of a Python float: the host constants the kernels take."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _rank_exact(ab, sa, sa2, sb, sb2, *, mode, so_mode, s_max, inv_norm, n):
    """The 'raw' and 'general' keys above INT8_MAX_K, from exact integers.

    ab (SumAB) and sb2 (SumB2) come as exact float64, sa, sa2 and sb as f32
    or (above F32_SUMS_MAX_K) float64, exact integers and quarters either
    way.  'raw': the integer 16q = 8*(4*SumAB) - 16*SumB2 (<= 532,684,800 at
    n = 256, past 2^31 above n = 1024: int64), rounded once to f32, then
    scaled by 1/16 (exact).  'general': cov4, var16 = 16*var_b, var_a and the
    'reference' denominator n*SumA2 - (SumA - 1)*SumA as int64; s, o and
    the residual e in float64 in the expression order of the f32 branch
    below (the C++ reference computes them in double); q = -f32(max(e, 0)
    * inv_norm).  s_max and inv_norm enter as their f32 values, as the
    kernels take them.
    """
    ni = int(n)
    ab4 = (4.0 * ab).to(torch.int64)
    sb2_16 = (16.0 * sb2).to(torch.int64)
    if mode == "raw":
        return (8 * ab4 - sb2_16).to(torch.float32) * 0.0625
    f64 = torch.float64
    sa_i, sa2_i = sa.to(torch.int64), sa2.to(torch.int64)
    sb4 = (4.0 * sb).to(torch.int64)
    cov = (ni * ab4 - sa_i * sb4).to(f64) * 0.25
    if so_mode == "ls":
        var_b = (ni * sb2_16 - sb4 * sb4).to(f64) * 0.0625
        den = var_b
    else:
        den = (ni * sa2_i - (sa_i - 1) * sa_i).to(f64)
    s = torch.where(den == 0.0, 0.0, cov / torch.where(den == 0.0, 1.0, den))
    if s_max > 0.0:
        s = s.clamp(-_f32(s_max), _f32(s_max))
    if so_mode == "ls":
        var_a = (ni * sa2_i - sa_i * sa_i).to(f64)
        e = (var_a - 2.0 * s * cov + (s * s) * var_b) * (1.0 / n)
    else:
        sa, sa2, sb = sa.to(f64), sa2.to(f64), sb.to(f64)
        o = (sb - s * sa) * (1.0 / n)
        e = (sa2 + (s * s) * sb2 + n * o * o + 2.0 * s * o * sb
             - 2.0 * s * ab - 2.0 * o * sa)
    return -((e.clamp_min(0.0) * _f32(inv_norm)).to(torch.float32))


def _rank_tile(ab, sa, sa2, sb, aux, *, criterion, so_mode, s_max, inv_norm, n):
    """The maximized rank key q for a [rows, cols] block of SumAB values.

    ``aux`` is inv_var_b for mode 'ls', SumB2 otherwise.  'raw' and 'ls' are
    single IEEE operations on exact operands, so they equal the JAX package's
    keys bit for bit.  'general' has multiply-adds that XLA:CPU may contract
    into FMAs, so its keys can differ from the JAX package's in the last bit.
    Above INT8_MAX_K, 'raw' and 'general' take ``_rank_exact`` (ab and aux
    as exact float64).
    """
    mode = rank_mode(criterion, so_mode, s_max)
    if n > INT8_MAX_K and mode != "ls":
        _require_exact_sums(n, ab=ab, sb2=aux)
        return _rank_exact(ab, sa, sa2, sb, aux, mode=mode, so_mode=so_mode,
                           s_max=s_max, inv_norm=inv_norm, n=n)
    if mode == "raw":
        return 2.0 * ab - aux
    cov = _cov_exact(ab, sa, sb, n)
    if mode == "ls":
        return (cov * cov) * aux
    sb2 = aux
    var_b = n * sb2 - sb * sb
    if so_mode == "ls":
        var_a = n * sa2 - sa * sa
        s = torch.where(var_b.abs() < 1e-5, 0.0,
                        cov / torch.where(var_b == 0.0, 1.0, var_b))
        if s_max > 0.0:
            s = s.clamp(-s_max, s_max)
        e = (var_a - 2.0 * s * cov + (s * s) * var_b) * (1.0 / n)
        return -(e.clamp_min(0.0) * inv_norm)
    den = n * sa2 - (sa - 1.0) * sa
    s = torch.where(den.abs() < 1e-5, 0.0, cov / torch.where(den == 0.0, 1.0, den))
    if s_max > 0.0:
        s = s.clamp(-s_max, s_max)
    o = (sb - s * sa) * (1.0 / n)
    e = (sa2 + (s * s) * sb2 + n * o * o + 2.0 * s * o * sb
         - 2.0 * s * ab - 2.0 * o * sa)
    return -(e.clamp_min(0.0) * inv_norm)


def _rank_ls_int8(sa_i, dot, sb4, aux16, n: int):
    """The 'ls' key from the exact integer dot (matcher_pallas._rank_ls_int8).

    cov4 = 4*(n*SumAB - SumA*SumB) = n*dot + (128n - SumA)*sb4 with dot =
    sum ai*(8ch + cl); q = f32(cov4)^2 * (aux/16).  cov4 is formed in i32 for
    n <= INT8_MAX_K, as the JAX package does (for n not a power of two too:
    an integer, rounded once), and in int64 above (it reaches ~9e9 at
    n = 256).
    """
    if n > INT8_MAX_K:
        dot, sa_i, sb4 = dot.to(torch.int64), sa_i.to(torch.int64), sb4.to(torch.int64)
    cov4 = n * dot + (128 * n - sa_i) * sb4
    c = cov4.to(torch.float32)
    return (c * c) * aux16


def rank_to_dist(q, sa2, sa, *, criterion, so_mode, s_max, inv_norm, n: float):
    """Convert rank keys back to distances; q <= -_BIG/2 (no column) -> _BIG."""
    mode = rank_mode(criterion, so_mode, s_max)
    if mode == "raw":
        # SumA2 rounded once to f32 (exact up to F32_SUMS_MAX_K)
        dist = (sa2.to(torch.float32) - q) * inv_norm
    elif mode == "ls":
        # SumA and SumA2 are exact (f32 up to F32_SUMS_MAX_K, float64 above);
        # var_a is formed exactly in int64 and rounded once
        sa_i = sa.to(torch.int64)
        var_a = (int(n) * sa2.to(torch.int64) - sa_i * sa_i).to(torch.float32)
        dist = (var_a - q).clamp_min(0.0) * (inv_norm * (1.0 / n))
    else:
        dist = -q
    return torch.where(q <= -_BIG * 0.5, _BIG, dist)


def _frontier_mask(hit, t_n: int):
    """Within one chunk of whole groups (chunk-local ids, groups of ``t_n``
    from id 0): (the columns a row keeps, whether the row hit, the end of
    its frontier group or the chunk's width).  The TPU kernels'
    ``_apply_frontier`` with the prefix mask as a boolean."""
    ids = torch.arange(hit.shape[1], dtype=torch.int64, device=hit.device)
    first = torch.where(hit, ids, _BIG_I).amin(1, keepdim=True)
    any_hit = first < _BIG_I
    g_start = torch.div(first, t_n, rounding_mode="floor") * t_n
    in_g = (ids >= g_start) & (ids < g_start + t_n)
    c_star = torch.where(hit & in_g, ids, -1).amax(1, keepdim=True)
    keep = ~any_hit | (ids < g_start) | (in_g & (ids >= c_star))
    end = torch.where(any_hit, g_start + t_n, hit.shape[1]).squeeze(1)
    return keep, any_hit.squeeze(1), end


def _plain_search(ai, ch, cl, sb, aux, segments, *, n: int, criterion: str,
                  so_mode: str, s_max: float, inv_norm: float, sa=None, sa2=None,
                  rcls=None, ccls=None, threshold: float = 0.0, t_n: int = 4,
                  scanned=None, hit=None):
    """The plain search over ranges of ``n`` pixels (the operand rows may be
    wider, zero past n): for each (r0, r1, c0, c1) in ``segments``, rows
    [r0, r1) of ``ai`` against columns [c0, c1), with the class mask
    ``rcls[r] == ccls[j]`` when both are given, and the early-accept
    frontier when ``threshold > 0`` (groups of ``t_n`` columns from c0; the
    hit test reads ``sa`` and ``sa2`` for every key).  Rows no segment
    covers, and rows with no admissible column, keep (-_BIG, 0).
    ``scanned`` (int64 [rows], optional) receives each row's count of
    admissible columns up to the end of its frontier group (or of its
    segment): the pairs the search needs.  ``hit`` (bool [rows], optional)
    receives whether each row's scan met the frontier.

    The dot sum(ai * (8*ch + cl)) comes exactly from matmuls: one of ai
    against b4 = 8*ch + cl in float64 on the CPU (integers below 2^53); on
    CUDA in float32 with TF32 off, one against b4 for n <= INT8_MAX_K (every
    partial sum is an integer below 2^24) and one each against ch and cl up
    to n = 1032 (|sum| <= n*128*127 < 2^24), combined in integers; above, one
    against b4 in float64.  The dot is an int32, and an int64 above
    F32_SUMS_MAX_K (it passes 2^31 above n = 16,448).  With the frontier,
    columns go in chunks of whole groups, as in the CUDA kernels, and rows
    that are done leave the chunks that follow.
    """
    r_pad, k = ai.shape
    dev = ai.device
    mode = rank_mode(criterion, so_mode, s_max)
    frontier = threshold > 0.0
    if frontier and (sa is None or sa2 is None or t_n < 1):
        raise ValueError("the frontier needs the per-row sa and sa2, and t_n >= 1")
    # the kernels compare with f32(threshold), as the JAX package does
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    f32_mm = dev.type == "cuda" and n <= 1032
    mm_dtype = torch.float32 if f32_mm else torch.float64
    budget = (1 << 26) if dev.type == "cuda" else (1 << 21)
    split = f32_mm and n > INT8_MAX_K
    dot_dtype = torch.int32 if n <= F32_SUMS_MAX_K else torch.int64

    q_out = torch.full((r_pad,), -_BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros((r_pad,), dtype=torch.int32, device=dev)
    a_mm = ai.to(mm_dtype)
    if split:
        bh_mm, bl_mm = ch.to(mm_dtype), cl.to(mm_dtype)
    else:
        b_mm = (8 * ch.to(torch.int32) + cl.to(torch.int32)).to(mm_dtype)

    def dot_of(rows, j0, j1):
        a = a_mm[rows]
        if split:
            return (8 * (a @ bh_mm[j0:j1].T).to(dot_dtype)
                    + (a @ bl_mm[j0:j1].T).to(dot_dtype))
        return (a @ b_mm[j0:j1].T).to(dot_dtype)

    if mode == "ls":
        # SumA = the row's byte sum + 128 n (its zero bytes past n add nothing)
        sa_i = ai.to(torch.int32).sum(1, dtype=torch.int32) + 128 * n
        sb4 = (4.0 * sb).to(torch.int32)
        aux16 = aux * 0.0625
    else:
        ab_dtype = torch.float32 if n <= INT8_MAX_K else torch.float64
        sb_ab = sb.to(ab_dtype)
    col = lambda x, rows: None if x is None else x[rows].unsqueeze(1)

    for r0_, r1_, c0, c1 in segments:
        if c1 <= c0:
            continue  # no columns: keep the initial (-_BIG, 0)
        col_chunk = min(c1 - c0, 16384)
        if frontier:
            col_chunk = max(t_n, col_chunk - col_chunk % t_n)  # whole groups
        row_chunk = max(1, budget // col_chunk)
        for r0 in range(r0_, r1_, row_chunk):
            r1 = min(r0 + row_chunk, r1_)
            best_q = torch.full((r1 - r0,), -_BIG, dtype=torch.float32, device=dev)
            best_i = torch.zeros((r1 - r0,), dtype=torch.int32, device=dev)
            done = torch.zeros((r1 - r0,), dtype=torch.bool, device=dev)
            for j0 in range(c0, c1, col_chunk):
                j1 = min(j0 + col_chunk, c1)
                loc = slice(None)  # the rows of [r0, r1) still scanning
                if frontier and bool(done.any()):
                    loc = (~done).nonzero().squeeze(1)
                    if loc.numel() == 0:
                        break
                rows = slice(r0, r1) if isinstance(loc, slice) else loc + r0
                dot = dot_of(rows, j0, j1)
                if mode == "ls":
                    q = _rank_ls_int8(col(sa_i, rows), dot, sb4[None, j0:j1],
                                      aux16[None, j0:j1], n)
                else:  # SumAB: exact in f32 up to INT8_MAX_K, in float64 above
                    ab = dot.to(ab_dtype) * 0.25 + 128.0 * sb_ab[None, j0:j1]
                    q = _rank_tile(ab, col(sa, rows), col(sa2, rows), sb[None, j0:j1],
                                   aux[None, j0:j1], criterion=criterion,
                                   so_mode=so_mode, s_max=s_max, inv_norm=inv_norm,
                                   n=float(n))
                admit = None
                if rcls is not None:
                    admit = col(rcls, rows) == ccls[None, j0:j1]
                    q = torch.where(admit, q, -_BIG)
                end = None
                if frontier:
                    dist = rank_to_dist(q, col(sa2, rows), col(sa, rows),
                                        criterion=criterion, so_mode=so_mode,
                                        s_max=s_max, inv_norm=inv_norm, n=float(n))
                    keep, row_hit, end = _frontier_mask(dist <= thr, t_n)
                    q = torch.where(keep, q, -_BIG)
                if scanned is not None:
                    within = (torch.ones_like(q, dtype=torch.bool) if end is None else
                              torch.arange(j1 - j0, device=dev) < end[:, None])
                    if admit is not None:
                        within = within & admit
                    scanned[rows] += within.sum(1)
                # first-occurrence argmax: the lowest column holding the max
                tile_q = q.amax(1)
                ids = torch.arange(j1 - j0, dtype=torch.int32, device=dev)
                tile_arg = torch.where(q == tile_q[:, None], ids, _BIG_I).amin(1) + j0
                improved = tile_q > best_q[loc]
                best_i[loc] = torch.where(improved, tile_arg.to(torch.int32), best_i[loc])
                best_q[loc] = torch.where(improved, tile_q, best_q[loc])
                if frontier:
                    done[loc] = row_hit
            q_out[r0:r1] = best_q
            idx_out[r0:r1] = best_i
            if hit is not None:
                hit[r0:r1] = done
    return q_out, idx_out


def _class_runs(tile_class: torch.Tensor):
    """[(first tile, end tile, class)] for runs of equal class: range tiles
    are sorted by class, so each class's rows are one contiguous slice."""
    tc = tile_class.tolist()
    runs, t0 = [], 0
    for t in range(1, len(tc) + 1):
        if t == len(tc) or tc[t] != tc[t0]:
            runs.append((t0, t, tc[t0]))
            t0 = t
    return runs


def _classed_segments(tile_class, col_tile_start, col_end, row_end, block_r: int,
                      block_m: int, frontier: bool):
    """[(r0, r1, c0, c1)]: each run of range tiles of one class, its rows and
    its class's column segment.  With the frontier only a class's real rows
    (below ``row_end``) search."""
    starts = (col_tile_start.to(torch.int64) * block_m).tolist()
    ends = col_end.tolist()
    row_ends = row_end.tolist()
    return [(t0 * block_r,
             min(t1 * block_r, max(t0 * block_r, row_ends[c])) if frontier else t1 * block_r,
             starts[c], ends[c])
            for t0, t1, c in _class_runs(tile_class)]


def search_classed_torch(ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                         col_tile_start, col_end, row_end, *, block_r: int,
                         block_m: int, criterion: str, so_mode: str, s_max: float,
                         inv_norm: float, sa_s=None, sa2_s=None,
                         threshold: float = 0.0, t_n: int = 4, scanned=None, n=None):
    """Plain PyTorch version of K1, the class-blocked search.

    ai_s [R_pad, K] i8 (A - 128), ch_s/cl_s [M_pad, K] i8 (4B >> 3, 4B & 7),
    each zero past ``n``, the range's pixel count (None: the operands are
    unpadded, n = K); sb_s/aux_s [M_pad] f32 (``sum_dtype(n)`` for sb_s and
    ``_aux_dtype`` for aux_s), tile_class [NRT] i32, col_tile_start/col_end/
    row_end [NC] i32; sa_s/sa2_s [R_pad] f32 for the 'general' mode and for
    the frontier (``threshold > 0``, groups of ``t_n`` columns from each
    class segment's start).  Returns (q [R_pad] f32, idx [R_pad] i32), idx a
    sorted column index.  Without the frontier every row of a class's tiles
    is searched, the layout's padding rows too (as the TPU kernel does);
    with it only the rows below ``row_end[c]``, and the padding rows keep
    (-_BIG, 0).  Above INT8_MAX_K, aux_s is float64 for 'raw' and
    'general' (the exact SumB2); above F32_SUMS_MAX_K sb_s, sa_s and sa2_s
    are float64.  ``scanned``: see ``_plain_search``.
    """
    segments = _classed_segments(tile_class, col_tile_start, col_end, row_end,
                                 block_r, block_m, threshold > 0.0)
    return _plain_search(ai_s, ch_s, cl_s, sb_s, aux_s, segments, n=_width_n(ai_s, n),
                         criterion=criterion, so_mode=so_mode, s_max=s_max,
                         inv_norm=inv_norm, sa=sa_s, sa2=sa2_s, threshold=threshold,
                         t_n=t_n, scanned=scanned)


def _check_width(width: int, frontier: bool, t_n: int) -> None:
    if width < 1 or (frontier and width % t_n):
        raise ValueError(f"{width} columns per split: need a positive multiple of "
                         f"t_n = {t_n} with the frontier")


def search_classed2d_torch(ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                           col_tile_start, col_end, row_end, *, block_r: int,
                           block_m: int, criterion: str, so_mode: str, s_max: float,
                           inv_norm: float, sa_s=None, sa2_s=None,
                           threshold: float = 0.0, t_n: int = 4, splits=None,
                           scanned=None, n=None):
    """Plain PyTorch version of K2, the 2-D class-blocked search: K1's
    function (``search_classed_torch``: the same arguments and result),
    computed split by split as the TPU kernel's 2-D grid does.

    ``splits`` is the number of columns per split (a multiple of ``t_n``
    with the frontier; None: one split per class segment).  Split s of a
    class covers columns [start + s*splits, start + (s+1)*splits) of its
    segment; its partial is ``_plain_search`` over them, with the frontier's
    groups counted from the split's start, which is a group boundary of the
    segment, so no group straddles two splits.  A row's result is the
    strict-'>' max over its splits in order, up to and including the first
    split whose scan hit: an earlier split holds lower columns, so ties go
    to the lowest column, and nothing after a row's frontier counts.
    ``scanned`` counts each row's pairs up to its frontier, as K1's does.
    """
    frontier = threshold > 0.0
    segments = _classed_segments(tile_class, col_tile_start, col_end, row_end,
                                 block_r, block_m, frontier)
    longest = max((c1 - c0 for _, _, c0, c1 in segments), default=0)
    width = max(longest, t_n) if splits is None else splits
    _check_width(width, frontier, t_n)
    r_pad, dev = ai_s.shape[0], ai_s.device
    n = _width_n(ai_s, n)
    q = torch.full((r_pad,), -_BIG, dtype=torch.float32, device=dev)
    idx = torch.zeros((r_pad,), dtype=torch.int32, device=dev)
    stopped = torch.zeros((r_pad,), dtype=torch.bool, device=dev)
    for s0 in range(0, longest, width):
        part = [(r0, r1, c0 + s0, min(c0 + s0 + width, c1))
                for r0, r1, c0, c1 in segments if c0 + s0 < c1]
        hit = torch.zeros_like(stopped)
        part_scanned = None if scanned is None else torch.zeros_like(scanned)
        q_s, i_s = _plain_search(ai_s, ch_s, cl_s, sb_s, aux_s, part, n=n, criterion=criterion,
                                 so_mode=so_mode, s_max=s_max, inv_norm=inv_norm,
                                 sa=sa_s, sa2=sa2_s, threshold=threshold, t_n=t_n,
                                 scanned=part_scanned, hit=hit)
        better = ~stopped & (q_s > q)
        q = torch.where(better, q_s, q)
        idx = torch.where(better, i_s, idx)
        if scanned is not None:
            scanned += torch.where(stopped, 0, part_scanned)
        stopped |= hit
    return q, idx


def search_dense_torch(ai, ch, cl, sb, aux, *, m_valid: int, criterion: str,
                       so_mode: str, s_max: float, inv_norm: float, sa=None,
                       sa2=None, rcls=None, ccls=None, threshold: float = 0.0,
                       t_n: int = 4, scanned=None, n=None):
    """Plain PyTorch version of K3, the dense search (``fused_search``).

    ai [R, K] i8 (A - 128), ch/cl [M, K] i8 (4B >> 3, 4B & 7), each zero past
    ``n`` (None: unpadded, n = K), and sb/aux [M] for columns in search
    order (f32 but as in ``search_classed_torch``; aux is inv_var_b for 'ls', SumB2
    otherwise), M >= m_valid; sa/sa2 [R] f32 for the 'general' mode and for
    the frontier (``threshold > 0``, groups of ``t_n`` columns from column
    0); rcls [R] and ccls [M] i32 for the class mask (``use_classes``), or
    None.  Returns (q [R] f32, idx [R] i32): the first-occurrence argmax over
    the columns [0, m_valid) (of the row's class, with the mask).  K above
    INT8_MAX_K, aux is float64 for 'raw' and 'general' (the exact SumB2).
    ``scanned``: see ``_plain_search``.
    """
    return _plain_search(ai, ch, cl, sb, aux, [(0, ai.shape[0], 0, m_valid)],
                         n=_width_n(ai, n), criterion=criterion, so_mode=so_mode, s_max=s_max,
                         inv_norm=inv_norm, sa=sa, sa2=sa2, rcls=rcls, ccls=ccls,
                         threshold=threshold, t_n=t_n, scanned=scanned)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _launch_mode(ai, n, criterion: str, so_mode: str, s_max: float):
    """(mode, width, n) of a launch on CUDA tensors (``instance_width``), or
    raise for operands that no instance takes."""
    if ai.device.type != "cuda":
        raise ValueError(f"unsupported device {ai.device}")
    n = _width_n(ai, n)
    return rank_mode(criterion, so_mode, s_max), instance_width(n, ai.shape[1]), n


def _aux_dtype(mode: str, n: int):
    """The column aux the kernels read: f32, or the exact float64 SumB2 of
    the 'raw' and 'general' keys above INT8_MAX_K (``key_sum_sq``)."""
    return torch.float64 if n > INT8_MAX_K and mode != "ls" else torch.float32


def _key_args(mode, width, n, kp, sa, sa2, rows, dev, *, so_mode, s_max, inv_norm,
              threshold, t_n):
    """The kernels' trailing key and frontier arguments: the sa and sa2
    pointers (read by 'general' and by the frontier), s_max, 1/n and
    inv_norm (ctypes.c_float rounds the Python doubles to the f32 values
    torch computes with), the so_mode flag; then f32(threshold), the hit
    test's distance scale (rank_to_dist's: inv_norm/n formed in double, then
    rounded once, for 'ls'; inv_norm for 'raw') and t_n; and for the padded
    and K-slab instances n and the row width kp."""
    frontier = threshold > 0.0
    if mode == "general" or frontier:
        _check("sa", sa, sum_dtype(n), (rows,), dev)
        _check("sa2", sa2, sum_dtype(n), (rows,), dev)
        ptrs = (sa.data_ptr(), sa2.data_ptr())
    else:
        ptrs = (None, None)
    if frontier and t_n < 1:
        raise ValueError(f"t_n {t_n} < 1")
    scale = inv_norm * (1.0 / n) if mode == "ls" else inv_norm
    return (*ptrs, s_max, 1.0 / n, inv_norm, int(so_mode == "reference"),
            threshold, scale, t_n) + (() if isinstance(width, int) else (n, kp))


_KEY_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_float] * 3 + [ctypes.c_int]
                 + [ctypes.c_float] * 2 + [ctypes.c_int])


# each kernel's arguments before the key arguments: pointers, then ints
# (K2: also its grid's work items), and after them (K2: its split width, its
# work items' count, the work items, each tile's first among them, then its
# partials)
_HEADS = {"search_classed": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3,
          "search_classed2d": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4,
          "search_dense": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2}
_TAILS = {"search_classed2d": [ctypes.c_void_p] * 7}


def _kernel_fn(kernel: str, mode: str, width, frontier: bool):
    """The C entry point ``fe_<kernel>_<mode><width>``, ``..._thr`` with the
    frontier (its library built and loaded on first use); the padded and
    K-slab instances take n and kp after the key arguments."""
    from ._build import load_library

    fn = getattr(load_library(kernel), f"fe_{kernel}_{mode}{width}"
                 + ("_thr" if frontier else ""))
    wide = [] if isinstance(width, int) else [ctypes.c_int] * 2
    fn.argtypes = (_HEADS[kernel] + _KEY_ARGTYPES + wide + _TAILS.get(kernel, [])
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, key: tuple, rows: int, dev, *args):
    """Allocate (q, idx) of ``rows`` entries and launch the kernel of
    ``key`` = (mode, width, frontier) on the current stream with ``args``
    before them; raise on a refused launch."""
    fn = _kernel_fn(kernel, *key)
    with torch.cuda.device(dev):
        q = torch.empty((rows,), dtype=torch.float32, device=dev)
        idx = torch.empty((rows,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, q.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    return q, idx


def search_classed_cuda(ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                        col_tile_start, col_end, row_end, *, block_r: int,
                        block_m: int, criterion: str, so_mode: str, s_max: float,
                        inv_norm: float, sa_s=None, sa2_s=None,
                        threshold: float = 0.0, t_n: int = 4, n=None):
    """K1's hand-written CUDA kernel, with the arguments and result of
    ``search_classed_torch``.

    CPU tensors run the plain version.  CUDA tensors launch
    ``csrc/search_classed.cu``'s instance for n and the operands' width
    (and add one to ``search_classed_cuda.launches[(mode, width,
    frontier)]``), or raise ``ValueError`` for operands no instance takes.
    """
    kw = dict(block_r=block_r, block_m=block_m, criterion=criterion,
              so_mode=so_mode, s_max=s_max, inv_norm=inv_norm, sa_s=sa_s,
              sa2_s=sa2_s, threshold=threshold, t_n=t_n, n=n)
    if ai_s.device.type == "cpu":
        return search_classed_torch(ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                                    col_tile_start, col_end, row_end, **kw)
    key, head, keys = _classed_launch_args(
        "search_classed", ai_s, ch_s, cl_s, sb_s, aux_s, tile_class, col_tile_start,
        col_end, row_end, block_r, block_m, criterion, so_mode, s_max, inv_norm,
        sa_s, sa2_s, threshold, t_n, n)
    out = _launch("search_classed", key, ai_s.shape[0], ai_s.device, *head, *keys)
    search_classed_cuda.launches[key] += 1
    return out


def _classed_launch_args(kernel, ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                         col_tile_start, col_end, row_end, block_r, block_m, criterion,
                         so_mode, s_max, inv_norm, sa_s, sa2_s, threshold, t_n, n):
    """Check K1's or K2's CUDA tensors; return the launch key (mode, width,
    frontier), the layout's pointers, nrt, block_r and block_m, and the key
    arguments (``_key_args``)."""
    mode, width, n = _launch_mode(ai_s, n, criterion, so_mode, s_max)
    k = ai_s.shape[1]
    r_pad, m_pad = ai_s.shape[0], ch_s.shape[0]
    nrt, nc = tile_class.shape[0], col_end.shape[0]
    dev = ai_s.device
    if r_pad != nrt * block_r:
        raise ValueError(f"r_pad {r_pad} != {nrt} tiles x {block_r} rows")
    _check("ai_s", ai_s, torch.int8, (r_pad, k), dev)
    _check("ch_s", ch_s, torch.int8, (m_pad, k), dev)
    _check("cl_s", cl_s, torch.int8, (m_pad, k), dev)
    _check("sb_s", sb_s, sum_dtype(n), (m_pad,), dev)
    _check("aux_s", aux_s, _aux_dtype(mode, n), (m_pad,), dev)
    _check("tile_class", tile_class, torch.int32, (nrt,), dev)
    _check("col_tile_start", col_tile_start, torch.int32, (nc,), dev)
    _check("col_end", col_end, torch.int32, (nc,), dev)
    _check("row_end", row_end, torch.int32, (nc,), dev)
    head = (ai_s.data_ptr(), ch_s.data_ptr(), cl_s.data_ptr(), sb_s.data_ptr(),
            aux_s.data_ptr(), tile_class.data_ptr(), col_tile_start.data_ptr(),
            col_end.data_ptr(), row_end.data_ptr(), nrt, block_r, block_m)
    keys = _key_args(mode, width, n, k, sa_s, sa2_s, r_pad, dev, so_mode=so_mode,
                     s_max=s_max, inv_norm=inv_norm, threshold=threshold, t_n=t_n)
    return (mode, width, threshold > 0.0), head, keys


def _k2_plan(nrt: int, m_pad: int, block_r: int, k: int, frontier: bool, t_n: int,
             splits, sms: int):
    """K2's plan from the layout's shapes alone, so that nothing is read
    back: (step, items).  ``step`` is the split width with ``splits``
    (columns per split) given, else the unit the width the device picks
    (``_k2_work``) is a multiple of: one staged chunk (``_CHUNK_COLS`` by
    the operands' width K), whole groups with the frontier.  ``items``, the
    grid's x, bounds the (range tile, split) pairs that do work: a tile's
    segment holds at most the ``m_pad`` sorted columns, and a width chosen
    for the ``_BLOCKS_PER_SM`` blocks per SM of ``sms`` splits the columns
    of all the tiles into fewer than that many blocks beyond one a tile."""
    if splits is not None:
        _check_width(splits, frontier, t_n)
        return splits, max(1, nrt * -(-m_pad // splits))
    chunk = _CHUNK_COLS.get(k, _SLAB_CHUNK_COLS)
    step = chunk - (chunk % t_n if frontier else 0)
    slices = -(-block_r // _KROWS)  # the grid's thread blocks per range tile
    items = min(nrt * -(-m_pad // step), nrt + -(-_BLOCKS_PER_SM * sms // slices))
    return step, max(1, items)


def _k2_width(total, step: int, block_r: int, m_pad: int, sms: int):
    """The split width K2 picks for the ``total`` columns its range tiles
    search (a tensor): the multiple of ``step`` that gives the grid about
    ``_BLOCKS_PER_SM`` blocks per SM of ``sms``, at least one step and at
    most the ``m_pad`` columns a segment can hold; a search with many range
    tiles gets one split a segment."""
    slices = -(-block_r // _KROWS)
    width = (-(-total * slices // (_BLOCKS_PER_SM * sms))).clamp(step, max(step, m_pad))
    return -(-width // step) * step


def _k2_work(tile_class, col_tile_start, col_end, *, block_m: int, block_r: int,
             m_pad: int, step: int, items: int, auto: bool, sms: int):
    """K2's work on the device, made with torch ops and read back by
    nothing: (width, 0-d i32, the columns a split: ``step``, or with
    ``auto`` ``_k2_width`` of the searched columns; splits [nrt] i64, each
    tile's splits, 0 where it has no columns; work [items, 4] i32, (range
    tile, class, first column, end column) of each split that has columns,
    in tile then split order, the rows past them not read; n_work, 0-d i32,
    their count; first [nrt] i32, each tile's first row in work)."""
    cls = tile_class.to(torch.int64)
    start = col_tile_start.to(torch.int64)[cls] * block_m
    end = col_end.to(torch.int64)[cls]
    seg = (end - start).clamp_min(0)
    width = (_k2_width(seg.sum(), step, block_r, m_pad, sms) if auto
             else seg.new_full((), step))
    n = -(-seg // width)
    ends = n.cumsum(0)
    first = ends - n
    j = torch.arange(items, dtype=torch.int64, device=seg.device)
    # each item's tile; nrt past the last, which the padding below serves
    tile = torch.searchsorted(ends, j, right=True)
    pad = lambda x: torch.cat([x, x.new_zeros(1)])[tile]
    col = pad(start) + (j - pad(first)) * width
    work = torch.stack([tile, pad(cls), col, torch.minimum(col + width, pad(end))], 1)
    return (width.to(torch.int32), n, work.to(torch.int32), n.sum(dtype=torch.int32),
            first.to(torch.int32))


def search_classed2d_cuda(ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                          col_tile_start, col_end, row_end, *, block_r: int,
                          block_m: int, criterion: str, so_mode: str, s_max: float,
                          inv_norm: float, sa_s=None, sa2_s=None,
                          threshold: float = 0.0, t_n: int = 4, splits=None, n=None):
    """K2's hand-written CUDA kernel, with the arguments and result of
    ``search_classed2d_torch``.

    CPU tensors run the plain version.  CUDA tensors launch
    ``csrc/search_classed2d.cu``'s instance for n and the operands' width
    (and add one to ``search_classed2d_cuda.launches[(mode, width,
    frontier)]``), or raise ``ValueError`` for operands no instance takes.
    The launch reads nothing back: the grid and the partials are sized from
    the shapes (``_k2_plan``), and the split width and the (range tile,
    split) work list are made on the device (``_k2_work``; ``splits``,
    columns per split, None: chosen there to fill the card).  The plan of
    the last launch is kept in ``search_classed2d_cuda.plan``: the host's
    step, work items the grid runs over, range tiles and partials' bytes,
    and the device's ``width``, ``splits`` (each tile's) and ``work`` (their
    sum): reading them waits for the launch.
    """
    kw = dict(block_r=block_r, block_m=block_m, criterion=criterion,
              so_mode=so_mode, s_max=s_max, inv_norm=inv_norm, sa_s=sa_s,
              sa2_s=sa2_s, threshold=threshold, t_n=t_n, splits=splits, n=n)
    if ai_s.device.type == "cpu":
        return search_classed2d_torch(ai_s, ch_s, cl_s, sb_s, aux_s, tile_class,
                                      col_tile_start, col_end, row_end, **kw)
    key, head, keys = _classed_launch_args(
        "search_classed2d", ai_s, ch_s, cl_s, sb_s, aux_s, tile_class, col_tile_start,
        col_end, row_end, block_r, block_m, criterion, so_mode, s_max, inv_norm,
        sa_s, sa2_s, threshold, t_n, n)
    dev = ai_s.device
    nrt = tile_class.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    step, items = _k2_plan(nrt, ch_s.shape[0], block_r, ai_s.shape[1], key[2], t_n, splits,
                           sms)
    width, n, work, n_work, first = _k2_work(tile_class, col_tile_start, col_end,
                                          block_m=block_m, block_r=block_r,
                                          m_pad=ch_s.shape[0], step=step, items=items,
                                          auto=splits is None, sms=sms)
    # the partials (q, idx, hit) of every row of a work item
    part = [torch.empty((items * block_r,), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.uint8)]
    out = _launch("search_classed2d", key, ai_s.shape[0], dev, *head, items, *keys,
                  width.data_ptr(), n_work.data_ptr(), work.data_ptr(), first.data_ptr(),
                  *(t.data_ptr() for t in part))
    search_classed2d_cuda.launches[key] += 1
    search_classed2d_cuda.plan = dict(step=step, items=items, tiles=nrt,
                                      partial_bytes=9 * items * block_r, width=width,
                                      splits=n, work=n_work)
    return out


def search_dense_cuda(ai, ch, cl, sb, aux, *, m_valid: int, criterion: str,
                      so_mode: str, s_max: float, inv_norm: float, sa=None,
                      sa2=None, rcls=None, ccls=None, threshold: float = 0.0,
                      t_n: int = 4, n=None):
    """K3's hand-written CUDA kernel, with the arguments and result of
    ``search_dense_torch``.

    CPU tensors run the plain version.  CUDA tensors launch
    ``csrc/search_dense.cu``'s instance for n and the operands' width (and
    add one to ``search_dense_cuda.launches[(mode, width, frontier,
    masked)]``, masked whether the class mask is given), or raise
    ``ValueError`` for operands no instance takes.
    """
    kw = dict(m_valid=m_valid, criterion=criterion, so_mode=so_mode,
              s_max=s_max, inv_norm=inv_norm, sa=sa, sa2=sa2, rcls=rcls,
              ccls=ccls, threshold=threshold, t_n=t_n, n=n)
    if ai.device.type == "cpu":
        return search_dense_torch(ai, ch, cl, sb, aux, **kw)
    mode, width, n = _launch_mode(ai, n, criterion, so_mode, s_max)
    k = ai.shape[1]
    rows, m = ai.shape[0], ch.shape[0]
    dev = ai.device
    if not 0 <= m_valid <= m:
        raise ValueError(f"m_valid {m_valid} outside [0, {m}]")
    if (rcls is None) != (ccls is None):
        raise ValueError("the class mask needs both rcls and ccls")
    _check("ai", ai, torch.int8, (rows, k), dev)
    _check("ch", ch, torch.int8, (m, k), dev)
    _check("cl", cl, torch.int8, (m, k), dev)
    _check("sb", sb, sum_dtype(n), (m,), dev)
    _check("aux", aux, _aux_dtype(mode, n), (m,), dev)
    if rcls is not None:
        _check("rcls", rcls, torch.int32, (rows,), dev)
        _check("ccls", ccls, torch.int32, (m,), dev)
        cls = (rcls.data_ptr(), ccls.data_ptr())
    else:
        cls = (None, None)
    key = (mode, width, threshold > 0.0, rcls is not None)
    args = _key_args(mode, width, n, k, sa, sa2, rows, dev, so_mode=so_mode, s_max=s_max,
                     inv_norm=inv_norm, threshold=threshold, t_n=t_n)
    out = _launch("search_dense", key[:3], rows, dev,
                  ai.data_ptr(), ch.data_ptr(), cl.data_ptr(), sb.data_ptr(),
                  aux.data_ptr(), *cls, rows, m_valid, *args)
    search_dense_cuda.launches[key] += 1
    return out


# launch counts by (mode, width, frontier); K3's also by whether it was masked
search_classed_cuda.launches = {(mode, k, thr): 0 for mode, ks in KERNEL_KEYS.items()
                                for k in ks for thr in (False, True)}
search_classed2d_cuda.launches = dict(search_classed_cuda.launches)
search_classed2d_cuda.plan = None
search_dense_cuda.launches = {(*key, masked): 0 for key in search_classed_cuda.launches
                              for masked in (False, True)}
