"""Transform matching (port of ``fractencode_tpu/encode/matcher.py``).

The search ranks every (range, domain, isometry) pair by a key built from
the five sums SumA, SumA2, SumB, SumB2 and SumAB.  Two searches:

``search_classed`` keeps only pairs whose ranges and domains share a
brightness class, in three stages, as the JAX package's
``search_pallas_classed`` does:

  * ``classed_prep``: a counting sort lays ranges and codebook columns out
    by class in tile-aligned segments and converts them to the kernel's
    int8 operands; it also takes the JAX package's route between its two
    class-blocked kernels (K1, or K2 where K1's pair list would overflow),
    on the device where the class counts decide it;
  * ``classed_kernel``: the search over each range tile's class segment
    (``ops.matcher_kernels``, K1 or K2 by the route: the CUDA kernel or its
    plain version; both give the same result; where the device decides, the
    card runs both, the untaken one over empty segments, as the JAX
    package's ``lax.cond`` compiles both);
  * ``classed_post``: unsorts the winners and solves (s, o) for each.

``search_dense`` (the JAX package's ``search_pallas``) ranks every pair, for
the search without the classifier: the int8 operands in search order, the
dense search (K3) and the same winner solve.

``search`` is the dense oracle (the JAX package's ``search``): every pair's
distance, key and (s, o) as plain tensors, the winner picked by
``select_best``, which applies the early-accept frontier in the reference's
own terms (first hit domain, first hit isometry).  It is a second,
independent form of the frontier that the kernels' paths do not use.

Search-order columns are ``m = d*T + (T-1-t)`` and ties go to the first
maximum, which is the reference's tie rule (domain ascending, later
transform wins, ``transformmatcher.h:57,67``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import matcher_kernels as _mk
from ..ops.matcher_kernels import (CT_BITS, DEFAULT_BM, DEFAULT_BR, INT8_MAX_K,
                                   PAIR_TILE_M, PAIR_TILE_R, _rank_tile,
                                   _require_exact_sums, inv_var_b, kernel_width,
                                   key_sum_sq, rank_mode, sum_dtype,
                                   rank_to_dist, search_classed2d_cuda,
                                   search_classed2d_torch, search_classed_cuda,
                                   search_classed_torch, search_dense_cuda,
                                   search_dense_torch)
from ..params import EncoderConfig
from ..utils.profiling import mark
from .codebook import Codebook

__all__ = ["SearchResult", "solve_so", "inv_norm", "select_best", "search", "classed_prep",
           "classed_kernel", "classed_post", "mask_ranges_result", "search_classed",
           "dense_prep", "dense_kernel", "search_dense", "replays_graph"]

_BIG = 3.0e38
_NUM_CLASS_BINS = 7  # classifier bins -1..5 shifted to 0..6


@dataclasses.dataclass
class SearchResult:
    """Per-range best match. All tensors [R]."""

    domain_idx: torch.Tensor  # i32, row-major index into the domain grid
    transform: torch.Tensor  # i32, TransformType value
    distance: torch.Tensor  # f32, in the configured criterion's units
    s: torch.Tensor  # f32 contrast
    o: torch.Tensor  # f32 brightness
    valid: torch.Tensor  # bool — False if the classifier rejected every domain
    key: torch.Tensor | None = None  # f32 maximized rank key of the winner


def solve_so(sum_a, sum_a2, sum_b, sum_b2, sum_ab, n: float, so_mode: str,
             s_max: float):
    """Solve the affine brightness map from the five sums.

    'reference' reproduces ``transformmatcher.h:103-105`` (with its
    ``(SumA-1)*SumA`` denominator); 'ls' is the least-squares fit of
    ``range ~ s*domain + o``.  Numerator and denominator are integers (scaled
    by 4 and 16), formed in int64 and rounded once to f32, so ``s`` is one
    correctly rounded division of them.  For n <= INT8_MAX_K the integers
    are rebuilt from the f32 sums, as the JAX package does (16*SumB2 from
    the rounded f32 SumB2 at n = 64); above, ``sum_ab`` and ``sum_b2`` must
    be the exact float64 sums (the port's exact rule above n = 64, where the
    JAX package solves in f32), and above F32_SUMS_MAX_K ``sum_a``,
    ``sum_a2`` and ``sum_b`` are float64 too (``sum_dtype``).  ``o`` is
    formed with one rounding, as the fused multiply-add that XLA:CPU emits
    for the JAX package: ``SumA - s*SumB`` is exact in float64 (s has 24
    significant bits, the sums are multiples of 0.25 below 2^29 while
    n <= MAX_SLAB_N), then rounded once to f32 and multiplied by the f32
    reciprocal of n (XLA:CPU compiles the division by the constant n so; for
    n a power of two the two agree).
    """
    _require_exact_sums(n, sum_ab=sum_ab, sum_b2=sum_b2)
    ni = int(n)
    sa_i = sum_a.to(torch.int64)
    sb4 = (4.0 * sum_b).to(torch.int64)
    ab4 = (4.0 * sum_ab).to(torch.int64)
    num4 = (ni * ab4 - sa_i * sb4).to(torch.float32)  # 4*num, exact
    if so_mode == "reference":
        sa2_i = sum_a2.to(torch.int64)
        den = (ni * sa2_i - (sa_i - 1) * sa_i).to(torch.float32)  # exact
        s = torch.where(den.abs() < 1e-5, 0.0,
                        (num4 * 0.25) / torch.where(den == 0, 1.0, den))
    else:
        sb2_16 = (16.0 * sum_b2).to(torch.int64)
        den16 = (ni * sb2_16 - sb4 * sb4).to(torch.float32)  # 16*den
        s = torch.where(den16 == 0, 0.0,
                        (num4 * 4.0) / torch.where(den16 == 0, 1.0, den16))
    if s_max > 0.0:
        s = s.clamp(-s_max, s_max)
    s64 = s.to(torch.float64)
    if so_mode == "reference":
        o = (sum_b.to(torch.float64) - s64 * sum_a.to(torch.float64))
    else:
        o = (sum_a.to(torch.float64) - s64 * sum_b.to(torch.float64))
    return s, o.to(torch.float32) * (1.0 / n)


def inv_norm(cfg: EncoderConfig, k: int, domain_area: int) -> float:
    """The distance's normalisation: 1/(domain area) for the 'raw'
    criterion, 1/K otherwise."""
    return 1.0 / domain_area if cfg.criterion == "raw" else 1.0 / k


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _class_layout(classes01: torch.Tensor, block: int,
                  num_bins: int = _NUM_CLASS_BINS):
    """Tile-aligned class-sorted layout for items in classes 0..num_bins-1.

    A counting sort: each item's destination is its class segment's start
    plus its rank within the class (stable).  Segments start on multiples of
    ``block``.  Returns (pos [n] destination of each item, seg_start
    [num_bins+1], counts [num_bins+1] — the extra entry is an empty bin —
    and tile_cum [num_bins] cumulative tile counts).
    """
    # [num_bins, n]: the per-class running count is a scan along the long
    # inner axis (a scan down the 7-wide outer axis of [n, num_bins] took
    # 46 ms for 262,144 items on an H100)
    onehot = (classes01[None, :] == torch.arange(
        num_bins, dtype=classes01.dtype, device=classes01.device)[:, None]).to(torch.int32)
    csum = torch.cumsum(onehot, 1, dtype=torch.int32)  # inclusive per-class counts
    counts = csum[:, -1]
    tiles = -(-counts // block)
    tile_cum = torch.cumsum(tiles, 0, dtype=torch.int32)
    seg_start = torch.cat([tile_cum.new_zeros(1), tile_cum[:-1]]) * block
    rank = (onehot * csum).sum(0, dtype=torch.int32) - 1
    pos = (onehot * seg_start[:, None]).sum(0, dtype=torch.int32) + rank
    zero = counts.new_zeros(1)
    return pos, torch.cat([seg_start, zero]), torch.cat([counts, zero]), tile_cum


def _int8_operands(ranges, cb: Codebook):
    """The int8 operands (matcher_pallas._int8_operands) in search order
    m = d*T + (T-1-t), each row padded with zero bytes from n, the range's
    pixel count, to the kernels' width K = ``kernel_width(n)``: ai = A - 128
    [R, K] and the split ch = b4 >> 3, cl = b4 & 7 [m, K] i8 of the 10-bit
    b4 = 4B; and b4 itself [m, n] i16, unpadded."""
    d, t, n = cb.values.shape
    b4_cols = torch.round(cb.values.flip(1).reshape(d * t, n) * 4.0).to(torch.int16)
    ai = (ranges.to(torch.int32) - 128).to(torch.int8)
    ch, cl = (b4_cols >> 3).to(torch.int8), (b4_cols & 7).to(torch.int8)
    k = kernel_width(n)
    if k > n:
        ai, ch, cl = (torch.nn.functional.pad(x, (0, k - n)) for x in (ai, ch, cl))
    return ai, ch, cl, b4_cols


def _column_sums(b4, mode: str, n: int):
    """Per-column SumB and the key's aux (inv_var_b for 'ls', SumB2
    otherwise) of the integer columns b4 = 4B [M, K] i32 of ranges of n
    pixels (zero past n): every sum is an exact integer, rounded once, as the
    JAX package's cb.sum and cb.sum_sq (see ``key_sum_sq`` for SumB2, and
    ``sum_dtype`` for SumB)."""
    sb = b4.sum(1, dtype=torch.int64).to(sum_dtype(n)) * 0.25
    sb2 = key_sum_sq((b4 * b4).sum(1, dtype=torch.int64), n)
    return sb, inv_var_b(sb, sb2, n) if mode == "ls" else sb2


def _tiles(r: int, m: int, n_row_bins: int, n_col_bins: int, block_r: int,
           block_m: int):
    """(block_r, block_m, r_pad, m_pad) of a class-sorted layout: room for
    every class's alignment waste plus the reserved bins."""
    block_r = min(block_r, _round_up(r, 8))
    block_m = min(block_m, _round_up(m, 128))
    return (block_r, block_m, _round_up(r, block_r) + n_row_bins * block_r,
            _round_up(m, block_m) + n_col_bins * block_m)


def _classed_statics(r: int, m: int, masked_domains: bool = False,
                     masked_ranges: bool = False, block_r: int | None = None,
                     block_m: int | None = None):
    """(block_r, block_m, r_pad, m_pad, worst_pairs, p_cap, use_pairs).

    The first four are the class-sorted layout's.  ``block_r``/``block_m``
    default to the port's tiles (``DEFAULT_BR``, ``DEFAULT_BM``); the padded
    buffers have room for every class's alignment waste plus one reserved
    bin for masked domains or ranges.  The last three are the JAX package's
    route (``fractencode_tpu/encode/matcher.py:253-285``), at its tiles
    (``PAIR_TILE_R``, ``PAIR_TILE_M``) whatever the port's: the length of
    its pair list in the worst case, the list's cap, and whether the
    column-tile index fits the list's field at all (below 16K planes).
    """
    n_col_bins = _NUM_CLASS_BINS + (1 if masked_domains else 0)
    n_row_bins = _NUM_CLASS_BINS + (1 if masked_ranges else 0)
    layout = _tiles(r, m, n_row_bins, n_col_bins, block_r or DEFAULT_BR,
                    block_m or DEFAULT_BM)
    pbr, pbm, pr_pad, pm_pad = _tiles(r, m, n_row_bins, n_col_bins, PAIR_TILE_R,
                                      PAIR_TILE_M)
    use_pairs = pm_pad // pbm < (1 << CT_BITS)
    worst_pairs = (pr_pad // pbr) * (pm_pad // pbm) + pr_pad // pbr
    return (*layout, worst_pairs, min(worst_pairs, _mk.PAIR_CAP), use_pairs)


def replays_graph(r: int, m: int, cfg: EncoderConfig, device) -> bool:
    """Whether the search of ``r`` ranges against ``m`` search-order
    columns under ``cfg`` on ``device`` runs inside a CUDA graph
    (``utils.graphs``): a card under backend 'auto' or 'cuda', and a search
    with rows and columns.  Every route reads nothing back there: the dense
    search (K3), K1, K2 (its plan from the shapes) and the route the class
    counts decide (both kernels, ``classed_kernel``)."""
    return (torch.device(device).type == "cuda" and cfg.backend != "torch"
            and r > 0 and m > 0)


def _pair_count(r_counts, c_counts, r: int, m: int, n_row_bins: int,
                n_col_bins: int) -> torch.Tensor:
    """The length of the JAX package's pair list, its ``n_pairs``
    (``fractencode_tpu/encode/matcher.py:504-509``), a 0-d int64 tensor on
    the counts' device: at its tiles, every range tile of a class pairs with
    each column tile of that class, or with one dummy where there is none,
    and every other range tile (padding, masked ranges) with one.
    ``r_counts``/``c_counts``: the ranges and columns of the class bins."""
    pbr, pbm, pr_pad, _ = _tiles(r, m, n_row_bins, n_col_bins, PAIR_TILE_R, PAIR_TILE_M)
    rc = r_counts[:_NUM_CLASS_BINS].to(torch.int64)
    cc = c_counts[:_NUM_CLASS_BINS].to(torch.int64)
    tiles = -(-rc // pbr)
    pairs = (tiles * (-(-cc // pbm)).clamp_min(1)).sum()
    return pairs + (pr_pad // pbr - tiles.sum())


def classed_prep(ranges, sum_a, sum_a2, cb: Codebook, range_classes,
                 domain_classes, cfg: EncoderConfig, domain_mask=None,
                 range_mask=None, block_r: int | None = None,
                 block_m: int | None = None, force_no_pairs: bool = False) -> dict:
    """Class-sorted layout and int8 operands: every tensor the search takes,
    plus the inverse maps ``classed_post`` needs, and the route.

    The route is the JAX package's (``fractencode_tpu/encode/matcher.py:
    590-602``): K2 (``search_classed2d``) where its pair list cannot be used
    (``use_pairs`` False, 16K planes and up) or where ``force_no_pairs``
    asks for it; K1 (``search_classed``) where the list fits in every case;
    and where it could overflow its cap (``worst_pairs > PAIR_CAP``, 4K
    planes and up), ``counted``: the layout's ``n_pairs`` decides on the
    device, K2 where ``take_k2 = n_pairs > p_cap`` (the negation of the JAX
    package's ``lax.cond`` predicate), K1 otherwise.  Nothing is read back.

    ``domain_mask`` ([D] bool) parks geometry-invalid domains in a reserved
    column bin no range tile visits; ``range_mask`` ([R] bool) parks excluded
    ranges in a reserved row bin whose tiles visit the empty column bin.

    Returns a dict with ai_s [r_pad, K] i8; ch_s, cl_s [m_pad, K] i8
    (K = ``kernel_width(n)``, n the range's pixel count, zero past n); sb_s,
    aux_s [m_pad]; sa_s, sa2_s [r_pad] (for the 'general' key and the
    frontier, else None; the sums in ``sum_dtype(n)``, aux as the key reads
    it); tile_class [nrt] i32; col_tile_start, col_tile_count, col_end
    and row_end (the end of each class's real rows, 0 past the classes)
    [n_col_bins+1] i32; rpos [R]; inv_dom [m_pad/T] or inv_col [m_pad]; and
    b4_cols [m, K] i16 (4x the codebook values in search order); route
    ('search_classed', 'search_classed2d' or 'counted'); n_pairs (0-d i64)
    and take_k2 (0-d bool) on the device for the 'counted' route, else
    None; worst_pairs, p_cap and use_pairs.
    """
    r, n = ranges.shape
    d, t, _ = cb.values.shape
    m = d * t
    dev = ranges.device
    masked = domain_mask is not None
    r_masked = range_mask is not None
    n_col_bins = _NUM_CLASS_BINS + (1 if masked else 0)
    n_row_bins = _NUM_CLASS_BINS + (1 if r_masked else 0)
    block_r, block_m, r_pad, m_pad, worst_pairs, p_cap, use_pairs = _classed_statics(
        r, m, masked, r_masked, block_r, block_m)

    rcls01 = (range_classes + 1).to(torch.int32)  # bins -1..5 -> 0..6
    dcls01 = (domain_classes + 1).to(torch.int32)
    if masked:
        dcls01 = torch.where(domain_mask, dcls01, _NUM_CLASS_BINS)
    if r_masked:
        rcls01 = torch.where(range_mask, rcls01, _NUM_CLASS_BINS)

    rpos, r_seg_start, r_counts, r_tile_cum = _class_layout(rcls01, block_r, n_row_bins)

    def inverse(pos, size, fill):
        inv = torch.full((size,), fill, dtype=torch.int64, device=dev)
        inv[pos.to(torch.int64)] = torch.arange(pos.shape[0], device=dev)
        return inv

    ai, ch, cl, b4_cols = _int8_operands(ranges, cb)
    k = ai.shape[1]  # the operands' width
    inv_r = inverse(rpos, r_pad, r)
    ai_s = torch.cat([ai, ai.new_zeros(1, k)])[inv_r]

    if block_m % t == 0:
        # Domain-granularity layout: all T isometries of a domain share its
        # class and occupy T consecutive columns, and segments are
        # block_m-aligned, so the column layout is the domain layout expanded
        # T-fold; one row gather moves both operands.
        dpos, d_seg_start, d_counts, _ = _class_layout(dcls01, block_m // t, n_col_bins)
        inv_dom = inverse(dpos, m_pad // t, d)
        inv_col = None
        c_seg_start = d_seg_start * t
        c_counts = d_counts * t
        packed = torch.cat([ch.reshape(d, t * k), cl.reshape(d, t * k)], 1)
        packed_s = torch.cat([packed, packed.new_zeros(1, 2 * t * k)])[inv_dom]
        # at one isometry the reshapes are strided views: the kernels take
        # contiguous operands
        ch_s = packed_s[:, :t * k].reshape(m_pad, k).contiguous()
        cl_s = packed_s[:, t * k:].reshape(m_pad, k).contiguous()
    else:
        ccls01 = torch.repeat_interleave(dcls01, t)
        cpos, c_seg_start, c_counts, _ = _class_layout(ccls01, block_m, n_col_bins)
        inv_col = inverse(cpos, m_pad, m)
        inv_dom = None
        ch_s = torch.cat([ch, ch.new_zeros(1, k)])[inv_col]
        cl_s = torch.cat([cl, cl.new_zeros(1, k)])[inv_col]

    # sorted per-column sums (padding rows are zero, so their sums are 0)
    mode = rank_mode(cfg.criterion, cfg.so_mode, cfg.s_max)
    sb_s, aux_s = _column_sums(8 * ch_s.to(torch.int32) + cl_s.to(torch.int32), mode, n)
    if mode == "general" or cfg.rms_threshold > 0.0:
        zero = sum_a.new_zeros(1)
        sa_s = torch.cat([sum_a, zero])[inv_r]
        sa2_s = torch.cat([sum_a2, zero])[inv_r]
    else:
        sa_s = sa2_s = None

    # per-range-tile class; tiles past the last class bin (padding, masked
    # ranges) point at the appended empty column bin
    nrt = r_pad // block_r
    tile_ids = torch.arange(nrt, dtype=torch.int32, device=dev)
    tile_class = torch.searchsorted(r_tile_cum, tile_ids, right=True).to(torch.int32)
    tile_class = torch.where(tile_class >= _NUM_CLASS_BINS, n_col_bins, tile_class)
    col_tile_start = (c_seg_start // block_m).to(torch.int32)
    col_tile_count = (-(-c_counts // block_m)).to(torch.int32)
    col_end = (c_seg_start + c_counts).to(torch.int32)
    row_end = torch.zeros_like(col_end)
    row_end[:_NUM_CLASS_BINS] = (r_seg_start + r_counts)[:_NUM_CLASS_BINS]

    n_pairs = take_k2 = None
    if not use_pairs or force_no_pairs:
        route = "search_classed2d"
    elif worst_pairs > _mk.PAIR_CAP:
        route = "counted"
        n_pairs = _pair_count(r_counts, c_counts, r, m, n_row_bins, n_col_bins)
        take_k2 = n_pairs > p_cap
    else:
        route = "search_classed"
    return dict(ai_s=ai_s, ch_s=ch_s, cl_s=cl_s, sb_s=sb_s, aux_s=aux_s,
                sa_s=sa_s, sa2_s=sa2_s, b4_cols=b4_cols,
                tile_class=tile_class, col_tile_start=col_tile_start,
                col_tile_count=col_tile_count, col_end=col_end, row_end=row_end,
                rpos=rpos, inv_col=inv_col, inv_dom=inv_dom,
                block_r=block_r, block_m=block_m, route=route, n_pairs=n_pairs,
                take_k2=take_k2, worst_pairs=worst_pairs, p_cap=p_cap,
                use_pairs=use_pairs)


def _plain_only(cfg: EncoderConfig, scanned) -> dict:
    """The plain version's ``scanned`` keyword, which only backend 'torch'
    takes (it counts the pairs each row needs, for a kernel's bound)."""
    if scanned is None:
        return {}
    if cfg.backend != "torch":
        raise ValueError("scanned is counted by the plain version: backend='torch'")
    return dict(scanned=scanned)


def classed_kernel(prep: dict, k: int, domain_area: int, cfg: EncoderConfig,
                   scanned=None, splits=None):
    """Run the search on prepped tensors; (q_s, idx_s) in the sorted layout.

    ``prep['route']`` picks K1 or K2.  ``cfg.backend`` 'torch' forces the
    plain version; otherwise the CUDA wrapper routes on the device (CPU
    tensors run the plain version), and 'cuda' requires CUDA tensors.  The
    'counted' route is the JAX package's ``lax.cond`` on ``take_k2``: on the
    card both kernels launch, the untaken one over empty segments
    (``_counted``), and the taken one's result is kept, so nothing is read
    back; the plain version reads the flag and runs the taken search alone.
    ``scanned`` (backend 'torch' only): see ``ops.matcher_kernels.
    _plain_search``.  ``splits`` (K2 only): its columns per split, chosen
    by the wrapper when None.
    """
    if cfg.backend == "cuda" and prep["ai_s"].device.type != "cuda":
        raise ValueError("backend='cuda' needs tensors on a CUDA device")
    plain = cfg.backend == "torch"
    route = prep["route"]
    if route == "counted" and (plain or prep["ai_s"].device.type != "cuda"):
        route = "search_classed2d" if bool(prep["take_k2"]) else "search_classed"
    if splits is not None and route == "search_classed":
        raise ValueError("splits is K2's: the route is K1")
    args, kw = _search_args(prep, k, domain_area, cfg, _plain_only(cfg, scanned))
    if route == "counted":
        return _counted(prep, args, kw, splits)
    if route == "search_classed2d":
        return (search_classed2d_torch if plain else search_classed2d_cuda)(
            *args, splits=splits, **kw)
    return (search_classed_torch if plain else search_classed_cuda)(*args, **kw)


def _search_args(prep: dict, k: int, domain_area: int, cfg: EncoderConfig, extra: dict):
    """The positional and keyword arguments K1 and K2 take for ``prep``
    (``col_end`` eighth)."""
    args = (prep["ai_s"], prep["ch_s"], prep["cl_s"], prep["sb_s"], prep["aux_s"],
            prep["tile_class"], prep["col_tile_start"], prep["col_end"], prep["row_end"])
    kw = dict(block_r=prep["block_r"], block_m=prep["block_m"],
              criterion=cfg.criterion, so_mode=cfg.so_mode, s_max=cfg.s_max,
              inv_norm=inv_norm(cfg, k, domain_area), sa_s=prep["sa_s"],
              sa2_s=prep["sa2_s"], threshold=cfg.rms_threshold, t_n=cfg.num_transforms,
              n=k, **extra)
    return args, kw


def _counted(prep: dict, args: tuple, kw: dict, splits=None):
    """The 'counted' route without a host read, the counterpart of the JAX
    package's ``lax.cond(n_pairs <= p_cap, K1, K2)``: K1 and K2 (their
    wrappers) each on a copy of ``col_end`` in which the untaken route's
    class segments end where they start, so that kernel scans no column and
    writes the initial (q, idx) to every row; the taken one's result is
    kept by ``take_k2``."""
    start = prep["col_tile_start"] * prep["block_m"]
    end, flag = prep["col_end"], prep["take_k2"]
    q1, i1 = search_classed_cuda(*args[:7], torch.where(flag, start, end), *args[8:], **kw)
    q2, i2 = search_classed2d_cuda(*args[:7], torch.where(flag, end, start), *args[8:],
                                   splits=splits, **kw)
    return torch.where(flag, q2, q1), torch.where(flag, i2, i1)


def classed_post(q_s, idx_s, rpos, inv_col, ranges, sum_a, sum_a2, cb: Codebook,
                 cfg: EncoderConfig, b4_cols, inv_dom=None) -> SearchResult:
    """Map sorted-layout search outputs back to range order and solve (s, o)
    for the winners (``_winners``).

    The key becomes a distance after unsorting, against the range-order sums
    (elementwise, so the same values as converting before).
    """
    k = ranges.shape[1]
    d, t, _ = cb.values.shape
    m = d * t
    m_pad = inv_col.shape[0] if inv_col is not None else inv_dom.shape[0] * t
    rpos = rpos.to(torch.int64)
    q_r = q_s[rpos]
    win_sorted = idx_s[rpos].to(torch.int64)
    dist = rank_to_dist(q_r, sum_a2, sum_a, criterion=cfg.criterion,
                        so_mode=cfg.so_mode, s_max=cfg.s_max,
                        inv_norm=inv_norm(cfg, k, cb.grid.block_size ** 2), n=float(k))
    valid = dist < _BIG
    ws = win_sorted.clamp(0, m_pad - 1)
    if inv_dom is not None:
        # column c holds domain inv_dom[c // T], isometry column c % T
        wd = inv_dom[ws // t]
        wcol = torch.where(wd == d, m, wd * t + ws % t)
    else:
        wcol = inv_col[ws]
    win_m = torch.where(valid, wcol, 0).clamp(0, m - 1)
    return _winners(ranges, sum_a, sum_a2, b4_cols, win_m, t, dist, q_r, cfg)


def _winners(ranges, sum_a, sum_a2, b4_cols, win_m, t: int, dist, key,
             cfg: EncoderConfig) -> SearchResult:
    """The SearchResult of search-order winners ``win_m`` (i64 [R]), with
    (s, o) solved from the exact integer sums over each winner's b4 row
    (``b4_cols``: 4x the codebook values in search order): as the f32
    values of the JAX package's codebook for n <= INT8_MAX_K (SumB2 rounded
    once, as ``cb.sum_sq``), exact in float64 above (see ``solve_so``)."""
    k = ranges.shape[1]
    valid = dist < _BIG
    # every sum is an exact integer, in int64 (16*SumB2 <= n*1020^2 passes
    # 2^31 above n = 2064, 4*SumAB <= n*255*1020 above n = 8256)
    b4_win = b4_cols[win_m].to(torch.int32)  # [R, k]
    ab4 = (ranges.to(torch.int32) * b4_win).sum(-1, dtype=torch.int64)
    sum_ab = ab4.to(torch.float32 if k <= INT8_MAX_K else torch.float64) * 0.25
    sb_win = b4_win.sum(-1, dtype=torch.int64).to(sum_dtype(k)) * 0.25
    sb2_win = key_sum_sq((b4_win * b4_win).sum(-1, dtype=torch.int64), float(k))
    s, o = solve_so(sum_a, sum_a2, sb_win, sb2_win, sum_ab, float(k),
                    cfg.so_mode, cfg.s_max)
    return SearchResult(
        domain_idx=(win_m // t).to(torch.int32),
        transform=((t - 1) - win_m % t).to(torch.int32),
        distance=dist, s=torch.where(valid, s, 0.0), o=torch.where(valid, o, 0.0),
        valid=valid, key=key)


def mask_ranges_result(res: SearchResult, range_mask: torch.Tensor) -> SearchResult:
    """Canonical fields for ranges excluded by ``range_mask`` (False = out)."""
    return SearchResult(
        domain_idx=torch.where(range_mask, res.domain_idx, 0),
        transform=torch.where(range_mask, res.transform, 0),
        distance=torch.where(range_mask, res.distance, _BIG),
        s=torch.where(range_mask, res.s, 0.0),
        o=torch.where(range_mask, res.o, 0.0),
        valid=res.valid & range_mask,
        key=None if res.key is None else torch.where(range_mask, res.key, -_BIG),
    )


def search_classed(ranges, sum_a, sum_a2, cb: Codebook, range_classes,
                   domain_classes, cfg: EncoderConfig, domain_mask=None,
                   range_mask=None, block_r: int | None = None,
                   block_m: int | None = None,
                   force_no_pairs: bool = False) -> SearchResult:
    """Class-blocked search (the counterpart of ``search_pallas_classed``):
    only same-class pairs compete, with the reference's tie-break order.
    ``force_no_pairs`` takes K2 whatever the route (``classed_prep``)."""
    k = ranges.shape[1]
    mark("prep", ranges)
    prep = classed_prep(ranges, sum_a, sum_a2, cb, range_classes, domain_classes,
                        cfg, domain_mask=domain_mask, range_mask=range_mask,
                        block_r=block_r, block_m=block_m, force_no_pairs=force_no_pairs)
    mark("search", ranges)
    q_s, idx_s = classed_kernel(prep, k, cb.grid.block_size ** 2, cfg)
    mark("post", ranges)
    res = classed_post(q_s, idx_s, prep["rpos"], prep["inv_col"], ranges, sum_a,
                       sum_a2, cb, cfg, b4_cols=prep["b4_cols"],
                       inv_dom=prep["inv_dom"])
    if range_mask is not None:
        res = mask_ranges_result(res, range_mask)
    return res


def dense_prep(ranges, sum_a, sum_a2, cb: Codebook, range_classes,
               domain_classes, cfg: EncoderConfig) -> dict:
    """The dense search's operands, columns in search order: ai [R, K] i8;
    ch, cl [M, K] i8; sb, aux [M] f32; sa, sa2 [R] f32 (for the 'general' key
    and the frontier, else None); rcls [R], ccls [M] i32, the class mask, with
    ``cfg.use_classifier`` and both class arrays given (else None); and
    b4_cols [M, n] i16 (4x the codebook values); the operands and sums as
    ``classed_prep``'s."""
    t = cb.values.shape[1]
    ai, ch, cl, b4_cols = _int8_operands(ranges, cb)
    mode = rank_mode(cfg.criterion, cfg.so_mode, cfg.s_max)
    sb, aux = _column_sums(b4_cols.to(torch.int32), mode, ranges.shape[1])
    if cfg.use_classifier and range_classes is not None:
        rcls = range_classes.to(torch.int32)
        ccls = torch.repeat_interleave(domain_classes.to(torch.int32), t)
    else:
        rcls = ccls = None
    sums = mode == "general" or cfg.rms_threshold > 0.0
    return dict(ai=ai, ch=ch, cl=cl, sb=sb, aux=aux, rcls=rcls, ccls=ccls,
                sa=sum_a if sums else None, sa2=sum_a2 if sums else None,
                b4_cols=b4_cols)


def dense_kernel(prep: dict, k: int, domain_area: int, cfg: EncoderConfig,
                 scanned=None):
    """Run the dense search on ``dense_prep``'s tensors: (q, idx) per range,
    idx a search-order column.  ``cfg.backend`` routes, and ``scanned`` is
    taken, as in ``classed_kernel``."""
    if cfg.backend == "cuda" and prep["ai"].device.type != "cuda":
        raise ValueError("backend='cuda' needs tensors on a CUDA device")
    search = search_dense_torch if cfg.backend == "torch" else search_dense_cuda
    return search(
        prep["ai"], prep["ch"], prep["cl"], prep["sb"], prep["aux"],
        m_valid=prep["ch"].shape[0], criterion=cfg.criterion, so_mode=cfg.so_mode,
        s_max=cfg.s_max, inv_norm=inv_norm(cfg, k, domain_area),
        sa=prep["sa"], sa2=prep["sa2"], rcls=prep["rcls"], ccls=prep["ccls"],
        threshold=cfg.rms_threshold, t_n=cfg.num_transforms, n=k,
        **_plain_only(cfg, scanned))


def search_dense(ranges, sum_a, sum_a2, cb: Codebook, range_classes,
                 domain_classes, cfg: EncoderConfig) -> SearchResult:
    """Dense search (the counterpart of ``search_pallas``): every range
    against every (domain, isometry) column in search order, with the
    reference's tie-break order.  With ``cfg.use_classifier`` and both class
    arrays given, only same-class pairs compete (K3's per-element mask);
    otherwise every range is valid.  Winners come straight from the
    search-order index: domain ``m // T``, isometry ``(T-1) - m % T``.
    """
    k = ranges.shape[1]
    area = cb.grid.block_size ** 2
    mark("prep", ranges)
    prep = dense_prep(ranges, sum_a, sum_a2, cb, range_classes, domain_classes, cfg)
    mark("search", ranges)
    q, idx = dense_kernel(prep, k, area, cfg)
    mark("post", ranges)
    dist = rank_to_dist(q, sum_a2, sum_a, criterion=cfg.criterion,
                        so_mode=cfg.so_mode, s_max=cfg.s_max,
                        inv_norm=inv_norm(cfg, k, area), n=float(k))
    return _winners(ranges, sum_a, sum_a2, prep["b4_cols"], idx.to(torch.int64),
                    cb.values.shape[1], dist, q, cfg)


def _pair_scores(ranges, sum_a, sum_a2, cb: Codebook, cfg: EncoderConfig):
    """(dist, key, s, o) of a chunk of ranges against the whole codebook,
    each [RC, D, T] (the JAX package's ``_pair_scores``).  ``key`` is the
    minimized rank key, the negated key of the kernels; ``dist`` its
    distance.  SumAB comes exact from a float64 matmul (integers times
    multiples of 0.25), in f32 for n <= INT8_MAX_K and float64 above (the
    port's rule above n = 64), as do the codebook's SumB2 (``key_sum_sq``)."""
    k = ranges.shape[-1]
    n = float(k)
    d, t, _ = cb.values.shape
    mode = rank_mode(cfg.criterion, cfg.so_mode, cfg.s_max)
    exact = torch.float32 if k <= INT8_MAX_K else torch.float64
    flat_cb = cb.values.reshape(d * t, k).to(torch.float64)
    sum_ab = (ranges.to(torch.float64) @ flat_cb.T).to(exact).reshape(-1, d, t)
    b4 = torch.round(cb.values * 4.0).to(torch.int32)
    sb2 = key_sum_sq((b4 * b4).sum(-1, dtype=torch.int64), n)[None]
    sa, sa2, sb = sum_a[:, None, None], sum_a2[:, None, None], cb.sum[None]
    s, o = solve_so(sa, sa2, sb, sb2, sum_ab, n, cfg.so_mode, cfg.s_max)
    mode_kw = dict(criterion=cfg.criterion, so_mode=cfg.so_mode, s_max=cfg.s_max,
                   inv_norm=inv_norm(cfg, k, cb.grid.block_size ** 2), n=n)
    aux = cb.inv_var[None] if mode == "ls" else sb2
    q = _rank_tile(sum_ab, sa, sa2, sb, aux, **mode_kw)
    return rank_to_dist(q, sa2, sa, **mode_kw), -q, s, o


def select_best(dist, threshold: float, key=None):
    """Per-range winner with the reference's tie and early-accept rules
    (the JAX package's ``select_best``).

    dist [RC, D, T]; ``key`` (same shape, optional) is the minimized rank
    key that ranks and breaks ties, while the frontier reads ``dist``.  Let
    d* be the first domain whose best distance is <= f32(threshold) and t*
    its first isometry that is: the reference's scan never looks past (d*,
    t*), so every (d, t) beyond it is masked out, and the winner is the
    argmin of the key with ties to the lower domain, then the later
    isometry.  Returns (win_d, win_t) i32 [RC].
    """
    if key is None:
        key = dist
    rc, d, t = dist.shape
    dev = dist.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    hit = dist.amin(2) <= thr  # [RC, D]
    has_hit = hit.any(1)
    dstar = hit.to(torch.uint8).argmax(1)  # first hit domain (0 if none)
    thit = dist[torch.arange(rc, device=dev), dstar] <= thr  # [RC, T]
    tstar = thit.to(torch.uint8).argmax(1)  # first hit isometry
    d_ids = torch.arange(d, device=dev)[None, :, None]
    t_ids = torch.arange(t, device=dev)[None, None, :]
    dstar, tstar = dstar[:, None, None], tstar[:, None, None]
    beyond = (d_ids > dstar) | ((d_ids == dstar) & (t_ids > tstar))
    masked = torch.where(has_hit[:, None, None] & beyond, _BIG, key)
    # argmin in (domain asc, isometry desc) order: the first minimum wins
    flat_rev = masked.flip(2).reshape(rc, d * t).argmin(1)
    win_d = torch.div(flat_rev, t, rounding_mode="floor")
    win_t = (t - 1) - flat_rev % t
    return win_d.to(torch.int32), win_t.to(torch.int32)


def search(ranges, sum_a, sum_a2, cb: Codebook, range_classes, domain_classes,
           cfg: EncoderConfig, domain_mask=None, range_mask=None) -> SearchResult:
    """Best (domain, isometry, s, o) per range from every pair's scores (the
    JAX package's dense oracle ``search``), ``cfg.range_chunk`` ranges at a
    time.  With ``cfg.use_classifier`` and both class arrays given, only
    same-class pairs compete; ``domain_mask`` ([D] bool) rules domains out;
    ``range_mask`` ([R] bool) is applied after the search
    (``mask_ranges_result``)."""
    r = ranges.shape[0]
    use_classes = range_classes is not None and cfg.use_classifier
    parts = []
    for r0 in range(0, r, min(cfg.range_chunk, r)):
        rows = slice(r0, r0 + cfg.range_chunk)
        dist, key, s, o = _pair_scores(ranges[rows], sum_a[rows], sum_a2[rows], cb, cfg)
        out = torch.zeros(dist.shape[:2], dtype=torch.bool, device=dist.device)
        if use_classes:
            out |= range_classes[rows, None] != domain_classes[None, :]
        if domain_mask is not None:
            out |= ~domain_mask[None, :]
        dist = torch.where(out[:, :, None], _BIG, dist)
        key = torch.where(out[:, :, None], _BIG, key)
        win_d, win_t = select_best(dist, cfg.rms_threshold, key)
        at = (torch.arange(dist.shape[0], device=dist.device), win_d.long(), win_t.long())
        best = dist[at]
        valid = best < _BIG
        parts.append((win_d, win_t, best, torch.where(valid, s[at], 0.0),
                      torch.where(valid, o[at], 0.0), valid, -key[at]))
    win_d, win_t, best, s, o, valid, q = (torch.cat(x) for x in zip(*parts))
    res = SearchResult(domain_idx=win_d, transform=win_t, distance=best, s=s, o=o,
                       valid=valid, key=q)
    if range_mask is not None:
        res = mask_ranges_result(res, range_mask)
    return res
