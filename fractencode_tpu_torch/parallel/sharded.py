"""Sharded encode and decode over a device mesh (port of
``fractencode_tpu/parallel/sharded.py``).

One controller drives every shard, as ``shard_map`` drives every local
device (``mesh.py``): a Python loop issues each shard's work on its own
device, and the collectives are explicit tensor moves.

  * ``data`` axis — independent images: frame b goes to data shard
    b // (B / n_data), and its result to that shard's first device.
  * ``search`` axis, three strategies for one image:
      - **ranges** (default): each device owns a contiguous slice of the
        range blocks and builds the whole codebook from the replicated
        plane; no communication.  The slices' results are concatenated.
      - **domains**: each device builds only its row band of the domain
        codebook and scores every range against it; the global winner is an
        argmax-allreduce on the rank key (the per-shard keys gathered onto
        the data shard's first device, the first maximum taken).
      - **ring**: each device builds its codebook band once; the bands then
        rotate around the ring (``ppermute``: a rotation of the list of band
        tensors, a copy wherever two devices differ), visiting every device,
        so a device holds at most two bands at a time.  The JAX package
        keeps every range on every device and computes the same winners n
        times over; here each device keeps a contiguous slice of the ranges,
        as the halo driver's bands do, and the slices' results are
        concatenated: the same result, each range searched once.

Each strategy is a few *steps*, one function run on every search device
with the shard index as a 0-d int64 tensor on that device (``_shard_index``,
the counterpart of ``jax.lax.axis_index``): no slice, offset or branch in a
step depends on a Python shard number.  On the card each step replays one
CUDA graph for each (step, config, shapes, device) (``utils.graphs``),
whatever the shard and the hop, and the moves run between the replays.  A
replay's outputs are the graph's own, so each is copied out (into the
caller's rows, or a clone) before the step's next replay.  An encode reads
nothing back from the card after the upload of its planes; a decode reads
its iterations and MSEs once, and the flat loop its exit flag once a chunk.
On the CPU the same steps run eagerly.  The steps:
  * 'ranges': ``_ranges_step`` a shard.
  * 'domains': ``_domains_step`` a shard, gathered on the data shard's first
    device, then ``_domains_reduce`` there.
  * 'ring', and the halo plane's ring: a build a shard (``_ring_build``,
    ``_halo_build``), ``_ring_hop`` a (shard, hop), ``_ring_merge`` a shard.
  * the halo plane's 'replicate': ``_halo_build`` a shard, the gathered
    codebook, ``_halo_search`` a shard.

Every cross-shard reduction compares the maximized rank key
(``SearchResult.key``), never the distance: distances saturate (the 'ls'
criterion clamps at 0 on flat ranges), so only the key reproduces the
single-device first-occurrence tie-break bitwise.  Shards hold ascending
global columns, so ties go to the lowest shard, then to the lowest column.

With ``rms_threshold > 0`` the early-accept frontier follows the global
scan order: 'domains' masks the shards past a row's first hit shard; 'ring'
keeps two in-order accumulators (``_ring_search``).

The search route (``_search_any``) mirrors the JAX package's: backends
'auto' and 'cuda' take the kernels' route (K1, ``search_classed``, with the
classifier; K3, ``search_dense``, without it), whose wrappers launch the
CUDA kernels on CUDA tensors and run their plain versions on CPU tensors
('cuda' refuses those); backend 'torch' takes the dense oracle ``search``,
as the JAX package's 'jnp' does, eagerly.  Domains a shard must skip
(padding rows, rows off the image) are K1's reserved column bin, the
oracle's ``domain_mask``, or K3's class mask with a class no range has.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.classify import classify_grid
from ..core.grid import uniform_grid
from ..core.stats import integral_image
from ..decode.decoder import _DECODE_FIELDS, _decode_rows, _read_back
from ..encode.codebook import Codebook, build_codebook, extract_ranges, range_sums
from ..encode.encoder import ARRAY_FIELDS, EncodeResult, plane_on_device
from ..encode.matcher import (_BIG, SearchResult, replays_graph, search, search_classed,
                              search_dense)
from ..params import DecoderConfig, EncoderConfig
from ..utils import graphs
from ..utils.tables import device_table
from .mesh import Mesh

__all__ = ["encode_batch_sharded", "decode_batch_sharded", "encode_plane_sharded_image",
           "STRATEGIES"]

STRATEGIES = ("ranges", "domains", "ring")


def _search_any(ranges, sum_a, sum_a2, cb: Codebook, rcls, dcls, cfg: EncoderConfig,
                domain_mask=None) -> SearchResult:
    """The search every strategy runs (see the module docstring for the
    route).  ``domain_mask`` ([D] bool) marks the domains that may win.
    Without the classifier K3's only masking hook is the class compare, so
    the mask becomes classes, as in the JAX package: every range class 0,
    a masked domain class -4 (the dense search repeats a domain's class over
    its isometries)."""
    if cfg.backend == "torch":
        return search(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg, domain_mask=domain_mask)
    if cfg.use_classifier and rcls is not None:
        return search_classed(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                              domain_mask=domain_mask)
    if domain_mask is not None:
        rcls0 = torch.zeros(ranges.shape[0], dtype=torch.int32, device=ranges.device)
        dcls0 = torch.where(domain_mask, 0, -4).to(torch.int32)
        return search_dense(ranges, sum_a, sum_a2, cb, rcls0, dcls0,
                            dataclasses.replace(cfg, use_classifier=True))
    return search_dense(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg)


def _result_tuple(res: SearchResult):
    return (res.domain_idx, res.transform, res.s, res.o, res.distance, res.valid)


def _range_arrays(plane, cfg: EncoderConfig, ii=None):
    """(ranges, SumA, SumA2, range classes or None) of one plane."""
    h, w = plane.shape
    ranges = extract_ranges(plane.to(torch.float32), cfg.target_size)
    rcls = None
    if cfg.use_classifier:
        rcls = classify_grid(plane, uniform_grid(w, h, cfg.target_size, cfg.target_size),
                             ii=ii)
    return (ranges, *range_sums(ranges), rcls)


# ---------------------------------------------------------------------------
# the steps' machinery: the shard index on the device, the graphs, the moves


def _shard_ids(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.int64)


def _shard_index(j: int, n: int, device) -> torch.Tensor:
    """Shard ``j``'s index among ``n`` as a 0-d int64 tensor on ``device``,
    the counterpart of ``jax.lax.axis_index``: a view of the device's table
    of indices (``utils.tables``), so taking it uploads nothing."""
    return device_table(_shard_ids, n, device=device)[j]


def _takes_graphs(devices, searches, cfg: EncoderConfig) -> bool:
    """Whether a call's steps replay CUDA graphs, from the shapes alone:
    every device a card, and every search the steps run, (rows, columns) in
    ``searches``, one that ``matcher.replays_graph`` takes."""
    return all(replays_graph(r, m, cfg, d) for d in devices for r, m in searches)


def _run(name: str, statics: tuple, fn, graph: bool, *inputs) -> tuple:
    """``fn(*inputs)``, a step: through its CUDA graph with ``graph``, one
    for each (``name``, ``statics``, the inputs' shapes and device) whatever
    the shard (its index is an input), else eagerly.  A replay's outputs
    are the graph's own, which the key's next replay overwrites: the caller
    copies what it keeps first."""
    return graphs.replay(name, statics, fn, *inputs) if graph else tuple(fn(*inputs))


def _kept(xs: tuple, graph: bool) -> tuple:
    """``_run``'s outputs, copied out of the graph's with ``graph``."""
    return tuple(x.clone() for x in xs) if graph else xs


def _rows_into(parts, cuts, home) -> tuple:
    """The six result fields on ``home``: each of ``parts`` (per-shard
    6-tuples, made one at a time) copied into its rows ``cuts[j]`` before
    the next is made.  The copy is the move to the data shard's first
    device and takes the part out of a graph's outputs."""
    rows = None
    for (lo, hi), part in zip(cuts, parts, strict=True):
        if rows is None:
            rows = [x.new_empty((cuts[-1][1],), device=home) for x in part]
        for row, x in zip(rows, part):
            row[lo:hi] = x
    return tuple(rows)


def _all_gather(parts, devices):
    """Each device's copy of ``parts`` (one tensor per shard) concatenated in
    shard order: one copy per distinct device (shards that share a device
    share it)."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = torch.cat([p.to(d) for p in parts])
    return [out[d] for d in devices]


def _member_arrays(ranges, sum_a, sum_a2, rcls) -> tuple:
    """A search member's arrays as a step takes them: (ranges, SumA, SumA2),
    the range classes after them with the classifier."""
    return (ranges, sum_a, sum_a2, *(() if rcls is None else (rcls,)))


def _member(xs: tuple, cfg: EncoderConfig) -> tuple:
    """(ranges, SumA, SumA2, range classes or None) of ``_member_arrays``."""
    return (*xs[:3], xs[3] if cfg.use_classifier else None)


def _band_arrays(cb: Codebook, dcls) -> tuple:
    """A codebook band's arrays as a step takes them: (values, SumB, SumB2,
    1/var_b), the domain classes after them with the classifier."""
    return (cb.values, cb.sum, cb.sum_sq, cb.inv_var, *(() if dcls is None else (dcls,)))


def _codebook(xs: tuple, grid, cfg: EncoderConfig) -> tuple:
    """(Codebook over ``grid``, domain classes or None) of ``_band_arrays``."""
    cb = Codebook(values=xs[0], sum=xs[1], sum_sq=xs[2], grid=grid, inv_var=xs[3])
    return cb, (xs[4] if cfg.use_classifier else None)


def _widths(cfg: EncoderConfig) -> tuple:
    """(len of ``_member_arrays``, len of ``_band_arrays``) under ``cfg``."""
    c = 1 if cfg.use_classifier else 0
    return 3 + c, 4 + c


# ---------------------------------------------------------------------------
# 'ranges'


def _ranges_step(cfg: EncoderConfig, r_per: int):
    """The 'ranges' step: the six fields of the range blocks [idx * r_per,
    idx * r_per + r_per) of one plane against its whole codebook."""
    def step(plane, idx):
        h, w = plane.shape
        domain_grid = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
        cb = build_codebook(plane.to(torch.float32), domain_grid, cfg.target_size,
                            cfg.num_transforms)
        ii = integral_image(plane) if cfg.use_classifier else None
        rows = idx * r_per + torch.arange(r_per, device=plane.device)
        ranges, sum_a, sum_a2, rcls = (None if x is None else x.index_select(0, rows)
                                       for x in _range_arrays(plane, cfg, ii))
        dcls = classify_grid(plane, domain_grid, ii=ii) if cfg.use_classifier else None
        return _result_tuple(_search_any(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg))

    return step


# ---------------------------------------------------------------------------
# the domain-band machinery of the 'domains' and 'ring' strategies


class _Bands(NamedTuple):
    """The static geometry of the per-device domain row bands."""

    ny: int  # domain rows of the plane
    nx: int  # domain columns
    rows_per: int  # domain rows a band holds (the last band's may fall off)
    band_h: int  # pixel rows of a band
    pad_h: int  # zero rows under the plane, so that the last band fits
    d_local: int  # domains a band holds


def _band_statics(h: int, w: int, cfg: EncoderConfig, n: int) -> _Bands:
    step = cfg.domain_step
    grid = uniform_grid(w, h, cfg.source_size, step)
    rows_per = -(-grid.ny // n)  # every band the same height
    band_h = (rows_per - 1) * step + cfg.source_size
    pad_h = max(0, (n - 1) * rows_per * step + band_h - h)
    return _Bands(grid.ny, grid.nx, rows_per, band_h, pad_h, rows_per * grid.nx)


def _band_grid(w: int, cfg: EncoderConfig, bands: _Bands):
    """The domain grid of one band."""
    grid = uniform_grid(w, bands.band_h, cfg.source_size, cfg.domain_step)
    assert grid.ny == bands.rows_per, (grid.ny, bands.rows_per)
    return grid


def _band_mask(idx, bands: _Bands, device) -> torch.Tensor:
    """[d_local] bool: band ``idx``'s (a 0-d device tensor) domains that lie
    on the image."""
    rows = idx * bands.rows_per + torch.arange(bands.d_local, device=device) // bands.nx
    return rows < bands.ny


def _local_band_codebook(plane, cfg: EncoderConfig, idx, bands: _Bands):
    """The codebook and classes of domain rows [idx * rows_per, ...) from
    the (replicated) plane, ``idx`` a 0-d device tensor: the band's own
    build, never the full grid's.  Returns (codebook, domain classes or
    None)."""
    h, w = plane.shape
    padded = torch.cat([plane, plane.new_zeros((bands.pad_h, w))]) if bands.pad_h else plane
    y0 = idx * (bands.rows_per * cfg.domain_step)
    band = padded.index_select(0, y0 + torch.arange(bands.band_h, device=plane.device))
    grid = _band_grid(w, cfg, bands)
    cb = build_codebook(band.to(torch.float32), grid, cfg.target_size, cfg.num_transforms)
    return cb, (classify_grid(band, grid) if cfg.use_classifier else None)


def _local_m(res: SearchResult, t: int) -> torch.Tensor:
    """Search-order column of the winner within its shard: m = d*T + (T-1-t)."""
    return res.domain_idx.to(torch.int64) * t + (t - 1) - res.transform.to(torch.int64)


def _acc_empty(r: int, device):
    """(key, col, dist, s, o, valid) running-winner accumulator."""
    return (torch.full((r,), -_BIG, dtype=torch.float32, device=device),
            torch.zeros((r,), dtype=torch.int64, device=device),
            torch.full((r,), _BIG, dtype=torch.float32, device=device),
            torch.zeros((r,), dtype=torch.float32, device=device),
            torch.zeros((r,), dtype=torch.float32, device=device),
            torch.zeros((r,), dtype=torch.bool, device=device))


def _acc_update(acc, res: SearchResult, gcol, gate=None):
    """Fold one shard's result into the accumulator with the global
    first-occurrence rule: the higher key wins, equal keys go to the lower
    global column.  ``gate`` (bool [R], optional) blocks updates."""
    bq, bcol = acc[0], acc[1]
    better = (res.key > bq) | ((res.key == bq) & (gcol < bcol))
    if gate is not None:
        better = better & gate
    new = (res.key, gcol, res.distance, res.s, res.o, res.valid)
    return tuple(torch.where(better, a, b) for a, b in zip(new, acc))


def _acc_merge(x, y):
    """The composite best of two accumulators (the same (key, col) rule)."""
    better = (y[0] > x[0]) | ((y[0] == x[0]) & (y[1] < x[1]))
    return tuple(torch.where(better, b, a) for a, b in zip(x, y))


def _threshold(cfg: EncoderConfig) -> float:
    """The frontier's threshold as the kernels compare it, in f32: a Python
    float that f32 holds exactly, so a comparison with an f32 tensor is the
    same in any precision and uploads nothing."""
    return float(np.float32(cfg.rms_threshold))


def _hits(res: SearchResult, cfg: EncoderConfig) -> torch.Tensor:
    """Rows whose shard-local winner meets the frontier: a shard hit exactly
    where its frozen best is under the threshold."""
    return res.valid & (res.distance <= _threshold(cfg))


# ---------------------------------------------------------------------------
# 'domains'


def _domains_step(cfg: EncoderConfig, bands: _Bands):
    """The 'domains' step: one plane's ranges against band ``idx`` of its
    domain rows; the band search's rank key and six fields."""
    def step(plane, idx):
        cb, dcls = _local_band_codebook(plane, cfg, idx, bands)
        ranges, sum_a, sum_a2, rcls = _range_arrays(plane, cfg)
        res = _search_any(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                          domain_mask=_band_mask(idx, bands, plane.device))
        return (res.key, *_result_tuple(res))

    return step


def _domains_reduce(cfg: EncoderConfig, d_local: int):
    """The argmax-allreduce of the 'domains' strategy, a step on the
    per-shard keys and fields gathered ([S, R] each): the global winner the
    highest key, ties to the lowest shard (shards hold ascending global
    columns, and each shard's winner is already its first occurrence).
    With the frontier a row's shards past its first hit shard are masked
    out: the reference's scan never reaches them."""
    def step(qs, dom, tr, s, o, dist, valid):
        dev = qs.device
        if cfg.rms_threshold > 0.0:
            hits = valid & (dist <= _threshold(cfg))
            any_hit = hits.any(0)
            s_star = hits.to(torch.uint8).argmax(0)  # the first hit shard
            sid = torch.arange(qs.shape[0], device=dev)[:, None]
            qs = torch.where(any_hit[None, :] & (sid > s_star[None, :]), -_BIG, qs)
        winner = qs.argmax(0)  # the first maximum: the lowest shard on ties
        rows = torch.arange(qs.shape[1], device=dev)
        sel = lambda x: x[winner, rows]  # noqa: E731
        ok = sel(valid)
        g_dom = sel(dom).to(torch.int64) + winner * d_local
        return (torch.where(ok, g_dom, 0).to(torch.int32), sel(tr), sel(s), sel(o),
                sel(dist), ok)

    return step


# ---------------------------------------------------------------------------
# 'ring'


def _ring_build(cfg: EncoderConfig, bands: _Bands, num_ranges: int, n: int, r_len: int):
    """The ring's build step for shard ``idx`` of ``n``: its band's arrays
    (``_band_arrays``), then its member's (``_member_arrays``): the
    ``r_len`` ranges from ``idx * num_ranges // n``."""
    def step(plane, idx):
        cb, dcls = _local_band_codebook(plane, cfg, idx, bands)
        lo = torch.div(idx * num_ranges, n, rounding_mode="floor")
        rows = lo + torch.arange(r_len, device=plane.device)
        member = (None if x is None else x.index_select(0, rows)
                  for x in _range_arrays(plane, cfg))
        return (*_band_arrays(cb, dcls), *_member_arrays(*member))

    return step


def _ring_state(r: int, cfg: EncoderConfig, device) -> tuple:
    """A member's accumulator before its first hop (``_acc_empty``); with
    the frontier, group A's, group B's, then the two frozen flags."""
    if cfg.rms_threshold <= 0.0:
        return _acc_empty(r, device)
    no = torch.zeros((r,), dtype=torch.bool, device=device)
    return (*_acc_empty(r, device), *_acc_empty(r, device), no, no)


def _ring_hop(cfg: EncoderConfig, bands: _Bands, grid):
    """The ring's hop step: a member (``_member_arrays``) searched against
    the band it holds (``_band_arrays`` over ``grid``), band ``src`` (a 0-d
    device tensor), and folded into its state (``_ring_state``).  With the
    frontier the band's group is a device flag, ``src < j`` for member
    ``j``: B, the globally first bands, or A; it gates both accumulators'
    updates and freezes, so each group freezes at its own first hit band."""
    t_n = cfg.num_transforms
    m_local = bands.d_local * t_n
    nm, nb = _widths(cfg)

    def step(*xs):
        ranges, sum_a, sum_a2, rcls = _member(xs[:nm], cfg)
        cb, dcls = _codebook(xs[nm:nm + nb], grid, cfg)
        src, j = xs[nm + nb:nm + nb + 2]
        state = xs[nm + nb + 2:]
        res = _search_any(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                          domain_mask=_band_mask(src, bands, ranges.device))
        gcol = src * m_local + _local_m(res, t_n)
        if cfg.rms_threshold <= 0.0:
            return _acc_update(state, res, gcol)
        acc_a, acc_b, frz_a, frz_b = state[:6], state[6:12], state[12], state[13]
        hit, in_b = _hits(res, cfg), src < j
        return (*_acc_update(acc_a, res, gcol, gate=~frz_a & ~in_b),
                *_acc_update(acc_b, res, gcol, gate=~frz_b & in_b),
                frz_a | (hit & ~in_b), frz_b | (hit & in_b))

    return step


def _ring_merge(cfg: EncoderConfig):
    """The ring's merge step: a member's state (``_ring_state``) as its six
    result fields.  With the frontier, group B's columns all precede group
    A's: where B froze, the reference's scan never reaches A; elsewhere the
    composite of B and the frozen A."""
    t_n = cfg.num_transforms

    def step(*state):
        acc = state[:6]
        if cfg.rms_threshold > 0.0:
            acc_b, frz_b = state[6:12], state[13]
            merged = _acc_merge(acc_b, acc)
            acc = tuple(torch.where(frz_b, b, m) for b, m in zip(acc_b, merged))
        _, bcol, bdist, bs, bo, bvalid = acc
        # a range no band admits keeps column 0, i.e. (domain 0, transform
        # T-1): the single-device search's first-column fallback
        return ((bcol // t_n).to(torch.int32), ((t_n - 1) - bcol % t_n).to(torch.int32),
                torch.where(bvalid, bs, 0.0), torch.where(bvalid, bo, 0.0),
                torch.where(bvalid, bdist, _BIG), bvalid)

    return step


def _ring_search(members, shards, cfg: EncoderConfig, bands: _Bands, w: int, graph: bool):
    """Ring-streamed codebook search.  ``members[j]`` (``_member_arrays``)
    lies on device j, ``shards[j]`` (``_band_arrays`` of band j) was built
    there; the search takes the bands out of ``shards`` (it empties the
    list), so that a band that has moved on is freed and a device holds at
    most two.  At hop h device j holds band (j + h) % n; then every band
    moves to the previous device (``ppermute``), so device j visits bands j,
    j + 1, ..., n - 1, 0, ..., j - 1: two runs, each ascending in global
    column order.  Band s's global search-order columns start at
    s * d_local * T.

    With ``rms_threshold > 0`` the frontier needs the global scan order, so
    the two runs keep separate accumulators, each frozen at its own first
    hit band (``_ring_hop``, ``_ring_merge``).  Yields, member by member,
    the 6-tuple (domain, transform, s, o, distance, valid): a graph's
    outputs with ``graph``, which the caller copies before taking the
    next."""
    n = len(members)
    devices = [m[0].device for m in members]
    hop = _ring_hop(cfg, bands, _band_grid(w, cfg, bands))
    state = [_ring_state(m[0].shape[0], cfg, d) for m, d in zip(members, devices)]
    held, shards[:] = list(shards), []
    for h in range(n):
        for j in range(n):
            src = _shard_index((j + h) % n, n, devices[j])  # the band device j holds
            state[j] = _kept(_run("sharded_ring_hop", (cfg, bands, w), hop, graph,
                                  *members[j], *held[j], src,
                                  _shard_index(j, n, devices[j]), *state[j]), graph)
        if h + 1 < n:  # the band held by device i moves to device i - 1
            held = [tuple(x.to(devices[j]) for x in held[(j + 1) % n]) for j in range(n)]
    del held
    merge = _ring_merge(cfg)
    for s in state:
        yield _run("sharded_ring_merge", (cfg,), merge, graph, *s)


# ---------------------------------------------------------------------------
# the batch


def _ring_cuts(num_ranges: int, n: int) -> list:
    """The ring's range cuts: member j's rows [lo, hi); their lengths differ
    by one at most, so a ring's steps take at most two shapes."""
    return [(num_ranges * j // n, num_ranges * (j + 1) // n) for j in range(n)]


def _searches(h: int, w: int, cfg: EncoderConfig, n: int, strategy: str) -> list:
    """(rows, columns) of each search a frame's steps run under
    ``strategy`` over ``n`` search shards."""
    num_ranges = (h // cfg.target_size) * (w // cfg.target_size)
    t_n = cfg.num_transforms
    if strategy == "ranges":
        d = uniform_grid(w, h, cfg.source_size, cfg.domain_step).num_items
        return [(num_ranges // n, d * t_n)]
    m = _band_statics(h, w, cfg, n).d_local * t_n
    if strategy == "domains":
        return [(num_ranges, m)]
    return [(hi - lo, m) for lo, hi in _ring_cuts(num_ranges, n)]


def _encode_one(plane, cfg: EncoderConfig, devices, strategy: str, graph: bool):
    """One frame over the search devices ``devices``: the 6-tuple of its
    result on ``devices[0]``."""
    n = len(devices)
    h, w = plane.shape
    num_ranges = (h // cfg.target_size) * (w // cfg.target_size)
    local = [plane.to(d) for d in devices]  # the replicated plane
    ids = [_shard_index(j, n, d) for j, d in enumerate(devices)]
    home = devices[0]
    if strategy == "ranges":
        if num_ranges % n:
            raise ValueError(f"{num_ranges} ranges do not split evenly over {n} "
                             "search shards")
        r_per = num_ranges // n
        step = _ranges_step(cfg, r_per)
        parts = (_run("sharded_ranges", (cfg, r_per), step, graph, local[j], ids[j])
                 for j in range(n))
        return _rows_into(parts, [(j * r_per, (j + 1) * r_per) for j in range(n)], home)
    bands = _band_statics(h, w, cfg, n)
    if strategy == "domains":
        step = _domains_step(cfg, bands)
        gathered = None
        for j in range(n):
            part = _run("sharded_domains", (cfg, bands), step, graph, local[j], ids[j])
            if gathered is None:
                gathered = [x.new_empty((n, *x.shape), device=home) for x in part]
            for g, x in zip(gathered, part):  # the all_gather onto the home device
                g[j] = x
        return _kept(_run("sharded_domains_reduce", (cfg, bands.d_local),
                          _domains_reduce(cfg, bands.d_local), graph, *gathered), graph)
    if strategy == "ring":
        cuts = _ring_cuts(num_ranges, n)
        _, nb = _widths(cfg)
        shards, members = [], []
        for j, (lo, hi) in enumerate(cuts):
            built = _kept(_run("sharded_ring_build", (cfg, bands, num_ranges, n, hi - lo),
                               _ring_build(cfg, bands, num_ranges, n, hi - lo), graph,
                               local[j], ids[j]), graph)
            shards.append(built[:nb])
            members.append(built[nb:])
        del built  # the ring frees each band as it moves on
        return _rows_into(_ring_search(members, shards, cfg, bands, w, graph), cuts, home)
    raise ValueError(f"unknown strategy {strategy}; want one of {STRATEGIES}")


def _result(fields, h: int, w: int, cfg: EncoderConfig) -> EncodeResult:
    return EncodeResult(**dict(zip(ARRAY_FIELDS, fields)), width=w, height=h,
                        source_size=cfg.source_size, target_size=cfg.target_size,
                        domain_step=cfg.domain_step, num_transforms=cfg.num_transforms)


def encode_batch_sharded(planes, cfg: EncoderConfig, mesh: Mesh,
                         strategy: str = "ranges") -> list[EncodeResult]:
    """Encode a batch of [B, H, W] u8 planes (numpy array or tensor; it
    goes to the mesh's first device, then to each shard's) across the mesh:
    frames over the data axis, one frame's search over the search axis by
    ``strategy`` (``STRATEGIES``).  Returns one EncodeResult per frame, on
    the first device of its data shard; each equals ``encode_plane`` of the
    frame bitwise.  On the card each step replays its CUDA graph (the
    module docstring), and nothing is read back after the upload."""
    return _encode_batch(planes, cfg, mesh, strategy)


def _encode_batch(planes, cfg: EncoderConfig, mesh: Mesh, strategy: str,
                  graph: bool | None = None) -> list[EncodeResult]:
    """``encode_batch_sharded``, its steps through their graphs with
    ``graph``, eagerly without; None: where ``_takes_graphs``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy}; want one of {STRATEGIES}")
    planes = plane_on_device(planes, mesh.devices[0][0])
    b, h, w = planes.shape
    frame_devices = mesh.frame_devices(b)
    if graph is None:
        graph = _takes_graphs([d for row in mesh.devices for d in row],
                              _searches(h, w, cfg, len(mesh.devices[0]), strategy), cfg)
    return [_result(_encode_one(plane, cfg, devices, strategy, graph), h, w, cfg)
            for plane, devices in zip(planes, frame_devices)]


# ---------------------------------------------------------------------------
# the halo-sharded plane


def _halo_build(cfg: EncoderConfig, grid):
    """The halo plane's build step: the codebook band over a device's rows
    and the halo rows under them (``_band_arrays`` over ``grid``), then the
    member's arrays of its own rows (``_member_arrays``)."""
    def step(band, halo_rows):
        ext = torch.cat([band, halo_rows])
        cb = build_codebook(ext.to(torch.float32), grid, cfg.target_size, cfg.num_transforms)
        dcls = classify_grid(ext, grid, ii=integral_image(ext)) if cfg.use_classifier else None
        member = _range_arrays(band, cfg, integral_image(band) if cfg.use_classifier else None)
        return (*_band_arrays(cb, dcls), *_member_arrays(*member))

    return step


def _halo_search(cfg: EncoderConfig, grid):
    """The halo plane's 'replicate' search step: a member against the
    gathered codebook over the plane's domain ``grid`` (its bands' padding
    rows masked)."""
    nm, _ = _widths(cfg)

    def step(*xs):
        ranges, sum_a, sum_a2, rcls = _member(xs[:nm], cfg)
        cb, dcls = _codebook(xs[nm:], grid, cfg)
        d_total = cb.values.shape[0]
        mask = torch.arange(d_total, device=ranges.device) // grid.nx < grid.ny
        return _result_tuple(_search_any(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                                         domain_mask=mask))

    return step


def encode_plane_sharded_image(plane, cfg: EncoderConfig, mesh: Mesh,
                               codebook: str = "replicate") -> EncodeResult:
    """Encode ONE large plane with the image itself sharded by rows across
    the first data shard's search devices: each holds a band of H / n rows
    and its ranges.  Domains near a band's south edge read ``source_size -
    domain_step`` rows of the next band: the halo exchange (``ppermute``
    south to north; the last band's, wrapped from the first, lie under
    domains off the image, which are masked).  Then either the codebook
    bands are gathered onto every device (``codebook='replicate'``, the
    case that fits) or they stream around the ring (``codebook='ring'``, a
    device holds at most two bands: config 4 at 4K+).  Bitwise equal to the
    single-device encode either way; the result lies on the first device.
    On the card each step replays its CUDA graph (the module docstring)."""
    return _encode_image(plane, cfg, mesh, codebook)


def _encode_image(plane, cfg: EncoderConfig, mesh: Mesh, codebook: str,
                  graph: bool | None = None) -> EncodeResult:
    """``encode_plane_sharded_image``, its steps through their graphs with
    ``graph``, eagerly without; None: where ``_takes_graphs``."""
    if codebook not in ("replicate", "ring"):
        raise ValueError(f"unknown codebook mode {codebook}")
    devices = mesh.devices[0]
    n = len(devices)
    plane = plane_on_device(plane, devices[0])
    h, w = plane.shape
    sw, step, ts = cfg.source_size, cfg.domain_step, cfg.target_size
    if h % n:
        raise ValueError(f"{h} rows do not split evenly over {n} search shards")
    hs = h // n  # rows per device
    halo = sw - step  # rows a band needs from its southern neighbour
    if hs % step or hs % ts:
        raise ValueError(f"a band of {hs} rows is no multiple of the domain step {step} "
                         f"and the range size {ts}")
    if hs < sw:
        raise ValueError(f"a band of {hs} rows is shorter than a domain ({sw})")
    grid = uniform_grid(w, h, sw, step)
    rows_per = hs // step  # domain rows anchored in each band
    bands = _Bands(grid.ny, grid.nx, rows_per, hs + halo, 0, rows_per * grid.nx)
    r_band = (hs // ts) * (w // ts)  # the ranges of a band
    if graph is None:
        cols = (n if codebook == "replicate" else 1) * bands.d_local * cfg.num_transforms
        graph = _takes_graphs(devices, [(r_band, cols)], cfg)
    local = [plane[j * hs:(j + 1) * hs].to(devices[j]) for j in range(n)]
    # the halo exchange: device j receives the top rows of band j + 1
    tops = [local[(j + 1) % n][:halo].to(devices[j]) for j in range(n)]
    build = _halo_build(cfg, _band_grid(w, cfg, bands))
    _, nb = _widths(cfg)
    shards, members = [], []
    for j in range(n):
        built = _kept(_run("sharded_halo_build", (cfg, bands, w), build, graph, local[j],
                           tops[j]), graph)
        shards.append(built[:nb])
        members.append(built[nb:])
    del built  # the ring frees each band as it moves on
    if codebook == "ring":
        parts = _ring_search(members, shards, cfg, bands, w, graph)
    else:
        # the codebook all_gather: device-major order is the global
        # row-major domain order, as the bands are contiguous rows
        gathered = [_all_gather([s[f] for s in shards], devices) for f in range(nb)]
        del shards
        search_step = _halo_search(cfg, grid)
        parts = (_run("sharded_halo_search", (cfg, grid), search_step, graph, *members[j],
                      *(g[j] for g in gathered)) for j in range(n))
    cuts = [(j * r_band, (j + 1) * r_band) for j in range(n)]
    return _result(_rows_into(parts, cuts, devices[0]), h, w, cfg)


# ---------------------------------------------------------------------------
# the decode


def decode_batch_sharded(results: list[EncodeResult], mesh: Mesh,
                         max_iterations: int = 300, epsilon: float = 1e-5,
                         initial_value: int = 100, stall_window: int = 8,
                         stall_rtol: float = 0.02, pyramid: bool = False):
    """Decode a batch of encodes data-parallel across the mesh: each data
    shard's frames stacked on its first device and decoded there as
    ``decode_batch_stacked`` decodes them (on the card, through its graphs),
    with the flat loop (its period-2 and stall exits; iterations count every
    step run, as the JAX package's sharded decode counts them) or, with
    ``pyramid=True``, the coarse-to-fine start and the fixed
    full-resolution floor (``DecoderConfig.pyramid``).

    Returns ([B, H, W] u8 images on the mesh's first device, [B] i32
    iterations, [B] f32 final mse), the last two on the CPU, read back once."""
    dcfg = DecoderConfig(max_iterations=max_iterations, epsilon=epsilon,
                         initial_value=initial_value, stall_window=stall_window,
                         stall_rtol=stall_rtol, pyramid=pyramid)
    return _decode_batch(results, mesh, dcfg)


def _decode_batch(results: list[EncodeResult], mesh: Mesh, dcfg: DecoderConfig,
                  graph: bool | None = None):
    """``decode_batch_sharded`` under ``dcfg``: through the graphs with
    ``graph``, eagerly without; None: on the card."""
    home = mesh.devices[0][0]
    frame_devices = mesh.frame_devices(len(results))
    per = len(results) // len(mesh.devices)
    outs, iters, mses = [], [], []
    for i in range(0, len(results), per):
        d = frame_devices[i][0]
        frames = results[i:i + per]
        # the data shard's frames stacked on its first device (a move)
        stacked = dataclasses.replace(frames[0], **{
            f: torch.stack([getattr(r, f).to(d) for r in frames]) for f in _DECODE_FIELDS})
        o, it, m = _decode_rows(stacked, dcfg, d.type == "cuda" if graph is None else graph,
                                ran_steps=True)
        outs.append(o.to(home))
        iters.append(it.to(home))
        mses.append(m.to(home))
    return (torch.cat(outs), *_read_back(torch.cat(iters), torch.cat(mses)))
