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
as the JAX package's 'jnp' does.  Domains a shard must skip (padding rows,
rows off the image) are K1's reserved column bin, the oracle's
``domain_mask``, or K3's class mask with a class no range has.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.classify import classify_grid
from ..core.grid import uniform_grid
from ..core.stats import integral_image
from ..decode.decoder import _decode_core
from ..encode.codebook import Codebook, build_codebook, extract_ranges, range_sums
from ..encode.encoder import ARRAY_FIELDS, EncodeResult, plane_on_device
from ..encode.matcher import _BIG, SearchResult, search, search_classed, search_dense
from ..params import DecoderConfig, EncoderConfig
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


def _plane_search_arrays(plane, cfg: EncoderConfig, r_lo: int, r_count: int):
    """Search the range blocks [r_lo, r_lo + r_count) of one plane against
    its whole codebook (a 'ranges' search shard)."""
    h, w = plane.shape
    domain_grid = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
    cb = build_codebook(plane.to(torch.float32), domain_grid, cfg.target_size,
                        cfg.num_transforms)
    ii = integral_image(plane) if cfg.use_classifier else None
    ranges, sum_a, sum_a2, rcls = _range_arrays(plane, cfg, ii)
    rows = slice(r_lo, r_lo + r_count)
    dcls = classify_grid(plane, domain_grid, ii=ii) if cfg.use_classifier else None
    return _search_any(ranges[rows], sum_a[rows], sum_a2[rows], cb,
                       None if rcls is None else rcls[rows], dcls, cfg)


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


def _band_mask(shard: int, bands: _Bands, device) -> torch.Tensor:
    """[d_local] bool: the band's domains that lie on the image."""
    rows = shard * bands.rows_per + torch.arange(bands.d_local, device=device) // bands.nx
    return rows < bands.ny


def _local_band_codebook(plane, cfg: EncoderConfig, shard: int, bands: _Bands):
    """The codebook and classes of domain rows [shard * rows_per, ...) from
    the (replicated) plane: the band's own build, never the full grid's.
    Returns (codebook, domain classes or None, domain mask)."""
    h, w = plane.shape
    step = cfg.domain_step
    padded = torch.cat([plane, plane.new_zeros((bands.pad_h, w))]) if bands.pad_h else plane
    y0 = shard * bands.rows_per * step
    band = padded[y0:y0 + bands.band_h]
    local_grid = uniform_grid(w, bands.band_h, cfg.source_size, step)
    assert local_grid.ny == bands.rows_per, (local_grid.ny, bands.rows_per)
    cb = build_codebook(band.to(torch.float32), local_grid, cfg.target_size,
                        cfg.num_transforms)
    dcls = classify_grid(band, local_grid) if cfg.use_classifier else None
    return cb, dcls, _band_mask(shard, bands, plane.device)


def _codebook_to(cb: Codebook, device) -> Codebook:
    return Codebook(values=cb.values.to(device), sum=cb.sum.to(device),
                    sum_sq=cb.sum_sq.to(device), grid=cb.grid,
                    inv_var=cb.inv_var.to(device))


def _all_gather(parts, devices):
    """Each device's copy of ``parts`` (one tensor per shard) concatenated in
    shard order: one copy per distinct device (shards that share a device
    share it)."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = torch.cat([p.to(d) for p in parts])
    return [out[d] for d in devices]


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


def _hits(res: SearchResult, cfg: EncoderConfig) -> torch.Tensor:
    """Rows whose shard-local winner meets the frontier: a shard hit exactly
    where its frozen best is under the threshold (f32, as the kernels)."""
    thr = torch.tensor(cfg.rms_threshold, dtype=torch.float32, device=res.distance.device)
    return res.valid & (res.distance <= thr)


def _ring_search(members, shards, cfg: EncoderConfig, bands: _Bands):
    """Ring-streamed codebook search.  ``members[j]`` = (ranges, SumA,
    SumA2, range classes or None) resident on device j, ``shards[j]`` =
    (codebook, domain classes or None) of band j, built there; the search
    takes the bands out of ``shards`` (it empties the list), so that a band
    that has moved on is freed and a device holds at most two.  At hop h
    device j holds band (j + h) % n; then every band moves to the previous
    device (``ppermute``), so device j visits bands j, j + 1, ..., n - 1, 0,
    ..., j - 1: two runs, each ascending in global column order.  Band s's
    global search-order columns start at s * d_local * T.

    With ``rms_threshold > 0`` the frontier needs the global scan order, so
    the two runs keep separate accumulators, each frozen at its own first
    hit band (group B, the bands before j, holds the globally first
    columns): the winner is B's frozen best where B hit, else the composite
    of B and the frozen A.  Returns, per member, the 6-tuple (domain,
    transform, s, o, distance, valid)."""
    n = len(members)
    t_n = cfg.num_transforms
    m_local = bands.d_local * t_n
    use_thr = cfg.rms_threshold > 0.0
    devices = [m[0].device for m in members]
    state = []
    for ranges, *_ in members:
        r, dev = ranges.shape[0], ranges.device
        no = torch.zeros((r,), dtype=torch.bool, device=dev)
        state.append([_acc_empty(r, dev), _acc_empty(r, dev), no, no])
    held, shards[:] = list(shards), []
    for hop in range(n):
        for j, (ranges, sum_a, sum_a2, rcls) in enumerate(members):
            src = (j + hop) % n  # the band device j holds
            cb, dcls = held[j]
            res = _search_any(ranges, sum_a, sum_a2, cb, rcls,
                              dcls if cfg.use_classifier else None, cfg,
                              domain_mask=_band_mask(src, bands, devices[j]))
            gcol = src * m_local + _local_m(res, t_n)
            acc_a, acc_b, frz_a, frz_b = state[j]
            if use_thr:
                hit = _hits(res, cfg)
                if src < j:  # group B: the globally first bands
                    acc_b = _acc_update(acc_b, res, gcol, gate=~frz_b)
                    frz_b = frz_b | hit
                else:
                    acc_a = _acc_update(acc_a, res, gcol, gate=~frz_a)
                    frz_a = frz_a | hit
            else:
                acc_a = _acc_update(acc_a, res, gcol)
            state[j] = [acc_a, acc_b, frz_a, frz_b]
        if hop + 1 < n:  # the band held by device i moves to device i - 1
            held = [(_codebook_to(held[(j + 1) % n][0], devices[j]),
                     None if held[(j + 1) % n][1] is None
                     else held[(j + 1) % n][1].to(devices[j])) for j in range(n)]
    out = []
    for acc_a, acc_b, _, frz_b in state:
        if use_thr:
            # group B's columns all precede group A's: where B froze, the
            # reference's scan never reaches A
            merged = _acc_merge(acc_b, acc_a)
            acc_a = tuple(torch.where(frz_b, b, m) for b, m in zip(acc_b, merged))
        _, bcol, bdist, bs, bo, bvalid = acc_a
        # a range no band admits keeps column 0, i.e. (domain 0, transform
        # T-1): the single-device search's first-column fallback
        out.append(((bcol // t_n).to(torch.int32),
                    ((t_n - 1) - bcol % t_n).to(torch.int32),
                    torch.where(bvalid, bs, 0.0), torch.where(bvalid, bo, 0.0),
                    torch.where(bvalid, bdist, _BIG), bvalid))
    return out


def _domains_reduce(locals_, cfg: EncoderConfig, d_local: int, device):
    """The argmax-allreduce of the 'domains' strategy on ``device``: the
    per-shard winners gathered, the global winner the highest key, ties to
    the lowest shard (shards hold ascending global columns, and each
    shard's winner is already its first occurrence).  With the frontier a
    row's shards past its first hit shard are masked out: the reference's
    scan never reaches them."""
    gather = lambda f: torch.stack([getattr(res, f).to(device) for res in locals_])  # [S, R]
    qs = gather("key")
    if cfg.rms_threshold > 0.0:
        hits = torch.stack([_hits(res, cfg).to(device) for res in locals_])
        any_hit = hits.any(0)
        s_star = hits.to(torch.uint8).argmax(0)  # the first hit shard
        sid = torch.arange(len(locals_), device=device)[:, None]
        qs = torch.where(any_hit[None, :] & (sid > s_star[None, :]), -_BIG, qs)
    winner = qs.argmax(0)  # the first maximum: the lowest shard on ties
    rows = torch.arange(qs.shape[1], device=device)
    sel = lambda f: gather(f)[winner, rows]
    valid = sel("valid")
    g_dom = sel("domain_idx").to(torch.int64) + winner * d_local
    return (torch.where(valid, g_dom, 0).to(torch.int32), sel("transform"), sel("s"),
            sel("o"), sel("distance"), valid)


def _encode_one(plane, cfg: EncoderConfig, devices, strategy: str):
    """One frame over the search devices ``devices``: the 6-tuple of its
    result on ``devices[0]``."""
    n = len(devices)
    h, w = plane.shape
    num_ranges = (h // cfg.target_size) * (w // cfg.target_size)
    local = [plane.to(d) for d in devices]  # the replicated plane
    home = devices[0]
    if strategy == "ranges":
        if num_ranges % n:
            raise ValueError(f"{num_ranges} ranges do not split evenly over {n} "
                             "search shards")
        r_per = num_ranges // n
        parts = [_result_tuple(_plane_search_arrays(local[j], cfg, j * r_per, r_per))
                 for j in range(n)]
        return tuple(torch.cat([p[f].to(home) for p in parts]) for f in range(6))
    bands = _band_statics(h, w, cfg, n)
    if strategy == "domains":
        locals_ = []
        for j in range(n):
            cb, dcls, dmask = _local_band_codebook(local[j], cfg, j, bands)
            ranges, sum_a, sum_a2, rcls = _range_arrays(local[j], cfg)
            locals_.append(_search_any(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                                       domain_mask=dmask))
        return _domains_reduce(locals_, cfg, bands.d_local, home)
    if strategy == "ring":
        shards = [_local_band_codebook(local[j], cfg, j, bands)[:2] for j in range(n)]
        members = []
        for j in range(n):
            ranges, sum_a, sum_a2, rcls = _range_arrays(local[j], cfg)
            cut = slice(num_ranges * j // n, num_ranges * (j + 1) // n)
            members.append((ranges[cut], sum_a[cut], sum_a2[cut],
                            None if rcls is None else rcls[cut]))
        parts = _ring_search(members, shards, cfg, bands)
        return tuple(torch.cat([p[f].to(home) for p in parts]) for f in range(6))
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
    frame bitwise."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy}; want one of {STRATEGIES}")
    planes = plane_on_device(planes, mesh.devices[0][0])
    _, h, w = planes.shape
    return [_result(_encode_one(plane, cfg, devices, strategy), h, w, cfg)
            for plane, devices in zip(planes, mesh.frame_devices(planes.shape[0]))]


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
    single-device encode either way; the result lies on the first device."""
    if codebook not in ("replicate", "ring"):
        raise ValueError(f"unknown codebook mode {codebook}")
    devices = mesh.devices[0]
    n = len(devices)
    plane = plane_on_device(plane, devices[0])
    h, w = plane.shape
    sw, step = cfg.source_size, cfg.domain_step
    if h % n:
        raise ValueError(f"{h} rows do not split evenly over {n} search shards")
    hs = h // n  # rows per device
    halo = sw - step  # rows a band needs from its southern neighbour
    if hs % step or hs % cfg.target_size:
        raise ValueError(f"a band of {hs} rows is no multiple of the domain step {step} "
                         f"and the range size {cfg.target_size}")
    if hs < sw:
        raise ValueError(f"a band of {hs} rows is shorter than a domain ({sw})")
    grid = uniform_grid(w, h, sw, step)
    rows_per = hs // step  # domain rows anchored in each band
    bands = _Bands(grid.ny, grid.nx, rows_per, hs + halo, 0, rows_per * grid.nx)
    local = [plane[j * hs:(j + 1) * hs].to(devices[j]) for j in range(n)]
    # the halo exchange: device j receives the top rows of band j + 1
    ext = [torch.cat([local[j], local[(j + 1) % n][:halo].to(devices[j])]) for j in range(n)]
    local_grid = uniform_grid(w, hs + halo, sw, step)
    assert local_grid.ny == rows_per, (local_grid.ny, rows_per)
    cbs = [build_codebook(e.to(torch.float32), local_grid, cfg.target_size,
                          cfg.num_transforms) for e in ext]
    dcls = ([classify_grid(e, local_grid, ii=integral_image(e)) for e in ext]
            if cfg.use_classifier else [None] * n)
    members = [_range_arrays(local[j], cfg, integral_image(local[j])
                             if cfg.use_classifier else None) for j in range(n)]
    if codebook == "ring":
        shards = list(zip(cbs, dcls))
        del cbs, dcls  # the ring's bands, which it frees as they move on
        parts = _ring_search(members, shards, cfg, bands)
    else:
        # the codebook all_gather: device-major order is the global
        # row-major domain order, as the bands are contiguous rows
        gathered = [_all_gather([getattr(cb, f) for cb in cbs], devices)
                    for f in ("values", "sum", "sum_sq", "inv_var")]
        dcls_all = (_all_gather(dcls, devices) if cfg.use_classifier else [None] * n)
        d_total = n * bands.d_local
        parts = []
        for j, (ranges, sum_a, sum_a2, rcls) in enumerate(members):
            cb = Codebook(values=gathered[0][j], sum=gathered[1][j], sum_sq=gathered[2][j],
                          grid=grid, inv_var=gathered[3][j])
            mask = torch.arange(d_total, device=devices[j]) // grid.nx < grid.ny
            parts.append(_result_tuple(_search_any(ranges, sum_a, sum_a2, cb, rcls,
                                                   dcls_all[j], cfg, domain_mask=mask)))
    return _result(tuple(torch.cat([p[f].to(devices[0]) for p in parts]) for f in range(6)),
                   h, w, cfg)


def decode_batch_sharded(results: list[EncodeResult], mesh: Mesh,
                         max_iterations: int = 300, epsilon: float = 1e-5,
                         initial_value: int = 100, stall_window: int = 8,
                         stall_rtol: float = 0.02, pyramid: bool = False):
    """Decode a batch of encodes data-parallel across the mesh: each frame on
    the first device of its data shard, with the flat loop (its period-2 and
    stall exits; iterations count every step run, as the JAX package's
    sharded decode counts them) or, with ``pyramid=True``, the
    coarse-to-fine start and the fixed full-resolution floor
    (``DecoderConfig.pyramid``).

    Returns ([B, H, W] u8 images on the mesh's first device, [B] i32
    iterations, [B] f32 final mse), the last two on the CPU."""
    dcfg = DecoderConfig(max_iterations=max_iterations, epsilon=epsilon,
                         initial_value=initial_value, stall_window=stall_window,
                         stall_rtol=stall_rtol, pyramid=pyramid)
    home = mesh.devices[0][0]
    outs, iters, mses = [], [], []
    for res, devices in zip(results, mesh.frame_devices(len(results))):
        d = devices[0]
        arrays = {f: getattr(res, f).to(d) for f in ARRAY_FIELDS}
        arrays["distance"] = torch.zeros_like(arrays["s"])
        frame = dataclasses.replace(res, **arrays)
        out, it, mse = _decode_core(frame, dcfg, ran_steps=True)
        outs.append(out.to(home))
        iters.append(it)
        mses.append(mse)
    return (torch.stack(outs), torch.tensor(iters, dtype=torch.int32),
            torch.tensor(mses, dtype=torch.float32))
