"""Quadtree adaptive range partitioning (port of ``fractencode_tpu/encode/quadtree.py``).

Every level of the size pyramid (range sizes ``max_size`` down to
``min_size``, powers of two) is encoded as a full uniform grid with the
single-level search, coarse to fine.  A block is *accepted* at the coarsest
level where its per-pixel error meets the threshold (the finest level
accepts whatever remains); the blocks under an accepted coarser leaf are
parked by the coverage ``range_mask``, so finer levels search only the
uncovered ones.  No tree is built: one boolean mask per level.

Decode composes per-level decode steps with per-pixel masks: every level's
grid tiles the plane, so each produces a full image, and the output takes
each pixel from the level that holds its leaf.

The JAX package runs the pyramid as one fused program, or level by level
for a progress reporter; so does the port: on the card (``_replays``) the
pyramid is one CUDA graph (``utils.graphs``), and the per-level loop runs
eagerly otherwise.  The batch forms run it frame by frame (the JAX
package's ``lax.map``) into preallocated level arrays; the sharded forms
run each data shard's frames on its own device (``parallel.mesh``); the
decode is one graph from the pyramid, or the flat loop's chunks
(``graphs.while_loop``); the FTQ1 bitstream is
``codec/bitstream_quadtree.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.classify import classify_grid
from ..core.grid import uniform_grid
from ..core.stats import block_sums_nonoverlapping, integral_image
from ..params import DecoderConfig, EncoderConfig
from ..utils import graphs
from ..utils.profiling import entry_span, mark
from .codebook import build_codebook, extract_ranges, range_sums
from .encoder import plane_on_device
from .matcher import mask_ranges_result, replays_graph, search_classed, search_dense

__all__ = ["QuadtreeConfig", "QuadtreeLevel", "QuadtreeResult",
           "encode_plane_quadtree", "encode_batch_quadtree",
           "encode_batch_quadtree_stacked", "encode_batch_quadtree_sharded",
           "decode_plane_quadtree", "decode_batch_quadtree_sharded"]


@dataclasses.dataclass(frozen=True)
class QuadtreeConfig:
    min_size: int = 4  # finest range size
    max_size: int = 16  # coarsest range size
    error_threshold: float = 50.0  # accept a level if per-pixel MSE <= this
    domain_ratio: int = 4  # domain = ratio * range per level
    lattice: int = 2  # domain step = domain_size // lattice
    # skip searching blocks already covered by an accepted coarser leaf
    # (bit-identical accepted leaves; False searches every level fully)
    mask_covered: bool = True

    def __post_init__(self):
        if self.min_size > self.max_size:
            raise ValueError("min_size > max_size")
        for s in (self.min_size, self.max_size, self.domain_ratio):
            if s & (s - 1):
                raise ValueError("sizes must be powers of two")

    @property
    def level_sizes(self) -> tuple[int, ...]:
        """Coarse -> fine range sizes."""
        sizes = []
        s = self.max_size
        while s >= self.min_size:
            sizes.append(s)
            s //= 2
        return tuple(sizes)


@dataclasses.dataclass
class QuadtreeLevel:
    """One pyramid level: a full uniform-grid encode plus its leaf mask."""

    domain_idx: torch.Tensor  # [R_l] i32
    transform: torch.Tensor  # [R_l] i32
    s: torch.Tensor  # [R_l] f32
    o: torch.Tensor  # [R_l] f32
    error: torch.Tensor  # [R_l] f32 per-pixel MSE under the stored map
    accepted: torch.Tensor  # [R_l] bool: this block is a leaf of the tree

    range_size: int
    domain_size: int
    domain_step: int
    # True when 'o' stores the target block mean (the bitstream's
    # parameterization; see the JAX package's codec.bitstream)
    o_is_mean: bool = False
    num_transforms: int = 8  # isometries the search considered


# QuadtreeLevel's per-range arrays
LEVEL_ARRAY_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")


@dataclasses.dataclass
class QuadtreeResult:
    levels: list[QuadtreeLevel]
    width: int
    height: int

    @property
    def num_leaves(self) -> int:
        return int(sum(int(l.accepted.sum()) for l in self.levels))


def _per_pixel_error(res, k: int, criterion: str, domain_area: int):
    """A search distance in per-pixel MSE units, for thresholding."""
    if criterion == "raw":
        # raw distance = sum / domain_area (metrics.h:49); per pixel = sum / K
        return res.distance * (domain_area / k)
    return res.distance  # the affine criterion is already per range pixel


def _encode_level(plane, plane_f32, cfg: EncoderConfig, range_size: int,
                  domain_size: int, domain_step: int, range_mask=None):
    """One level's uniform-grid encode: (SearchResult, per-pixel error, inf
    where no domain shares the range's class).  With the classifier the
    class-blocked search skips the ranges ``range_mask`` excludes; the dense
    search has no pair list to shrink, so it searches them all and masks
    them after, as the JAX package does."""
    mark("inputs", plane)
    h, w = plane.shape
    domain_grid = uniform_grid(w, h, domain_size, domain_step)
    range_grid = uniform_grid(w, h, range_size, range_size)
    if h % 2 == 0 and w % 2 == 0:
        sums2x2 = block_sums_nonoverlapping(plane, 2)
        half = sums2x2.to(torch.float32) * 0.25
    else:
        sums2x2 = half = None
    cb = build_codebook(plane_f32, domain_grid, range_size, cfg.num_transforms,
                        half=half)
    ranges = extract_ranges(plane_f32, range_size)
    sum_a, sum_a2 = range_sums(ranges)
    if cfg.use_classifier:
        ii = integral_image(plane)
        dcls = classify_grid(plane, domain_grid, ii=ii, sums2x2=sums2x2)
        rcls = classify_grid(plane, range_grid, ii=ii, sums2x2=sums2x2)
        res = search_classed(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                             range_mask=range_mask)
    else:
        res = search_dense(ranges, sum_a, sum_a2, cb, None, None, cfg)
        if range_mask is not None:
            res = mask_ranges_result(res, range_mask)
    err = _per_pixel_error(res, range_size * range_size, cfg.criterion,
                           domain_size * domain_size)
    return res, torch.where(res.valid, err, torch.inf)


def _upsample_mask(mask2d: torch.Tensor) -> torch.Tensor:
    """[ny, nx] bool -> [2ny, 2nx] bool (each parent covers 4 children)."""
    return mask2d.repeat_interleave(2, 0).repeat_interleave(2, 1)


def _quadtree_arrays(plane: torch.Tensor, cfg: EncoderConfig, qcfg: QuadtreeConfig,
                     reporter=None) -> tuple:
    """Every level's six arrays (``LEVEL_ARRAY_FIELDS``, coarse to fine) of
    one [H, W] u8 plane, as one flat tuple: the per-level encodes and the
    selection cascade.  ``reporter`` logs each level done."""
    h, w = plane.shape
    plane_f32 = plane.to(torch.float32)
    arrays = []
    covered = None  # [ny, nx] bool at the current level's resolution
    sizes = qcfg.level_sizes
    for i, rs in enumerate(sizes):
        ds = rs * qcfg.domain_ratio
        range_mask = (None if covered is None or not qcfg.mask_covered
                      else ~covered.reshape(-1))
        res, err = _encode_level(plane, plane_f32, _level_config(cfg, qcfg, rs), rs, ds,
                                 ds // qcfg.lattice, range_mask=range_mask)
        ny, nx = h // rs, w // rs
        if covered is None:
            covered = torch.zeros((ny, nx), dtype=torch.bool, device=plane.device)
        if i == len(sizes) - 1:
            accept2d = ~covered
        else:
            accept2d = ~covered & (err.reshape(ny, nx) <= qcfg.error_threshold)
        covered = covered | accept2d
        arrays += [res.domain_idx, res.transform, res.s, res.o, err, accept2d.reshape(-1)]
        if i < len(sizes) - 1:
            covered = _upsample_mask(covered)
        if reporter is not None:
            reporter.log(i + 1, len(sizes))
    return tuple(arrays)


def _level_config(cfg: EncoderConfig, qcfg: QuadtreeConfig, rs: int) -> EncoderConfig:
    """The uniform-grid config of the level of ``rs`` px ranges (the levels
    search without VQ bins)."""
    return dataclasses.replace(cfg, source_size=rs * qcfg.domain_ratio, target_size=rs,
                               lattice=qcfg.lattice, vq_classes=0)


def _replays(h: int, w: int, cfg: EncoderConfig, qcfg: QuadtreeConfig, device) -> bool:
    """Whether the quadtree encode of an [h, w] plane on ``device`` runs in
    one CUDA graph, decided before any work: every level's search may
    (``matcher.replays_graph``)."""
    for rs in qcfg.level_sizes:
        lcfg = _level_config(cfg, qcfg, rs)
        r = (h // rs) * (w // rs)
        m = (uniform_grid(w, h, lcfg.source_size, lcfg.domain_step).num_items
             * cfg.num_transforms)
        if not replays_graph(r, m, lcfg, device):
            return False
    return True


def _frame_levels(plane: torch.Tensor, cfg: EncoderConfig, qcfg: QuadtreeConfig,
                  graph: bool) -> tuple:
    """``_quadtree_arrays`` of one plane, eager or through its CUDA graph
    (the counterpart of the JAX package's ``_encode_quadtree_fused``); the
    graph's outputs are its own, overwritten by the next frame."""
    if not graph:
        return _quadtree_arrays(plane, cfg, qcfg)
    return graphs.replay("encode_plane_quadtree", (cfg, qcfg),
                         lambda p: _quadtree_arrays(p, cfg, qcfg), plane)


def _levels(arrays, h: int, w: int, cfg: EncoderConfig, qcfg: QuadtreeConfig
            ) -> QuadtreeResult:
    """The QuadtreeResult of ``_quadtree_arrays``' flat tuple."""
    nf = len(LEVEL_ARRAY_FIELDS)
    levels = [QuadtreeLevel(**dict(zip(LEVEL_ARRAY_FIELDS, arrays[nf * i:nf * (i + 1)])),
                            range_size=rs, domain_size=rs * qcfg.domain_ratio,
                            domain_step=rs * qcfg.domain_ratio // qcfg.lattice,
                            num_transforms=cfg.num_transforms)
              for i, rs in enumerate(qcfg.level_sizes)]
    return QuadtreeResult(levels=levels, width=w, height=h)


def _check_aligned(h: int, w: int, qcfg: QuadtreeConfig) -> None:
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")


@entry_span
def encode_plane_quadtree(plane, cfg: EncoderConfig | None = None,
                          qcfg: QuadtreeConfig | None = None, reporter=None, *,
                          device: torch.device | str | None = None
                          ) -> QuadtreeResult:
    """Adaptive-depth encode of one [H, W] u8 plane (numpy array or tensor)
    on ``device`` (default: the tensor's, or the card for a numpy array; see
    ``encoder.plane_on_device``): coarse blocks where they fit, fine where
    needed.  ``cfg`` (its ``rms_threshold`` among the rest, not
    ``vq_classes``) applies at every level.  On the card, where ``_replays``
    allows, the whole pyramid is one CUDA graph for each (shape, config,
    device), run eagerly at its first call and captured at its second
    (``utils.graphs``); a replay's result is a copy of the graph's outputs.
    ``reporter`` (a ``utils.ProgressReporter``) logs each level done, from
    the per-level eager loop, as the JAX package does."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    plane = plane_on_device(plane, device)
    h, w = plane.shape
    _check_aligned(h, w, qcfg)
    if reporter is not None:
        return _levels(_quadtree_arrays(plane, cfg, qcfg, reporter), h, w, cfg, qcfg)
    graph = _replays(h, w, cfg, qcfg, plane.device)
    arrays = _frame_levels(plane, cfg, qcfg, graph)
    if graph:
        arrays = tuple(x.clone() for x in arrays)
    return _levels(arrays, h, w, cfg, qcfg)


@entry_span
def encode_batch_quadtree_stacked(planes, cfg: EncoderConfig | None = None,
                                  qcfg: QuadtreeConfig | None = None, *,
                                  device: torch.device | str | None = None
                                  ) -> QuadtreeResult:
    """Quadtree-encode a [B, H, W] u8 batch (numpy array or tensor) on
    ``device`` (``encoder.plane_on_device``'s rule) and return ONE
    QuadtreeResult whose level arrays carry a leading batch axis.  Frames run
    one after another as in ``encode_plane_quadtree`` (the JAX package's
    ``lax.map``), each into its row of the preallocated arrays, so each
    equals its single-plane encode; on the graph, the call reads nothing
    back from the card."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    planes = plane_on_device(planes, device)
    _, h, w = planes.shape
    _check_aligned(h, w, qcfg)
    return _encode_batch(planes, cfg, qcfg, _replays(h, w, cfg, qcfg, planes.device))


def _encode_batch(planes: torch.Tensor, cfg: EncoderConfig, qcfg: QuadtreeConfig,
                  graph: bool) -> QuadtreeResult:
    """``encode_batch_quadtree_stacked`` of a [B, H, W] u8 tensor, its frames
    eager or through the graph."""
    b, h, w = planes.shape
    rows = None
    for i in range(b):
        arrays = _frame_levels(planes[i], cfg, qcfg, graph)
        if rows is None:
            rows = [x.new_empty((b, *x.shape)) for x in arrays]
        for row, x in zip(rows, arrays):
            row[i] = x
    return _levels(rows, h, w, cfg, qcfg)


def encode_batch_quadtree(planes, cfg: EncoderConfig | None = None,
                          qcfg: QuadtreeConfig | None = None, *,
                          device: torch.device | str | None = None
                          ) -> list[QuadtreeResult]:
    """Quadtree-encode a [B, H, W] u8 batch; one QuadtreeResult per frame
    (slices of ``encode_batch_quadtree_stacked``'s level arrays)."""
    stacked = encode_batch_quadtree_stacked(planes, cfg, qcfg, device=device)

    def frame(i):
        return [dataclasses.replace(l, **{f: getattr(l, f)[i] for f in LEVEL_ARRAY_FIELDS})
                for l in stacked.levels]

    return [QuadtreeResult(levels=frame(i), width=stacked.width, height=stacked.height)
            for i in range(stacked.levels[0].domain_idx.shape[0])]


def encode_batch_quadtree_sharded(planes, cfg: EncoderConfig | None,
                                  qcfg: QuadtreeConfig | None, mesh) -> list[QuadtreeResult]:
    """Quadtree-encode a [B, H, W] u8 batch (numpy array or tensor)
    data-parallel over the mesh's 'data' axis (``parallel.mesh.Mesh``):
    frame b runs the whole pyramid (``encode_plane_quadtree``) on the first
    device of data shard b // (B / n_data); no cross-frame communication
    exists to shard, and the search axis is not used.  One QuadtreeResult
    per frame, on that device."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    planes = plane_on_device(planes, mesh.devices[0][0])
    _, h, w = planes.shape
    _check_aligned(h, w, qcfg)
    return [encode_plane_quadtree(p, cfg, qcfg, device=devices[0])
            for p, devices in zip(planes, mesh.frame_devices(planes.shape[0]))]


# ---------------------------------------------------------------------------
# decode (the uniform decoder's helpers are imported inside the functions:
# decode.decoder imports this package)


def _quadtree_step_at(levels, h: int, w: int, f: int):
    """The composite decode step at scale 1/f (f = 1 is full resolution):
    each level's full image (the uniform decoder's step), each pixel taken
    from the level that holds its leaf."""
    from ..decode.decoder import _decode_step, _step_tables

    hf, wf = h // f, w // f
    tables = [_step_tables(l.domain_idx, l.transform, wf, hf,
                           l.domain_size // f, l.range_size // f,
                           l.domain_step // f, l.num_transforms)
              for l in levels]
    pixel_masks = [l.accepted.reshape(h // l.range_size, w // l.range_size)
                   .repeat_interleave(l.range_size // f, 0)
                   .repeat_interleave(l.range_size // f, 1) for l in levels]

    def step(img):
        out = torch.zeros((hf, wf), dtype=torch.uint8, device=img.device)
        for l, tab, pmask in zip(levels, tables, pixel_masks):
            lvl = _decode_step(img, tab, l.s, l.o, hf, wf, l.range_size // f,
                               l.o_is_mean)
            out = torch.where(pmask, lvl, out)
        return out

    return step


def _pyramid_factors(levels, h: int, w: int, dcfg: DecoderConfig) -> tuple:
    """The coarse-to-fine scale factors every level supports (the uniform
    decoder's ``pyramid_factors``), coarsest first, from the geometry."""
    from ..decode.decoder import pyramid_factors

    fs = None
    for l in levels:
        lf = pyramid_factors(h, w, l.range_size, l.domain_size, l.domain_step,
                             max_levels=dcfg.pyramid_levels)
        fs = set(lf) if fs is None else fs & set(lf)
    return tuple(sorted(fs or (), reverse=True))


# the level arrays a decode reads
_DECODE_FIELDS = ("domain_idx", "transform", "s", "o", "accepted")


def _decode_levels(arrays, geometry) -> list:
    """Decode-only levels (no ``error``) from their arrays (``_DECODE_FIELDS``
    level after level) and their geometry (``_level_geometry``)."""
    nf = len(_DECODE_FIELDS)
    return [QuadtreeLevel(**dict(zip(_DECODE_FIELDS, arrays[nf * i:nf * (i + 1)])),
                          error=None, **g) for i, g in enumerate(geometry)]


def _level_geometry(l: QuadtreeLevel) -> dict:
    return dict(range_size=l.range_size, domain_size=l.domain_size,
                domain_step=l.domain_step, o_is_mean=l.o_is_mean,
                num_transforms=l.num_transforms)


def decode_plane_quadtree(result: QuadtreeResult,
                          dcfg: DecoderConfig = DecoderConfig(), *,
                          device: torch.device | str | None = None):
    """Fixed-point decode of a quadtree encode on ``device`` (default: the
    result's), with the uniform decoder's loop and exits.  Returns (u8
    [H, W] tensor, iterations int, mse float).  On the card the pyramid
    decode is one CUDA graph, and the flat loop's chunks replay one
    (``graphs.while_loop``), each for a (geometry, config, device)."""
    from ..decode.decoder import _to_device

    result = dataclasses.replace(result, levels=[_to_device(l, device) for l in result.levels])
    graph = result.levels[0].s.device.type == "cuda"
    img, it, mse = _decode(result, dcfg, graph)
    return (img.clone() if graph else img), int(it), float(mse)


def _decode(result: QuadtreeResult, dcfg: DecoderConfig, graph: bool):
    """``decode_plane_quadtree``'s (image, iterations, mse), eager or
    through its graphs; the image is a graph's own output with ``graph``."""
    from ..decode.decoder import _coarse_to_fine, _flat_loop, _full_res, _full_steps

    levels = result.levels
    h, w = result.height, result.width
    dev = levels[0].s.device
    geometry = tuple(_level_geometry(l) for l in levels)
    statics = (h, w, *(tuple(g.items()) for g in geometry))
    arrays = tuple(getattr(l, f) for l in levels for f in _DECODE_FIELDS)
    fs = _pyramid_factors(levels, h, w, dcfg) if dcfg.pyramid else ()
    if fs:
        def decode(*arrays):
            ls = _decode_levels(arrays, geometry)
            start = _coarse_to_fine(fs, lambda f: _quadtree_step_at(ls, h, w, f), h, w,
                                    dcfg, dev)
            return _full_res(_quadtree_step_at(ls, h, w, 1), start, dcfg)

        img, mse = (graphs.replay("decode_plane_quadtree", (dcfg, *statics), decode, *arrays)
                    if graph else decode(*arrays))
        return img, _full_steps(dcfg), mse
    init = torch.full((h, w), dcfg.initial_value, dtype=torch.uint8, device=dev)
    return _flat_loop("decode_plane_quadtree_flat", statics,
                      lambda *a: _quadtree_step_at(_decode_levels(a, geometry), h, w, 1),
                      arrays, init, dcfg, graph)


def decode_batch_quadtree_sharded(results: list[QuadtreeResult], mesh,
                                  dcfg: DecoderConfig = DecoderConfig()):
    """Decode a batch of quadtree encodes data-parallel over the mesh's
    'data' axis: frame b with ``decode_plane_quadtree``'s loop and exits on
    the first device of data shard b // (B / n_data), on the card through
    its graphs (``_decode``), into its row of the preallocated outputs.

    Returns ([B, H, W] u8 images on the mesh's first device, [B] i32
    iterations, [B] f32 final mse), the last two on the CPU, read back
    once."""
    return _decode_batch_sharded(results, mesh, dcfg)


def _decode_batch_sharded(results: list[QuadtreeResult], mesh, dcfg: DecoderConfig,
                          graph: bool | None = None):
    """``decode_batch_quadtree_sharded``: through the graphs with ``graph``,
    eagerly without; None: on the card."""
    from ..decode.decoder import _read_back, _to_device

    home = mesh.devices[0][0]
    b = len(results)
    outs = iters = mses = None
    for i, (res, devices) in enumerate(zip(results, mesh.frame_devices(b))):
        d = devices[0]
        frame = dataclasses.replace(res, levels=[_to_device(l, d) for l in res.levels])
        img, it, mse = _decode(frame, dcfg, d.type == "cuda" if graph is None else graph)
        if outs is None:
            outs = torch.empty((b, *img.shape), dtype=img.dtype, device=home)
            iters = torch.empty((b,), dtype=torch.int32, device=home)
            mses = torch.empty((b,), dtype=torch.float32, device=home)
        outs[i], mses[i] = img, mse
        if isinstance(it, int):  # the pyramid's fixed count
            iters[i].fill_(it)
        else:
            iters[i] = it
    return (outs, *_read_back(iters, mses))
