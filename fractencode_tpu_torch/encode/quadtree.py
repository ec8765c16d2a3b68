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

The JAX package runs the pyramid as one fused program or level by level;
PyTorch runs eagerly, so there is one form here, the per-level loop.  The
batch forms run it frame by frame (the JAX package's ``lax.map``) and stack
each level's arrays; the sharded forms run each data shard's frames on its
own device (``parallel.mesh``); the FTQ1 bitstream is
``codec/bitstream_quadtree.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.classify import classify_grid
from ..core.grid import uniform_grid
from ..core.stats import block_sums_nonoverlapping, integral_image
from ..params import DecoderConfig, EncoderConfig
from .codebook import build_codebook, extract_ranges, range_sums
from .encoder import plane_on_device
from .matcher import mask_ranges_result, search_classed, search_dense

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


def encode_plane_quadtree(plane, cfg: EncoderConfig | None = None,
                          qcfg: QuadtreeConfig | None = None, reporter=None, *,
                          device: torch.device | str | None = None
                          ) -> QuadtreeResult:
    """Adaptive-depth encode of one [H, W] u8 plane (numpy array or tensor)
    on ``device`` (default: the tensor's, or the card for a numpy array; see
    ``encoder.plane_on_device``): coarse blocks where they fit, fine where
    needed.  ``cfg`` (its ``rms_threshold`` among the rest, not
    ``vq_classes``) applies at every level; ``reporter`` (a
    ``utils.ProgressReporter``) logs each level done."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    plane = plane_on_device(plane, device)
    h, w = plane.shape
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")
    plane_f32 = plane.to(torch.float32)
    levels = []
    covered = None  # [ny, nx] bool at the current level's resolution
    sizes = qcfg.level_sizes
    for i, rs in enumerate(sizes):
        ds = rs * qcfg.domain_ratio
        step = ds // qcfg.lattice
        lcfg = dataclasses.replace(cfg, source_size=ds, target_size=rs,
                                   lattice=qcfg.lattice)
        range_mask = (None if covered is None or not qcfg.mask_covered
                      else ~covered.reshape(-1))
        res, err = _encode_level(plane, plane_f32, lcfg, rs, ds, step,
                                 range_mask=range_mask)
        ny, nx = h // rs, w // rs
        if covered is None:
            covered = torch.zeros((ny, nx), dtype=torch.bool, device=plane.device)
        if i == len(sizes) - 1:
            accept2d = ~covered
        else:
            accept2d = ~covered & (err.reshape(ny, nx) <= qcfg.error_threshold)
        covered = covered | accept2d
        levels.append(QuadtreeLevel(
            domain_idx=res.domain_idx, transform=res.transform, s=res.s,
            o=res.o, error=err, accepted=accept2d.reshape(-1), range_size=rs,
            domain_size=ds, domain_step=step, num_transforms=cfg.num_transforms))
        if i < len(sizes) - 1:
            covered = _upsample_mask(covered)
        if reporter is not None:
            reporter.log(i + 1, len(sizes))
    return QuadtreeResult(levels=levels, width=w, height=h)


# QuadtreeLevel's per-range arrays
LEVEL_ARRAY_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")


def encode_batch_quadtree_stacked(planes, cfg: EncoderConfig | None = None,
                                  qcfg: QuadtreeConfig | None = None, *,
                                  device: torch.device | str | None = None
                                  ) -> QuadtreeResult:
    """Quadtree-encode a [B, H, W] u8 batch (numpy array or tensor) on
    ``device`` (``encoder.plane_on_device``'s rule) and return ONE
    QuadtreeResult whose level arrays carry a leading batch axis.  Frames run
    one after another through ``encode_plane_quadtree``, so each equals its
    single-plane encode."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    planes = plane_on_device(planes, device)
    _, h, w = planes.shape
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")
    frames = [encode_plane_quadtree(p, cfg, qcfg) for p in planes]
    levels = [dataclasses.replace(level, **{
                  f: torch.stack([getattr(r.levels[i], f) for r in frames])
                  for f in LEVEL_ARRAY_FIELDS})
              for i, level in enumerate(frames[0].levels)]
    return QuadtreeResult(levels=levels, width=w, height=h)


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
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")
    return [encode_plane_quadtree(p, cfg, qcfg, device=devices[0])
            for p, devices in zip(planes, mesh.frame_devices(planes.shape[0]))]


# ---------------------------------------------------------------------------
# decode (the uniform decoder's helpers are imported inside the functions:
# decode.decoder imports this package)


def _quadtree_step_at(levels, h: int, w: int, f: int):
    """The composite decode step at scale 1/f (f = 1 is full resolution):
    each level's full image (the uniform decoder's step), each pixel taken
    from the level that holds its leaf."""
    from ..decode.decoder import _decode_step, build_decode_tables

    hf, wf = h // f, w // f
    tables = [build_decode_tables(l.domain_idx, l.transform, wf, hf,
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


def _pyramid_init_quadtree(levels, h: int, w: int, dcfg: DecoderConfig):
    """Coarse-to-fine start image for the quadtree loop, or None (the
    uniform decoder's scheme with composite steps, at the scales every
    level supports)."""
    from ..decode.decoder import _coarse_to_fine, pyramid_factors

    fs = None
    for l in levels:
        lf = pyramid_factors(h, w, l.range_size, l.domain_size, l.domain_step,
                             max_levels=dcfg.pyramid_levels)
        fs = set(lf) if fs is None else fs & set(lf)
    return _coarse_to_fine(tuple(sorted(fs or (), reverse=True)),
                           lambda f: _quadtree_step_at(levels, h, w, f), h, w,
                           dcfg, levels[0].s.device)


def decode_plane_quadtree(result: QuadtreeResult,
                          dcfg: DecoderConfig = DecoderConfig(), *,
                          device: torch.device | str | None = None):
    """Fixed-point decode of a quadtree encode on ``device`` (default: the
    result's), with the uniform decoder's loop and exits.  Returns (u8
    [H, W] tensor, iterations int, mse float)."""
    from ..decode.decoder import _fixed_point, _to_device

    levels = [_to_device(l, device) for l in result.levels]
    h, w = result.height, result.width
    init = torch.full((h, w), dcfg.initial_value, dtype=torch.uint8,
                      device=levels[0].s.device)
    start = _pyramid_init_quadtree(levels, h, w, dcfg) if dcfg.pyramid else None
    return _fixed_point(_quadtree_step_at(levels, h, w, 1), init, start, dcfg)


def decode_batch_quadtree_sharded(results: list[QuadtreeResult], mesh,
                                  dcfg: DecoderConfig = DecoderConfig()):
    """Decode a batch of quadtree encodes data-parallel over the mesh's
    'data' axis: frame b with ``decode_plane_quadtree``'s loop and exits on
    the first device of data shard b // (B / n_data).

    Returns ([B, H, W] u8 images on the mesh's first device, [B] i32
    iterations, [B] f32 final mse), the last two on the CPU."""
    home = mesh.devices[0][0]
    outs, iters, mses = [], [], []
    for res, devices in zip(results, mesh.frame_devices(len(results))):
        out, it, mse = decode_plane_quadtree(res, dcfg, device=devices[0])
        outs.append(out.to(home))
        iters.append(it)
        mses.append(mse)
    return (torch.stack(outs), torch.tensor(iters, dtype=torch.int32),
            torch.tensor(mses, dtype=torch.float32))
