"""Plane encoder (port of ``fractencode_tpu/encode/encoder.py``).

Pipeline for one u8 plane: 2x2 box sums (shared by the codebook's half image
and the classifier's quadrant sums) -> codebook and range blocks -> range and
domain classes (the brightness classifier, or learned VQ bins with
``vq_classes``) -> class-blocked search (``matcher.search_classed``); without
the classifier, no classes and the dense search (``matcher.search_dense``).
The per-range result plays the role of ``grid_encode_data_t``
(``encode/datatypes.h:8-26``).

On the card (``matcher.replays_graph``: every classed and dense encode of
a non-empty plane, whatever route the class counts take), the encode of a
plane is one CUDA graph (``utils.graphs``), the counterpart of the JAX
package's jitted ``encode_plane``.  The batch forms run it frame by frame
(the JAX package streams frames through ``lax.map`` in one program) into
preallocated [B, R] arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.classify import classify_grid
from ..core.grid import Grid, uniform_grid
from ..core.stats import block_sums_nonoverlapping, integral_image
from ..params import EncoderConfig
from ..utils import graphs
from ..utils.profiling import entry_span, mark, span
from ..utils.prng import prng_key
from .codebook import build_codebook, extract_ranges, range_sums
from .matcher import replays_graph, search_classed, search_dense
from . import vq
from .vq import assign_codes

__all__ = ["EncodeResult", "ARRAY_FIELDS", "encode_plane", "encode_batch",
           "encode_batch_stacked", "encode_stats", "default_device", "plane_on_device"]


@dataclasses.dataclass
class EncodeResult:
    """Encoded plane: per-range transform parameters (the compressed form).

    Range r covers the block at (x, y) = ((r % nx) * ts, (r // nx) * ts)
    with nx = width // target_size.
    """

    domain_idx: torch.Tensor  # [R] i32 row-major domain grid index
    transform: torch.Tensor  # [R] i32 TransformType
    s: torch.Tensor  # [R] f32 contrast
    o: torch.Tensor  # [R] f32 brightness
    distance: torch.Tensor  # [R] f32 search distance (criterion units)
    valid: torch.Tensor  # [R] bool

    width: int
    height: int
    source_size: int
    target_size: int
    domain_step: int
    # True: ``o`` holds the range's target mean and the decoder applies
    # ``s*(D - mean(D)) + o`` (the quantized bitstream's parameterization).
    o_is_mean: bool = False
    # Isometries the search considered (every stored transform id is below).
    num_transforms: int = 8

    @property
    def num_ranges(self) -> int:
        return (self.width // self.target_size) * (self.height // self.target_size)

    @property
    def domain_grid(self) -> Grid:
        return uniform_grid(self.width, self.height, self.source_size, self.domain_step)

    @property
    def range_grid(self) -> Grid:
        return uniform_grid(self.width, self.height, self.target_size, self.target_size)

    def domain_origins(self):
        """([R] x, [R] y) i32 global origins of each range's matched domain."""
        nx = self.domain_grid.nx
        ox = (self.domain_idx % nx) * self.domain_step
        oy = (self.domain_idx // nx) * self.domain_step
        return ox, oy


def default_device(device=None):
    """``device``, or the card when it is None: the CPU runs only where the
    caller asks for it.  Raises when no card is there to default to."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return "cuda"


def plane_on_device(plane, device=None) -> torch.Tensor:
    """The [H, W] u8 plane or [B, H, W] batch (numpy array or tensor) as a
    tensor on ``device``.  By default a tensor stays where it is and a numpy
    array goes to the card (``default_device``): the CPU runs only where the
    caller asks for it, with a CPU tensor or ``device='cpu'``."""
    if device is None and isinstance(plane, torch.Tensor):
        device = plane.device
    device = default_device(device)
    with span("fractencode.upload"):
        if not isinstance(plane, torch.Tensor):
            plane = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.uint8))
        return plane.to(device=device, dtype=torch.uint8)


# EncodeResult's per-range arrays
ARRAY_FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid")


def _normalize_affine(v: torch.Tensor) -> torch.Tensor:
    """Remove the components the search's affine map absorbs: zero-mean,
    ~unit-variance rows (variance floor 1 keeps flat blocks at ~0).  The
    mean is exact in f32 for the encoder's vectors (multiples of 1/4 below
    256); the variance sums the centred squares (exact products) in float64,
    and the scale 1/sqrt(var + 1) is computed in float64, then rounded to
    f32: the same elementwise ops on the card and the CPU (the JAX
    package's ``lax.rsqrt`` is XLA's approximation, within 2 ulp of it)."""
    c = v - v.mean(-1, keepdim=True)
    c64 = c.double()
    var = (c64 * c64).sum(-1, keepdim=True) / v.shape[-1]
    return c * (1.0 / torch.sqrt(var + 1.0)).float()


def _vq_vectors(ranges: torch.Tensor, cb):
    """(domain vectors, range vectors) of the VQ bins: the identity-isometry
    domains and the ranges, contrast- and brightness-normalized."""
    return _normalize_affine(cb.values[:, 0, :]), _normalize_affine(ranges)


def _vq_limit(d: int, cfg: EncoderConfig):
    return cfg.vq_sample_limit if cfg.vq_sample_limit < d else None


def _vq_labels(ranges: torch.Tensor, cb, codebook: torch.Tensor):
    """(range_classes, domain_classes): each vector's nearest codeword id,
    in the classifier's value convention (the class layout shifts by +1, so
    codeword ids 0..N-1 are returned as -1..N-2 -> bins 0..N-1)."""
    dvec, rvec = _vq_vectors(ranges, cb)
    return assign_codes(rvec, codebook) - 1, assign_codes(dvec, codebook) - 1


def _vq_classes(ranges: torch.Tensor, cb, cfg: EncoderConfig):
    """``_vq_labels`` of a learned LBG codebook, trained here."""
    dvec, _ = _vq_vectors(ranges, cb)
    codebook, _, _ = vq.train_codebook(dvec, prng_key(cfg.vq_seed), cfg.vq_classes,
                                       sample_limit=_vq_limit(dvec.shape[0], cfg))
    return _vq_labels(ranges, cb, codebook)


def _inputs(plane: torch.Tensor, cfg: EncoderConfig):
    """(codebook, ranges, SumA, SumA2, 2x2 box sums or None) of one [H, W] u8
    plane."""
    h, w = plane.shape
    plane_f32 = plane.to(torch.float32)
    domain_grid = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
    # one 2x2 box-sum pass feeds both the codebook's half image (x0.25,
    # exact) and the classifier's quadrant sums
    if h % 2 == 0 and w % 2 == 0:
        sums2x2 = block_sums_nonoverlapping(plane, 2)
        half = sums2x2.to(torch.float32) * 0.25
    else:
        sums2x2 = half = None
    cb = build_codebook(plane_f32, domain_grid, cfg.target_size,
                        cfg.num_transforms, half=half)
    ranges = extract_ranges(plane_f32, cfg.target_size)
    return (cb, ranges, *range_sums(ranges), sums2x2)


def _vq_start(plane: torch.Tensor, cfg: EncoderConfig) -> tuple:
    """The k-means' inputs for one plane's VQ bins (``vq._start``)."""
    cb, ranges, *_ = _inputs(plane, cfg)
    dvec, _ = _vq_vectors(ranges, cb)
    return vq._start(dvec, prng_key(cfg.vq_seed), cfg.vq_classes,
                     _vq_limit(dvec.shape[0], cfg))


def _encode_arrays(plane: torch.Tensor, cfg: EncoderConfig, codebook=None) -> tuple:
    """The six per-range arrays (``ARRAY_FIELDS``) of one [H, W] u8 plane.
    With ``vq_classes``, ``codebook`` is the trained VQ codebook, or None to
    train it here."""
    mark("inputs", plane)
    h, w = plane.shape
    cb, ranges, sum_a, sum_a2, sums2x2 = _inputs(plane, cfg)
    if cfg.vq_classes > 0:
        # learned pruning: the LBG codeword id as the class bin, on contrast-
        # and brightness-normalized vectors; the classed search runs on
        # these bins as on the classifier's (use_classifier forced on)
        range_classes, domain_classes = (_vq_classes(ranges, cb, cfg) if codebook is None
                                         else _vq_labels(ranges, cb, codebook))
        res = search_classed(ranges, sum_a, sum_a2, cb, range_classes, domain_classes,
                             dataclasses.replace(cfg, use_classifier=True))
    elif cfg.use_classifier:
        domain_grid = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
        range_grid = uniform_grid(w, h, cfg.target_size, cfg.target_size)
        ii = integral_image(plane)
        domain_classes = classify_grid(plane, domain_grid, ii=ii, sums2x2=sums2x2)
        range_classes = classify_grid(plane, range_grid, ii=ii, sums2x2=sums2x2)
        res = search_classed(ranges, sum_a, sum_a2, cb, range_classes,
                             domain_classes, cfg)
    else:
        res = search_dense(ranges, sum_a, sum_a2, cb, None, None, cfg)
    return tuple(getattr(res, f) for f in ARRAY_FIELDS)


def _replays(h: int, w: int, cfg: EncoderConfig, device) -> bool:
    """Whether the encode of an [h, w] plane on ``device`` runs in a CUDA
    graph (``matcher.replays_graph``), decided before any work."""
    r = (h // cfg.target_size) * (w // cfg.target_size)
    m = uniform_grid(w, h, cfg.source_size, cfg.domain_step).num_items * cfg.num_transforms
    return replays_graph(r, m, cfg, device)


def _frame_arrays(plane: torch.Tensor, cfg: EncoderConfig, graph: bool) -> tuple:
    """``_encode_arrays`` of one plane, eager or through its graph; the
    graph's outputs are its own, overwritten by the next frame.  With
    ``vq_classes`` the graph form is three: the k-means' start, its chunks
    (``vq._kmeans``) and the encode given the trained codebook (the start
    and the encode each build the codebook and the ranges)."""
    if not graph:
        return _encode_arrays(plane, cfg)
    if cfg.vq_classes > 0:
        start = graphs.replay("encode_plane_vq_start", (cfg,),
                              lambda p: _vq_start(p, cfg), plane)
        codebook, _ = vq._kmeans(*start, vq.MAX_STEPS, vq.EPSILON, graph=True)
        return graphs.replay("encode_plane", (cfg,),
                             lambda p, c: _encode_arrays(p, cfg, c), plane, codebook)
    return graphs.replay("encode_plane", (cfg,), lambda p: _encode_arrays(p, cfg), plane)


def _result(arrays, h: int, w: int, cfg: EncoderConfig) -> EncodeResult:
    return EncodeResult(**dict(zip(ARRAY_FIELDS, arrays)), width=w, height=h,
                        source_size=cfg.source_size, target_size=cfg.target_size,
                        domain_step=cfg.domain_step, num_transforms=cfg.num_transforms)


def _check_aligned(h: int, w: int, cfg: EncoderConfig) -> None:
    if h % cfg.target_size or w % cfg.target_size:
        raise ValueError("image not aligned to range grid")  # partition2.hpp:119


@entry_span
def encode_plane(plane, cfg: EncoderConfig | None = None, *,
                 device: torch.device | str | None = None) -> EncodeResult:
    """Encode one [H, W] u8 plane (numpy array or tensor) on ``device``
    (default: the tensor's device, or the card for a numpy array; see
    ``plane_on_device``).  On the card, where ``matcher.replays_graph``
    allows, the encode is one CUDA graph for each (shape, config, device),
    run eagerly at its first call and captured at its second
    (``utils.graphs``); a replay's result is a copy of the graph's outputs."""
    cfg = cfg or EncoderConfig()
    plane = plane_on_device(plane, device)
    h, w = plane.shape
    _check_aligned(h, w, cfg)
    graph = _replays(h, w, cfg, plane.device)
    arrays = _frame_arrays(plane, cfg, graph)
    if graph:
        arrays = tuple(x.clone() for x in arrays)
    return _result(arrays, h, w, cfg)


@entry_span
def encode_batch_stacked(planes, cfg: EncoderConfig | None = None, *,
                         device: torch.device | str | None = None) -> EncodeResult:
    """Encode a [B, H, W] u8 batch (numpy array or tensor) on ``device``
    (``plane_on_device``'s rule) and return ONE EncodeResult whose arrays
    carry a leading batch axis ([B, R]).  Frames run one after another as in
    ``encode_plane``, each into its row of the preallocated arrays, so each
    equals its single-plane encode; on the graph, the call reads nothing
    back from the card."""
    cfg = cfg or EncoderConfig()
    planes = plane_on_device(planes, device)
    _, h, w = planes.shape
    _check_aligned(h, w, cfg)
    return _encode_batch(planes, cfg, _replays(h, w, cfg, planes.device))


def _encode_batch(planes: torch.Tensor, cfg: EncoderConfig, graph: bool) -> EncodeResult:
    """``encode_batch_stacked`` of a [B, H, W] u8 tensor, its frames eager
    or through the graph."""
    b, h, w = planes.shape
    rows = None
    for i in range(b):
        arrays = _frame_arrays(planes[i], cfg, graph)
        if rows is None:
            rows = [x.new_empty((b, *x.shape)) for x in arrays]
        for row, x in zip(rows, arrays):
            row[i] = x
    return _result(rows, h, w, cfg)


def encode_batch(planes, cfg: EncoderConfig | None = None, *,
                 device: torch.device | str | None = None) -> list[EncodeResult]:
    """Encode a [B, H, W] u8 batch; one EncodeResult per frame (slices of
    ``encode_batch_stacked``'s arrays)."""
    stacked = encode_batch_stacked(planes, cfg, device=device)
    return [dataclasses.replace(stacked, **{f: getattr(stacked, f)[i] for f in ARRAY_FIELDS})
            for i in range(stacked.domain_idx.shape[0])]


def encode_stats(result: EncodeResult, range_classes=None, domain_classes=None):
    """Classifier rejection statistics (cf. ``encode_stats_t``,
    ``Encoder2.hpp:17-24``): a pair is rejected iff the class bins differ, so
    ``rejected = R*D - sum_c R_c * D_c`` over the 7 class histograms."""
    total = result.num_ranges * result.domain_grid.num_items
    if range_classes is None or domain_classes is None:
        return dict(total_mappings=total, rejected_mappings=0)
    rh = np.bincount(np.asarray(range_classes).ravel() + 1, minlength=7)
    dh = np.bincount(np.asarray(domain_classes).ravel() + 1, minlength=7)
    rejected = int(total - int((rh.astype(np.int64) * dh.astype(np.int64)).sum()))
    return dict(total_mappings=total, rejected_mappings=rejected)
