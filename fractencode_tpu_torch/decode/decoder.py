"""Fixed-point PIFS decoder (port of ``fractencode_tpu/decode/decoder.py``).

Reference semantics (``Encoder2.hpp:60-99``, ``DecodeUtils.hpp:9-25``): start
from a flat gray image and apply the whole map set Jacobi-style until the
inter-iterate MSE drops below epsilon or 300 iterations.  Per range pixel:
sample the isometry-mapped domain (2x2 average), apply ``s*v + o``, clamp to
[0, 255] and truncate to u8.

One step is a gather of every range's K domain samples through static tap
tables, an affine map and a reshape; ranges tile the image, so there is no
scatter.  On the card a step is one launch of a hand-written kernel
(``ops.decode_kernels``) that writes the next image and nothing else; on
the CPU it is those torch ops (``_decode_step_torch``).  The pyramid loop
runs a fixed count, which on the card is one CUDA graph (``utils.graphs``;
the counterpart of the JAX package's jitted ``decode_plane``) whose MSE is
read once.  The flat loop carries its exit
tests on the device (``graphs.while_loop``, the counterpart of its
``lax.while_loop``): chunks of predicated steps, one CUDA graph on the
card, the exit flag read once a chunk.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.sampler import all_tap_tables
from ..core.transform import NUM_TRANSFORMS
from ..encode.encoder import ARRAY_FIELDS, EncodeResult
from ..ops.decode_kernels import cell_corners, decode_step_cuda
from ..params import DecoderConfig
from ..utils import graphs
from ..utils.profiling import entry_span
from ..utils.tables import device_table

__all__ = ["decode_plane", "decode_batch_stacked", "decode_steps_py",
           "build_decode_tables", "sample_domains", "half_res_image", "pyramid_factors"]


@functools.lru_cache(maxsize=None)
def _global_tap_tables(source_size: int, target_size: int, stride: int) -> np.ndarray:
    """[NUM_TRANSFORMS, K, 4] flat *image* offsets of the 4 sample taps for
    every output pixel of a domain block anchored at flat origin 0."""
    local = all_tap_tables(source_size, target_size)  # block-flat, stride=sw
    my, mx = np.divmod(local, source_size)
    return (my.astype(np.int64) * stride + mx).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _half_res_taps(source_size: int, target_size: int, width: int):
    """[NUM_TRANSFORMS, K] single-tap flat indices into the [H/2, W/2] half
    image for a domain anchored at half-image origin 0, or None.

    The 4 taps of every sample are the isometry image of an axis-aligned 2x2
    cell; when every cell's min corner is even, the 4-tap average is one
    pixel of the 2x2-box-downsampled image.
    """
    sw = source_size
    if sw % 2:
        return None
    local = all_tap_tables(sw, target_size)  # [T, K, 4] block-flat
    my, mx = np.divmod(local, sw)
    my0 = my.min(axis=2)
    mx0 = mx.min(axis=2)
    cell_ok = ((my.max(axis=2) == my0 + 1) & (mx.max(axis=2) == mx0 + 1)
               & (my0 % 2 == 0) & (mx0 % 2 == 0))
    if not cell_ok.all():
        return None
    return ((my0 // 2).astype(np.int64) * (width // 2) + mx0 // 2).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _patch_tap_tables(source_size: int, target_size: int, width: int,
                      max_slices: int = 256):
    """Tables for the codebook-rows decode path, or None.

    Splits the half-res tap set into the distinct local patch positions U
    that any isometry samples, and a [T, K] index of every (transform,
    sample) into U.  Returns (positions tuple[(dy, dx)], tap_idx
    [NUM_TRANSFORMS, K] i32).
    """
    taps = _half_res_taps(source_size, target_size, width)
    if taps is None:
        return None
    w2 = width // 2
    ys, xs = np.divmod(taps, w2)  # local patch coords (origin-0 anchor)
    pos = sorted(set(zip(ys.ravel().tolist(), xs.ravel().tolist())))
    if len(pos) > max_slices:
        return None
    index = {p: i for i, p in enumerate(pos)}
    t_n, k_n = taps.shape
    tap_idx = np.array(
        [[index[(int(ys[t, k]), int(xs[t, k]))] for k in range(k_n)]
         for t in range(t_n)], np.int32)
    return tuple(pos), tap_idx


def _patch_tap_idx(source_size: int, target_size: int, width: int) -> np.ndarray:
    """``_patch_tap_tables``' tap_idx."""
    return _patch_tap_tables(source_size, target_size, width)[1]


def _patch_positions(source_size: int, target_size: int, width: int) -> np.ndarray:
    """[2, U]: ``_patch_tap_tables``' positions as (rows, columns)."""
    return np.array(_patch_tap_tables(source_size, target_size, width)[0]).T


def build_decode_tables(domain_idx, transform, width, height, source_size,
                        target_size, domain_step,
                        num_transforms: int = NUM_TRANSFORMS):
    """Gather tables for one map-set application, as (kind, tables).

    "cb": sample the whole (domain, isometry) pool from the image's half
    image, then read each range's K values as one row (the decode-time
    codebook); its tables are (code, (patch rows, patch columns, extent_y,
    extent_x), tap_idx, ny, nx, step / 2).  "half": [R, K] single-tap
    indices into the half image.  "full": [R, K, 4] tap indices into the
    full image.  The kinds are tried in that order, as the JAX package does;
    all give the same samples.
    """
    dev = domain_idx.device
    dom = domain_idx.to(torch.int64)
    tr = transform.to(torch.int64)
    nx = (width - source_size) // domain_step + 1
    ox = (dom % nx) * domain_step
    oy = (dom // nx) * domain_step

    if domain_step % 2 == 0 and domain_step >= 2:
        patch = _patch_tap_tables(source_size, target_size, width)
        if patch is not None:
            pos = patch[0]
            # only the isometries the search considered
            tap_idx = device_table(_patch_tap_idx, source_size, target_size, width,
                                   device=dev)[:num_transforms]
            ny = (height - source_size) // domain_step + 1
            code = dom * num_transforms + tr
            # the U patch positions as index tensors, plus the patch extent
            pys, pxs = device_table(_patch_positions, source_size, target_size, width,
                                    device=dev)
            pos_yx = (pys, pxs, max(p[0] for p in pos) + 1, max(p[1] for p in pos) + 1)
            return "cb", (code, pos_yx, tap_idx, ny, nx, domain_step // 2)

    if _half_res_taps(source_size, target_size, width) is not None and domain_step % 2 == 0:
        origin_half = (oy // 2) * (width // 2) + ox // 2
        taps = device_table(_half_res_taps, source_size, target_size, width, device=dev)
        return "half", origin_half[:, None] + taps[tr]

    taps = device_table(_global_tap_tables, source_size, target_size, width, device=dev)
    origin_flat = oy * width + ox
    return "full", origin_flat[:, None, None] + taps[tr]


def _step_tables(domain_idx, transform, width, height, source_size, target_size,
                 domain_step, num_transforms: int = NUM_TRANSFORMS):
    """The tables ``_decode_step`` reads, from ``build_decode_tables``'
    arguments.  On the card the kernel's, ("cells", (domain_idx, transform,
    the [8, K] tap-cell corners ``ops.decode_kernels.cell_corners`` on the
    device, the domain grid's columns, the domain step)); elsewhere
    ``build_decode_tables``'."""
    if domain_idx.device.type != "cuda":
        return build_decode_tables(domain_idx, transform, width, height, source_size,
                                   target_size, domain_step, num_transforms)
    cells = device_table(cell_corners, source_size, target_size, width,
                         device=domain_idx.device, dtype=torch.int32)
    domain_cols = (width - source_size) // domain_step + 1
    return "cells", (domain_idx, transform, cells, domain_cols, domain_step)


def _build_indices(result: EncodeResult):
    return _step_tables(
        result.domain_idx, result.transform, result.width, result.height,
        result.source_size, result.target_size, result.domain_step,
        result.num_transforms)


def _box2_sums(img: torch.Tensor) -> torch.Tensor:
    """[H/2, W/2] i32 2x2 box sums (an odd last row or column is dropped)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[:2 * h2, :2 * w2].to(torch.int32).reshape(h2, 2, w2, 2)
    return x.sum(dim=(1, 3), dtype=torch.int32)


def half_res_image(img: torch.Tensor) -> torch.Tensor:
    """[H, W] u8 or u8-valued f32 -> [H/2, W/2] f32 2x2 box averages
    (multiples of 0.25, exact)."""
    return _box2_sums(img).to(torch.float32) * 0.25


def _half_sums_u16(img_u8: torch.Tensor) -> torch.Tensor:
    """[H/2, W/2] 2x2 box SUMS (4x the half image, <= 1020, exact).

    The JAX package keeps them in u16; the port uses int32, which PyTorch
    supports on every operator, with the same values.  Integer planes only.
    """
    if img_u8.dtype.is_floating_point:
        raise TypeError(f"_half_sums_u16 requires an integer (u8) plane, "
                        f"got {img_u8.dtype}")
    return _box2_sums(img_u8)


def sample_domains(img_u8: torch.Tensor, tables) -> torch.Tensor:
    """[R, K] f32 sampled (2x2-averaged) domain pixels for every range."""
    kind, idx = tables
    if kind == "cb":
        code, (pys, pxs, extent_y, extent_x), tap_idx, ny, nx, s2 = idx
        half4 = _half_sums_u16(img_u8).contiguous()
        w2 = half4.shape[1]
        # [ny, nx, extent_y, extent_x] view of every domain's patch; the pool
        # picks the U sampled positions of each: [D, U]
        patches = half4.as_strided((ny, nx, extent_y, extent_x), (s2 * w2, s2, w2, 1))
        base = patches[:, :, pys, pxs].reshape(ny * nx, pys.shape[0])
        t_n, k_n = tap_idx.shape
        vals = base[:, tap_idx.reshape(-1)].reshape(ny * nx * t_n, k_n)
        return vals[code].to(torch.float32) * 0.25
    if kind == "half":
        return _half_sums_u16(img_u8).reshape(-1)[idx].to(torch.float32) * 0.25
    flat = img_u8.to(torch.float32).reshape(-1)
    return flat[idx].sum(-1) * 0.25


def _affine_u8(s, v, o):
    """floor(clip(s*v + o, 0, 255)) as u8, with s*v + o rounded once to f32
    (the fused multiply-add XLA:CPU emits): s*v is exact in float64 (v is a
    multiple of 0.25 below 2^8, s has 24 significant bits)."""
    out = (s.to(torch.float64) * v.to(torch.float64) + o.to(torch.float64))
    return out.to(torch.float32).clamp(0.0, 255.0).floor().to(torch.uint8)


def _decode_step(img_u8, tables, s, o, height, width, target_size, o_is_mean=False):
    """One application of the full map set: u8 image -> u8 image.  On the
    card one launch of the decoder step's kernel (``ops.decode_kernels``;
    ``tables`` from ``_step_tables``), elsewhere the plain torch step."""
    if img_u8.device.type != "cuda":
        return _decode_step_torch(img_u8, tables, s, o, height, width, target_size,
                                  o_is_mean)
    kind, idx = tables
    if kind != "cells":
        raise ValueError(f"a decode step on the card reads _step_tables' tables, not {kind!r}")
    dom, tr, cells, domain_cols, domain_step = idx
    return decode_step_cuda(img_u8, dom, tr, s, o, cells,
                            target_size=target_size, domain_cols=domain_cols,
                            domain_step=domain_step, o_is_mean=o_is_mean)


def _decode_step_torch(img_u8, tables, s, o, height, width, target_size, o_is_mean=False):
    """``_decode_step`` in plain torch ops (any device), from
    ``build_decode_tables``' tables.  The range mean of ``o_is_mean`` is
    the JAX package's: the samples' sum (exact) times f32(1/K), as XLA:CPU
    forms its division by the constant K (torch's CPU ``mean`` divides,
    which differs where K is no power of two)."""
    samp = sample_domains(img_u8, tables)  # [R, K]
    if o_is_mean:
        recip = float(np.float32(1.0) / np.float32(samp.shape[-1]))
        samp = samp - samp.sum(-1, keepdim=True) * recip
    out = _affine_u8(s[:, None], samp, o[:, None])
    ny = height // target_size
    nx = width // target_size
    return (out.reshape(ny, nx, target_size, target_size)
            .permute(0, 2, 1, 3).reshape(height, width))


def _mean_offsets(kb: int, nxr: int) -> np.ndarray:
    """[kb^2] offsets of a domain's range blocks in the [R] block-mean grid."""
    di, dj = np.meshgrid(np.arange(kb), np.arange(kb), indexing="ij")
    return di.reshape(-1) * nxr + dj.reshape(-1)


def _mean_init_image(result: EncodeResult, dcfg: DecoderConfig):
    """Piecewise-constant start image from the block-mean fixed point, or
    None when the geometry does not qualify (``initial='means'``).

    A domain's mean is the mean of the (sw/ts)^2 range blocks it covers, so
    the block means satisfy their own [R]-sized contraction.
    """
    h, w = result.height, result.width
    ts = result.target_size
    sw = result.source_size
    step = result.domain_step
    ny, nxr = h // ts, w // ts
    s = torch.where(result.valid, result.s, 0.0)
    o = torch.where(result.valid, result.o, 0.0)
    if result.o_is_mean:
        mu = o.clamp(0.0, 255.0)
    else:
        if step % ts or sw % ts or step == 0:
            return None
        nxd = (w - sw) // step + 1
        kb = sw // ts
        dom = result.domain_idx.to(torch.int64)
        oy = (dom // nxd) * (step // ts)  # domain origin in range-block units
        ox = (dom % nxd) * (step // ts)
        offs = device_table(_mean_offsets, kb, nxr, device=dom.device)
        gather_idx = (oy * nxr + ox)[:, None] + offs[None, :]
        mu = torch.full((ny * nxr,), float(dcfg.initial_value), dtype=torch.float32,
                        device=dom.device)
        for _ in range(dcfg.mean_init_iters):
            dm = mu[gather_idx].mean(1)
            mu = (s.to(torch.float64) * dm.to(torch.float64)
                  + o.to(torch.float64)).to(torch.float32).clamp(0.0, 255.0)
    img = mu.floor().to(torch.uint8).reshape(ny, nxr)
    return img.repeat_interleave(ts, 0).repeat_interleave(ts, 1)


def pyramid_factors(height: int, width: int, target_size: int,
                    source_size: int, domain_step: int,
                    max_levels: int = 2) -> tuple[int, ...]:
    """Coarse-to-fine scale factors (coarsest first), possibly empty: f
    qualifies when the decode geometry divides by f and the scaled image
    still supports the half-res pool build."""
    fs = []
    f = 2
    while (len(fs) < max_levels and target_size % f == 0
           and source_size % f == 0 and domain_step % f == 0
           and height % (2 * f) == 0 and width % (2 * f) == 0
           and source_size // f >= 2 and domain_step // f >= 1):
        fs.append(f)
        f *= 2
    return tuple(reversed(fs))


def _coarse_to_fine(fs, step_at, h: int, w: int, dcfg: DecoderConfig, device):
    """Start image for the full-res loop from the scale factors ``fs``
    (coarsest first; ``step_at(f)`` is the decode step at scale 1/f), or
    None without any: ``pyramid_steps`` iterations at the coarsest scale,
    ``pyramid_refine_steps`` at each finer one, upsampling by pixel
    replication between scales."""
    if not fs:
        return None
    img = None
    for i, f in enumerate(fs):
        step = step_at(f)
        if img is None:
            img = torch.full((h // f, w // f), dcfg.initial_value,
                             dtype=torch.uint8, device=device)
            n = dcfg.pyramid_steps
        else:
            n = dcfg.pyramid_refine_steps
        for _ in range(n):
            img = step(img)
        rep = f // (fs[i + 1] if i + 1 < len(fs) else 1)
        if rep > 1:
            img = img.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    return img


def _pyramid_init(result: EncodeResult, s, o, dcfg: DecoderConfig):
    """Coarse-to-fine start image for the full-res loop, or None."""
    h, w = result.height, result.width
    ts = result.target_size

    def step_at(f):
        hf, wf, tsf = h // f, w // f, ts // f
        tables = _step_tables(
            result.domain_idx, result.transform, wf, hf,
            result.source_size // f, tsf, result.domain_step // f,
            result.num_transforms)
        return lambda img: _decode_step(img, tables, s, o, hf, wf, tsf,
                                        result.o_is_mean)

    fs = pyramid_factors(h, w, ts, result.source_size, result.domain_step,
                         max_levels=dcfg.pyramid_levels)
    return _coarse_to_fine(fs, step_at, h, w, dcfg, s.device)


def _step_mse(nxt: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Inter-iterate MSE as a 0-d f32 tensor on the images' device, read
    nothing back: the squared differences summed exactly, rounded once to
    f32, then multiplied by the f32 reciprocal of the area (XLA:CPU compiles
    the JAX loop's division by the constant area so)."""
    d = nxt.to(torch.int32) - img.to(torch.int32)
    recip = float(np.float32(1.0) / np.float32(nxt.numel()))
    return (d * d).sum().to(torch.float32) * recip


def _full_steps(dcfg: DecoderConfig) -> int:
    """The pyramid decode's full-resolution steps (see
    DecoderConfig.pyramid_full_steps)."""
    return min(dcfg.pyramid_full_steps, dcfg.max_iterations)


def _has_pyramid(result: EncodeResult, dcfg: DecoderConfig) -> bool:
    """Whether ``result``'s decode starts from a pyramid and so runs a fixed
    count of steps, from its geometry alone."""
    return dcfg.pyramid and bool(pyramid_factors(
        result.height, result.width, result.target_size, result.source_size,
        result.domain_step, max_levels=dcfg.pyramid_levels))


def _full_res(step, start, dcfg: DecoderConfig):
    """``_full_steps`` full-resolution steps from a pyramid ``start``:
    (image, mse as ``_step_mse`` gives it)."""
    img = prev = start
    for _ in range(_full_steps(dcfg)):
        img, prev = step(img), img
    return img, _step_mse(img, prev)


# flat-loop steps a chunk: the host reads the exit flag once a chunk, and a
# chunk runs on past the exit by up to _CHUNK - 1 steps that change nothing
# (chip_smoke.py phase 26 times 1, 4, 8 and 16; PERF.md)
_CHUNK = 8


def _loop_body(step, dcfg: DecoderConfig):
    """One step of the flat loop over its carry (image, previous image,
    steps, mse, done, best mse, steps since the best improved), with the JAX
    package's exit tests: epsilon, an exact period-2 cycle (u8 truncation
    can trap a few pixels flip-flopping forever), or a stall (no
    improvement by stall_rtol for stall_window steps); in f32 and i32, as
    the JAX package's ``lax.while_loop`` body."""
    eps = float(np.float32(dcfg.epsilon))
    keep = float(np.float32(1.0 - dcfg.stall_rtol))

    def body(carry):
        img, prev, steps, _, _, best, since = carry
        nxt = step(img)
        mse = _step_mse(nxt, img)
        since = torch.where(mse < best * keep, 0, since + 1)
        done = (mse < eps) | (nxt == prev).all()
        if dcfg.stall_window > 0:
            done = done | (since >= dcfg.stall_window)
        return nxt, img, steps + 1, mse, done, torch.minimum(best, mse), since

    return body


def _flat_loop(name: str, statics: tuple, make_step, arrays: tuple, init, dcfg: DecoderConfig,
               graph: bool, ran_steps: bool = False):
    """The flat decode loop from ``init`` (``graphs.while_loop``:
    ``make_step(*arrays)`` is the decode step; on the card with ``graph``,
    chunks replay one CUDA graph per (``name``, ``statics``, dcfg)), as
    (image, iterations, mse), the last two 0-d device tensors.  Iterations
    follow the reference's count (the step that met an exit is not counted),
    or with ``ran_steps`` every step run, as the JAX package's sharded
    decode counts them."""
    dev = init.device
    inf = torch.full((), np.inf, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # prev differs from any first iterate
    carry = (init, init ^ 1, zero, inf, torch.zeros((), dtype=torch.bool, device=dev),
             inf, zero)
    img, _, steps, mse, done, _, _ = graphs.while_loop(
        name, (dcfg, *statics), lambda *a: _loop_body(make_step(*a), dcfg),
        lambda c: (c[2] < dcfg.max_iterations) & ~c[4], arrays, carry,
        graph=graph, chunk=_CHUNK)
    return img, (steps if ran_steps else steps - done.to(torch.int32)), mse


def _pyramid_decode(result: EncodeResult, dcfg: DecoderConfig):
    """(image, mse) of the pyramid decode (``_has_pyramid``): the
    coarse-to-fine start image, then ``_full_res``."""
    h, w = result.height, result.width
    tables = _build_indices(result)
    s = torch.where(result.valid, result.s, 0.0)
    o = torch.where(result.valid, result.o, 0.0)

    def step(img):
        return _decode_step(img, tables, s, o, h, w, result.target_size,
                            result.o_is_mean)

    return _full_res(step, _pyramid_init(result, s, o, dcfg), dcfg)


# the arrays a decode reads; the other fields of an EncodeResult are its
# geometry
_DECODE_FIELDS = ("domain_idx", "transform", "s", "o", "valid")


def _geometry(result: EncodeResult) -> dict:
    """``result``'s fields other than its arrays."""
    return {f.name: getattr(result, f.name) for f in dataclasses.fields(result)
            if f.name not in ARRAY_FIELDS}


def _frame_decode(result: EncodeResult, dcfg: DecoderConfig, graph: bool):
    """``_pyramid_decode`` of ``result``, eager or through its CUDA graph,
    one for each (geometry, config, device) (``utils.graphs``: the outputs
    are the graph's own, overwritten by the next frame)."""
    if not graph:
        return _pyramid_decode(result, dcfg)
    geometry = _geometry(result)

    def decode(*arrays):
        return _pyramid_decode(EncodeResult(**dict(zip(_DECODE_FIELDS, arrays)),
                                            distance=None, **geometry), dcfg)

    return graphs.replay("decode_plane", (dcfg, *geometry.items()), decode,
                         *(getattr(result, f) for f in _DECODE_FIELDS))


def _flat_decode(result: EncodeResult, dcfg: DecoderConfig, graph: bool,
                 ran_steps: bool = False):
    """``_flat_loop`` over ``result``'s decode step from the flat start image,
    or from the block-mean fixed point (``initial='means'``, computed before
    the loop where the geometry qualifies)."""
    h, w = result.height, result.width
    geometry = _geometry(result)
    init = torch.full((h, w), dcfg.initial_value, dtype=torch.uint8, device=result.s.device)
    if dcfg.initial == "means":
        mi = _mean_init_image(result, dcfg)
        if mi is not None:
            init = mi

    def make_step(*arrays):
        frame = EncodeResult(**dict(zip(_DECODE_FIELDS, arrays)), distance=None, **geometry)
        tables = _build_indices(frame)
        s = torch.where(frame.valid, frame.s, 0.0)
        o = torch.where(frame.valid, frame.o, 0.0)
        return lambda img: _decode_step(img, tables, s, o, h, w, frame.target_size,
                                        frame.o_is_mean)

    return _flat_loop("decode_plane_flat", tuple(geometry.items()), make_step,
                      tuple(getattr(result, f) for f in _DECODE_FIELDS), init, dcfg,
                      graph, ran_steps)


def _decode_core(result: EncodeResult, dcfg: DecoderConfig):
    """(image, iterations int, mse float): the pyramid decode eagerly, or
    the flat loop, its chunks on their CUDA graph on the card."""
    if _has_pyramid(result, dcfg):
        img, mse = _pyramid_decode(result, dcfg)
        return img, _full_steps(dcfg), float(mse)
    graph = result.s.device.type == "cuda"
    img, it, mse = _flat_decode(result, dcfg, graph)
    return (img.clone() if graph else img), int(it), float(mse)


def _to_device(result, device):
    """A copy of the dataclass ``result`` (an EncodeResult or a quadtree
    level) with its tensors on ``device``; itself when they lie there."""
    if device is None or torch.device(device) == result.s.device:
        return result
    arrays = {f.name: getattr(result, f.name).to(device)
              for f in dataclasses.fields(result)
              if isinstance(getattr(result, f.name), torch.Tensor)}
    return dataclasses.replace(result, **arrays)


@entry_span
def decode_plane(result: EncodeResult, dcfg: DecoderConfig = DecoderConfig(), *,
                 device: torch.device | str | None = None):
    """Decode to a fixed point on ``device`` (default: the result's).
    Returns (plane u8 [H, W] tensor, iterations int, mse float); iterations
    follow the reference's count (``Encoder2.hpp:76-88``).  On the card the
    pyramid decode (``dcfg.pyramid`` where the geometry has a level) is one
    CUDA graph whose MSE is read once, and the flat loop's chunks replay
    one, its exit flag read once a chunk (``graphs.while_loop``)."""
    result = _to_device(result, device)
    if not _has_pyramid(result, dcfg):
        return _decode_core(result, dcfg)
    graph = result.s.device.type == "cuda"
    img, mse = _frame_decode(result, dcfg, graph)
    return (img.clone() if graph else img), _full_steps(dcfg), float(mse)


@entry_span
def decode_batch_stacked(result: EncodeResult, dcfg: DecoderConfig = DecoderConfig()):
    """Decode a stacked batch (arrays with a leading [B] axis, as
    ``encode_batch_stacked`` gives them) on the result's device, frame after
    frame as ``decode_plane`` does with each frame's ``distance`` zeroed, as
    the JAX package's does.  Returns ([B, H, W] u8, [B] i32 iterations, [B]
    f32 mse) tensors; the last two on the CPU.  Each frame is written into
    its row of the preallocated outputs, and the iterations and MSEs are
    read back once for the batch."""
    return _decode_batch(result, dcfg, result.s.device.type == "cuda")


def _decode_batch(result: EncodeResult, dcfg: DecoderConfig, graph: bool):
    """``decode_batch_stacked``, its frames eager or through the graphs."""
    outs, iters, mses = _decode_rows(result, dcfg, graph)
    return (outs, *_read_back(iters, mses))


def _decode_rows(result: EncodeResult, dcfg: DecoderConfig, graph: bool,
                 ran_steps: bool = False):
    """The frames of a stacked ``result`` decoded one after another on its
    device, eager or through the graphs, each into its row of the
    preallocated ([B, H, W] u8, [B] i32 iterations, [B] f32 mse), which
    stay on the device: nothing is read back but the flat loop's exit flag
    once a chunk.  Iterations as ``_flat_loop`` counts them
    (``ran_steps``)."""
    b = result.domain_idx.shape[0]
    pyramid = _has_pyramid(result, dcfg)
    outs = iters = mses = None
    for i in range(b):
        frame = dataclasses.replace(
            result, domain_idx=result.domain_idx[i], transform=result.transform[i],
            s=result.s[i], o=result.o[i], distance=torch.zeros_like(result.s[i]),
            valid=result.valid[i])
        if pyramid:
            (img, mse), it = _frame_decode(frame, dcfg, graph), None
        else:
            img, it, mse = _flat_decode(frame, dcfg, graph, ran_steps)
        if outs is None:
            outs = img.new_empty((b, *img.shape))
            iters = torch.full((b,), _full_steps(dcfg), dtype=torch.int32, device=img.device)
            mses = mse.new_empty((b,))
        outs[i], mses[i] = img, mse
        if it is not None:
            iters[i] = it
    return outs, iters, mses


def _read_back(iters: torch.Tensor, mses: torch.Tensor):
    """[B] i32 iterations and [B] f32 MSEs on the CPU, in one read from
    their device: the iterations beside the MSEs' bits."""
    both = torch.stack([iters, mses.view(torch.int32)]).cpu()
    return both[0], both[1].view(torch.float32)


def decode_steps_py(result: EncodeResult, dcfg: DecoderConfig = DecoderConfig(),
                    reporter=None):
    """Decode yielding every iterate (for --debug_decode dumps, cf.
    ``Encoder2.hpp:74-82``).  Yields (step_index, u8 image); stops on the
    epsilon test only, like the reference.  ``reporter`` (a
    ``utils.ProgressReporter``) logs each step against ``max_iterations``."""
    h, w = result.height, result.width
    tables = _build_indices(result)
    s = torch.where(result.valid, result.s, 0.0)
    o = torch.where(result.valid, result.o, 0.0)
    img = torch.full((h, w), dcfg.initial_value, dtype=torch.uint8, device=s.device)
    yield 0, img
    for i in range(dcfg.max_iterations):
        nxt = _decode_step(img, tables, s, o, h, w, result.target_size,
                           result.o_is_mean)
        d = nxt.to(torch.int64) - img.to(torch.int64)
        mse = float((d * d).sum().item()) / (h * w)
        if reporter is not None:
            reporter.log(i + 1, dcfg.max_iterations)
        yield i + 1, nxt
        if mse < dcfg.epsilon:
            if reporter is not None:
                reporter.log(dcfg.max_iterations, dcfg.max_iterations)
            return
        img = nxt
