"""The port's CUDA kernels against their plain PyTorch version, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
without one (the CPU parity tests in test_torch_*.py cover the plain
version against the JAX package).  Run on a machine with a card, where jax
may be absent (tests/conftest.py imports it): ``python -m pytest
tests/test_torch_cuda.py -q --noconftest``.
"""
import collections
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (DECODE_STEP_GEOMETRIES, assert_bitwise, decode_step_case, mean_maps,
                           random_plane)

import fractencode_tpu_torch as T
from fractencode_tpu_torch.decode import decoder as dec
from fractencode_tpu_torch.encode import matcher as tm
from fractencode_tpu_torch.ops import decode_kernels as dk
from fractencode_tpu_torch.ops import matcher_kernels as mk

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(img, cfg, device):
    """(ranges, SumA, SumA2, codebook, range classes, domain classes)."""
    from fractencode_tpu_torch.core.classify import classify_grid
    from fractencode_tpu_torch.core.grid import uniform_grid
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges, range_sums

    n = img.shape[0]
    p = torch.from_numpy(img).to(device)
    pf = p.to(torch.float32)
    dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
    cb = build_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(pf, cfg.target_size)
    return (ranges, *range_sums(ranges), cb, classify_grid(p, rg), classify_grid(p, dg))


def _prep(img, cfg, device, **blocks):
    return tm.classed_prep(*_inputs(img, cfg, device), cfg, **blocks)


# one config per kernel key: (mode, K) -> overrides; 'general' twice, for
# each of its so_modes.  K = 64 is BASELINE config 1's geometry (8 px ranges,
# 16 px domains, 8 isometries), K = 256 the quadtree's 16 px level.
GEOMETRY = {16: {}, 64: dict(target_size=8, num_transforms=8),
            256: dict(source_size=64, target_size=16)}
KEYS = {"ls": {}, "raw": dict(criterion="raw", so_mode="reference"),
        "general-ls": dict(s_max=1.0), "general-reference": dict(so_mode="reference")}
CASES = [(key, k) for key in KEYS for k in (16, 64, 256)
         if k in mk.KERNEL_KEYS[key.split("-")[0]]]


def _case_cfg(key, k, **kw):
    return T.EncoderConfig(**GEOMETRY[k], **KEYS[key], **kw)


# operands beside each test's own plane: tie-heavy ones, and ragged rows and
# columns (K3: a row count that is no multiple of 16 and m_valid < m; the
# class layout of K1 and K2: 24-row range tiles and 8-column column tiles)
OPERANDS = ["plane", "ties", "ragged"]
RAGGED_BLOCKS = dict(block_r=24, block_m=8)


def _ties_plane(n, seed):
    """Tie-heavy: the top half repeats one 8 px tile, so its domains give
    repeated codebook columns at every geometry; the bottom-left quarter is
    flat, so its ranges are flat; the rest is noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, n)).astype(np.uint8)
    img[: n // 2] = np.tile(rng.integers(0, 256, (8, 8)), (n // 16, n // 8))
    img[n // 2:, : n // 2] = 97
    return img


def _dense_pair(prep, k, area, cfg, rows=None, m_valid=None):
    """K3's kernel and plain results on ``dense_prep``'s tensors, through the
    wrappers, for the first ``rows`` ranges against the first ``m_valid``
    columns (all by default)."""
    r = prep["ai"].shape[0] if rows is None else rows
    cut = lambda x: None if x is None else x[:r]
    kw = dict(m_valid=prep["ch"].shape[0] if m_valid is None else m_valid,
              criterion=cfg.criterion, so_mode=cfg.so_mode, s_max=cfg.s_max,
              inv_norm=tm.inv_norm(cfg, k, area), sa=cut(prep["sa"]), sa2=cut(prep["sa2"]),
              rcls=cut(prep["rcls"]), ccls=prep["ccls"], threshold=cfg.rms_threshold,
              t_n=cfg.num_transforms)
    args = (prep["ai"][:r], prep["ch"], prep["cl"], prep["sb"], prep["aux"])
    out = mk.search_dense_cuda(*args, **kw)
    torch.cuda.synchronize()
    return out, mk.search_dense_torch(*args, **kw)


@pytest.mark.parametrize("blocks", [{}, dict(block_r=512, block_m=4096),
                                    dict(block_r=8, block_m=128)])
@pytest.mark.parametrize("n", [128, 256])
def test_kernel_matches_plain(cuda, n, blocks):
    """(q, idx) of every sorted row bitwise, at several layout tiles (block_r
    512 runs four thread blocks per range tile, 8 leaves most threads idle)."""
    img = random_plane(n, 5)
    cfg = T.EncoderConfig()
    prep = _prep(img, cfg, cuda, **blocks)
    before = mk.search_classed_cuda.launches[("ls", 16, False)]
    q_k, i_k = tm.classed_kernel(prep, 16, 256, cfg)
    assert mk.search_classed_cuda.launches[("ls", 16, False)] == before + 1
    q_p, i_p = tm.classed_kernel(prep, 16, 256, T.EncoderConfig(backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")


@pytest.mark.parametrize("blocks", [{}, dict(block_r=512, block_m=4096),
                                    dict(block_r=8, block_m=128)])
@pytest.mark.parametrize("k", [64, 256])
def test_kernel_matches_plain_quadtree_levels(cuda, k, blocks):
    """K = 64 and K = 256 (the quadtree's 8 and 16 px levels: 32 -> 8 and
    64 -> 16 geometries) on a 256^2 plane, (q, idx) bitwise."""
    ds, rs = {64: (32, 8), 256: (64, 16)}[k]
    img = random_plane(256, 7)
    cfg = T.EncoderConfig(source_size=ds, target_size=rs)
    prep = _prep(img, cfg, cuda, **blocks)
    before = mk.search_classed_cuda.launches[("ls", k, False)]
    q_k, i_k = tm.classed_kernel(prep, k, ds * ds, cfg)
    assert mk.search_classed_cuda.launches[("ls", k, False)] == before + 1
    q_p, i_p = tm.classed_kernel(prep, k, ds * ds,
                                 T.EncoderConfig(source_size=ds, target_size=rs,
                                                 backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")


def test_quadtree_cuda_equals_cpu(cuda):
    """The quadtree encode (every level's fields) and both decodes, card
    against CPU, bitwise."""
    from fractencode_tpu_torch.encode import quadtree as tq

    # a smooth wave plus uniform noise: leaves at every level (32, 123, 20)
    yy, xx = np.mgrid[0:128, 0:128]
    img = (60 + 40 * np.sin(xx / 19.0) * np.cos(yy / 23.0)
           + np.random.default_rng(8).integers(0, 20, (128, 128))).astype(np.uint8)
    rg = tq.encode_plane_quadtree(img, device=cuda)
    rc = tq.encode_plane_quadtree(img, device="cpu")
    for lg, lc in zip(rg.levels, rc.levels):
        for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
            assert_bitwise(getattr(lg, f), getattr(lc, f), f"{lg.range_size} px {f}")
    for pyramid in (True, False):
        dcfg = T.DecoderConfig(pyramid=pyramid)
        og, ig, mg = tq.decode_plane_quadtree(rg, dcfg)
        oc, ic, mc = tq.decode_plane_quadtree(rc, dcfg)
        assert_bitwise(og, oc, "pixels")
        assert (ig, mg) == (ic, mc)


def test_encode_decode_cuda_equals_cpu(cuda):
    img = random_plane(128, 6)
    dcfg = T.DecoderConfig(pyramid=True)
    rg = T.encode_plane(img, device=cuda)
    rc = T.encode_plane(img, device="cpu")
    for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
        assert_bitwise(getattr(rg, f), getattr(rc, f), f)
    og, ig, mg = T.decode_plane(rg, dcfg)
    oc, ic, mc = T.decode_plane(rc, dcfg)
    assert_bitwise(og, oc, "pixels")
    assert (ig, mg) == (ic, mc)
    og, ig, _ = T.decode_plane(rc, device=cuda)  # a CPU encode, decoded on the card
    oc, ic, _ = T.decode_plane(rc)
    assert og.device.type == "cuda"
    assert_bitwise(og, oc, "flat pixels")
    assert ig == ic


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_classed_keys_match_plain(cuda, case):
    """K1's 'raw' and 'general' keys (and 'ls') at K = 16, 64 and 256: (q,
    idx) of every sorted row bitwise against the plain version."""
    key, k = case
    cfg = _case_cfg(key, k)
    prep = _prep(random_plane(128, 10), cfg, cuda)
    mode = key.split("-")[0]
    before = mk.search_classed_cuda.launches[(mode, k, False)]
    area = cfg.source_size ** 2
    q_k, i_k = tm.classed_kernel(prep, k, area, cfg)
    assert mk.search_classed_cuda.launches[(mode, k, False)] == before + 1
    q_p, i_p = tm.classed_kernel(prep, k, area, _case_cfg(key, k, backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")


@pytest.mark.parametrize("t_n", [1, None], ids=["t1", "own"])
@pytest.mark.parametrize("block_r", [8, 40])
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_classed_kernel_ragged_empty_class(cuda, case, frontier, block_r, t_n):
    """Every K1 instance (each key and K, plain and `_thr`) at a ragged
    block_r (range tiles of 8 and 40 rows: one partial block of the
    mainloop's 128 rows each), at one isometry and at the geometry's own,
    on 8-column tiles, with the first tile's class given an empty column
    segment: (q, idx) of every sorted row bitwise against the plain
    version, and that class's rows (-3e38, 0)."""
    key, k = case
    cfg = _case_cfg(key, k, rms_threshold=10.0 if frontier else 0.0)
    if t_n is not None:
        cfg = dataclasses.replace(cfg, num_transforms=t_n)
    prep = _prep(_smooth(128, 21), cfg, cuda, block_r=block_r, block_m=8)
    c = int(prep["tile_class"][0])
    col_end = prep["col_end"].clone()
    col_end[c] = prep["col_tile_start"][c] * prep["block_m"]
    prep = dict(prep, col_end=col_end)
    mode, area = key.split("-")[0], cfg.source_size ** 2
    before = mk.search_classed_cuda.launches[(mode, k, frontier)]
    q_k, i_k = tm.classed_kernel(prep, k, area, cfg)
    assert mk.search_classed_cuda.launches[(mode, k, frontier)] == before + 1
    q_p, i_p = tm.classed_kernel(prep, k, area, dataclasses.replace(cfg, backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    empty = (prep["tile_class"] == c).repeat_interleave(block_r)
    assert bool((q_k[empty] == -3.0e38).all()) and not bool(i_k[empty].any())
    assert bool((q_k[~empty] > -3.0e38).any())


def test_classed_library_runs_on_tensor_cores(cuda):
    """The built K1 library's SASS holds tensor-core products (IMMA) and no
    dp4a (IDP.4A), counted as chip_smoke.py's phase 1 counts them."""
    import chip_smoke
    from fractencode_tpu_torch.ops import _build

    _build.load_library("search_classed")
    counts = chip_smoke.sass_counts(_build._library("search_classed"))
    assert counts["IMMA"] > 0 and counts["IDP4A"] == 0, counts


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_dense_kernel_matches_plain(cuda, case, masked, frontier, operands):
    """K3 at every (mode, K) it covers, with and without the class mask,
    each plain and with the early-accept frontier at 10.0 (the `_thr`
    instances; on a smooth plane, where ranges hit): (q, idx) of every
    range bitwise against the plain version, on a random or smooth plane,
    on tie-heavy operands (repeated codebook columns, flat ranges) and on
    ragged ones (a row count that is no multiple of 16, m_valid < m); the
    launch count of the instance, (mode, K, frontier, masked), moves by one.
    With the mask, rows of a class no column has keep (-3e38, 0); without
    the frontier some rows' best column lies outside their class, with it
    the frontier changes some rows' keys (its threshold 60 at K = 256, as
    test_exact_key_instances_match_plain's, where 16 px ranges meet 10
    too rarely within a class)."""
    key, k = case
    cfg = _case_cfg(key, k, rms_threshold=(60.0 if k == 256 else 10.0) if frontier else 0.0)
    img = (_ties_plane(128, 11) if operands == "ties" else
           _smooth(256, 11) if frontier else random_plane(128, 11))
    ranges, sa, sa2, cb, rcls, dcls = _inputs(img, cfg, cuda)
    if not masked:
        rcls = dcls = None
    elif operands != "plane":
        rcls = rcls.clone()
        rcls[3:6] = 99  # no column has this class
    prep = tm.dense_prep(ranges, sa, sa2, cb, rcls, dcls, cfg)
    assert (prep["rcls"] is None) != masked
    mode = key.split("-")[0]
    launch = (mode, k, frontier, masked)
    before = mk.search_dense_cuda.launches[launch]
    area = cfg.source_size ** 2
    if operands == "plane":
        q_k, i_k = tm.dense_kernel(prep, k, area, cfg)
        q_p, i_p = tm.dense_kernel(prep, k, area, _case_cfg(key, k, backend="torch",
                                                             rms_threshold=cfg.rms_threshold))
    else:
        rows, m = prep["ai"].shape[0], prep["ch"].shape[0]
        shape = (rows - 5, m - 13) if operands == "ragged" else (None, None)
        (q_k, i_k), (q_p, i_p) = _dense_pair(prep, k, area, cfg, *shape)
    assert mk.search_dense_cuda.launches[launch] == before + 1
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    if masked and operands == "plane" and frontier:
        off = tm.dense_kernel(prep, k, area, dataclasses.replace(cfg, rms_threshold=0.0))
        assert bool((off[0] != q_k).any()), "vacuous: the frontier changed no key"
    elif masked and operands == "plane":  # some rows' best column lies outside their class
        unmasked = tm.dense_kernel(dict(prep, rcls=None, ccls=None), k, area, cfg)
        assert bool((unmasked[0] > q_k).any())
    elif masked:
        assert bool((q_k[3:6] == -3.0e38).all()) and not bool(i_k[3:6].any())


@pytest.mark.parametrize("cfg", [
    T.EncoderConfig(use_classifier=False), T.REFERENCE_COMPAT(),
    T.EncoderConfig(s_max=0.9), T.EncoderConfig(so_mode="reference"),
    T.REFERENCE_COMPAT(use_classifier=False),
    T.EncoderConfig(use_classifier=False, target_size=8, num_transforms=8),
], ids=["nocls", "compat", "smax", "so_reference", "compat_nocls", "config1"])
def test_encode_cuda_equals_cpu_keys(cuda, cfg):
    """--noclassifier, --compat, --smax, --so-mode reference and BASELINE
    config 1: the encode on the card (a kernel launch) equals the CPU's,
    every field bitwise, and so do the decoded pixels."""
    img = random_plane(128, 12)
    total = lambda: sum(mk.search_dense_cuda.launches.values()) + \
        sum(mk.search_classed_cuda.launches.values())
    before = total()
    rg = T.encode_plane(img, cfg, device=cuda)
    assert total() == before + 1
    rc = T.encode_plane(img, cfg, device="cpu")
    for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
        assert_bitwise(getattr(rg, f), getattr(rc, f), f)
    og, ig, mg = T.decode_plane(rg)
    oc, ic, mc = T.decode_plane(rc)
    assert_bitwise(og, oc, "pixels")
    assert (ig, mg) == (ic, mc)


@pytest.mark.parametrize("cfg", [T.EncoderConfig(), T.REFERENCE_COMPAT()],
                         ids=["default", "compat"])
@pytest.mark.parametrize("quadtree", [False, True], ids=["grid", "quadtree"])
def test_stream_bytes_cuda_equal_cpu(cuda, quadtree, cfg):
    """FTC1 and FTQ1 at 128^2 (the quadtree under --compat: the 'raw' key at
    K = 256): the card's encode packs to the CPU's bytes, and the file
    unpacks on the card to tensors there that decode to the CPU's pixels."""
    from fractencode_tpu_torch import codec
    from fractencode_tpu_torch.encode import quadtree as tq

    img = random_plane(128, 13)
    if quadtree:
        encode, pack, unpack, decode = (tq.encode_plane_quadtree, codec.pack_quadtree,
                                        codec.unpack_quadtree, tq.decode_plane_quadtree)
    else:
        encode, pack, unpack, decode = (T.encode_plane, codec.pack_result,
                                        codec.unpack_result, T.decode_plane)
    blob = pack(encode(img, cfg, device=cuda), plane=img)
    assert blob == pack(encode(img, cfg, device="cpu"), plane=img)
    ug, uc = unpack(blob), unpack(blob, device="cpu")
    og, ig, _ = decode(ug, T.DecoderConfig())
    oc, ic, _ = decode(uc, T.DecoderConfig())
    assert og.device.type == "cuda"
    assert_bitwise(og, oc, "pixels")
    assert ig == ic


def test_quadtree_noclassifier_cuda_equals_cpu(cuda):
    """The quadtree without the classifier (K3 at K = 16, 64 and 256, then
    the coverage post-mask): every level bitwise, card against CPU."""
    from fractencode_tpu_torch.encode import quadtree as tq

    yy, xx = np.mgrid[0:128, 0:128]
    img = (60 + 40 * np.sin(xx / 19.0) * np.cos(yy / 23.0)
           + np.random.default_rng(8).integers(0, 20, (128, 128))).astype(np.uint8)
    cfg = T.EncoderConfig(use_classifier=False)
    rg = tq.encode_plane_quadtree(img, cfg, device=cuda)
    rc = tq.encode_plane_quadtree(img, cfg, device="cpu")
    for lg, lc in zip(rg.levels, rc.levels, strict=True):
        for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
            assert_bitwise(getattr(lg, f), getattr(lc, f), f"{lg.range_size} px {f}")


# (source, target) of the range sizes the padded instances (n = 4, 36, 100)
# and the K-slab form (n = 1024) serve
RANGE_SIZES = {4: (8, 2), 36: (12, 6), 100: (20, 10), 1024: (64, 32)}


@pytest.mark.parametrize("n", sorted(RANGE_SIZES))
@pytest.mark.parametrize("make", [T.REFERENCE_COMPAT,
                                  functools.partial(T.EncoderConfig, s_max=1.0),
                                  T.EncoderConfig], ids=["raw", "general", "ls"])
def test_uncovered_configs_raise_on_cuda(cuda, make, n):
    """Range sizes whose n is not 16, 64 or 256 (under each key, with and
    without the classifier) launch the padded instances or the K-slab form
    on CUDA: every field of the encode bitwise against the CPU's, and the
    same with backend='torch' (the plain version on the card)."""
    source, target = RANGE_SIZES[n]
    size = 120 if n in (36, 100) else 128  # a multiple of the range size
    img = random_plane(size)
    width = mk.instance_width(n, mk.kernel_width(n))
    for use_classifier in (True, False):
        c = make(source_size=source, target_size=target, use_classifier=use_classifier)
        launches = (mk.search_classed_cuda if use_classifier else mk.search_dense_cuda).launches
        before = sum(v for key, v in launches.items() if key[1] == width)
        rg = T.encode_plane(img, c, device=cuda)
        assert sum(v for key, v in launches.items() if key[1] == width) == before + 1
        rt = T.encode_plane(img, dataclasses.replace(c, backend="torch"), device=cuda)
        rc = T.encode_plane(img, c, device="cpu")
        for f in ("domain_idx", "transform", "valid", "distance", "s", "o"):
            assert_bitwise(getattr(rg, f), getattr(rc, f), f)
            assert_bitwise(getattr(rt, f), getattr(rc, f), f)


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("t_n", [1, 3, 4, 5, 7, 8])
@pytest.mark.parametrize("kernel", ["classed", "dense"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_frontier_kernels_match_plain(cuda, case, kernel, t_n, operands):
    """Every `_thr` instance (K1 and K3, each key and K) with the early-accept
    frontier at 10.0 on a smooth 256^2 plane, at 4 isometries (the
    geometry's own: 8 at K = 64) and at 1, 3, 5, 7 and 8 (groups that
    straddle K1's column tiles, the kernels' n8 tiles and chunks): (q, idx)
    of every row bitwise against the plain version, and the frontier active
    at 3 and 4 (it changes some rows' keys); also on tie-heavy operands and on ragged
    ones (K3: rows no multiple of 16, m_valid < m; K1: 24-row range tiles,
    8-column column tiles)."""
    key, k = case
    cfg = _case_cfg(key, k, rms_threshold=10.0)
    if t_n != 4:
        cfg = dataclasses.replace(cfg, num_transforms=t_n)
    yy, xx = np.mgrid[0:256, 0:256]
    img = (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
           + np.random.default_rng(13).integers(0, 6, (256, 256))).astype(np.uint8)
    if operands == "ties":
        img = _ties_plane(256, 13)
    inputs = _inputs(img, cfg, cuda)
    mode = key.split("-")[0]
    area = cfg.source_size ** 2
    off = dataclasses.replace(cfg, rms_threshold=0.0)
    if kernel == "classed":
        prep = tm.classed_prep(*inputs, cfg, **(RAGGED_BLOCKS if operands == "ragged" else {}))
        run, launches = (lambda c: tm.classed_kernel(prep, k, area, c)), \
            mk.search_classed_cuda.launches
    else:
        prep = tm.dense_prep(*inputs[:4], None, None, cfg)
        run, launches = (lambda c: tm.dense_kernel(prep, k, area, c)), \
            mk.search_dense_cuda.launches
    launch = (mode, k, True) if kernel == "classed" else (mode, k, True, False)
    before = launches[launch]
    if kernel == "dense" and operands == "ragged":
        rows, m = prep["ai"].shape[0], prep["ch"].shape[0]
        (q_k, i_k), (q_p, i_p) = _dense_pair(prep, k, area, cfg, rows - 5, m - 13)
    else:
        q_k, i_k = run(cfg)
        q_p, i_p = run(dataclasses.replace(cfg, backend="torch"))
    assert launches[launch] == before + 1
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    if operands == "plane" and t_n in (3, 4):  # at 1 isometry some keys never move
        assert bool((run(off)[0] != q_k).any()), "vacuous: the frontier changed no key"


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("kernel", ["classed", "dense"])
@pytest.mark.parametrize("key", ["raw", "general-ls", "general-reference"])
def test_exact_key_instances_match_plain(cuda, key, kernel, frontier, operands):
    """The 'raw' and 'general' instances at K = 256 (raw256, general256 and
    their `_thr` forms, K1 and K3; 'general' under both so_modes) on a
    smooth 256^2 plane at the quadtree's 16 px level geometry: (q, idx) of
    every row bitwise against the plain version, through the encoder's own
    calls; with the frontier some rows' keys change.  Also on tie-heavy
    operands and on ragged ones (K3: rows no multiple of 16, m_valid < m;
    K1: 24-row range tiles, 8-column column tiles)."""
    cfg = _case_cfg(key, 256, rms_threshold=60.0 if frontier else 0.0)
    yy, xx = np.mgrid[0:256, 0:256]
    img = (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
           + np.random.default_rng(15).integers(0, 6, (256, 256))).astype(np.uint8)
    if operands == "ties":
        img = _ties_plane(256, 15)
    inputs = _inputs(img, cfg, cuda)
    mode = key.split("-")[0]
    if kernel == "classed":
        prep = tm.classed_prep(*inputs, cfg, **(RAGGED_BLOCKS if operands == "ragged" else {}))
        run, launches = (lambda c: tm.classed_kernel(prep, 256, 64 * 64, c)), \
            mk.search_classed_cuda.launches
    else:
        prep = tm.dense_prep(*inputs[:4], None, None, cfg)
        run, launches = (lambda c: tm.dense_kernel(prep, 256, 64 * 64, c)), \
            mk.search_dense_cuda.launches
    assert prep["aux_s" if kernel == "classed" else "aux"].dtype == torch.float64
    launch = (mode, 256, frontier) + (() if kernel == "classed" else (False,))
    before = launches[launch]
    if kernel == "dense" and operands == "ragged":
        rows, m = prep["ai"].shape[0], prep["ch"].shape[0]
        (q_k, i_k), (q_p, i_p) = _dense_pair(prep, 256, 64 * 64, cfg, rows - 5, m - 13)
    else:
        q_k, i_k = run(cfg)
        q_p, i_p = run(dataclasses.replace(cfg, backend="torch"))
    assert launches[launch] == before + 1
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    if frontier and operands == "plane":
        off = run(dataclasses.replace(cfg, rms_threshold=0.0))[0]
        assert bool((off != q_k).any()), "vacuous: the frontier changed no key"


def test_frontier_launch_never_runs_plain(cuda, monkeypatch):
    """With rms_threshold > 0 on CUDA tensors, the encode launches the `_thr`
    kernels and never the plain version (it is made to raise here)."""
    def refuse(*_, **__):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(mk, "search_classed_torch", refuse)
    monkeypatch.setattr(mk, "search_dense_torch", refuse)
    monkeypatch.setattr(mk, "_plain_search", refuse)
    img = random_plane(128, 14)
    for cfg, launches, key in (
            (T.EncoderConfig(rms_threshold=10.0), mk.search_classed_cuda.launches,
             ("ls", 16, True)),
            (T.REFERENCE_COMPAT(rms_threshold=10.0, use_classifier=False),
             mk.search_dense_cuda.launches, ("raw", 16, True, False))):
        before = launches[key]
        T.encode_plane(img, cfg, device=cuda)
        assert launches[key] == before + 1


def _smooth(n, seed):
    """A smooth wave plus uniform noise: many ranges meet the threshold 10."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
            + np.random.default_rng(seed).integers(0, 6, (n, n))).astype(np.uint8)


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_classed2d_kernel_matches_plain(cuda, case, frontier, operands):
    """Each K2 instance on the forced route (force_no_pairs), with the split
    width it picks and with splits of two groups: (q, idx) of every sorted
    row bitwise against its plain version; K2 launches, K1 does not.  Also
    on tie-heavy operands and on a ragged layout (24-row range tiles, so a
    block's rows are no multiple of 16, and 8-column column tiles)."""
    key, k = case
    cfg = _case_cfg(key, k, rms_threshold=10.0 if frontier else 0.0)
    img = _ties_plane(256, 16) if operands == "ties" else _smooth(256, 16)
    prep = _prep(img, cfg, cuda, force_no_pairs=True,
                 **(RAGGED_BLOCKS if operands == "ragged" else {}))
    assert prep["route"] == "search_classed2d"
    mode, area = key.split("-")[0], cfg.source_size ** 2
    q_p, i_p = tm.classed_kernel(prep, k, area, dataclasses.replace(cfg, backend="torch"))
    before = mk.search_classed2d_cuda.launches[(mode, k, frontier)]
    k1 = dict(mk.search_classed_cuda.launches)
    for splits in (None, 2 * cfg.num_transforms):
        q_k, i_k = tm.classed_kernel(prep, k, area, cfg, splits=splits)
        torch.cuda.synchronize()
        assert_bitwise(q_k, q_p, f"q, splits {splits}")
        assert_bitwise(i_k, i_p, f"idx, splits {splits}")
    assert mk.search_classed2d_cuda.launches[(mode, k, frontier)] == before + 2
    assert mk.search_classed_cuda.launches == k1
    assert int(mk.search_classed2d_cuda.plan["splits"].max()) > 1


@pytest.mark.parametrize("threshold", [0.0, 10.0])
def test_classed2d_matches_classed_on_the_card(cuda, threshold):
    """K2 against K1 on the card, on the forced route's prep and K1's: one
    split per segment, several, and the width K2 picks; (q, idx) bitwise."""
    cfg = T.EncoderConfig(rms_threshold=threshold)
    inputs = _inputs(_smooth(256, 17), cfg, cuda)
    q1, i1 = tm.classed_kernel(tm.classed_prep(*inputs, cfg), 16, 256, cfg)
    prep = tm.classed_prep(*inputs, cfg, force_no_pairs=True)
    longest = int((prep["col_end"] - prep["col_tile_start"] * prep["block_m"]).max())
    for splits, n in ((-(-longest // 4) * 4, 1), (64, -(-longest // 64)), (None, None)):
        q2, i2 = tm.classed_kernel(prep, 16, 256, cfg, splits=splits)
        torch.cuda.synchronize()
        assert_bitwise(q1, q2, f"q, splits {splits}")
        assert_bitwise(i1, i2, f"idx, splits {splits}")
        assert n is None or int(mk.search_classed2d_cuda.plan["splits"].max()) == n


@pytest.mark.parametrize("threshold", [0.0, 10.0])
def test_classed2d_few_searched_tiles(cuda, threshold):
    """A range mask that leaves 200 of 16,384 ranges (a fine quadtree
    level's coverage): K2 at the width it picks on the device (many splits)
    against its plain version, (q, idx) of every sorted row bitwise, with
    the partials sized by the shapes' bound on the work items, about r_pad's
    rows, not by r_pad times the splits."""
    cfg = T.EncoderConfig(rms_threshold=threshold)
    img = _smooth(512, 19)
    ranges, *rest = _inputs(img, cfg, cuda)
    keep = torch.zeros(ranges.shape[0], dtype=torch.bool, device=cuda)
    keep[torch.from_numpy(np.random.default_rng(19).choice(ranges.shape[0], 200,
                                                           replace=False)).to(cuda)] = True
    prep = tm.classed_prep(ranges, *rest, cfg, range_mask=keep, force_no_pairs=True)
    q_p, i_p = tm.classed_kernel(prep, 16, 256, dataclasses.replace(cfg, backend="torch"))
    q_k, i_k = tm.classed_kernel(prep, 16, 256, cfg)
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    plan, r_pad = mk.search_classed2d_cuda.plan, prep["ai_s"].shape[0]
    splits = int(plan["splits"].max())
    assert splits > 1 and int(plan["work"]) <= plan["items"]
    assert plan["partial_bytes"] == 9 * plan["items"] * prep["block_r"] < 9 * splits * r_pad


def test_classed2d_wrapper_refuses_bad_inputs(cuda):
    """A wrong dtype, shape or device, or a split width below one column,
    raises before any launch."""
    cfg = T.EncoderConfig()
    prep = _prep(random_plane(128, 18), cfg, cuda, force_no_pairs=True)
    names = ("ai_s", "ch_s", "cl_s", "sb_s", "aux_s", "tile_class", "col_tile_start",
             "col_end", "row_end")
    args = [prep[n] for n in names]
    kw = dict(block_r=prep["block_r"], block_m=prep["block_m"], criterion="affine",
              so_mode="ls", s_max=-1.0, inv_norm=1.0 / 16)
    before = dict(mk.search_classed2d_cuda.launches)
    for i, bad in ((0, args[0].to(torch.int16)), (3, args[3][:-1].contiguous()),
                   (1, args[1].cpu()), (5, args[5].to(torch.int64))):
        with pytest.raises(ValueError, match=names[i]):
            mk.search_classed2d_cuda(*args[:i], bad, *args[i + 1:], **kw)
    with pytest.raises(ValueError, match="multiple"):
        mk.search_classed2d_cuda(*args, **kw, splits=0)
    assert mk.search_classed2d_cuda.launches == before


# K2's instance families beyond CASES' fixed widths: the padded K = 16
# instance (n = 4) and the K-slab form (n = 1024), by geometry
WIDE = {"16p": dict(source_size=8, target_size=2), "slab": dict(source_size=64,
                                                                 target_size=32)}


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("case", CASES + [(key, w) for key in ("ls", "raw", "general-ls")
                                          for w in WIDE], ids=lambda c: f"{c[0]}{c[1]}")
def test_classed2d_device_searched_matches_plain(cuda, case, frontier):
    """Each K2 family (every key at K = 16, 64, 256, padded 16p and the
    K-slab form, plain and _thr) with its searched tiles' count on the
    device and the shape plan: no host sync in the launch (the sync debug
    mode raises on one), (q, idx) bitwise against the plain version, the
    grid over the shapes' bound on the work items."""
    key, k = case
    geometry = WIDE[k] if k in WIDE else GEOMETRY[k]
    cfg = T.EncoderConfig(**geometry, **KEYS[key], rms_threshold=10.0 if frontier else 0.0)
    prep = _prep(_smooth(256, 21), cfg, cuda, force_no_pairs=True)
    n, area = cfg.target_size ** 2, cfg.source_size ** 2
    q_p, i_p = tm.classed_kernel(prep, n, area, dataclasses.replace(cfg, backend="torch"))
    tm.classed_kernel(prep, n, area, cfg)  # the build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q_k, i_k = tm.classed_kernel(prep, n, area, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    plan = mk.search_classed2d_cuda.plan
    assert plan["tiles"] == prep["tile_class"].shape[0]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert int(plan["work"]) <= plan["items"] <= plan["tiles"] + 4 * sms


def _n_pairs(make, monkeypatch):
    """Each counted search's n_pairs in ``make()`` with the cap at 4."""
    n_pairs = []
    prep = tm.classed_prep
    monkeypatch.setattr(tm, "classed_prep", lambda *a, **k: (
        lambda p: n_pairs.append(int(p["n_pairs"])) or p)(prep(*a, **k)))
    monkeypatch.setattr(mk, "PAIR_CAP", 4)
    make()
    monkeypatch.setattr(tm, "classed_prep", prep)
    return n_pairs


def _arrays(res):
    from fractencode_tpu_torch.encode.encoder import ARRAY_FIELDS

    return [getattr(res, f) for f in ARRAY_FIELDS]


def _launches():
    return (sum(mk.search_classed_cuda.launches.values()),
            sum(mk.search_classed2d_cuda.launches.values()))


@pytest.mark.parametrize("form,branch", [(f, b) for f in ("plane", "batch", "quadtree")
                                         for b in ("k2", "k1")]
                         + [("plane", "mixed"), ("batch", "mixed")])
def test_counted_route_graph_equals_eager_on_the_card(cuda, form, branch, monkeypatch):
    """At 512^2 with the cap just below the two planes' smallest n_pairs (K2
    taken), at their largest (K1 taken), or for the grid at the smaller
    plane's (the capture takes one branch, the replay on the other plane
    the other): encode_plane, encode_batch_stacked and
    encode_plane_quadtree take their graph; the eager first call, the
    capture and a replay equal the eager encode and the CPU's bitwise; a
    counted search launches both kernels (the counters count both), and a
    warm call makes no host sync."""
    from fractencode_tpu_torch.encode import encoder as enc, quadtree as tq
    from fractencode_tpu_torch.utils import graphs

    cfg, qcfg = T.EncoderConfig(), tq.QuadtreeConfig()
    a, b = _smooth(512, 64), random_plane(512, 65)
    if form == "quadtree":
        eager = lambda p: tq._quadtree_arrays(torch.from_numpy(p).to(cuda), cfg, qcfg)
        call = lambda p, dev=cuda: [getattr(l, f) for l in tq.encode_plane_quadtree(
            p, cfg, qcfg, device=dev).levels for f in tq.LEVEL_ARRAY_FIELDS]
        assert tq._replays(512, 512, cfg, qcfg, cuda)
    else:
        eager = lambda p: enc._encode_arrays(torch.from_numpy(p).to(cuda), cfg)
        if form == "plane":
            call = lambda p, dev=cuda: _arrays(T.encode_plane(p, cfg, device=dev))
        else:
            call = lambda p, dev=cuda: [x[1] for x in _arrays(T.encode_batch_stacked(
                np.stack([p, p]), cfg, device=dev))]
        assert enc._replays(512, 512, cfg, cuda)
    n_a, n_b = (_n_pairs(lambda: eager(p), monkeypatch) for p in (a, b))
    assert n_a and n_b
    if branch == "mixed":
        assert n_a != n_b
        cap = min(n_a[0], n_b[0])
    else:
        cap = min(n_a + n_b) - 1 if branch == "k2" else max(n_a + n_b)
    monkeypatch.setattr(mk, "PAIR_CAP", cap)
    routes = []
    prep = tm.classed_prep
    monkeypatch.setattr(tm, "classed_prep", lambda *a_, **k: (
        lambda p: routes.append((p["route"], p["take_k2"])) or p)(prep(*a_, **k)))
    graphs.clear()
    want = [eager(p) for p in (a, b)]
    torch.cuda.synchronize()
    # the searches of one encode, and its counted ones (the others static K1)
    searches = len(routes) // 2
    counted = [r for r, _ in routes].count("counted") // 2
    taken = {bool(t) for r, t in routes if r == "counted"}
    assert counted and taken == {"k2": {True}, "k1": {False}, "mixed": {False, True}}[branch]
    assert all(r in ("counted", "search_classed") for r, _ in routes)
    frames = 2 if form == "batch" else 1
    before = _launches()
    results = [call(p) for p in (a, a, b)]
    # every search launches K1, a counted one K2 too, in each of 3 calls
    assert tuple(x - y for x, y in zip(_launches(), before)) == (
        3 * frames * searches, 3 * frames * counted)
    name = "encode_plane_quadtree" if form == "quadtree" else "encode_plane"
    assert graphs.calls[name, "capture"] >= 1 and graphs.calls[name, "replay"] >= 2
    cpu = call(a, "cpu")
    for got, exp in zip(results + [cpu], [want[0], want[0], want[1], want[0]]):
        for x, y in zip(got, exp, strict=True):
            assert_bitwise(x, y, f"{form} {branch}")
    for x, y in zip(results[0], results[1]):
        assert_bitwise(x, y, "an earlier result changed")
    plane = torch.from_numpy(a).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if form == "quadtree":
            tq.encode_plane_quadtree(plane, cfg, qcfg)
        elif form == "plane":
            T.encode_plane(plane, cfg)
        else:
            T.encode_batch_stacked(torch.stack([plane, plane]), cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_cli_without_a_card_exits_nonzero(cuda, tmp_path):
    """With the card hidden, the CLI's default --device cuda exits non-zero
    and names --device cpu; it does not run on the CPU by itself."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lenna = os.path.join(repo, "tests", "golden", "lenna128_input.png")
    env = {**os.environ, "PYTHONPATH": repo, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "fractencode_tpu_torch", lenna,
                           "--result", str(tmp_path / "r.png")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    assert not (tmp_path / "r.png").exists()


# K4 and K5, the pair-list step microbenchmark's kernels (ops/micro_kernels.py)
from fractencode_tpu_torch.ops import micro_kernels as mt  # noqa: E402


def _micro_ops(kind, ni, br, nj, bm, device, seed=0):
    """Operands for ni x nj tiles of br x bm: the JAX script's draw law, or
    ties (many equal keys at each row's max; column tile 1 one column
    repeated), with the [K, M] copies."""
    rng = np.random.default_rng(seed)
    r, m = ni * br, nj * bm
    if kind == "draw":
        ops = dict(ai=rng.integers(-128, 128, (r, 16), np.int8),
                   ch=rng.integers(0, 128, (m, 16), np.int8),
                   cl=rng.integers(0, 8, (m, 16), np.int8),
                   sb=rng.random(m, np.float32) * 100, aux=rng.random(m, np.float32))
    else:
        ops = dict(ai=rng.integers(-2, 2, (r, 16), np.int8),
                   ch=rng.integers(0, 2, (m, 16), np.int8), cl=np.zeros((m, 16), np.int8),
                   sb=rng.integers(0, 2, m).astype(np.float32) * 0.25,
                   aux=np.full(m, 0.5, np.float32))
        for name in ("ch", "cl", "sb", "aux"):
            ops[name][bm:2 * bm] = ops[name][bm]
    ops["chT"], ops["clT"] = ops["ch"].T.copy(), ops["cl"].T.copy()
    return {k: torch.from_numpy(v).to(device) for k, v in ops.items()}


def _micro_words(steps, device, cap=64):
    rt, ct, first = (torch.tensor(c, dtype=torch.int32) for c in zip(*steps))
    w = torch.zeros(cap, dtype=torch.int32)
    w[:len(steps)] = mt.pack_pairs(rt, ct, first, torch.ones_like(rt))
    return w.to(device)


def _micro(fn, ops, variant, words, n, br, bm):
    t = variant == "full_t"
    return fn(words, n, ops["ai"], ops["chT" if t else "ch"], ops["clT" if t else "cl"],
              ops["sb"], ops["aux"], variant=variant, block_r=br, block_m=bm)


# (ni, block_r, nj, block_m): a tile of 200 rows (two thread blocks, the
# second part idle), 1000 columns (a staged chunk and a part), and the
# script's 512 x 4096 tiles
MICRO_TILES = [(3, 200, 5, 1000), (2, 512, 3, 4096)]
# each range tile over its column tiles twice, the first restarted midway
# by a second `first`, with a word outside the operands (rt = ni) and one
# range tile (the last) never visited
def _micro_steps(ni, nj):
    steps = [(0, ct, int(ct == 0)) for ct in range(nj)] + [(0, 1, 1), (0, 0, 0)]
    steps += [(ni, 0, 1)]
    for rt in range(1, ni - 1):
        steps += [(rt, ct % nj, int(ct == 0)) for ct in range(2 * nj)]
    return steps


@pytest.mark.parametrize("kind", ["draw", "ties"])
@pytest.mark.parametrize("tiles", MICRO_TILES, ids=["200x1000", "512x4096"])
@pytest.mark.parametrize("variant", mt.VARIANTS)
def test_micro_step_matches_plain(cuda, variant, tiles, kind):
    """Each K4/K5 instance equals its plain version on the card, (q, idx)
    bitwise, and counts one launch."""
    ni, br, nj, bm = tiles
    ops = _micro_ops(kind, ni, br, nj, bm, cuda)
    steps = _micro_steps(ni, nj)
    words = _micro_words(steps, cuda)
    before = mt.micro_step_cuda.launches[variant]
    q_k, i_k = _micro(mt.micro_step_cuda, ops, variant, words, len(steps), br, bm)
    torch.cuda.synchronize()
    assert mt.micro_step_cuda.launches[variant] == before + 1
    q_p, i_p = _micro(mt.micro_step_torch, ops, variant, words, len(steps), br, bm)
    assert_bitwise(q_k, q_p, f"{variant} q")
    assert_bitwise(i_k, i_p, f"{variant} idx")
    assert (q_k[(ni - 1) * br:] == np.float32(-3.0e38)).all()  # the tile no word visits


@pytest.mark.parametrize("tiles", MICRO_TILES, ids=["200x1000", "512x4096"])
def test_micro_k5_equals_k4_full(cuda, tiles):
    """K5 reads the [K, M] layout itself and equals K4 'full' bitwise; an
    empty list leaves every row at (-3e38, 0)."""
    ni, br, nj, bm = tiles
    ops = _micro_ops("draw", ni, br, nj, bm, cuda, seed=3)
    steps = _micro_steps(ni, nj)
    words = _micro_words(steps, cuda)
    q4, i4 = _micro(mt.micro_step_cuda, ops, "full", words, len(steps), br, bm)
    q5, i5 = _micro(mt.micro_step_cuda, ops, "full_t", words, len(steps), br, bm)
    assert_bitwise(q5, q4, "q")
    assert_bitwise(i5, i4, "idx")
    q0, i0 = _micro(mt.micro_step_cuda, ops, "full_t", words, 0, br, bm)
    assert (q0 == np.float32(-3.0e38)).all() and (i0 == 0).all()


def test_micro_library_runs_on_tensor_cores(cuda):
    """The built K4/K5 library's SASS holds tensor-core products (IMMA) and
    no dp4a (IDP.4A), counted as chip_smoke.py's phase 1 counts them."""
    import chip_smoke
    from fractencode_tpu_torch.ops import _build

    if not os.path.exists(os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")):
        pytest.skip("needs cuobjdump beside nvcc")
    _build.load_library("micro_step")
    counts = chip_smoke.sass_counts(_build._library("micro_step"))
    assert counts["IMMA"] > 0 and counts["IDP4A"] == 0, counts


def test_micro_wrapper_refuses_bad_inputs(cuda):
    """'packed' above 4096 columns, K != 16, K5 given row-layout operands,
    words not int32, n_pairs beyond the list, and operands on two devices
    raise before any launch."""
    ops = _micro_ops("draw", 2, 128, 2, 8192, cuda)
    words = _micro_words([(0, 0, 1), (1, 1, 1)], cuda)
    kw = dict(block_r=128, block_m=8192)
    args = lambda **o: {**dict(words=words, n_pairs=2, ai=ops["ai"], ch=ops["ch"],
                               cl=ops["cl"], sb=ops["sb"], aux=ops["aux"]), **o}
    before = dict(mt.micro_step_cuda.launches)
    cases = [("packed", args(), "12 bits"),
             ("full", args(ai=ops["ai"][:, :8].contiguous()), "K = 16"),
             ("full_t", args(), r"\[K, M\]"),
             ("full", args(words=words.to(torch.int64)), "int32"),
             ("full", args(n_pairs=65), "the list's length"),
             ("full", args(words=words.cpu()), "several devices")]
    for variant, a, msg in cases:
        with pytest.raises(ValueError, match=msg):
            mt.micro_step_cuda(*a.values(), variant=variant, **kw)
    assert mt.micro_step_cuda.launches == before


def _distinct_frames(b, n):
    """b distinct seeded [n, n] frames (no frame repeated)."""
    return np.stack([random_plane(n, 40 + i) for i in range(b)])


@pytest.mark.parametrize("cfg", [T.EncoderConfig(), T.EncoderConfig(use_classifier=False)],
                         ids=["default", "nocls"])
def test_batch_frames_equal_single_on_the_card(cuda, cfg):
    """encode_batch_stacked and decode_batch_stacked on the card: each frame
    bitwise equal to encode_plane and decode_plane there, the search's
    launches B times the single frame's, and frame 0 equal to the CPU's."""
    frames = _distinct_frames(3, 128)
    counts = lambda: sum(mk.search_dense_cuda.launches.values()) + \
        sum(mk.search_classed_cuda.launches.values())
    before = counts()
    stacked = T.encode_batch_stacked(frames, cfg, device=cuda)
    assert counts() == before + 3 and stacked.s.device.type == "cuda"
    dcfg = T.DecoderConfig(pyramid=True)
    outs, iters, mses = T.decode_batch_stacked(stacked, dcfg)
    cpu = T.encode_plane(frames[0], cfg, device="cpu")
    for i, plane in enumerate(frames):
        single = T.encode_plane(plane, cfg, device=cuda)
        for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
            assert_bitwise(getattr(stacked, f)[i], getattr(single, f), f"frame {i} {f}")
            if i == 0:
                assert_bitwise(getattr(stacked, f)[i], getattr(cpu, f), f"CPU {f}")
        out, it, mse = T.decode_plane(single, dcfg)
        assert_bitwise(outs[i], out, f"frame {i} pixels")
        assert (int(iters[i]), float(mses[i])) == (it, mse)


def test_batch_quadtree_frames_equal_single_on_the_card(cuda):
    from fractencode_tpu_torch.encode import quadtree as tq

    frames = _distinct_frames(2, 128)
    count = lambda: sum(mk.search_classed_cuda.launches.values())
    before = count()
    stacked = tq.encode_batch_quadtree_stacked(frames, device=cuda)
    launched = count() - before
    singles = [tq.encode_plane_quadtree(plane, device=cuda) for plane in frames]
    assert launched == count() - before - launched > 0
    for i, single in enumerate(singles):
        for ls, l1 in zip(stacked.levels, single.levels, strict=True):
            for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
                assert_bitwise(getattr(ls, f)[i], getattr(l1, f), f"frame {i} {f}")


@pytest.mark.parametrize("num_codes,limit", [(3, 65536), (4, 400), (7, 65536)])
def test_vq_card_equals_cpu(cuda, num_codes, limit):
    """VQ on the card: the normalized vectors, train_codebook's codebook,
    steps and labels, and the encode (K1 on the VQ bins), bitwise equal to
    the CPU's; limit 400 below 961 domains takes the subsample branch."""
    from fractencode_tpu_torch.core.grid import uniform_grid
    from fractencode_tpu_torch.encode import encoder as te
    from fractencode_tpu_torch.encode import vq as tv
    from fractencode_tpu_torch.encode.codebook import build_codebook
    from fractencode_tpu_torch.utils.prng import prng_key

    img = random_plane(256, 17)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pf = torch.from_numpy(img).to(dev).float()
        dvec = te._normalize_affine(build_codebook(pf, uniform_grid(256, 256, 16, 8), 4,
                                                   4).values[:, 0, :])
        cb, labels, steps = tv.train_codebook(dvec, prng_key(5), num_codes,
                                              sample_limit=limit if limit < 961 else None)
        out[dev.type] = (dvec, cb, labels, steps)
    assert out["cuda"][3] == out["cpu"][3]
    for what, g, c in zip(("vectors", "codebook", "labels"), out["cuda"][:3], out["cpu"][:3]):
        assert_bitwise(g, c, what)
    cfg = T.EncoderConfig(vq_classes=num_codes, vq_sample_limit=limit)
    before = sum(mk.search_classed_cuda.launches.values())
    rg = T.encode_plane(img, cfg, device=cuda)
    assert sum(mk.search_classed_cuda.launches.values()) == before + 1
    rc = T.encode_plane(img, cfg, device="cpu")
    for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
        assert_bitwise(getattr(rg, f), getattr(rc, f), f)


@pytest.mark.parametrize("strategy", ["ranges", "domains", "ring"])
def test_sharded_encode_on_the_card(cuda, strategy, monkeypatch):
    """encode_batch_sharded on a (1, 4) mesh of one card repeated, with the
    classifier and without it under --rms 10: each frame bitwise equal to
    encode_plane on the card; 'domains' and 'ring' without the classifier
    launch K3's masked `_thr` instance (the shards' domain masks as
    classes), and nothing runs a plain version on CUDA tensors."""
    from fractencode_tpu_torch.parallel import encode_batch_sharded, make_mesh

    def refuse(*_, **__):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(mk, "search_classed_torch", refuse)
    monkeypatch.setattr(mk, "search_dense_torch", refuse)
    monkeypatch.setattr(mk, "_plain_search", refuse)
    frames = np.stack([_smooth(128, 50), _smooth(128, 51)])
    mesh = make_mesh(1, 4, devices=[cuda] * 4)
    for cfg in (T.EncoderConfig(), T.EncoderConfig(use_classifier=False, rms_threshold=10.0)):
        masked = ("ls", 16, True, True)
        before = mk.search_dense_cuda.launches[masked]
        results = encode_batch_sharded(frames, cfg, mesh, strategy)
        launched = mk.search_dense_cuda.launches[masked] - before
        assert launched == (0 if cfg.use_classifier or strategy == "ranges" else
                            2 * (4 if strategy == "domains" else 16))
        for i, res in enumerate(results):
            assert res.s.device.type == "cuda"
            single = T.encode_plane(frames[i], cfg, device=cuda)
            for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
                assert_bitwise(getattr(res, f), getattr(single, f), f"frame {i} {f}")


# the configs the encode's CUDA graph takes (matcher.replays_graph), by CLI
# flags
GRAPH_PATHS = {"default": [], "compat": ["--compat"], "smax": ["--smax", "0.9"],
               "rms": ["--rms", "10"], "noclassifier": ["--noclassifier"],
               "config1": ["--source", "16", "--target", "8", "--transforms", "8",
                           "--noclassifier"],
               "ranges2": ["--source", "8", "--target", "2"]}


def _graph_config(path):
    from fractencode_tpu_torch import cli

    return cli._config_from_args(cli.build_parser().parse_args(GRAPH_PATHS[path]))


def _search_launches():
    return (sum(mk.search_classed_cuda.launches.values())
            + sum(mk.search_classed2d_cuda.launches.values())
            + sum(mk.search_dense_cuda.launches.values()))


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_equals_eager_on_the_card(cuda, path):
    """encode_plane on its CUDA graph, for each config the graph takes: the
    first call (eager), the second (the capture and a replay) and the third
    (a replay) bitwise equal to the eager encode and to the CPU's; a later
    call on another plane leaves
    the earlier result unchanged; each replay adds the one launch its
    capture recorded; the pyramid decode's graph equals its eager form."""
    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.encode import encoder as enc
    from fractencode_tpu_torch.utils import graphs

    fields = ("domain_idx", "transform", "s", "o", "distance", "valid")
    cfg = _graph_config(path)
    a, b = random_plane(128, 60), random_plane(128, 61)
    assert enc._replays(128, 128, cfg, cuda)
    graphs.clear()
    eager = [enc._result(enc._encode_arrays(torch.from_numpy(p).to(cuda), cfg), 128, 128, cfg)
             for p in (a, b)]
    before, replays = _search_launches(), graphs.calls["encode_plane", "replay"]
    firsts = graphs.calls["encode_plane", "eager"]
    first = T.encode_plane(a, cfg, device=cuda)
    second = T.encode_plane(a, cfg, device=cuda)
    kept = {f: getattr(second, f).clone() for f in fields}
    third = T.encode_plane(b, cfg, device=cuda)
    assert _search_launches() == before + 3
    assert graphs.calls["encode_plane", "replay"] == replays + 2
    assert graphs.calls["encode_plane", "eager"] == firsts + 1
    cpu = T.encode_plane(a, cfg, device="cpu")
    for f in fields:
        assert_bitwise(getattr(second, f), kept[f], f"{f} overwritten by a later call")
        for what, res in (("first", first), ("replay", second), ("cpu", cpu)):
            assert_bitwise(getattr(res, f), getattr(eager[0], f), f"{what} {f}")
        assert_bitwise(getattr(third, f), getattr(eager[1], f), f"other plane {f}")

    dcfg = T.DecoderConfig(pyramid=True)
    img, iters, mse = dec._decode_core(second, dcfg)
    replays = graphs.calls["decode_plane", "replay"]
    for res in (second, second, cpu):
        out, it, m = T.decode_plane(res, dcfg)
        assert_bitwise(out, img, "pyramid decode")
        assert (it, m) == (iters, mse)
    assert graphs.calls["decode_plane", "replay"] == replays + 1


def test_graph_batch_reads_nothing_back(cuda):
    """Once captured, encode_batch_stacked of a batch on the card makes no
    host sync (the sync debug mode raises on one), and its frames equal
    encode_plane's."""
    cfg = T.EncoderConfig()
    frames = torch.from_numpy(_distinct_frames(3, 128)).to(cuda)
    T.encode_batch_stacked(frames, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stacked = T.encode_batch_stacked(frames, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for i in range(3):
        single = T.encode_plane(frames[i], cfg)
        for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
            assert_bitwise(getattr(stacked, f)[i], getattr(single, f), f"frame {i} {f}")


# the quadtree configs whose pyramid replays one CUDA graph, by CLI flags
QT_GRAPH_PATHS = {"default": [], "noclassifier": ["--noclassifier"], "compat": ["--compat"],
                  "smax": ["--smax", "0.9"], "rms": ["--rms", "10"],
                  "qtmin2": ["--qt-min", "2"]}


@pytest.mark.parametrize("path", list(QT_GRAPH_PATHS))
def test_quadtree_graph_equals_eager_on_the_card(cuda, path):
    """encode_plane_quadtree on its CUDA graph: the first call (eager), the
    second (the capture and a replay) and the third (a replay on another
    plane) bitwise equal to the per-level eager encode and the CPU's, each
    replay adding the eager call's launches, a later call leaving the
    earlier result unchanged; the batch replays the graph frame by frame;
    the pyramid and flat decodes of the result equal their eager forms."""
    from fractencode_tpu_torch import cli
    from fractencode_tpu_torch.encode import quadtree as tq
    from fractencode_tpu_torch.utils import graphs

    args = cli.build_parser().parse_args(["--quadtree", *QT_GRAPH_PATHS[path]])
    cfg = cli._config_from_args(args)
    qcfg = tq.QuadtreeConfig(min_size=args.qt_min, max_size=args.qt_max,
                             error_threshold=args.qt_threshold)
    a, b = _smooth(128, 62), random_plane(128, 63)
    assert tq._replays(128, 128, cfg, qcfg, cuda)
    graphs.clear()
    eager = [tq._quadtree_arrays(torch.from_numpy(p).to(cuda), cfg, qcfg) for p in (a, b)]
    calls = lambda: {f: graphs.calls["encode_plane_quadtree", f]
                     for f in ("eager", "capture", "replay")}
    before = calls()
    launches = []
    results = []
    for p in (a, a, b):
        n = _search_launches()
        results.append(tq.encode_plane_quadtree(p, cfg, qcfg, device=cuda))
        launches.append(_search_launches() - n)
    after = calls()
    assert {f: after[f] - before[f] for f in after} == {"eager": 1, "capture": 1, "replay": 2}
    assert launches == [len(qcfg.level_sizes)] * 3
    cpu = tq.encode_plane_quadtree(a, cfg, qcfg, device="cpu")
    flat = lambda r: [getattr(l, f) for l in r.levels for f in tq.LEVEL_ARRAY_FIELDS]
    for res, want in zip(results + [cpu], [eager[0], eager[0], eager[1], eager[0]]):
        for x, y in zip(flat(res), want, strict=True):
            assert_bitwise(x, y, path)
    for x, y in zip(flat(results[0]), flat(results[1])):
        assert_bitwise(x, y, "an earlier result changed")

    stacked = tq.encode_batch_quadtree_stacked(np.stack([a, b]), cfg, qcfg, device=cuda)
    for i, want in enumerate(eager):
        for x, y in zip(flat(stacked), want):
            assert_bitwise(x[i], y, f"batch frame {i}")

    for dcfg in (T.DecoderConfig(pyramid=True), T.DecoderConfig(max_iterations=40)):
        outs = [tq.decode_plane_quadtree(results[1], dcfg) for _ in range(3)]
        want = tq.decode_plane_quadtree(cpu, dcfg)
        for out, it, mse in outs:
            assert_bitwise(out, want[0], f"decode pyramid={dcfg.pyramid}")
            assert (it, mse) == want[1:]


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("dname", ["flat", "nostall", "means", "cap5"])
def test_flat_decode_graph_equals_eager_on_the_card(cuda, dname, chunk, monkeypatch):
    """The flat loop's chunks on their CUDA graph: decode_plane's pixels,
    iterations and MSE equal the eager chunks' on the card and the CPU's,
    at every chunk length, a chunk replaying one graph; the batch's flat
    branch equals the single frames."""
    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.utils import graphs

    dcfg = {"flat": T.DecoderConfig(), "nostall": T.DecoderConfig(stall_window=0),
            "means": T.DecoderConfig(initial="means"),
            "cap5": T.DecoderConfig(max_iterations=5)}[dname]
    monkeypatch.setattr(dec, "_CHUNK", chunk)
    frames = np.stack([_smooth(128, 64), random_plane(128, 65)])
    stacked = T.encode_batch_stacked(frames, T.EncoderConfig(), device=cuda)
    singles = T.encode_batch(frames, T.EncoderConfig(), device=cuda)
    graphs.clear()
    for i, res in enumerate(singles):
        img, it, mse = dec._flat_decode(res, dcfg, graph=False)
        want = (int(it), float(mse))
        replays = graphs.calls["decode_plane_flat", "replay"]
        for _ in range(2):
            out, iters, m = T.decode_plane(res, dcfg)
            assert_bitwise(out, img, f"frame {i}")
            assert (iters, m) == want
        cpu = T.decode_plane(res, dcfg, device="cpu")
        assert_bitwise(cpu[0], img, f"frame {i} cpu")
        assert cpu[1:] == want
        # the step that meets an exit runs but is not counted
        steps = min(want[0] + 1, dcfg.max_iterations)
        assert graphs.calls["decode_plane_flat", "replay"] - replays >= 2 * -(-steps // chunk) - 2
    outs, iters, mses = T.decode_batch_stacked(stacked, dcfg)
    for i, res in enumerate(singles):
        out, it, mse = T.decode_plane(res, dcfg)
        assert_bitwise(outs[i], out, f"batch frame {i}")
        assert (int(iters[i]), float(mses[i])) == (it, mse)


@pytest.mark.parametrize("num_codes,limit", [(4, 65536), (3, 400)])
def test_vq_graph_equals_eager_on_the_card(cuda, num_codes, limit):
    """The VQ encode on its graphs (the k-means' start, its chunks, the
    encode given the codebook): eager == capture == replay == CPU bitwise,
    one K1 launch a call; train_codebook's device loop on the card equals
    the CPU's."""
    from fractencode_tpu_torch.encode import encoder as enc
    from fractencode_tpu_torch.utils import graphs

    cfg = T.EncoderConfig(vq_classes=num_codes, vq_sample_limit=limit)
    a, b = random_plane(256, 66), _smooth(256, 67)
    assert enc._replays(256, 256, cfg, cuda)
    graphs.clear()
    eager = [enc._encode_arrays(torch.from_numpy(p).to(cuda), cfg) for p in (a, b)]
    before = sum(mk.search_classed_cuda.launches.values())
    results = [T.encode_plane(p, cfg, device=cuda) for p in (a, a, b)]
    assert sum(mk.search_classed_cuda.launches.values()) == before + 3
    assert graphs.calls["encode_plane_vq_start", "replay"] >= 2
    assert graphs.calls["train_codebook", "replay"] > 0
    cpu = T.encode_plane(a, cfg, device="cpu")
    fields = ("domain_idx", "transform", "s", "o", "distance", "valid")
    for res, want in zip(results + [cpu], [eager[0], eager[0], eager[1], eager[0]]):
        for f, y in zip(fields, want):
            assert_bitwise(getattr(res, f), y, f)


# the sharded forms' configs on their CUDA graphs (parallel.sharded)
SHARDED_CONFIGS = {"default": {}, "rms": dict(rms_threshold=10.0),
                   "nocls": dict(use_classifier=False),
                   "nocls_rms": dict(use_classifier=False, rms_threshold=10.0)}
SHARDED_FORMS = ("ranges", "domains", "ring", "halo replicate", "halo ring")


def _sharded_form(form, planes, cfg, graph, device):
    """One sharded call of ``form`` on a mesh of ``device`` x 4: a list of
    EncodeResults (the halo forms: of the first plane)."""
    from fractencode_tpu_torch.parallel import make_mesh
    from fractencode_tpu_torch.parallel import sharded as ts

    mesh = make_mesh(1, 4, devices=[device] * 4)
    if form.startswith("halo"):
        return [ts._encode_image(planes[0], cfg, mesh, form.split()[1], graph)]
    return ts._encode_batch(planes, cfg, mesh, form, graph)


@pytest.mark.parametrize("config", list(SHARDED_CONFIGS))
@pytest.mark.parametrize("form", SHARDED_FORMS)
def test_sharded_graph_equals_eager_on_the_card(cuda, form, config):
    """Each sharded form on cuda:0 x 4, through its step graphs: the first
    call (eager, capture, replays) and the second (replays only, no host
    sync: the planes are on the card) bitwise equal to the eager steps and
    to encode_plane; a ring holds at most 4 graph keys."""
    from fractencode_tpu_torch.utils import graphs

    cfg = T.EncoderConfig(**SHARDED_CONFIGS[config])
    planes = torch.from_numpy(np.stack([_smooth(128, 72), random_plane(128, 73)])).to(cuda)
    graphs.clear()
    eager = _sharded_form(form, planes, cfg, False, cuda)
    first = _sharded_form(form, planes, cfg, None, cuda)
    before = collections.Counter(graphs.calls)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = _sharded_form(form, planes, cfg, None, cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    forms = {f for (name, f), n in (graphs.calls - before).items() if name.startswith("sharded_")}
    assert forms == {"replay"}, graphs.calls - before
    if "ring" in form:
        assert len(graphs._GRAPHS) <= 4
    for i, res in enumerate(second):
        single = T.encode_plane(planes[i], cfg)
        for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
            for what, other in (("eager", eager[i]), ("first", first[i]), ("single", single)):
                assert_bitwise(getattr(res, f), getattr(other, f), f"frame {i} {f} {what}")
    graphs.clear()


@pytest.mark.parametrize("pyramid", [False, True], ids=["flat", "pyramid"])
def test_sharded_decodes_on_the_card(cuda, pyramid):
    """decode_batch_sharded on (2, 2) x cuda:0, twice through its graphs:
    pixels and MSEs equal decode_batch_stacked's and the eager form's, its
    iterations the JAX package's sharded rule (every step run: the stacked
    count plus the exit step); at most one host sync a call beside one a
    flat-loop chunk.  decode_batch_quadtree_sharded equals
    decode_plane_quadtree frame by frame."""
    import warnings

    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.encode import quadtree as tq
    from fractencode_tpu_torch.parallel import decode_batch_sharded, make_mesh
    from fractencode_tpu_torch.parallel import sharded as ts

    frames = _distinct_frames(4, 128)
    cfg, dcfg = T.EncoderConfig(), T.DecoderConfig(pyramid=pyramid)
    stacked = T.encode_batch_stacked(frames, cfg, device=cuda)
    results = T.encode_batch(frames, cfg, device=cuda)
    mesh = make_mesh(2, 2, devices=[cuda] * 4)
    so, si, sm = T.decode_batch_stacked(stacked, dcfg)
    want = si if pyramid else (si + 1).clamp(max=dcfg.max_iterations)
    eager = ts._decode_batch(results, mesh, dcfg, graph=False)
    for _ in range(2):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = decode_batch_sharded(results, mesh, pyramid=pyramid)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                    for w in caught)
        chunks = 0 if pyramid else int((-(-got[1] // dec._CHUNK)).sum())
        assert syncs <= 1 + chunks, (syncs, chunks)
        for a, b, c, what in zip(got, (so, want, sm), eager, ("pixels", "iterations", "mse")):
            assert_bitwise(a, b, what)
            assert_bitwise(a, c, f"{what} eager")
    qcfg = tq.QuadtreeConfig()
    qres = [tq.encode_plane_quadtree(f, cfg, qcfg, device=cuda) for f in frames]
    outs, iters, mses = tq.decode_batch_quadtree_sharded(qres, mesh, dcfg)
    for i, q in enumerate(qres):
        out, it, mse = tq.decode_plane_quadtree(q, dcfg)
        assert_bitwise(outs[i], out, f"quadtree frame {i}")
        assert (int(iters[i]), float(mses[i])) == (it, float(np.float32(mse)))


def _marks_and_replays(prof):
    """(the device marks' names in stream order, for each the start of the
    runtime call that launched it (CUPTI's correlation id), and the host
    ``fractencode.replay`` spans as (start, end)) of a CUDA profile, in ns."""
    events = list(prof.profiler.kineto_results.events())
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.name() == "cudaGraphLaunch" and str(e.device_type()).endswith("CPU")}
    marks, replays = [], []
    for e in events:
        if e.name().startswith("fractencode_mark_"):
            marks.append((e.start_ns(), e.name().removeprefix("fractencode_mark_"),
                          launched.get(e.correlation_id())))
        elif e.name() == "fractencode.replay" and str(e.device_type()).endswith("CPU"):
            replays.append((e.start_ns(), e.end_ns()))
    marks.sort()
    return [m for _, m, _ in marks], [t for _, _, t in marks], sorted(replays)


_STAGES = ["inputs", "prep", "search", "post"]


@pytest.mark.parametrize("form", ["encode", "quadtree", "decode"])
def test_traced_twin_on_the_card(cuda, form):
    """Each entry's graph and its traced twin on the card: the twin's
    outputs (a replay while torch.profiler records) are bitwise the plain
    graph's and the eager call's; the CUPTI trace holds each frame's marks
    in order, and no other; one capture a key; each body's ``begin`` mark
    was launched from inside a ``fractencode.replay`` span: the graph launch
    that ran it (CUPTI's correlation id) lies inside the span, one body a
    span.  (Host spans and device records share
    kineto's clock only to within its alignment, which read the device up
    to 0.8 ms early on the card, so the launch, a host record, is what is
    compared.)"""
    from torch.profiler import ProfilerActivity, profile

    from fractencode_tpu_torch.encode import quadtree
    from fractencode_tpu_torch.utils import graphs

    planes = torch.from_numpy(_distinct_frames(2, 512)).to(cuda)
    dcfg = T.DecoderConfig(pyramid=True)
    encoded = T.encode_batch_stacked(planes)
    if form == "encode":
        run = lambda: T.encode_plane(planes[0])  # noqa: E731
        fields, frame = ("domain_idx", "transform", "s", "o", "distance", "valid"), 1
        want = ["begin", *_STAGES, "end"]
    elif form == "quadtree":
        run = lambda: quadtree.encode_batch_quadtree_stacked(planes)  # noqa: E731
        fields, frame = None, 2
        want = ["begin", *_STAGES * 3, "end"] * 2
    else:
        run = lambda: T.decode_batch_stacked(encoded, dcfg)  # noqa: E731
        fields, frame = None, 2
        want = ["begin", "end"] * 2

    def arrays(out):
        if fields:
            return [getattr(out, f).clone() for f in fields]
        if form == "quadtree":
            return [getattr(l, f).clone() for l in out.levels
                    for f in ("domain_idx", "transform", "s", "o", "error", "accepted")]
        return [x.clone() for x in out]

    graphs.clear()
    before = collections.Counter(graphs.calls)
    eager = arrays(run())  # a batch's first call: its first frame eager, the next replayed
    plain = arrays(run())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = arrays(run())
        torch.cuda.synchronize()
    again = arrays(run())
    calls = graphs.calls - before
    assert sum(n for (_, f), n in calls.items() if f == "capture") == 1
    assert sum(n for (_, f), n in calls.items() if f == "replay") == 4 * frame - 1
    for i, (a, b, c, d) in enumerate(zip(eager, plain, traced, again)):
        for what, x in (("plain", b), ("twin", c), ("plain after the twin", d)):
            assert_bitwise(x, a, f"{form} array {i}: {what}")
    marks, launches, replays = _marks_and_replays(prof)
    assert marks == want
    begins = [t for m, t in zip(marks, launches) if m == "begin"]
    assert len(replays) == len(begins) == frame
    assert all(b0 <= t <= b1 for (b0, b1), t in zip(replays, begins)), (replays, begins)


# -- the decoder step's kernel (ops/decode_kernels.py, csrc/decode_step.cu)


def _steps(geometry, case, o_is_mean, cuda, size=None):
    """(the kernel's step on the card, the plain step on the CPU, the plain
    step on the card) of the numpy ``case``; the kernel launched once."""
    sw, ts, step, t_n, n = DECODE_STEP_GEOMETRIES[geometry]
    n = size or n
    img, dom, tr, s, o = (torch.from_numpy(a) for a in case)

    def plain(device):
        tables = dec.build_decode_tables(dom.to(device), tr.to(device), n, n, sw, ts, step, t_n)
        return dec._decode_step_torch(img.to(device), tables, s.to(device), o.to(device),
                                      n, n, ts, o_is_mean)

    tables = dec._step_tables(dom.to(cuda), tr.to(cuda), n, n, sw, ts, step, t_n)
    assert tables[0] == "cells"
    key = (ts, o_is_mean)
    launches = dk.decode_step_cuda.launches[key]
    got = dec._decode_step(img.to(cuda), tables, s.to(cuda), o.to(cuda), n, n, ts, o_is_mean)
    torch.cuda.synchronize()
    assert dk.decode_step_cuda.launches[key] == launches + 1
    return got, plain("cpu"), plain(cuda)


@pytest.mark.parametrize("o_is_mean", [False, True], ids=["so", "mean"])
@pytest.mark.parametrize("geometry", list(DECODE_STEP_GEOMETRIES))
def test_decode_step_kernel_matches_plain(cuda, geometry, o_is_mean):
    """One launch of the kernel, bitwise the plain step on the CPU and its
    torch ops on the card, at every table kind, the grid's and the
    quadtree's geometries at both scales, 3 to 32 px ranges, o_is_mean at
    K = 4 to 1024, pixels past 0 and 255 and invalid ranges."""
    got, cpu, card = _steps(geometry, decode_step_case(geometry, 21, o_is_mean), o_is_mean, cuda)
    assert_bitwise(got, cpu, f"{geometry} against the CPU")
    assert_bitwise(got, card, f"{geometry} against the card's torch ops")
    if not o_is_mean:
        assert bool((cpu == 0).any()) and bool((cpu == 255).any())


@pytest.mark.parametrize("geometry", ["ts3", "grid", "ts5", "qt8"])
def test_decode_step_kernel_sees_the_means_rounding(cuda, geometry):
    """On ``mean_maps`` (a pixel one grey level lower wherever a mean is one
    ulp off) the kernel's means are the plain step's, K = 9, 16, 25, 64."""
    img, dom, tr, s, o = decode_step_case(geometry, 22, o_is_mean=True)
    sw, ts, step, t_n, n = DECODE_STEP_GEOMETRIES[geometry]
    tables = dec.build_decode_tables(torch.from_numpy(dom), torch.from_numpy(tr), n, n,
                                     sw, ts, step, t_n)
    s, o = mean_maps(dec.sample_domains(torch.from_numpy(img), tables))
    got, cpu, card = _steps(geometry, (img, dom, tr, s, o), True, cuda)
    assert_bitwise(got, cpu, geometry)
    assert_bitwise(got, card, geometry)


@pytest.mark.parametrize("geometry,size", [("grid_half", 1024), ("grid", 2048)])
def test_decode_step_kernel_at_the_decode_cells_shapes(cuda, geometry, size):
    """The pyramid decode's two steps of a 2048^2 frame: 1024^2 with 2 px
    ranges and 2048^2 with 4 px ones."""
    got, _, card = _steps(geometry, decode_step_case(geometry, 23, size=size), False, cuda, size)
    assert_bitwise(got, card, f"{geometry} at {size}^2")


def test_decode_step_is_one_kernel_on_the_card(cuda):
    """A traced full-scale step runs one device operation, the kernel: no
    [R, K] gather, cast, product or permute, no copy."""
    from torch.profiler import ProfilerActivity, profile

    sw, ts, step, t_n, _ = DECODE_STEP_GEOMETRIES["grid"]
    img, dom, tr, s, o = (torch.from_numpy(a).to(cuda)
                          for a in decode_step_case("grid", 24, size=512))
    tables = dec._step_tables(dom, tr, 512, 512, sw, ts, step, t_n)
    want = dec._decode_step(img, tables, s, o, 512, 512, ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = dec._decode_step(img, tables, s, o, 512, 512, ts)
        torch.cuda.synchronize()
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if not str(e.device_type()).endswith("CPU")]
    assert len(ops) == 1 and "decode_step_kernel" in ops[0], ops
    assert_bitwise(out, want, "traced step")


def test_pyramid_decode_launches_the_kernel_14_times_a_frame(cuda):
    """decode_batch_stacked in the decode cell's pyramid (8 steps at half
    scale, 6 at full) launches the kernel 14 times a frame on every call:
    the eager first frame, the capture's taken back, and each replay's
    through ``graphs._counters``; the frames equal the CPU's."""
    from fractencode_tpu_torch.utils import graphs

    encoded = T.encode_batch_stacked(torch.from_numpy(_distinct_frames(2, 256)).to(cuda))
    dcfg = T.DecoderConfig(pyramid=True, pyramid_steps=8, pyramid_levels=1,
                           pyramid_full_steps=6)
    graphs.clear()
    replays = graphs.calls["decode_plane", "replay"]
    for _ in range(3):
        before = collections.Counter(dk.decode_step_cuda.launches)
        outs, iters, mses = T.decode_batch_stacked(encoded, dcfg)
        assert dk.decode_step_cuda.launches - before == {(2, False): 16, (4, False): 12}
    assert graphs.calls["decode_plane", "replay"] == replays + 5
    cpu = T.decode_batch_stacked(dec._to_device(encoded, "cpu"), dcfg)
    assert_bitwise(outs, cpu[0], "frames")
    assert torch.equal(iters, cpu[1]) and torch.equal(mses, cpu[2])


def _decode_forms(cuda):
    """{form: a function that decodes on the card and returns its tensors}:
    the pyramid decode_plane, decode_batch_stacked, the quadtree's pyramid
    and flat decodes, the flat decode_plane and a file's (o_is_mean)."""
    from fractencode_tpu_torch import codec
    from fractencode_tpu_torch.encode import quadtree as tq

    frames = _distinct_frames(2, 256)
    encoded = T.encode_batch_stacked(torch.from_numpy(frames).to(cuda))
    single = T.encode_plane(frames[0], device=cuda)
    qres = tq.encode_plane_quadtree(frames[1], device=cuda)
    ures = codec.unpack_result(codec.pack_result(single, plane=frames[0]), device=cuda)
    pyr, flat = T.DecoderConfig(pyramid=True), T.DecoderConfig(max_iterations=40)
    return {"plane": lambda: T.decode_plane(single, pyr)[:1],
            "batch": lambda: T.decode_batch_stacked(encoded, pyr),
            "quadtree": lambda: tq.decode_plane_quadtree(qres, pyr)[:1],
            "quadtree_flat": lambda: tq.decode_plane_quadtree(qres, flat)[:1],
            "flat": lambda: T.decode_plane(single, flat)[:1],
            "file": lambda: T.decode_plane(ures, flat)[:1]}


@pytest.mark.parametrize("form", ["plane", "batch", "quadtree", "quadtree_flat", "flat", "file"])
def test_decodes_on_their_graphs_equal_the_plain_step(cuda, form, monkeypatch):
    """Each decode form on the card, three calls through its graphs (eager,
    capture and replay, replay), launching the kernel, bitwise equal to the
    same form with the plain torch step on the card (``_step_tables`` and
    ``_decode_step`` patched to the plain versions)."""
    from fractencode_tpu_torch.utils import graphs

    run = _decode_forms(cuda)[form]
    graphs.clear()
    before = sum(dk.decode_step_cuda.launches.values())
    kernel = [[x.clone() for x in run()] for _ in range(3)]
    assert sum(dk.decode_step_cuda.launches.values()) > before
    monkeypatch.setattr(dec, "_step_tables", dec.build_decode_tables)
    monkeypatch.setattr(dec, "_decode_step", dec._decode_step_torch)
    graphs.clear()
    launches = sum(dk.decode_step_cuda.launches.values())
    plain = [x.clone() for x in run()]
    assert sum(dk.decode_step_cuda.launches.values()) == launches
    graphs.clear()
    for out in kernel:
        for x, y in zip(out, plain, strict=True):
            assert_bitwise(x, y, form)
