"""The port's CUDA kernels against their plain PyTorch version, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
without one (the CPU parity tests in test_torch_*.py cover the plain
version against the JAX package).  Run on a machine with a card, where jax
may be absent (tests/conftest.py imports it): ``python -m pytest
tests/test_torch_cuda.py -q --noconftest``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, random_plane

import fractencode_tpu_torch as T
from fractencode_tpu_torch.encode import matcher as tm
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
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges

    n = img.shape[0]
    p = torch.from_numpy(img).to(device)
    pf = p.to(torch.float32)
    dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
    cb = build_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(pf, cfg.target_size)
    return (ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
            classify_grid(p, rg), classify_grid(p, dg))


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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_dense_kernel_matches_plain(cuda, case, masked):
    """K3 at every (mode, K) it covers, with and without the class mask:
    (q, idx) of every range bitwise against the plain version."""
    key, k = case
    cfg = _case_cfg(key, k)
    ranges, sa, sa2, cb, rcls, dcls = _inputs(random_plane(128, 11), cfg, cuda)
    if not masked:
        rcls = dcls = None
    prep = tm.dense_prep(ranges, sa, sa2, cb, rcls, dcls, cfg)
    assert (prep["rcls"] is None) != masked
    mode = key.split("-")[0]
    before = mk.search_dense_cuda.launches[(mode, k, False)]
    area = cfg.source_size ** 2
    q_k, i_k = tm.dense_kernel(prep, k, area, cfg)
    assert mk.search_dense_cuda.launches[(mode, k, False)] == before + 1
    q_p, i_p = tm.dense_kernel(prep, k, area, _case_cfg(key, k, backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    if masked:  # some rows' best column lies outside their class
        unmasked = tm.dense_kernel(dict(prep, rcls=None, ccls=None), k, area, cfg)
        assert bool((unmasked[0] > q_k).any())


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


@pytest.mark.parametrize("cfg", [T.REFERENCE_COMPAT(source_size=8, target_size=2),
                                 T.EncoderConfig(s_max=1.0, source_size=8, target_size=2),
                                 T.EncoderConfig(source_size=8, target_size=2)])
def test_uncovered_configs_raise_on_cuda(cuda, cfg):
    """Configs no kernel covers (K = 4, under each key, with and without
    the classifier) raise on CUDA (no fallback), and run there with
    backend='torch' like on the CPU.  Winners, validity and distances come
    from exact integer keys."""
    img = random_plane(64)
    for use_classifier in (True, False):
        c = dataclasses.replace(cfg, use_classifier=use_classifier)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.encode_plane(img, c, device=cuda)
        rg = T.encode_plane(img, dataclasses.replace(c, backend="torch"), device=cuda)
        rc = T.encode_plane(img, c, device="cpu")
        for f in ("domain_idx", "transform", "valid", "distance"):
            assert_bitwise(getattr(rg, f), getattr(rc, f), f)


@pytest.mark.parametrize("t_n", [4, 3])
@pytest.mark.parametrize("kernel", ["classed", "dense"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_frontier_kernels_match_plain(cuda, case, kernel, t_n):
    """Every `_thr` instance (K1 and K3, each key and K) with the early-accept
    frontier at 10.0 on a smooth 256^2 plane, at 4 isometries and at 3 (the
    groups then straddle K1's column tiles and the kernels' chunks): (q, idx)
    of every row bitwise against the plain version, and the frontier active
    (it changes some rows' keys)."""
    key, k = case
    cfg = _case_cfg(key, k, rms_threshold=10.0)
    if t_n == 3:
        cfg = dataclasses.replace(cfg, num_transforms=3)
    yy, xx = np.mgrid[0:256, 0:256]
    img = (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
           + np.random.default_rng(13).integers(0, 6, (256, 256))).astype(np.uint8)
    inputs = _inputs(img, cfg, cuda)
    mode = key.split("-")[0]
    area = cfg.source_size ** 2
    off = dataclasses.replace(cfg, rms_threshold=0.0)
    if kernel == "classed":
        prep = tm.classed_prep(*inputs, cfg)
        run, launches = (lambda c: tm.classed_kernel(prep, k, area, c)), \
            mk.search_classed_cuda.launches
    else:
        prep = tm.dense_prep(*inputs[:4], None, None, cfg)
        run, launches = (lambda c: tm.dense_kernel(prep, k, area, c)), \
            mk.search_dense_cuda.launches
    before = launches[(mode, k, True)]
    q_k, i_k = run(cfg)
    assert launches[(mode, k, True)] == before + 1
    q_p, i_p = run(dataclasses.replace(cfg, backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    assert bool((run(off)[0] != q_k).any()), "vacuous: the frontier changed no key"


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("kernel", ["classed", "dense"])
@pytest.mark.parametrize("key", ["raw", "general-ls", "general-reference"])
def test_exact_key_instances_match_plain(cuda, key, kernel, frontier):
    """The 'raw' and 'general' instances at K = 256 (raw256, general256 and
    their `_thr` forms, K1 and K3; 'general' under both so_modes) on a
    smooth 256^2 plane at the quadtree's 16 px level geometry: (q, idx) of
    every row bitwise against the plain version, through the encoder's own
    calls; with the frontier some rows' keys change."""
    cfg = _case_cfg(key, 256, rms_threshold=60.0 if frontier else 0.0)
    yy, xx = np.mgrid[0:256, 0:256]
    img = (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
           + np.random.default_rng(15).integers(0, 6, (256, 256))).astype(np.uint8)
    inputs = _inputs(img, cfg, cuda)
    mode = key.split("-")[0]
    if kernel == "classed":
        prep = tm.classed_prep(*inputs, cfg)
        run, launches = (lambda c: tm.classed_kernel(prep, 256, 64 * 64, c)), \
            mk.search_classed_cuda.launches
    else:
        prep = tm.dense_prep(*inputs[:4], None, None, cfg)
        run, launches = (lambda c: tm.dense_kernel(prep, 256, 64 * 64, c)), \
            mk.search_dense_cuda.launches
    assert prep["aux_s" if kernel == "classed" else "aux"].dtype == torch.float64
    before = launches[(mode, 256, frontier)]
    q_k, i_k = run(cfg)
    assert launches[(mode, 256, frontier)] == before + 1
    q_p, i_p = run(dataclasses.replace(cfg, backend="torch"))
    torch.cuda.synchronize()
    assert_bitwise(q_k, q_p, "q")
    assert_bitwise(i_k, i_p, "idx")
    if frontier:
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
             mk.search_dense_cuda.launches, ("raw", 16, True))):
        before = launches[key]
        T.encode_plane(img, cfg, device=cuda)
        assert launches[key] == before + 1


def _smooth(n, seed):
    """A smooth wave plus uniform noise: many ranges meet the threshold 10."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
            + np.random.default_rng(seed).integers(0, 6, (n, n))).astype(np.uint8)


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_classed2d_kernel_matches_plain(cuda, case, frontier):
    """Each K2 instance on the forced route (force_no_pairs), with the split
    width it picks and with splits of two groups: (q, idx) of every sorted
    row bitwise against its plain version; K2 launches, K1 does not."""
    key, k = case
    cfg = _case_cfg(key, k, rms_threshold=10.0 if frontier else 0.0)
    prep = _prep(_smooth(256, 16), cfg, cuda, force_no_pairs=True)
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
    assert mk.search_classed2d_cuda.plan["splits"] > 1


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
        assert n is None or mk.search_classed2d_cuda.plan["splits"] == n


@pytest.mark.parametrize("threshold", [0.0, 10.0])
def test_classed2d_few_searched_tiles(cuda, threshold):
    """A range mask that leaves 200 of 16,384 ranges (a fine quadtree
    level's coverage): K2 at the width it picks (many splits) against its
    plain version, (q, idx) of every sorted row bitwise, with the partials
    sized by the searched tiles, not by r_pad."""
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
    assert plan["splits"] > 1
    assert plan["partial_bytes"] * 4 < 9 * plan["splits"] * r_pad


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
