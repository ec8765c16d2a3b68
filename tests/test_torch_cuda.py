"""The port's CUDA kernels against their plain PyTorch version, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
without one (the CPU parity tests in test_torch_*.py cover the plain
version against the JAX package).  Run on a machine with a card, where jax
may be absent (tests/conftest.py imports it): ``python -m pytest
tests/test_torch_cuda.py -q --noconftest``.
"""
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


def _prep(img, cfg, device, **blocks):
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
    return tm.classed_prep(ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
                           classify_grid(p, rg), classify_grid(p, dg), cfg, **blocks)


@pytest.mark.parametrize("blocks", [{}, dict(block_r=512, block_m=4096),
                                    dict(block_r=8, block_m=128)])
@pytest.mark.parametrize("n", [128, 256])
def test_kernel_matches_plain(cuda, n, blocks):
    """(q, idx) of every sorted row bitwise, at several layout tiles (block_r
    512 runs four thread blocks per range tile, 8 leaves most threads idle)."""
    img = random_plane(n, 5)
    cfg = T.EncoderConfig()
    prep = _prep(img, cfg, cuda, **blocks)
    before = mk.search_classed_cuda.launches[16]
    q_k, i_k = tm.classed_kernel(prep, 16, 256, cfg)
    assert mk.search_classed_cuda.launches[16] == before + 1
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
    before = mk.search_classed_cuda.launches[k]
    q_k, i_k = tm.classed_kernel(prep, k, ds * ds, cfg)
    assert mk.search_classed_cuda.launches[k] == before + 1
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
    rc = tq.encode_plane_quadtree(img)
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
    rc = T.encode_plane(img)
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


@pytest.mark.parametrize("cfg", [T.REFERENCE_COMPAT(), T.EncoderConfig(s_max=1.0),
                                 T.EncoderConfig(source_size=8, target_size=2)])
def test_uncovered_configs_raise_on_cuda(cuda, cfg):
    """Configs the kernel does not cover (the raw and general keys, K = 4)
    raise on CUDA (no fallback), and run there with backend='torch' like on
    the CPU.  Winners, validity and distances come from exact integer
    keys."""
    import dataclasses

    img = random_plane(64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.encode_plane(img, cfg, device=cuda)
    rg = T.encode_plane(img, dataclasses.replace(cfg, backend="torch"), device=cuda)
    rc = T.encode_plane(img, cfg)
    for f in ("domain_idx", "transform", "valid", "distance"):
        assert_bitwise(getattr(rg, f), getattr(rc, f), f)
