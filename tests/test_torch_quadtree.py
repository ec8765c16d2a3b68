"""Port parity, quadtree (``--quadtree``): the quadtree encode, its decode,
the bridge and the CLI, against the JAX package on the CPU.  The search at
the levels' geometries (K1 at K = 64 and 256, the level codebooks) is held
in test_torch_quadtree_search.py.

The JAX side runs the jnp oracle (``backend='auto'`` on the CPU, as its CLI
does), level by level, so one compile per level geometry serves every
threshold and plane.  Its own tests hold that oracle bitwise to the
interpret-mode Pallas kernel.

Two rules (ROADMAP.md, parity contract):
  * 4 px (K = 16) and 8 px (K = 64) levels: bitwise.
  * 16 px (K = 256): the JAX package ranks and solves in f32, whose values
    depend on summation order and FMA contraction; the port uses the exact
    integers, each rounded once.  Winners and leaves must agree exactly;
    s, o and the per-pixel error to the tolerances below,
    measured on these planes (the largest difference seen, times about
    five).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import GOLDEN, assert_bitwise, lenna128

import fractencode_tpu as J
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import quadtree_from_numpy, quadtree_to_numpy

LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")

# K = 256 tolerances: relative, with an absolute floor for values near 0.
# Largest differences measured on these planes: s 2.2e-6 absolute (1.2e-5
# relative); o 6.9e-6 relative; error 2.3e-5 relative and 2.7e-5 absolute
# where it is near 0.
S_RTOL, S_ATOL = 5e-5, 1e-5
O_RTOL, O_ATOL = 5e-5, 1e-5
ERR_RTOL, ERR_ATOL = 1.2e-4, 1e-4


def smooth_plane(n: int, seed: int) -> np.ndarray:
    """Low-frequency cosines plus mild noise, dark (values ~30..115): large
    smooth regions, so the 16 px level accepts leaves, and no flat block.

    Dark on purpose: at the 8 px level (K = 64) every SumB2 of such a plane
    stays below 2^20 and is exact in f32, as on lenna128.  Where a sum is
    not exact, the JAX oracle reads XLA's f32 sum, whose order differs from
    one correct rounding in the last bit on some entries, and s, o and error
    at 8 px then differ in the last bits (ROADMAP.md, parity contract)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = np.full((n, n), 70.0)
    for _ in range(3):
        fx, fy = rng.uniform(0.3, 2.0, 2)
        img += rng.uniform(10, 18) * np.cos(2 * np.pi * (fx * xx + fy * yy)
                                            + rng.uniform(0, 2 * np.pi))
    img += rng.normal(0.0, 1.5, (n, n))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


PLANES = {"lenna128": lenna128(), "smooth128": smooth_plane(128, 5),
          "smooth64": smooth_plane(64, 6)}


class _LevelByLevel:
    """A reporter: makes the JAX encode run its per-level programs."""

    def log(self, *_):
        pass


@functools.lru_cache(maxsize=None)
def _jax_quadtree(pname: str, threshold: float):
    return jq.encode_plane_quadtree(PLANES[pname], J.EncoderConfig(),
                                    jq.QuadtreeConfig(error_threshold=threshold),
                                    reporter=_LevelByLevel())


@functools.lru_cache(maxsize=None)
def _port_quadtree(pname: str, threshold: float):
    return tq.encode_plane_quadtree(PLANES[pname], T.EncoderConfig(),
                                    tq.QuadtreeConfig(error_threshold=threshold),
                                    device="cpu")


def _jax_levels_numpy(rj):
    return [({f: np.asarray(getattr(l, f)) for f in LEVEL_FIELDS},
             dict(range_size=l.range_size, domain_size=l.domain_size,
                  domain_step=l.domain_step, o_is_mean=l.o_is_mean,
                  num_transforms=l.num_transforms)) for l in rj.levels]


def _to_jax(levels, width, height):
    return jq.QuadtreeResult(
        levels=[jq.QuadtreeLevel(**{f: jnp.asarray(a[f]) for f in LEVEL_FIELDS},
                                 **meta) for a, meta in levels],
        width=width, height=height)


def _knife_edges(rj, threshold, ny16):
    """16 px blocks whose JAX error lies within the K = 256 tolerance of the
    threshold: their acceptance may flip between the packages."""
    err = np.asarray(rj.levels[0].error).reshape(ny16, -1)
    tol = ERR_ATOL + ERR_RTOL * np.abs(err)
    return np.isfinite(err) & (np.abs(err - threshold) <= tol)


@pytest.mark.parametrize("case", [("lenna128", 50.0), ("lenna128", 20.0),
                                  ("lenna128", 120.0), ("smooth128", 50.0),
                                  ("smooth128", 20.0)])
def test_quadtree_encode_matches_jax(case):
    """Every level: accepted, domain_idx and transform bitwise; s, o and
    error bitwise at 8 and 4 px and to the K = 256 tolerances at 16 px.
    Blocks under a 16 px knife edge are named and left out (these planes
    have none)."""
    pname, threshold = case
    rj, rt = _jax_quadtree(pname, threshold), _port_quadtree(pname, threshold)
    h = PLANES[pname].shape[0]
    knife = _knife_edges(rj, threshold, h // 16)
    assert not knife.any(), f"{pname} knife edges at 16 px: {np.argwhere(knife)}"
    assert [l.range_size for l in rj.levels] == [l.range_size for l in rt.levels]
    excluded = knife
    for lj, lt in zip(rj.levels, rt.levels):
        keep = ~excluded.reshape(-1)
        for f in LEVEL_FIELDS:
            a, b = np.asarray(getattr(lj, f))[keep], getattr(lt, f).numpy()[keep]
            if lj.range_size < 16 or f in ("domain_idx", "transform", "accepted"):
                assert_bitwise(a, b, f"{lj.range_size} px {f}")
        if lj.range_size == 16:
            tols = dict(s=(S_RTOL, S_ATOL), o=(O_RTOL, O_ATOL),
                        error=(ERR_RTOL, ERR_ATOL))
            for f, (rtol, atol) in tols.items():
                a, b = np.asarray(getattr(lj, f))[keep], getattr(lt, f).numpy()[keep]
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f)
        assert (lj.range_size, lj.domain_size, lj.domain_step) == \
            (lt.range_size, lt.domain_size, lt.domain_step)
        excluded = np.repeat(np.repeat(excluded, 2, 0), 2, 1)
    assert rj.num_leaves == rt.num_leaves


@pytest.mark.parametrize("pname", ["lenna128", "smooth64"])
def test_coverage_mask_leaves_bit_identical(pname):
    """Masking covered blocks changes no accepted leaf: the masks and every
    stored field of the accepted entries equal the full per-level search."""
    qcfg = tq.QuadtreeConfig()
    r_on = tq.encode_plane_quadtree(PLANES[pname], T.EncoderConfig(), qcfg, device="cpu")
    r_off = tq.encode_plane_quadtree(
        PLANES[pname], T.EncoderConfig(),
        dataclasses.replace(qcfg, mask_covered=False), device="cpu")
    assert int(r_on.levels[0].accepted.sum()) > 0, "vacuous: no 16 px leaf"
    assert r_on.num_leaves == r_off.num_leaves
    for lon, loff in zip(r_on.levels, r_off.levels):
        assert_bitwise(lon.accepted, loff.accepted, "accepted")
        acc = lon.accepted
        for f in ("domain_idx", "transform", "s", "o", "error"):
            assert_bitwise(getattr(lon, f)[acc], getattr(loff, f)[acc], f)


@pytest.mark.parametrize("pyramid", [True, False])
def test_decode_jax_encode(pyramid):
    """A JAX quadtree encode, carried across by bridge.py, decodes to the
    JAX decoder's pixels, iteration count and MSE."""
    rj = _jax_quadtree("lenna128", 50.0)
    oj, ij, mj = jq.decode_plane_quadtree(rj, J.DecoderConfig(pyramid=pyramid))
    rx = quadtree_from_numpy(_jax_levels_numpy(rj), rj.width, rj.height, "cpu")
    ot, it, mt = tq.decode_plane_quadtree(rx, T.DecoderConfig(pyramid=pyramid))
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert (int(ij), float(mj)) == (it, mt)


def test_jax_decodes_port_encode():
    """The other way: the port's encode, as numpy, decodes in the JAX
    package to the port decoder's pixels; the bridge round trip is lossless."""
    rt = _port_quadtree("lenna128", 50.0)
    levels, w, h = quadtree_to_numpy(rt)
    back = quadtree_from_numpy(levels, w, h, "cpu")
    for lt, lb in zip(rt.levels, back.levels):
        for f in LEVEL_FIELDS:
            assert_bitwise(getattr(lt, f), getattr(lb, f), f)
    dcfg = dict(pyramid=True)
    oj, ij, mj = jq.decode_plane_quadtree(_to_jax(levels, w, h),
                                          J.DecoderConfig(**dcfg))
    ot, it, mt = tq.decode_plane_quadtree(rt, T.DecoderConfig(**dcfg))
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert (int(ij), float(mj)) == (it, mt)


def test_quadtree_refuses_unported_options():
    """A 32 px level (n = 1024, the K-slab form) under the 'raw' key without
    the classifier runs as the JAX package's does: leaves and winners of
    every level exactly, s, o and error bitwise at 8 and 4 px, to the 'raw'
    key's K = 256 tolerances (test_torch_keys256.py) at 16 px and to
    test_torch_range_sizes.py's n > 256 ones at
    32 px (the JAX side samples its codebook on its general path, which
    compiles in a fraction of a second at 32 px); a plane not aligned to the
    coarsest range size still raises."""
    import test_torch_keys256 as k256
    from test_torch_range_sizes import (N_WIDE_O_ATOL, N_WIDE_O_RTOL, N_WIDE_Q_RTOL,
                                        N_WIDE_S_ATOL, N_WIDE_S_RTOL, jax_general_sampling)

    img = PLANES["smooth128"]  # 'raw' errors: its 32 px leaves need a threshold of 400
    with jax_general_sampling():
        rj = jq.encode_plane_quadtree(img, J.REFERENCE_COMPAT(use_classifier=False),
                                      jq.QuadtreeConfig(max_size=32, error_threshold=400.0))
    rt = tq.encode_plane_quadtree(img, T.REFERENCE_COMPAT(use_classifier=False),
                                  tq.QuadtreeConfig(max_size=32, error_threshold=400.0),
                                  device="cpu")
    assert [l.range_size for l in rt.levels] == [32, 16, 8, 4]
    assert int(rt.levels[0].accepted.sum()) > 0, "vacuous: no 32 px leaf"
    tols = {16: dict(s=(k256.S_RTOL, k256.S_ATOL), o=(k256.O_RTOL, k256.O_ATOL),
                     error=(k256.Q_RTOL, 0.0)),
            32: dict(s=(N_WIDE_S_RTOL, N_WIDE_S_ATOL), o=(N_WIDE_O_RTOL, N_WIDE_O_ATOL),
                     error=(N_WIDE_Q_RTOL, 0.0))}
    for lj, lt in zip(rj.levels, rt.levels, strict=True):
        for f in LEVEL_FIELDS:
            a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
            if lj.range_size < 16 or f in ("domain_idx", "transform", "accepted"):
                assert_bitwise(a, b, f"{lj.range_size} px {f}")
            else:
                rtol, atol = tols[lj.range_size][f]
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                           err_msg=f"{lj.range_size} px {f}")
    assert rj.num_leaves == rt.num_leaves
    with pytest.raises(ValueError, match="aligned"):
        tq.encode_plane_quadtree(PLANES["smooth64"][:56, :56], device="cpu")


def test_cli_quadtree_matches_jax_cli(tmp_path, capsys):
    """``--quadtree`` on lenna128 on the CPU: the port's CLI prints the JAX
    CLI's leaves per level and decode statistics, the same PSNR to 1e-4 dB,
    and writes the same image (both CLIs run in this process)."""
    import os
    import re

    from PIL import Image

    from fractencode_tpu.cli import main as j_main
    from fractencode_tpu_torch.cli import main as t_main

    lenna = os.path.join(GOLDEN, "lenna128_input.png")
    assert t_main([lenna, "--quadtree", "--device", "cpu",
                   "--result", str(tmp_path / "t.png")]) == 0
    port = capsys.readouterr().out
    assert j_main([lenna, "--quadtree", "--result", str(tmp_path / "j.png")]) == 0
    ref = capsys.readouterr().out

    def psnr(out):
        return float(re.search(r"psnr: ([0-9.]+) dB", out).group(1))

    assert abs(psnr(port) - psnr(ref)) <= 1e-4
    lines = lambda out: [l for l in out.splitlines()
                         if " leaves " in l or l.startswith("decode stats")]
    assert len(lines(port)) == 2 and lines(port) == lines(ref)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                          np.asarray(Image.open(tmp_path / "j.png")))
