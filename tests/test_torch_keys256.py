"""Port parity, the 'raw' and 'general' keys at K = 256 (the quadtree's 16 px
level, 64 -> 16): the plain K1 and K3 against the JAX package's Pallas
kernels (``fused_search_pairs`` through ``classed_kernel``, and
``fused_search``; interpret mode) and its jnp oracle ``search``, with and
without the early-accept frontier, on the CPU.

The parity rule of ROADMAP.md for K = 256: the JAX package ranks and solves
in f32, whose values depend on summation order and FMA contraction; the
port ranks from exact integers, each key rounded once ('raw': the integer
16q = 8*(4*SumAB) - 16*SumB2; 'general': the residual in float64 from the
exact sums).  So winners must be equal, and keys, distances, s and o agree
to the tolerances below (the largest difference measured on these planes,
times about five).  No winner differs on these planes; a near-tie that did
would be named here.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, lenna128, random_plane
from test_torch_matcher import _jax_inputs, _port_inputs

import fractencode_tpu as J
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu.ops.matcher_pallas import DEFAULT_BM, DEFAULT_BR, fused_search
from fractencode_tpu_torch.bridge import config_from_jax_fields
from fractencode_tpu_torch.ops import matcher_kernels as mk

# Relative tolerance on keys and distances (largest measured: 2.3e-4, the
# 'general' key with so_mode 'reference' on the wave).
Q_RTOL = 5e-4
# s: relative, with an absolute floor for values near 0 (largest measured:
# 4.3e-5 absolute where s is near 0, 1.2e-4 relative elsewhere).  o: so_mode
# 'reference' forms o = (SumB - s*SumA)/n, so it inherits s's difference
# times the range's mean (<= 255): the floor is 255 S_ATOL (largest
# measured: 2.8e-3 absolute, 6.8e-4 relative, where o is near 4).
S_RTOL, S_ATOL = 5e-4, 1e-4
O_RTOL, O_ATOL = 5e-4, 255 * S_ATOL


def smooth_wave(n: int, seed: int) -> np.ndarray:
    """A smooth wave plus uniform noise in [0, 6): about half of its 16 px
    ranges meet the frontier's threshold under 'raw' and 'general' with
    s_max (a natural plane's rarely do)."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
            + np.random.default_rng(seed).integers(0, 6, (n, n))).astype(np.uint8)


PLANES = {"lenna128": lenna128(), "rand128": random_plane(128, 3),
          "wave128": smooth_wave(128, 13)}
# the three configs of the 'raw' and 'general' keys, and the threshold at
# which some of the wave's 16 px ranges hit (the 'reference' so_mode's
# residual is larger: its s is not the least-squares one)
KEYS = {"raw": (lambda **kw: J.REFERENCE_COMPAT(**kw), 10.0),
        "smax": (lambda **kw: J.EncoderConfig(s_max=0.9, **kw), 10.0),
        "reference": (lambda **kw: J.EncoderConfig(so_mode="reference", **kw), 60.0)}
FIELDS = ("domain_idx", "transform", "distance", "s", "o", "valid", "key")


def _jcfg(key, threshold=0.0, t_n=4, classifier=True):
    make, _ = KEYS[key]
    return make(backend="jnp", source_size=64, target_size=16, num_transforms=t_n,
                rms_threshold=threshold, use_classifier=classifier)


def _threshold(key, frontier):
    return KEYS[key][1] if frontier else 0.0


_j_search = jax.jit(jm.search, static_argnames="cfg")


@functools.lru_cache(maxsize=None)
def _jax_args(pname, t_n):
    """The JAX search's inputs, built under a config of the geometry alone
    (one compile per number of isometries)."""
    geometry = J.EncoderConfig(source_size=64, target_size=16, num_transforms=t_n)
    return _jax_inputs(jnp.asarray(PLANES[pname]), geometry)


@functools.lru_cache(maxsize=None)
def _jax_oracle(pname, jcfg):
    return _j_search(*_jax_args(pname, jcfg.num_transforms), jcfg)


def _jax_k1(pname, jcfg):
    """(q, idx) of the JAX package's K1 (fused_search_pairs, interpret mode)
    on its own class layout at its block sizes, and that layout's rpos."""
    args = _jax_args(pname, jcfg.num_transforms)
    ranges, _, _, cb, _, _ = args
    d, t, _ = cb.values.shape
    block_r, block_m, _, _, worst, p_cap, _ = jm._classed_statics(ranges.shape[0], d * t, jcfg)
    prep = jm.classed_prep(*args, jcfg)
    _, idx, q = jm.classed_kernel(prep, 256, 64 * 64, block_r, block_m, p_cap, worst,
                                  jcfg, interpret=True, t_n=t)
    return np.asarray(q), np.asarray(idx)


def _jax_k3(pname, jcfg):
    """(q, idx) of the JAX package's K3 (fused_search, interpret mode) over
    the search-order columns, as search_pallas calls it without classes."""
    ranges, sum_a, sum_a2, cb, _, _ = _jax_args(pname, jcfg.num_transforms)
    r = ranges.shape[0]
    d, t, _ = cb.values.shape
    m = d * t
    cols = [x[:, ::-1].reshape(m, *x.shape[2:]) for x in (cb.values, cb.sum, cb.sum_sq)]
    block_r, block_m = 64, 128
    assert r % block_r == 0 and m % block_m, "the m_valid tail must be exercised"
    cpad = lambda x: jnp.pad(x, [(0, block_m - m)] + [(0, 0)] * (x.ndim - 1))
    _, idx, q = fused_search(
        ranges, sum_a, sum_a2, cpad(cols[0]), cpad(cols[1]), cpad(cols[2]),
        jnp.zeros((r,), jnp.int32), jnp.zeros((block_m,), jnp.int32),
        criterion=jcfg.criterion, so_mode=jcfg.so_mode, s_max=jcfg.s_max,
        inv_norm=1.0 / (64 * 64) if jcfg.criterion == "raw" else 1.0 / 256,
        use_classes=False, m_valid=m, block_r=block_r, block_m=block_m,
        use_int8=False, interpret=True, threshold=jcfg.rms_threshold, t_n=t)
    return np.asarray(q), np.asarray(idx)


def _port_search(img, tcfg):
    args = _port_inputs(img, tcfg)
    if tcfg.use_classifier:
        return tm.search_classed(*args, tcfg)
    return tm.search_dense(*args[:4], None, None, tcfg)


def _assert_close(rj, rt, what=""):
    """Winners and validity equal; keys, distances, s and o to tolerance."""
    for f in ("domain_idx", "transform", "valid"):
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f"{what} {f}")
    for f, rtol, atol in (("key", Q_RTOL, 0.0), ("distance", Q_RTOL, 0.0),
                          ("s", S_RTOL, S_ATOL), ("o", O_RTOL, O_ATOL)):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {f}")


@pytest.mark.parametrize("pname", ["lenna128", "rand128"])
@pytest.mark.parametrize("key", list(KEYS))
def test_plain_k1_matches_pallas(key, pname):
    """The plain K1 against fused_search_pairs (interpret mode, its f32
    branch) on the same layout (the JAX block sizes): idx of every sorted
    row that holds a range equal, q to Q_RTOL.  The layout's padding rows
    differ by design: the f32 branch pads the ranges with 0, the int8
    operands with ai = 0 (pixels of 128); their results are discarded."""
    jcfg = _jcfg(key)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES[pname]
    q_j, idx_j = _jax_k1(pname, jcfg)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, block_r=DEFAULT_BR,
                         block_m=DEFAULT_BM)
    assert pt["aux_s"].dtype == torch.float64  # the exact SumB2
    q_t, idx_t = tm.classed_kernel(pt, 256, 64 * 64, tcfg)
    rows = pt["rpos"].numpy()
    assert_bitwise(idx_j[rows], idx_t[rows], "idx")
    np.testing.assert_allclose(q_t[rows].numpy(), q_j[rows], rtol=Q_RTOL, atol=0)


@pytest.mark.parametrize("key", list(KEYS))
def test_plain_k1_frontier_matches_pallas(key):
    """The same with the early-accept frontier on the wave (4 isometries):
    the rows that hold a range (with the frontier the port does not search
    the layout's padding rows), idx equal, q to Q_RTOL, and some ranges hit."""
    jcfg = _jcfg(key, _threshold(key, True))
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["wave128"]
    q_j, idx_j = _jax_k1("wave128", jcfg)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, block_r=DEFAULT_BR,
                         block_m=DEFAULT_BM)
    q_t, idx_t = tm.classed_kernel(pt, 256, 64 * 64, tcfg)
    rows = pt["rpos"].numpy()
    assert_bitwise(idx_j[rows], idx_t[rows], "idx")
    np.testing.assert_allclose(q_t[rows].numpy(), q_j[rows], rtol=Q_RTOL, atol=0)


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "frontier"])
@pytest.mark.parametrize("key", list(KEYS))
def test_plain_k3_matches_fused_search(key, frontier):
    """The plain K3 (through dense_prep and dense_kernel) against
    fused_search (interpret mode, f32 branch; M not a multiple of its
    block_m) on the wave, 4 isometries (fused_search takes the frontier only
    where its block_m is a multiple of T; test_frontier_search_matches_oracle
    covers T = 3): idx equal, q to Q_RTOL."""
    jcfg = _jcfg(key, _threshold(key, frontier), classifier=False)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["wave128"]
    q_j, idx_j = _jax_k3("wave128", jcfg)
    prep = tm.dense_prep(*_port_inputs(img, tcfg)[:4], None, None, tcfg)
    assert prep["aux"].dtype == torch.float64
    q_t, idx_t = tm.dense_kernel(prep, 256, 64 * 64, tcfg)
    assert_bitwise(idx_j, idx_t, "idx")
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=Q_RTOL, atol=0)


CASES = [(key, cls) for key in KEYS for cls in (True, False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'cls' if c[1] else 'nocls'}")
@pytest.mark.parametrize("pname", ["lenna128", "rand128"])
def test_search_matches_oracle(pname, case):
    """The port's search (K1's plain version with the classifier, K3's
    without) against the JAX package's jnp oracle ``search``: winners equal,
    keys, distances, s and o to tolerance; and bitwise equal to the port's
    own oracle, which ranks with the same exact keys."""
    key, cls = case
    jcfg = _jcfg(key, classifier=cls)
    tcfg = config_from_jax_fields(jcfg)
    rt = _port_search(PLANES[pname], tcfg)
    _assert_close(_jax_oracle(pname, jcfg), rt, pname)
    ro = tm.search(*_port_inputs(PLANES[pname], tcfg), tcfg)
    for f in FIELDS:
        assert_bitwise(getattr(ro, f), getattr(rt, f), f)


@pytest.mark.parametrize("t_n", [4, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'cls' if c[1] else 'nocls'}")
def test_frontier_search_matches_oracle(case, t_n):
    """With the frontier on the wave (T = 4, and T = 3, whose groups cross
    K1's column tiles): the port's search against the JAX oracle, winners
    equal and the rest to tolerance, bitwise equal to the port's oracle; and
    the frontier is not vacuous (it changes some winner)."""
    key, cls = case
    jcfg = _jcfg(key, _threshold(key, True), t_n, cls)
    tcfg = config_from_jax_fields(jcfg)
    img = PLANES["wave128"]
    rt = _port_search(img, tcfg)
    _assert_close(_jax_oracle("wave128", jcfg), rt)
    ro = tm.search(*_port_inputs(img, tcfg), tcfg)
    for f in FIELDS:
        assert_bitwise(getattr(ro, f), getattr(rt, f), f)
    off = _port_search(img, dataclasses.replace(tcfg, rms_threshold=0.0))
    changed = (rt.domain_idx != off.domain_idx) | (rt.transform != off.transform)
    assert bool(changed.any()), "vacuous: the frontier changed no winner"
    assert bool((rt.distance[changed] <= np.float32(tcfg.rms_threshold)).all())


@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("t_n", [4, 3])
def test_frontier_independent_of_tiles(t_n, key):
    """The plain K1 with the frontier gives the same result, bitwise, at
    block sizes (128, 128), (8, 256) and (128, 256): the frontier's groups
    count from each class segment's start, not from a tile's."""
    tcfg = config_from_jax_fields(_jcfg(key, _threshold(key, True), t_n))
    args = _port_inputs(PLANES["wave128"], tcfg)
    ref = tm.search_classed(*args, tcfg)
    for block_r, block_m in ((8, 256), (128, 256), (8, 128)):
        res = tm.search_classed(*args, tcfg, block_r=block_r, block_m=block_m)
        for f in FIELDS:
            assert_bitwise(getattr(ref, f), getattr(res, f), f)


def _exact_sums(img, tcfg):
    """Every (range, column) pair's exact integer sums in int64 numpy:
    SumA, SumA2 [R, 1]; 4*SumB, 16*SumB2 [1, M]; 4*SumAB [R, M]."""
    ranges, sa, sa2, cb, _, _ = _port_inputs(img, tcfg)
    a = ranges.numpy().astype(np.int64)
    b4 = np.round(cb.values.flip(1).reshape(-1, 256).numpy().astype(np.float64) * 4)
    b4 = b4.astype(np.int64)
    return (a.sum(1)[:, None], (a * a).sum(1)[:, None], b4.sum(1)[None],
            (b4 * b4).sum(1)[None], a @ b4.T)


@pytest.mark.parametrize("key", list(KEYS))
def test_exact_keys_follow_their_rule(key):
    """The plain K3's q of every pair (one column at a time, so each row's
    best is that pair's key) against the rule of ROADMAP.md evaluated in
    numpy from the exact integers: 'raw' f32(8*(4*SumAB) - 16*SumB2)/16;
    'general' the residual in float64, then -f32(max(e, 0)/n); bitwise."""
    tcfg = config_from_jax_fields(_jcfg(key, classifier=False))
    img = PLANES["lenna128"]
    sa, sa2, sb4, sb2_16, ab4 = _exact_sums(img, tcfg)
    n = 256
    if key == "raw":
        want = (8 * ab4 - sb2_16).astype(np.float32) * np.float32(0.0625)
    else:
        cov = (n * ab4 - sa * sb4).astype(np.float64) * 0.25
        if tcfg.so_mode == "ls":
            var_b = (n * sb2_16 - sb4 * sb4).astype(np.float64) * 0.0625
            den, var_a = var_b, (n * sa2 - sa * sa).astype(np.float64)
        else:
            den = np.broadcast_to((n * sa2 - (sa - 1) * sa).astype(np.float64), cov.shape)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.where(den == 0, 0.0, cov / np.where(den == 0, 1.0, den))
        if tcfg.s_max > 0:
            s = np.clip(s, -float(np.float32(tcfg.s_max)), float(np.float32(tcfg.s_max)))
        if tcfg.so_mode == "ls":
            e = (var_a - 2.0 * s * cov + (s * s) * var_b) * (1.0 / n)
        else:
            sb, ab, sb2 = sb4 * 0.25, ab4 * 0.25, sb2_16 * 0.0625
            o = (sb - s * sa) * (1.0 / n)
            e = (sa2 + (s * s) * sb2 + n * o * o + 2.0 * s * o * sb
                 - 2.0 * s * ab - 2.0 * o * sa)
        want = -(np.maximum(e, 0.0) * (1.0 / n)).astype(np.float32)
    prep = tm.dense_prep(*_port_inputs(img, tcfg)[:4], None, None, tcfg)
    got = np.empty_like(want)
    for j in range(want.shape[1]):
        one = {f: (v[j:j + 1] if f in ("ch", "cl", "sb", "aux") else v)
               for f, v in prep.items()}
        got[:, j] = tm.dense_kernel(one, 256, 64 * 64, tcfg)[0].numpy()
    assert_bitwise(want, got, "q")


@pytest.mark.parametrize("so_mode", ["reference", "ls"])
def test_winner_solve_from_exact_sums(so_mode):
    """_winners (solve_so) at K = 256 from exact sums: s within 2 ulp of the
    exact quotient num/den (numerator and denominator each rounded once to
    f32, then one division), and o equal, bitwise, to one f32 rounding of
    the float64 SumB - s*SumA (SumA - s*SumB for 'ls') times f32(1/n)."""
    tcfg = config_from_jax_fields(_jcfg("raw" if so_mode == "reference" else "smax",
                                        classifier=False))
    tcfg = dataclasses.replace(tcfg, s_max=-1.0)
    img = PLANES["lenna128"]
    rt = _port_search(img, tcfg)
    sa, sa2, sb4, sb2_16, ab4 = _exact_sums(img, tcfg)
    win = (rt.domain_idx.numpy().astype(np.int64) * 4 + 3 - rt.transform.numpy())
    rows = np.arange(win.shape[0])
    sa, sa2 = sa[:, 0], sa2[:, 0]
    sb4, sb2_16, ab4 = sb4[0, win], sb2_16[0, win], ab4[rows, win]
    num = (256 * ab4 - sa * sb4) * 0.25
    den = (256 * sa2 - (sa - 1) * sa if so_mode == "reference" else
           (256 * sb2_16 - sb4 * sb4) * 0.0625)
    assert (den != 0).all()
    exact = num / den
    s = rt.s.numpy()
    assert (np.abs(s - exact) <= 2 * np.spacing(np.abs(exact).astype(np.float32))).all()
    sb, fa = sb4 * 0.25, sa.astype(np.float64)
    o64 = sb - s.astype(np.float64) * fa if so_mode == "reference" else fa - s * sb
    want = o64.astype(np.float32) * np.float32(1.0 / 256)
    assert_bitwise(want, rt.o, "o")


def test_kernel_keys_cover_k256():
    """Every key has a CUDA instance at K = 256, so the quadtree's 16 px
    level under --compat and --smax launches a kernel on the card."""
    for mode in ("ls", "raw", "general"):
        assert 256 in mk.KERNEL_KEYS[mode]
        for launches, masks in ((mk.search_classed_cuda.launches, [()]),
                                (mk.search_dense_cuda.launches, [(False,), (True,)])):
            for mask in masks:
                assert (mode, 256, False, *mask) in launches
                assert (mode, 256, True, *mask) in launches
