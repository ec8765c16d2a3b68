"""Port parity at every range size: the searches at n = target_size^2 pixels
a range that are not 16, 64 or 256 (the padded operands, K = 16, 64 or 256),
and above 256 (the K-slab form, K a multiple of 256), on the CPU.

The plain K1 (``search_classed_torch``) and K3 (``search_dense_torch``) run
on the port's own operands, zero past n, against the JAX package's
interpret-mode Pallas kernels (``fused_search_pairs`` through
``classed_kernel``, and ``fused_search``) and its jnp oracle ``search``:
each key ('ls'; 'raw', the reference's; 'general' with s_max and with so_mode
'reference'), with and without the early-accept frontier (10.0), on crops of
the in-repo Lenna plane.  This file holds n = 4 and 9 (2x2 and 3x3 ranges);
the padded operands against unpadded ones, and the integers of the K-slab
form at n = 4096 are in test_torch_range_sizes_operands.py;
test_torch_range_sizes_mid.py holds n = 36 and 49,
test_torch_range_sizes_wide.py n = 100, 144 and 1024, and
test_torch_range_sizes_encode.py the whole encode, the quadtree and the
files.

One rule per range of n (ROADMAP.md, parity contract):
  * n <= 64: the JAX package's int8 path; the port is bitwise equal for the
    'ls' and 'raw' keys.  The 'general' key keeps its caveat (XLA may fuse
    its multiply-adds, and its residual cancels terms of order n 255^2):
    winners, s and o bitwise, keys and distances to GENERAL_Q_ATOL.
  * 64 < n <= 256: the K = 256 rule, test_torch_keys256.py's tolerances.
  * n > 256: the JAX package computes in f32 with heavy cancellation in
    n*SumAB - SumA*SumB; the port in exact integers, each key rounded once.
    Winners equal (no winner differs on these planes: a near-tie that did
    would be named here), keys, s and o to the N_WIDE tolerances, each the
    largest difference measured on these planes times five.

The JAX package samples its codebook at 32 px ranges with one strided slice
per (isometry, pixel), 4,096 of them, which takes XLA ~40 s to compile on
the CPU.  So the JAX side here builds every codebook on its general path
(``_half_res_taps`` reporting no half-image taps: a block gather and four
tap gathers), which its docstring holds bit-exact with the strided slices;
test_torch_range_sizes_operands.py holds the two equal at 16 px.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_bitwise, lenna128
from test_torch_keys256 import O_ATOL, O_RTOL, Q_RTOL, S_ATOL, S_RTOL
from test_torch_matcher import _jax_inputs, _port_inputs

import fractencode_tpu as J
import fractencode_tpu.decode.decoder as jdec
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu.ops.matcher_pallas import fused_search
from fractencode_tpu_torch.bridge import config_from_jax_fields
from fractencode_tpu_torch.ops import matcher_kernels as mk

# n -> (domain size, range size, plane size): the plane a crop of lenna128
GEOMETRY = {4: (8, 2, 64), 9: (12, 3, 60), 36: (12, 6, 96), 49: (14, 7, 98),
            100: (20, 10, 100), 144: (24, 12, 96), 400: (40, 20, 120),
            1024: (64, 32, 128)}
KEYS = {"ls": J.EncoderConfig, "raw": J.REFERENCE_COMPAT,
        "smax": functools.partial(J.EncoderConfig, s_max=0.9),
        "reference": functools.partial(J.EncoderConfig, so_mode="reference")}
THRESHOLD = 10.0
FIELDS = ("domain_idx", "transform", "valid", "key", "distance", "s", "o")

# n <= 64, the 'general' key: absolute tolerance on keys and distances, five
# times the largest difference measured on these planes (with s_max 1.8e-3
# at n = 49; so_mode 'reference' 3.0e-2 at n = 36, K1), over K1, K3 and the
# oracle.
GENERAL_Q_ATOL = {"smax": 9.1e-3, "reference": 0.152}
# n > 256, each the largest difference measured on these planes times five
# (n = 1024, over K1, K3 and the oracle): keys and distances relative
# 1.5e-4 (so_mode 'reference'); s 6.1e-5 absolute, 1.6e-4 relative; o
# 1.1e-2 absolute, 3.1e-4 relative.
N_WIDE_Q_RTOL = 7.5e-4
N_WIDE_S_RTOL, N_WIDE_S_ATOL = 8e-4, 3.1e-4
N_WIDE_O_RTOL, N_WIDE_O_ATOL = 1.6e-3, 5.3e-2


@contextlib.contextmanager
def jax_general_sampling():
    """The JAX package's codebook built on its general sampling path."""
    taps = jdec._half_res_taps
    jdec._half_res_taps = lambda *args: None
    try:
        yield
    finally:
        jdec._half_res_taps = taps


def plane(n: int) -> np.ndarray:
    size = GEOMETRY[n][2]
    return np.ascontiguousarray(lenna128()[:size, :size])


def jcfg(key: str, n: int, frontier: bool = False, classifier: bool = True):
    source, target, _ = GEOMETRY[n]
    return KEYS[key](backend="jnp", source_size=source, target_size=target,
                     rms_threshold=THRESHOLD if frontier else 0.0,
                     use_classifier=classifier)


@functools.lru_cache(maxsize=None)
def jax_args(n: int):
    """The JAX search's inputs on n's plane, built under a config of the
    geometry alone (one compile per n)."""
    source, target, _ = GEOMETRY[n]
    with jax_general_sampling():
        return _jax_inputs(jnp.asarray(plane(n)),
                           J.EncoderConfig(source_size=source, target_size=target))


@functools.lru_cache(maxsize=None)
def port_args(n: int):
    source, target, _ = GEOMETRY[n]
    return _port_inputs(plane(n), config_from_jax_fields(jcfg("ls", n)))


_j_search = jax.jit(jm.search, static_argnames="cfg")
_j_prep = jax.jit(jm.classed_prep, static_argnames=("cfg", "force_no_pairs"))


def jax_k1(n: int, cfg):
    """(q, idx) of the JAX package's K1 (interpret mode) on its class layout
    at its block sizes; the layout's rpos and block sizes."""
    args = jax_args(n)
    ranges, _, _, cb, _, _ = args
    r, k = ranges.shape
    d, t, _ = cb.values.shape
    block_r, block_m, _, _, worst, p_cap, _ = jm._classed_statics(r, d * t, cfg)
    prep = _j_prep(*args, cfg)
    _, idx, q = jm.classed_kernel(prep, k, cb.grid.block_size ** 2, block_r, block_m,
                                  p_cap, worst, cfg, interpret=True, t_n=t)
    return np.asarray(q), np.asarray(idx), np.asarray(prep["rpos"]), block_r, block_m


def port_k1(n: int, cfg, block_r: int, block_m: int):
    """(q, idx, rpos) of the plain K1 on the port's padded operands."""
    tcfg = config_from_jax_fields(cfg)
    prep = tm.classed_prep(*port_args(n), tcfg, block_r=block_r, block_m=block_m)
    assert prep["ai_s"].shape[1] == mk.kernel_width(n)
    q, idx = tm.classed_kernel(prep, n, GEOMETRY[n][0] ** 2, tcfg)
    return q.numpy(), idx.numpy(), prep["rpos"].numpy()


def jax_k3(n: int, cfg):
    """(q, idx) of the JAX package's K3 (interpret mode) over the
    search-order columns without classes, as search_pallas calls it (the
    column tail past m_valid included)."""
    ranges, sum_a, sum_a2, cb, _, _ = jax_args(n)
    r, k = ranges.shape
    d, t, _ = cb.values.shape
    m = d * t
    aux = cb.inv_var_or_compute() if mk.rank_mode(cfg.criterion, cfg.so_mode,
                                                  cfg.s_max) == "ls" else cb.sum_sq
    cols = [x[:, ::-1].reshape(m, *x.shape[2:]) for x in (cb.values, cb.sum, aux)]
    block_r, block_m = -(-r // 8) * 8, -(-m // 128) * 128 + 128
    rpad = lambda x: jnp.pad(x, [(0, block_r - r)] + [(0, 0)] * (x.ndim - 1))
    cpad = lambda x: jnp.pad(x, [(0, block_m - m)] + [(0, 0)] * (x.ndim - 1))
    _, idx, q = fused_search(
        rpad(ranges), rpad(sum_a), rpad(sum_a2), cpad(cols[0]), cpad(cols[1]),
        cpad(cols[2]), jnp.zeros((block_r,), jnp.int32), jnp.zeros((block_m,), jnp.int32),
        criterion=cfg.criterion, so_mode=cfg.so_mode, s_max=cfg.s_max,
        inv_norm=1.0 / cb.grid.block_size ** 2 if cfg.criterion == "raw" else 1.0 / k,
        use_classes=False, m_valid=m, block_r=block_r, block_m=block_m,
        use_int8=k <= mk.INT8_MAX_K, interpret=True, threshold=cfg.rms_threshold, t_n=t)
    return np.asarray(q)[:r], np.asarray(idx)[:r]


def port_k3(n: int, cfg):
    tcfg = config_from_jax_fields(cfg)
    ranges, sa, sa2, cb, _, _ = port_args(n)
    prep = tm.dense_prep(ranges, sa, sa2, cb, None, None, tcfg)
    q, idx = tm.dense_kernel(prep, n, GEOMETRY[n][0] ** 2, tcfg)
    return q.numpy(), idx.numpy()


def jax_oracle(n: int, cfg):
    return _j_search(*jax_args(n), cfg)


def port_search(n: int, cfg):
    tcfg = config_from_jax_fields(cfg)
    args = port_args(n)
    if tcfg.use_classifier:
        return tm.search_classed(*args, tcfg)
    return tm.search_dense(*args[:4], None, None, tcfg)


def _general(key: str) -> bool:
    return key in ("smax", "reference")


def assert_keys(n: int, key: str, qj, qt, ij, it, what: str):
    """A search's (q, idx) by n's rule: winners equal; keys bitwise at
    n <= 64 but for the 'general' key, else to n's tolerance."""
    assert_bitwise(ij, it, f"{what} idx")
    if n <= mk.INT8_MAX_K and not _general(key):
        assert_bitwise(qj, qt, f"{what} q")
    elif n <= mk.INT8_MAX_K:
        np.testing.assert_allclose(qt, qj, rtol=0.0, atol=GENERAL_Q_ATOL[key],
                                   err_msg=f"{what} q")
    else:
        rtol = Q_RTOL if n <= mk.F32_SUMS_MAX_K else N_WIDE_Q_RTOL
        np.testing.assert_allclose(qt, qj, rtol=rtol, atol=0.0, err_msg=f"{what} q")


def assert_results(n: int, key: str, rj, rt, what: str = ""):
    """A SearchResult, or an EncodeResult (no key), by n's rule (the module
    docstring)."""
    for f in ("domain_idx", "transform", "valid"):
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f"{what} {f}")
    if n <= mk.INT8_MAX_K:
        bitwise = FIELDS[3:] if not _general(key) else ("s", "o")
        for f in (f for f in bitwise if hasattr(rj, f)):
            assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f"{what} {f}")
        if _general(key):
            for f in (f for f in ("key", "distance") if hasattr(rj, f)):
                np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                           rtol=0.0, atol=GENERAL_Q_ATOL[key], err_msg=f)
        return
    wide = n > mk.F32_SUMS_MAX_K
    tols = {"key": (N_WIDE_Q_RTOL if wide else Q_RTOL, 0.0),
            "distance": (N_WIDE_Q_RTOL if wide else Q_RTOL, 0.0),
            "s": (N_WIDE_S_RTOL, N_WIDE_S_ATOL) if wide else (S_RTOL, S_ATOL),
            "o": (N_WIDE_O_RTOL, N_WIDE_O_ATOL) if wide else (O_RTOL, O_ATOL)}
    for f, (rtol, atol) in ((f, tol) for f, tol in tols.items() if hasattr(rj, f)):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {f}")


def check_k1(n: int, key: str, frontier: bool):
    """The plain K1 against fused_search_pairs on the same class layout:
    every sorted row at n <= 64, else, and with the frontier, every range's
    row (the layout's padding rows are A = 128 in the int8 operands and 0 in
    the JAX package's f32 ones, and keep the initial value in the port under
    the frontier)."""
    cfg = jcfg(key, n, frontier)
    qj, ij, rpos_j, block_r, block_m = jax_k1(n, cfg)
    qt, it, rpos_t = port_k1(n, cfg, block_r, block_m)
    assert_bitwise(rpos_j, rpos_t, "rpos")
    rows = rpos_t if frontier or n > mk.INT8_MAX_K else slice(None)
    assert_keys(n, key, qj[rows], qt[rows], ij[rows], it[rows], f"K1 n={n}")


def check_k3(n: int, key: str, frontier: bool):
    cfg = jcfg(key, n, frontier, classifier=False)
    qj, ij = jax_k3(n, cfg)
    qt, it = port_k3(n, cfg)
    assert_keys(n, key, qj, qt, ij, it, f"K3 n={n}")


def check_oracle(n: int, key: str, frontier: bool, classifier: bool):
    cfg = jcfg(key, n, frontier, classifier)
    assert_results(n, key, jax_oracle(n, cfg), port_search(n, cfg), f"n={n}")


NS = [4, 9]


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", NS)
def test_plain_k1_matches_fused_search_pairs(n, key, frontier):
    check_k1(n, key, frontier)


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", NS)
def test_plain_k3_matches_fused_search(n, key, frontier):
    check_k3(n, key, frontier)


@pytest.mark.parametrize("classifier", [True, False], ids=["classed", "dense"])
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", NS)
def test_search_matches_oracle(n, key, frontier, classifier):
    check_oracle(n, key, frontier, classifier)
