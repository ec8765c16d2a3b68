"""Port parity, the search at the quadtree's level geometries: the 8 px
(32 -> 8, K = 64) and 16 px (64 -> 16, K = 256) level codebooks and the
plain K1 against the JAX package's Pallas kernel (interpret mode) on the
CPU.  At K = 256 the JAX package ranks in f32 and the port with exact
integers (ROADMAP.md, parity contract): winners must agree, keys to Q_RTOL."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise
from test_torch_matcher import _jax_inputs, _jax_search, _port_inputs
from test_torch_quadtree import PLANES

import fractencode_tpu as J
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu.ops.matcher_pallas import DEFAULT_BM, DEFAULT_BR
from fractencode_tpu_torch.decode.decoder import _half_res_taps
from fractencode_tpu_torch.encode.codebook import build_codebook as t_codebook

# (domain, range) sizes of the default pyramid's levels by K
GEOMETRY = {64: (32, 8), 256: (64, 16)}
# Each row's best key at K = 256: 1.0e-4 relative measured on these planes.
Q_RTOL = 5e-4


@pytest.mark.parametrize("k", [64, 256])
def test_level_codebook_matches_jax(k):
    """The 8 px (32 -> 8) and 16 px (64 -> 16) level codebooks take the half-
    image fast path; values and SumB bitwise; SumB2 correctly rounded, which
    equals XLA's f32 sum at K = 64 on lenna128 (exact there) and lies within
    5e-7 of it at K = 256 (XLA's sum of 256 terms: 1.5e-7 measured)."""
    from fractencode_tpu_torch.core.grid import uniform_grid

    ds, rs = GEOMETRY[k]
    img = PLANES["lenna128"]
    assert _half_res_taps(ds, rs, img.shape[1]) is not None
    dg = uniform_grid(128, 128, ds, ds // 2)
    cj = _jax_inputs(jnp.asarray(img), J.EncoderConfig(
        backend="jnp", source_size=ds, target_size=rs))[3]
    ct = t_codebook(torch.from_numpy(img).to(torch.float32), dg, rs, 4)
    assert_bitwise(cj.values, ct.values, "values")
    assert_bitwise(cj.sum, ct.sum, "sum")
    if k == 64:
        assert_bitwise(cj.sum_sq, ct.sum_sq, "sum_sq")
    else:
        exact = (np.round(np.asarray(ct.values, np.float64) * 4) ** 2).sum(-1) / 16
        assert_bitwise(exact.astype(np.float32), ct.sum_sq, "sum_sq")
        np.testing.assert_allclose(ct.sum_sq.numpy(), np.asarray(cj.sum_sq),
                                   rtol=5e-7, atol=0)


@pytest.mark.parametrize("pname", ["lenna128", "smooth128"])
@pytest.mark.parametrize("k", [64, 256])
def test_plain_k1_matches_pallas(k, pname):
    """The plain K1 at the quadtree's 8 and 16 px levels against
    fused_search_pairs (interpret mode) on the same layout (the JAX block
    sizes): (q, idx) of every sorted row bitwise at K = 64; at K = 256 (the
    JAX package's f32 branch) idx equal and q to Q_RTOL."""
    ds, rs = GEOMETRY[k]
    jcfg = J.EncoderConfig(backend="jnp", source_size=ds, target_size=rs)
    tcfg = T.EncoderConfig(source_size=ds, target_size=rs)
    img = PLANES[pname]
    _, _, (_, idx_j, q_j) = _jax_search(img, jcfg)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, block_r=DEFAULT_BR,
                         block_m=DEFAULT_BM)
    q_t, idx_t = tm.classed_kernel(pt, k, ds * ds, tcfg)
    assert_bitwise(idx_j, idx_t, "idx")
    if k == 64:
        assert_bitwise(q_j, q_t, "q")
    else:
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=Q_RTOL, atol=0)
