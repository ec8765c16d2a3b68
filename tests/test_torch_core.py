"""Port parity, image substrate: block sums, quadrant sums, classes, metrics,
codebook and range blocks, bitwise against the JAX package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, planes

import fractencode_tpu.core.classify as jcls
import fractencode_tpu.core.metrics as jmet
import fractencode_tpu.core.stats as jst
import fractencode_tpu.encode.codebook as jcb
import fractencode_tpu_torch.core.classify as tcls
import fractencode_tpu_torch.core.metrics as tmet
import fractencode_tpu_torch.core.stats as tst
import fractencode_tpu_torch.encode.codebook as tcb
from fractencode_tpu_torch.core.grid import uniform_grid

PLANES = planes()
# (block, step): the default range and domain grids, a quadtree-like level,
# and two grids whose step is no multiple of the half block, which take the
# integral-image path of quadrant_sums
GRIDS = [(4, 4), (16, 8), (8, 8), (6, 4), (10, 3)]


@pytest.mark.parametrize("name", sorted(PLANES))
def test_integral_and_block_sums(name):
    p = PLANES[name]
    pt = torch.from_numpy(p)
    assert_bitwise(jst.integral_image(jnp.asarray(p)), tst.integral_image(pt), "ii")
    for b in (2, 4, 8):
        assert_bitwise(jst.block_sums_nonoverlapping(jnp.asarray(p), b),
                       tst.block_sums_nonoverlapping(pt, b), f"block {b}")
    for block, step in GRIDS:
        g = uniform_grid(p.shape[1], p.shape[0], block, step)
        assert_bitwise(jst.grid_block_sums(jnp.asarray(p), g),
                       tst.grid_block_sums(pt, g), f"grid {block}/{step}")


@pytest.mark.parametrize("name", sorted(PLANES))
@pytest.mark.parametrize("block,step", GRIDS)
def test_quadrant_sums_and_classes(name, block, step):
    p = PLANES[name]
    pt = torch.from_numpy(p)
    g = uniform_grid(p.shape[1], p.shape[0], block, step)
    s2_j = jst.block_sums_nonoverlapping(jnp.asarray(p), 2)
    s2_t = tst.block_sums_nonoverlapping(pt, 2)
    for s2j, s2t in ((None, None), (s2_j, s2_t)):
        assert_bitwise(jst.quadrant_sums(jnp.asarray(p), g, sums2x2=s2j),
                       tst.quadrant_sums(pt, g, sums2x2=s2t), "quadrants")
        assert_bitwise(jcls.classify_grid(jnp.asarray(p), g, sums2x2=s2j),
                       tcls.classify_grid(pt, g, sums2x2=s2t), "classes")


def test_order_code_table_and_float_quadrants():
    assert_bitwise(jcls._order_code_table(), tcls._order_code_table(), "table")
    q = np.random.default_rng(5).integers(0, 6, size=(4096, 4)).astype(np.float32)
    assert_bitwise(jcls.classify_from_quadrants(jnp.asarray(q)),
                   tcls.classify_from_quadrants(torch.from_numpy(q)), "f32 quads")


@pytest.mark.parametrize("name", sorted(PLANES))
def test_metrics(name):
    """plane_mse is exact in the port (int64 sum); the JAX package's hi/lo
    f32 recombination rounds twice, so the two agree to f32 precision."""
    a = PLANES[name]
    b = np.roll(a, 3, axis=1)
    mj = float(jmet.plane_mse(jnp.asarray(a), jnp.asarray(b)))
    mt = float(tmet.plane_mse(torch.from_numpy(a), torch.from_numpy(b)))
    exact = float(((a.astype(np.int64) - b) ** 2).sum()) / a.size
    assert mt == pytest.approx(exact, rel=1e-7)
    assert mt == pytest.approx(mj, rel=2e-7)
    pj = float(jmet.psnr(jnp.asarray(a), jnp.asarray(b)))
    pt = float(tmet.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    assert pt == pytest.approx(pj, abs=1e-4)
    assert float(tmet.psnr(torch.from_numpy(a), torch.from_numpy(a))) == \
        pytest.approx(float(jmet.psnr(jnp.asarray(a), jnp.asarray(a))))


@pytest.mark.parametrize("name", sorted(PLANES))
@pytest.mark.parametrize("geom", [
    (16, 4, 8, 4),   # default: the half-image fast path
    (16, 4, 8, 8),   # all 8 isometries
    (8, 4, 4, 4),    # quadtree-like level, fast path
    (12, 4, 6, 4),   # odd tap cells: the general 4-tap path
    (16, 4, 5, 4),   # odd domain step: the general 4-tap path
])
def test_codebook_and_ranges(name, geom):
    source, target, step, t_n = geom
    p = PLANES[name]
    pj = jnp.asarray(p, jnp.float32)
    pt = torch.from_numpy(p).to(torch.float32)
    g = uniform_grid(p.shape[1], p.shape[0], source, step)
    # jitted: eagerly, its 64 strided slices would each compile on their own
    cj = jax.jit(jcb.build_codebook, static_argnums=(1, 2, 3))(pj, g, target, t_n)
    ct = tcb.build_codebook(pt, g, target, t_n)
    for f in ("values", "sum", "sum_sq", "inv_var"):
        assert_bitwise(getattr(cj, f), getattr(ct, f), f)
    assert_bitwise(jcb.extract_ranges(pj, target), tcb.extract_ranges(pt, target),
                   "ranges")
