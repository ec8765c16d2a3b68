"""Port parity at every range size, the operands: the plain K1 and K3 on
padded operands (zero past n, K = 16, 64, 256 or a multiple of 256) against
the same searches on unpadded ones; the operand widths and the bound of the
K-slab form; its integers at n = 4096 against Python integers; and the JAX
package's two codebook sampling paths, one of which the JAX side of the
range-size tests takes (test_torch_range_sizes.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, lenna128
from test_torch_range_sizes import GEOMETRY, KEYS, jax_general_sampling, jcfg, port_args

import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu.core.grid import uniform_grid as j_grid
from fractencode_tpu.encode.codebook import build_codebook as j_codebook
from fractencode_tpu_torch.bridge import config_from_jax_fields
from fractencode_tpu_torch.core.grid import uniform_grid
from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges, range_sums
from fractencode_tpu_torch.ops import matcher_kernels as mk


def test_jax_sampling_paths_agree():
    """The JAX package's general sampling path, which the JAX side of these
    tests takes, gives its strided-slice path's codebook bitwise (16 px
    ranges on lenna128)."""
    img = jnp.asarray(lenna128()).astype(jnp.float32)
    grid = j_grid(128, 128, 32, 16)
    build = lambda: jax.jit(lambda p: j_codebook(p, grid, 16, 4))(img)
    fast = build()
    with jax_general_sampling():
        general = build()
    for f in ("values", "sum", "sum_sq", "inv_var"):
        assert_bitwise(np.asarray(getattr(fast, f)), np.asarray(getattr(general, f)), f)


def _unpadded(x, n):
    return x[:, :n].contiguous()


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", [4, 9, 36, 100, 400])
def test_padded_operands_match_unpadded(n, key, frontier):
    """The plain K1 and K3 on the padded operands (zero past n, as the
    kernels take them) give the (q, idx) of the same search on operands of
    width n, bitwise."""
    tcfg = config_from_jax_fields(jcfg(key, n, frontier))
    args = port_args(n)
    area = GEOMETRY[n][0] ** 2
    prep = tm.classed_prep(*args, tcfg)
    assert prep["ai_s"].shape[1] == mk.kernel_width(n) > n
    for x in ("ai_s", "ch_s", "cl_s"):
        assert not prep[x][:, n:].any(), f"{x}: nonzero past n"
    layout = [prep[x] for x in ("sb_s", "aux_s", "tile_class", "col_tile_start",
                                "col_end", "row_end")]
    kw = dict(block_r=prep["block_r"], block_m=prep["block_m"], criterion=tcfg.criterion,
              so_mode=tcfg.so_mode, s_max=tcfg.s_max, inv_norm=tm.inv_norm(tcfg, n, area),
              sa_s=prep["sa_s"], sa2_s=prep["sa2_s"], threshold=tcfg.rms_threshold,
              t_n=tcfg.num_transforms)
    padded = mk.search_classed_torch(prep["ai_s"], prep["ch_s"], prep["cl_s"], *layout,
                                     n=n, **kw)
    narrow = mk.search_classed_torch(*(_unpadded(prep[x], n) for x in ("ai_s", "ch_s", "cl_s")),
                                     *layout, **kw)
    for a, b, what in zip(padded, narrow, ("q", "idx")):
        assert_bitwise(a, b, f"K1 {what}")
    dense = tm.dense_prep(*args[:4], None, None, tcfg)
    kw = dict(m_valid=dense["ch"].shape[0], criterion=tcfg.criterion, so_mode=tcfg.so_mode,
              s_max=tcfg.s_max, inv_norm=tm.inv_norm(tcfg, n, area), sa=dense["sa"],
              sa2=dense["sa2"], threshold=tcfg.rms_threshold, t_n=tcfg.num_transforms)
    cols = [dense[x] for x in ("sb", "aux")]
    padded = mk.search_dense_torch(dense["ai"], dense["ch"], dense["cl"], *cols, n=n, **kw)
    narrow = mk.search_dense_torch(*(_unpadded(dense[x], n) for x in ("ai", "ch", "cl")),
                                   *cols, **kw)
    for a, b, what in zip(padded, narrow, ("q", "idx")):
        assert_bitwise(a, b, f"K3 {what}")


def test_operand_widths():
    """K for every n: 16, 64, 256, then multiples of 256; the instance of
    each; and the bound of the K-slab form's int32 sums, named."""
    assert [mk.kernel_width(n) for n in (1, 4, 16, 17, 36, 64, 65, 100, 256, 257, 1024,
                                         4096, 132104)] == \
        [16, 16, 16, 64, 64, 64, 256, 256, 256, 512, 1024, 4096, 132352]
    assert [mk.instance_width(n, mk.kernel_width(n)) for n in (4, 16, 36, 64, 100, 256, 289)] \
        == ["16p", 16, "64p", 64, "256p", 256, "_slab"]
    with pytest.raises(ValueError, match="132104"):
        mk.kernel_width(132105)
    with pytest.raises(ValueError, match="kernels take 64"):
        mk.instance_width(36, 256)
    assert mk.sum_dtype(256) == torch.float32 and mk.sum_dtype(257) == torch.float64


def _stripes(size: int) -> np.ndarray:
    """Extreme values only: the top half 255, the bottom half 4 px vertical
    stripes of 0 and 255 (2 px stripes in the 2x2-averaged codebook)."""
    img = np.full((size, size), 255, np.uint8)
    img[size // 2:, (np.arange(size) // 4) % 2 == 1] = 0
    return img


def test_slab_integers_are_exact():
    """n = 4096 (64 px ranges, 128 px domains) on extreme planes: SumA and
    SumA2 (above 2^24), 4 SumB, 16 SumB2 (above 2^31), and each winner's
    'raw' key from 16q = 8 (4 SumAB) - 16 SumB2 (above 2^31), 'ls' key
    from cov4 and inv_var_b, and 'ls' distance from var_a = n SumA2 - SumA^2
    (above 2^32), equal the values formed from Python integers with one
    rounding each."""
    n, size = 4096, 256
    img = _stripes(size)
    p = torch.from_numpy(img)
    cb = build_codebook(p.to(torch.float32), uniform_grid(size, size, 128, 64), 64, 4)
    ranges = extract_ranges(p.to(torch.float32), 64)
    sa, sa2 = range_sums(ranges)
    a_int = [[int(v) for v in row] for row in ranges.to(torch.int64).tolist()]
    assert sa.dtype == torch.float64 and cb.sum.dtype == torch.float64
    assert [int(v) for v in sa.tolist()] == [sum(r) for r in a_int]
    assert [int(v) for v in sa2.tolist()] == [sum(v * v for v in r) for r in a_int]
    assert max(sa2.tolist()) > 2 ** 24
    b4 = [[int(v) for v in col] for col in
          torch.round(cb.values.flip(1).reshape(-1, n) * 4).to(torch.int64).tolist()]
    sb4 = [sum(c) for c in b4]
    sb2_16 = [sum(v * v for v in c) for c in b4]
    assert max(sb2_16) > 2 ** 31
    sb, sb2 = tm._column_sums(torch.tensor(b4, dtype=torch.int32), "raw", n)
    assert [int(4 * v) for v in sb.tolist()] == sb4
    assert [int(16 * v) for v in sb2.tolist()] == sb2_16
    for key in ("raw", "ls"):
        tcfg = config_from_jax_fields(KEYS[key](source_size=128, target_size=64,
                                                use_classifier=False))
        res = tm.search_dense(ranges, sa, sa2, cb, None, None, tcfg)
        m = (res.domain_idx * 4 + 3 - res.transform).tolist()
        for r, (row, j) in enumerate(zip(a_int, m)):
            ab4 = sum(x * y for x, y in zip(row, b4[j]))  # 4 SumAB
            if key == "raw":
                q16 = 8 * ab4 - sb2_16[j]
                assert abs(q16) > 2 ** 31 or q16 == 0
                assert res.key[r].item() == float(np.float32(float(q16))) / 16
            else:
                cov4 = n * ab4 - sum(row) * sb4[j]
                var16 = n * sb2_16[j] - sb4[j] ** 2
                inv = np.float32(0.0) if var16 == 0 else \
                    np.float32(1.0) / np.float32(float(var16) / 16)
                c = np.float32(float(cov4))
                q = (c * c) * (inv * np.float32(0.0625))
                assert res.key[r].item() == float(q)
                var_a = n * sum(v * v for v in row) - sum(row) ** 2
                dist = max(np.float32(float(var_a)) - q, np.float32(0.0)) * \
                    np.float32(1.0 / n / n)
                assert res.distance[r].item() == float(np.float32(dist))
