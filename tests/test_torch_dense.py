"""Port parity, the search without the classifier (``--noclassifier``): the
plain version of K3 (the dense search) against the JAX package's Pallas
kernel ``fused_search`` (interpret mode), the 'general' key, and the dense
search as a superset of the class-blocked one, on the CPU (the whole encode
and the quadtree: test_torch_dense_encode.py).

Two rules from ROADMAP.md's parity contract apply here:
  * K = 64 (8x8 ranges): the JAX codebook's SumB2 is XLA's f32 sum, which
    is not always the correctly rounded value the port uses (on lenna128 at
    16 -> 8, 9 of 1,800 columns).  Where a winner's column is one of them,
    its s, o and distance differ in the last bits (a key too, if it reads
    SumB2); everything else is bitwise.
  * K = 256 (the quadtree's 16 px level): the JAX package ranks in f32, the
    port in exact integers: winners equal, keys to Q_RTOL.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, lenna128, random_plane
from test_torch_matcher import _jax_inputs, _port_inputs
from test_torch_quadtree import PLANES as QT_PLANES
from test_torch_quadtree_search import Q_RTOL

import fractencode_tpu as J
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu.ops.matcher_pallas import fused_search
from fractencode_tpu_torch.bridge import config_from_jax_fields
from fractencode_tpu_torch.ops import matcher_kernels as mk

PLANES = {"lenna128": lenna128(), "rand64": random_plane(64, 1),
          "rand96": random_plane(96, 2),
          "rand96x64": np.random.default_rng(11).integers(0, 256, (96, 64), np.uint8)}


def _round_up(x, m):
    return -(-x // m) * m


def _jax_dense(img, jcfg, use_classes, **search_kw):
    """(q, idx) of JAX's K3 on one plane's search-order columns, padded and
    called as search_pallas does (the tail past m_valid included);
    ``search_kw`` (threshold, t_n) goes to fused_search."""
    ranges, sum_a, sum_a2, cb, rcls, dcls = _jax_inputs(jnp.asarray(img), jcfg)
    r, k = ranges.shape
    d, t, _ = cb.values.shape
    m = d * t
    mode = mk.rank_mode(jcfg.criterion, jcfg.so_mode, jcfg.s_max)
    aux = cb.inv_var_or_compute() if mode == "ls" else cb.sum_sq
    cols = [x[:, ::-1].reshape(m, *x.shape[2:]) for x in (cb.values, cb.sum, aux)]
    ccls = jnp.repeat(dcls, t) if use_classes else jnp.zeros((m,), jnp.int32)
    rcls = rcls if use_classes else jnp.zeros((r,), jnp.int32)
    block_r, block_m = min(512, _round_up(r, 8)), min(4096, _round_up(m, 128))
    assert m % block_m, "the m_valid tail must be exercised"
    rpad = lambda x, fill=0: jnp.pad(x, [(0, _round_up(r, block_r) - r)]
                                     + [(0, 0)] * (x.ndim - 1), constant_values=fill)
    cpad = lambda x, fill=0: jnp.pad(x, [(0, _round_up(m, block_m) - m)]
                                     + [(0, 0)] * (x.ndim - 1), constant_values=fill)
    _, idx, q = fused_search(
        rpad(ranges), rpad(sum_a), rpad(sum_a2), cpad(cols[0]), cpad(cols[1]),
        cpad(cols[2]), rpad(rcls, -3), cpad(ccls, -4), criterion=jcfg.criterion,
        so_mode=jcfg.so_mode, s_max=jcfg.s_max,
        inv_norm=1.0 / cb.grid.block_size ** 2 if jcfg.criterion == "raw" else 1.0 / k,
        use_classes=use_classes, m_valid=m, block_r=block_r, block_m=block_m,
        use_int8=k <= mk.INT8_MAX_K, interpret=True, **search_kw)
    return np.asarray(q)[:r], np.asarray(idx)[:r]


def _port_dense(img, tcfg, use_classes, **search_kw):
    """(q, idx) of the plain K3 on the same plane, from the port's own
    operands; ``search_kw`` (threshold, t_n) goes to search_dense_torch."""
    ranges, sum_a, sum_a2, cb, rcls, dcls = _port_inputs(img, tcfg)
    d, t, k = cb.values.shape
    ai, ch, cl, _ = tm._int8_operands(ranges, cb)
    mode = mk.rank_mode(tcfg.criterion, tcfg.so_mode, tcfg.s_max)
    aux = cb.inv_var if mode == "ls" else cb.sum_sq
    return mk.search_dense_torch(
        ai, ch, cl, cb.sum.flip(1).reshape(-1), aux.flip(1).reshape(-1),
        m_valid=d * t, criterion=tcfg.criterion, so_mode=tcfg.so_mode,
        s_max=tcfg.s_max,
        inv_norm=1.0 / cb.grid.block_size ** 2 if tcfg.criterion == "raw" else 1.0 / k,
        sa=sum_a, sa2=sum_a2,
        rcls=rcls.to(torch.int32) if use_classes else None,
        ccls=torch.repeat_interleave(dcls.to(torch.int32), t) if use_classes else None,
        **search_kw)


# (key, num_transforms, target_size): K = 16 with 4 and 8 isometries, and
# config 1's K = 64 with 8
KEY_CASES = [("ls", 4, 4), ("raw", 4, 4), ("ls", 8, 4), ("raw", 8, 4),
             ("ls", 8, 8), ("raw", 8, 8)]


@pytest.mark.parametrize("use_classes", [False, True])
@pytest.mark.parametrize("case", KEY_CASES, ids=lambda c: f"{c[0]}-t{c[1]}-ts{c[2]}")
@pytest.mark.parametrize("pname", ["rand64", "rand96x64"])
def test_plain_dense_matches_fused_search(pname, case, use_classes):
    """The plain K3's (q, idx) of every row bitwise against fused_search
    (interpret mode), with and without the per-element class mask, M not a
    multiple of the JAX block_m (so its m_valid tail is masked)."""
    key, t_n, ts = case
    kw = dict(num_transforms=t_n, target_size=ts)
    jcfg = (J.REFERENCE_COMPAT(backend="jnp", **kw) if key == "raw"
            else J.EncoderConfig(backend="jnp", **kw))
    img = PLANES[pname]
    q_j, idx_j = _jax_dense(img, jcfg, use_classes)
    q_t, idx_t = _port_dense(img, config_from_jax_fields(jcfg), use_classes)
    assert_bitwise(q_j, q_t, "q")
    assert_bitwise(idx_j, idx_t, "idx")


@pytest.mark.parametrize("use_classes", [False, True])
def test_plain_dense_k256_matches_fused_search(use_classes):
    """'ls' at K = 256 (the quadtree's 16 px level, 64 -> 16): the JAX
    package's f32 branch against the port's exact integers: idx equal, q to
    Q_RTOL."""
    jcfg = J.EncoderConfig(backend="jnp", source_size=64, target_size=16)
    img = QT_PLANES["lenna128"]
    q_j, idx_j = _jax_dense(img, jcfg, use_classes)
    q_t, idx_t = _port_dense(img, config_from_jax_fields(jcfg), use_classes)
    assert_bitwise(idx_j, idx_t, "idx")
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=Q_RTOL, atol=0)


@pytest.mark.parametrize("cfg_kw", [dict(s_max=1.0), dict(so_mode="reference")])
def test_general_rank_mode(cfg_kw):
    """The 'general' key without the classifier: the rule of
    test_torch_matcher.py::test_general_rank_mode (winners >= 99%,
    distances to 1e-3), every range valid."""
    img = lenna128()
    rj = J.encode_plane(img, J.EncoderConfig(backend="jnp", use_classifier=False, **cfg_kw))
    rt = T.encode_plane(img, T.EncoderConfig(use_classifier=False, **cfg_kw), device="cpu")
    same = (np.asarray(rj.domain_idx) == rt.domain_idx.numpy()) & \
        (np.asarray(rj.transform) == rt.transform.numpy())
    assert same.mean() > 0.99 and rt.valid.all()
    np.testing.assert_allclose(rt.distance.numpy(), np.asarray(rj.distance),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("pname", ["rand64", "rand96", "lenna128"])
def test_dense_keys_dominate_classed(pname):
    """The dense search sees a superset of the class-blocked search's
    columns, so under the 'ls' key every range's best key is at least the
    classed one, and equal where the dense winner shares the range's
    class."""
    cfg = T.EncoderConfig()
    ranges, sum_a, sum_a2, cb, rcls, dcls = _port_inputs(PLANES[pname], cfg)
    dense = tm.search_dense(ranges, sum_a, sum_a2, cb, None, None, cfg)
    classed = tm.search_classed(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg)
    qd, qc = dense.key.numpy(), classed.key.numpy()
    assert (qd >= qc).all()
    same_class = (dcls[dense.domain_idx.long()] == rcls).numpy()
    assert_bitwise(qd[same_class], qc[same_class], "key")
    assert (qd > qc).any(), "vacuous: the classifier pruned no winner"
    # the class-masked dense search is the class-blocked one
    masked = tm.search_dense(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg)
    for f in ("domain_idx", "transform", "distance", "s", "o", "valid", "key"):
        assert_bitwise(getattr(masked, f), getattr(classed, f), f)


def test_dense_refusals():
    """32x32 ranges (n = 1024, the K-slab form) without the classifier run
    as the JAX package's do (its oracle; winners exactly, the rest to
    test_torch_range_sizes.py's n > 256 tolerances); backend 'cuda' with CPU
    tensors still raises (no fallback), and CPU tensors launch no kernel."""
    from test_torch_range_sizes import assert_results, jax_general_sampling

    img = random_plane(128)
    kw = dict(use_classifier=False, source_size=64, target_size=32)
    with jax_general_sampling():
        rj = J.encode_plane(img, J.REFERENCE_COMPAT(**kw))
    rt = T.encode_plane(img, T.REFERENCE_COMPAT(**kw), device="cpu")
    assert_results(1024, "raw", rj, rt)
    with pytest.raises(ValueError, match="CUDA"):
        T.encode_plane(img, T.EncoderConfig(use_classifier=False, backend="cuda"),
                       device="cpu")
    before = dict(mk.search_dense_cuda.launches)
    T.encode_plane(img, T.EncoderConfig(use_classifier=False), device="cpu")
    assert mk.search_dense_cuda.launches == before  # CPU tensors: no launch
