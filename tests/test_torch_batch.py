"""Port parity, batch forms: ``encode_batch_stacked``, ``encode_batch``,
``decode_batch_stacked`` and the quadtree's ``encode_batch_quadtree_stacked``
and ``encode_batch_quadtree``, against the JAX package's (its jnp oracle on
the CPU, whose frames stream through ``lax.map``) and against the port's
single-plane functions frame by frame, bitwise.  Mirrors the JAX package's
tests/test_roundtrip.py (batch encode and decode) and
tests/test_quadtree.py (batch quadtree).

The quadtree's 16 px level (K = 256) follows the parity contract's
tolerances against the JAX package (test_torch_quadtree.py); every other
level, and every frame against the port's own single-plane encode, is
bitwise.  One JAX compile per form and config serves the whole file.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, lenna128

import fractencode_tpu as J
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import (ARRAY_FIELDS, META_FIELDS, quadtree_from_numpy,
                                          quadtree_to_numpy, result_from_numpy,
                                          result_to_numpy)

LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")
# K = 256 (the 16 px level): test_torch_quadtree.py's tolerances
K256_TOL = dict(s=(5e-5, 1e-5), o=(5e-5, 1e-5), error=(1.2e-4, 1e-4))

CONFIGS = {"default": {}, "noclassifier": dict(use_classifier=False)}


def _frames(b: int = 3, n: int = 64) -> np.ndarray:
    """b distinct [n, n] frames: crops of the Lenna plane and seeded noise,
    no two alike (a repeated frame would hide a cross-frame fault)."""
    img = lenna128()
    rng = np.random.default_rng(11)
    crops = [img[:n, :n], img[n:2 * n, n:2 * n][::-1].copy()]
    while len(crops) < b:
        crops.append(rng.integers(0, 256, (n, n), dtype=np.uint8))
    return np.stack(crops[:b])


@functools.lru_cache(maxsize=None)
def _jax_stacked(config: str):
    return J.encode_batch_stacked(jnp.asarray(_frames()),
                                  J.EncoderConfig(backend="jnp", **CONFIGS[config]))


@functools.lru_cache(maxsize=None)
def _port_stacked(config: str):
    return T.encode_batch_stacked(_frames(), T.EncoderConfig(**CONFIGS[config]),
                                  device="cpu")


def _frame(stacked, i):
    return dataclasses.replace(stacked, **{f: getattr(stacked, f)[i] for f in ARRAY_FIELDS})


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encode_batch_stacked_matches_jax(config):
    rj, rt = _jax_stacked(config), _port_stacked(config)
    assert rt.domain_idx.shape == (3, 256)
    for f in ARRAY_FIELDS:
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f)
    for f in META_FIELDS:
        assert getattr(rj, f) == getattr(rt, f), f


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encode_batch_frames_equal_single_plane(config):
    """Every frame of the stacked and the listed form equals encode_plane on
    that frame, bitwise."""
    cfg = T.EncoderConfig(**CONFIGS[config])
    stacked = _port_stacked(config)
    listed = T.encode_batch(_frames(), cfg, device="cpu")
    assert len(listed) == 3
    for i, plane in enumerate(_frames()):
        single = T.encode_plane(plane, cfg, device="cpu")
        for f in ARRAY_FIELDS:
            assert_bitwise(getattr(stacked, f)[i], getattr(single, f), f"frame {i} {f}")
            assert_bitwise(getattr(listed[i], f), getattr(single, f), f"listed {i} {f}")
        assert dataclasses.replace(listed[i], **{f: None for f in ARRAY_FIELDS}) == \
            dataclasses.replace(single, **{f: None for f in ARRAY_FIELDS})


def test_encode_batch_takes_a_tensor_on_its_device():
    planes = torch.from_numpy(_frames())
    res = T.encode_batch_stacked(planes, T.EncoderConfig())
    assert res.s.device.type == "cpu"
    assert_bitwise(res.domain_idx, _port_stacked("default").domain_idx)


@pytest.mark.parametrize("pyramid", [False, True], ids=["flat", "pyramid"])
def test_decode_batch_stacked_matches_jax_and_single(pyramid):
    """Pixels, iterations and MSE per frame: equal to the JAX package's
    batch decode of its own stacked encode, and to the port's decode_plane
    on each frame (with distance zeroed, as the batch form does)."""
    dj = J.DecoderConfig(pyramid=pyramid)
    dt = T.DecoderConfig(pyramid=pyramid)
    outs_j, iters_j, mses_j = J.decode_batch_stacked(_jax_stacked("default"), dj)
    stacked = _port_stacked("default")
    outs, iters, mses = T.decode_batch_stacked(stacked, dt)
    assert outs.shape == (3, 64, 64) and outs.dtype == torch.uint8
    assert iters.dtype == torch.int32 and mses.dtype == torch.float32
    assert_bitwise(np.asarray(outs_j), outs, "pixels")
    assert_bitwise(np.asarray(iters_j), iters, "iterations")
    assert_bitwise(np.asarray(mses_j), mses, "mse")
    for i in range(3):
        out, it, mse = T.decode_plane(_frame(stacked, i), dt)
        assert_bitwise(outs[i], out, f"frame {i} pixels")
        assert int(iters[i]) == it and float(mses[i]) == mse


def test_stacked_results_cross_the_bridge():
    """A JAX stacked result moves into the port through bridge.py and back:
    the port's batch decode of it equals the JAX package's, and its arrays
    come back unchanged."""
    rj = _jax_stacked("default")
    arrays = {f: np.asarray(getattr(rj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(rj, f) for f in META_FIELDS}
    rt = result_from_numpy(arrays, meta, "cpu")
    back, meta_back = result_to_numpy(rt)
    for f in ARRAY_FIELDS:
        assert_bitwise(arrays[f], back[f], f)
    assert meta_back == meta
    dcfg = dict(pyramid=True)
    outs_j, iters_j, _ = J.decode_batch_stacked(rj, J.DecoderConfig(**dcfg))
    outs_t, iters_t, _ = T.decode_batch_stacked(rt, T.DecoderConfig(**dcfg))
    assert_bitwise(np.asarray(outs_j), outs_t, "pixels")
    assert_bitwise(np.asarray(iters_j), iters_t, "iterations")


QCFG = dict(min_size=4, max_size=16)


@functools.lru_cache(maxsize=None)
def _jax_quadtree():
    return jq.encode_batch_quadtree_stacked(
        jnp.asarray(_frames(2)), J.EncoderConfig(backend="jnp"), jq.QuadtreeConfig(**QCFG))


@functools.lru_cache(maxsize=None)
def _port_quadtree():
    return tq.encode_batch_quadtree_stacked(_frames(2), T.EncoderConfig(),
                                            tq.QuadtreeConfig(**QCFG), device="cpu")


def _assert_level_close(lj, lt, what):
    """A JAX and a port level: bitwise but at K = 256, which is held to the
    parity contract's tolerances (winners and leaves exactly)."""
    for f in LEVEL_FIELDS:
        a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
        if lt.range_size == 16 and f in K256_TOL:
            rtol, atol = K256_TOL[f]
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{what} {f}")
        else:
            assert_bitwise(a, b, f"{what} {f}")


def test_encode_batch_quadtree_stacked_matches_jax():
    qj, qt = _jax_quadtree(), _port_quadtree()
    assert (qt.width, qt.height) == (qj.width, qj.height) == (64, 64)
    assert [l.range_size for l in qt.levels] == [16, 8, 4]
    for lj, lt in zip(qj.levels, qt.levels, strict=True):
        assert lt.domain_idx.shape[0] == 2
        for f in ("range_size", "domain_size", "domain_step", "num_transforms"):
            assert getattr(lj, f) == getattr(lt, f), f
        _assert_level_close(lj, lt, f"{lt.range_size} px")


def test_encode_batch_quadtree_frames_equal_single_plane():
    """Every level of every frame, stacked and listed, equals
    encode_plane_quadtree on that frame, bitwise; and so do the decodes."""
    cfg, qcfg = T.EncoderConfig(), tq.QuadtreeConfig(**QCFG)
    stacked = _port_quadtree()
    listed = tq.encode_batch_quadtree(_frames(2), cfg, qcfg, device="cpu")
    for i, plane in enumerate(_frames(2)):
        single = tq.encode_plane_quadtree(plane, cfg, qcfg, device="cpu")
        for ls, ll, l1 in zip(stacked.levels, listed[i].levels, single.levels, strict=True):
            for f in LEVEL_FIELDS:
                assert_bitwise(getattr(ls, f)[i], getattr(l1, f), f"frame {i} {f}")
                assert_bitwise(getattr(ll, f), getattr(l1, f), f"listed {i} {f}")
            assert dataclasses.replace(ll, **{f: None for f in LEVEL_FIELDS}) == \
                dataclasses.replace(l1, **{f: None for f in LEVEL_FIELDS})
        out_l, it_l, _ = tq.decode_plane_quadtree(listed[i])
        out_1, it_1, _ = tq.decode_plane_quadtree(single)
        assert_bitwise(out_l, out_1, f"frame {i} decode")
        assert it_l == it_1


def test_stacked_quadtree_crosses_the_bridge():
    """The JAX stacked quadtree result moves into the port and back; each
    frame of it decodes in the port as in the JAX package."""
    qj = _jax_quadtree()
    levels = [({f: np.asarray(getattr(l, f)) for f in LEVEL_FIELDS},
               {f: getattr(l, f) for f in ("range_size", "domain_size", "domain_step",
                                           "o_is_mean", "num_transforms")})
              for l in qj.levels]
    qt = quadtree_from_numpy(levels, qj.width, qj.height, "cpu")
    back, w, h = quadtree_to_numpy(qt)
    assert (w, h) == (qj.width, qj.height)
    for (arrays, meta), (arrays_b, meta_b) in zip(levels, back, strict=True):
        assert meta == meta_b
        for f in LEVEL_FIELDS:
            assert_bitwise(arrays[f], arrays_b[f], f)
    for i in range(2):
        fj = jq.QuadtreeResult(levels=[dataclasses.replace(
            l, **{f: getattr(l, f)[i] for f in LEVEL_FIELDS}) for l in qj.levels],
            width=qj.width, height=qj.height)
        ft = tq.QuadtreeResult(levels=[dataclasses.replace(
            l, **{f: getattr(l, f)[i] for f in LEVEL_FIELDS}) for l in qt.levels],
            width=qt.width, height=qt.height)
        out_j, it_j, _ = jq.decode_plane_quadtree(fj, J.DecoderConfig())
        out_t, it_t, _ = tq.decode_plane_quadtree(ft, T.DecoderConfig())
        assert_bitwise(np.asarray(out_j), out_t, f"frame {i} pixels")
        assert int(it_j) == it_t


def test_batch_quadtree_alignment_check():
    with pytest.raises(ValueError, match="coarsest range size"):
        tq.encode_batch_quadtree_stacked(np.zeros((2, 40, 40), np.uint8), device="cpu")


def test_batch_names_are_exported():
    from fractencode_tpu_torch import (decode_batch_stacked, encode_batch,  # noqa: F401
                                       encode_batch_stacked)

    for name in ("encode_batch", "encode_batch_stacked", "decode_batch_stacked"):
        assert name in T.__all__ and name in J.__all__
    for name in ("encode_batch_quadtree", "encode_batch_quadtree_stacked"):
        assert name in tq.__all__ and callable(getattr(tq, name))


def test_batch_forms_need_a_card_for_numpy():
    """A numpy batch with no device goes to the card, as encode_plane's
    plane does; with none, the batch forms raise rather than run on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for encode in (T.encode_batch_stacked, T.encode_batch,
                   tq.encode_batch_quadtree_stacked, tq.encode_batch_quadtree):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            encode(_frames(2))
