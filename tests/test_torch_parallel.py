"""Port parity, sharding: ``fractencode_tpu_torch.parallel`` against the JAX
package's sharded functions (run on conftest's 8 virtual CPU devices), and
against the port's single-device ``encode_plane`` on the wider matrix of
tests/test_parallel.py.  The port's meshes repeat ``torch.device("cpu")``.

Against the JAX package, every field bitwise: ``encode_batch_sharded`` for
each strategy on a (2, 4) mesh, with the classifier, with it and
``rms_threshold`` 60, and without it under the threshold (``JAX_CONFIGS``);
``encode_plane_sharded_image`` on a 128x64 plane for each codebook mode,
with and without the classifier; ``decode_batch_sharded`` flat and
pyramid.  Each JAX call runs once per file (``functools.lru_cache``).
"""
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise

import fractencode_tpu as J
from fractencode_tpu.parallel import decode_batch_sharded as j_decode_batch_sharded
from fractencode_tpu.parallel import encode_batch_sharded as j_encode_batch_sharded
from fractencode_tpu.parallel import make_mesh as j_make_mesh
from fractencode_tpu.parallel.sharded import encode_plane_sharded_image as j_encode_image

import fractencode_tpu_torch as T
from fractencode_tpu_torch.parallel import (STRATEGIES, decode_batch_sharded,
                                            encode_batch_sharded,
                                            encode_plane_sharded_image, make_mesh)

CPU = torch.device("cpu")
FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid")
THR = 60.0
# the JAX comparisons' configs: (EncoderConfig overrides, the frames); the
# threshold runs on smooth frames, where ranges meet it
JAX_CONFIGS = {"default": ({}, "noise"),
               "rms": (dict(rms_threshold=THR), "smooth"),
               "nocls_rms": (dict(use_classifier=False, rms_threshold=THR), "smooth")}


def _mesh(n_data: int, n_search: int):
    return make_mesh(n_data, n_search, devices=[CPU] * (n_data * n_search))


def _noise(b=2, n=64, seed=1234):
    return np.random.default_rng(seed).integers(0, 256, size=(b, n, n), dtype=np.uint8)


def _smooth(b=2, n=64, seed=1234):
    """Low-pass frames (a 5x5 box mean of noise), as tests/test_parallel.py
    makes them, so that the threshold's early accepts trigger."""
    from numpy.lib.stride_tricks import sliding_window_view

    base = np.random.default_rng(seed).integers(0, 256, size=(b, n, n)).astype(np.float32)
    out = [sliding_window_view(np.pad(x, 2, mode="edge"), (5, 5)).reshape(n, n, 25).mean(2)
           for x in base]
    return np.stack(out).astype(np.uint8)


FRAMES = {"noise": _noise, "smooth": _smooth}


def _assert_result(rj, rt, what):
    for f in FIELDS:
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f"{what} {f}")


def _assert_same(ra, rb, what):
    for f in FIELDS:
        assert_bitwise(getattr(ra, f), getattr(rb, f), f"{what} {f}")


@functools.lru_cache(maxsize=None)
def _jax_batch(strategy: str, config: str):
    kw, frames = JAX_CONFIGS[config]
    return j_encode_batch_sharded(FRAMES[frames](), J.EncoderConfig(**kw), j_make_mesh(2, 4),
                                  strategy=strategy)


def _tall(config: str):
    kw, frames = JAX_CONFIGS[config]
    return (FRAMES[frames](1, 128, seed=99)[0, :, :64] if frames == "smooth"
            else _noise(1, 128, seed=99)[0, :, :64])


@functools.lru_cache(maxsize=None)
def _jax_image(codebook: str, config: str):
    import jax

    mesh = j_make_mesh(1, 4, devices=jax.devices()[:4])
    return j_encode_image(_tall(config), J.EncoderConfig(**JAX_CONFIGS[config][0]), mesh,
                          codebook=codebook)


@pytest.mark.parametrize("config", sorted(JAX_CONFIGS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_encode_batch_sharded_matches_jax(strategy, config):
    kw, frames = JAX_CONFIGS[config]
    rt = encode_batch_sharded(FRAMES[frames](), T.EncoderConfig(**kw), _mesh(2, 4), strategy)
    rj = _jax_batch(strategy, config)
    assert len(rt) == len(rj) == 2
    for i in range(2):
        assert rt[i].s.device == CPU
        _assert_result(rj[i], rt[i], f"{strategy} {config} frame {i}")
    if "rms" in config:  # not vacuous: some ranges meet the threshold
        assert int((rt[0].distance <= THR).sum()) > 0


@pytest.mark.parametrize("config", ["default", "nocls_rms"])
@pytest.mark.parametrize("codebook", ["replicate", "ring"])
def test_encode_plane_sharded_image_matches_jax(codebook, config):
    rt = encode_plane_sharded_image(_tall(config), T.EncoderConfig(**JAX_CONFIGS[config][0]),
                                    _mesh(1, 4), codebook=codebook)
    _assert_result(_jax_image(codebook, config), rt, f"{codebook} {config}")


@functools.lru_cache(maxsize=None)
def _port_ranges():
    return encode_batch_sharded(_noise(), T.EncoderConfig(), _mesh(2, 4))


@pytest.mark.parametrize("pyramid", [False, True], ids=["flat", "pyramid"])
def test_decode_batch_sharded_matches_jax(pyramid):
    """Pixels, iterations (every step run, as the JAX package's sharded
    decode counts them) and the final MSE, bitwise."""
    oj, ij, mj = j_decode_batch_sharded(_jax_batch("ranges", "default"), j_make_mesh(2, 4),
                                        pyramid=pyramid)
    ot, it, mt = decode_batch_sharded(_port_ranges(), _mesh(2, 4), pyramid=pyramid)
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert_bitwise(np.asarray(ij), it, "iterations")
    assert_bitwise(np.asarray(mj), mt, "mse")


# ---------------------------------------------------------------------------
# the wider matrix, against the port's single-device encode (which the other
# test_torch_*.py files hold to the JAX package)


def _single(img, cfg):
    return T.encode_plane(img, cfg, device="cpu")


@pytest.mark.parametrize("strategy", ["domains", "ring"])
def test_sharded_encode_flat_blocks_tiebreak(strategy):
    """Flat ranges tie at distance 0 against many domains (the 'ls' key
    clamps); the cross-shard reducers compare the rank key, so they keep the
    single-device winner bitwise."""
    img = np.random.default_rng(7).integers(0, 256, size=(64, 64), dtype=np.uint8)
    img[:16, :] = 128
    imgs = np.stack([img, img[::-1]])
    cfg = T.EncoderConfig()
    for i, res in enumerate(encode_batch_sharded(imgs, cfg, _mesh(2, 4), strategy)):
        _assert_same(res, _single(imgs[i], cfg), f"{strategy} frame {i}")


@pytest.mark.parametrize("strategy", ["domains", "ring"])
def test_sharded_encode_noclassifier(strategy):
    cfg = T.EncoderConfig(use_classifier=False)
    imgs = _noise(seed=5)
    for i, res in enumerate(encode_batch_sharded(imgs, cfg, _mesh(2, 4), strategy)):
        _assert_same(res, _single(imgs[i], cfg), f"{strategy} frame {i}")


@pytest.mark.parametrize("use_classifier", [True, False], ids=["cls", "nocls"])
@pytest.mark.parametrize("strategy", ["domains", "ring"])
def test_sharded_encode_uneven_domain_rows(strategy, use_classifier):
    """80x64: 9 domain rows over 4 shards (3 a band), so the last band's
    padded rows are masked out: K1's reserved column bin, or K3's class
    mask."""
    cfg = T.EncoderConfig(use_classifier=use_classifier)
    imgs = np.random.default_rng(6).integers(0, 256, size=(2, 80, 64), dtype=np.uint8)
    for i, res in enumerate(encode_batch_sharded(imgs, cfg, _mesh(2, 4), strategy)):
        _assert_same(res, _single(imgs[i], cfg), f"{strategy} frame {i}")


@pytest.mark.parametrize("use_classifier", [True, False], ids=["cls", "nocls"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_threshold_matches_single(strategy, backend, use_classifier):
    """rms_threshold > 0 across shards: the frontier follows the global scan
    order ('domains' masks the shards past the first hit shard, 'ring'
    keeps two in-order accumulators), through the kernels' route ('auto':
    K1 or K3, their plain versions on CPU tensors) and the dense oracle
    ('torch')."""
    cfg = T.EncoderConfig(rms_threshold=THR, backend=backend,
                          use_classifier=use_classifier)
    imgs = _smooth(seed=3)
    hits = 0
    for i, res in enumerate(encode_batch_sharded(imgs, cfg, _mesh(2, 4), strategy)):
        single = _single(imgs[i], T.EncoderConfig(rms_threshold=THR,
                                                  use_classifier=use_classifier))
        hits += int((single.distance <= THR).sum())
        _assert_same(res, single, f"{strategy} {backend} frame {i}")
    assert hits > 0, "threshold never triggered: the test is vacuous"


@pytest.mark.parametrize("use_classifier", [True, False], ids=["cls", "nocls"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("codebook", ["replicate", "ring"])
def test_image_sharded_halo_threshold(codebook, backend, use_classifier):
    """The halo-sharded plane with rms_threshold > 0: 'replicate' searches
    each band in order against the whole codebook; 'ring' runs the two-group
    accumulators under the halo driver."""
    cfg = T.EncoderConfig(rms_threshold=THR, backend=backend, use_classifier=use_classifier)
    img = _smooth(1, 128, seed=4)[0, :, :64]
    res = encode_plane_sharded_image(img, cfg, _mesh(1, 4), codebook=codebook)
    single = _single(img, T.EncoderConfig(rms_threshold=THR, use_classifier=use_classifier))
    assert int((single.distance <= THR).sum()) > 0
    _assert_same(res, single, f"{codebook} {backend}")


@pytest.mark.parametrize("codebook", ["replicate", "ring"])
@pytest.mark.parametrize("n_search", [2, 4])
def test_image_sharded_halo_noclassifier(n_search, codebook):
    cfg = T.EncoderConfig(use_classifier=False)
    img = _noise(1, 64, seed=8)[0]
    res = encode_plane_sharded_image(img, cfg, _mesh(1, n_search), codebook=codebook)
    _assert_same(res, _single(img, cfg), f"{codebook} n_search={n_search}")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_oracle_route_equals_kernel_route(strategy):
    """backend 'torch' (the dense oracle, as the JAX package's 'jnp') against
    'auto' (K1 and K3's route, their plain versions on CPU tensors), with
    and without the classifier: every field, the rank keys' winners among
    them, bitwise."""
    imgs = _noise(seed=9)
    for kw in ({}, dict(use_classifier=False)):
        auto = encode_batch_sharded(imgs, T.EncoderConfig(**kw), _mesh(2, 4), strategy)
        oracle = encode_batch_sharded(imgs, T.EncoderConfig(backend="torch", **kw),
                                      _mesh(2, 4), strategy)
        for i in range(2):
            _assert_same(auto[i], oracle[i], f"{strategy} {kw} frame {i}")


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        encode_batch_sharded(_noise(), T.EncoderConfig(backend="cuda"), _mesh(2, 4), "domains")


def test_decode_batch_sharded_matches_single_device():
    """Each frame's pixels equal decode_plane's; the flat loop counts the
    step that met its exit too, the pyramid counts its fixed floor."""
    results = _port_ranges()
    for pyramid in (False, True):
        outs, iters, _ = decode_batch_sharded(results, _mesh(2, 4), pyramid=pyramid)
        for i, res in enumerate(results):
            out, it, _ = T.decode_plane(res, T.DecoderConfig(pyramid=pyramid))
            assert_bitwise(outs[i], out, f"frame {i} pyramid={pyramid}")
            assert int(iters[i]) == (it if pyramid else it + 1)


def test_mesh_shapes_and_errors():
    mesh = _mesh(2, 4)
    assert mesh.shape == {"data": 2, "search": 4}
    assert mesh.devices[1][0] == CPU and sum(map(len, mesh.devices)) == 8
    assert make_mesh(2, devices=[CPU] * 8).shape == {"data": 2, "search": 4}
    with pytest.raises(ValueError, match="exceeds 8 devices"):
        make_mesh(n_data=16, n_search=16, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="no device"):
        make_mesh(n_data=16, devices=[CPU] * 8)
    if not torch.cuda.is_available():  # never a silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)
    with pytest.raises(ValueError, match="unknown strategy"):
        encode_batch_sharded(_noise(), T.EncoderConfig(), mesh, "rows")
    with pytest.raises(ValueError, match="split evenly over 4 data shards"):
        encode_batch_sharded(_noise(b=2), T.EncoderConfig(), make_mesh(4, 2, [CPU] * 8))
    with pytest.raises(ValueError, match="unknown codebook mode"):
        encode_plane_sharded_image(_noise(1)[0], T.EncoderConfig(), _mesh(1, 4), "all")
    with pytest.raises(ValueError, match="split evenly over 3 search shards"):
        encode_plane_sharded_image(_noise(1)[0], T.EncoderConfig(), _mesh(1, 3))


def test_port_sources_import_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package (the import test in test_torch_cli.py checks the loaded
    modules; this reads every source)."""
    root = pathlib.Path(T.__file__).parent
    banned = re.compile(r"^\s*(import|from)\s+(jax|fractencode_tpu)(\.|\s|$)", re.M)
    sources = [*root.rglob("*.py"), root.parent / "chip_smoke.py"]
    assert len(sources) > 40
    bad = [str(p) for p in sources if banned.search(p.read_text())]
    assert not bad, bad
