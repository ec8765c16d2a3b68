"""Port parity, decoder: the same encodes (carried across by bridge.py)
through both packages' decoders give identical pixels, iteration counts and
MSE; plus the C++ reference goldens, run through the port."""
import dataclasses
import gzip
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import (DECODE_STEP_GEOMETRIES, GOLDEN, RESULT_ARRAYS, assert_bitwise,
                           decode_step_case, jax_result_to_port, lenna128, mean_maps,
                           random_plane)

import fractencode_tpu as J
import fractencode_tpu.decode.decoder as jdec
import fractencode_tpu_torch as T
import fractencode_tpu_torch.decode.decoder as tdec
from fractencode_tpu_torch.bridge import (config_from_jax_fields, result_from_numpy,
                                          result_to_numpy)

DCFGS = {
    "flat": J.DecoderConfig(),
    "flat_nostall": J.DecoderConfig(stall_window=0),
    "pyramid": J.DecoderConfig(pyramid=True),
    "pyramid_cap3": J.DecoderConfig(pyramid=True, max_iterations=3),
    "means": J.DecoderConfig(initial="means"),
}
_ENCODES = {}


def _jax_encode(pname, cname):
    key = (pname, cname)
    if key not in _ENCODES:
        img = lenna128() if pname == "lenna128" else random_plane(96, 2)
        cfg = J.REFERENCE_COMPAT(backend="jnp") if cname == "compat" else \
            J.EncoderConfig(backend="jnp")
        _ENCODES[key] = (img, J.encode_plane(img, cfg))
    return _ENCODES[key]


@pytest.mark.parametrize("dname", sorted(DCFGS))
@pytest.mark.parametrize("cname", ["default", "compat"])
@pytest.mark.parametrize("pname", ["lenna128", "rand96"])
def test_decode_matches_jax(pname, cname, dname):
    _, rj = _jax_encode(pname, cname)
    dcfg = DCFGS[dname]
    oj, ij, mj = J.decode_plane(rj, dcfg)
    ot, it, mt = T.decode_plane(jax_result_to_port(rj), config_from_jax_fields(dcfg))
    assert_bitwise(oj, ot, "pixels")
    assert int(ij) == it
    assert np.float32(mj) == np.float32(mt)


def test_jax_decodes_port_encode():
    """The other direction: a port encode, carried to the JAX package's
    EncodeResult, decodes there to the port's own pixels."""
    from fractencode_tpu.encode.encoder import EncodeResult as JaxResult

    img = random_plane(64, 9)
    rt = T.encode_plane(img, device="cpu")
    arrays, meta = result_to_numpy(rt)
    rj = JaxResult(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}, **meta)
    dcfg = J.DecoderConfig(pyramid=True)
    oj, ij, _ = J.decode_plane(rj, dcfg)
    ot, it, _ = T.decode_plane(rt, config_from_jax_fields(dcfg))
    assert_bitwise(oj, ot, "pixels")
    assert int(ij) == it
    back = result_from_numpy(*result_to_numpy(rt), device="cpu")
    for f in RESULT_ARRAYS:
        assert_bitwise(getattr(rt, f), getattr(back, f), f)


def test_config_from_jax_fields():
    jcfg = J.REFERENCE_COMPAT(backend="jnp", num_transforms=8)
    tcfg = config_from_jax_fields(jcfg)
    assert isinstance(tcfg, T.EncoderConfig) and tcfg.backend == "torch"
    assert {k: v for k, v in dataclasses.asdict(tcfg).items() if k != "backend"} == \
        {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "backend"}
    assert config_from_jax_fields(J.EncoderConfig(backend="pallas")).backend == "cuda"
    dcfg = J.DecoderConfig(pyramid=True, stall_window=3)
    assert dataclasses.asdict(config_from_jax_fields(dcfg)) == dataclasses.asdict(dcfg)


def test_decode_steps_py_matches_jax():
    _, rj = _jax_encode("lenna128", "compat")
    dcfg = J.DecoderConfig(max_iterations=20)
    steps_j = [(i, np.asarray(im)) for i, im in jdec.decode_steps_py(rj, dcfg)]
    steps_t = [(i, im.numpy()) for i, im in
               tdec.decode_steps_py(jax_result_to_port(rj), config_from_jax_fields(dcfg))]
    assert [i for i, _ in steps_j] == [i for i, _ in steps_t]
    for (_, a), (_, b) in zip(steps_j, steps_t):
        assert_bitwise(a, b, "iterate")


@pytest.mark.parametrize("geom,kind", [((16, 4, 8), "cb"), ((64, 32, 32), "half"),
                                       ((6, 3, 3), "full")])
def test_decode_table_kinds(geom, kind):
    """Each table kind ('cb', 'half', 'full') is chosen for the same geometry
    as in the JAX package and samples the same values."""
    source, target, step = geom
    n = 192
    nx = (n - source) // step + 1
    rng = np.random.default_rng(12)
    r = (n // target) ** 2
    dom = rng.integers(0, nx * nx, r).astype(np.int32)
    tr = rng.integers(0, 8, r).astype(np.int32)
    img = rng.integers(0, 256, (n, n), dtype=np.uint8)
    kind_j, idx_j = jdec.build_decode_tables(jax.numpy.asarray(dom), jax.numpy.asarray(tr),
                                             n, n, source, target, step)
    kind_t, idx_t = tdec.build_decode_tables(torch.from_numpy(dom), torch.from_numpy(tr),
                                             n, n, source, target, step)
    assert kind_j == kind_t == kind
    assert_bitwise(jdec.sample_domains(jax.numpy.asarray(img), (kind_j, idx_j)),
                   tdec.sample_domains(torch.from_numpy(img), (kind_t, idx_t)), kind)


@pytest.mark.parametrize("geometry", ["ts3", "grid", "ts5"])
def test_mean_step_matches_jax(geometry):
    """The o_is_mean step against the JAX package's on ``mean_maps``, where a
    pixel falls one grey level wherever a range's mean is one ulp off: the
    JAX package's mean is the sum times f32(1/K) (XLA:CPU turns the division
    by the constant K into that product), K = 9, 16, 25."""
    sw, ts, step, t_n, n = DECODE_STEP_GEOMETRIES[geometry]
    img, dom, tr, _, _ = decode_step_case(geometry, 31, o_is_mean=True)
    tables = tdec.build_decode_tables(torch.from_numpy(dom), torch.from_numpy(tr), n, n,
                                      sw, ts, step, t_n)
    s, o = mean_maps(tdec.sample_domains(torch.from_numpy(img), tables))
    step_j = jax.jit(lambda im, d, t, s_, o_: jdec._decode_step(
        im, jdec.build_decode_tables(d, t, n, n, sw, ts, step, t_n), s_, o_, n, n, ts,
        o_is_mean=True))
    want = step_j(*map(jax.numpy.asarray, (img, dom, tr, s, o)))
    got = tdec._decode_step(torch.from_numpy(img), tables, torch.from_numpy(s),
                            torch.from_numpy(o), n, n, ts, True)
    assert_bitwise(np.asarray(want), got, geometry)


# --- the C++ reference goldens (tests/test_reference_parity.py), for the port


def _cpp_dump(name="lenna128_cpp_encode.txt.gz"):
    with gzip.open(os.path.join(GOLDEN, name), "rt") as f:
        dump = np.loadtxt(f)
    rx = (dump[:, 0] // 4).astype(int)
    ry = (dump[:, 1] // 4).astype(int)
    out = np.zeros_like(dump)
    out[ry * 32 + rx] = dump
    return out


def _cpp_result_png(name="lenna128_cpp_result.png"):
    path = os.path.join(GOLDEN, name)
    return np.asarray(Image.open(path).convert("L"))


# the reference's non-default flags (tests/test_reference_parity.py):
# config overrides, encode dump, result.png
_CPP_FLAGS = {
    "rms10": (dict(rms_threshold=10.0), "lenna128_cpp_rms10.txt.gz",
              "lenna128_cpp_result_rms10.png"),
    "nocls": (dict(use_classifier=False), "lenna128_cpp_nocls.txt.gz",
              "lenna128_cpp_result_nocls.png"),
    "smax09": (dict(s_max=0.9), "lenna128_cpp_smax09.txt.gz",
               "lenna128_cpp_result_smax09.png"),
}


def test_encoder_parity_with_cpp():
    _assert_cpp_encode(T.encode_plane(lenna128(), T.REFERENCE_COMPAT(), device="cpu"),
                       _cpp_dump())


@pytest.mark.parametrize("name", sorted(_CPP_FLAGS))
def test_encoder_parity_with_cpp_flags(name):
    """--rms 10 (the early-accept frontier), --noclassifier (the dense
    search) and --smax 0.9 against the C++ encoder's dumps, to
    test_reference_parity.py's tolerances."""
    overrides, dump_name, _ = _CPP_FLAGS[name]
    res = T.encode_plane(lenna128(), T.REFERENCE_COMPAT(**overrides), device="cpu")
    assert bool(res.valid.all())
    _assert_cpp_encode(res, _cpp_dump(dump_name))


def _assert_cpp_encode(res, dump):
    nx = (128 - 16) // 8 + 1
    dom_idx_cpp = (dump[:, 5] // 8).astype(int) * nx + (dump[:, 4] // 8).astype(int)
    assert np.array_equal(res.domain_idx.numpy(), dom_idx_cpp)
    assert np.array_equal(res.transform.numpy(), dump[:, 8].astype(int))
    np.testing.assert_allclose(res.distance.numpy(), dump[:, 11], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.s.numpy(), dump[:, 9], rtol=0, atol=5e-4)
    np.testing.assert_allclose(res.o.numpy(), dump[:, 10], rtol=0, atol=0.1)


def test_decode_parity_from_cpp_encode():
    """The port's decoder on the C++ encoder's output is pixel-identical to
    the C++ decoder's result.png, in the reference's 16 steps."""
    dump = _cpp_dump()
    nx = (128 - 16) // 8 + 1
    dom_idx = (dump[:, 5] // 8).astype(int) * nx + (dump[:, 4] // 8).astype(int)
    res = result_from_numpy(
        dict(domain_idx=dom_idx, transform=dump[:, 8].astype(int), s=dump[:, 9],
             o=dump[:, 10], distance=dump[:, 11], valid=np.ones(len(dump), bool)),
        dict(width=128, height=128, source_size=16, target_size=4, domain_step=8),
        device="cpu")
    out, iters, _ = T.decode_plane(res)
    assert np.array_equal(out.numpy(), _cpp_result_png())
    assert iters == 16  # reference printed "decode stats: 16 steps"


def test_end_to_end_parity():
    """Compat encode + decode fully in the port == C++ result.png."""
    res = T.encode_plane(lenna128(), T.REFERENCE_COMPAT(), device="cpu")
    out, _, _ = T.decode_plane(res)
    assert np.array_equal(out.numpy(), _cpp_result_png())


@pytest.mark.parametrize("name", sorted(_CPP_FLAGS))
def test_end_to_end_parity_flags(name):
    """The port's encode + decode under each flag == the C++ result.png:
    exact without the classifier; with --smax 0.9, at most 2 pixels off by
    one gray level (the reference's decoder applies the clamp in double,
    test_reference_parity.py::test_decode_parity_flag_matrix)."""
    overrides, _, result_name = _CPP_FLAGS[name]
    res = T.encode_plane(lenna128(), T.REFERENCE_COMPAT(**overrides), device="cpu")
    out, _, _ = T.decode_plane(res)
    diff = np.abs(out.numpy().astype(int) - _cpp_result_png(result_name).astype(int))
    if name == "smax09":
        assert (diff > 0).sum() <= 2 and diff.max() <= 1, ((diff > 0).sum(), diff.max())
    else:
        assert not diff.any(), (diff > 0).sum()


@pytest.mark.parametrize("shape,cfg_kw", [
    ((96, 64), {}), ((80, 48), dict(num_transforms=8)), ((64, 64), dict(num_transforms=3)),
    ((60, 60), dict(source_size=12, target_size=6, lattice=3)),  # K = 36: n not 2^k
    ((72, 72), dict(source_size=12, target_size=4, lattice=3)),  # 3x3 range blocks per domain
    ((63, 63), dict(source_size=6, target_size=3, lattice=2)),   # odd sizes, 'full' taps
])
def test_other_geometries(shape, cfg_kw):
    """Non-square planes and other block geometries: the whole encode
    bitwise, then flat, pyramid and means decodes identical."""
    from _torch_parity import assert_results_equal
    from fractencode_tpu_torch.bridge import config_from_jax_fields as conv

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    jcfg = J.EncoderConfig(backend="jnp", **cfg_kw)
    rj = J.encode_plane(img, jcfg)
    assert_results_equal(rj, T.encode_plane(img, conv(jcfg), device="cpu"))
    for dcfg in (J.DecoderConfig(), J.DecoderConfig(pyramid=True),
                 J.DecoderConfig(initial="means")):
        oj, ij, mj = J.decode_plane(rj, dcfg)
        ot, it, mt = T.decode_plane(jax_result_to_port(rj), conv(dcfg))
        assert_bitwise(oj, ot, "pixels")
        assert (int(ij), np.float32(mj)) == (it, np.float32(mt))
