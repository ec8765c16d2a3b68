"""The device loops and the quadtree's graph, on the CPU: the flat decode
loop carried on the device (``graphs.while_loop``), in chunks of 1, 3 and 8
predicated steps, against the JAX package's ``lax.while_loop`` for an exit
on each of its tests; VQ's k-means the same way against its
``train_codebook``; ``quadtree._replays`` against the JAX route statics of
every level; and the stages these graphs capture, which read nothing back
but the exit flag once a chunk.  The graphs themselves run on the card:
tests/test_torch_cuda.py.

The JAX side compiles one decode for each (form, decoder config): three
configs, six compiles at 64^2, shared across the file.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, lenna128, random_plane
from test_torch_graphs import GRAPH_PATHS, _config, _recorded

import fractencode_tpu as J
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu.encode.vq as jv
import fractencode_tpu.ops.matcher_pallas as jmp
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.quadtree as tq
import fractencode_tpu_torch.encode.vq as tv
from fractencode_tpu.encode.encoder import EncodeResult as JaxResult
from fractencode_tpu_torch.bridge import quadtree_to_numpy, result_to_numpy
from fractencode_tpu_torch.core.grid import uniform_grid
from fractencode_tpu_torch.decode import decoder as dec
from fractencode_tpu_torch.encode import encoder
from fractencode_tpu_torch.encode import matcher as tm
from fractencode_tpu_torch.ops import matcher_kernels as mk
from fractencode_tpu_torch.utils import prng

aten = torch.ops.aten
LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")

# a decode exiting on each of the flat loop's tests, at 64^2 (the plane,
# the decoder config): found on these planes with the reference's rules
PLANES = {"lenna_center": lambda: lenna128()[32:96, 32:96],
          "lenna_corner": lambda: lenna128()[:64, :64],
          "rand": lambda: random_plane(64, 1)}
EXITS = {"epsilon": ("lenna_center", {}),
         "cycle": ("lenna_corner", dict(stall_window=0)),
         "stall": ("rand", {}),
         "max_iterations": ("lenna_center", dict(max_iterations=3))}


@functools.lru_cache(maxsize=None)
def _encode(plane: str, form: str):
    img = PLANES[plane]()
    if form == "grid":
        return T.encode_plane(img, T.EncoderConfig(), device="cpu")
    return tq.encode_plane_quadtree(img, T.EncoderConfig(), device="cpu")


def _decode_port(plane, form, dcfg):
    res = _encode(plane, form)
    if form == "grid":
        return T.decode_plane(res, dcfg)
    return tq.decode_plane_quadtree(res, dcfg)


@functools.lru_cache(maxsize=None)
def _decode_jax(plane: str, form: str, overrides: tuple):
    """The JAX package's decode of the port's encode, carried across as numpy."""
    dcfg = J.DecoderConfig(**dict(overrides))
    if form == "grid":
        arrays, meta = result_to_numpy(_encode(plane, form))
        out = J.decode_plane(JaxResult(**{f: jnp.asarray(a) for f, a in arrays.items()},
                                       **meta), dcfg)
    else:
        levels, w, h = quadtree_to_numpy(_encode(plane, form))
        out = jq.decode_plane_quadtree(jq.QuadtreeResult(
            levels=[jq.QuadtreeLevel(**{f: jnp.asarray(a[f]) for f in LEVEL_FIELDS}, **meta)
                    for a, meta in levels], width=w, height=h), dcfg)
    return np.asarray(out[0]), int(out[1]), float(out[2])


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("form", ["grid", "quadtree"])
@pytest.mark.parametrize("exit_test", list(EXITS))
def test_flat_loop_matches_jax(exit_test, form, chunk, monkeypatch):
    """Pixels, iterations and MSE bitwise equal to the JAX package's flat
    decode_plane / decode_plane_quadtree at every chunk length: a chunk's
    steps past the exit change nothing.  Each case exits on its test."""
    plane, overrides = EXITS[exit_test]
    dcfg = T.DecoderConfig(**overrides)
    monkeypatch.setattr(dec, "_CHUNK", chunk)
    out, iters, mse = _decode_port(plane, form, dcfg)
    oj, ij, mj = _decode_jax(plane, form, tuple(sorted(overrides.items())))
    assert_bitwise(oj, out, "pixels")
    assert (iters, mse) == (ij, mj)
    below = np.float32(mse) < np.float32(dcfg.epsilon)
    if exit_test == "max_iterations":
        assert iters == dcfg.max_iterations
    elif exit_test == "epsilon":
        assert below and iters < dcfg.max_iterations
    elif exit_test == "cycle":  # no stall test, so a cycle ended it
        assert not below and iters < dcfg.max_iterations and dcfg.stall_window == 0
    else:  # the same decode without the stall test runs on
        assert not below and iters < dcfg.max_iterations
        assert _runs_on(plane, form, iters)


@functools.lru_cache(maxsize=None)
def _runs_on(plane: str, form: str, iters: int) -> bool:
    """Whether the decode without the stall test runs past ``iters``
    iterations (up to two more)."""
    dcfg = T.DecoderConfig(stall_window=0, max_iterations=iters + 2)
    return _decode_port(plane, form, dcfg)[1] > iters


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's thousands of tiny ops on 64^2
    planes: beside other test workers, a thread pool only slows them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_flat_batch_equals_single_frames(monkeypatch):
    """decode_batch_stacked's flat loop: each frame's pixels, iterations and
    MSE equal decode_plane's, read back once for the batch."""
    monkeypatch.setattr(dec, "_CHUNK", 3)
    planes = np.stack([PLANES[p]() for p in ("lenna_center", "lenna_corner", "rand")])
    stacked = T.encode_batch_stacked(planes, T.EncoderConfig(), device="cpu")
    dcfg = T.DecoderConfig(stall_window=0, max_iterations=20)
    outs, iters, mses = T.decode_batch_stacked(stacked, dcfg)
    assert iters.dtype == torch.int32 and mses.dtype == torch.float32
    for i, res in enumerate(T.encode_batch(planes, T.EncoderConfig(), device="cpu")):
        out, it, mse = T.decode_plane(res, dcfg)
        assert_bitwise(outs[i], out, f"frame {i}")
        assert (int(iters[i]), float(mses[i])) == (it, mse)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_kmeans_device_loop_matches_jax(chunk, monkeypatch):
    """train_codebook's device loop at every chunk length: steps and labels
    equal to the JAX package's (70 steps, a multiple of neither 3 nor 8),
    the codebook to the tolerance of test_torch_vq.py and bitwise equal
    across chunk lengths."""
    x = np.random.default_rng(0).standard_normal((3000, 16)).astype(np.float32)
    cb_j, asg_j, steps_j = _train_jax()
    monkeypatch.setattr(tv, "_CHUNK", chunk)
    cb_t, asg_t, steps_t = tv.train_codebook(torch.from_numpy(x), prng.prng_key(0), 5)
    assert steps_t == steps_j == 70
    np.testing.assert_allclose(cb_t.numpy(), cb_j, rtol=1e-5, atol=1e-6)
    assert_bitwise(asg_j, asg_t, "labels")
    monkeypatch.setattr(tv, "_CHUNK", 1)
    assert_bitwise(tv.train_codebook(torch.from_numpy(x), prng.prng_key(0), 5)[0], cb_t,
                   "codebook at chunk 1")


@functools.lru_cache(maxsize=None)
def _train_jax():
    x = np.random.default_rng(0).standard_normal((3000, 16)).astype(np.float32)
    cb, asg, steps = jv.train_codebook(jnp.asarray(x), jax.random.PRNGKey(0), 5)
    return np.asarray(cb), np.asarray(asg), int(steps)


def test_fixed_point_shift_on_the_device():
    """The shift is the host formula's, 62 less the exponent of max |x|
    times N; 0 for an all-zero input; and 2^e is exact."""
    import math

    for x in (torch.tensor([[0.75, -3.5], [1.0, 2.0]]), torch.zeros(3, 2),
              torch.full((5, 1), 1e-30), torch.full((7, 2), -6.0e4)):
        amax = float(x.abs().max())
        want = 0 if amax == 0 else 62 - math.frexp(amax * x.shape[0])[1]
        assert int(tv._fixed_point_shift(x)) == want
    e = torch.arange(-1000, 1001, dtype=torch.int64)
    assert torch.equal(tv._pow2(e), torch.tensor([2.0 ** int(k) for k in e],
                                                 dtype=torch.float64))


# sides of square planes, 64^2 to 16384^2
SIDES = [64, 512, 2048, 4096, 8192, 16384]


@pytest.mark.parametrize("mask_covered", [True, False])
@pytest.mark.parametrize("side", SIDES)
def test_quadtree_predicate_matches_the_jax_route_statics(side, mask_covered):
    """The quadtree replays at every size, whichever route each level's JAX
    route statics (the port's, equal, each level past the first with the
    coverage mask's reserved row bin) give it; without the classifier (K3)
    too; never on the CPU or with the plain versions."""
    qcfg = tq.QuadtreeConfig(mask_covered=mask_covered)
    fits = []
    for i, rs in enumerate(qcfg.level_sizes):
        ds = rs * qcfg.domain_ratio
        r = (side // rs) ** 2
        m = uniform_grid(side, side, ds, ds // qcfg.lattice).num_items * 4
        masked = i > 0 and mask_covered
        js = jm._classed_statics(r, m, J.EncoderConfig(), masked_ranges=masked)
        assert tm._classed_statics(r, m, masked_ranges=masked)[4:] == js[4:]
        *_, worst, p_cap, use_pairs = js
        fits.append(use_pairs and worst <= p_cap)
    cuda = torch.device("cuda")
    assert tq._replays(side, side, T.EncoderConfig(), qcfg, cuda)
    assert tq._replays(side, side, T.EncoderConfig(use_classifier=False), qcfg, cuda)
    assert not tq._replays(side, side, T.EncoderConfig(), qcfg, torch.device("cpu"))
    assert not tq._replays(side, side, T.EncoderConfig(backend="torch"), qcfg, cuda)
    assert all(fits) == (side <= 2048)


def test_quadtree_predicate_counts_the_masked_row_bin(monkeypatch):
    """With the pair cap at 72, a 64^2 level fits its list unmasked (72
    pairs at worst) but not with the reserved row bin (81), as the JAX route
    statics count it: the masked level's route is the counted one, and the
    pyramid replays either way."""
    monkeypatch.setattr(mk, "PAIR_CAP", 72)
    monkeypatch.setattr(jmp, "PAIR_CAP", 72)
    r, m = 256, uniform_grid(64, 64, 16, 8).num_items * 4
    for masked in (False, True):
        js = jm._classed_statics(r, m, J.EncoderConfig(), masked_ranges=masked)
        assert tm._classed_statics(r, m, masked_ranges=masked)[4:] == js[4:]
        *_, worst, p_cap, use_pairs = js
        assert (worst, worst <= p_cap) == ((81, False) if masked else (72, True))
        assert tm.replays_graph(r, m, T.EncoderConfig(), "cuda")
    plane = torch.from_numpy(random_plane(64, 18))
    cuda = torch.device("cuda")
    for mask_covered in (True, False):
        qcfg = tq.QuadtreeConfig(mask_covered=mask_covered)
        assert tq._replays(64, 64, T.EncoderConfig(), qcfg, cuda)
        routes = []
        kernel = tm.classed_prep
        monkeypatch.setattr(tm, "classed_prep", lambda *a, **k: (
            lambda p: routes.append(p["route"]) or p)(kernel(*a, **k)))
        tq._quadtree_arrays(plane, T.EncoderConfig(), qcfg)
        monkeypatch.setattr(tm, "classed_prep", kernel)
        # the 4 px level (worst 72 or 81 at 64^2) under the mask or not
        assert routes[-1] == ("counted" if mask_covered else "search_classed")


# the quadtree configs the graph takes, by CLI flags
QT_PATHS = {"default": [], "noclassifier": ["--noclassifier"], "compat": ["--compat"],
            "smax": ["--smax", "0.9"], "rms": ["--rms", "10"], "qtmin2": ["--qt-min", "2"]}


def _qt_config(argv):
    from fractencode_tpu_torch import cli

    args = cli.build_parser().parse_args(["--device", "cpu", "--quadtree", *argv])
    return cli._config_from_args(args), tq.QuadtreeConfig(
        min_size=args.qt_min, max_size=args.qt_max, error_threshold=args.qt_threshold)


@pytest.mark.parametrize("path", list(QT_PATHS))
def test_quadtree_stages_read_nothing_back(path, monkeypatch):
    """For each quadtree config: the captured pyramid makes no data-dependent
    host read and, once the tables are cached, no upload, and its arrays
    equal the per-level loop's (the reporter's eager form); the decodes'
    captured stages read only the flat loop's exit flag, once a chunk."""
    cfg, qcfg = _qt_config(QT_PATHS[path])
    assert tq._replays(64, 64, cfg, qcfg, torch.device("cuda"))
    plane = torch.from_numpy(lenna128()[32:96, 32:96].copy())
    tq._quadtree_arrays(plane, cfg, qcfg)  # the tables
    arrays, rec = _recorded(monkeypatch, tq._quadtree_arrays, plane, cfg, qcfg)
    assert (rec.reads, rec.uploads) == ([], []), path

    class Levels:
        def log(self, *_):
            pass

    eager = tq.encode_plane_quadtree(plane, cfg, qcfg, Levels())
    flat = [getattr(l, f) for l in eager.levels for f in LEVEL_FIELDS]
    assert len(flat) == len(arrays)
    for a, b in zip(arrays, flat):
        assert_bitwise(a, b, path)

    res = tq._levels(arrays, 64, 64, cfg, qcfg)
    monkeypatch.setattr(dec, "_CHUNK", 3)
    for dcfg in (T.DecoderConfig(pyramid=True), T.DecoderConfig(max_iterations=7)):
        tq.decode_plane_quadtree(res, dcfg)  # the tables
        (_, iters, _), rec = _recorded(monkeypatch, tq.decode_plane_quadtree, res, dcfg)
        chunks = 0 if dcfg.pyramid else -(-min(iters + 1, dcfg.max_iterations) // 3)
        assert rec.uploads == [], path
        assert rec.reads == [aten._local_scalar_dense.default] * (chunks + 1 + (
            0 if dcfg.pyramid else 1)), path


def test_quadtree_batch_equals_single_frames():
    """encode_batch_quadtree_stacked writes each frame's levels into its
    rows: every level of every frame equals encode_plane_quadtree's."""
    planes = np.stack([PLANES[p]() for p in ("lenna_center", "rand")])
    stacked = tq.encode_batch_quadtree_stacked(planes, device="cpu")
    for i, p in enumerate(planes):
        single = tq.encode_plane_quadtree(p, device="cpu")
        for ls, l1 in zip(stacked.levels, single.levels, strict=True):
            for f in LEVEL_FIELDS:
                assert_bitwise(getattr(ls, f)[i], getattr(l1, f), f"frame {i} {f}")


@pytest.mark.parametrize("path", ["default", "compat"])
def test_flat_decode_chunk_reads_nothing_back(path, monkeypatch):
    """A chunk of the flat loop reads nothing back; the loop reads its exit
    flag once a chunk and uploads nothing once the tables are cached, also
    from the block-mean start (``initial='means'``)."""
    res = encoder.encode_plane(random_plane(64, 21), _config(GRAPH_PATHS[path]), device="cpu")
    monkeypatch.setattr(dec, "_CHUNK", 4)
    for dcfg in (T.DecoderConfig(max_iterations=9),
                 T.DecoderConfig(initial="means", max_iterations=9)):
        dec._flat_decode(res, dcfg, graph=False)  # the tables
        (_, iters, _), rec = _recorded(monkeypatch, dec._flat_decode, res, dcfg, False)
        chunks = -(-min(int(iters) + 1, dcfg.max_iterations) // 4)
        assert rec.reads == [aten._local_scalar_dense.default] * chunks, path
        assert rec.uploads == [], path


@pytest.mark.parametrize("limit", [None, 100])
def test_vq_stages_read_nothing_back(limit, monkeypatch):
    """The VQ encode's graph form: the k-means' start and the encode given
    the codebook read nothing back and upload nothing once the draws are
    device tables; the k-means reads its exit flag once a chunk; together
    they equal the eager encode."""
    cfg = T.EncoderConfig(vq_classes=4, vq_sample_limit=limit or 65536)
    plane = torch.from_numpy(lenna128())
    eager = encoder._encode_arrays(plane, cfg)  # the tables
    encoder._vq_start(plane, cfg)
    start, rec = _recorded(monkeypatch, encoder._vq_start, plane, cfg)
    assert (rec.reads, rec.uploads) == ([], [])
    monkeypatch.setattr(tv, "_CHUNK", 8)
    (codebook, steps), rec = _recorded(
        monkeypatch, lambda: tv._kmeans(*start, tv.MAX_STEPS, tv.EPSILON, graph=False))
    chunks = -(-int(steps) // 8)  # the step that meets the exit is counted
    assert rec.reads == [aten._local_scalar_dense.default] * chunks and rec.uploads == []
    arrays, rec = _recorded(monkeypatch, encoder._encode_arrays, plane, cfg, codebook)
    assert (rec.reads, rec.uploads) == ([], [])
    for f, a, b in zip(encoder.ARRAY_FIELDS, arrays, eager):
        assert_bitwise(a, b, f)


def test_vq_now_replays():
    """The VQ encode takes the graph where the classifier's would."""
    r, m = (512 // 4) ** 2, uniform_grid(512, 512, 16, 8).num_items * 4
    for n in (1, 4, 7):
        assert tm.replays_graph(r, m, T.EncoderConfig(vq_classes=n), "cuda")
    assert encoder._replays(512, 512, T.EncoderConfig(vq_classes=4), torch.device("cuda"))

