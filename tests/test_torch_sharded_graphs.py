"""The sharded forms' device programs, on the CPU: every step of
``parallel.sharded`` (and the quadtree's sharded decode) makes no host read
and no upload, the shard index being a device value; through
``utils.graphs``, with torch's capture stood in for by a replay that runs the
step again and writes over the graph's outputs (as a CUDA graph's replay
does), a second call replays every step, a ring holds a few graph keys
whatever its shards and hops, and the results equal the eager calls', the
single-device encode's and the JAX package's bitwise.  Meshes repeat
``torch.device("cpu")``, so a replay overwrites the outputs the previous
shard's replay of the same key left, as on a card repeated.  The graphs
themselves run on the card: tests/test_torch_cuda.py.
"""
import collections
import contextlib
import functools

import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise
from test_torch_graphs import _recorded

import fractencode_tpu as J
from fractencode_tpu.parallel import encode_batch_sharded as j_encode_batch_sharded
from fractencode_tpu.parallel import make_mesh as j_make_mesh

import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.decode import decoder as dec
from fractencode_tpu_torch.parallel import make_mesh
from fractencode_tpu_torch.parallel import sharded as ts
from fractencode_tpu_torch.utils import graphs

aten = torch.ops.aten
CPU = torch.device("cpu")
FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid")
THR = 60.0
CONFIGS = {"default": {}, "rms": dict(rms_threshold=THR),
           "nocls": dict(use_classifier=False),
           "nocls_rms": dict(use_classifier=False, rms_threshold=THR)}
# the steps each form runs
STEPS = {"ranges": {"sharded_ranges"},
         "domains": {"sharded_domains", "sharded_domains_reduce"},
         "ring": {"sharded_ring_build", "sharded_ring_hop", "sharded_ring_merge"},
         "halo replicate": {"sharded_halo_build", "sharded_halo_search"},
         "halo ring": {"sharded_halo_build", "sharded_ring_hop", "sharded_ring_merge"}}


def _mesh(n_data: int, n_search: int):
    return make_mesh(n_data, n_search, devices=[CPU] * (n_data * n_search))


def _smooth(b=2, n=64, seed=1234):
    """Low-pass frames (a 5x5 box mean of noise), so that the threshold's
    early accepts trigger, as tests/test_torch_parallel.py makes them."""
    from numpy.lib.stride_tricks import sliding_window_view

    base = np.random.default_rng(seed).integers(0, 256, size=(b, n, n)).astype(np.float32)
    out = [sliding_window_view(np.pad(x, 2, mode="edge"), (5, 5)).reshape(n, n, 25).mean(2)
           for x in base]
    return np.stack(out).astype(np.uint8)


# the planes: two 64^2 frames, and a 128 x 64 plane for the halo forms
FRAMES = torch.from_numpy(_smooth(seed=21))
TALL = torch.from_numpy(_smooth(1, 128, seed=22)[0, :, :64].copy())


def _form(form: str, cfg, graph, mesh=None):
    """One sharded call of ``form`` (a key of STEPS) on the test's planes:
    a list of EncodeResults."""
    if form.startswith("halo"):
        return [ts._encode_image(TALL, cfg, mesh or _mesh(1, 4), form.split()[1], graph)]
    return ts._encode_batch(FRAMES, cfg, mesh or _mesh(2, 4), form, graph)


def _assert_same(ra, rb, what):
    for a, b in zip(ra, rb, strict=True):
        for f in FIELDS:
            assert_bitwise(getattr(a, f), getattr(b, f), f"{what} {f}")


@contextlib.contextmanager
def _steps_run(monkeypatch):
    """The names of the steps ``sharded._run`` is given (a list it fills)."""
    names = []
    run = ts._run

    def spy(name, *args):
        names.append(name)
        return run(name, *args)

    monkeypatch.setattr(ts, "_run", spy)
    yield names
    monkeypatch.setattr(ts, "_run", run)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("form", list(STEPS))
def test_steps_read_nothing_back(form, config, monkeypatch):
    """Every step of each sharded form, and the moves between them, make no
    data-dependent host read and no upload once the tables are on the
    device: the shard index, the band offsets, the range cuts, the masks
    and the ring's group are device values, and the threshold a constant."""
    cfg = T.EncoderConfig(**CONFIGS[config])
    want = _form(form, cfg, False)  # the tables
    with _steps_run(monkeypatch) as names:
        got, rec = _recorded(monkeypatch, _form, form, cfg, False)
    assert (rec.reads, rec.uploads) == ([], []), (form, config)
    assert set(names) == STEPS[form]
    _assert_same(got, want, f"{form} {config}")


class _Rerun:
    """A captured step on the CPU: a replay runs the step again on the
    graph's static inputs and writes its results over the graph's outputs,
    as a CUDA graph's replay does."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        for out, new in zip(self.outputs, self.fn(*self.inputs), strict=True):
            out.copy_(new)

    def reset(self):
        pass


@pytest.fixture
def rerun_graphs(monkeypatch):
    """utils.graphs with torch's capture stood in for by ``_Rerun``, which
    is its own traced twin."""
    def capture(fn, inputs, used):
        static = tuple(torch.empty_like(x) for x in inputs)
        for s, x in zip(static, inputs):
            s.copy_(x)
        outputs = tuple(fn(*static))
        graph = _Rerun(fn, static, outputs)
        return graphs._Graph(graph, static, outputs, (), used, (graph, outputs))

    monkeypatch.setattr(graphs, "_capture", capture)
    graphs.clear()
    yield
    graphs.clear()


def _forms_taken(before):
    """{(step, form): calls} since ``before`` (a copy of graphs.calls)."""
    return {k: n for k, n in (graphs.calls - before).items() if k[0].startswith("sharded_")}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("form", list(STEPS))
def test_second_call_replays_every_step(form, config, rerun_graphs):
    """Through the graphs, a first call runs each step's key eagerly once,
    captures it at the next shard and replays it from then on; a second
    call replays every step.  Both equal the eager call bitwise, so each
    replay's outputs were copied out before the next shard's replay of the
    key overwrote them.  A ring holds its build, hop and merge keys only,
    whatever its shards and hops."""
    cfg = T.EncoderConfig(**CONFIGS[config])
    eager = _form(form, cfg, False)
    before = collections.Counter(graphs.calls)
    first = _form(form, cfg, True)
    mid = collections.Counter(graphs.calls)
    second = _form(form, cfg, True)
    forms = _forms_taken(mid)
    assert {name for name, _ in forms} == STEPS[form]
    assert all(f == "replay" for _, f in forms), forms
    taken = _forms_taken(before)
    assert all(taken[name, "eager"] == 1 for name in STEPS[form]), taken
    assert len(graphs._GRAPHS) == len(STEPS[form]) and not graphs._SEEN
    _assert_same(first, eager, f"{form} {config} first call")
    _assert_same(second, eager, f"{form} {config} second call")
    if form.startswith("halo"):
        single = T.encode_plane(TALL, cfg, device="cpu")
        _assert_same(second, [single], f"{form} {config} against encode_plane")


def test_ring_hops_share_keys(rerun_graphs):
    """A ring on 4 repeated devices replays 16 hops through one graph: its
    keys are the build, the hop and the merge, not one for each (shard,
    hop)."""
    cfg = T.EncoderConfig(rms_threshold=THR)
    before = collections.Counter(graphs.calls)
    for _ in range(2):
        _form("ring", cfg, True, _mesh(1, 4))
    taken = _forms_taken(before)
    # a capturing call replays too
    hops = taken["sharded_ring_hop", "eager"] + taken["sharded_ring_hop", "replay"]
    assert hops == 2 * 2 * 16  # two calls of two frames, four shards, four hops
    assert [k[0] for k in graphs._GRAPHS] == ["sharded_ring_build", "sharded_ring_hop",
                                              "sharded_ring_merge"]


@pytest.mark.parametrize("config", ["default", "nocls_rms"])
def test_uneven_ring_cut(config, rerun_graphs):
    """256 ranges over 3 shards cut 85, 85 and 86: two shapes, so two keys
    for each of the ring's steps; the graph form equals the eager one and
    encode_plane bitwise."""
    cfg = T.EncoderConfig(**CONFIGS[config])
    mesh = _mesh(1, 3)
    eager = _form("ring", cfg, False, mesh)
    for _ in range(2):
        got = _form("ring", cfg, True, mesh)
    assert sorted(k[0] for k in graphs._GRAPHS) == sorted(
        2 * ["sharded_ring_build", "sharded_ring_hop", "sharded_ring_merge"])
    singles = [T.encode_plane(f, cfg, device="cpu") for f in FRAMES]
    _assert_same(got, eager, f"uneven ring {config}")
    _assert_same(got, singles, f"uneven ring {config} against encode_plane")


@functools.lru_cache(maxsize=None)
def _jax_ring():
    cfg = J.EncoderConfig(rms_threshold=THR)
    return j_encode_batch_sharded(_smooth(seed=21), cfg, j_make_mesh(2, 4), strategy="ring")


def test_ring_graph_matches_jax(rerun_graphs):
    """The ring with the frontier through the graphs, a second call (every
    step a replay), against the JAX package's on conftest's virtual devices:
    every field bitwise."""
    cfg = T.EncoderConfig(rms_threshold=THR)
    _form("ring", cfg, True)
    got = _form("ring", cfg, True)
    for rj, rt in zip(_jax_ring(), got, strict=True):
        for f in FIELDS:
            assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f)
    assert int((got[0].distance <= THR).sum()) > 0


@functools.lru_cache(maxsize=None)
def _encoded():
    return ts._encode_batch(FRAMES, T.EncoderConfig(), _mesh(2, 4), "ranges", False)


@functools.lru_cache(maxsize=None)
def _encoded_quadtree():
    return tq.encode_batch_quadtree_sharded(FRAMES, T.EncoderConfig(),
                                            tq.QuadtreeConfig(min_size=4, max_size=16),
                                            _mesh(2, 4))


def _decode(kind: str, dcfg, graph):
    if kind == "grid":
        return ts._decode_batch(_encoded(), _mesh(2, 4), dcfg, graph)
    return tq._decode_batch_sharded(_encoded_quadtree(), _mesh(2, 4), dcfg, graph)


def _cpu_calls(monkeypatch):
    """A list that gets one entry for each Tensor.cpu call."""
    calls = []
    cpu = torch.Tensor.cpu

    def spy(t, *args, **kwargs):
        calls.append(t.shape)
        return cpu(t, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    return calls


@pytest.mark.parametrize("pyramid", [False, True], ids=["flat", "pyramid"])
@pytest.mark.parametrize("kind", ["grid", "quadtree"])
def test_sharded_decodes_read_once(kind, pyramid, monkeypatch):
    """The sharded decodes read the iterations and MSEs back once a call,
    beside the flat loop's exit flag once a chunk, and upload nothing."""
    monkeypatch.setattr(dec, "_CHUNK", 3)
    dcfg = T.DecoderConfig(pyramid=pyramid)
    want = _decode(kind, dcfg, False)  # the tables
    cpu = _cpu_calls(monkeypatch)
    (outs, iters, mses), rec = _recorded(monkeypatch, _decode, kind, dcfg, False)
    assert cpu == [torch.Size([2, 2])]  # [iterations, mse bits] x 2 frames
    steps = iters if kind == "grid" else (iters + 1).clamp(max=dcfg.max_iterations)
    chunks = 0 if pyramid else int((-(-steps // 3)).sum())
    assert rec.reads == [aten._local_scalar_dense.default] * chunks
    assert rec.uploads == []
    for a, b, what in zip((outs, iters, mses), want, ("pixels", "iterations", "mse")):
        assert_bitwise(a, b, what)
    assert iters.dtype == torch.int32 and mses.dtype == torch.float32


@pytest.mark.parametrize("pyramid", [False, True], ids=["flat", "pyramid"])
@pytest.mark.parametrize("kind", ["grid", "quadtree"])
def test_sharded_decode_graphs_equal_eager(kind, pyramid, rerun_graphs):
    """Through the graphs (the pyramid's, the flat loop's chunks), twice:
    pixels, iterations and MSEs equal the eager decode's bitwise, and the
    grid's equal decode_batch_stacked's (its iterations plus the step that
    met the exit, which the sharded decode counts)."""
    dcfg = T.DecoderConfig(pyramid=pyramid)
    want = _decode(kind, dcfg, False)
    for _ in range(2):
        got = _decode(kind, dcfg, True)
        for a, b, what in zip(got, want, ("pixels", "iterations", "mse")):
            assert_bitwise(a, b, what)
    if kind == "grid":
        stacked = T.encode_batch_stacked(FRAMES, T.EncoderConfig(), device="cpu")
        outs, iters, mses = T.decode_batch_stacked(stacked, dcfg)
        assert_bitwise(got[0], outs, "pixels against decode_batch_stacked")
        assert_bitwise(got[2], mses, "mse against decode_batch_stacked")
        assert torch.equal(got[1], iters if pyramid
                           else (iters + 1).clamp(max=dcfg.max_iterations))
