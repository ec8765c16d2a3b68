"""The port's CUDA-graph path, on the CPU: which calls may replay a graph
(``matcher.replays_graph``) against the JAX package's route statics, that the
stages a graph captures read nothing back from the device and upload nothing
once the tables are on it, and the device table cache (``utils.tables``).
The graphs themselves run on the card: tests/test_torch_cuda.py.
"""
import collections
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import assert_bitwise, random_plane

import fractencode_tpu as J
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu_torch import cli
from fractencode_tpu_torch.core import classify, stats
from fractencode_tpu_torch.core.grid import Grid, uniform_grid
from fractencode_tpu_torch.core.sampler import all_tap_tables
from fractencode_tpu_torch.decode import decoder as dec
from fractencode_tpu_torch.encode import codebook, encoder, quadtree
from fractencode_tpu_torch.ops import matcher_kernels as mk
from fractencode_tpu_torch.params import DecoderConfig, EncoderConfig
from fractencode_tpu_torch.utils import graphs, profiling, tables
from fractencode_tpu_torch.utils.tables import device_table

aten = torch.ops.aten

# the configs the graph takes, by CLI flags (each at 64^2 and 128^2 here)
GRAPH_PATHS = {"default": [], "compat": ["--compat"], "smax": ["--smax", "0.9"],
               "rms": ["--rms", "10"], "noclassifier": ["--noclassifier"],
               "config1": ["--source", "16", "--target", "8", "--transforms", "8",
                           "--noclassifier"],
               "ranges2": ["--source", "8", "--target", "2"]}


def _config(argv):
    return cli._config_from_args(cli.build_parser().parse_args(["--device", "cpu", *argv]))


def _geometry(side, source, target, transforms=4):
    """(R, M) of a square plane: ranges, and domains times isometries."""
    return ((side // target) ** 2,
            uniform_grid(side, side, source, source // 2).num_items * transforms)


@pytest.mark.parametrize("geometry", [(16, 4), (32, 8), (64, 16)],
                         ids=["4px", "8px", "16px"])
@pytest.mark.parametrize("side", [64, 512, 2048, 4096, 8192, 16384])
def test_predicate_matches_the_jax_route_statics(side, geometry):
    """A classed encode replays at every size, whichever route the JAX
    package's statics (the port's, equal) give it: K1 where its pair list
    always fits (to 2048^2 at 4 px), the route the class counts decide on
    the device where the list could overflow (4096^2 and 8192^2), K2 where
    the list cannot be used (16384^2)."""
    ds, rs = geometry
    r, m = _geometry(side, ds, rs)
    js = jm._classed_statics(r, m, J.EncoderConfig())
    assert tm._classed_statics(r, m)[4:] == js[4:]
    *_, worst, p_cap, use_pairs = js
    cfg = EncoderConfig(source_size=ds, target_size=rs)
    for backend in ("auto", "cuda"):
        c = dataclasses.replace(cfg, backend=backend)
        assert tm.replays_graph(r, m, c, "cuda")
        assert encoder._replays(side, side, c, torch.device("cuda"))
    if rs == 4:
        route = ("search_classed" if use_pairs and worst <= p_cap
                 else "counted" if use_pairs else "search_classed2d")
        assert route == ("search_classed" if side <= 2048 else
                         "counted" if side <= 8192 else "search_classed2d")
    # the dense route is static at every size
    assert tm.replays_graph(r, m, dataclasses.replace(cfg, use_classifier=False), "cuda")


@pytest.mark.parametrize("cfg", [EncoderConfig(backend="torch"),
                                 EncoderConfig(vq_classes=3, backend="torch"),
                                 EncoderConfig(use_classifier=False, backend="torch")],
                         ids=["torch", "vq", "dense-torch"])
def test_predicate_refuses(cfg):
    """The plain versions (with the classifier, VQ bins or neither), the
    CPU and an empty plane never replay."""
    r, m = _geometry(512, 16, 4)
    assert not tm.replays_graph(r, m, cfg, "cuda")
    assert not tm.replays_graph(r, m, EncoderConfig(), "cpu")
    assert not tm.replays_graph(0, m, EncoderConfig(), "cuda")


class HostReads(TorchDispatchMode):
    """Records what would wait for the card: ops whose result depends on
    tensor data on the host side (``_local_scalar_dense``, ``equal``, ops
    with data-dependent output shapes, indexing by a boolean mask), the
    reads that skip the dispatcher on the CPU (``tolist``, ``numpy``), and
    tensors made from host data (``lift_fresh``: an upload on the card)."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.reads, self.uploads = [], []
        self.active = True
        for name in ("tolist", "numpy"):
            self._wrap(monkeypatch, name)

    def _wrap(self, monkeypatch, name):
        method = getattr(torch.Tensor, name)

        def wrapped(t, *args, **kwargs):
            if self.active:
                self.reads.append(name)
            return method(t, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, wrapped)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.active:
            if func is aten.lift_fresh.default:
                self.uploads.append(func)
            elif func.__name__.startswith("index") and any(
                    isinstance(a, (list, tuple)) and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in a)
                    for a in args):
                self.reads.append(func)
            elif (torch.Tag.data_dependent_output in func.tags
                  or (torch.Tag.dynamic_output_shape in func.tags
                      and func is not aten.index.Tensor)):
                self.reads.append(func)
        return func(*args, **(kwargs or {}))

    def paused(self, fn):
        """``fn`` run unrecorded (the search kernel: on the card one launch,
        here its plain version)."""
        def run(*args, **kwargs):
            self.active = False
            try:
                return fn(*args, **kwargs)
            finally:
                self.active = True
        return run


def _recorded(monkeypatch, fn, *args):
    """(fn(*args), its HostReads) with the searches' kernels unrecorded."""
    rec = HostReads(monkeypatch)
    monkeypatch.setattr(tm, "classed_kernel", rec.paused(tm.classed_kernel))
    monkeypatch.setattr(tm, "dense_kernel", rec.paused(tm.dense_kernel))
    with rec:
        out = fn(*args)
    return out, rec


@pytest.mark.parametrize("side", [64, 128])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_stages_read_nothing_back(path, side, monkeypatch):
    """For each config the graph takes: the inputs, the prep, the post and
    the pyramid decode make no data-dependent host read and, once the tables
    are cached, no upload; the encode and decode equal the public calls'."""
    cfg = _config(GRAPH_PATHS[path])
    assert encoder._replays(side, side, cfg, torch.device("cuda"))
    plane = torch.from_numpy(random_plane(side, 11))
    encoder._encode_arrays(torch.from_numpy(random_plane(side, 12)), cfg)  # the tables
    arrays, rec = _recorded(monkeypatch, encoder._encode_arrays, plane, cfg)
    assert (rec.reads, rec.uploads) == ([], []), path
    res = encoder._result(arrays, side, side, cfg)
    public = encoder.encode_plane(plane, cfg)
    for f in encoder.ARRAY_FIELDS:
        assert_bitwise(getattr(res, f), getattr(public, f), f)

    dcfg = DecoderConfig(pyramid=True)
    assert dec._has_pyramid(res, dcfg)
    dec._pyramid_decode(res, dcfg)  # the tables
    (img, mse), rec = _recorded(monkeypatch, dec._pyramid_decode, res, dcfg)
    assert (rec.reads, rec.uploads) == ([], []), path
    out, iters, mse_public = dec.decode_plane(res, dcfg)
    assert_bitwise(img, out)
    assert (iters, float(mse)) == (dcfg.pyramid_full_steps, mse_public)


def _routes(monkeypatch):
    """The routes classed_kernel is given, in order (a list it fills)."""
    routes = []
    kernel = tm.classed_kernel

    def spy(prep, *args, **kwargs):
        routes.append(prep["route"] if prep["route"] != "counted"
                      else ("counted", bool(prep["take_k2"])))
        return kernel(prep, *args, **kwargs)

    monkeypatch.setattr(tm, "classed_kernel", spy)
    return routes


@pytest.mark.parametrize("side", [64, 128])
def test_refused_config_reads_back(side, monkeypatch):
    """With PAIR_CAP patched to 4 the route counts the pair list from the
    class counts, on the device: the predicate takes the graph, and the
    encode reads nothing back and uploads nothing."""
    monkeypatch.setattr(mk, "PAIR_CAP", 4)
    cfg = EncoderConfig()
    assert encoder._replays(side, side, cfg, torch.device("cuda"))
    plane = torch.from_numpy(random_plane(side, 13))
    encoder._encode_arrays(plane, cfg)
    routes = _routes(monkeypatch)
    _, rec = _recorded(monkeypatch, encoder._encode_arrays, plane, cfg)
    assert routes == [("counted", True)]
    assert (rec.reads, rec.uploads) == ([], [])


@functools.lru_cache(maxsize=None)
def _jax_reference(kind):
    """The JAX package's encode of the counted tests' 64^2 plane on the CPU
    (its route there does not depend on the cap), and its decoded u8
    pixels: encode_plane and decode_plane, or the quadtree pair."""
    img = random_plane(64, 17)
    if kind == "grid":
        res = J.encode_plane(img, J.EncoderConfig())
        out, _, _ = J.decode_plane(res, J.DecoderConfig(pyramid=True))
        return img, res, np.asarray(out)
    import fractencode_tpu.encode.quadtree as jq

    res = jq.encode_plane_quadtree(img, J.EncoderConfig(), jq.QuadtreeConfig())
    out, _, _ = jq.decode_plane_quadtree(res, J.DecoderConfig(pyramid=True))
    return img, res, np.asarray(out)


@pytest.mark.parametrize("branch", ["k2", "k1"])
@pytest.mark.parametrize("kind", ["grid", "quadtree"])
def test_counted_route_matches_jax(kind, branch, monkeypatch):
    """With the cap just below the smallest search's n_pairs (every search
    takes K2) or at the largest (every one K1, its list still able to
    overflow): the stages read nothing back and upload nothing; the encode
    equals the static route's (the cap unpatched) bitwise, and the JAX
    package's on the CPU, bitwise but for s and o at the quadtree's 16 px
    level (K = 256: to test_torch_quadtree.py's tolerances, the parity
    contract); the decoded pixels equal the JAX package's bitwise."""
    from test_torch_quadtree import O_ATOL, O_RTOL, S_ATOL, S_RTOL

    from fractencode_tpu_torch.encode import quadtree as tq

    img, rj, out_j = _jax_reference(kind)
    plane = torch.from_numpy(img)
    cfg, qcfg = EncoderConfig(), tq.QuadtreeConfig()
    encode = ((lambda p: encoder._encode_arrays(p, cfg)) if kind == "grid"
              else (lambda p: tq._quadtree_arrays(p, cfg, qcfg)))
    static = encode(plane)
    prep = tm.classed_prep
    n_pairs = []
    monkeypatch.setattr(tm, "classed_prep", lambda *a, **k: (
        lambda out: n_pairs.append(int(out["n_pairs"])) or out)(prep(*a, **k)))
    monkeypatch.setattr(mk, "PAIR_CAP", 4)
    encode(plane)  # the tables, and each search's n_pairs
    monkeypatch.setattr(tm, "classed_prep", prep)
    monkeypatch.setattr(mk, "PAIR_CAP", min(n_pairs) - 1 if branch == "k2" else max(n_pairs))
    routes = _routes(monkeypatch)
    arrays, rec = _recorded(monkeypatch, encode, plane)
    assert routes == [("counted", branch == "k2")] * (1 if kind == "grid" else 3)
    assert (rec.reads, rec.uploads) == ([], [])
    for x, y in zip(arrays, static, strict=True):
        assert_bitwise(x, y, "the static route's encode")
    pyramid = DecoderConfig(pyramid=True)
    if kind == "grid":
        rt = encoder._result(arrays, 64, 64, cfg)
        pairs, fields = [(rj, rt)], ("domain_idx", "transform", "s", "o", "valid")
        out_t = dec.decode_plane(rt, pyramid)[0]
    else:
        rt = tq._levels(arrays, 64, 64, cfg, qcfg)
        pairs, fields = list(zip(rj.levels, rt.levels, strict=True)), (
            "domain_idx", "transform", "s", "o", "accepted")
        out_t = tq.decode_plane_quadtree(rt, pyramid)[0]
    tols = dict(s=(S_RTOL, S_ATOL), o=(O_RTOL, O_ATOL))
    for lj, lt in pairs:
        for f in fields:
            a, b = np.asarray(getattr(lj, f)), getattr(lt, f)
            if getattr(lt, "range_size", 0) == 16 and f in tols:
                np.testing.assert_allclose(b.numpy(), a, *tols[f], err_msg=f)
            else:
                assert_bitwise(a, b, f)
    assert_bitwise(out_j, out_t, "decoded pixels")


def test_flat_decode_reads_back(monkeypatch):
    """The flat loop carries its exit tests on the device: a chunk of steps
    reads nothing back, and the loop reads its exit flag once a chunk, then
    the iterations and the MSE once, at every chunk length."""
    res = encoder.encode_plane(random_plane(64, 14), EncoderConfig(), device="cpu")
    dcfg = DecoderConfig(max_iterations=5)
    assert not dec._has_pyramid(res, dcfg)
    dec._decode_core(res, dcfg)  # the tables
    for chunk in (1, 3):
        monkeypatch.setattr(dec, "_CHUNK", chunk)
        (_, iters, _), rec = _recorded(monkeypatch, dec._decode_core, res, dcfg)
        # the step that meets an exit runs but is not counted
        chunks = -(-min(iters + 1, dcfg.max_iterations) // chunk)
        assert rec.reads == [aten._local_scalar_dense.default] * (chunks + 2), chunk
        assert rec.uploads == []


def test_cpu_calls_take_no_graph():
    """CPU tensors run the eager forms and never reach utils.graphs."""
    before = dict(graphs.calls)
    cfg = EncoderConfig()
    planes = np.stack([random_plane(64, 15), random_plane(64, 16)])
    stacked = encoder.encode_batch_stacked(planes, cfg, device="cpu")
    dec.decode_batch_stacked(stacked, DecoderConfig(pyramid=True))
    dec.decode_plane(encoder.encode_plane(planes[0], cfg, device="cpu"),
                     DecoderConfig(pyramid=True))
    assert dict(graphs.calls) == before


# every table the encode and the pyramid decode read, by (build function, arguments)
TABLES = {
    "half_res_taps": (dec._half_res_taps, (16, 4, 128)),
    "half_origins": (codebook._half_origins, (uniform_grid(128, 128, 16, 8), 128)),
    "flat_origins": (Grid.flat_origins, (uniform_grid(120, 120, 12, 6), 120)),
    "block_offsets": (codebook._block_pixel_offsets, (12, 120)),
    "all_tap_tables": (all_tap_tables, (12, 6)),
    "pair_table": (classify._pair_table, ()),
    "bit_weights": (classify._bit_weights, ()),
    "order_code_table": (classify._order_code_table, ()),
    "grid_origins": (stats._grid_origins, (uniform_grid(96, 96, 6, 3),)),
    "patch_tap_idx": (dec._patch_tap_idx, (16, 4, 128)),
    "patch_positions": (dec._patch_positions, (16, 4, 128)),
    "global_tap_tables": (dec._global_tap_tables, (12, 6, 120)),
    "mean_offsets": (dec._mean_offsets, (4, 32)),
}


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", list(TABLES))
def test_device_table_cache(name, dtype):
    """Each cached table equals a fresh build, and a second call returns
    the same tensor (one upload for each build function, arguments, dtype and
    device)."""
    build, args = TABLES[name]
    t = device_table(build, *args, device="cpu", dtype=dtype)
    fresh = torch.as_tensor(np.asarray(build(*args)), dtype=dtype)
    assert t.dtype == dtype and torch.equal(t, fresh)
    again = device_table(build, *args, device=torch.device("cpu"), dtype=dtype)
    assert again is t and again.data_ptr() == t.data_ptr()


def test_device_table_cache_is_bounded():
    """The cache keeps the most recently used tables, up to its bound; a
    recorded block holds what it read after the cache drops it, and puts it
    back for the next block."""
    tables.clear()
    grids = [uniform_grid(16 * (i + 1), 16, 8, 4) for i in range(tables._MAX_TABLES + 1)]
    with tables.recorded() as read:
        first = device_table(stats._grid_origins, grids[0], device="cpu")
    for g in grids[1:]:
        device_table(stats._grid_origins, g, device="cpu")
    assert len(tables._TABLES) == tables._MAX_TABLES
    (key, held), = read.items()
    assert held is first and key not in tables._TABLES
    with tables.recorded(read) as again:
        assert device_table(stats._grid_origins, grids[0], device="cpu") is first
    assert again == read
    tables.clear()
    assert not tables._TABLES


class _StandInGraph:
    """torch.cuda.CUDAGraph's bookkeeping, for the CPU: replays and resets
    are counted, nothing runs."""

    def __init__(self):
        self.replays = self.resets = 0

    def replay(self):
        self.replays += 1

    def reset(self):
        self.resets += 1

    def pool(self):
        return None


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """utils.graphs with torch.cuda's graph capture stood in for (the
    captured function runs once for each graph, the plain one and its
    traced twin, as a capture traces it)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(mk.search_classed_cuda, "launches", collections.Counter())
    graphs.clear()
    yield
    graphs.clear()


def test_graph_forms_and_launches(stand_in_graphs):
    """The first call of a key runs eagerly and returns its own result; the
    second captures and replays; later ones replay.  A capture counts no
    launch, and each replay adds the launches its capture made, so each call
    counts one, also where the counts were cleared after the first; the
    graph keeps the tables its function read."""
    launches = mk.search_classed_cuda.launches
    grid = uniform_grid(32, 32, 8, 4)

    def fn(x):
        launches["k"] += 1
        return (x + device_table(stats._grid_origins, grid, device="cpu")[0][:1],)

    x = torch.arange(4.0)
    before = collections.Counter(graphs.calls)
    out = graphs.replay("f", ("cfg",), fn, x)
    assert torch.equal(out[0], x) and launches["k"] == 1
    assert graphs.calls - before == collections.Counter({("f", "eager"): 1})
    tables.clear()  # the table the capture reads comes back from the first call
    launches.clear()
    graphs.replay("f", ("cfg",), fn, x + 1)
    graphs.replay("f", ("cfg",), fn, x + 2)
    entry, = graphs._GRAPHS.values()
    assert launches["k"] == 2 and entry.graph.replays == 2
    assert torch.equal(entry.inputs[0], x + 2)
    assert graphs.calls - before == collections.Counter(
        {("f", "eager"): 1, ("f", "capture"): 1, ("f", "replay"): 2})
    (key, table), = entry.tables.items()
    assert tables._TABLES[key] is table
    graphs.replay("f", ("other",), fn, x)
    assert graphs.calls["f", "eager"] - before["f", "eager"] == 2


def test_graph_cache_is_bounded(stand_in_graphs):
    """Past the bound the least recently used graph is dropped and its
    memory pool freed (reset), and so are keys seen only once."""
    x = torch.zeros(2)
    kept = []
    for i in range(graphs._MAX_GRAPHS + 1):
        for _ in range(2):
            graphs.replay("f", (i,), lambda t: (t + 1,), x)
        kept.append(graphs._GRAPHS[next(reversed(graphs._GRAPHS))])
    assert len(graphs._GRAPHS) == graphs._MAX_GRAPHS
    assert kept[0].graph.resets == 1 and all(g.graph.resets == 0 for g in kept[1:])
    assert kept[0].twin[0].resets == 1 and all(g.twin[0].resets == 0 for g in kept[1:])
    for i in range(graphs._MAX_GRAPHS + 1):
        graphs.replay("g", (i,), lambda t: (t,), x)
    assert len(graphs._SEEN) == graphs._MAX_GRAPHS


@pytest.fixture
def recorded_marks(monkeypatch):
    """The device marks launched, in order: a recording stand-in for the
    mark launcher, which sees the marks of CPU tensors too."""
    seen = []
    monkeypatch.setattr(profiling, "_launch", lambda name, like: seen.append(name))
    return seen


def _cpu_profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_second_call_captures_a_traced_twin(stand_in_graphs, recorded_marks):
    """A key's second call captures the plain graph with the marks off and
    its twin with them on, from the same static inputs; a replay takes the
    twin only while a profiler records; the calls count one capture and a
    replay a call; clear() resets both graphs.  The eager first call
    launches its marks only while a profiler records."""
    fn = lambda t: (t + 1,)  # noqa: E731
    x = torch.arange(4.0)
    before = collections.Counter(graphs.calls)
    graphs.replay("f", ("a",), fn, x)
    assert recorded_marks == []
    with _cpu_profiler():
        graphs.replay("f", ("b",), fn, x)
    assert recorded_marks == ["begin", "end"]
    recorded_marks.clear()
    graphs.replay("f", ("a",), fn, x)
    assert recorded_marks == ["begin", "end"]  # the twin's capture alone
    entry = graphs._GRAPHS[next(iter(graphs._GRAPHS))]
    twin, twin_outputs = entry.twin
    assert twin is not entry.graph and twin_outputs is not entry.outputs
    assert (entry.graph.replays, twin.replays) == (1, 0)
    with _cpu_profiler():
        assert graphs.replay("f", ("a",), fn, x) is twin_outputs
    assert graphs.replay("f", ("a",), fn, x) is entry.outputs
    assert (entry.graph.replays, twin.replays) == (2, 1)
    assert graphs.calls - before == collections.Counter(
        {("f", "eager"): 2, ("f", "capture"): 1, ("f", "replay"): 3})
    assert recorded_marks == ["begin", "end"]  # a replay launches nothing itself
    graphs.clear()
    assert (entry.graph.resets, twin.resets) == (1, 1)


_BODY = ["inputs", "prep", "search", "post"]


@pytest.mark.parametrize("form, marks", [
    ("grid", ["begin", *_BODY, "end"]),
    ("dense", ["begin", *_BODY, "end"]),
    ("quadtree", ["begin", *_BODY * 3, "end"]),
])
def test_twin_marks_each_stage_in_order(form, marks, stand_in_graphs, recorded_marks):
    """The traced twin of a grid frame (classed or dense) marks its body's
    begin, the four stages' starts and its end; a quadtree frame of three
    levels marks the four stages of each; the eager call and the plain
    capture mark nothing."""
    plane = torch.from_numpy(random_plane(64, 9))
    cfg = EncoderConfig(use_classifier=form != "dense")
    if form == "quadtree":
        run = lambda: quadtree._frame_levels(plane, cfg, quadtree.QuadtreeConfig(), True)  # noqa: E731
    else:
        run = lambda: encoder._frame_arrays(plane, cfg, True)  # noqa: E731
    run()
    assert recorded_marks == []
    run()
    assert recorded_marks == marks
