"""CUDA graphs over the encode and the decode: the port's counterpart of the
JAX package's jitted programs (``encode_plane``, ``encode_batch_stacked``,
the quadtree pyramid, ``decode_plane``, ``decode_batch_stacked``,
``decode_plane_quadtree``), each one device program, of its
``lax.while_loop`` (``while_loop``: the flat decode, the k-means), and of
the program ``shard_map`` runs on every device (``parallel.sharded``: a
graph for each step, whatever the shard, its index an input).

``replay`` runs a function of CUDA tensors eagerly at the first call of a
key (the function's name, its configuration and geometry, and its inputs'
shapes, dtypes and device), captures it at the second and replays it from
then on.  Its callers decide whether a call
goes through here from the shape, the configuration, the backend and the
device alone, before any work (``encode.matcher.replays_graph``: every
classed and dense search of rows and columns on the card, the route the
class counts decide included; ``decode.decoder``): a function captured
here makes no read back to the host, and its tables are on the device
(``utils.tables``).  A capture that fails raises; nothing falls back to the
eager form.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from . import profiling, tables

__all__ = ["replay", "while_loop", "calls", "clear"]

# graphs kept at once, and keys seen once and not yet captured; the least
# recently used is dropped, a graph's memory pool with it
_MAX_GRAPHS = 16

# calls by (name, "eager", "capture" or "replay"): which form each call took
# (a capturing call replays too)
calls: collections.Counter = collections.Counter()


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # static inputs, filled before each replay
    outputs: tuple  # static outputs, in the graph's memory pool
    launches: tuple  # (counter dict, key, launches) the capture recorded
    tables: dict  # the device tables the graph reads, kept alive with it
    # (graph, outputs) of the traced twin: the same body from the same
    # inputs with the device marks on (utils.profiling), replayed while a
    # profiler records
    twin: tuple


_GRAPHS: collections.OrderedDict = collections.OrderedDict()
# key -> the device tables its eager first call read
_SEEN: collections.OrderedDict = collections.OrderedDict()


def _counters():
    """The kernel wrappers' launch counters, which count a replay's
    launches as an eager call's."""
    from ..ops import decode_kernels as dk
    from ..ops import matcher_kernels as mk

    return (mk.search_classed_cuda.launches, mk.search_classed2d_cuda.launches,
            mk.search_dense_cuda.launches, dk.decode_step_cuda.launches)


def _body(fn, inputs) -> tuple:
    """``fn(*inputs)`` between the ``begin`` and ``end`` marks."""
    profiling.mark("begin", inputs[0])
    out = tuple(fn(*inputs))
    profiling.mark("end", inputs[0])
    return out


@contextlib.contextmanager
def _launches_taken_back():
    """The kernel wrappers' launches counted inside the block, taken back
    from their counters and listed as (counter, key, launches) in the
    list the block gets."""
    counters = _counters()
    before = [dict(c) for c in counters]
    taken = []
    try:
        yield taken
    finally:
        taken += [(c, k, n - b.get(k, 0)) for c, b in zip(counters, before)
                  for k, n in c.items() if n != b.get(k, 0)]
        for c, k, n in taken:
            c[k] -= n


def _capture(fn, inputs, used: dict) -> _Graph:
    """Capture ``fn`` on static copies of ``inputs``' layout (torch.cuda.
    graph: a side stream, the graph's own memory pool), the tables ``used``
    by its eager run back in their cache, twice: the plain graph with the
    device marks off, and its traced twin with them on, from the same
    static inputs and in the same memory pool.  The kernel wrappers count
    their launches while they are captured; those counts are taken back,
    and the plain capture's kept for the replays."""
    static = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                   for x in inputs)
    device = static[0].device
    profiling.load_marks(device)
    graph, twin = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with tables.recorded(used) as read, torch.cuda.device(device):
        with (_launches_taken_back() as launches, profiling.forced_marks(False),
              torch.cuda.graph(graph)):
            outputs = _body(fn, static)
        with (_launches_taken_back(), profiling.forced_marks(True),
              torch.cuda.graph(twin, pool=graph.pool())):
            twin_outputs = _body(fn, static)
    return _Graph(graph, static, outputs, tuple(launches), read, (twin, twin_outputs))


def replay(name: str, statics: tuple, fn, *inputs) -> tuple:
    """``fn(*inputs)``, a tuple of CUDA tensors from CUDA tensors, through
    the graph of (``name``, ``statics``, the inputs' shapes, dtypes and
    device); ``statics`` holds everything else ``fn``'s work depends on.

    The first call of a key runs ``fn`` eagerly on the current stream and
    returns its result, so a caller that calls once pays for no capture; that
    run builds and loads the kernels and uploads the tables, the capture's
    warm-up.  The second call captures the graph; it and every later call
    copy ``inputs`` into the graph's static inputs and replay it on the
    current stream: the traced twin while a profiler records, else the
    plain graph (``_capture``).  ``fn``'s body runs between the ``begin``
    and ``end`` marks (``utils.profiling``: launched in the twin, and in the
    eager call while a profiler records).  A replay's result is the graph's
    own outputs, which the next call of the key overwrites, so callers copy
    them out."""
    key = (name, statics, tuple((x.shape, x.dtype, x.device) for x in inputs))
    entry = _GRAPHS.get(key)
    if entry is None:
        used = _SEEN.pop(key, None)
        if used is None:
            with tables.recorded() as used:
                out = _body(fn, inputs)
            _SEEN[key] = used
            _drop(_SEEN)
            calls[name, "eager"] += 1
            return out
        entry = _GRAPHS[key] = _capture(fn, inputs, used)
        _drop(_GRAPHS)
        calls[name, "capture"] += 1
    _GRAPHS.move_to_end(key)
    graph, outputs = entry.twin if profiling.recording() else (entry.graph, entry.outputs)
    with profiling.span("fractencode.replay"):
        for static, x in zip(entry.inputs, inputs):
            static.copy_(x)
        graph.replay()
    for counter, k, n in entry.launches:
        counter[k] += n
    calls[name, "replay"] += 1
    return outputs


def while_loop(name: str, statics: tuple, make_body, cond, consts: tuple, carry: tuple,
               *, graph: bool, chunk: int) -> tuple:
    """The counterpart of ``lax.while_loop``: ``carry`` (a tuple of tensors)
    advanced by ``make_body(*consts)(carry)`` while ``cond(carry)`` (a 0-d
    bool tensor) holds.  Steps run in chunks of ``chunk``, each guarded by
    ``cond``: a step taken after the loop has ended leaves the carry as it
    was, so the result is the loop's whatever the chunk length.  The host
    reads ``cond`` once a chunk.  With ``graph`` each chunk replays one CUDA
    graph per (``name``, ``statics``, chunk, shapes) (``replay``; a chunk's
    outputs are copied into the graph's inputs for the next); without, it
    runs eagerly.  Returns the final carry (a graph's own outputs with
    ``graph``, overwritten by the key's next call)."""
    n = len(consts)

    def run(*tensors):
        body, state = make_body(*tensors[:n]), tensors[n:]
        for _ in range(chunk):
            go = cond(state)
            state = tuple(torch.where(go, new, old) for new, old in zip(body(state), state))
        return (*state, cond(state))

    while True:
        out = (replay(name, (*statics, chunk), run, *consts, *carry) if graph
               else run(*consts, *carry))
        carry = out[:-1]
        if not out[-1].item():
            return carry


def _drop(cache: collections.OrderedDict, keep: int = _MAX_GRAPHS) -> None:
    """Drop ``cache``'s least recently used entries past ``keep``, each
    graph and its twin with their memory pool."""
    while len(cache) > keep:
        entry = cache.popitem(last=False)[1]
        if isinstance(entry, _Graph):
            entry.graph.reset()
            entry.twin[0].reset()


def clear() -> None:
    """Drop every graph and its memory pool, the keys seen once, and the
    device tables (``utils.tables``)."""
    _drop(_GRAPHS, 0)
    _SEEN.clear()
    tables.clear()
