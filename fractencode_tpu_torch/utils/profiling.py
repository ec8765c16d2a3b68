"""Timing and tracing (port of ``fractencode_tpu/utils/profiling.py``).

The reference has a wall-clock ``Frac::Timer`` around encode/decode
(``utils/timer.h:7-21``, printed by ``main.cpp:164-178``) and nothing else.
Here: a phase-timing struct for per-stage numbers, and a ``torch.profiler``
trace context for device profiles (the JAX package's is ``jax.profiler``).

Tracing is on exactly while a ``torch.profiler`` profile records (``--profile``,
``device_trace``, or a caller's own profiler); off, a span or a mark costs one
flag check.  A trace then shows, in one timeline (kineto aligns the host's
clock with the device's only to about a millisecond, so a device op is put
down to a stage by the marks around it on the device, not by host spans):

* host spans (``record_function`` ranges): ``fractencode.<entry>`` around
  each call of ``encode_plane``, ``encode_batch_stacked``,
  ``encode_plane_quadtree``, ``encode_batch_quadtree_stacked``,
  ``decode_plane`` and ``decode_batch_stacked``; ``fractencode.upload``
  around the plane's copy to the device (``encoder.plane_on_device``);
  ``fractencode.replay`` around a graph's input fill and replay
  (``graphs.replay``); ``fractencode.phase.<name>`` around each
  ``PhaseTimer`` phase;
* device marks, empty one-thread kernels named ``fractencode_mark_<m>``
  (``csrc/search_classed.cu``): ``begin`` and ``end`` around every graph
  body (``graphs.replay``), and ``inputs``, ``prep``, ``search`` and
  ``post`` where each encode stage starts, a stage running until the next
  mark.  Graphs hold them in a traced twin that replays only while a
  profiler records (``graphs._capture``), so the graphs run untraced hold
  none.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import time

import torch
from torch.profiler import record_function

__all__ = ["PhaseTimer", "device_trace"]

# the device marks, in csrc/search_classed.cu's order
MARKS = ("begin", "end", "inputs", "prep", "search", "post")

# marks forced on (a traced twin's capture) or off (a plain capture); None:
# on while a profiler records
_forced_marks: bool | None = None


def recording() -> bool:
    """Whether a ``torch.profiler`` profile records on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A host range named ``name`` in the trace while a profiler records."""
    return record_function(name) if recording() else contextlib.nullcontext()


def entry_span(fn):
    """``fn`` inside the host range ``fractencode.<its name>`` while a
    profiler records: the root span of a request."""
    name = f"fractencode.{fn.__name__}"

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not recording():
            return fn(*args, **kwargs)
        with record_function(name):
            return fn(*args, **kwargs)

    return call


def mark(name: str, like: torch.Tensor) -> None:
    """Launch the device mark ``name`` (one of ``MARKS``) on the current
    stream of ``like``'s device, where marks are on: while a profiler
    records, or in a traced twin's capture (``forced_marks``)."""
    if recording() if _forced_marks is None else _forced_marks:
        _launch(name, like)


@contextlib.contextmanager
def forced_marks(on: bool):
    """Marks on (or off) whatever the profiler does, inside the block."""
    global _forced_marks
    was, _forced_marks = _forced_marks, on
    try:
        yield
    finally:
        _forced_marks = was


def _launch(name: str, like: torch.Tensor) -> None:
    """The mark kernel's launch; marks launch only on CUDA tensors."""
    if like.device.type != "cuda":
        return
    with torch.cuda.device(like.device):
        err = _marks().fe_mark(MARKS.index(name), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mark {name} failed to launch: CUDA error {err}")


def load_marks(device) -> None:
    """Load the mark kernels on ``device`` (a CUDA one; else nothing), ahead
    of a capture that launches them."""
    if torch.device(device).type != "cuda":
        return
    with torch.cuda.device(device):
        err = _marks().fe_mark_load()
    if err != 0:
        raise RuntimeError(f"the mark kernels failed to load: CUDA error {err}")


@functools.cache
def _marks() -> ctypes.CDLL:
    """The library that holds the marks: K1's, built on first use.  The
    marks take no build of their own there, but every graph capture loads
    them (``graphs._capture``), so a decode's first capture builds K1's
    library too, and fails where it fails to build."""
    from ..ops._build import load_library

    lib = load_library("search_classed")
    lib.fe_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.fe_mark.restype = ctypes.c_int
    lib.fe_mark_load.argtypes = []
    lib.fe_mark_load.restype = ctypes.c_int
    return lib


class PhaseTimer:
    """Accumulates named wall-clock phases; synchronize the device on the
    phase's outputs before exiting the context for honest device timings.
    Each phase is the host span ``fractencode.phase.<name>`` in a trace."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"fractencode.phase.{name}"):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v * 1e3:.2f} ms" for k, v in self.phases.items()]
        lines.append(f"total: {total * 1e3:.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device):
    """``torch.profiler`` trace of the block, written into ``log_dir`` as a
    Chrome/TensorBoard trace (``*.pt.trace.json``): host activity and the
    port's spans, plus the card's kernels and marks when ``device`` is a
    CUDA device."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()
