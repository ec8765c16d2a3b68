"""The traced window: torch.profiler (CUPTI) over whole requests, reduced to
device intervals and host ops, and the context the per-layer readers
(``metrics/``) take their numbers from.

Device operations are kernels (those inside CUDA graph replays included),
memcpys and memsets.  The window is the span of a host annotation around the
requests; the device is busy where the union of its operations' intervals
covers it (``arith.union_seconds``), never by summing durations, which
counts overlapping work twice.
"""
from __future__ import annotations

import collections
import dataclasses
import re

from . import arith

WINDOW = "codec_bench.window"
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
# the program's search kernels (K1, K2 and its reduce, K3)
SEARCH = re.compile(r"search_classed_kernel|search_classed2d_kernel|classed2d_reduce_kernel"
                    r"|search_dense_kernel")


def short(name: str) -> str:
    """A device op's name without its return type and parameter list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:120].strip()


@dataclasses.dataclass
class Trace:
    device: list  # (name, kind, begin s, end s)
    host: list  # (name, begin s, end s), the window's thread
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return arith.union_seconds(((b, e) for _, _, b, e in self.device), self.start, self.end)

    def seconds(self, keep) -> float:
        """Summed seconds of the device ops ``keep(name, kind)`` selects."""
        return sum(e - b for name, kind, b, e in self.device if keep(name, kind))

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, by name, and the idle time by
        the host op that was running (the innermost one open at each gap's
        middle), each the ``top`` largest, in seconds."""
        ops = collections.Counter()
        for name, _, b, e in self.device:
            ops[short(name)] += e - b
        idle = collections.Counter()
        spans = sorted(self.host, key=lambda x: (x[1], -x[2]))
        stack, i = [], 0
        for b, e in arith.gaps(((b, e) for _, _, b, e in self.device), self.start, self.end):
            mid = (b + e) / 2
            while i < len(spans) and spans[i][1] <= mid:
                while stack and stack[-1][2] <= spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            idle[stack[-1][0] if stack else "(no host op)"] += e - b
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}


def capture(loop):
    """Run ``loop()`` (whole requests, each ending on the host) under
    torch.profiler; returns (its result, the Trace of the window)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = loop()
    return out, reduce(prof.profiler.kineto_results.events())


def _kind(e) -> str:
    """The event's kineto activity type, or where the event does not give
    it (older torch), its reading from the device and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    annotation = e.name() == WINDOW or (hasattr(e, "is_user_annotation")
                                        and e.is_user_annotation())
    if str(e.device_type()).endswith("CPU"):
        return "user_annotation" if annotation else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def reduce(events) -> Trace:
    """A Trace from kineto events (``name()``, ``activity_type()`` or
    ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``start_thread_id()``)."""
    win = next(e for e in events if e.name() == WINDOW and _kind(e) == "user_annotation")
    t0, thread = win.start_ns(), win.start_thread_id()
    start, end = 0.0, win.duration_ns() * 1e-9
    device, host = [], []
    for e in events:
        kind = _kind(e)
        b = (e.start_ns() - t0) * 1e-9
        span = (b, b + e.duration_ns() * 1e-9)
        if kind in _DEVICE:
            device.append((e.name(), kind, *span))
        elif kind in _HOST and e is not win and e.start_thread_id() == thread:
            host.append((e.name(), *span))
    return Trace(device=device, host=host, start=start, end=end)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window of a run of one
    cell and the benchmark's own counts over it."""

    kind: str  # the entry's kind: "encode" or "decode"
    trace: Trace
    requests: int
    mpix: float  # megapixels of the requests in the window
    calls: collections.Counter  # utils.graphs.calls over the window
    syncs: int  # host syncs over the window (torch's sync debug mode)
    search_bound_s: float  # the least seconds of the window's searches (0: none)

    def ms_per_mpix(self, keep) -> float | None:
        t = self.trace.seconds(keep)
        return 1e3 * t / self.mpix if self.mpix > 0 and t > 0 else None

    def idle_share(self) -> float | None:
        w = self.trace.window_s
        return 1.0 - self.trace.busy_s() / w if w > 0 and self.trace.device else None

    def replay_share(self) -> float | None:
        total = sum(self.calls.values())
        replays = sum(v for (_, form), v in self.calls.items() if form == "replay")
        return replays / total if total else None


def is_search(name: str, kind: str) -> bool:
    return kind == "kernel" and bool(SEARCH.search(name))


def is_host_copy(name: str, kind: str) -> bool:
    return kind == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name)
