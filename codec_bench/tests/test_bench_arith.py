"""The benchmark's frozen arithmetic on hand-made numbers and trace events:
the peaks, a search's bound and needed pairs, the union of device intervals
(overlapping and adjacent kernels, an idle gap, kernels inside a graph
replay) and the per-layer readers over them."""
from __future__ import annotations

import collections

import pytest
import torch

from codec_bench import arith, trace
from codec_bench.harness import ROOT, _reader


class Ev:
    """A kineto event as ``trace.reduce`` reads it (times in microseconds)."""

    def __init__(self, name, kind, start_us, dur_us, thread=1):
        self._n, self._k, self._s, self._d, self._t = name, kind, start_us, dur_us, thread

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def start_thread_id(self):
        return self._t


K1 = "void search_classed_kernel<16, (Key)0, false>(int const*, signed char const*)"


def _events():
    """A 1000 us window: a graph replay (two kernels inside it, overlapping),
    an adjacent pair, a memcpy each way, and idle gaps under a sync and
    under no op at all."""
    return [
        Ev(trace.WINDOW, "user_annotation", 0, 1000),
        Ev("aten::copy_", "cpu_op", 0, 100),
        Ev("cudaMemcpyAsync", "cuda_runtime", 10, 80),
        Ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 60),
        Ev("cudaGraphLaunch", "cuda_runtime", 100, 20),
        Ev(K1, "kernel", 130, 300),  # [130, 430]
        Ev("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)", "kernel",
           400, 100),  # [400, 500]: overlaps K1
        Ev("void classed2d_reduce_kernel(float const*)", "kernel", 500, 50),  # adjacent
        Ev("aten::item", "cpu_op", 560, 300),
        Ev("cudaStreamSynchronize", "cuda_runtime", 570, 280),
        Ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 850, 40),  # [850, 890]
        Ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 900, 10),
        Ev("aten::add", "cpu_op", 920, 5, thread=2),  # another thread: not the host's
    ]


def test_peaks_and_bound():
    assert arith.PEAK_INT8_OPS == 1979e12 and arith.PEAK_BYTES == 3.35e12
    assert arith.search_bytes(10, 20, 16, False) == 10 * 24 + 20 * 40
    assert arith.search_bytes(10, 20, 16, True, masked=True) == 10 * 36 + 20 * 44
    ops = 2 * 16 * 1_000_000 / 1979e12
    assert arith.bound_s(1_000_000, 16, 1000) == pytest.approx(ops)
    assert arith.bound_s(1, 16, 3.35e9) == pytest.approx(1e-3)


def test_needed_pairs():
    r = torch.tensor([-1, 0, 0, 5, 2])
    c = torch.tensor([0, 0, 0, -1, 5, 5, 3])
    assert arith.needed_pairs(r, c) == 1 * 1 + 2 * 3 + 1 * 2


def test_union_and_gaps():
    iv = [(0.1, 0.3), (0.2, 0.4), (0.4, 0.5), (0.7, 0.8), (1.2, 1.5)]
    assert arith.union_seconds(iv, 0.0, 1.0) == pytest.approx(0.5)
    got = arith.gaps(iv, 0.0, 1.0)
    assert [tuple(round(x, 9) for x in g) for g in got] == [(0.0, 0.1), (0.5, 0.7), (0.8, 1.0)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_trace_reduce_and_breakdown():
    tr = trace.reduce(_events())
    assert tr.window_s == pytest.approx(1e-3)
    assert len(tr.device) == 6 and len(tr.host) == 5
    # busy: [20, 80] + [130, 550] + [850, 890] + [900, 910]
    assert tr.busy_s() == pytest.approx((60 + 420 + 40 + 10) * 1e-6)
    assert tr.seconds(trace.is_search) == pytest.approx(350e-6)
    assert tr.seconds(trace.is_host_copy) == pytest.approx(100e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["search_classed_kernel<16, (Key)0, false>", pytest.approx(3e-4)]
    idle = dict(b["idle_gaps"])
    # [0, 20] under the memcpy call inside aten::copy_, [80, 130] under the
    # graph launch, [550, 850] under the sync inside aten::item, [890, 900]
    # and [910, 1000] under no op
    assert idle == {"cudaMemcpyAsync": pytest.approx(20e-6),
                    "cudaGraphLaunch": pytest.approx(50e-6),
                    "cudaStreamSynchronize": pytest.approx(300e-6),
                    "(no host op)": pytest.approx(100e-6)}
    assert sum(idle.values()) == pytest.approx(1e-3 - tr.busy_s())


def _ctx(kind="encode", calls=None, bound=175e-6):
    return trace.Context(kind=kind, trace=trace.reduce(_events()), requests=2, mpix=0.5,
                         calls=collections.Counter(calls or {("encode_plane", "replay"): 3,
                                                             ("encode_plane", "eager"): 1}),
                         syncs=5, search_bound_s=bound)


def _read(name, ctx):
    return _reader(ROOT / "metrics" / f"{name}.py")(ctx)


def test_readers():
    ctx = _ctx()
    assert _read("search_roofline.encode", ctx) == pytest.approx(50.0)
    assert _read("stage_ms_per_mpix.encode", ctx) == pytest.approx(2 * 0.1)
    assert _read("copy_ms_per_mpix.encode", ctx) == pytest.approx(2 * 0.1)
    assert _read("graph_replay_share.encode", ctx) == pytest.approx(0.75)
    assert _read("host_syncs_per_req.encode", ctx) == pytest.approx(2.5)
    assert _read("device_idle.encode", ctx) == pytest.approx(0.47)
    for name in ("decode_ms_per_mpix.decode", "graph_replay_share.decode",
                 "device_idle.decode"):
        assert _read(name, ctx) is None
    dec = _ctx("decode")
    assert _read("decode_ms_per_mpix.decode", dec) == pytest.approx(2 * 0.45)
    assert _read("device_idle.decode", dec) == pytest.approx(0.47)
    assert _read("search_roofline.encode", dec) is None


def test_readers_find_nothing_and_say_so():
    empty = trace.Context(kind="encode", trace=trace.Trace([], [], 0.0, 1.0), requests=1,
                          mpix=1.0, calls=collections.Counter(), syncs=0, search_bound_s=0.0)
    for name in ("search_roofline.encode", "stage_ms_per_mpix.encode",
                 "copy_ms_per_mpix.encode", "graph_replay_share.encode", "device_idle.encode"):
        assert _read(name, empty) is None
