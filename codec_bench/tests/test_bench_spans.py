"""The readers of the port's marks on a hand-built trace with known
intervals: two graph bodies with their stage marks (a stage that holds no
op among them), work outside the bodies, host copies each way, idle gaps
that ops in a body, the upload, the copy back and the entries' own work
end, and host spans the idle reader does not read; and on the toy cells,
where the CPU runs no device op."""
from __future__ import annotations

import collections

import pytest
import torch

from codec_bench import run, trace
from codec_bench.harness import ROOT, _reader

NEW = ("inputs_ms_per_mpix.encode", "prep_ms_per_mpix.encode", "post_ms_per_mpix.encode",
       "glue_ms_per_mpix.encode", "launch_idle_share.encode")
K1 = "void (anonymous namespace)::search_classed_kernel<16, 0, 0, false>(int const*)"


def _us(*ops):
    """Device ops as (name, kind, begin s, end s) from (name, kind, begin us, end us)."""
    return [(n, k, b * 1e-6, e * 1e-6) for n, k, b, e in ops]


def _mark(name, at):
    return (f"fractencode_mark_{name}", "kernel", at, at + 1)


def _device():
    """A 1000 us window: the upload, two graph bodies, glue between them and
    the caller's copy back."""
    return _us(
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40, 90),
        _mark("begin", 210),
        ("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 211, 231),  # inputs
        _mark("inputs", 231),
        ("void at::native::tensor_kernel_scan_outer_dim<int>(int*)", "kernel", 232, 262),
        _mark("prep", 262),
        ("void at::native::tensor_kernel_scan_innermost_dim<int>(int*)", "kernel", 263, 283),
        _mark("search", 283),
        (K1, "kernel", 284, 384),
        ("void at::native::reduce_kernel<512, 1>(float)", "kernel", 384, 386),  # search stage
        _mark("post", 386),
        ("void at::native::index_kernel(float)", "kernel", 387, 417),  # post
        _mark("end", 417),
        ("void at::native::direct_copy_kernel(int)", "kernel", 420, 430),  # glue: a row copy
        _mark("begin", 510),
        ("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 511, 521),  # inputs
        _mark("prep", 521),  # a prep stage that holds no op
        _mark("search", 522),
        (K1, "kernel", 523, 573),
        _mark("post", 573),
        ("void at::native::index_kernel(float)", "kernel", 574, 584),  # post
        _mark("end", 584),
        ("void at::native::direct_copy_kernel(int)", "kernel", 590, 600),  # glue: a clone
        ("Memset (Device)", "gpu_memset", 600, 605),  # glue
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 610, 620),  # glue
        ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 850, 900),  # the caller's copy back
    )


def _host():
    return [(n, b * 1e-6, e * 1e-6) for n, b, e in (
        ("fractencode.encode_batch_stacked", 0, 800),
        ("fractencode.upload", 10, 100),
        ("aten::copy_", 20, 95),
        ("fractencode.replay", 150, 200),
        ("cudaGraphLaunch", 160, 190),
        ("fractencode.replay", 450, 500),
        ("aten::copy_", 840, 905),
    )]


def _ctx(device=None, host=None, kind="encode"):
    tr = trace.Trace(device=_device() if device is None else device,
                     host=_host() if host is None else host, start=0.0, end=1e-3)
    return trace.Context(kind=kind, trace=tr, requests=2, mpix=0.5,
                         calls=collections.Counter({("encode_plane", "replay"): 2}),
                         syncs=0, search_bound_s=0.0)


def _read(name, ctx):
    return _reader(ROOT / "metrics" / f"{name}.py")(ctx)


def test_stage_and_glue_readers():
    ctx = _ctx()
    # inputs 20 + 30 + 10 us, prep 20 + 0, post 30 + 10, glue 10 + 10 + 5 + 10,
    # over 0.5 Mpix
    assert _read("inputs_ms_per_mpix.encode", ctx) == pytest.approx(1e3 * 60e-6 / 0.5)
    assert _read("prep_ms_per_mpix.encode", ctx) == pytest.approx(1e3 * 20e-6 / 0.5)
    assert _read("post_ms_per_mpix.encode", ctx) == pytest.approx(1e3 * 40e-6 / 0.5)
    assert _read("glue_ms_per_mpix.encode", ctx) == pytest.approx(1e3 * 35e-6 / 0.5)


def test_the_stages_glue_and_copies_account_for_every_op():
    """inputs + prep + post + the search stage + glue + host copies: all the
    device time but the marks'."""
    ctx = _ctx()
    stages = _reader(ROOT / "metrics" / "glue_ms_per_mpix.encode.py").__globals__
    by_stage = collections.Counter()
    for stage, t in stages["stage_seconds"](ctx.trace.device):
        by_stage[stage] += t
    assert by_stage["search"] == pytest.approx(152e-6)
    marks = ctx.trace.seconds(lambda name, kind: name.startswith("fractencode_mark_"))
    copies = ctx.trace.seconds(trace.is_host_copy)
    total = ctx.trace.seconds(lambda name, kind: True)
    assert sum(by_stage.values()) + copies == pytest.approx(total - marks)


LAUNCH = "launch_idle_share.encode"


def test_launch_idle_reader():
    """Each gap goes to the op that ends it, on the device's clock: the
    host spans, moved by 0.8 ms or left out, change nothing."""
    ctx = _ctx()
    # idle: [0, 40] [90, 210] [418, 420] [430, 510] [585, 590] [605, 610]
    # [620, 850] [900, 1000]
    assert ctx.idle_share() == pytest.approx(0.582)
    launch = _read(LAUNCH, ctx)
    assert launch == pytest.approx(0.2)  # [90, 210] and [430, 510], before each begin
    assert launch <= ctx.idle_share()
    moved = _ctx(host=[(n, b + 8e-4, e + 8e-4) for n, b, e in _host()])
    assert _read(LAUNCH, moved) == launch
    assert _read(LAUNCH, _ctx(host=[])) == launch


def test_launch_idle_reader_takes_copies_in_a_body():
    """A gap that an op of a graph body ends is the launch's, host copies
    and the body's own gaps included; a gap that an op outside the bodies
    ends (an upload, a copy back, a clone) is not."""
    device = _us(
        _mark("begin", 10),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 30),
        ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 40, 50),
        _mark("end", 50),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60, 70),
        ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 100, 110),
        ("void at::native::direct_copy_kernel(int)", "kernel", 105, 140),  # overlaps
    )
    ctx = _ctx(device=device)
    # idle: [0, 10] [11, 20] [30, 40] [51, 60] [70, 100] [140, 1000], the last
    # ended by no op
    assert _read(LAUNCH, ctx) == pytest.approx(0.029)


def test_readers_find_nothing_and_say_so():
    no_marks = _ctx(device=[op for op in _device() if "fractencode_mark" not in op[0]])
    no_device = _ctx(device=[])
    for name in NEW:
        assert _read(name, _ctx(kind="decode")) is None, name
        assert _read(name, no_device) is None, name
        assert _read(name, no_marks) is None, name
    # a trace with no prep stage holds no prep mark
    no_prep = _ctx(device=[op for op in _device() if op[0] != "fractencode_mark_prep"])
    assert _read("prep_ms_per_mpix.encode", no_prep) is None


@pytest.mark.parametrize("traffic", ["enc", "batch", "qt"])
def test_readers_give_nothing_on_the_cpu(toy_cell, traffic):
    """On the CPU no device op and no mark is there: the new readers give
    no value, and the run leaves them out."""
    cell = toy_cell(traffic)
    assert set(NEW) <= set(cell.readers)
    result, _, _ = run.measure(cell, 2**31 + 23, 0.2, 1, torch.device("cpu"))
    assert result["correct"]
    assert not set(NEW) & set(result["metrics"]), result["metrics"]
