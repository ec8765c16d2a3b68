"""The port's tracing switch, on the CPU (``utils.profiling``): with no
profiler recording, the entries open no host span and launch no device
mark; under one, a request's spans nest in its entry's span; and the names
the port gives its marks are the ones the benchmark's readers
(``codec_bench/metrics/``) look for.  The marks in a CUDA trace:
tests/test_torch_cuda.py."""
import re
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler
import torch.profiler
from torch.profiler import ProfilerActivity, profile

from _torch_parity import random_plane

import fractencode_tpu_torch as T
from fractencode_tpu_torch.decode import decoder
from fractencode_tpu_torch.encode import encoder, quadtree
from fractencode_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
METRICS = ROOT / "codec_bench" / "metrics"
ENTRIES = (encoder.encode_plane, encoder.encode_batch_stacked,
           quadtree.encode_plane_quadtree, quadtree.encode_batch_quadtree_stacked,
           decoder.decode_plane, decoder.decode_batch_stacked)


def _planes(n=2):
    return torch.from_numpy(random_plane(32, 3)).expand(n, 32, 32).contiguous().numpy()


def _requests():
    """One call of each entry on the CPU (the quadtree's 8 and 4 px levels
    fit a 32^2 plane)."""
    planes = _planes()
    T.encode_plane(planes[0], device="cpu")
    res = T.encode_batch_stacked(planes, device="cpu")
    qcfg = quadtree.QuadtreeConfig(max_size=8)
    quadtree.encode_plane_quadtree(planes[0], qcfg=qcfg, device="cpu")
    quadtree.encode_batch_quadtree_stacked(planes, qcfg=qcfg, device="cpu")
    dcfg = T.DecoderConfig(pyramid=True)
    T.decode_batch_stacked(res, dcfg)
    T.decode_plane(T.encode_plane(planes[0], device="cpu"), dcfg)


def test_profiler_off_opens_no_span_and_launches_no_mark(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("traced with no profiler recording")

    for module in (profiling, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(module, "record_function", refuse)
    monkeypatch.setattr(profiling, "_launch", refuse)
    assert not profiling.recording()
    _requests()


def test_upload_nests_in_the_entry_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.encode_batch_stacked(_planes(), device="cpu")
    spans = [e for e in prof.events() if e.name.startswith("fractencode.")]
    assert [e.name for e in spans] == ["fractencode.encode_batch_stacked",
                                       "fractencode.upload"]
    assert spans[1].cpu_parent is spans[0]


def test_every_entry_opens_its_span(monkeypatch):
    """Each entry opens ``fractencode.<its name>`` while a profiler records
    (the root span of a request; entries that call entries nest)."""
    seen = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: seen.append(name) or torch.profiler.record_function(name))
    with profile(activities=[ProfilerActivity.CPU]):
        _requests()
    for fn in ENTRIES:
        assert fn.__wrapped__.__name__ == fn.__name__
        assert f"fractencode.{fn.__name__}" in seen


def test_span_and_mark_names_match_the_readers():
    """Each mark the port emits is named, letter for letter, in the
    benchmark readers that read it and in the mark kernels' source; the host
    spans are named where the port opens them."""
    text = {p.name.removesuffix(".encode.py"): p.read_text()
            for p in METRICS.glob("*.encode.py")}
    source = (ROOT / "fractencode_tpu_torch" / "csrc" / "search_classed.cu").read_text()
    kernels = re.findall(r'extern "C" __global__ void (fractencode_mark_\w+)\(\)', source)
    assert kernels == [f"fractencode_mark_{m}" for m in profiling.MARKS]
    for reader in ("inputs_ms_per_mpix", "prep_ms_per_mpix", "post_ms_per_mpix",
                   "glue_ms_per_mpix"):
        for name in kernels:
            assert f'"{name}"' in text[reader], (reader, name)
    for name in ("fractencode_mark_begin", "fractencode_mark_end"):
        assert f'"{name}"' in text["launch_idle_share"], name
    port = ROOT / "fractencode_tpu_torch"
    assert '"fractencode.replay"' in (port / "utils" / "graphs.py").read_text()
    assert '"fractencode.upload"' in (port / "encode" / "encoder.py").read_text()


@pytest.mark.parametrize("name", ["encode", "decode"])
def test_phase_opens_its_span(name):
    timer = profiling.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase(name):
            torch.zeros(4).sum()
    assert [e.name for e in prof.events() if e.name.startswith("fractencode.")] == [
        f"fractencode.phase.{name}"]
    assert set(timer.phases) == {name}
