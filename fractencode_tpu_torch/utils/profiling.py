"""Timing and tracing (port of ``fractencode_tpu/utils/profiling.py``).

The reference has a wall-clock ``Frac::Timer`` around encode/decode
(``utils/timer.h:7-21``, printed by ``main.cpp:164-178``) and nothing else.
Here: a phase-timing struct for per-stage numbers, and a ``torch.profiler``
trace context for device profiles (the JAX package's is ``jax.profiler``).
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["PhaseTimer", "device_trace"]


class PhaseTimer:
    """Accumulates named wall-clock phases; synchronize the device on the
    phase's outputs before exiting the context for honest device timings."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
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
    Chrome/TensorBoard trace (``*.pt.trace.json``): host activity, plus the
    card's kernels when ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()
