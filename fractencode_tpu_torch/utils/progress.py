# Copied from fractencode_tpu/utils/progress.py (reference C++ paths written relative to
# that repo): importing any fractencode_tpu module imports jax
# (fractencode_tpu/__init__.py imports the encoder).
"""Progress reporting.

Equivalent of ``ProgressReporter2`` / ``StdoutReporter2``
(``encode/EncodingEngine2.hpp:13-48``): the reference logs
from inside its work queue; here a single search is one device program, so
progress hooks attach to the *host-visible* step boundaries that remain —
quadtree levels, images of a batch, decode iterations in the python-loop
decoder — via the same interface.
"""
from __future__ import annotations

import sys
import time

__all__ = ["ProgressReporter", "StdoutReporter", "NullReporter"]


class ProgressReporter:
    def log(self, done: int, total: int) -> None:
        raise NotImplementedError


class NullReporter(ProgressReporter):
    """cf. DummyReporter2 (Encoder2.hpp:9-13)."""

    def log(self, done: int, total: int) -> None:
        pass


class StdoutReporter(ProgressReporter):
    """Throttled in-place percentage, one update per ``interval`` seconds
    (reference throttles at 0.3 s and rewinds with backspaces,
    ``EncodingEngine2.hpp:19-48``)."""

    def __init__(self, interval: float = 0.3, stream=None):
        self._interval = interval
        self._stream = stream or sys.stdout
        self._last = 0.0
        self._last_len = 0

    def log(self, done: int, total: int) -> None:
        now = time.monotonic()
        if now - self._last <= self._interval and done < total:
            return
        self._last = now
        text = f"{100.0 * done / max(total, 1):g}%"
        self._stream.write("\b" * self._last_len + text)
        self._last_len = len(text)
        self._stream.flush()
        if done >= total:
            self._stream.write("\n")
            self._last_len = 0
