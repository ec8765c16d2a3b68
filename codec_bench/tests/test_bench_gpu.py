"""On the card: one short run of each cell through the benchmark's own
command comes out correct, and its result line has the keys a run prints.
Skips without a card (decided in the fixture, never at import).

    python -m pytest codec_bench/tests/test_bench_gpu.py -q
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(card, cell, traced):
    r = subprocess.run([sys.executable, "-m", "codec_bench.run", "--workload", cell,
                        "--seed", "4000000007", "--seconds", "2", "--trace", str(traced)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if traced:
        assert out["device"]["busy_s"] > 0 and "breakdown" in out
