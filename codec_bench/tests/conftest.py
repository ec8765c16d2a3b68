"""Toy cells for the CPU tests: the benchmark's own configuration files and
readers under a temporary root, with traffic files at 64^2."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from codec_bench import harness

ROOT = Path(__file__).resolve().parents[1]
TOY = {
    "enc": {"entry": "encode_plane", "size": 64, "batch": 1, "pool": 2, "gap_ranges": 100,
            "trace_seconds": 1},
    "batch": {"entry": "encode_batch_stacked", "size": 64, "batch": 2, "pool": 4,
              "gap_ranges": None, "trace_seconds": 1},
    "qt": {"entry": "encode_batch_quadtree_stacked", "size": 64, "batch": 2, "pool": 4,
           "gap_ranges": None, "trace_seconds": 1},
    "dec": {"entry": "decode_batch_stacked", "size": 64, "batch": 2, "pool": 4,
            "gap_ranges": None, "trace_seconds": 1},
}
CELLS = {"enc": "grid-default", "batch": "grid-default", "qt": "quadtree-4-16",
         "dec": "grid-default"}


@pytest.fixture(autouse=True)
def one_warm_request(monkeypatch):
    """One warm-up request: the plain path on the CPU captures no graph."""
    monkeypatch.setattr(harness, "WARM", 1)


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "configs", root / "configs")
    shutil.copytree(ROOT / "metrics", root / "metrics")
    (root / "traffic").mkdir()
    for name, traffic in TOY.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    return root


@pytest.fixture(scope="session")
def toy_bench() -> dict:
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
                           "why": "toy"} for t, c in CELLS.items()]
    encode = [f"{c}.{t}" for t, c in CELLS.items() if t != "dec"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["grid-default.dec"] if "decode" in m["name"] else
                              ["grid-default.enc"] if m["name"] == "encode_p95_ms" else encode)
    return bench


@pytest.fixture
def toy_cell(toy_root, toy_bench):
    def make(traffic: str) -> harness.Cell:
        return harness.resolve(f"{CELLS[traffic]}.{traffic}", toy_bench, toy_root)
    return make
