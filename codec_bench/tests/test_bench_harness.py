"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric are added as files and entries alone, found by name and
run (here at a toy size on the CPU, on the program's plain path), with no
edit to a file the benchmark has."""
from __future__ import annotations

import json

import pytest
import torch

from codec_bench import harness, run


def test_a_new_config_traffic_and_metric_run(toy_root, toy_bench, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CHECK", 1)
    root = tmp_path
    for sub in ("configs", "traffic", "metrics"):
        (root / sub).mkdir()
    cfg = json.loads((toy_root / "configs" / "grid-default.json").read_text())
    cfg["encoder"].update(source_size=8, target_size=4, lattice=2)  # a config of its own
    (root / "configs" / "grid-8-4.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tiny.json").write_text(json.dumps(
        {"entry": "encode_batch_stacked", "size": 32, "batch": 2, "pool": 2,
         "gap_ranges": None, "trace_seconds": 1}))
    (root / "metrics" / "requests_seen.toy.py").write_text(
        "def read(ctx):\n    return float(ctx.requests)\n")
    bench = dict(toy_bench, workloads=[{"name": "grid-8-4.tiny", "config": "grid-8-4",
                                        "traffic": "tiny", "chips": 1, "why": "toy"}],
                 per_layer=[{"name": "requests_seen.toy", "unit": "count", "better": "higher",
                             "source": "program_counter", "layer": "entry forms",
                             "moves": "encode_mpix_s"}],
                 end_to_end=[{"name": "setup_s", "unit": "s"},
                             {"name": "encode_mpix_s", "unit": "Mpix/s"}])
    cell = harness.resolve("grid-8-4.tiny", bench, root)
    assert cell.traffic["size"] == 32 and cell.config["encoder"]["source_size"] == 8
    result, numbers, _ = run.measure(cell, 4_100_000_001, 0.2, 0, torch.device("cpu"))
    assert result["correct"], numbers
    assert set(result["metrics"]) == {"setup_s", "encode_mpix_s"}
    assert result["metrics"]["encode_mpix_s"]["value"] > 0
    traced, _, _ = run.measure(cell, 4_100_000_003, 0.2, 1, torch.device("cpu"))
    assert traced["correct"]
    assert traced["metrics"]["requests_seen.toy"]["value"] >= 1
    assert list(traced)[-1] == "checks" and "breakdown" in traced


@pytest.mark.parametrize("traffic", ["enc", "batch", "qt", "dec"])
def test_every_entry_form_runs_correct(toy_cell, traffic):
    cell = toy_cell(traffic)
    result, numbers, limits = run.measure(cell, 2**31 + 11, 0.3, 0, torch.device("cpu"))
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    kind = "decode" if traffic == "dec" else "encode"
    assert f"{kind}_mpix_s" in result["metrics"] and "setup_s" in result["metrics"]
    assert set(result["checks"]) == set(numbers)
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_same_seed_same_inputs(toy_cell):
    cell = toy_cell("batch")
    a = harness.make_entry(cell, 2**31 + 5, "cpu")
    b = harness.make_entry(cell, 2**31 + 5, "cpu")
    c = harness.make_entry(cell, 2**31 + 6, "cpu")
    assert (a.pool == b.pool).all() and not (a.pool == c.pool).all()
    assert a.pool.shape == (4, 64, 64)


def test_unknown_workload_is_refused(toy_bench, toy_root):
    with pytest.raises(KeyError):
        harness.resolve("grid-default.nothing", toy_bench, toy_root)
