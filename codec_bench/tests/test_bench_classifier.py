"""The configuration's ``use_classifier`` in the check, the reference, the
control and the bound, on the CPU at 64^2-512^2: without the classifier every
range and column is in one class, the reference searches every column, the
port's full search is judged correct and its bfloat16 control is not, and the
bound counts rows x columns pairs; with it, every number is as it was before
the switch existed.  And the guard that stops a configuration the reference
cannot judge."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

import fractencode_tpu_torch as T
from codec_bench import arith, check, control, harness, planes
from codec_bench.reference import blocks, encode as ref_encode
from fractencode_tpu_torch.encode.quadtree import QuadtreeConfig, encode_plane_quadtree

FULL8 = dict(source_size=16, target_size=8, lattice=2, num_transforms=8, use_classifier=False,
             criterion="affine", so_mode="ls", rms_threshold=0.0, s_max=-1.0)
QT = dict(min_size=4, max_size=16, error_threshold=50.0, domain_ratio=4, lattice=2,
          mask_covered=True)
FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid")


def _plane(size: int, seed: int) -> torch.Tensor:
    return planes.natural_planes(1, size, planes.generator(seed, "cpu"), "cpu")[0]


def _config(name: str) -> dict:
    return json.loads((harness.ROOT / "configs" / f"{name}.json").read_text())


def _cell(config: dict, traffic: dict) -> harness.Cell:
    return harness.Cell(name="toy", config=config, traffic=traffic, end_to_end=[],
                        per_layer=[], readers={})


def _grid_default(**enc) -> dict:
    cfg = _config("grid-default")
    return dict(cfg, encoder=dict(cfg["encoder"], **enc))


def test_unclassed_inputs_are_one_class():
    plane = _plane(64, 1)
    p = ref_encode.plane_inputs(plane, 16, 8, 8, 8, classed=False)
    assert p.range_class.shape == (64,) and p.column_class.shape == (49 * 8,)
    assert not p.range_class.any() and not p.column_class.any()
    assert p.range_class.dtype == p.column_class.dtype == torch.int64


def test_unclassed_best_is_the_first_least_error_over_every_column():
    """Brute force over every column, range by range, with ties: a flat
    quarter of the plane makes flat ranges and flat domains, whose errors
    tie exactly (every value here is exact in float64)."""
    plane = _plane(64, 2)
    plane[:32, :32] = 128
    p = ref_encode.plane_inputs(plane, 16, 8, 8, 8, classed=False)
    rows = torch.arange(p.ranges.shape[0])
    err, col = ref_encode.best(p, rows)
    tied = 0
    for r in rows.tolist():
        e, _, _ = ref_encode.fit(p.ranges[r].expand_as(p.columns), p.columns)
        least = e.min()
        first = int(torch.nonzero(e == least)[0])
        tied += int((e == least).sum()) > 1
        assert col[r] == first and err[r] == least, r
    assert tied > 0


def test_full_search_is_judged_correct():
    plane = _plane(64, 5)
    res = T.encode_plane(plane, T.EncoderConfig(**FULL8), device="cpu")
    assert res.valid.all()
    nums = check.grid_frame(plane, {f: getattr(res, f) for f in FIELDS}, FULL8)
    limits = _config("grid-default")["limits"]
    assert nums["class_faults"] == 0 and nums["winner_gap"] == 0
    assert check.verdict(nums, {k: limits[k] for k in nums}), nums
    # the classes as they stood before the switch would fail it
    classed = check.grid_frame(plane, {f: getattr(res, f) for f in FIELDS},
                               dict(FULL8, use_classifier=True))
    assert classed["class_faults"] > 0


def test_full_search_quadtree_is_judged_correct():
    enc = dict(FULL8, target_size=4, num_transforms=4)
    plane = _plane(128, 6)
    res = encode_plane_quadtree(plane, T.EncoderConfig(**enc), QuadtreeConfig(**QT),
                                device="cpu")
    levels = [{f: getattr(l, f) for f in ("domain_idx", "transform", "s", "o", "error",
                                          "accepted")} for l in res.levels]
    nums = check.quadtree_frame(plane, levels, enc, QT, band=2e-4)
    limits = _config("quadtree-4-16")["limits"]
    assert nums["class_faults"] == 0 and nums["leaf_faults"] == 0
    assert check.verdict(nums, {k: limits[k] for k in nums}), nums


def test_full_search_control_fails():
    plane = _plane(64, 5)
    limits = _config("grid-default")["limits"]
    nums = check.grid_frame(plane, control.grid(plane, FULL8), FULL8)
    failed = {k for k, v in nums.items() if not v <= limits[k]}
    assert failed & {"winner_gap", "distance_err", "map_err"}, nums


def test_unclassed_bound_counts_rows_times_columns(monkeypatch):
    # the operations' term alone, so that the pairs decide the bound
    monkeypatch.setattr(arith, "PEAK_BYTES", 1e30)
    e = harness.make_entry(_cell(_grid_default(use_classifier=False), {
        "entry": "encode_plane", "size": 512, "batch": 1, "pool": 1, "gap_ranges": None,
        "trace_seconds": 1}), 3_000_000_001, "cpu")
    rows, cols = (512 // 4) ** 2, ((512 - 16) // 8 + 1) ** 2 * 4
    assert e.bound_s(0, None) == arith.bound_s(rows * cols, 16, 0)

    qcfg = dict(_config("quadtree-4-16"))
    qcfg["encoder"] = dict(qcfg["encoder"], use_classifier=False)
    q = harness.make_entry(_cell(qcfg, {
        "entry": "encode_batch_quadtree_stacked", "size": 128, "batch": 2, "pool": 2,
        "gap_ranges": None, "trace_seconds": 1}), 3_000_000_002, "cpu")
    _, host = q.call(0)
    want = 0.0
    for j in range(2):
        covered = torch.zeros((128 // 16) ** 2, dtype=torch.bool)
        for l, level in enumerate(host["levels"]):
            rs = 16 >> l
            cols = ((128 - 4 * rs) // (2 * rs) + 1) ** 2 * 4
            want += arith.bound_s(int((~covered).sum()) * cols, rs * rs, 0)
            side = 128 // rs
            covered = (covered | level["accepted"][j]).reshape(side, side)
            covered = covered.repeat_interleave(2, 0).repeat_interleave(2, 1).reshape(-1)
    assert q.bound_s(0, host) == pytest.approx(want, rel=1e-12)


def test_classed_numbers_and_bound_are_as_before(monkeypatch):
    """With the classifier on, the check's numbers and the bound are, to the
    last bit, what the brightness classes gave before the switch: restated
    here from ``blocks.classes``, and the bound against the value the
    harness read before the switch existed."""
    enc = _config("grid-default")["encoder"]
    plane = _plane(64, 7)
    out = control.grid(plane, enc)
    got = check.grid_frame(plane, out, enc)
    p = ref_encode.plane_inputs(plane, 16, 4, 8, 4)
    old = dataclasses.replace(p, range_class=blocks.classes(plane, 4, 4),
                              column_class=blocks.classes(plane, 16, 8).repeat_interleave(4))
    want, _, _ = check._ranges_check(old, out, torch.arange(p.ranges.shape[0]), None,
                                     out["valid"].bool())
    assert got == want and got["winner_gap"] > 0
    assert torch.equal(p.range_class, old.range_class)
    assert torch.equal(p.column_class, old.column_class)

    monkeypatch.setattr(arith, "PEAK_BYTES", 1e30)
    e = harness.make_entry(_cell(_config("grid-default"), {
        "entry": "encode_plane", "size": 512, "batch": 1, "pool": 1, "gap_ranges": None,
        "trace_seconds": 1}), 3_000_000_001, "cpu")
    assert e.bound_s(0, None) == 1.025434777160182e-06
    q = harness.make_entry(_cell(_config("quadtree-4-16"), {
        "entry": "encode_batch_quadtree_stacked", "size": 128, "batch": 2, "pool": 2,
        "gap_ranges": None, "trace_seconds": 1}), 3_000_000_002, "cpu")
    assert q.bound_s(0, q.call(0)[1]) == 7.757485598787266e-09


@pytest.mark.parametrize("config", ["grid-default", "quadtree-4-16"])
def test_guard_passes_the_benchmarks_configurations(config):
    assert check.unjudged(T.EncoderConfig(**_config(config)["encoder"])) == []


@pytest.mark.parametrize("setting,named", [
    (dict(rms_threshold=10.0), "rms_threshold"), (dict(s_max=0.9), "s_max"),
    (dict(criterion="raw"), "criterion"), (dict(so_mode="reference"), "so_mode"),
    (dict(vq_classes=4), "vq_classes")])
def test_guard_stops_what_the_reference_cannot_judge(setting, named):
    cell = _cell(_grid_default(**setting), {
        "entry": "encode_plane", "size": 64, "batch": 1, "pool": 1, "gap_ranges": None,
        "trace_seconds": 1})
    with pytest.raises(ValueError, match=f"cannot judge.*{named}"):
        harness.make_entry(cell, 3_000_000_003, "cpu")
