"""The comparison's control, at a size a test run holds: the plain reference
put in the program's place and computed in bfloat16 is found not correct,
in every kind of check, while the program is (the limits are the
configurations' own)."""
from __future__ import annotations

import pytest

from codec_bench import check, harness


@pytest.mark.parametrize("traffic", ["enc", "batch", "qt", "dec"])
def test_control_fails_the_check(toy_cell, traffic):
    cell = toy_cell(traffic)
    entry = harness.make_entry(cell, 3_000_000_021, "cpu")
    limits = cell.config["limits"]
    frames = entry.judge(0, entry.control(0))
    ctl = check.worst(frames)
    assert not check.verdict(ctl, {k: limits[k] for k in ctl}), ctl
    # what fails it: the winners and the fit, or the pixels
    failed = {k for k, v in ctl.items() if not v <= limits[k]}
    assert failed & {"winner_gap", "map_err", "distance_err", "pixels_off"}, ctl
    sound, _ = harness.judge(entry, {0: entry.call(0)})
    assert check.verdict(sound, {k: limits[k] for k in sound}), sound
