"""The comparison that decides ``correct``: the program's outputs, judged
against the plain reference (``reference/``) on the inputs the benchmark made.

Every number is a worst case over the frames checked; a run is correct when
each is at most its limit (``limits`` in the configuration's file).

Encode (grid, and each quadtree level over the ranges it searched):

  * ``class_faults``: ranges whose ``valid`` flag differs from the
    reference's (a range is valid when some domain shares its class), or
    whose winner is no (domain, isometry) of the range's class.
  * ``winner_gap``: how far the error of the program's winner lies above
    the reference's least error over the range's class, over the range's
    variance + 1 (the reference runs the full search for ``gap_ranges``
    ranges a frame, drawn from the seed; every range where that is None).
  * ``distance_err``: |program distance - reference error of the program's
    winner| over the range's variance + 1.
  * ``map_err``: the program's (s, o) against the least-squares (s, o) of
    its winner, by the map they make: the largest |(s*v + o) - (s'*v + o')|
    over the winner's samples v, in grey levels.  It judges s and o where a
    decode uses them; s alone is ill-conditioned on near-flat domains, where
    the program's float32 SumB2 at n = 64 moves it by up to ~1e-3 while the
    map moves by far less than a grey level.

The classes are the configuration's: the brightness classes where
``use_classifier`` is on (the default), and one class, 0, for every range
and column where it is off (``reference.blocks.search_classes``).  Without
the classifier a range's class is every column, so ``class_faults`` counts
the ranges whose ``valid`` flag differs from the reference's (every range is
valid) or whose winner lies outside the grid, and ``winner_gap`` is taken
over every column, the first least error winning.

Quadtree, besides: ``leaf_faults``, blocks whose leaf flag differs from the
reference's (its least error against the threshold; a block whose least
error lies within ``band`` of the threshold, over its variance + 1, is not
counted: the program's rounding of the error decides it),
and ``coverage_faults``, finest blocks not covered by exactly one leaf.
The coarser levels' leaves, once checked, give the next level's ranges.

Decode: ``pixels_off``, pixels that differ from the reference decode.
"""
from __future__ import annotations

import math

import torch

from .reference import decode as ref_decode
from .reference import encode as ref_encode

NUMBERS = {
    "encode": ("class_faults", "winner_gap", "distance_err", "map_err"),
    "quadtree": ("class_faults", "winner_gap", "distance_err", "map_err", "leaf_faults",
                 "coverage_faults"),
    "decode": ("pixels_off",),
}


def unjudged(cfg) -> list[str]:
    """The encoder settings of ``cfg`` (the program's ``EncoderConfig``) that
    the plain reference does not implement, each with what it would need: a
    run under any of them would be judged against another search than the
    one the program makes."""
    return [why for off, why in (
        (cfg.rms_threshold != 0,
         f"rms_threshold {cfg.rms_threshold} (the frontier's scan-order winner)"),
        (cfg.s_max > 0, f"s_max {cfg.s_max} (the clamped 'general' fit)"),
        (cfg.criterion != "affine", f"criterion {cfg.criterion!r} (only 'affine')"),
        (cfg.so_mode != "ls", f"so_mode {cfg.so_mode!r} (only 'ls')"),
        (cfg.vq_classes > 0, f"vq_classes {cfg.vq_classes} (the VQ bins as classes)"),
    ) if off]


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _ranges_check(p: ref_encode.Plane, out: dict, rows: torch.Tensor, gap_rows,
                  valid: torch.Tensor) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The encode numbers of the ranges ``rows`` (int64 indices) of one
    plane at one geometry; ``out`` holds the program's [R] arrays on the
    plane's device, ``valid`` the program's validity of ``rows``;
    ``gap_rows`` (indices into ``rows``) the ranges given the full search,
    every one where None.  Also returns the reference's least error of
    ``rows`` (+inf where not searched) and the ranges' variance + 1."""
    t_count = p.t_count
    n_cols = p.columns.shape[0]
    d = out["domain_idx"][rows].long()
    t = out["transform"][rows].long()
    in_grid = (d >= 0) & (d * t_count < n_cols) & (t >= 0) & (t < t_count)
    m = torch.where(in_grid, d * t_count + (t_count - 1 - t), 0)
    rcls = p.range_class[rows]
    per_class = torch.bincount(p.column_class + 1, minlength=8)
    valid_ref = per_class[rcls + 1] > 0
    faults = (valid != valid_ref) | (valid & (~in_grid | (p.column_class[m] != rcls)))
    use = valid & ~faults
    a, v = p.ranges[rows], p.columns[m]
    err, s, o = ref_encode.fit(a, v)
    ac = a - a.mean(1, keepdim=True)
    scale = (ac * ac).mean(1) + 1
    ds = out["s"][rows].double() - s
    do = out["o"][rows].double() - o
    nums = {
        "class_faults": float(faults.sum()),
        "distance_err": _max(((out["distance"][rows].double() - err).abs() / scale)[use]),
        "map_err": _max((ds[:, None] * v + do[:, None]).abs().amax(1)[use]),
    }
    searched = (torch.arange(rows.shape[0], device=rows.device) if gap_rows is None
                else gap_rows)
    searched = searched[use[searched]]
    least = torch.full_like(err, float("inf"))
    least[searched] = ref_encode.best(p, rows[searched])[0]
    nums["winner_gap"] = _max(((err - least) / scale)[searched])
    return nums, least, scale


def _worst(acc: dict, nums: dict) -> None:
    for k, v in nums.items():
        acc[k] = max(acc.get(k, 0.0), v) if not math.isnan(v) else math.nan


def grid_frame(plane: torch.Tensor, out: dict, enc: dict, gap_rows=None) -> dict:
    """The encode numbers of one grid-encoded plane (``out``: the six
    EncodeResult arrays)."""
    p = ref_encode.plane_inputs(plane, enc["source_size"], enc["target_size"],
                                enc["source_size"] // enc["lattice"], enc["num_transforms"],
                                classed=enc.get("use_classifier", True))
    rows = torch.arange(p.ranges.shape[0], device=plane.device)
    nums, _, _ = _ranges_check(p, out, rows, gap_rows, out["valid"].bool())
    return nums


def quadtree_frame(plane: torch.Tensor, levels: list[dict], enc: dict, qt: dict,
                   band: float) -> dict:
    """The quadtree numbers of one plane (``levels``: each level's
    domain_idx, transform, s, o, error and accepted, coarse to fine)."""
    h, w = plane.shape
    sizes, acc = [], {}
    rs = qt["max_size"]
    while rs >= qt["min_size"]:
        sizes.append(rs)
        rs //= 2
    covered = torch.zeros((h // sizes[0], w // sizes[0]), dtype=torch.bool, device=plane.device)
    leaves = torch.zeros((h // sizes[-1], w // sizes[-1]), dtype=torch.int64,
                         device=plane.device)
    leaf_faults = 0.0
    for i, (rs, out) in enumerate(zip(sizes, levels)):
        ds = rs * qt["domain_ratio"]
        p = ref_encode.plane_inputs(plane, ds, rs, ds // qt["lattice"], enc["num_transforms"],
                                    classed=enc.get("use_classifier", True))
        accepted = out["accepted"].bool()
        rows = torch.nonzero(~covered.reshape(-1)).squeeze(1)
        out = dict(out, distance=out["error"])
        valid = torch.isfinite(out["error"][rows])
        nums, least, scale = _ranges_check(p, out, rows, None, valid)
        _worst(acc, nums)
        if i < len(sizes) - 1:
            ref_leaf = least <= qt["error_threshold"]
            near = (least - qt["error_threshold"]).abs() <= band * scale
            leaf_faults += float(((accepted[rows] != ref_leaf) & ~near).sum())
        else:
            leaf_faults += float((~accepted[rows]).sum())
        acc2d = accepted.reshape(covered.shape)
        rep = leaves.shape[0] // acc2d.shape[0]
        leaves += acc2d.long().repeat_interleave(rep, 0).repeat_interleave(rep, 1)
        covered = covered | acc2d
        if i < len(sizes) - 1:
            covered = covered.repeat_interleave(2, 0).repeat_interleave(2, 1)
    acc["leaf_faults"] = leaf_faults
    acc["coverage_faults"] = float((leaves != 1).sum())
    return acc


def decode_frame(maps: dict, pixels: torch.Tensor, geometry: dict) -> dict:
    """The decode numbers of one frame: the program's u8 ``pixels`` against
    the reference's pyramid decode of ``maps``."""
    ref = ref_decode.pyramid(maps, **geometry)
    return {"pixels_off": float((ref != pixels).sum())}


def worst(frames: list[dict]) -> dict:
    """Each number's worst over the frames checked."""
    acc: dict = {}
    for nums in frames:
        _worst(acc, nums)
    return acc


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at most its limit (a NaN or a missing number fails)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
