"""The control of the comparison: the plain reference put in the program's
place, computed in bfloat16, the precision below the float32 key and fit the
configurations state.  It gives the program's outputs (the same arrays, the
same layout), so that ``check`` judges it as it judges the program; a sound
comparison finds it not correct.  The benchmark's runs never call it
(``calibrate.py`` and the tests do).
"""
from __future__ import annotations

import torch

from .reference import decode as ref_decode
from .reference import encode as ref_encode

LOW = torch.bfloat16
_BIG = 3.0e38


def _search(p: ref_encode.Plane, rows: torch.Tensor) -> dict:
    """The winner of each range in ``rows`` and its fit, in ``LOW``, as the
    program's arrays (float32 s, o, distance; +BIG distance where invalid)."""
    err, col = ref_encode.best(p, rows)
    valid = col >= 0
    c = col.clamp_min(0)
    t_count = p.t_count
    e, s, o = ref_encode.fit(p.ranges[rows], p.columns[c])
    return dict(domain_idx=(c // t_count).int(), transform=(t_count - 1 - c % t_count).int(),
                s=torch.where(valid, s.float(), 0), o=torch.where(valid, o.float(), 0),
                distance=torch.where(valid, e.float(), _BIG), valid=valid)


def grid(plane: torch.Tensor, enc: dict) -> dict:
    p = ref_encode.plane_inputs(plane, enc["source_size"], enc["target_size"],
                                enc["source_size"] // enc["lattice"], enc["num_transforms"],
                                dtype=LOW, classed=enc.get("use_classifier", True))
    return _search(p, torch.arange(p.ranges.shape[0], device=plane.device))


def quadtree(plane: torch.Tensor, enc: dict, qt: dict) -> list[dict]:
    h, w = plane.shape
    levels, rs = [], qt["max_size"]
    covered = torch.zeros((h // rs, w // rs), dtype=torch.bool, device=plane.device)
    while rs >= qt["min_size"]:
        ds = rs * qt["domain_ratio"]
        p = ref_encode.plane_inputs(plane, ds, rs, ds // qt["lattice"], enc["num_transforms"],
                                    dtype=LOW, classed=enc.get("use_classifier", True))
        r = p.ranges.shape[0]
        rows = torch.nonzero(~covered.reshape(-1)).squeeze(1)
        found = _search(p, rows)
        out = dict(domain_idx=torch.zeros(r, dtype=torch.int32, device=plane.device),
                   transform=torch.zeros(r, dtype=torch.int32, device=plane.device),
                   s=torch.zeros(r, device=plane.device), o=torch.zeros(r, device=plane.device),
                   error=torch.full((r,), float("inf"), device=plane.device))
        for k in ("domain_idx", "transform", "s", "o"):
            out[k][rows] = found[k]
        out["error"][rows] = torch.where(found["valid"], found["distance"], float("inf"))
        last = rs // 2 < qt["min_size"]
        leaf = ~covered.reshape(-1)
        if not last:
            leaf &= out["error"] <= qt["error_threshold"]
        out["accepted"] = leaf
        levels.append(out)
        covered = covered | leaf.reshape(covered.shape)
        if not last:
            covered = covered.repeat_interleave(2, 0).repeat_interleave(2, 1)
        rs //= 2
    return levels


def decode(maps: dict, geometry: dict) -> torch.Tensor:
    return ref_decode.pyramid(maps, **geometry, dtype=LOW)
