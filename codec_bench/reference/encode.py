"""Plain reference of the encode's search and fit: for each range, the
least-squares error of every same-class (domain, isometry) pair, its best,
and the (s, o) of a given pair.  The classes are the brightness classes
where the configuration's ``use_classifier`` is on; where it is off, every
range and column is in class 0, so a range's class is every column (the
full search: rows x columns pairs).

The pairs are scored from centred vectors: with A' = A - mean(A) and
B' = B - mean(B), the least-squares map A ~ s*B + o has s = <A', B'> / |B'|^2,
o = mean(A) - s*mean(B) and the per-pixel error
(|A'|^2 - <A', B'>^2 / |B'|^2) / n (s = 0 where B is flat).  In float64
every centred value and product is exact for u8 ranges and quarter-valued
domain samples, so each error is rounded twice at most.  ``dtype`` computes
the same in a lower precision (the control).

Columns are in the search order m = d*T + (T-1-t), so the first minimum is
the reference's tie rule (domain ascending, the later isometry first).
"""
from __future__ import annotations

import dataclasses

import torch

from . import blocks


@dataclasses.dataclass
class Plane:
    """One plane's encode inputs at one geometry."""

    ranges: torch.Tensor  # [R, n]
    columns: torch.Tensor  # [D*T, n] domain samples in search order
    range_class: torch.Tensor  # [R] int64
    column_class: torch.Tensor  # [D*T] int64
    t_count: int

    @property
    def n(self) -> int:
        return self.ranges.shape[1]


def plane_inputs(plane: torch.Tensor, source: int, target: int, step: int, t_count: int,
                 dtype=torch.float64, classed: bool = True) -> Plane:
    """The encode inputs of an [H, W] u8 plane for ranges of ``target`` px and
    domains of ``source`` px at ``step``, under ``t_count`` isometries; the
    classes by ``blocks.search_classes`` (``classed``: the configuration's
    ``use_classifier``; without it every range and column is in class 0)."""
    dv = blocks.domain_vectors(plane, source, step, target, t_count, dtype)
    d = dv.shape[0]
    columns = dv.flip(1).reshape(d * t_count, -1)
    dcls = blocks.search_classes(plane, source, step, classed)
    return Plane(ranges=blocks.range_blocks(plane, target, dtype), columns=columns,
                 range_class=blocks.search_classes(plane, target, target, classed),
                 column_class=dcls.repeat_interleave(t_count), t_count=t_count)


def _centred(x: torch.Tensor):
    mean = x.mean(1, keepdim=True)
    c = x - mean
    return c, (c * c).sum(1), mean.squeeze(1)


def fit(a: torch.Tensor, b: torch.Tensor):
    """Row-wise least squares of ranges ``a`` [R, n] on samples ``b``
    [R, n]: (per-pixel error, s, o), each [R], in the inputs' dtype."""
    ac, ssa, ma = _centred(a)
    bc, ssb, mb = _centred(b)
    g = (ac * bc).sum(1)
    flat = ssb == 0
    ssb = torch.where(flat, 1, ssb)
    s = torch.where(flat, 0, g / ssb)
    err = ((ssa - g * g / ssb) / a.shape[1]).clamp_min(0)
    return err, s, ma - s * mb


def best(p: Plane, rows: torch.Tensor, block: int = 256):
    """(least error, search-order column of its first occurrence) of each
    range in ``rows`` over the columns of its class (every column without
    the classifier), each [len(rows)]; error +inf and column -1 where the
    class has no column."""
    dev = p.ranges.device
    err = torch.full((rows.shape[0],), float("inf"), dtype=p.ranges.dtype, device=dev)
    col = torch.full((rows.shape[0],), -1, dtype=torch.int64, device=dev)
    rcls = p.range_class[rows]
    for c in torch.unique(rcls).tolist():
        cols = torch.nonzero(p.column_class == c).squeeze(1)
        if cols.numel() == 0:
            continue
        bc, ssb, _ = _centred(p.columns[cols])
        ssb = torch.where(ssb == 0, 1, ssb)
        at = torch.nonzero(rcls == c).squeeze(1)
        for i in range(0, at.shape[0], block):
            sel = at[i:i + block]
            ac, ssa, _ = _centred(p.ranges[rows[sel]])
            g = ac @ bc.T
            e = g.square_().div_(ssb).neg_().add_(ssa[:, None])
            low, arg = e.min(1)
            err[sel] = (low / p.n).clamp_min(0)
            col[sel] = cols[arg]
    return err, col
