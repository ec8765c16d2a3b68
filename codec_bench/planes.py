"""The benchmark's inputs, made from the seed on the device in a few large
calls: natural-like u8 planes, and for the decode the encodings of those
planes that the plain reference's search finds.

``natural_planes`` is a torch copy of ``chip_smoke.natural_plane``'s recipe: a
few random low-frequency cosines plus 5x5 box-blurred uniform noise, scaled
to [0, 255].  It is not periodic and has a natural mix of the classifier's
brightness classes.
"""
from __future__ import annotations

import math

import torch

from .reference import encode as ref_encode


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def natural_planes(count: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """[count, size, size] u8 planes on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    axis = torch.arange(size, **f64) / size
    yy, xx = axis[:, None], axis[None, :]
    freq = torch.rand((count, 6, 2), generator=gen, **f64) * 5.5 + 0.5
    amp = torch.rand((count, 6), generator=gen, **f64) * 30 + 10
    phase = torch.rand((count, 6), generator=gen, **f64) * 2 * math.pi
    r, k = 2, 5
    noise = torch.rand((count, size + 2 * r, size + 2 * r), generator=gen, **f64) * 2 - 1
    out = torch.empty((count, size, size), dtype=torch.uint8, device=device)
    for i in range(count):
        img = torch.zeros((size, size), **f64)
        for j in range(6):
            img += amp[i, j] * torch.cos(2 * math.pi * (freq[i, j, 0] * xx + freq[i, j, 1] * yy)
                                         + phase[i, j])
        c = torch.nn.functional.pad(noise[i].cumsum(0).cumsum(1), (1, 0, 1, 0))
        img += 60 * (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
        img = (img - img.min()) / (img.max() - img.min()) * 255.0
        out[i] = img.to(torch.uint8)
    return out


def searched_maps(plane: torch.Tensor, enc: dict, block: int = 2048) -> dict:
    """A grid encoding of ``plane`` for the decode, made by the plain
    reference: each range's winner is the first least-squares best of the
    class-pruned search over every domain of the plane (the full search
    without the classifier; ``reference.encode.best``, in float32 on the
    plane's device), with that pair's
    least-squares (s, o) rounded to float32.  The winners are a real
    encoding's, scattered over the plane as the search finds them, and the
    decode's reference takes nothing the program made.  A range whose class
    has no domain is invalid, with s = o = 0, as the program marks it."""
    sw, tw, t_count = enc["source_size"], enc["target_size"], enc["num_transforms"]
    p = ref_encode.plane_inputs(plane, sw, tw, sw // enc["lattice"], t_count, torch.float32,
                                classed=enc.get("use_classifier", True))
    _, col = ref_encode.best(p, torch.arange(p.ranges.shape[0], device=plane.device), block)
    valid = col >= 0
    m = col.clamp_min(0)
    _, s, o = ref_encode.fit(p.ranges[valid].double(), p.columns[m[valid]].double())
    maps = dict(domain_idx=torch.where(valid, m // t_count, 0).int(),
                transform=torch.where(valid, t_count - 1 - m % t_count, 0).int(),
                s=torch.zeros(m.shape, dtype=torch.float32, device=plane.device),
                o=torch.zeros(m.shape, dtype=torch.float32, device=plane.device), valid=valid)
    maps["s"][valid], maps["o"][valid] = s.float(), o.float()
    return maps
