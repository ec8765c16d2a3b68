"""Plain reference of the pyramid decode (Encoder2.hpp, DecodeUtils.hpp, with
the coarse-to-fine start the codec's CLI runs).

One step applies every range's map to the current u8 image: sample the
domain under its isometry (2x2 averages, ``blocks.sample_taps``), take
s*v + o, round it once to float32, clamp to [0, 255] and truncate to u8.
The pyramid runs ``coarse_steps`` steps at half scale from a flat gray
image (every block size and step halved), replicates each pixel 2x2, and
runs ``full_steps`` steps at full scale.  ``dtype`` computes s*v + o in a
lower precision (the control).
"""
from __future__ import annotations

import torch

from . import blocks


def step(img: torch.Tensor, maps: dict, sw: int, tw: int, st: int,
         dtype=torch.float64) -> torch.Tensor:
    """One application of the map set to the [H, W] u8 ``img`` with domains
    of ``sw`` px at step ``st`` and ranges of ``tw`` px."""
    h, w = img.shape
    t_count = int(maps["t_count"])
    nx = (w - sw) // st + 1
    dom, tr = maps["domain_idx"].long(), maps["transform"].long()
    base = (dom // nx) * st * w + (dom % nx) * st
    local = torch.from_numpy(blocks.sample_taps(sw, tw, t_count)).to(img.device)
    offs = (local // sw) * w + local % sw  # [T, n, 4]
    v = img.reshape(-1).to(dtype)[base[:, None, None] + offs[tr]].sum(-1) * 0.25
    s, o = maps["s"].to(dtype)[:, None], maps["o"].to(dtype)[:, None]
    out = (s * v + o).to(torch.float32).clamp(0, 255).floor().to(torch.uint8)
    return out.reshape(h // tw, w // tw, tw, tw).permute(0, 2, 1, 3).reshape(h, w)


def pyramid(maps: dict, height: int, width: int, sw: int, tw: int, st: int,
            coarse_steps: int, full_steps: int, initial: int,
            dtype=torch.float64) -> torch.Tensor:
    """The [H, W] u8 pyramid decode of one frame's maps (``domain_idx``,
    ``transform``, ``s``, ``o`` [R] tensors and ``t_count``)."""
    dev = maps["s"].device
    img = torch.full((height // 2, width // 2), initial, dtype=torch.uint8, device=dev)
    for _ in range(coarse_steps):
        img = step(img, maps, sw // 2, tw // 2, st // 2, dtype)
    img = img.repeat_interleave(2, 0).repeat_interleave(2, 1)
    for _ in range(full_steps):
        img = step(img, maps, sw, tw, st, dtype)
    return img
