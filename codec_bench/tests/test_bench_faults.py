"""A run with the timed path broken underneath comes out not correct: the
rest of a run (``run.measure``: set-up, window, check) on the CPU at a toy
size, for each fault a cell can have.  No cell spans chips, so none can
leave out an exchange between them."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from codec_bench import run
from fractencode_tpu_torch.decode import decoder
from fractencode_tpu_torch.encode import encoder, matcher, quadtree


def _altered_winners(orig):
    """Every 7th range's winner moved one column on, where it is produced
    (its (s, o) then fit the moved pair)."""
    def winners(ranges, sum_a, sum_a2, b4_cols, win_m, t, dist, key, cfg):
        moved = win_m.clone()
        moved[::7] = (moved[::7] + 1) % b4_cols.shape[0]
        return orig(ranges, sum_a, sum_a2, b4_cols, moved, t, dist, key, cfg)
    return winners


def _altered_s(orig):
    """Every 5th range's contrast off by 1e-3, where it is produced."""
    def winners(*args):
        res = orig(*args)
        res.s[::5] *= 1.001
        return res
    return winners


def _half_grid_batch(orig):
    """The first half of the batch encoded, its rows repeated for the rest."""
    def encode(planes, cfg, graph):
        res = orig(planes[: planes.shape[0] // 2], cfg, graph)
        return dataclasses.replace(res, **{f: torch.cat([getattr(res, f)] * 2)
                                           for f in encoder.ARRAY_FIELDS})
    return encode


def _half_quadtree_batch(orig):
    def encode(planes, cfg, qcfg, graph):
        res = orig(planes[: planes.shape[0] // 2], cfg, qcfg, graph)
        levels = [dataclasses.replace(l, **{f: torch.cat([getattr(l, f)] * 2)
                                            for f in quadtree.LEVEL_ARRAY_FIELDS})
                  for l in res.levels]
        return dataclasses.replace(res, levels=levels)
    return encode


def _half_decode_batch(orig):
    def rows(result, dcfg, graph, ran_steps=False):
        outs, iters, mses = orig(result, dcfg, graph, ran_steps)
        h = outs.shape[0] // 2
        outs[h:] = outs[:h]
        return outs, iters, mses
    return rows


def _unchanged_step(orig):
    """A decode step that returns its state unchanged."""
    def step(img_u8, tables, s, o, height, width, target_size, o_is_mean=False):
        return img_u8
    return step


def _altered_pixel(orig):
    """One pixel of each decoded frame off by one, where it is produced."""
    def decode(result, dcfg):
        img, mse = orig(result, dcfg)
        img = img.clone()
        img[3, 5] ^= 1
        return img, mse
    return decode


FAULTS = {
    "enc": [(matcher, "_winners", _altered_winners), (matcher, "_winners", _altered_s)],
    "batch": [(matcher, "_winners", _altered_winners),
              (encoder, "_encode_batch", _half_grid_batch)],
    "qt": [(matcher, "_winners", _altered_winners), (matcher, "_winners", _altered_s),
           (quadtree, "_encode_batch", _half_quadtree_batch)],
    "dec": [(decoder, "_decode_step", _unchanged_step),
            (decoder, "_pyramid_decode", _altered_pixel),
            (decoder, "_decode_rows", _half_decode_batch)],
}


@pytest.mark.parametrize("traffic,module,name,fault",
                         [(t, m, n, f) for t, fs in FAULTS.items() for m, n, f in fs],
                         ids=[f"{t}-{f.__name__}" for t, fs in FAULTS.items() for _, _, f in fs])
def test_broken_path_is_not_correct(toy_cell, monkeypatch, traffic, module, name, fault):
    cell = toy_cell(traffic)
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    result, numbers, limits = run.measure(cell, 2**31 + 101, 0.2, 0, torch.device("cpu"))
    assert result["correct"] is False, numbers
    assert any(not v <= limits[k] for k, v in numbers.items())
