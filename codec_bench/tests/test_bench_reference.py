"""The benchmark's plain reference held against the program on the CPU at
64^2-128^2: classes, domain samples, winners, distance, s, o, the quadtree's
leaves and the decoded pixels.  The program's CPU path runs its plain
searches, which its own tests hold against the CUDA kernels."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import fractencode_tpu_torch as T
from codec_bench import check, planes
from codec_bench.reference import blocks, decode as ref_decode, encode as ref_encode
from fractencode_tpu_torch.core.classify import classify_grid
from fractencode_tpu_torch.core.grid import uniform_grid
from fractencode_tpu_torch.encode.codebook import build_codebook
from fractencode_tpu_torch.encode.quadtree import QuadtreeConfig, encode_plane_quadtree

ENC = dict(source_size=16, target_size=4, lattice=2, num_transforms=4, use_classifier=True,
           criterion="affine", so_mode="ls", rms_threshold=0.0, s_max=-1.0)
QT = dict(min_size=4, max_size=16, error_threshold=50.0, domain_ratio=4, lattice=2,
          mask_covered=True)


def _plane(size: int, seed: int) -> torch.Tensor:
    return planes.natural_planes(1, size, planes.generator(seed, "cpu"), "cpu")[0]


@pytest.mark.parametrize("block,step", [(4, 4), (16, 8), (8, 4), (64, 32)])
def test_classes_match_the_program(block, step):
    plane = _plane(128, 3)
    grid = uniform_grid(128, 128, block, step)
    assert torch.equal(blocks.classes(plane, block, step), classify_grid(plane, grid).long())


@pytest.mark.parametrize("sw,tw,t_count", [(16, 4, 4), (16, 4, 8), (64, 16, 4), (32, 8, 4)])
def test_domain_samples_match_the_codebook(sw, tw, t_count):
    plane = _plane(128, 4)
    cb = build_codebook(plane.float(), uniform_grid(128, 128, sw, sw // 2), tw, t_count)
    ref = blocks.domain_vectors(plane, sw, sw // 2, tw, t_count)
    assert torch.equal(ref, cb.values.double())


@pytest.mark.parametrize("size,seed", [(64, 1), (128, 2)])
def test_grid_encode_matches(size, seed):
    plane = _plane(size, seed)
    res = T.encode_plane(plane, T.EncoderConfig(**ENC), device="cpu")
    p = ref_encode.plane_inputs(plane, 16, 4, 8, 4)
    err, col = ref_encode.best(p, torch.arange(p.ranges.shape[0]))
    valid = col >= 0
    assert torch.equal(res.valid, valid)
    assert torch.equal(res.domain_idx[valid].long(), col[valid] // 4)
    assert torch.equal(res.transform[valid].long(), 3 - col[valid] % 4)
    _, s, o = ref_encode.fit(p.ranges, p.columns[col.clamp_min(0)])
    torch.testing.assert_close(res.distance[valid].double(), err[valid], rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(res.s[valid].double(), s[valid], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(res.o[valid].double(), o[valid], rtol=1e-6, atol=1e-4)
    out = {f: getattr(res, f) for f in ("domain_idx", "transform", "s", "o", "distance", "valid")}
    nums = check.grid_frame(plane, out, ENC)
    assert nums["class_faults"] == 0 and nums["winner_gap"] == 0


@pytest.mark.parametrize("size,seed", [(64, 5), (128, 6)])
def test_quadtree_leaves_match(size, seed):
    plane = _plane(size, seed)
    res = encode_plane_quadtree(plane, T.EncoderConfig(**ENC), QuadtreeConfig(**QT),
                                device="cpu")
    levels = [{f: getattr(l, f) for f in ("domain_idx", "transform", "s", "o", "error",
                                          "accepted")} for l in res.levels]
    nums = check.quadtree_frame(plane, levels, ENC, QT, band=1e-4)
    assert nums["leaf_faults"] == 0 and nums["coverage_faults"] == 0
    assert nums["class_faults"] == 0 and nums["winner_gap"] == 0
    assert nums["distance_err"] < 1e-4 and nums["map_err"] < 1e-3
    # the reference's own cascade gives the same leaves
    covered = torch.zeros((size // 16, size // 16), dtype=torch.bool)
    for rs, level in zip((16, 8, 4), res.levels):
        p = ref_encode.plane_inputs(plane, 4 * rs, rs, 2 * rs, 4)
        rows = torch.nonzero(~covered.reshape(-1)).squeeze(1)
        least, _ = ref_encode.best(p, rows)
        leaf = torch.zeros_like(level.accepted)
        leaf[rows] = True if rs == 4 else least <= 50.0
        assert torch.equal(leaf, level.accepted)
        covered = covered | leaf.reshape(covered.shape)
        if rs > 4:
            covered = covered.repeat_interleave(2, 0).repeat_interleave(2, 1)


@pytest.mark.parametrize("size,seed", [(64, 7), (128, 8)])
def test_pyramid_decode_matches(size, seed):
    plane = _plane(size, seed)
    maps = planes.searched_maps(plane, ENC)
    res = T.EncodeResult(**{k: v[None] for k, v in maps.items()}, distance=None, width=size,
                         height=size, source_size=16, target_size=4, domain_step=8,
                         num_transforms=4)
    pixels, iters, _ = T.decode_batch_stacked(res, T.DecoderConfig(pyramid=True))
    ref = ref_decode.pyramid(dict(maps, t_count=4), size, size, 16, 4, 8, 8, 6, 100)
    assert torch.equal(pixels[0], ref)
    assert int(iters[0]) == 6
    assert 0 < int(np.unique(ref.numpy()).size)


@pytest.mark.parametrize("size,seed", [(64, 9), (128, 10)])
def test_searched_maps_are_the_programs_encoding(size, seed):
    """The decode's maps come from the reference's search: the program's
    encode of the same plane picks the same winners (float32 near-ties
    aside) and the same validity."""
    plane = _plane(size, seed)
    maps = planes.searched_maps(plane, ENC)
    res = T.encode_plane(plane.numpy(), T.EncoderConfig(**ENC), device="cpu")
    assert torch.equal(maps["valid"], res.valid.reshape(-1))
    same = ((maps["domain_idx"] == res.domain_idx.reshape(-1))
            & (maps["transform"] == res.transform.reshape(-1)))
    assert same.float().mean() > 0.95
    assert not maps["s"][~maps["valid"]].any() and not maps["o"][~maps["valid"]].any()
