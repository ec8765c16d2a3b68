"""Port parity, K2 (the 2-D class-blocked search) and the route to it, on the
CPU: the JAX package's route statics and pair count, K2's plain version
against K1's, the forced route against the JAX package's interpret-mode
``fused_search_classed``, and the route taken where the pair list would
overflow (its cap patched small, as tests/test_pallas_matcher.py does).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, random_plane
from test_torch_matcher import _jax_inputs, _port_inputs
from test_torch_quadtree import smooth_plane

import fractencode_tpu as J
import fractencode_tpu.encode.matcher as jm
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.matcher as tm
from fractencode_tpu_torch.bridge import config_from_jax_fields
from fractencode_tpu_torch.encode.quadtree import encode_plane_quadtree
from fractencode_tpu_torch.ops import matcher_kernels as mk

FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid", "key")
MASKS = [(False, False), (True, False), (False, True), (True, True)]
MASK_IDS = ["nomask", "dmask", "rmask", "both"]
# one compile per (shape, masks, cfg), shared by the file's tests
_j_prep = jax.jit(jm.classed_prep, static_argnames=("cfg", "force_no_pairs"))
_j_classed = jax.jit(jm.search_pallas_classed,
                     static_argnames=("cfg", "interpret", "force_no_pairs"))


# (domain, range) sizes: the default grid and the quadtree's finer levels
@pytest.mark.parametrize("geometry", [(16, 4), (32, 8), (64, 16)],
                         ids=["4px", "8px", "16px"])
@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("side", [64, 512, 2048, 4096, 8192, 16384])
def test_route_statics_match_jax(side, masks, geometry):
    """block_r, block_m, r_pad, m_pad, worst_pairs, p_cap and use_pairs
    equal the JAX package's _classed_statics at its tiles; the port's own
    tiles change the layout but not the route's three."""
    ds, rs = geometry
    r, m = (side // rs) ** 2, ((side - ds) // (ds // 2) + 1) ** 2 * 4
    js = jm._classed_statics(r, m, J.EncoderConfig(), masked_domains=masks[0],
                             masked_ranges=masks[1])
    assert tm._classed_statics(r, m, *masks, block_r=mk.PAIR_TILE_R,
                               block_m=mk.PAIR_TILE_M) == js
    assert tm._classed_statics(r, m, *masks)[4:] == js[4:]
    if side == 16384 and rs == 4:
        assert not js[6]  # the pair list's column-tile field overflows
    if side <= 2048 and rs == 4:
        assert js[4] <= mk.PAIR_CAP  # the pair list always fits: K1


def _masks(args, masks, seed):
    rng = np.random.default_rng(seed)
    dmask = rng.random(args[3].values.shape[0]) < 0.8 if masks[0] else None
    rmask = rng.random(args[0].shape[0]) < 0.7 if masks[1] else None
    return dmask, rmask


@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("side", [64, 128])
def test_pair_count_matches_jax(side, masks, monkeypatch):
    """With PAIR_CAP patched to 4 the route counts the pair list: the port's
    n_pairs equals the JAX classed_prep's, and above the cap the route is K2."""
    img = random_plane(side, 40 + side)
    jcfg, tcfg = J.EncoderConfig(), T.EncoderConfig()
    args = _jax_inputs(jnp.asarray(img), jcfg)
    dmask, rmask = _masks(args, masks, side)
    pj = _j_prep(*args, jcfg, domain_mask=None if dmask is None else jnp.asarray(dmask),
                 range_mask=None if rmask is None else jnp.asarray(rmask))
    unpatched = tm.classed_prep(*_port_inputs(img, tcfg), tcfg)
    assert (unpatched["route"], unpatched["n_pairs"]) == ("search_classed", None)
    monkeypatch.setattr(mk, "PAIR_CAP", 4)
    as_t = lambda x: None if x is None else torch.from_numpy(x)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, domain_mask=as_t(dmask),
                         range_mask=as_t(rmask))
    assert pt["n_pairs"] == int(pj["n_pairs"])
    assert (pt["p_cap"], pt["route"]) == (4, "search_classed2d")


# one config per key: 'general' twice, for each of its so_modes
KEYS = {"ls": {}, "raw": dict(criterion="raw", so_mode="reference"),
        "general-ls": dict(s_max=0.9), "general-reference": dict(so_mode="reference")}
GEOMETRY = {16: dict(source_size=16, target_size=4),
            64: dict(source_size=32, target_size=8),
            256: dict(source_size=64, target_size=16)}


@functools.lru_cache(maxsize=None)
def _k1(key, k, frontier):
    """(cfg, prep, K1's plain (q, idx, scanned)) of one case on a smooth
    128^2 plane (many ranges meet the threshold 10)."""
    cfg = T.EncoderConfig(**GEOMETRY[k], **KEYS[key], rms_threshold=10.0 if frontier else 0.0,
                          backend="torch")
    prep = tm.classed_prep(*_port_inputs(smooth_plane(128, 23), cfg), cfg)
    assert prep["route"] == "search_classed"
    scanned = torch.zeros(prep["ai_s"].shape[0], dtype=torch.int64)
    q, idx = tm.classed_kernel(prep, k, cfg.source_size ** 2, cfg, scanned=scanned)
    return cfg, prep, (q, idx, scanned)


@pytest.mark.parametrize("n_splits", [1, 2, 5])
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("k", [16, 64, 256])
@pytest.mark.parametrize("key", list(KEYS))
def test_plain_k2_matches_plain_k1(key, k, frontier, n_splits):
    """search_classed2d_torch against search_classed_torch on the same
    prep, with the longest class segment cut into 1, 2 and 5 splits: (q,
    idx) of every row of r_pad bitwise, and the pairs each row needs."""
    cfg, prep, (q1, i1, s1) = _k1(key, k, frontier)
    seg = prep["col_end"] - prep["col_tile_start"] * prep["block_m"]
    t_n = cfg.num_transforms
    width = -(-int(seg.max()) // n_splits)
    width = -(-width // t_n) * t_n
    scanned = torch.zeros_like(s1)
    q2, i2 = tm.classed_kernel(dict(prep, route="search_classed2d"), k, cfg.source_size ** 2,
                               cfg, scanned=scanned, splits=width)
    assert_bitwise(q1, q2, "q")
    assert_bitwise(i1, i2, "idx")
    assert torch.equal(s1, scanned)
    if frontier and n_splits == 5:
        # the frontier took some rows' best away: it is not vacuous
        q_off, _ = tm.classed_kernel(prep, k, cfg.source_size ** 2,
                                     dataclasses.replace(cfg, rms_threshold=0.0))
        assert bool((q_off != q2).any())


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
def test_sampled_tiles_match_the_whole_search(key, frontier):
    """The first and last range tile of each class, the others pointed at
    the empty column bin (as chip_smoke.py samples the 8192^2 preps): K2's
    plain version gives those tiles' rows what K1 gives them in the whole
    search, and the other rows (-3e38, 0)."""
    k = 16  # the grid with several tiles a class
    cfg, prep, (q1, i1, _) = _k1(key, k, frontier)
    tc, br = prep["tile_class"], prep["block_r"]
    tiles = sorted({t for t0, t1, _ in mk._class_runs(tc) for t in (t0, t1 - 1)})
    keep = torch.zeros(tc.shape[0], dtype=torch.bool)
    keep[tiles] = True
    assert not bool(keep.all())  # a sample, not every tile
    sub = dict(prep, route="search_classed2d",
               tile_class=torch.where(keep, tc, prep["col_end"].shape[0] - 1).to(torch.int32))
    q2, i2 = tm.classed_kernel(sub, k, cfg.source_size ** 2, cfg)
    rows = keep.repeat_interleave(br)
    assert_bitwise(q1[rows], q2[rows], "q")
    assert_bitwise(i1[rows], i2[rows], "idx")
    assert bool((q2[~rows] == -3.0e38).all()) and not bool(i2[~rows].any())


# K2's split plans: (side, (domain, range) sizes, masked ranges, searched
# tiles (None: all), the longest segment's share of the columns, the other
# tiles' most columns (None: up to the longest)) -- the 16K quadtree's 4 px
# level with one range tile left, the 8192^2 default, the 2048^2 quadtree's
# 4 px level with a few, and one long segment among 100,000 short ones
PLANS = {"16384-4px-1tile": (16384, (16, 4), True, 1, 0.6, None),
         "8192-default": (8192, (16, 4), False, None, 0.3, None),
         "2048-4px-2tiles": (2048, (16, 4), True, 2, 0.3, None),
         "16384-long-among-short": (16384, (16, 4), True, 100_000, 0.6, 512)}


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_split_plan_partials_follow_the_searched_tiles(plan, frontier):
    """The grid runs over the searched tiles only, and the partials hold 9
    bytes per searched row and split: a 16K quadtree level with one tile
    left holds under 1 MiB, where partials over every row of r_pad would
    hold tens of GB.  An automatic plan gives the card about 4 blocks per
    SM, and never passes _PARTIALS_MAX_BYTES (it widens the splits)."""
    side, (ds, rs), masked, searched, share, short = PLANS[plan]
    r, m = (side // rs) ** 2, ((side - ds) // (ds // 2) + 1) ** 2 * 4
    block_r, _, r_pad, m_pad, *_ = tm._classed_statics(r, m, masked_ranges=masked)
    nrt = r_pad // block_r
    rng = np.random.default_rng(side)
    longest = int(share * m_pad)
    tiles = nrt if searched is None else searched
    seg = rng.integers(1, (short or longest) + 1, tiles)
    seg[0] = longest
    sms, t_n = 132, 4
    width, n, nbytes = mk._split_plan(int(seg.sum()), longest, tiles, block_r, rs * rs,
                                      frontier, t_n, None, sms)
    assert width % (t_n if frontier else 1) == 0
    assert n == -(-longest // width)
    assert nbytes == 9 * n * tiles * block_r <= mk._PARTIALS_MAX_BYTES
    if searched == 1:
        assert n > 100 and nbytes < 2**20 and 9 * n * r_pad > 10**10
    if searched is None:  # one split a segment
        assert n == 1
    elif short is None:
        assert n * tiles >= 4 * sms // 2  # the grid fills the card
    else:  # the bytes, not the card, set the width
        assert 9 * (n + 1) * tiles * block_r > mk._PARTIALS_MAX_BYTES


def test_split_width_is_checked():
    """K2's width must hold whole groups with the frontier, and only K2
    takes one."""
    cfg, prep, _ = _k1("ls", 16, True)
    k2 = dict(prep, route="search_classed2d")
    with pytest.raises(ValueError, match="multiple of t_n"):
        tm.classed_kernel(k2, 16, 256, cfg, splits=cfg.num_transforms + 1)
    with pytest.raises(ValueError, match="K2"):
        tm.classed_kernel(prep, 16, 256, cfg, splits=8)


# the forced route's configs, by CLI flags: the default, --compat, --smax 0.9
# and --rms 10
FORCED = {"default": {}, "compat": dict(criterion="raw", so_mode="reference"),
          "smax": dict(s_max=0.9), "rms": dict(rms_threshold=10.0)}


@pytest.mark.parametrize("cname", list(FORCED))
def test_forced_route_matches_jax_classed_kernel(cname):
    """search_classed(force_no_pairs=True) on the CPU (K2's plain version)
    against the JAX package's search_pallas_classed(force_no_pairs=True) in
    interpret mode (its fused_search_classed) at 64^2.  Every field bitwise,
    except: 'compat' rounds o once where the JAX classed_post rounds twice
    (test_torch_matcher.test_classed_post: the same bound); 'smax' is the
    'general' key, which XLA:CPU may contract into FMAs (ROADMAP.md, parity
    contract: winners 99%, distances to 1e-3)."""
    jcfg = J.EncoderConfig(**FORCED[cname])
    tcfg = config_from_jax_fields(jcfg)
    img = smooth_plane(64, 21)
    args = _jax_inputs(jnp.asarray(img), J.EncoderConfig())
    rj = _j_classed(*args, jcfg, interpret=True, force_no_pairs=True)
    ranges, sa, sa2, cb, rcls, dcls = _port_inputs(img, tcfg)
    prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, tcfg, force_no_pairs=True)
    assert (prep["route"], prep["use_pairs"]) == ("search_classed2d", True)
    rt = tm.search_classed(ranges, sa, sa2, cb, rcls, dcls, tcfg, force_no_pairs=True)
    if cname == "smax":
        same = (np.asarray(rj.domain_idx) == rt.domain_idx.numpy()) & \
            (np.asarray(rj.transform) == rt.transform.numpy())
        assert same.mean() > 0.99
        np.testing.assert_allclose(rt.distance.numpy(), np.asarray(rj.distance),
                                   rtol=1e-3, atol=1e-3)
        return
    for f in FIELDS:
        if f != "o" or cname != "compat":
            assert_bitwise(getattr(rj, f), getattr(rt, f), f)
    if cname == "compat":
        prod = np.abs(rt.s.numpy() * sa.numpy())
        bound = np.spacing(prod.astype(np.float32)) / 32 + np.spacing(np.abs(rt.o.numpy()))
        assert (np.abs(np.asarray(rj.o) - rt.o.numpy()) <= bound).all()


@pytest.mark.parametrize("path", ["default", "rms", "compat", "quadtree"])
def test_pair_cap_overflow_takes_k2(path, monkeypatch):
    """With PAIR_CAP patched to 4 the encode (every quadtree level) takes
    K2, and gives the unpatched encode's result bitwise."""
    img = smooth_plane(64, 24)
    cfg = T.EncoderConfig(**FORCED.get(path, {}))
    quadtree = path == "quadtree"
    encode = (lambda: encode_plane_quadtree(img, cfg, device="cpu")) if quadtree else \
        (lambda: T.encode_plane(img, cfg, device="cpu"))
    ref = encode()
    calls = []
    k2 = tm.search_classed2d_cuda

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return k2(*a, **kw)

    monkeypatch.setattr(tm, "search_classed2d_cuda", spy)
    monkeypatch.setattr(mk, "PAIR_CAP", 4)
    got = encode()
    assert calls == ([256, 64, 16] if quadtree else [16])
    if quadtree:
        for lr, lg in zip(ref.levels, got.levels, strict=True):
            for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
                assert_bitwise(getattr(lr, f), getattr(lg, f), f"{lr.range_size} px {f}")
    else:
        for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
            assert_bitwise(getattr(ref, f), getattr(got, f), f)
