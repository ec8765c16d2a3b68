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
    """With PAIR_CAP patched to 4 the route counts the pair list on the
    device: the port's n_pairs, a 0-d tensor, equals the JAX classed_prep's,
    and above the cap take_k2 takes K2."""
    img = random_plane(side, 40 + side)
    tcfg = T.EncoderConfig()
    unpatched = tm.classed_prep(*_port_inputs(img, tcfg), tcfg)
    pj, pt = _counted_preps(img, side, masks, 4, monkeypatch)
    assert (unpatched["route"], unpatched["n_pairs"], unpatched["take_k2"]) == (
        "search_classed", None, None)
    assert pt["n_pairs"].dtype == torch.int64 and pt["n_pairs"].dim() == 0
    assert int(pt["n_pairs"]) == int(pj["n_pairs"])
    assert (pt["p_cap"], pt["route"], bool(pt["take_k2"])) == (4, "counted", True)


def _counted_preps(img, side, masks, cap, monkeypatch):
    """(the JAX classed_prep, the port's with PAIR_CAP patched to ``cap``)
    of ``img`` under the default config and the test's masks."""
    jcfg, tcfg = J.EncoderConfig(), T.EncoderConfig()
    args = _jax_inputs(jnp.asarray(img), jcfg)
    dmask, rmask = _masks(args, masks, side)
    pj = _j_prep(*args, jcfg, domain_mask=None if dmask is None else jnp.asarray(dmask),
                 range_mask=None if rmask is None else jnp.asarray(rmask))
    monkeypatch.setattr(mk, "PAIR_CAP", cap)
    as_t = lambda x: None if x is None else torch.from_numpy(x)
    pt = tm.classed_prep(*_port_inputs(img, tcfg), tcfg, domain_mask=as_t(dmask),
                         range_mask=as_t(rmask))
    return pj, pt


@pytest.mark.parametrize("offset", [-1, 0, 1], ids=["below", "at", "above"])
@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
def test_take_k2_is_the_jax_cond_negated(masks, offset, monkeypatch):
    """With the cap just below, at and just above the JAX package's n_pairs
    the route is 'counted', and take_k2 is the negation of its lax.cond
    predicate ``n_pairs <= p_cap``: both branches are taken."""
    img = random_plane(64, 104)
    pj, _ = _counted_preps(img, 64, masks, 4, monkeypatch)
    n_pairs = int(pj["n_pairs"])
    _, pt = _counted_preps(img, 64, masks, n_pairs + offset, monkeypatch)
    assert pt["route"] == "counted" and pt["p_cap"] == n_pairs + offset
    assert bool(pt["take_k2"]) == (not n_pairs <= pt["p_cap"]) == (offset < 0)
    assert int(pt["n_pairs"]) == n_pairs


@pytest.mark.parametrize("take_k2", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
def test_counted_runs_both_and_keeps_the_taken(frontier, take_k2, monkeypatch):
    """The card's form of the 'counted' route, here through the wrappers'
    plain versions: K1 and K2 both run, the untaken one on class segments
    that end where they start (every row keeps (-3e38, 0)), and the kept
    result is the taken route's, bitwise."""
    cfg = T.EncoderConfig(rms_threshold=10.0 if frontier else 0.0)
    img = smooth_plane(64, 105)
    prep = tm.classed_prep(*_port_inputs(img, cfg), cfg)
    prep = dict(prep, route="counted", take_k2=torch.tensor(take_k2))
    seen = {}

    def spy(name, fn):
        def run(*args, **kw):
            seen[name] = fn(*args, **kw)
            return seen[name]
        return run

    monkeypatch.setattr(tm, "search_classed_cuda", spy("k1", mk.search_classed_cuda))
    monkeypatch.setattr(tm, "search_classed2d_cuda", spy("k2", mk.search_classed2d_cuda))
    q, idx = tm._counted(prep, *tm._search_args(prep, 16, 256, cfg, {}))
    taken = tm.classed_kernel(dict(prep, route="search_classed2d" if take_k2
                                   else "search_classed"), 16, 256, cfg)
    assert_bitwise(q, taken[0], "q")
    assert_bitwise(idx, taken[1], "idx")
    q_u, i_u = seen["k1" if take_k2 else "k2"]
    assert bool((q_u == -3.0e38).all()) and not bool(i_u.any())
    assert bool((q > -3.0e38).any())


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
SMS = 132  # an H100's SMs


def _statics(side, geometry, masked):
    """(block_r, nrt, m_pad) of a side^2 plane at (domain, range) sizes
    ``geometry``, as classed_prep lays it out."""
    ds, rs = geometry
    r, m = (side // rs) ** 2, ((side - ds) // (ds // 2) + 1) ** 2 * 4
    block_r, _, r_pad, m_pad, *_ = tm._classed_statics(r, m, masked_ranges=masked)
    return block_r, r_pad // block_r, m_pad


def _layout_work(nrt, seg, block_r, m_pad, k, frontier):
    """The shape plan (step, items) and K2's work on the device
    (mk._k2_work) for a layout of ``nrt`` range tiles, each its own class,
    whose segments hold ``seg`` columns from column 0 (the tiles past them
    none)."""
    col_end = torch.zeros(nrt, dtype=torch.int32)
    col_end[:len(seg)] = torch.as_tensor(np.asarray(seg), dtype=torch.int32)
    step, items = mk._k2_plan(nrt, m_pad, block_r, k, frontier, 4, None, SMS)
    work = mk._k2_work(torch.arange(nrt, dtype=torch.int32), torch.zeros_like(col_end),
                       col_end, block_m=1, block_r=block_r, m_pad=m_pad, step=step,
                       items=items, auto=True, sms=SMS)
    return step, items, work


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_split_plan_partials_follow_the_searched_tiles(plan, frontier):
    """K2's split width, picked on the device from the columns the searched
    tiles hold, gives the card about 4 blocks per SM of splits: a 16K
    quadtree level's one tile left, the 2048^2 4 px level's few and a long
    segment among 100,000 short ones get over 100 splits, the 8192^2
    default one split a segment.  Every split is a work item within the
    grid's bound from the shapes, and the partials, 9 bytes a row of a work
    item, hold about r_pad's rows, not r_pad's times the splits."""
    side, geometry, masked, searched, share, short = PLANS[plan]
    block_r, nrt, m_pad = _statics(side, geometry, masked)
    rng = np.random.default_rng(side)
    longest = int(share * m_pad)
    tiles = nrt if searched is None else searched
    seg = rng.integers(1, (short or longest) + 1, tiles)
    seg[0] = longest
    step, items, (width, n, _, n_work, _) = _layout_work(nrt, seg, block_r, m_pad,
                                                         geometry[1] ** 2, frontier)
    width = int(width)
    assert width % step == 0 and width % (4 if frontier else 1) == 0
    assert torch.equal(n[:tiles], torch.from_numpy(-(-seg // width)))
    assert not bool(n[tiles:].any())
    assert int(n_work) == int(n.sum()) <= items <= nrt + 4 * SMS
    nbytes = 9 * items * block_r
    if searched is None:  # one split a segment
        assert int(n.max()) == 1
    else:
        assert int(n[0]) > 100 and nbytes < 9 * int(n[0]) * nrt * block_r
        assert int(n_work) >= 4 * SMS // 2  # the grid fills the card


def test_split_width_is_checked():
    """K2's width must hold whole groups with the frontier, and only K2
    takes one."""
    cfg, prep, _ = _k1("ls", 16, True)
    k2 = dict(prep, route="search_classed2d")
    with pytest.raises(ValueError, match="multiple of t_n"):
        tm.classed_kernel(k2, 16, 256, cfg, splits=cfg.num_transforms + 1)
    with pytest.raises(ValueError, match="K2"):
        tm.classed_kernel(prep, 16, 256, cfg, splits=8)


# the default geometries: (domain, range) sizes of the grid and the
# quadtree's finer levels
GEOMETRIES = {"4px": (16, 4), "8px": (32, 8), "16px": (64, 16)}


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
def test_shape_plan_ignores_the_class_counts(frontier):
    """K2's plan on the host comes from the layout's shapes: two planes with
    different class counts give the same plan, where the splits the device
    picks for them differ."""
    cfg = T.EncoderConfig()
    preps = [tm.classed_prep(*_port_inputs(img, cfg), cfg)
             for img in (random_plane(128, 106), smooth_plane(128, 107))]
    counts = [torch.bincount(p["tile_class"], minlength=8) for p in preps]
    assert not torch.equal(*counts)
    plans, splits = [], []
    for p in preps:
        nrt, m_pad = p["tile_class"].shape[0], p["ch_s"].shape[0]
        plans.append(mk._k2_plan(nrt, m_pad, p["block_r"], 16, frontier, 4, None, SMS))
        step, items = plans[-1]
        splits.append(mk._k2_work(p["tile_class"], p["col_tile_start"], p["col_end"],
                                  block_m=p["block_m"], block_r=p["block_r"], m_pad=m_pad,
                                  step=step, items=items, auto=True, sms=SMS)[1])
    assert plans[0] == plans[1]
    assert not torch.equal(*splits)


@pytest.mark.parametrize("masked", [False, True], ids=["grid", "masked"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("side", [512, 2048, 4096, 8192, 16384])
def test_shape_plan_bounds(side, geometry, masked):
    """From 512^2 to 16384^2 at the three default geometries, with and
    without the masked row bin and the frontier: the shape plan's grid holds
    every work item of the worst layout (every tile searching all m_pad
    columns) and of a lone tile doing so, within nrt + 4 blocks per SM, so
    its partials stay near 9 bytes a row of r_pad (under 1 GiB); from
    4096^2 at 4 px (the planes whose route may take K2) the worst layout
    gets one split a segment."""
    block_r, nrt, m_pad = _statics(side, GEOMETRIES[geometry], masked)
    k = GEOMETRIES[geometry][1] ** 2
    for frontier in (False, True):
        for seg in ([m_pad] * nrt, [m_pad]):
            step, items, (width, n, _, n_work, _) = _layout_work(nrt, seg, block_r, m_pad,
                                                                 k, frontier)
            assert items <= nrt + 4 * SMS and 9 * items * block_r < 1 << 30
            assert int(n_work) <= items and step <= int(width) <= m_pad + step
            if len(seg) == nrt and side >= 4096 and k == 16:
                assert int(n.max()) == 1


@pytest.mark.parametrize("auto", [True, False], ids=["picked", "given"])
def test_k2_work_reads_nothing_back(auto, monkeypatch):
    """K2's work on the device (_k2_work), made without a host read or an
    upload: each split of each range tile whose class has columns, in tile
    then split order, with its class and columns, each tile's first among
    them, and their count; the kernel's partial of tile t, split z lies at
    row first[t] + z."""
    from test_torch_graphs import HostReads

    cfg = T.EncoderConfig()
    ranges, sa, sa2, cb, rcls, dcls = _port_inputs(random_plane(128, 108), cfg)
    rmask = torch.from_numpy(np.random.default_rng(108).random(ranges.shape[0]) < 0.3)
    prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, cfg, range_mask=rmask)
    tc, cts, ce = prep["tile_class"], prep["col_tile_start"], prep["col_end"]
    nrt, m_pad = tc.shape[0], prep["ch_s"].shape[0]
    step, items = mk._k2_plan(nrt, m_pad, prep["block_r"], 16, False, 4,
                              None if auto else 64, SMS)
    with HostReads(monkeypatch) as rec:
        width, n, work, n_work, first = mk._k2_work(
            tc, cts, ce, block_m=prep["block_m"], block_r=prep["block_r"], m_pad=m_pad,
            step=step, items=items, auto=auto, sms=SMS)
    assert (rec.reads, rec.uploads) == ([], [])
    w, bm = int(width), prep["block_m"]
    want, splits = [], []
    for t in range(nrt):
        c = int(tc[t])
        s0, e = int(cts[c]) * bm, int(ce[c])
        splits.append([(t, c, s, min(s + w, e)) for s in range(s0, e, w)])
        want += splits[-1]
    assert 0 < sum(1 for x in splits if x) < nrt
    assert width.dtype == n_work.dtype == torch.int32 and int(n_work) == len(want)
    assert w == step if not auto else w % step == 0
    assert max(map(len, splits)) > 1 or auto
    assert work.shape == (items, 4) and [tuple(x) for x in work[:len(want)].tolist()] == want
    for t in range(nrt):
        assert int(n[t]) == len(splits[t])
        for z, item in enumerate(splits[t]):
            assert tuple(work[int(first[t]) + z].tolist()) == item


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
