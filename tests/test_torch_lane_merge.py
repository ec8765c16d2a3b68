"""The search order of the tensor-core K1, K2 and K3 (csrc/search_mma.cuh),
emulated in plain PyTorch on the CPU and held against the plain searches
(``ops/matcher_kernels._plain_search`` through ``search_dense_torch``,
``search_classed_torch`` and ``search_classed2d_torch``), and K4/K5's step
on the same mainloop (csrc/micro_step.cu) against ``ops/micro_kernels.
micro_step_torch``.

The CUDA kernels cannot run here, so this pins the rule they implement:
columns in chunks, each split into n8 tiles whose columns 2t and 2t + 1 sit
in lane t of a quad; a best per lane and row with the strict '>' in the
lane's column order, then the quad merged (the larger q, the lower idx on
equal q); with the frontier, chunks and sub-blocks of whole groups and n8
tiles, a sub-block where a row has no hit continuing the row's lane bests
and the one where it first hits scanned in column order with the group
logic, its result merged last; K2's partials per split reduced in split
order up to the first split that hit; K1's blocks searching a range
tile's whole class segment and writing each row's result directly; K4's
step as one such segment per pair-list word, each variant's lane policy
and quad merge, and the partials folded in list order.  (The
kernel's check of a step's maximum before its exact update, and a warp's or
block's stop once all its rows are done, change no result and are not
emulated.)

The keys come from a small table indexed by the exact dot (the plain
search's 'ls' key patched to it), so ties are everywhere and +0 and -0 both
occur.  Where a row's max is a zero, torch's amax in the plain version may
return either sign for a tie of +0 and -0 (it is not a first occurrence),
so there q is compared as a float; idx is compared bitwise everywhere, and
q bitwise wherever the max is not zero.
"""
import numpy as np
import pytest
import torch

from fractencode_tpu_torch.ops import matcher_kernels as mk
from fractencode_tpu_torch.ops import micro_kernels as mt

K = 16
K_INIT = -3.0e38
SUB = 64  # the frontier's most staged columns per warp (mma::kSub)
# the key of an even-sum row by dot mod 8 (RARE_KEY where dot mod 64 is 63),
# of an odd-sum row by dot mod 4
RARE_KEY = 96.0
EVEN_KEYS = torch.tensor([-16.0, -0.0, 0.0, 16.0, 32.0, 48.0, 48.0, 80.0])
ODD_KEYS = torch.tensor([-0.0, 0.0, -16.0, 0.0])
THRESHOLD = 0.5
INV_NORM = 16.0  # so the 'ls' distance is max(16 SumA2 - q, 0) for SumA = 0
KW = dict(criterion="affine", so_mode="ls", s_max=0.0, inv_norm=INV_NORM)


def table_key(sa_i, dot, sb4, aux16, n):
    """The patched 'ls' key: a table lookup by the exact dot and the row's
    byte-sum parity."""
    even = sa_i.remainder(2) == 0
    q_even = torch.where(dot.remainder(64) == 63, RARE_KEY, EVEN_KEYS[dot.remainder(8).long()])
    return torch.where(even, q_even, ODD_KEYS[dot.remainder(4).long()])


@pytest.fixture(autouse=True)
def _table_keys(monkeypatch):
    monkeypatch.setattr(mk, "_rank_ls_int8", table_key)
    monkeypatch.setattr(mt, "_rank_ls_int8", table_key)


def operands(rows: int, cols: int, seed: int):
    """int8 operands whose dots take small values; a few all-zero rows (every
    key -0) and repeated columns, many in runs of neighbours; SumA = 0 and SumA2 in 0..7, so the
    frontier's hit test is q >= 16 SumA2 - 0.5: some rows hit often, some
    rarely (only the rare key hits at SumA2 = 6: late in the scan), some
    never."""
    rng = np.random.default_rng(seed)
    ai = rng.integers(-3, 4, (rows, K), dtype=np.int8)
    ai[rng.random(rows) < 0.05] = 0
    ch = rng.integers(0, 4, (cols, K), dtype=np.int8)
    cl = rng.integers(0, 8, (cols, K), dtype=np.int8)
    rep = rng.random(cols) < 0.2
    src = rng.integers(0, cols, cols)
    ch[rep], cl[rep] = ch[src[rep]], cl[src[rep]]
    for j in np.flatnonzero(rng.random(cols) < 0.4):  # runs of equal neighbours
        ch[j], cl[j] = ch[j - 1], cl[j - 1]
    sb = np.zeros(cols, np.float32)
    aux = np.ones(cols, np.float32)
    sa = np.zeros(rows, np.float32)
    sa2 = rng.integers(0, 8, rows).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (ai, ch, cl, sb, aux, sa, sa2))


def key_matrix(ai, ch, cl, sa, sa2):
    """(keys, hits) of every (row, column) pair: the dot in int64, the table
    key, and rank_to_dist's distance against the threshold."""
    dot = ai.long() @ (8 * ch.long() + cl.long()).T
    sa_i = ai.long().sum(1, keepdim=True) + 128 * K
    q = table_key(sa_i, dot, None, None, K)
    dist = mk.rank_to_dist(q, sa2[:, None], sa[:, None], n=float(K), **KW)
    return q, dist <= torch.tensor(THRESHOLD, dtype=torch.float32)


def merge(q, i, oq, oi):
    """The larger q, the lower idx on equal q (merge_best)."""
    take = (oq > q) | ((oq == q) & (oi < i))
    return torch.where(take, oq, q), torch.where(take, oi, i)


def lane_bests(q, admit, cols, bq, bi):
    """Fold the columns ``cols`` (ascending, n8 tiles from the first) into
    each quad lane's best with the strict '>': lane t holds the columns 2t
    and 2t + 1 of every tile, in column order."""
    for n, j in enumerate(cols):
        t = (n % 8) // 2
        upd = q[:, j] > bq[t]  # strict: the first occurrence wins
        if admit is not None:
            upd &= admit[:, j]
        bq[t] = torch.where(upd, q[:, j], bq[t])
        bi[t] = torch.where(upd, j, bi[t])


def group_scan(q, hit, cols, t_n):
    """search_common.cuh's group logic over ``cols`` from a group boundary,
    for rows that hit there: (q, idx) over the columns before the first
    group with a hit and that group's from its last hit on (a trailing
    partial group closed at the end)."""
    rows = q.shape[0]
    cand_q, cand_i = torch.full((rows,), K_INIT), torch.zeros(rows, dtype=torch.int64)
    group_q, group_i = torch.full((rows,), K_INIT), torch.zeros(rows, dtype=torch.int64)
    group_hit = torch.zeros(rows, dtype=torch.bool)
    stop = torch.zeros(rows, dtype=torch.bool)
    for n, j in enumerate(cols):
        live = ~stop
        restart = live & (hit[:, j] | (q[:, j] > group_q))  # a hit restarts the group
        group_q = torch.where(restart, q[:, j], group_q)
        group_i = torch.where(restart, j, group_i)
        group_hit |= live & hit[:, j]
        if (n + 1) % t_n == 0 or n + 1 == len(cols):  # a group (or the scan) ends
            better = live & (group_q > cand_q)
            cand_q = torch.where(better, group_q, cand_q)
            cand_i = torch.where(better, group_i, cand_i)
            stop |= group_hit
            group_q = torch.where(stop, group_q, K_INIT)
            group_hit = torch.zeros(rows, dtype=torch.bool)
    return cand_q, cand_i


def emulate(q, hit, admit, c0, c1, chunk, frontier, t_n):
    """The kernel's scan of every row of ``q`` over columns [c0, c1) in
    chunks of ``chunk`` columns: (q, idx, hit) per row.  ``admit`` (bool
    [rows, cols] or None) is the class mask.  With the frontier, chunks and
    sub-blocks hold whole groups and whole n8 tiles; a sub-block where a
    row has no hit folds into its lane bests, the one where it first hits
    is scanned with the group logic, and the row stops."""
    rows = q.shape[0]
    bq = {t: torch.full((rows,), K_INIT) for t in range(4)}
    bi = {t: torch.zeros(rows, dtype=torch.int64) for t in range(4)}
    done = torch.zeros(rows, dtype=torch.bool)
    cand_q, cand_i = torch.full((rows,), K_INIT), torch.zeros(rows, dtype=torch.int64)
    sub, step = chunk, chunk
    if frontier:
        lcm = t_n
        while lcm % 8:
            lcm += t_n
        sub = SUB // lcm * lcm
        step = chunk // sub * sub
    for cs in range(c0, c1, step):
        n = min(step, c1 - cs)
        for s0 in range(0, n, sub):
            cols = list(range(cs + s0, cs + min(s0 + sub, n)))
            if not frontier:
                lane_bests(q, admit, cols, bq, bi)
                continue
            # the bests continued over the sub-block, kept where a row has no hit
            tq, ti = dict(bq), dict(bi)
            lane_bests(q, None, cols, tq, ti)
            rh = hit[:, cols].any(1) & ~done
            keep = ~rh & ~done
            for t in bq:
                bq[t] = torch.where(keep, tq[t], bq[t])
                bi[t] = torch.where(keep, ti[t], bi[t])
            if bool(rh.any()):  # the rows that hit here: the group scan
                gq, gi = group_scan(q, hit, cols, t_n)
                cand_q = torch.where(rh, gq, cand_q)
                cand_i = torch.where(rh, gi, cand_i)
                done |= rh
    lanes = [(bq[t], bi[t]) for t in range(4)]
    for x in (1, 2):  # the quad's butterfly (__shfl_xor_sync 1, then 2)
        lanes = [merge(*lanes[t], *lanes[t ^ x]) for t in range(4)]
    for t in range(1, 4):  # every lane ends with the same result
        assert torch.equal(lanes[t][1], lanes[0][1])
    q_out, i_out = merge(*lanes[0], cand_q, cand_i)
    return q_out, i_out, done


def assert_same(q_e, i_e, q_p, i_p):
    """idx bitwise; q bitwise where the max is not zero, equal as floats
    (+0 == -0) where it is."""
    assert torch.equal(i_e.to(torch.int32), i_p), int((i_e.to(torch.int32) != i_p).sum())
    assert torch.equal(q_e, q_p)  # as floats
    nz = q_p != 0
    assert torch.equal(q_e[nz].view(torch.int32), q_p[nz].view(torch.int32))


# the kernel's chunks (mma::kCols: 512 at K = 16) and smaller ones, so that a
# few hundred columns span several chunks
CHUNKS = [16, 64, 512]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("m_valid", [1, 7, 203, 700])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_dense_merge_matches_plain(masked, m_valid, chunk):
    """K3 without the frontier: the quad lanes' strict-'>' bests merged
    give the plain version's first-occurrence argmax; with the class mask a
    row with no column of its class keeps (-3e38, 0)."""
    ai, ch, cl, sb, aux, sa, sa2 = operands(200, 704, seed=m_valid)
    rcls = ccls = admit = None
    if masked:
        rng = np.random.default_rng(7)
        rcls = torch.from_numpy(rng.integers(0, 5, 200).astype(np.int32))
        ccls = torch.from_numpy(rng.integers(0, 4, 704).astype(np.int32))  # class 4: none
        admit = rcls[:, None] == ccls[None, :]
    q, hit = key_matrix(ai, ch, cl, sa, sa2)
    q_p, i_p = mk.search_dense_torch(ai, ch, cl, sb, aux, m_valid=m_valid, rcls=rcls,
                                     ccls=ccls, **KW)
    q_e, i_e, _ = emulate(q, hit, admit, 0, m_valid, chunk, False, 4)
    assert_same(q_e, i_e, q_p, i_p)
    if masked:  # the rows of class 4 have no column
        none = rcls == 4
        assert bool(none.any()) and bool((q_p[none] == K_INIT).all())
        assert not bool(i_p[none].any())


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("m_valid", [3, 203, 700])
@pytest.mark.parametrize("t_n", range(1, 9))
def test_dense_frontier_matches_plain(t_n, m_valid, chunk):
    """K3 with the frontier, in chunks of whole groups of 64 and 128 columns
    (the frontier's mma::kCols) and of 256: sub-blocks without a hit
    continuing the lane bests and the first with one scanned by the group
    logic (groups of t_n from column 0, a column count that is no multiple
    of t_n) give the plain version's result; some rows hit, some never
    do."""
    ai, ch, cl, sb, aux, sa, sa2 = operands(200, 704, seed=t_n)
    q, hit = key_matrix(ai, ch, cl, sa, sa2)
    q_p, i_p = mk.search_dense_torch(ai, ch, cl, sb, aux, m_valid=m_valid, sa=sa, sa2=sa2,
                                     threshold=THRESHOLD, t_n=t_n, **KW)
    q_e, i_e, hit_e = emulate(q, hit, None, 0, m_valid, chunk, True, t_n)
    assert_same(q_e, i_e, q_p, i_p)
    assert 0 < int(hit_e.sum()) < 200


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("m_valid", [203, 700])
@pytest.mark.parametrize("t_n", range(1, 9))
def test_dense_masked_frontier_matches_plain(t_n, m_valid, chunk):
    """K3 with the class mask and the frontier (the masked `_thr`
    instances): a column of another class takes the key -3e38 before the
    hit test and the staging of the sub-block's keys, so it is never a hit
    and the group scan never takes it; the frontier's scan as above then
    gives the plain version's result, which masks before the frontier.  Some
    rows hit, some never do, and the rows of a class no column has keep
    (-3e38, 0)."""
    ai, ch, cl, sb, aux, sa, sa2 = operands(200, 704, seed=10 + t_n)
    rng = np.random.default_rng(t_n)
    rcls = torch.from_numpy(rng.integers(0, 4, 200).astype(np.int32))
    ccls = torch.from_numpy(rng.integers(0, 3, 704).astype(np.int32))  # class 3: none
    admit = rcls[:, None] == ccls[None, :]
    q, hit = key_matrix(ai, ch, cl, sa, sa2)
    q, hit = torch.where(admit, q, K_INIT), hit & admit
    q_p, i_p = mk.search_dense_torch(ai, ch, cl, sb, aux, m_valid=m_valid, sa=sa, sa2=sa2,
                                     rcls=rcls, ccls=ccls, threshold=THRESHOLD, t_n=t_n,
                                     **KW)
    q_e, i_e, hit_e = emulate(q, hit, admit, 0, m_valid, chunk, True, t_n)
    assert_same(q_e, i_e, q_p, i_p)
    assert 0 < int(hit_e.sum()) < 200
    none = rcls == 3
    assert bool(none.any()) and bool((q_p[none] == K_INIT).all())
    assert not bool(i_p[none].any())


def layout(block_r: int, seed: int):
    """A class-sorted layout: five classes over eight range tiles of
    ``block_r`` rows (class 1 with no columns, class 3's last tile half
    padding) and column segments of whole groups of 4 but no multiple of 8,
    on 8-column tiles."""
    tile_class = torch.tensor([0, 0, 1, 2, 3, 3, 4, 4], dtype=torch.int32)
    block_m = 8
    col_tile_start = torch.tensor([0, 30, 30, 45, 80], dtype=torch.int32)
    col_end = torch.tensor([236, 240, 300, 516, 700], dtype=torch.int32)
    col_end[1] = col_tile_start[1] * block_m  # class 1: an empty segment
    row_end = torch.tensor([2, 3, 4, 5.5, 8]) * block_r
    return (tile_class, col_tile_start, col_end, row_end.to(torch.int32), block_m)


@pytest.mark.parametrize("splits", [None, 64, 96], ids=["one", "64", "96"])
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("block_r", [8, 24, 128])
def test_classed2d_merge_matches_plain(block_r, frontier, splits):
    """K2: each split's partial by the kernel's order (without the frontier
    every row of a class's tiles, with it only the rows below row_end), in
    chunks of 64 columns, then the reduce in split order up to the first
    split that hit, give the plain K2 (and so K1) result, at one split per
    segment (several chunks) and at splits of one and of two chunks; a
    class with no columns keeps (-3e38, 0)."""
    tile_class, cts, col_end, row_end, block_m = layout(block_r, block_r)
    t_n = 4
    rows = tile_class.shape[0] * block_r
    ai, ch, cl, sb, aux, sa, sa2 = operands(rows, 704, seed=block_r + 1)
    q, hit = key_matrix(ai, ch, cl, sa, sa2)
    kw = dict(block_r=block_r, block_m=block_m, sa_s=sa, sa2_s=sa2,
              threshold=THRESHOLD if frontier else 0.0, t_n=t_n, **KW)
    q_p, i_p = mk.search_classed2d_torch(ai, ch, cl, sb, aux, tile_class, cts, col_end,
                                         row_end, splits=splits, **kw)
    q_e = torch.full((rows,), K_INIT)
    i_e = torch.zeros(rows, dtype=torch.int64)
    for tile, c in enumerate(tile_class.tolist()):
        start, end = int(cts[c]) * block_m, int(col_end[c])
        r0 = tile * block_r
        r1 = min(r0 + block_r, int(row_end[c])) if frontier else r0 + block_r
        if r1 <= r0 or end <= start:
            continue
        width = end - start if splits is None else splits
        stopped = torch.zeros(r1 - r0, dtype=torch.bool)
        for s0 in range(start, end, width):  # the reduce, in split order
            pq, pi, ph = emulate(q[r0:r1], hit[r0:r1], None, s0, min(s0 + width, end),
                                 64, frontier, t_n)  # chunks of 64 columns
            better = ~stopped & (pq > q_e[r0:r1])
            q_e[r0:r1] = torch.where(better, pq, q_e[r0:r1])
            i_e[r0:r1] = torch.where(better, pi, i_e[r0:r1])
            stopped |= ph
    assert_same(q_e, i_e, q_p, i_p)
    empty = (tile_class == 1).repeat_interleave(block_r)
    assert bool((q_p[empty] == K_INIT).all())


# K1's chunks: mma::kCols at K = 16 (512, and 128 with the frontier) and a
# smaller one, so that a segment spans several chunks; t_n 1 to 8 with the
# frontier (groups that straddle n8 tiles, sub-blocks and chunks)
K1_SCANS = ([(False, chunk, 4) for chunk in (64, 512)]
            + [(True, 128, t_n) for t_n in range(1, 9)] + [(True, 64, 3)])


def k1_layout(block_r: int, t_n: int):
    """A class-sorted layout: five classes over eight range tiles of
    ``block_r`` rows (class 1 with no columns, class 3's last tile half
    padding) and segments of whole groups of ``t_n`` on 8-column tiles:
    59, 0, 15, 40 and 3 groups (the last shorter than one chunk)."""
    tile_class = torch.tensor([0, 0, 1, 2, 3, 3, 4, 4], dtype=torch.int32)
    block_m, at, starts, ends = 8, 0, [], []
    for groups in (59, 0, 15, 40, 3):
        starts.append(at // block_m)
        ends.append(at + groups * t_n)
        at = -(-ends[-1] // block_m) * block_m
    row_end = torch.tensor([2, 3, 4, 5.5, 8]) * block_r
    return (tile_class, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(ends, dtype=torch.int32), row_end.to(torch.int32), block_m, at)


@pytest.mark.parametrize("frontier,chunk,t_n", K1_SCANS,
                         ids=[f"{'thr' if f else 'plain'}-c{c}-t{t}" for f, c, t in K1_SCANS])
@pytest.mark.parametrize("block_r", [8, 24, 128])
def test_classed_direct_write_matches_plain(block_r, frontier, chunk, t_n):
    """K1: a block per 128-row slice of a range tile searches the tile's
    whole class segment by the kernel's order (without the frontier every
    row of the slice, padding rows too; with it only the rows below
    row_end) and writes each row's (q, idx) directly; that gives the plain
    K1 result.  A class with no columns and the padding rows under the
    frontier keep (-3e38, 0)."""
    tile_class, cts, col_end, row_end, block_m, cols = k1_layout(block_r, t_n)
    rows = tile_class.shape[0] * block_r
    ai, ch, cl, sb, aux, sa, sa2 = operands(rows, cols, seed=block_r + t_n)
    q, hit = key_matrix(ai, ch, cl, sa, sa2)
    q_p, i_p = mk.search_classed_torch(ai, ch, cl, sb, aux, tile_class, cts, col_end,
                                       row_end, block_r=block_r, block_m=block_m, sa_s=sa,
                                       sa2_s=sa2, threshold=THRESHOLD if frontier else 0.0,
                                       t_n=t_n, **KW)
    q_e = torch.full((rows,), K_INIT)
    i_e = torch.zeros(rows, dtype=torch.int64)
    for tile, c in enumerate(tile_class.tolist()):
        start, end = int(cts[c]) * block_m, int(col_end[c])
        for slice0 in range(0, block_r, 128):  # the grid's row slices of the tile
            r0 = tile * block_r + slice0
            n_load = min(128, block_r - slice0)
            n_active = (max(0, min(n_load, int(row_end[c]) - r0)) if frontier else n_load)
            if n_active == 0:
                continue
            r1 = r0 + n_active
            pq, pi, _ = emulate(q[r0:r1], hit[r0:r1], None, start, end, chunk, frontier, t_n)
            q_e[r0:r1], i_e[r0:r1] = pq, pi  # the direct write
    assert_same(q_e, i_e, q_p, i_p)
    empty = (tile_class == 1).repeat_interleave(block_r)
    assert bool((q_p[empty] == K_INIT).all()) and not bool(i_p[empty].any())
    if frontier:  # class 3's padding rows
        padding = torch.arange(rows)
        padding = (padding >= int(row_end[3])) & (padding < 6 * block_r)
        assert bool((q_p[padding] == K_INIT).all()) and not bool(i_p[padding].any())
        assert 0 < int(hit.any(1).sum())


# K4/K5's step (csrc/micro_step.cu): the lane policy of each variant
# (mma::Policy), K5 being K4 'full' on the [K, M] layout
MICRO_POLICIES = {"full": "Argmax", "full_t": "Argmax", "noargpass": "MaxOnly",
                  "packed": "PackedMax", "matmul": "DotMax"}


def micro_partial(q, start, policy):
    """One step's partial (q, idx) per row by the mainloop's order: ``q``
    [rows, block_m] the keys of the columns [start, start + block_m) (f32(dot)
    for DotMax), each lane t folding the columns 2t and 2t + 1 of every n8
    tile from ``start`` by its policy, then the quad's butterfly."""
    off = torch.arange(q.shape[1])
    lanes = []
    for t in range(4):
        cols = off[(off % 8) // 2 == t]
        v = q[:, cols]
        if policy == "Argmax":  # the strict '>' in column order: the first maximum
            first = (v == v.amax(1, keepdim=True)).int().argmax(1)
            lanes.append((v.gather(1, first[:, None])[:, 0], cols[first] + start))
        elif policy == "PackedMax":  # the int max of the packed key
            key = (v.view(torch.int32) & ~4095) | (4095 - cols.to(torch.int32))
            lanes.append((None, key.amax(1)))
        else:  # MaxOnly, DotMax: fmaxf
            lanes.append((v.amax(1), None))
    for x in (1, 2):  # the quad's butterfly
        if policy == "Argmax":
            lanes = [merge(*lanes[t], *lanes[t ^ x]) for t in range(4)]
        elif policy == "PackedMax":
            lanes = [(None, torch.maximum(lanes[t][1], lanes[t ^ x][1])) for t in range(4)]
        else:
            lanes = [(torch.maximum(lanes[t][0], lanes[t ^ x][0]), None) for t in range(4)]
    bq, bi = lanes[0]
    if policy == "PackedMax":  # the key's q, and its column
        return (bi & ~4095).view(torch.float32), 4095 - (bi & 4095).long() + start
    if policy != "Argmax":  # idx: the tile's first column
        return bq, torch.full_like(bq, start, dtype=torch.int64)
    return bq, bi


def micro_emulate(q, words, n_pairs, policy, block_r, block_m, n_rt, n_ct):
    """K4's two passes: each word's step partial (a block per 128-row slice
    searches the column tile as one K1 segment; the slices do not change a
    row's result), then the reduce in list order: a word naming no tile
    skipped, `first` restarting the tile's rows, a partial taken only where
    strictly above."""
    q_out = torch.full((q.shape[0],), K_INIT)
    i_out = torch.zeros(q.shape[0], dtype=torch.int64)
    for w in words[:n_pairs].tolist():
        rt, ct, first = w >> mt.RT_SHIFT, (w >> 2) & 4095, (w >> 1) & 1
        if not (0 <= rt < n_rt and ct < n_ct):
            continue
        rows = slice(rt * block_r, (rt + 1) * block_r)
        start = ct * block_m
        pq, pi = micro_partial(q[rows, start:start + block_m], start, policy)
        if first:
            q_out[rows], i_out[rows] = K_INIT, 0
        better = pq > q_out[rows]
        q_out[rows] = torch.where(better, pq, q_out[rows])
        i_out[rows] = torch.where(better, pi, i_out[rows])
    return q_out, i_out


def micro_words(ni, nj, revisit):
    """The pair list: each range tile over its column tiles once, or (revisit)
    twice with a restart midway, a word outside the rows and one outside the
    columns, and the last range tile never visited."""
    if not revisit:
        steps = [(rt, ct, int(ct == 0)) for rt in range(ni) for ct in range(nj)]
    else:
        steps = [(0, ct, int(ct == 0)) for ct in range(nj)] + [(0, 1, 1), (0, 0, 0)]
        steps += [(ni, 0, 1), (1, nj, 0)]
        for rt in range(1, ni - 1):
            steps += [(rt, ct % nj, int(ct == 0)) for ct in range(2 * nj)]
    rt, ct, first = (torch.tensor(c, dtype=torch.int32) for c in zip(*steps))
    return mt.pack_pairs(rt, ct, first, torch.ones_like(rt)), len(steps)


# (ni, block_r, nj, block_m): ragged tiles (a 128-row slice and a part; a
# 512-column chunk and a part) as in test_torch_cuda.py's MICRO_TILES, and
# whole ones
MICRO_TILES = [(3, 200, 5, 1000), (2, 128, 3, 1024)]


@pytest.mark.parametrize("revisit", [False, True], ids=["once", "revisit"])
@pytest.mark.parametrize("tiles", MICRO_TILES, ids=["200x1000", "128x1024"])
@pytest.mark.parametrize("variant", list(MICRO_POLICIES))
def test_micro_step_policies_match_plain(variant, tiles, revisit):
    """Each K4/K5 variant's lane policy and quad merge (Argmax, MaxOnly,
    PackedMax, DotMax) over each step's column tile, with the partials folded
    by the reduce in list order, gives the plain micro_step_torch's result."""
    ni, br, nj, bm = tiles
    ai, ch, cl, sb, aux, sa, sa2 = operands(ni * br, nj * bm, seed=br + nj)
    words, n = micro_words(ni, nj, revisit)
    policy = MICRO_POLICIES[variant]
    if policy == "DotMax":
        q = (ai.long() @ (8 * ch.long() + cl.long()).T).to(torch.float32)
    else:
        q, _ = key_matrix(ai, ch, cl, sa, sa2)
    t = variant == "full_t"
    q_p, i_p = mt.micro_step_torch(words, n, ai, ch.T.contiguous() if t else ch,
                                   cl.T.contiguous() if t else cl, sb, aux, variant=variant,
                                   block_r=br, block_m=bm)
    q_e, i_e = micro_emulate(q, words, n, policy, br, bm, ni, nj)
    assert_same(q_e, i_e, q_p, i_p)
    assert bool((q_p[(ni - 1) * br:] == K_INIT).all()) == revisit  # the tile no word visits


# ---------------------------------------------------------------------------
# the padded instances and the K-slab form (csrc/search_common.cuh's Geom):
# operands of n bytes a row at the kernels' width K, zero past n


def width_operands(rows: int, cols: int, n: int, seed: int, extreme: bool = False):
    """Operands of ranges of n pixels at K = kernel_width(n), zero past n:
    ``operands``' small values with repeated columns (ties), or (extreme)
    the int8 operands' whole ranges (ai -128..127, ch 0..127, cl 0..7), so
    that the K-slab form's int32 sums grow large.  SumA = 0 and SumA2 in
    0..7: with inv_norm = n the 'ls' distance is n SumA2 - q, so the rows
    of SumA2 0 hit often and the others rarely or never."""
    rng = np.random.default_rng(seed)
    k = mk.kernel_width(n)
    lo, hi = (-128, 128) if extreme else (-3, 4)
    ai = rng.integers(lo, hi, (rows, n))
    ch = rng.integers(0, 128 if extreme else 4, (cols, n))
    cl = rng.integers(0, 8, (cols, n))
    if not extreme:
        rep = np.flatnonzero(rng.random(cols) < 0.4)
        ch[rep], cl[rep] = ch[rep - 1], cl[rep - 1]
    pad = lambda x: torch.from_numpy(np.pad(x, ((0, 0), (0, k - n))).astype(np.int8))
    sa = torch.zeros(rows)
    sa2 = torch.from_numpy(rng.integers(0, 8, rows).astype(np.float32))
    return (pad(ai), pad(ch), pad(cl), torch.zeros(cols), torch.ones(cols), sa, sa2)


def slab_dots(ai, ch, cl, chunk: int = 64, slab: int = 256):
    """The K-slab form's dot of every pair: per chunk of ``chunk`` columns,
    dh = ai . ch and dl = ai . cl summed slab by slab (``slab`` bytes of the
    rows at a time), each running sum checked to stay inside the kernel's
    int32 accumulators, then dot = 8 dh + dl in int64."""
    rows, k = ai.shape
    cols = ch.shape[0]
    dh = torch.zeros((rows, cols), dtype=torch.int64)
    dl = torch.zeros_like(dh)
    for c0 in range(0, cols, chunk):
        c = slice(c0, c0 + chunk)
        for s0 in range(0, k, slab):
            s = slice(s0, s0 + slab)
            dh[:, c] += ai[:, s].long() @ ch[c, s].long().T
            dl[:, c] += ai[:, s].long() @ cl[c, s].long().T
            assert int(dh[:, c].abs().max()) < 2 ** 31 and int(dl[:, c].abs().max()) < 2 ** 31
    return 8 * dh + dl


def width_keys(dot, ai, sa, sa2, n: int):
    """(keys, hits) of every pair from its dot: the table key (SumA from the
    row's bytes and 128 n) and rank_to_dist's distance against the
    threshold, at n."""
    sa_i = ai.long().sum(1, keepdim=True) + 128 * n
    q = table_key(sa_i, dot, None, None, n)
    kw = dict(KW, inv_norm=float(n))
    dist = mk.rank_to_dist(q, sa2[:, None], sa[:, None], n=float(n), **kw)
    return q, dist <= torch.tensor(THRESHOLD, dtype=torch.float32)


WIDTH_SCANS = [(False, 4), (True, 3), (True, 4), (True, 8)]


@pytest.mark.parametrize("frontier,t_n", WIDTH_SCANS,
                         ids=[f"{'thr' if f else 'plain'}-t{t}" for f, t in WIDTH_SCANS])
@pytest.mark.parametrize("n", [4, 9, 36, 49, 100, 144])
def test_padded_widths_match_plain(n, frontier, t_n):
    """The padded instances: K3's scan at K = kernel_width(n) (16, 64 or 256)
    in its chunks (mma::kCols: 512, 128 with the frontier at K = 16; 128 at
    64; 64 at 256) over operands zero past n, the keys reading n, gives the
    plain version's result at n; the zero bytes leave every dot as the
    unpadded operands' dot."""
    k = mk.kernel_width(n)
    assert k > n
    ai, ch, cl, sb, aux, sa, sa2 = width_operands(160, 500, n, seed=n + t_n)
    b4 = 8 * ch.long() + cl.long()
    dot = ai.long() @ b4.T
    assert torch.equal(dot, ai[:, :n].long() @ b4[:, :n].T)
    q, hit = width_keys(dot, ai, sa, sa2, n)
    chunk = {16: 128 if frontier else 512, 64: 128, 256: 64}[k]
    q_p, i_p = mk.search_dense_torch(ai, ch, cl, sb, aux, m_valid=500, sa=sa, sa2=sa2,
                                     threshold=THRESHOLD if frontier else 0.0, t_n=t_n,
                                     n=n, **dict(KW, inv_norm=float(n)))
    q_e, i_e, hit_e = emulate(q, hit, None, 0, 500, chunk, frontier, t_n)
    assert_same(q_e, i_e, q_p, i_p)
    if frontier:
        assert 0 < int(hit_e.sum()) < 160


@pytest.mark.parametrize("frontier,t_n", WIDTH_SCANS,
                         ids=[f"{'thr' if f else 'plain'}-t{t}" for f, t in WIDTH_SCANS])
@pytest.mark.parametrize("n", [257, 1024, 2500])
def test_slab_sums_match_plain(n, frontier, t_n):
    """The K-slab form: its dots from dh and dl summed slab by slab in int32
    over chunks of 64 columns (on operands at the int8 ranges' ends, so the
    sums grow large) are the plain version's dots, and its scan over them
    gives the plain version's result at n."""
    ai, ch, cl, sb, aux, sa, sa2 = width_operands(48, 200, n, seed=n + t_n, extreme=True)
    assert ai.shape[1] == -(-n // 256) * 256
    dot = slab_dots(ai, ch, cl)
    assert torch.equal(dot, ai.double().matmul((8 * ch.double() + cl.double()).T).long())
    q, hit = width_keys(dot, ai, sa, sa2, n)
    q_p, i_p = mk.search_dense_torch(ai, ch, cl, sb, aux, m_valid=200, sa=sa, sa2=sa2,
                                     threshold=THRESHOLD if frontier else 0.0, t_n=t_n,
                                     n=n, **dict(KW, inv_norm=float(n)))
    q_e, i_e, hit_e = emulate(q, hit, None, 0, 200, 64, frontier, t_n)
    assert_same(q_e, i_e, q_p, i_p)
    if frontier:
        assert 0 < int(hit_e.sum()) < 48


def test_slab_sum_bound():
    """The K-slab form's dh sums, at most n * 128 * 127 in magnitude, stay
    inside int32 up to MAX_SLAB_N and leave it just above."""
    assert mk.MAX_SLAB_N * 128 * 127 < 2 ** 31 <= (mk.MAX_SLAB_N + 1) * 128 * 127
