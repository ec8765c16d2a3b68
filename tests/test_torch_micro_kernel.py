"""Port parity, K4 and K5 (the pair-list step microbenchmark's kernels), on
the CPU: the port's plain version (``ops/micro_kernels``) against the JAX
script's own kernel bodies, run in interpret mode, and the port's own rules.

``scripts/micro_kernel.py`` cannot be imported (it times the TPU kernels at
import), so ``kernel``, ``run``, ``kernel_t`` and ``run_t`` are taken from its
source with ``ast`` and executed at test-sized tiles, with the JAX package's
``_BIG``, ``_pair_ab_int8_raw`` and ``_rank_ls_int8`` and ``pallas_call`` in
interpret mode.  The script decodes rt at bit 12 and ct in 10 bits, a layout
older than the JAX package's ``_pack_pairs`` (rt at bit 14, 12 column bits),
so its kernels get words in their own layout and the port gets
``pack_pairs`` words for the same (rt, ct, first).  Tolerance 0: (q, idx)
bitwise on every row tile the list visits.
"""
import ast
import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import assert_bitwise

from fractencode_tpu.ops.matcher_pallas import (_BIG, _pack_pairs, _pair_ab_int8_raw,
                                                _rank_ls_int8)
from fractencode_tpu_torch.ops import micro_kernels as mt
from fractencode_tpu_torch.scripts import micro_kernel as script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "micro_kernel.py")
# test-sized tiles: NI range tiles of BR rows, NJ column tiles of BM columns
BR, BM, K, NI, NJ = 16, 128, 16, 3, 4
P_CAP = 64  # every list padded to one length: one compile per variant
VARIANTS = ("full", "noargpass", "packed", "matmul", "full_t")


def _script_tree():
    with open(SCRIPT) as f:
        return ast.parse(f.read())


@functools.lru_cache(maxsize=None)
def _script_kernels():
    """The JAX script's ``run`` and ``run_t`` at the test's tiles."""
    fns = [n for n in _script_tree().body
           if isinstance(n, ast.FunctionDef) and n.name in ("kernel", "run", "kernel_t", "run_t")]
    assert len(fns) == 4
    pl_interp = types.SimpleNamespace(**{a: getattr(pl, a) for a in dir(pl)
                                         if not a.startswith("__")})
    pl_interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(functools=functools, jax=jax, jnp=jnp, pl=pl_interp, pltpu=pltpu, _BIG=_BIG,
              _pair_ab_int8_raw=_pair_ab_int8_raw, _rank_ls_int8=_rank_ls_int8,
              BR=BR, BM=BM, K=K, R_PAD=NI * BR, M_PAD=NJ * BM)
    exec(compile(ast.Module(body=fns, type_ignores=[]), SCRIPT, "exec"), ns)
    return ns["run"], ns["run_t"]


def _draw(rng):
    """Operands under the script's draw law (its lines 111-116)."""
    return dict(ai=rng.integers(-128, 128, (NI * BR, K), np.int8),
                ch=rng.integers(0, 128, (NJ * BM, K), np.int8),
                cl=rng.integers(0, 8, (NJ * BM, K), np.int8),
                sb=rng.random(NJ * BM, np.float32) * 100,
                aux=rng.random(NJ * BM, np.float32))


def _ties(rng):
    """Many equal keys at each row's max: ai in [-2, 2), ch in {0, 1}, cl 0,
    sb in {0, 0.25}, aux 0.5; columns 64-79 of tile 1 copy its columns 0-15;
    column tile 2 is one column repeated."""
    ops = dict(ai=rng.integers(-2, 2, (NI * BR, K), np.int8),
               ch=rng.integers(0, 2, (NJ * BM, K), np.int8),
               cl=np.zeros((NJ * BM, K), np.int8),
               sb=rng.integers(0, 2, NJ * BM).astype(np.float32) * 0.25,
               aux=np.full(NJ * BM, 0.5, np.float32))
    for name in ("ch", "cl", "sb", "aux"):
        ops[name][BM + 64:BM + 80] = ops[name][BM:BM + 16]
        ops[name][2 * BM:3 * BM] = ops[name][2 * BM]
    return ops


def _script_list(reps):
    """The script's list: range tile by range tile, every column tile in
    order ``reps`` times, ``first`` on each tile's first step."""
    steps = []
    for rt in range(NI):
        for i in range(NJ * reps):
            steps.append((rt, i % NJ, int(i == 0)))
    return steps


# (rt, ct, first) lists: the script's at reps 1 and 3; with ties, column
# tiles revisited later in a tile's run (and the all-equal tile 2); a tile
# restarted by a second `first` right after its first run
LISTS = {
    "draw_reps1": (_draw, _script_list(1)),
    "draw_reps3": (_draw, _script_list(3)),
    "ties": (_ties, [(0, 2, 1), (0, 0, 0), (0, 1, 0), (0, 0, 0), (0, 2, 0),
                     (1, 1, 1), (1, 3, 0), (1, 1, 0), (1, 2, 0),
                     (2, 2, 1), (2, 2, 0), (2, 0, 0), (2, 3, 0), (2, 0, 0)]),
    "restart": (_draw, [(1, 0, 1), (1, 1, 0), (1, 2, 0), (1, 3, 1), (1, 1, 0),
                        (0, 0, 1), (0, 3, 0), (0, 1, 0),
                        (2, 1, 1), (2, 0, 0), (2, 2, 1), (2, 3, 0), (2, 0, 0)]),
}


def _words_script(steps):
    """The script's own decode layout: rt << 12 | ct << 2 | first << 1 | 1."""
    w = np.zeros(P_CAP, np.int32)
    w[:len(steps)] = [rt << 12 | ct << 2 | first << 1 | 1 for rt, ct, first in steps]
    return w


def _words_port(steps):
    rt, ct, first = (torch.tensor(c, dtype=torch.int32) for c in zip(*steps))
    w = torch.zeros(P_CAP, dtype=torch.int32)
    w[:len(steps)] = mt.pack_pairs(rt, ct, first, torch.ones_like(rt))
    return w


def _port(ops, words, n, variant, block_r=BR, block_m=BM):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ops.items()}
    ch, cl = (t[k].T.contiguous() if variant == "full_t" else t[k] for k in ("ch", "cl"))
    return mt.micro_step_torch(words, n, t["ai"], ch, cl, t["sb"], t["aux"],
                               variant=variant, block_r=block_r, block_m=block_m)


def _script(ops, steps, variant):
    run, run_t = _script_kernels()
    words = jnp.asarray(_words_script(steps))
    n = jnp.int32(len(steps))
    sb, aux = ops["sb"][None], ops["aux"][None]
    if variant == "full_t":
        q, i = run_t(words, n, ops["ai"], ops["ch"].T.copy(), ops["cl"].T.copy(), sb, aux)
    else:
        q, i = run(words, n, ops["ai"], ops["ch"], ops["cl"], sb, aux, variant)
    return np.asarray(q)[:, 0], np.asarray(i)[:, 0]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", list(LISTS))
def test_plain_matches_script_kernel(case, variant):
    """Each plain variant equals the script's kernel body ('full_t': its
    ``run_t``), (q, idx) bitwise, on every visited row tile."""
    make, steps = LISTS[case]
    ops = make(np.random.default_rng(7))
    q_j, i_j = _script(ops, steps, variant)
    q_t, i_t = _port(ops, _words_port(steps), len(steps), variant)
    rows = np.zeros(NI * BR, bool)
    for rt, _, _ in steps:
        rows[rt * BR:(rt + 1) * BR] = True
    assert_bitwise(q_t.numpy()[rows], q_j[rows], f"{case} {variant} q")
    assert_bitwise(i_t.numpy()[rows], i_j[rows], f"{case} {variant} idx")


def test_ties_take_the_lowest_lane_and_the_earlier_step():
    """On the all-equal tile 'full' takes its first column and 'packed' its
    lowest lane; a revisited tile's equal step leaves the earlier one."""
    ops = _ties(np.random.default_rng(7))
    steps = [(0, 2, 1), (0, 2, 0)]
    for variant in ("full", "packed"):
        q, i = _port(ops, _words_port(steps), 2, variant)
        assert (i[:BR] == 2 * BM).all(), variant
    q, i = _port(ops, _words_port([(0, 1, 1), (0, 1, 0)]), 2, "full")
    q1, i1 = _port(ops, _words_port([(0, 1, 1)]), 1, "full")
    assert_bitwise(q, q1, "q")
    assert_bitwise(i, i1, "idx")


@pytest.mark.parametrize("variant", VARIANTS)
def test_unvisited_tiles_hold_the_initial_value(variant):
    """Rows of a tile no word visits, and the steps of words outside the
    operands, leave (-_BIG, 0)."""
    ops = _draw(np.random.default_rng(3))
    words = _words_port([(1, 0, 1), (1, 3, 0)])
    words[2] = mt.pack_pairs(*(torch.tensor([v], dtype=torch.int32) for v in (2, NJ, 1, 1)))
    words[3] = mt.pack_pairs(*(torch.tensor([v], dtype=torch.int32) for v in (NI, 0, 1, 1)))
    q, i = _port(ops, words, 4, variant)
    for rt in (0, 2):
        rows = slice(rt * BR, (rt + 1) * BR)
        assert (q[rows] == np.float32(-_BIG)).all() and (i[rows] == 0).all()
    assert (q[BR:2 * BR] > -_BIG).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_four_repetitions_equal_one(variant):
    """Each repetition of the script's list is the same steps again: a strict
    '>' keeps the first repetition's winner."""
    ops = _draw(np.random.default_rng(5))
    q1, i1 = _port(ops, _words_port(_script_list(1)), NI * NJ, variant)
    q4, i4 = _port(ops, _words_port(_script_list(4)), NI * NJ * 4, variant)
    assert_bitwise(q4, q1, "q")
    assert_bitwise(i4, i1, "idx")


def test_pack_pairs_equals_jax():
    """``pack_pairs`` equals the JAX package's ``_pack_pairs`` on random
    fields over their whole ranges."""
    rng = np.random.default_rng(11)
    n = 4096
    rt = rng.integers(0, 1 << (31 - mt.RT_SHIFT), n, dtype=np.int32)
    ct = rng.integers(0, 1 << 12, n, dtype=np.int32)
    first, compute = rng.integers(0, 2, (2, n)).astype(bool)
    j = np.asarray(_pack_pairs(jnp.asarray(rt), jnp.asarray(ct), jnp.asarray(first),
                               jnp.asarray(compute)))
    t = mt.pack_pairs(torch.from_numpy(rt), torch.from_numpy(ct), torch.from_numpy(first),
                      torch.from_numpy(compute))
    assert_bitwise(t, j, "words")
    assert mt.RT_SHIFT == 14


def test_script_decode_is_stale():
    """The JAX script decodes rt as word >> 12 (10 column bits); the
    package's ``_pack_pairs`` puts rt at bit 14, so the script reads row
    tile 4 rt.  The port decodes the package's layout."""
    rt = jnp.arange(8, dtype=jnp.int32)
    w = np.asarray(_pack_pairs(rt, jnp.full(8, 5, jnp.int32), jnp.ones(8, bool),
                               jnp.ones(8, jnp.int32)))
    assert ((w >> 12) == 4 * np.arange(8)).all()
    assert ((w >> 2) & 1023 == 5).all() and ((w >> 1) & 1 == 1).all()
    assert ((w >> mt.RT_SHIFT) == np.arange(8)).all()
    text = open(SCRIPT).read()
    assert "pairs[p] >> 12" in text and "(packed >> 2) & 1023" in text


def test_make_inputs_equals_the_script_draws():
    """``make_inputs`` gives the JAX script's numpy draws bit for bit at its
    shapes (its own assignment lines, run with numpy in place of jnp), and
    ``make_pairs`` its list in the port's layout."""
    draws = [n for n in _script_tree().body if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Name) and n.targets[0].id in ("rng", "ai", "ch", "cl", "sb", "aux")]
    assert [n.targets[0].id for n in draws] == ["rng", "ai", "ch", "cl", "sb", "aux"]
    ns = dict(np=np, jnp=types.SimpleNamespace(asarray=np.asarray), K=script.K,
              R_PAD=script.R_PAD, M_PAD=script.M_PAD)
    exec(compile(ast.Module(body=draws, type_ignores=[]), SCRIPT, "exec"), ns)
    got = script.make_inputs("cpu")
    for name in ("ai", "ch", "cl", "sb", "aux"):
        assert_bitwise(got[name].numpy(), ns[name].reshape(got[name].shape), name)
    assert_bitwise(got["chT"].numpy(), ns["ch"].T, "chT")
    assert_bitwise(got["clT"].numpy(), ns["cl"].T, "clT")
    for reps in (1, 4):
        words, n = script.make_pairs(reps)
        w = words[:n].numpy()
        assert n == script.NI * script.NJ * reps and (words[n:] == 0).all()
        assert ((w >> mt.RT_SHIFT) == np.repeat(np.arange(script.NI), script.NJ * reps)).all()
        assert (((w >> 2) & 4095) == np.tile(np.arange(script.NJ), script.NI * reps)).all()
        assert ((w >> 1) & 1).sum() == script.NI and (w & 1).all()


def _bad_args(variant="full", **over):
    ops = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in _draw(np.random.default_rng(1)).items()}
    args = dict(words=_words_port(_script_list(1)), n_pairs=NI * NJ, ai=ops["ai"],
                ch=ops["ch"], cl=ops["cl"], sb=ops["sb"], aux=ops["aux"])
    kw = dict(variant=variant, block_r=BR, block_m=BM)
    for k, v in over.items():
        (kw if k in kw else args)[k] = v(args) if callable(v) else v
    return args, kw


# each refused input: (variant, overrides, message)
BAD = {
    "packed_bm_above_4096": ("packed", dict(block_m=8192, ch=lambda a: a["ch"].repeat(16, 1),
                                            cl=lambda a: a["cl"].repeat(16, 1),
                                            sb=lambda a: a["sb"].repeat(16),
                                            aux=lambda a: a["aux"].repeat(16)), "12 bits"),
    "k_not_16": ("full", dict(ai=lambda a: a["ai"][:, :8].contiguous()), "K = 16"),
    "k5_row_layout": ("full_t", {}, r"\[K, M\]"),
    "words_not_i32": ("full", dict(words=lambda a: a["words"].to(torch.int64)), "int32"),
    "n_pairs_beyond_the_list": ("full", dict(n_pairs=P_CAP + 1), "the list's length"),
    "tiles_not_dividing": ("full", dict(block_r=BR + 1), "divide"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_refuses_bad_inputs(case):
    """Both versions refuse what the function does not take, by raising; on
    the CPU the wrapper runs the plain version, which raises the same."""
    variant, over, msg = BAD[case]
    args, kw = _bad_args(variant, **over)
    before = dict(mt.micro_step_cuda.launches)
    for fn in (mt.micro_step_torch, mt.micro_step_cuda):
        with pytest.raises(ValueError, match=msg):
            fn(*args.values(), **kw)
    assert mt.micro_step_cuda.launches == before


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result and
    counts no launch."""
    args, kw = _bad_args("packed")
    before = dict(mt.micro_step_cuda.launches)
    q_w, i_w = mt.micro_step_cuda(*args.values(), **kw)
    q_p, i_p = mt.micro_step_torch(*args.values(), **kw)
    assert_bitwise(q_w, q_p, "q")
    assert_bitwise(i_w, i_p, "idx")
    assert mt.micro_step_cuda.launches == before


def test_cli_without_a_card_exits_2(tmp_path):
    """With no card the microbenchmark exits 2 and says so; it never runs
    the plain version in the kernel's place."""
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "fractencode_tpu_torch.scripts.micro_kernel"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr and proc.stdout == ""
