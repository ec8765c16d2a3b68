"""The pair-list step microbenchmark's kernels: K4 and K5.

Counterpart of the TPU kernels in ``scripts/micro_kernel.py``: ``kernel``
through ``run`` (K4, four variants) and ``kernel_t`` through ``run_t`` (K5).
They take one step of K1's ``ls_fast`` search over a packed pair list at
K = 16, with parts removed, so that a step's cost splits into its dots, its
integer epilogue and its argmax.

The function (one definition for the plain version and the kernel):

  * The list.  The first ``n_pairs`` words of ``words`` are folded in list
    order.  A word is ``rt << RT_SHIFT | ct << 2 | first << 1 | compute``, as
    ``pack_pairs`` (the JAX package's ``_pack_pairs``) packs it; ``compute``
    is not read.  A word whose rt or ct lies outside the operands names no
    tile and is skipped, ``first`` included.
  * Every row starts at (-_BIG, 0); ``first`` resets the rows of tile rt to
    it before its step, so rows of a tile no word visits keep it.
  * One step (rt, ct) takes rows [rt*block_r, (rt+1)*block_r) against
    columns [ct*block_m, (ct+1)*block_m): dot = sum ai * (8 ch + cl), exact
    in int32, and the key q:
      - 'full', 'noargpass', 'packed', 'full_t': the 'ls' key
        (``matcher_kernels._rank_ls_int8``): sa_i = rowsum(ai) + 128*16,
        sb4 = int32(4 sb) truncated toward zero (sb need not be a multiple of
        0.25 here), cov4 = 16 dot + (2048 - sa_i) sb4 in int32,
        q = (f32(cov4) * f32(cov4)) * (aux * 0.0625);
      - 'matmul': q = f32(dot), no key.
  * The tile's best (tile_q, tile_arg):
      - 'full', 'full_t': the row max, at the lowest column holding it;
      - 'noargpass', 'matmul': the row max, at the tile's first column;
      - 'packed': the int32 max of key = (bits(q) & ~4095) | (4095 - lane),
        lane the column within the tile (block_m <= 4096);
        tile_q = float(bits of kmax & ~4095), tile_arg = 4095 -
        (kmax & 4095) + ct*block_m.  Not exact against 'full' by design.
  * The carry: the row takes (tile_q, tile_arg) only where tile_q is
    strictly above its current q, so a later equal step never replaces an
    earlier one.
  * 'full_t' (K5) is 'full' with ch and cl stored as [16, M].

Returns (q [R] f32, idx [R] i32).

Two versions: ``micro_step_torch``, the plain PyTorch version, and
``micro_step_cuda``, the wrapper of the hand-written CUDA kernel
``csrc/micro_step.cu``, which routes on the tensors' device as the search
wrappers do (``matcher_kernels``): CPU tensors run the plain version, CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from .matcher_kernels import _BIG, _BIG_I, CT_BITS, _check, _rank_ls_int8

__all__ = ["K", "RT_SHIFT", "VARIANTS", "pack_pairs", "micro_step_torch",
           "micro_step_cuda"]

K = 16
# the pair word's fields (matcher_pallas.py:496-505): compute at bit 0, first
# at bit 1, ct in CT_BITS bits from bit 2, rt above
RT_SHIFT = 2 + CT_BITS
_CT_MASK = (1 << CT_BITS) - 1
# the variants of K4 (row-layout ch and cl) and K5's 'full_t' ([K, M] layout)
VARIANTS = ("full", "noargpass", "packed", "matmul", "full_t")
# 'packed' keeps the lane in the key's low 12 bits
_PACKED_MAX_BM = 4096


def pack_pairs(rt, ct, first, compute):
    """Pair words (int32) from int32 rt and ct and bool or int first and
    compute: the JAX package's ``_pack_pairs``."""
    return ((rt << RT_SHIFT) | (ct << 2) | (first.to(torch.int32) << 1)
            | compute.to(torch.int32))


def _shapes(words, n_pairs, ai, ch, cl, sb, aux, variant, block_r, block_m):
    """Check the arguments' types and shapes on any device; return the
    number of row and column tiles."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError(f"words: expected a 1-D int32 list, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if not 0 <= n_pairs <= words.shape[0]:
        raise ValueError(f"n_pairs {n_pairs} outside [0, {words.shape[0]}], the list's length")
    if ai.dtype != torch.int8 or ai.dim() != 2 or ai.shape[1] != K:
        raise ValueError(f"ai: expected int8 [R, {K}] (the step is K = {K}), got "
                         f"{ai.dtype} {tuple(ai.shape)}")
    m = sb.shape[0]
    layout = (K, m) if variant == "full_t" else (m, K)
    for name, t in (("ch", ch), ("cl", cl)):
        if t.dtype != torch.int8 or tuple(t.shape) != layout:
            raise ValueError(f"{name}: expected int8 {layout} for variant {variant!r}"
                             f" ({'[K, M]' if variant == 'full_t' else '[M, K]'}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("sb", sb), ("aux", aux)):
        if t.dtype != torch.float32 or tuple(t.shape) != (m,):
            raise ValueError(f"{name}: expected float32 ({m},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    r = ai.shape[0]
    if block_r < 1 or r % block_r or block_m < 4 or block_m % 4 or m % block_m:
        raise ValueError(f"tiles {block_r} x {block_m} must divide the operands "
                         f"{r} x {m}, with block_m a multiple of 4")
    if variant == "packed" and block_m > _PACKED_MAX_BM:
        raise ValueError(f"'packed' keeps the lane in 12 bits: block_m {block_m} > "
                         f"{_PACKED_MAX_BM}")
    n_rt, n_ct = r // block_r, m // block_m
    if n_ct > _CT_MASK + 1 or n_rt > 1 << (31 - RT_SHIFT):
        raise ValueError(f"{n_rt} x {n_ct} tiles do not fit the pair word's fields")
    devs = {t.device for t in (words, ai, ch, cl, sb, aux)}
    if len(devs) > 1:
        raise ValueError(f"tensors on several devices: {devs}")
    return n_rt, n_ct


def micro_step_torch(words, n_pairs: int, ai, ch, cl, sb, aux, *, variant: str,
                     block_r: int, block_m: int):
    """Plain PyTorch version of K4 and K5 (the module's docstring gives the
    function).  The dot is one matmul of ai against 8 ch + cl: float32 on
    the card (with TF32 off every partial sum is an integer below 2^24 at
    K = 16, so exact), float64 on the CPU.  The list is read back to the host
    and folded step by step."""
    n_rt, n_ct = _shapes(words, n_pairs, ai, ch, cl, sb, aux, variant, block_r, block_m)
    dev = ai.device
    mm_dtype = torch.float32 if dev.type == "cuda" else torch.float64
    if variant == "full_t":
        ch, cl = ch.T, cl.T
    a_mm = ai.to(mm_dtype)
    b_mm = (8 * ch.to(torch.int32) + cl.to(torch.int32)).to(mm_dtype)
    sa_i = ai.to(torch.int32).sum(1, dtype=torch.int32) + 128 * K
    sb4 = (4.0 * sb).to(torch.int32)  # truncates toward zero
    aux16 = aux * 0.0625
    lanes = torch.arange(block_m, dtype=torch.int32, device=dev)
    q_out = torch.full((ai.shape[0],), -_BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros((ai.shape[0],), dtype=torch.int32, device=dev)
    for w in words[:n_pairs].tolist():
        rt, ct, first = w >> RT_SHIFT, (w >> 2) & _CT_MASK, (w >> 1) & 1
        if not (0 <= rt < n_rt and ct < n_ct):
            continue  # names no tile
        rows = slice(rt * block_r, (rt + 1) * block_r)
        c0 = ct * block_m
        cols = slice(c0, c0 + block_m)
        dot = (a_mm[rows] @ b_mm[cols].T).to(torch.int32)
        if variant == "matmul":
            q = dot.to(torch.float32)
        else:
            q = _rank_ls_int8(sa_i[rows, None], dot, sb4[None, cols], aux16[None, cols], K)
        if variant == "packed":
            key = (q.view(torch.int32) & ~4095) | (4095 - lanes)
            kmax = key.amax(1)
            tile_q = (kmax & ~4095).view(torch.float32)
            tile_arg = 4095 - (kmax & 4095) + c0
        else:
            tile_q = q.amax(1)
            if variant in ("noargpass", "matmul"):
                tile_arg = torch.full_like(idx_out[rows], c0)
            else:
                tile_arg = torch.where(q == tile_q[:, None], lanes, _BIG_I).amin(1) + c0
        if first:
            q_out[rows] = -_BIG
            idx_out[rows] = 0
        improved = tile_q > q_out[rows]
        idx_out[rows] = torch.where(improved, tile_arg.to(torch.int32), idx_out[rows])
        q_out[rows] = torch.where(improved, tile_q, q_out[rows])
    return q_out, idx_out


def _kernel_fn(variant: str):
    """The C entry point ``fe_micro_step_<variant>`` (its library built and
    loaded on first use)."""
    from ._build import load_library

    fn = getattr(load_library("micro_step"), f"fe_micro_step_{variant}")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def micro_step_cuda(words, n_pairs: int, ai, ch, cl, sb, aux, *, variant: str,
                    block_r: int, block_m: int):
    """K4's and K5's hand-written CUDA kernel, with the arguments and result
    of ``micro_step_torch``.

    CPU tensors run the plain version.  CUDA tensors launch
    ``csrc/micro_step.cu`` (and add one to ``micro_step_cuda.launches[variant]``)
    or raise.  Nothing is read back: the list stays on the card, and each step
    block decodes its own word.  The kernel writes a partial (q, idx) per
    step and row of its tile into a scratch of n_pairs x block_r entries;
    a reduce folds each row's partials in list order.
    """
    kw = dict(variant=variant, block_r=block_r, block_m=block_m)
    if ai.device.type == "cpu":
        return micro_step_torch(words, n_pairs, ai, ch, cl, sb, aux, **kw)
    n_rt, n_ct = _shapes(words, n_pairs, ai, ch, cl, sb, aux, variant, block_r, block_m)
    dev = ai.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    m = sb.shape[0]
    _check("words", words, torch.int32, tuple(words.shape), dev)
    _check("ai", ai, torch.int8, tuple(ai.shape), dev)
    _check("ch", ch, torch.int8, tuple(ch.shape), dev)
    _check("cl", cl, torch.int8, tuple(cl.shape), dev)
    _check("sb", sb, torch.float32, (m,), dev)
    _check("aux", aux, torch.float32, (m,), dev)
    fn = _kernel_fn(variant)
    with torch.cuda.device(dev):
        part_q = torch.empty((n_pairs, block_r), dtype=torch.float32, device=dev)
        part_idx = torch.empty((n_pairs, block_r), dtype=torch.int32, device=dev)
        q = torch.empty((ai.shape[0],), dtype=torch.float32, device=dev)
        idx = torch.empty((ai.shape[0],), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(words.data_ptr(), n_pairs, ai.data_ptr(), ch.data_ptr(), cl.data_ptr(),
                 sb.data_ptr(), aux.data_ptr(), n_rt, n_ct, block_r, block_m,
                 part_q.data_ptr(), part_idx.data_ptr(), q.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"micro_step kernel launch failed: CUDA error {err}")
    micro_step_cuda.launches[variant] += 1
    return q, idx


# launch counts by variant
micro_step_cuda.launches = {v: 0 for v in VARIANTS}
