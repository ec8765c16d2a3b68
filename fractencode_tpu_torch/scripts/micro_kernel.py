"""Pair-list step microbenchmark on one CUDA card: the counterpart of the
JAX package's ``scripts/micro_kernel.py`` (K4 and K5).

    python -m fractencode_tpu_torch.scripts.micro_kernel

It splits one step of K1's 'ls' search (a 512-row range tile against a
4096-column tile at K = 16) into its parts by timing the variants of
``ops/micro_kernels.micro_step_cuda``:

  full       the step: int8 dots, the exact integer key, the first-occurrence
             argmax
  noargpass  the step without its argmax pass (the tile's first column)
  packed     a one-pass packed argmax (bits(q) & ~4095 | 4095 - lane; not
             exact)
  matmul     the dots and the max only
  transposed 'full' with ch and cl stored as [16, M]

Each list visits every (range tile, column tile) pair once per repetition,
range tile by range tile.  Per-step µs is the difference of two list lengths
(4 repetitions and 1) over the steps between them, so what every call pays
once (launch, reduce setup) cancels.  Each time is one warmup, then the
minimum of 5 runs, by CUDA events around the wrapper call.  The list stays on
the card: the wrapper reads nothing back.  The first line is the card's name
and power limit from ``nvidia-smi``.  Without a CUDA device it exits 2; it
never runs the plain version in the kernel's place.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np

BR, BM, K = 512, 4096, 16
NI, NJ = 8, 64
R_PAD, M_PAD = NI * BR, NJ * BM
P_CAP = NI * NJ * 8
VARIANTS = ("full", "noargpass", "packed", "matmul")


def make_inputs(device):
    """The operands, from numpy's default_rng(0) in the JAX script's order
    and dtypes: ai [R_PAD, K], ch and cl [M_PAD, K] int8, sb and aux [M_PAD]
    f32, and chT, clT, the [K, M_PAD] copies of ch and cl."""
    import torch

    rng = np.random.default_rng(0)
    ai = rng.integers(-128, 128, (R_PAD, K), np.int8)
    ch = rng.integers(0, 128, (M_PAD, K), np.int8)
    cl = rng.integers(0, 8, (M_PAD, K), np.int8)
    sb = rng.random((1, M_PAD), np.float32) * 100
    aux = rng.random((1, M_PAD), np.float32)
    arrays = dict(ai=ai, ch=ch, cl=cl, sb=sb[0], aux=aux[0], chT=ch.T.copy(),
                  clT=cl.T.copy())
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def make_pairs(reps: int, device="cpu"):
    """The JAX script's list for ``reps`` repetitions in the port's word
    layout (``pack_pairs``): range tile by range tile, each visiting every
    column tile ``reps`` times in order, ``first`` on its first step; zeros
    after, to P_CAP words.  Returns (words [P_CAP] i32, n_pairs)."""
    import torch

    from ..ops.micro_kernels import pack_pairs

    n = NI * NJ * reps
    rt = torch.arange(NI, dtype=torch.int32).repeat_interleave(NJ * reps)
    ct = torch.arange(NJ, dtype=torch.int32).repeat(NI * reps)
    first = torch.zeros(n, dtype=torch.bool)
    first[:: NJ * reps] = True
    words = torch.zeros(P_CAP, dtype=torch.int32)
    words[:n] = pack_pairs(rt, ct, first, torch.ones(n, dtype=torch.int32))
    return words.to(device), n


def step(inputs, words, n_pairs, variant):
    """One wrapper call of ``variant`` ('full_t': the [K, M] operands)."""
    from ..ops.micro_kernels import micro_step_cuda

    t = variant == "full_t"
    return micro_step_cuda(words, n_pairs, inputs["ai"], inputs["chT" if t else "ch"],
                           inputs["clT" if t else "cl"], inputs["sb"], inputs["aux"],
                           variant=variant, block_r=BR, block_m=BM)


def timeit(inputs, variant, reps):
    """Min over 5 runs (after one warmup) of one call's ms, CUDA events."""
    import torch

    words, n = make_pairs(reps, inputs["ai"].device)
    step(inputs, words, n, variant)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(inputs, words, n, variant)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def per_step_us(inputs, variant):
    """(t(reps=4) - t(reps=1)) over the 3 * NI * NJ steps between them, µs."""
    return (timeit(inputs, variant, 4) - timeit(inputs, variant, 1)) / (NI * NJ * 3) * 1e3


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; this microbenchmark runs only on the card",
              file=sys.stderr)
        return 2
    print(card())
    inputs = make_inputs("cuda")
    for variant in VARIANTS:
        print(f"{variant:>10}: {per_step_us(inputs, variant):6.2f} us/step")
    words, n = make_pairs(1, "cuda")
    qa, ia = step(inputs, words, n, "full")
    qb, ib = step(inputs, words, n, "full_t")
    same = bool(torch.equal(qa.view(torch.int32), qb.view(torch.int32))
                and torch.equal(ia, ib))
    print("transposed bit-identical:", same)
    print(f"transposed: {per_step_us(inputs, 'full_t'):6.2f} us/step")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
