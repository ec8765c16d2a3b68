"""Vector-quantization codebook training (port of ``fractencode_tpu/encode/vq.py``).

LBG / k-means over [N, D] vectors, the reference's ``generateCodebook``
(``encode/CodebookGenerator.hpp:84-162``): random unique seeding, then
assign-to-nearest and centroid update until the largest codeword move drops
below epsilon or ``max_steps``; empty clusters keep their codeword.

The seeding and the subsample are the JAX package's draws
(``utils/prng.py``).  Every reduction has a fixed order, so the card and the
CPU agree bitwise: the distances' dot products are a loop over D (no
matmul: cuBLAS and the CPU's BLAS sum in different orders, and one ulp can
flip a near-tie and with it every later step), and a cluster's sum is an
exact int64 fixed-point sum, rounded to f64 and then to f32 by the same
elementwise ops on the card and the CPU.  The JAX package's dot at
HIGHEST and its segment sum have their own orders, so labels can differ
from its on near-ties (``tests/test_torch_vq.py`` states the agreement).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import prng

__all__ = ["train_codebook", "assign_codes"]


def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    """[N] f32 squared norms of a's [N, D] rows, summed over D in order."""
    acc = a[:, 0] * a[:, 0]
    for d in range(1, a.shape[1]):
        acc = acc + a[:, d] * a[:, d]
    return acc


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, M] squared distances via the five-sums identity, the dot products
    summed over D in order (f32 products and sums, no contraction)."""
    xc = x[:, :1] * c[:, 0]
    for d in range(1, x.shape[1]):
        xc = xc + x[:, d:d + 1] * c[:, d]
    return _sq_norms(x)[:, None] - 2.0 * xc + _sq_norms(c)[None, :]


def assign_codes(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N] i32 index of the nearest codeword for each vector (ties -> lowest)."""
    dist = _pairwise_sq_dists(x, codebook)
    best = dist[:, 0]
    idx = torch.zeros(dist.shape[0], dtype=torch.int32, device=x.device)
    for m in range(1, dist.shape[1]):
        better = dist[:, m] < best
        best = torch.where(better, dist[:, m], best)
        idx = torch.where(better, m, idx)
    return idx


def _fixed_point_shift(x: torch.Tensor) -> int:
    """s such that any sum of x's entries, scaled by 2^s, lies below 2^62
    in magnitude (one host read of max |x|)."""
    amax = float(x.abs().max()) if x.numel() else 0.0
    return 0 if amax == 0.0 else 62 - math.frexp(amax * x.shape[0])[1]


def _draw(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x[torch.from_numpy(idx.astype(np.int64)).to(x.device)]


def train_codebook(x: torch.Tensor, key, num_codes: int, max_steps: int = 200,
                   epsilon: float = 1e-3, sample_limit: int | None = None):
    """Train an LBG codebook over [N, D] vectors.

    ``key`` is a JAX-layout PRNG key (``utils.prng.prng_key``).  Returns
    (codebook [num_codes, D] f32, assignments [N] i32 of the full input,
    steps int).  Seeding draws ``num_codes`` distinct input vectors;
    ``sample_limit`` trains on a random subsample of that many vectors.  A
    step reads its largest move back to the host for the loop's test.
    """
    n_full, d = x.shape
    x_full = x.to(torch.float32)
    key = np.asarray(key, dtype=np.uint32)
    if sample_limit is not None and sample_limit < n_full:
        key, sub = prng.split(key)
        x = _draw(x_full, prng.choice(sub, n_full, sample_limit))
    else:
        x = x_full
    codebook = _draw(x, prng.choice(key, x.shape[0], num_codes))
    # each cluster's sum in int64 fixed point: exact, so in any order, for
    # values that are multiples of 2^-shift (the encoder's are)
    shift = _fixed_point_shift(x)
    xi = torch.round(x.double() * 2.0 ** shift).to(torch.int64)
    ones = torch.ones(x.shape[0], dtype=torch.int64, device=x.device)
    eps = np.float32(epsilon)
    steps, done = 0, False
    while steps < max_steps and not done:
        assign = assign_codes(x, codebook).long()
        counts = torch.zeros(num_codes, dtype=torch.int64, device=x.device).index_add_(
            0, assign, ones)[:, None]
        sums = torch.zeros((num_codes, d), dtype=torch.int64, device=x.device).index_add_(
            0, assign, xi)
        mean = (sums.double() * 2.0 ** -shift).float() / counts.clamp_min(1).float()
        new = torch.where(counts > 0, mean, codebook)
        move = torch.sqrt(_sq_norms(new - codebook)).max()
        codebook, steps = new, steps + 1
        done = bool(np.float32(move.item()) < eps)
    return codebook, assign_codes(x_full, codebook), steps
