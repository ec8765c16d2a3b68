"""Vector-quantization codebook training (port of ``fractencode_tpu/encode/vq.py``).

LBG / k-means over [N, D] vectors, the reference's ``generateCodebook``
(``encode/CodebookGenerator.hpp:84-162``): random unique seeding, then
assign-to-nearest and centroid update until the largest codeword move drops
below epsilon or ``max_steps``; empty clusters keep their codeword.  The
loop is carried on the device, as the JAX package's ``lax.while_loop``
(``utils.graphs.while_loop``), with the seeds, the subsample and the
fixed-point scale on the device too.

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

import numpy as np
import torch

from ..utils import graphs, prng
from ..utils.tables import device_table

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


def _fixed_point_shift(x: torch.Tensor) -> torch.Tensor:
    """s (a 0-d int64 tensor on x's device) such that any sum of x's
    entries, scaled by 2^s, lies below 2^62 in magnitude: 62 less the
    binary exponent of max |x| times the count (an exact float64 product)."""
    if not x.numel():
        return torch.zeros((), dtype=torch.int64, device=x.device)
    amax = x.abs().max()
    exponent = torch.frexp(amax.double() * x.shape[0])[1].to(torch.int64)
    return torch.where(amax == 0, 0, 62 - exponent)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as a float64 tensor, exactly (its bits), for int64 e in the
    normal range."""
    return ((e + 1023) << 52).view(torch.float64)


def _sample_rows(key: tuple, n_full: int, sample_limit: int) -> np.ndarray:
    """The subsample's rows: the draw of the second half of the key's split."""
    return prng.choice(prng.split(np.asarray(key, dtype=np.uint32))[1], n_full,
                       sample_limit)


def _seed_rows(key: tuple, n: int, num_codes: int, subsampled: bool) -> np.ndarray:
    """The seeds' rows among the n training vectors: the key's draw, or that
    of the first half of its split after a subsample."""
    key = np.asarray(key, dtype=np.uint32)
    return prng.choice(prng.split(key)[0] if subsampled else key, n, num_codes)


def _start(x: torch.Tensor, key, num_codes: int, sample_limit: int | None):
    """The k-means' inputs: (training vectors [n, D] f32, the same in int64
    fixed point, 2^-shift as a 0-d float64 tensor, seed codebook
    [num_codes, D]).  The draws depend on (key, N, num_codes, sample_limit)
    alone, so their rows are device tables (``utils.tables``)."""
    n_full = x.shape[0]
    x = x.to(torch.float32)
    key = tuple(int(k) for k in np.asarray(key, dtype=np.uint32).ravel())
    subsampled = sample_limit is not None and sample_limit < n_full
    if subsampled:
        x = x[device_table(_sample_rows, key, n_full, sample_limit, device=x.device)]
    codebook = x[device_table(_seed_rows, key, x.shape[0], num_codes, subsampled,
                              device=x.device)]
    # each cluster's sum in int64 fixed point: exact, so in any order, for
    # values that are multiples of 2^-shift (the encoder's are)
    shift = _fixed_point_shift(x)
    xi = torch.round(x.double() * _pow2(shift)).to(torch.int64)
    return x, xi, _pow2(-shift), codebook


# k-means steps a chunk (see graphs.while_loop; chip_smoke.py phase 26
# times 1, 8 and 32; PERF.md)
_CHUNK = 8
# the loop's default limits, the JAX package's train_codebook's
MAX_STEPS = 200
EPSILON = 1e-3


def _kmeans(x, xi, unscale, codebook, max_steps: int, epsilon: float, graph: bool):
    """LBG from ``_start``'s tensors: (codebook, steps as a 0-d i32
    tensor).  The loop is carried on the device (``graphs.while_loop``, the
    JAX package's ``lax.while_loop`` and its cond): chunks of predicated
    steps, one CUDA graph on the card with ``graph``, the exit flag read
    once a chunk.  The codebook is the graph's own output with ``graph``."""
    num_codes, d = codebook.shape
    eps = float(np.float32(epsilon))

    def make_body(x, xi, unscale):
        ones = torch.ones(x.shape[0], dtype=torch.int64, device=x.device)

        def body(carry):
            codebook = carry[0]
            assign = assign_codes(x, codebook).long()
            counts = torch.zeros(num_codes, dtype=torch.int64, device=x.device).index_add_(
                0, assign, ones)[:, None]
            sums = torch.zeros((num_codes, d), dtype=torch.int64, device=x.device).index_add_(
                0, assign, xi)
            mean = (sums.double() * unscale).float() / counts.clamp_min(1).float()
            new = torch.where(counts > 0, mean, codebook)
            move = torch.sqrt(_sq_norms(new - codebook)).max()
            return new, carry[1] + 1, move < eps

        return body

    carry = (codebook, torch.zeros((), dtype=torch.int32, device=x.device),
             torch.zeros((), dtype=torch.bool, device=x.device))
    codebook, steps, _ = graphs.while_loop(
        "train_codebook", (max_steps, eps), make_body,
        lambda c: (c[1] < max_steps) & ~c[2], (x, xi, unscale), carry,
        graph=graph, chunk=_CHUNK)
    return codebook, steps


def train_codebook(x: torch.Tensor, key, num_codes: int, max_steps: int = MAX_STEPS,
                   epsilon: float = EPSILON, sample_limit: int | None = None):
    """Train an LBG codebook over [N, D] vectors.

    ``key`` is a JAX-layout PRNG key (``utils.prng.prng_key``).  Returns
    (codebook [num_codes, D] f32, assignments [N] i32 of the full input,
    steps int).  Seeding draws ``num_codes`` distinct input vectors;
    ``sample_limit`` trains on a random subsample of that many vectors.
    The loop is carried on the device (``_kmeans``; CUDA graphs on the
    card) and reads one flag back a chunk of steps.
    """
    graph = x.device.type == "cuda"
    codebook, steps = _kmeans(*_start(x, key, num_codes, sample_limit), max_steps,
                              epsilon, graph)
    if graph:
        codebook = codebook.clone()
    return codebook, assign_codes(x.to(torch.float32), codebook), int(steps)
