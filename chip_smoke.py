#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fractencode_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. build the CUDA kernels from csrc/ (search_classed.cu, K1,
     search_classed2d.cu, K2, search_dense.cu, K3, and micro_step.cu, K4
     and K5: one nvcc each, in parallel, into build/kernels/), print each
     instantiation's registers and spills from ptxas' report, and the card's
     name and power limit;
  2. K1 parity at K = 16: the search kernel against its plain PyTorch
     version on the same class-sorted tensors at 512^2 and 2048^2, (q, idx)
     bitwise equal, with both times (CUDA events, median of 5 after a
     warmup);
  3. the CLI's encode -> pyramid-decode path (cli._encode_one) at 512^2 on
     the card, bitwise equal to the same call on the CPU;
  4. the same path at 2048^2 on the card, with the kernel's launch count, the
     encode and decode wall times and the PSNR;
  5. K1 parity at K = 64 and K = 256: the kernel against its plain version
     on the 8 px and 16 px quadtree level inputs of the 2048^2 plane (no
     coverage mask), (q, idx) bitwise equal, with both times;
  6. the CLI's quadtree path (cli._encode_one_quadtree, --quadtree) at
     512^2 on the card, every level and the decoded pixels bitwise equal to
     the same call on the CPU;
  7. the quadtree path at 2048^2 on the card, with each K's launch count,
     the leaves per level, the encode and decode wall times and the PSNR;
  8. K3 parity: the dense search kernel against its plain version, (q, idx)
     bitwise equal, with both times: K = 16 'ls', 'raw' and 'general' at
     512^2, 'ls' with the class mask at 512^2; K = 64 and 256 'ls' on the
     quadtree level inputs of the 2048^2 plane; then at 2048^2 under the
     very configs that phases 10, 11 and 13 parse from their flags:
     --noclassifier, config 1, and each path of KEY_PATHS (a quadtree path
     at its 16 px level's geometry: raw256 and general256);
  9. K1 'raw' and 'general' parity: so_mode 'reference' at 2048^2 and every
     key on the 8 px quadtree level (K = 64), then at 2048^2 under the
     configs that phase 13 parses from each path of KEY_PATHS;
 10. --noclassifier through cli._encode_one: at 512^2 card == CPU bitwise;
     at 2048^2 the launch counts, times and PSNR, and the dense search's key
     at least the class-blocked search's for every range;
 11. BASELINE config 1 (--source 16 --target 8 --transforms 8
     --noclassifier): at 256^2 card == CPU bitwise, times at 2048^2;
 12. --noclassifier --quadtree: at 512^2 card == CPU bitwise, times and
     leaves at 2048^2;
 13. the paths of KEY_PATHS (--compat and --smax 0.9, with 4x4 ranges, with
     config 1's 8x8 ranges and on the quadtree), with and without the
     classifier: card == CPU bitwise at 256^2 (every quadtree level), then
     at 2048^2 each with its launch counts (and the quadtree's leaves);
 14. the C++ reference goldens (default, --noclassifier, --smax 0.9,
     --rms 10) on the in-repo Lenna crop through the port on the card,
     against the reference encoder's dumps and decoded PNGs to the
     tolerances of tests/test_reference_parity.py;
 15. the early-accept frontier: every `_thr` instance of K1 and K3 against
     its plain version, (q, idx) bitwise, with both times, at 512^2 and then
     at 2048^2 under the config the --rms path that runs it parses to (at
     K = 256 also on a smooth 512^2 plane, where 16 px ranges hit), with
     the share of ranges that hit, which must be above 0 in one of the
     checks of each instance, and the pairs scanned up to each row's
     frontier;
 16. the --rms paths (RMS_PATHS: --rms 10 alone and with --compat,
     --noclassifier, config 1, --quadtree, --noclassifier --quadtree and the
     KEY_PATHS flags): card == CPU bitwise at 256^2 (512^2 for --rms 10),
     then at 2048^2 each with its launch counts (only `_thr` instances),
     PSNR and hit share, and the wall times of the first six;
 17. the bitstream (BITSTREAM_PATHS: the default path, --quadtree,
     --compat --quadtree and --color) at 512^2 and 2048^2: the CLI writes
     the file (--out) on the card and decodes it (--decode-file) on the
     card; at 512^2 the CPU's encode writes the same bytes and the CPU's
     decode of the file gives the same pixels; the file's bytes, bpp and
     PSNR, and the host ms of packing the card's results and of unpacking
     the file onto the card;
 18. K2, the 2-D class-blocked search: every instance against its plain
     version on the forced route (force_no_pairs), (q, idx) bitwise, with
     both times, at 512^2 (every K at its quadtree level's geometry; K = 256
     `_thr` also on the smooth plane) and at 2048^2's 8 px and 16 px level
     inputs, and once with splits of 64 columns; each `_thr` instance with
     a hit share above 0 in one check; then K2 against K1 on the same prep
     (bitwise, CUDA events, median of 5) at 512^2 and 2048^2 and on the
     2048^2 quadtree's levels with their coverage masks; then at 8192^2
     the default and --rms 10 paths through cli._encode_one (each launching
     K2 and not K1, whose route the JAX package's pair-list overflow
     decides), with K2 against K1 on their preps, encode and decode wall
     times, PSNR, the split count and the partials' bytes, and K2 against
     its plain version at the path's own split plan on a sample of the
     range tiles (the first and last of each class: the plain version of
     the whole plane would take minutes); and --quadtree at 8192^2 with the
     route each level took;
 19. K4 and K5, the pair-list step microbenchmark (ops/micro_kernels.py):
     at the JAX script's shapes and draws (fractencode_tpu_torch.scripts.
     micro_kernel: 8 x 64 tiles of 512 x 4096 at K = 16), each of the five
     instances against its plain version at 1 and 4 repetitions of the
     list, (q, idx) bitwise; K5 against K4 'full' and 4 repetitions against
     1, bitwise; every instance on a small list of ties; then the
     microbenchmark's main (the path `micro_kernel`), whose lines it prints.
Every path is driven with the launch counts set to 0 just before it and
read just after; each must launch the kernels it names.  Each search
kernel's record keeps the times of its last parity check, which is at the
shape of a path that launches it, and its bound there: the larger of 2K
int8 operations per (range, column) pair the search needs (the data's own
count with the frontier; the class layout's padding rows and columns are
not counted) over the H100 SXM's 1,979 TOP/s and the bytes of its ranges,
columns and results (``search_bytes``) over 3.35 TB/s.  K4's and K5's
records: the time of one repetition of the list (CUDA events, median of 5),
the per-step µs from 4 repetitions and 1, and the bound of one repetition
(every range tile against every column tile once).
No single PyTorch call gives a search's (q, idx), so library_ms is null;
K4 'matmul''s is torch._int_mm's int8 products of each range tile against
all columns with the row max, which writes the products out.  Plain timings
at 2048^2 are one run each, the parity run itself (which also counts the
pairs scanned), to keep the script short.
The planes are natural-like synthetic textures made with numpy from a seed.
The last two lines are the kernels' JSON record and the device JSON line.
Without a CUDA device it exits non-zero and prints no result.  Its files
go to build/smoke/ in the checkout, which it removes at the end.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20240611
SOURCES = {"search_classed": "fractencode_tpu_torch/csrc/search_classed.cu",
           "search_classed2d": "fractencode_tpu_torch/csrc/search_classed2d.cu",
           "search_dense": "fractencode_tpu_torch/csrc/search_dense.cu",
           "micro_step": "fractencode_tpu_torch/csrc/micro_step.cu"}
# The line of the TPU kernel each kernel key replaces: _pairs_kernel (K1),
# _classed_kernel (K2) and _search_kernel (K3); 'ls' at K = 64 is their
# ls_fast int8 branch (K2's serves K = 16 too), 'raw' and 'general' their
# generic int8 branch, K = 256 their f32 branch (every key); 'thr' (the
# `_thr` instances) their call of _apply_frontier.
_LINES = {"search_classed": {"ls16": 508, "ls64": 556, "raw": 560, "general": 560,
                             "f32": 568, "thr": 581},
          "search_classed2d": {"ls16": 426, "ls64": 426, "raw": 430, "general": 430,
                               "f32": 437, "thr": 454},
          "search_dense": {"ls16": 163, "ls64": 203, "raw": 206, "general": 206,
                           "f32": 211, "thr": 227}}
# (domain, range) sizes of the quadtree's levels by K (CLI defaults)
LEVELS = {16: (16, 4), 64: (32, 8), 256: (64, 16)}
CONFIG1 = ["--source", "16", "--target", "8", "--transforms", "8"]
# the CLI paths of the 'raw' and 'general' keys by (key, K), driven in phase
# 13 with and without --noclassifier; phases 8 and 9 check the kernels at
# the configs these flags parse to, a quadtree path at its level of K
# (--compat keeps 4 isometries, as in the JAX CLI, so its config 1 path has
# 260,100 columns)
KEY_PATHS = {("raw", 16): ["--compat"],
             ("raw", 64): [*CONFIG1, "--compat"],
             ("general", 16): ["--smax", "0.9"],
             ("general", 64): [*CONFIG1, "--smax", "0.9"],
             ("raw", 256): ["--compat", "--quadtree"],
             ("general", 256): ["--smax", "0.9", "--quadtree"]}
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# the C++ reference's goldens on the Lenna crop: CLI flags, encode dump, result
GOLDENS = {"default": ([], "lenna128_cpp_encode.txt.gz", "lenna128_cpp_result.png"),
           "nocls": (["--noclassifier"], "lenna128_cpp_nocls.txt.gz",
                     "lenna128_cpp_result_nocls.png"),
           "smax09": (["--smax", "0.9"], "lenna128_cpp_smax09.txt.gz",
                      "lenna128_cpp_result_smax09.png"),
           "rms10": (["--rms", "10"], "lenna128_cpp_rms10.txt.gz",
                     "lenna128_cpp_result_rms10.png")}
RMS = ["--rms", "10"]


def path_ks(argv, k):
    """The K of every search a CLI path of the key at K runs: each level's
    on the quadtree."""
    return list(LEVELS) if "--quadtree" in argv else [k]


# the --rms paths (phase 16) and the `_thr` instances (kernel, key, K) each
# runs; phase 15 checks each instance at the config of the first path here
# that runs it (the quadtree levels at their level geometry)
RMS_PATHS = {
    "--rms 10": (RMS, [("search_classed", "ls", 16)]),
    "--compat --rms 10": (["--compat", *RMS], [("search_classed", "raw", 16)]),
    "--noclassifier --rms 10": (["--noclassifier", *RMS], [("search_dense", "ls", 16)]),
    "config 1 --rms 10": ([*CONFIG1, "--noclassifier", *RMS], [("search_dense", "ls", 64)]),
    "--quadtree --rms 10": (["--quadtree", *RMS],
                            [("search_classed", "ls", k) for k in LEVELS]),
    "--noclassifier --quadtree --rms 10": (["--noclassifier", "--quadtree", *RMS],
                                           [("search_dense", "ls", k) for k in LEVELS]),
    **{f"{' '.join(argv)}{nocls} --rms 10": ([*argv, *nocls.split(), *RMS],
                                             [(kernel, mode, kk) for kk in path_ks(argv, k)])
       for kernel, nocls in (("search_classed", ""), ("search_dense", " --noclassifier"))
       for (mode, k), argv in KEY_PATHS.items()
       if (kernel, mode, k) != ("search_classed", "raw", 16)},
}
# the paths of phase 17, each with the kernel instances its encode launches
BITSTREAM_PATHS = {
    "default": ([], [("search_classed", "ls", 16, False)]),
    "--quadtree": (["--quadtree"], [("search_classed", "ls", k, False) for k in LEVELS]),
    "--compat --quadtree": (["--compat", "--quadtree"],
                            [("search_classed", "raw", k, False) for k in LEVELS]),
    "--color": (["--color"], [("search_classed", "ls", 16, False)]),
}
# the H100 SXM's dense int8 tensor-core rate and HBM3 rate (NVIDIA's data
# sheet, 700 W): the bound of a search is the larger of its 2K int8
# operations per pair over the first and its bytes over the second
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def natural_plane(n: int, seed: int) -> np.ndarray:
    """A non-periodic natural-like u8 texture: a few random low-frequency
    cosines plus box-blurred uniform noise, scaled to [0, 255]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = np.zeros((n, n))
    for _ in range(6):
        fx, fy = rng.uniform(0.5, 6.0, 2)
        img += rng.uniform(10, 40) * np.cos(2 * np.pi * (fx * xx + fy * yy)
                                            + rng.uniform(0, 2 * np.pi))
    r = 2  # 5x5 box blur of the noise via 2-D prefix sums
    noise = rng.uniform(-1, 1, (n + 2 * r, n + 2 * r))
    c = np.pad(noise.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    k = 2 * r + 1
    img += 60 * (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return img.astype(np.uint8)


def ptxas_report(text):
    """One line per kernel instantiation in an ``nvcc -Xptxas -v`` log: its
    name, template arguments (K, key, for K3 the class mask, and the
    frontier; K4/K5: the variant and the [K, M] layout), registers and
    spills."""
    lines, name, spill = [], None, ("?", "?")
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if m:  # a (nested) mangled name: length-prefixed parts, then <K, M, ...>
            rest = m.group(1)
            while d := re.match(r"\d+", rest):
                end = d.end() + int(d.group())
                name, rest = rest[d.end():end], rest[end:]
            targs = re.findall(r"L[ib](\d+)E", rest)
            if targs and name.startswith("micro_step"):
                variant, transposed = targs[:2]
                name += (f" {('full', 'noargpass', 'packed', 'matmul')[int(variant)]}"
                         + (" [K, M] layout" if transposed == "1" else ""))
            elif targs:  # the reduce kernels have none
                k, mode, *flags = targs
                masked, frontier = (flags[:2] if name.startswith("search_dense")
                                    else ("0", *flags[:1]))
                name += (f" K={k} {('ls', 'raw', 'general')[int(mode)]}"
                         + (" masked" if masked == "1" else "")
                         + (" frontier" if frontier == "1" else ""))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {spill[0]} B spill "
                         f"stores, {spill[1]} B spill loads")
            name, spill = None, ("?", "?")
    return lines


def cuda_ms(fn, reps=5):
    """Median device time of fn() in ms (CUDA events), and its last result;
    one warmup first when there is more than one repetition."""
    import torch

    if reps > 1:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def bitwise(a, b) -> bool:
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def level_inputs(img, cfg):
    """(ranges, SumA, SumA2, codebook, range classes, domain classes) of one
    plane's uniform grid, built on the card."""
    import torch

    from fractencode_tpu_torch.core.classify import classify_grid
    from fractencode_tpu_torch.core.grid import uniform_grid
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges

    n = img.shape[0]
    p = torch.from_numpy(img).cuda()
    pf = p.to(torch.float32)
    dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
    cb = build_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(pf, cfg.target_size)
    return (ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
            classify_grid(p, rg), classify_grid(p, dg))


def smooth_plane(n: int, seed: int) -> np.ndarray:
    """A smooth wave plus uniform noise in [0, 10): most but not all of its
    16 px ranges meet the --rms 10 frontier, which few of a natural plane's
    do."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
            + np.random.default_rng(seed).integers(0, 10, (n, n))).astype(np.uint8)


def search_bytes(rows: int, cols: int, k: int, sums: bool, masked: bool = False) -> int:
    """The bytes a search must move, each input read once and each output
    written once: per range its K int8 values, its (q, idx), and its SumA
    and SumA2 (``sums``: the 'general' key or the frontier) and class (the
    class mask); per column its 2K int8 values, SumB and the key's aux, and
    its class (the class mask)."""
    cls = 4 if masked else 0
    return rows * (k + 8 + (8 if sums else 0) + cls) + cols * (2 * k + 8 + cls)


def bound(pairs: int, k: int, nbytes: int):
    """(ms, 'operations' or 'bytes'): the least time the card could take for
    ``pairs`` (range, column) pairs of 2K int8 operations each, moving
    ``nbytes`` (each input read once, each output written once)."""
    ops_ms = 2 * k * pairs / PEAK_INT8_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class Kernels:
    """The kernels' records and launch counts, by (kernel, mode, K, frontier)
    for the searches and ("micro_step", variant) for K4 and K5."""

    def __init__(self):
        from fractencode_tpu_torch.ops import matcher_kernels as mk
        from fractencode_tpu_torch.ops import micro_kernels as mt

        self.wrappers = {"search_classed": mk.search_classed_cuda,
                         "search_classed2d": mk.search_classed2d_cuda,
                         "search_dense": mk.search_dense_cuda}
        self.micro = mt.micro_step_cuda
        self.records = {}
        for kernel in self.wrappers:
            for mode, ks in mk.KERNEL_KEYS.items():
                for k in ks:
                    for thr in (False, True):
                        lines = _LINES[kernel]
                        line = (lines["thr"] if thr else lines["f32"] if k == 256
                                else lines.get(f"{mode}{k}", lines.get(mode)))
                        self.records[(kernel, mode, k, thr)] = dict(
                            name=f"{kernel}_{mode}{k}" + ("_thr" if thr else ""),
                            route="cuda", source=SOURCES[kernel],
                            replaces=f"fractencode_tpu/ops/matcher_pallas.py:{line}",
                            launches=0, max_abs_err=0.0, library_ms=None,
                            launches_by_path={})
        for variant in mt.VARIANTS:  # K5 is 'full_t'; K4 the other four
            self.records[("micro_step", variant)] = dict(
                name="micro_t_full" if variant == "full_t" else f"micro_{variant}",
                route="cuda", source=SOURCES["micro_step"],
                replaces=f"scripts/micro_kernel.py:{208 if variant == 'full_t' else 96}",
                launches=0, max_abs_err=0.0, library_ms=None, launches_by_path={})

    def zero(self):
        for w in (*self.wrappers.values(), self.micro):
            for key in w.launches:
                w.launches[key] = 0

    def read(self, path, expect):
        """Add the counts since ``zero`` to the records under ``path``;
        every key in ``expect`` must have launched."""
        counts = {(kernel, *key): n for kernel, w in self.wrappers.items()
                  for key, n in w.launches.items()}
        counts.update({("micro_step", v): n for v, n in self.micro.launches.items()})
        for key in expect:
            check(counts[key] > 0, f"the {path} path launched no {self.records[key]['name']}")
        for key, n in counts.items():
            if n:
                self.records[key]["launches"] += n
                self.records[key]["launches_by_path"][path] = n
        return {self.records[key]["name"]: n for key, n in counts.items() if n}

    def parity(self, key, run, plain, what, nbytes, plain_reps=5, real=None):
        """Kernel ``run()`` against plain ``plain(scanned)``: (q, idx)
        bitwise; both times, and the bound from ``nbytes`` and the pairs the
        plain version counts in ``scanned`` for the rows ``real`` (the rows
        that hold a range; all rows when None), go into the record of
        ``key``.  Returns the kernel's (q, idx) and the pairs."""
        import torch

        q_k, i_k = run()
        scanned = torch.zeros(q_k.shape[0], dtype=torch.int64, device=q_k.device)
        plain_ms, (q_p, i_p) = cuda_ms(lambda: plain(scanned), reps=1)
        err = float((q_k.double() - q_p.double()).abs().max())
        name = self.records[key]["name"]
        check(bitwise(q_k, q_p), f"{name} q differs from the plain version at {what} "
                                 f"(max abs {err})")
        check(bitwise(i_k, i_p), f"{name} idx differs from the plain version at {what}")
        ms, _ = cuda_ms(run)
        if plain_reps > 1:
            plain_ms, _ = cuda_ms(plain, reps=plain_reps)
        pairs = int((scanned if real is None else scanned[real]).sum())
        bound_ms, bound_by = bound(pairs, key[2], nbytes)
        print(f"    {name} at {what}: {q_k.shape[0]} rows, (q, idx) bitwise equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + ("" if plain_reps > 1 else " (one run)")
              + f"; {pairs} pairs, bound {bound_ms:.4f} ms ({bound_by})")
        rec = self.records[key]
        rec.update(max_abs_err=max(rec["max_abs_err"], err), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        return q_k, i_k, pairs

    def hits(self, key, share):
        """Keep the largest hit share of the frontier instance ``key``."""
        rec = self.records[key]
        rec["max_hit_share"] = max(rec.get("max_hit_share", 0.0), share)


def parse(argv):
    from fractencode_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    return args, cli._config_from_args(args), cli._decoder_config(args)


def path_config(argv, mode, k):
    """The config the CLI parses from ``argv``, at the geometry of its level
    of K on the quadtree; it must select the (mode, K) kernel key."""
    from fractencode_tpu_torch.encode import matcher as tm

    _, c, _ = parse(["--device", "cuda", *argv])
    if "--quadtree" in argv:
        c = dataclasses.replace(c, source_size=LEVELS[k][0], target_size=LEVELS[k][1])
    check((tm.rank_mode(c.criterion, c.so_mode, c.s_max), c.target_size ** 2) == (mode, k),
          f"{' '.join(argv)} does not select the {mode}{k} kernel")
    return c


def run_cli(argv):
    """cli.main(argv) with its standard output captured: (exit code, text)."""
    import contextlib
    import io

    from fractencode_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def host_ms(fn, reps=3):
    """Median host-clock ms of fn(), which ends in a synchronize, over reps
    runs after one warmup; and its last result."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times), out


def card_equals_cpu(img, argv, label):
    """One CLI path on the card and on the CPU: every result field and the
    decoded pixels bitwise equal."""
    from fractencode_tpu_torch import cli

    args_g, cfg, dcfg = parse(["--device", "cuda", *argv])
    args_c, _, _ = parse(["--device", "cpu", *argv])
    res_g, out_g = cli._encode_one(img, args_g, cfg, dcfg, label=f" [{label} cuda]")
    res_c, out_c = cli._encode_one(img, args_c, cfg, dcfg, label=f" [{label} cpu]")
    if args_g.quadtree:
        pairs = [(f"{lg.range_size} px ", lg, lc)
                 for lg, lc in zip(res_g.levels, res_c.levels, strict=True)]
        fields = ("domain_idx", "transform", "s", "o", "error", "accepted")
    else:
        pairs = [("", res_g, res_c)]
        fields = ("domain_idx", "transform", "valid", "distance", "s", "o")
    for what, g, c in pairs:
        for f in fields:
            check(bitwise(getattr(g, f), getattr(c, f)),
                  f"{label} {what}{f}: card differs from CPU")
    check(np.array_equal(out_g, out_c), f"{label} decoded pixels: card differs from CPU")


def drive(kernels, path, img, argv, expect, label):
    """One CLI path on the card (cli._encode_one), the launch counts set to 0
    just before and read just after; (result, pixels, counts)."""
    from fractencode_tpu_torch import cli

    args, cfg, dcfg = parse(["--device", "cuda", *argv])
    kernels.zero()
    res, out = cli._encode_one(img, args, cfg, dcfg, label=f" [{label}]")
    return res, out, kernels.read(path, expect)


def wall_times(encode, decode, reps=3):
    """Median host-clock ms of encode() and decode(result), each ending in a
    synchronize, over ``reps`` warm runs; and the last decode's output."""
    import torch

    enc_s, dec_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        e = encode()
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        d = decode(e)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(enc_s), 1e3 * statistics.median(dec_s), d


def check_uniform(res, out, n, what):
    import torch

    r = (n // res.range_grid.block_size) ** 2
    check(out.shape == (n, n) and out.dtype == np.uint8, f"{what} decoded shape")
    for f in ("s", "o", "distance"):
        t = getattr(res, f)
        check(t.shape == (r,) and bool(torch.isfinite(t).all()), f"{what} {f} finite [R]")


def check_quadtree(qres, qout, n, qcfg, what):
    import torch

    check(qout.shape == (n, n) and qout.dtype == np.uint8, f"{what} decoded shape")
    area = 0
    for l in qres.levels:
        r = (n // l.range_size) ** 2
        for f in ("s", "o"):
            t = getattr(l, f)
            check(t.shape == (r,) and bool(torch.isfinite(t).all()),
                  f"{what} {l.range_size} px {f} finite [R]")
        area += int(l.accepted.sum()) * l.range_size ** 2
    for l in qres.levels[:-1]:  # the finest level takes every block left over
        check(bool((l.error[l.accepted] <= qcfg.error_threshold).all()),
              f"{what} {l.range_size} px leaves above the error threshold")
    check(area == n * n, f"{what} leaves cover {area} pixels, not the plane")


def cpp_golden(name):
    """(config flags, dump rows in range order, result.png) of a C++ golden."""
    from PIL import Image

    flags, dump_name, result_name = GOLDENS[name]
    with gzip.open(os.path.join(GOLDEN, dump_name), "rt") as f:
        dump = np.loadtxt(f)
    out = np.zeros_like(dump)
    out[(dump[:, 1] // 4).astype(int) * 32 + (dump[:, 0] // 4).astype(int)] = dump
    ref = np.asarray(Image.open(os.path.join(GOLDEN, result_name)).convert("L"))
    return flags, out, ref


def micro_ties(ni: int, br: int, nj: int, bm: int):
    """Operands with many equal keys at each row's max (ai in [-2, 2), ch in
    {0, 1}, cl 0, sb in {0, 0.25}, aux 0.5; column tile 1 one column
    repeated), on the card, and a list that revisits column tiles, restarts
    a range tile and holds a word outside the operands: (operands, words,
    n_pairs)."""
    import torch

    from fractencode_tpu_torch.ops.micro_kernels import pack_pairs

    rng = np.random.default_rng(SEED)
    ops = dict(ai=rng.integers(-2, 2, (ni * br, 16), np.int8),
               ch=rng.integers(0, 2, (nj * bm, 16), np.int8),
               cl=np.zeros((nj * bm, 16), np.int8),
               sb=rng.integers(0, 2, nj * bm).astype(np.float32) * 0.25,
               aux=np.full(nj * bm, 0.5, np.float32))
    for name in ("ch", "cl", "sb", "aux"):
        ops[name][bm:2 * bm] = ops[name][bm]
    ops["chT"], ops["clT"] = ops["ch"].T.copy(), ops["cl"].T.copy()
    steps = [(0, 1, 1), (0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 0, 0), (ni, 0, 1),
             (1, 2, 1), (1, 0, 0), (1, 1, 1), (1, 1, 0), (1, 2, 0), (1, 0, 0)]
    rt, ct, first = (torch.tensor(c, dtype=torch.int32) for c in zip(*steps))
    words = pack_pairs(rt, ct, first, torch.ones_like(rt)).cuda()
    return ({k: torch.from_numpy(v).cuda() for k, v in ops.items()}, words, len(steps))


def micro_phase(kernels):
    """Phase 19: K4's four instances and K5's against their plain version at
    the JAX script's shapes and on ties; then the microbenchmark's main."""
    import contextlib
    import io

    import torch

    from fractencode_tpu_torch.ops import micro_kernels as mt
    from fractencode_tpu_torch.scripts import micro_kernel as mkb

    def micro(fn, ops, variant, words, n, br=mkb.BR, bm=mkb.BM):
        t = variant == "full_t"
        return fn(words, n, ops["ai"], ops["chT" if t else "ch"], ops["clT" if t else "cl"],
                  ops["sb"], ops["aux"], variant=variant, block_r=br, block_m=bm)

    ins = mkb.make_inputs("cuda")
    lists = {reps: mkb.make_pairs(reps, "cuda") for reps in (1, 4)}
    ties = micro_ties(2, 128, 3, 1024)
    # one repetition of the list: every range tile against every column tile
    pairs = mkb.R_PAD * mkb.M_PAD
    bound_ms, bound_by = bound(pairs, mkb.K, search_bytes(mkb.R_PAD, mkb.M_PAD, mkb.K, False))
    out = {}
    for variant in mt.VARIANTS:
        key = ("micro_step", variant)
        rec = kernels.records[key]
        for reps, (words, n) in lists.items():
            q_k, i_k = micro(mt.micro_step_cuda, ins, variant, words, n)
            q_p, i_p = micro(mt.micro_step_torch, ins, variant, words, n)
            err = float((q_k.double() - q_p.double()).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            check(bitwise(q_k, q_p) and bitwise(i_k, i_p),
                  f"{rec['name']} differs from its plain version at {reps} repetition(s) "
                  f"(max abs {err})")
            out[variant, reps] = q_k, i_k
        check(bitwise(out[variant, 4][0], out[variant, 1][0])
              and bitwise(out[variant, 4][1], out[variant, 1][1]),
              f"{rec['name']}: 4 repetitions differ from 1")
        q_k, i_k = micro(mt.micro_step_cuda, ties[0], variant, *ties[1:], br=128, bm=1024)
        q_p, i_p = micro(mt.micro_step_torch, ties[0], variant, *ties[1:], br=128, bm=1024)
        check(bitwise(q_k, q_p) and bitwise(i_k, i_p), f"{rec['name']} differs on the ties")
        ms, _ = cuda_ms(lambda: micro(mt.micro_step_cuda, ins, variant, *lists[1]))
        ms4, _ = cuda_ms(lambda: micro(mt.micro_step_cuda, ins, variant, *lists[4]))
        plain_ms, _ = cuda_ms(lambda: micro(mt.micro_step_torch, ins, variant, *lists[1]))
        step_us = (ms4 - ms) / (mkb.NI * mkb.NJ * 3) * 1e3
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   step_us=step_us, step_bound_us=bound_ms / (mkb.NI * mkb.NJ) * 1e3)
        print(f"    {rec['name']}: (q, idx) bitwise equal to plain at 1 and 4 repetitions "
              f"and on the ties, 4 repetitions == 1; kernel {ms:.4f} ms a repetition "
              f"({mkb.NI * mkb.NJ} steps; 4 repetitions {ms4:.4f} ms), plain {plain_ms:.4f} "
              f"ms; {step_us:.4f} us a step; bound {bound_ms:.4f} ms ({bound_by}), "
              f"{rec['step_bound_us']:.4f} us a step")
    check(bitwise(out["full_t", 1][0], out["full", 1][0])
          and bitwise(out["full_t", 1][1], out["full", 1][1]), "K5 differs from K4 'full'")

    def int_mm_max():
        """The 'matmul' step's q by torch._int_mm: each range tile's int8
        products with all columns (written out as [512, M] i32), combined
        8 abh + abl, and the row max."""
        rows = []
        for rt in range(mkb.NI):
            a = ins["ai"][rt * mkb.BR:(rt + 1) * mkb.BR]
            comb = 8 * torch._int_mm(a, ins["chT"]) + torch._int_mm(a, ins["clT"])
            rows.append(comb.amax(1).to(torch.float32))
        return torch.cat(rows)

    lib_ms, q_lib = cuda_ms(int_mm_max)
    check(bitwise(q_lib, out["matmul", 1][0]), "torch._int_mm's row max differs from 'matmul'")
    kernels.records[("micro_step", "matmul")]["library_ms"] = lib_ms
    print(f"    micro_matmul's yardstick torch._int_mm: {lib_ms:.4f} ms a repetition "
          "(writes the [512, 262144] i32 products of each range tile), q bitwise equal")

    # the path: the microbenchmark's main, as `python -m` runs it
    kernels.zero()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mkb.main()
    counts = kernels.read("micro_kernel", [("micro_step", v) for v in mt.VARIANTS])
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"     | {line}")
    check(rc == 0 and "transposed bit-identical: True" in text,
          f"the microbenchmark exited {rc}")
    print(f"     micro_kernel path: launches {counts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; this script needs one card", file=sys.stderr)
        return 1

    from fractencode_tpu_torch.core.classify import classify_grid
    from fractencode_tpu_torch.core.metrics import psnr
    from fractencode_tpu_torch.decode import decode_plane
    from fractencode_tpu_torch.encode import encode_plane
    from fractencode_tpu_torch.encode import matcher as tm
    from fractencode_tpu_torch.encode.quadtree import (QuadtreeConfig,
                                                       decode_plane_quadtree,
                                                       encode_plane_quadtree)
    from PIL import Image

    from fractencode_tpu_torch.codec import (is_container, pack_container, pack_quadtree,
                                             pack_result, unpack_container,
                                             unpack_quadtree, unpack_result)
    from fractencode_tpu_torch.image import load_gray, load_planes
    from fractencode_tpu_torch.ops import _build
    from fractencode_tpu_torch.ops import matcher_kernels as mk
    from fractencode_tpu_torch.params import REFERENCE_COMPAT

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # -- 1. build
    t0 = time.perf_counter()
    _build.build(*SOURCES)
    for name in SOURCES:
        _build.load_library(name)
    print(f"[1] built {', '.join(SOURCES)} in {time.perf_counter() - t0:.3f} s")
    for name in SOURCES:
        for line in ptxas_report(_build._library(name).with_suffix(".so.log").read_text()):
            print(f"    {line}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    kernels = Kernels()
    _, cfg, dcfg = parse(["--device", "cuda"])
    planes = {n: natural_plane(n, SEED + n) for n in (256, 512, 2048)}
    big = planes[2048]

    def hit_share(q, sa, sa2, c):
        """Share of ranges whose winner meets the threshold: exactly the rows
        that hit (a row that hits wins at or above its hit column's key)."""
        k = c.target_size ** 2
        dist = mk.rank_to_dist(q, sa2, sa, criterion=c.criterion, so_mode=c.so_mode,
                               s_max=c.s_max, inv_norm=tm.inv_norm(c, k, c.source_size ** 2),
                               n=float(k))
        return float((dist <= torch.tensor(c.rms_threshold, dtype=torch.float32)).double()
                     .mean())

    def report_frontier(key, c, q, sa, sa2, pairs, what):
        if c.rms_threshold > 0:
            share = hit_share(q, sa, sa2, c)
            kernels.hits(key, share)
            print(f"      {what}: {share:.4f} of the ranges hit; "
                  f"{pairs} pairs scanned up to each row's frontier")

    def k1_parity(img, c, what, plain_reps=5):
        """K1 on one plane's class-sorted inputs under config c, through the
        encoder's own call (matcher.classed_kernel)."""
        k, area = c.target_size ** 2, c.source_size ** 2
        ranges, sa, sa2, cb, rcls, dcls = level_inputs(img, c)
        prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, c)
        plain_c = dataclasses.replace(c, backend="torch")
        key = ("search_classed", tm.rank_mode(c.criterion, c.so_mode, c.s_max), k,
               c.rms_threshold > 0)
        nbytes = search_bytes(ranges.shape[0], cb.values.shape[0] * cb.values.shape[1], k,
                              prep["sa_s"] is not None)
        rows = prep["rpos"].long()
        q, _, pairs = kernels.parity(
            key, lambda: tm.classed_kernel(prep, k, area, c),
            lambda scanned=None: tm.classed_kernel(prep, k, area, plain_c, scanned=scanned),
            f"{what}, {prep['ai_s'].shape[0]} sorted rows x {prep['ch_s'].shape[0]} "
            "sorted columns", nbytes, plain_reps, real=rows)
        report_frontier(key, c, q[rows], sa, sa2, pairs, what)

    def k3_parity(img, c, what, masked=False, plain_reps=5):
        """K3 on one plane's search-order inputs under config c, through the
        encoder's own call (matcher.dense_kernel)."""
        k, area = c.target_size ** 2, c.source_size ** 2
        ranges, sa, sa2, cb, rcls, dcls = level_inputs(img, c)
        if not masked:
            rcls = dcls = None
        prep = tm.dense_prep(ranges, sa, sa2, cb, rcls, dcls, c)
        check((prep["rcls"] is not None) == masked, "class mask")
        plain_c = dataclasses.replace(c, backend="torch")
        key = ("search_dense", tm.rank_mode(c.criterion, c.so_mode, c.s_max), k,
               c.rms_threshold > 0)
        nbytes = search_bytes(ranges.shape[0], prep["ch"].shape[0], k,
                              prep["sa"] is not None, masked)
        q, _, pairs = kernels.parity(
            key, lambda: tm.dense_kernel(prep, k, area, c),
            lambda scanned=None: tm.dense_kernel(prep, k, area, plain_c, scanned=scanned),
            f"{what}, {prep['ch'].shape[0]} columns"
            + (", class mask" if masked else ""), nbytes, plain_reps)
        report_frontier(key, c, q, sa, sa2, pairs, what)

    # -- 2. K1 parity and times at K = 16
    print("[2] K1 at K = 16 (default path), kernel vs plain")
    for n in (512, 2048):
        k1_parity(planes[n], cfg, f"{n}^2")

    # -- 3. main path at 512^2: card == CPU, bitwise
    card_equals_cpu(planes[512], [], "512")
    print("[3] 512^2 main path: card and CPU EncodeResult and pixels bitwise equal")

    # -- 4. main path at 2048^2 on the card
    res, out, counts = drive(kernels, "default", big, [],
                             [("search_classed", "ls", 16, False)], "2048 cuda")
    check_uniform(res, out, 2048, "2048^2")
    # valid is False exactly where no domain shares the range's class
    plane_t = torch.from_numpy(big)
    rcls = classify_grid(plane_t, res.range_grid)
    dh = torch.bincount(classify_grid(plane_t, res.domain_grid) + 1, minlength=7)
    check(torch.equal(res.valid.cpu(), dh[rcls + 1] > 0), "valid flags")
    enc_ms, dec_ms, (d, iters, _) = wall_times(
        lambda: encode_plane(big, cfg, device="cuda"), lambda e: decode_plane(e, dcfg))
    db = float(psnr(plane_t, d.cpu()))
    db_classed = db
    check(np.array_equal(d.cpu().numpy(), out), "repeat decode differs")
    check(db > 20.0, f"2048^2 PSNR {db:.4f} dB is implausibly low")
    print(f"[4] 2048^2 main path: launches {counts}; encode {enc_ms:.3f} ms, decode "
          f"{dec_ms:.3f} ms ({iters} full-res steps, median of 3 warm runs, host "
          f"clock); PSNR {db:.4f} dB")

    # -- 5. K1 parity and times at K = 64 and 256 (quadtree level inputs)
    print("[5] K1 at K = 64 and 256 (quadtree 8 and 16 px levels), kernel vs plain")
    for k in (64, 256):
        ds, rs = LEVELS[k]
        k1_parity(big, dataclasses.replace(cfg, source_size=ds, target_size=rs),
                  f"2048^2, {rs} px level")

    # -- 6. quadtree path at 512^2: card == CPU, bitwise
    card_equals_cpu(planes[512], ["--quadtree"], "512 quadtree")
    print("[6] 512^2 quadtree path: card and CPU levels and pixels bitwise equal")

    # -- 7. quadtree path at 2048^2 on the card
    qcfg = QuadtreeConfig()  # what the CLI's --qt-* defaults give
    qres, qout, counts = drive(kernels, "quadtree", big, ["--quadtree"],
                               [("search_classed", "ls", k, False) for k in LEVELS],
                               "2048 quadtree cuda")
    check_quadtree(qres, qout, 2048, qcfg, "2048^2 quadtree")
    qres_big = qres  # phase 18 searches its levels again
    enc_ms, dec_ms, (d, iters, _) = wall_times(
        lambda: encode_plane_quadtree(big, cfg, qcfg, device="cuda"),
        lambda e: decode_plane_quadtree(e, dcfg))
    db = float(psnr(plane_t, d.cpu()))
    check(np.array_equal(d.cpu().numpy(), qout), "repeat quadtree decode differs")
    check(db > 20.0, f"2048^2 quadtree PSNR {db:.4f} dB is implausibly low")
    leaves = " ".join(f"{l.range_size}px:{int(l.accepted.sum())}" for l in qres.levels)
    print(f"[7] 2048^2 quadtree path: launches {counts}; leaves {leaves}; encode "
          f"{enc_ms:.3f} ms, decode {dec_ms:.3f} ms ({iters} full-res steps, median "
          f"of 3 warm runs, host clock); PSNR {db:.4f} dB")

    # -- 8. K3 parity and times
    print("[8] K3 (dense search), kernel vs plain")
    nocls = dataclasses.replace(cfg, use_classifier=False)
    compat = REFERENCE_COMPAT(use_classifier=False)
    k3_parity(planes[512], cfg, "512^2", masked=True)  # classifier on: the mask
    for c in (nocls, compat):
        k3_parity(planes[512], c, "512^2")
    k3_parity(planes[512], dataclasses.replace(nocls, so_mode="reference"),
              "512^2, so_mode reference")
    for k in (256, 64):
        ds, rs = LEVELS[k]
        k3_parity(big, dataclasses.replace(nocls, source_size=ds, target_size=rs),
                  f"2048^2, {rs} px level", plain_reps=1)
    _, c1, _ = parse(["--device", "cuda", *CONFIG1, "--noclassifier"])
    k3_parity(big, nocls, "2048^2", plain_reps=1)
    k3_parity(big, c1, "2048^2, config 1", plain_reps=1)

    for (mode, k), argv in KEY_PATHS.items():
        argv = [*argv, "--noclassifier"]
        k3_parity(big, path_config(argv, mode, k), f"2048^2, {' '.join(argv)}", plain_reps=1)

    # -- 9. K1's raw and general keys
    print("[9] K1 'raw' and 'general' keys, kernel vs plain")
    so_ref = dataclasses.replace(cfg, so_mode="reference")
    k1_parity(big, so_ref, "2048^2, so_mode reference", plain_reps=1)
    for base in (REFERENCE_COMPAT(), so_ref, dataclasses.replace(cfg, s_max=0.9)):
        k1_parity(big, dataclasses.replace(base, source_size=32, target_size=8),
                  "2048^2, 8 px level", plain_reps=1)
    for (mode, k), argv in KEY_PATHS.items():
        k1_parity(big, path_config(argv, mode, k), f"2048^2, {' '.join(argv)}", plain_reps=1)

    # -- 10. --noclassifier: 512^2 card == CPU, then 2048^2
    card_equals_cpu(planes[512], ["--noclassifier"], "512 noclassifier")
    print("[10] 512^2 --noclassifier: card and CPU EncodeResult and pixels bitwise equal")
    res, out, counts = drive(kernels, "noclassifier", big, ["--noclassifier"],
                             [("search_dense", "ls", 16, False)], "2048 noclassifier cuda")
    check_uniform(res, out, 2048, "2048^2 --noclassifier")
    check(bool(res.valid.all()), "--noclassifier: every range valid")
    enc_ms, dec_ms, (d, iters, _) = wall_times(
        lambda: encode_plane(big, nocls, device="cuda"), lambda e: decode_plane(e, dcfg))
    db = float(psnr(plane_t, d.cpu()))
    check(np.array_equal(d.cpu().numpy(), out), "repeat --noclassifier decode differs")
    check(db > 20.0, f"2048^2 --noclassifier PSNR {db:.4f} dB is implausibly low")
    ranges, sa, sa2, cb, rcls, dcls = level_inputs(big, cfg)
    q_dense = tm.search_dense(ranges, sa, sa2, cb, None, None, nocls).key
    q_classed = tm.search_classed(ranges, sa, sa2, cb, rcls, dcls, cfg).key
    check(bool((q_dense >= q_classed).all()), "dense key below the class-blocked key")
    better = int((q_dense > q_classed).sum())
    print(f"     2048^2 --noclassifier: launches {counts}; encode {enc_ms:.3f} ms, "
          f"decode {dec_ms:.3f} ms ({iters} full-res steps, median of 3 warm runs, "
          f"host clock); PSNR {db:.4f} dB (classifier: {db_classed:.4f} dB); dense "
          f"key >= class-blocked key for all {q_dense.shape[0]} ranges, > for {better}")

    # -- 11. BASELINE config 1
    card_equals_cpu(planes[256], [*CONFIG1, "--noclassifier"], "256 config 1")
    print("[11] 256^2 config 1: card and CPU EncodeResult and pixels bitwise equal")
    res, out, counts = drive(kernels, "config1", big, [*CONFIG1, "--noclassifier"],
                             [("search_dense", "ls", 64, False)], "2048 config 1 cuda")
    check_uniform(res, out, 2048, "2048^2 config 1")
    enc_ms, dec_ms, (d, iters, _) = wall_times(
        lambda: encode_plane(big, c1, device="cuda"), lambda e: decode_plane(e, dcfg))
    db = float(psnr(plane_t, d.cpu()))
    check(np.array_equal(d.cpu().numpy(), out), "repeat config 1 decode differs")
    check(db > 20.0, f"2048^2 config 1 PSNR {db:.4f} dB is implausibly low")
    print(f"     2048^2 config 1: launches {counts}; encode {enc_ms:.3f} ms, decode "
          f"{dec_ms:.3f} ms ({iters} full-res steps, median of 3 warm runs, host "
          f"clock); PSNR {db:.4f} dB")

    # -- 12. --noclassifier --quadtree
    qflags = ["--quadtree", "--noclassifier"]
    card_equals_cpu(planes[512], qflags, "512 noclassifier quadtree")
    print("[12] 512^2 --noclassifier --quadtree: card and CPU levels and pixels "
          "bitwise equal")
    qres, qout, counts = drive(kernels, "noclassifier_quadtree", big, qflags,
                               [("search_dense", "ls", k, False) for k in LEVELS],
                               "2048 noclassifier quadtree cuda")
    check_quadtree(qres, qout, 2048, qcfg, "2048^2 --noclassifier --quadtree")
    enc_ms, dec_ms, (d, iters, _) = wall_times(
        lambda: encode_plane_quadtree(big, nocls, qcfg, device="cuda"),
        lambda e: decode_plane_quadtree(e, dcfg))
    db = float(psnr(plane_t, d.cpu()))
    check(np.array_equal(d.cpu().numpy(), qout), "repeat quadtree decode differs")
    check(db > 20.0, f"2048^2 --noclassifier --quadtree PSNR {db:.4f} dB is too low")
    leaves = " ".join(f"{l.range_size}px:{int(l.accepted.sum())}" for l in qres.levels)
    print(f"     2048^2 --noclassifier --quadtree: launches {counts}; leaves {leaves}; "
          f"encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms ({iters} full-res steps, "
          f"median of 3 warm runs, host clock); PSNR {db:.4f} dB")

    # -- 13. the other keys' paths at 2048^2
    print("[13] the raw and general keys' paths: card == CPU at 256^2, then 2048^2")
    for kernel, nocls_flag in (("search_classed", []), ("search_dense", ["--noclassifier"])):
        for (mode, k), key_argv in KEY_PATHS.items():
            argv = [*key_argv, *nocls_flag]
            path = " ".join(argv)
            card_equals_cpu(planes[256], argv, f"256 {path}")
            print(f"     256^2 {path}: card and CPU results and pixels bitwise equal")
            res, out, counts = drive(kernels, path, big, argv,
                                     [(kernel, mode, kk, False) for kk in path_ks(argv, k)],
                                     f"2048 {path} cuda")
            leaves = ""
            if "--quadtree" in argv:
                check_quadtree(res, out, 2048, qcfg, f"2048^2 {path}")
                leaves = "; leaves " + " ".join(f"{l.range_size}px:{int(l.accepted.sum())}"
                                                for l in res.levels)
            else:
                check_uniform(res, out, 2048, f"2048^2 {path}")
            db = float(psnr(plane_t, torch.from_numpy(out)))
            check(db > 20.0, f"2048^2 {path} PSNR {db:.4f} dB is implausibly low")
            print(f"     2048^2 {path}: launches {counts}{leaves}; PSNR {db:.4f} dB")

    # -- 14. the C++ reference goldens on the card
    lenna = load_gray(os.path.join(GOLDEN, "lenna128_input.png"))
    nx = (128 - 16) // 8 + 1
    for name in GOLDENS:
        flags, dump, ref = cpp_golden(name)
        _, gcfg, _ = parse(["--device", "cuda", "--compat", *flags])
        kernel = "search_dense" if "--noclassifier" in flags else "search_classed"
        kernels.zero()
        res = encode_plane(lenna, gcfg, device="cuda")
        out, _, _ = decode_plane(res)  # the reference's flat decode
        kernels.read(f"golden {name}", [(kernel, "raw", 16, "--rms" in flags)])
        dom = (dump[:, 5] // 8).astype(int) * nx + (dump[:, 4] // 8).astype(int)
        check(np.array_equal(res.domain_idx.cpu().numpy(), dom), f"{name}: domains")
        check(np.array_equal(res.transform.cpu().numpy(), dump[:, 8].astype(int)),
              f"{name}: isometries")
        for f, col, atol in (("distance", 11, 1e-6), ("s", 9, 5e-4), ("o", 10, 0.1)):
            err = np.abs(getattr(res, f).cpu().numpy() - dump[:, col]).max()
            check(err <= atol, f"{name}: {f} off the C++ dump by {err}")
        diff = np.abs(out.cpu().numpy().astype(int) - ref.astype(int))
        off = int((diff > 0).sum())
        if name == "smax09":  # the reference clamps in double when decoding
            check(off <= 2 and diff.max() <= 1, f"{name}: {off} pixels off the C++ result")
        else:
            check(off == 0, f"{name}: {off} pixels off the C++ result")
        print(f"[14] C++ golden {name}: winners equal, s/o/distance within tolerance, "
              f"{off} decoded pixels off the C++ result.png")

    # -- 15. the frontier instances against their plain versions
    print("[15] the early-accept frontier (_thr instances), kernel vs plain")

    smooth = smooth_plane(512, SEED)
    checked = set()
    for name, (_, insts) in RMS_PATHS.items():
        for kernel, mode, k in insts:
            if (kernel, mode, k) in checked:
                continue
            checked.add((kernel, mode, k))
            c = path_config(RMS_PATHS[name][0], mode, k)
            check(c.rms_threshold == 10.0, f"{name}: rms_threshold {c.rms_threshold}")
            parity = k1_parity if kernel == "search_classed" else k3_parity
            parity(planes[512], c, f"512^2, {name}")
            if k == 256:  # few 16 px ranges of a natural plane hit
                parity(smooth, c, f"512^2 smooth plane, {name}")
            parity(big, c, f"2048^2, {name}", plain_reps=1)
            share = kernels.records[(kernel, mode, k, True)].get("max_hit_share", 0.0)
            check(share > 0, f"{kernel} {mode}{k}_thr: no range hit in any check")

    # -- 16. the --rms paths: card == CPU, then 2048^2
    print("[16] the --rms paths: card == CPU, then 2048^2 with launch counts")
    thr32 = torch.tensor(10.0, dtype=torch.float32)
    for i, (name, (argv, insts)) in enumerate(RMS_PATHS.items()):
        n_eq = 512 if name == "--rms 10" else 256
        card_equals_cpu(planes[n_eq], argv, f"{n_eq} {name}")
        print(f"     {n_eq}^2 {name}: card and CPU results and pixels bitwise equal")
        res, out, counts = drive(kernels, name, big, argv,
                                 [(kernel, mode, k, True) for kernel, mode, k in insts],
                                 f"2048 {name}")
        plain = [n for n in counts if not n.endswith("_thr")]
        check(not plain, f"{name} launched instances without the frontier: {plain}")
        args, c, dcfg_p = parse(["--device", "cuda", *argv])
        if args.quadtree:
            check_quadtree(res, out, 2048, qcfg, f"2048^2 {name}")
            shares = []
            for l in res.levels:  # error is the distance, per pixel for 'raw'
                err = l.error[torch.isfinite(l.error)].cpu()
                if c.criterion == "raw":  # exact: a power-of-two scale
                    err = err * (l.range_size ** 2 / l.domain_size ** 2)
                shares.append(f"{l.range_size}px:{float((err <= thr32).double().mean()):.4f}")
            what = ("leaves " + " ".join(f"{l.range_size}px:{int(l.accepted.sum())}"
                                         for l in res.levels)
                    + "; hit share of the searched ranges " + " ".join(shares))
            encode = lambda: encode_plane_quadtree(big, c, qcfg, device="cuda")
            decode = lambda e: decode_plane_quadtree(e, dcfg_p)
        else:
            check_uniform(res, out, 2048, f"2048^2 {name}")
            hit = float((res.distance[res.valid].cpu() <= thr32).double().mean())
            what = f"hit share {hit:.4f}"
            encode = lambda: encode_plane(big, c, device="cuda")
            decode = lambda e: decode_plane(e, dcfg_p)
        db = float(psnr(plane_t, torch.from_numpy(out)))
        check(db > 20.0, f"2048^2 {name} PSNR {db:.4f} dB is implausibly low")
        timing = ""
        if i < 6:
            enc_ms, dec_ms, (d, iters, _) = wall_times(encode, decode)
            check(np.array_equal(d.cpu().numpy(), out), f"repeat {name} decode differs")
            timing = (f"; encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms ({iters} "
                      "full-res steps, median of 3 warm runs, host clock)")
        print(f"     2048^2 {name}: launches {counts}; {what}; PSNR {db:.4f} dB{timing}")

    # -- 17. the bitstream: --out, then --decode-file, on the card
    print("[17] the bitstream: --out and --decode-file on the card")
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    for n in (512, 2048):
        sources = {"gray": os.path.join(work, f"gray{n}.png"),
                   "rgb": os.path.join(work, f"rgb{n}.png")}
        Image.fromarray(planes[n]).save(sources["gray"])
        rgb = np.stack([planes[n], natural_plane(n, SEED + 1), natural_plane(n, SEED + 2)], -1)
        Image.fromarray(rgb).save(sources["rgb"])
        for name, (flags, expect) in BITSTREAM_PATHS.items():
            src = sources["rgb" if "--color" in flags else "gray"]
            file = lambda tag: os.path.join(work, f"{n}_{tag}")
            kernels.zero()
            rc, text = run_cli([src, *flags, "--out", file("card.ft"),
                                "--result", file("enc.png")])
            counts = kernels.read(f"{name} --out", expect)
            check(rc == 0, f"{n}^2 {name} --out: exit {rc}")
            with open(file("card.ft"), "rb") as f:
                blob = f.read()
            bpp = 8 * len(blob) / n ** 2
            check(f"bitstream: {len(blob)} bytes" in text and f"bpp: {bpp:.4f}" in text,
                  f"{n}^2 {name}: the CLI's bitstream lines")
            # the decoder flags of the encode (--compat: the reference's flat decode)
            dflags = [f for f in flags if f == "--compat"]
            rc, _ = run_cli(["--decode-file", file("card.ft"), *dflags,
                             "--result", file("dec.png")])
            check(rc == 0, f"{n}^2 {name} --decode-file on the card: exit {rc}")
            y_dec = load_planes(file("dec.png"))[0]
            if n == 512:
                rc, _ = run_cli([src, *flags, "--device", "cpu", "--out", file("cpu.ft"),
                                 "--result", file("enc_cpu.png")])
                with open(file("cpu.ft"), "rb") as f:
                    check(rc == 0 and f.read() == blob,
                          f"{n}^2 {name}: the CPU's encode writes other bytes")
                rc, _ = run_cli(["--decode-file", file("card.ft"), *dflags, "--device",
                                 "cpu", "--result", file("dec_cpu.png")])
                check(rc == 0 and np.array_equal(np.asarray(Image.open(file("dec_cpu.png"))),
                                                 np.asarray(Image.open(file("dec.png")))),
                      f"{n}^2 {name}: the card's decode of the file differs from the CPU's")
            # pack the card's results (what the CLI packs) and unpack the file
            args, c, _ = parse(["--device", "cuda", src, *flags])
            pl = load_planes(src)[:3 if args.color else 1]
            if args.quadtree:
                results = [encode_plane_quadtree(p, c, qcfg, device="cuda") for p in pl]
                pack, unpack = pack_quadtree, unpack_quadtree
            else:
                results = [encode_plane(p, c, device="cuda") for p in pl]
                pack, unpack = pack_result, unpack_result

            def pack_all():
                blobs = [pack(r, plane=p) for r, p in zip(results, pl)]
                return blobs[0] if len(blobs) == 1 else pack_container(blobs)

            reps = 3 if n == 512 else 1
            pack_ms, packed = host_ms(pack_all, reps)
            check(packed == blob, f"{n}^2 {name}: packing the card's results gives other bytes")

            def unpack_all():
                out = [unpack(b, "cuda") for b in
                       (unpack_container(blob) if is_container(blob) else [blob])]
                torch.cuda.synchronize()
                return out

            unpack_ms, _ = host_ms(unpack_all, reps)
            # the file's s and o (5 and 7 bits) cost little against the encode's
            # own decode (the CLI's first psnr line: Y's): within 3 dB of it, or
            # still above 30 dB where quantization noise is all that is left
            db = float(psnr(torch.from_numpy(load_planes(src)[0]), torch.from_numpy(y_dec)))
            db_enc = float(re.search(r"psnr: ([0-9.]+) dB", text).group(1))
            check(db > min(db_enc - 3.0, 30.0), f"{n}^2 {name}: the decoded file's PSNR "
                                                f"{db:.4f} dB, the encode's {db_enc:.4f} dB")
            print(f"     {n}^2 {name}: launches {counts}; {len(blob)} bytes, {bpp:.4f} bpp, "
                  f"decoded file's Y PSNR {db:.4f} dB (the encode's {db_enc:.4f} dB); "
                  f"pack {pack_ms:.3f} ms, unpack onto "
                  f"the card {unpack_ms:.3f} ms ({'median of 3' if reps > 1 else 'one run'}, "
                  "host clock, after a warmup)"
                  + ("; card == CPU: the same bytes and decoded pixels" if n == 512 else ""))
    shutil.rmtree(work)

    # -- 18. K2: kernel vs plain, K2 vs K1, and the 8192^2 paths
    print("[18] K2 (2-D class-blocked search): kernel vs plain on the forced route")
    t18 = time.perf_counter()
    key_cfgs = {"ls": cfg, "raw": REFERENCE_COMPAT(), "general": dataclasses.replace(cfg, s_max=0.9)}

    def k2_parity(img, c, what, plain_reps=5, splits=None):
        """K2 on one plane's class-sorted inputs under config c, on the
        forced route, through the encoder's own call (matcher.classed_kernel)."""
        k, area = c.target_size ** 2, c.source_size ** 2
        ranges, sa, sa2, cb, rcls, dcls = level_inputs(img, c)
        prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, c, force_no_pairs=True)
        check(prep["route"] == "search_classed2d", f"{what}: forced route {prep['route']}")
        plain_c = dataclasses.replace(c, backend="torch")
        key = ("search_classed2d", tm.rank_mode(c.criterion, c.so_mode, c.s_max), k,
               c.rms_threshold > 0)
        nbytes = search_bytes(ranges.shape[0], cb.values.shape[0] * cb.values.shape[1], k,
                              prep["sa_s"] is not None)
        rows = prep["rpos"].long()
        q, _, pairs = kernels.parity(
            key, lambda: tm.classed_kernel(prep, k, area, c, splits=splits),
            lambda scanned=None: tm.classed_kernel(prep, k, area, plain_c, scanned=scanned,
                                                   splits=splits),
            f"{what}, {prep['ai_s'].shape[0]} sorted rows x {prep['ch_s'].shape[0]} "
            "sorted columns", nbytes, plain_reps, real=rows)
        plan = mk.search_classed2d_cuda.plan
        print(f"      {plan['splits']} splits of {plan['width']} columns over "
              f"{plan['searched']} range tiles, partials {plan['partial_bytes']} bytes")
        report_frontier(key, c, q[rows], sa, sa2, pairs, what)
        return plan

    for mode, base in key_cfgs.items():
        for thr in (False, True):
            c16 = dataclasses.replace(base, rms_threshold=10.0 if thr else 0.0)
            k2_parity(planes[512], c16, f"512^2, {mode}16")
            for k in (64, 256):
                ds, rs = LEVELS[k]
                c = dataclasses.replace(c16, source_size=ds, target_size=rs)
                k2_parity(planes[512], c, f"512^2, {rs} px level")
                if thr and k == 256:
                    k2_parity(smooth, c, f"512^2 smooth plane, {rs} px level")
                k2_parity(big, c, f"2048^2, {rs} px level", plain_reps=1)
            if thr:
                for k in LEVELS:
                    share = kernels.records[("search_classed2d", mode, k, True)].get(
                        "max_hit_share", 0.0)
                    check(share > 0, f"search_classed2d {mode}{k}_thr: no range hit")
    plan = k2_parity(planes[512], cfg, "512^2, splits of 64 columns", splits=64)
    check(plan["splits"] > 1, "K2 with 64-column splits ran one split")

    def k1_vs_k2(prep, c, what, reps=5):
        """K1 and K2 on the same prep, (q, idx) bitwise, with both times."""
        k, area = c.target_size ** 2, c.source_size ** 2
        k1 = dict(prep, route="search_classed")
        k2 = dict(prep, route="search_classed2d")
        ms1, (q1, i1) = cuda_ms(lambda: tm.classed_kernel(k1, k, area, c), reps)
        ms2, (q2, i2) = cuda_ms(lambda: tm.classed_kernel(k2, k, area, c), reps)
        check(bitwise(q1, q2) and bitwise(i1, i2), f"K2 differs from K1 at {what}")
        plan = dict(mk.search_classed2d_cuda.plan)
        rows = prep["rpos"].long()
        seg = (prep["col_end"] - prep["col_tile_start"] * prep["block_m"]).long()
        pairs = int(seg[prep["tile_class"].long()[rows // prep["block_r"]]].sum())
        bound_ms, bound_by = bound(pairs, k, search_bytes(
            rows.shape[0], prep["b4_cols"].shape[0], k, prep["sa_s"] is not None))
        print(f"    {what}: K1 {ms1:.4f} ms, K2 {ms2:.4f} ms ({plan['splits']} splits of "
              f"{plan['width']} columns over {plan['searched']} range tiles, partials "
              f"{plan['partial_bytes']} bytes; "
              f"{'median of 5' if reps > 1 else 'one run'}); (q, idx) bitwise equal; "
              f"{rows.shape[0]} rows, {pairs} same-class pairs, bound {bound_ms:.4f} ms "
              f"({bound_by}{', without the frontier' if c.rms_threshold > 0 else ''})")
        return ms1, ms2, plan, (q2, i2)

    def k2_sampled(prep, c, plan, full, what):
        """K2 against its plain version on a prep too large for the plain
        version whole: a sample of its range tiles, the first and last of
        each class's run, with the path's split width (``plan``).  The other
        tiles point at the empty column bin, so neither version searches
        them.  The path's own run (``full``) and the sampled run of the
        kernel, on the sampled rows, are bitwise equal to the plain."""
        k, area = c.target_size ** 2, c.source_size ** 2
        tc, br = prep["tile_class"], prep["block_r"]
        tiles = sorted({t for t0, t1, _ in mk._class_runs(tc) for t in (t0, t1 - 1)})
        keep = torch.zeros(tc.shape[0], dtype=torch.bool, device=tc.device)
        keep[tiles] = True
        sub = dict(prep, tile_class=torch.where(keep, tc, prep["col_end"].shape[0] - 1)
                   .to(torch.int32))
        rows = prep["rpos"].long()
        real = rows[keep[rows // br]]
        key = ("search_classed2d", tm.rank_mode(c.criterion, c.so_mode, c.s_max), k,
               c.rms_threshold > 0)
        plain_c = dataclasses.replace(c, backend="torch")
        width = plan["width"]
        q_k, i_k, pairs = kernels.parity(
            key, lambda: tm.classed_kernel(sub, k, area, c, splits=width),
            lambda scanned=None: tm.classed_kernel(sub, k, area, plain_c, scanned=scanned,
                                                   splits=width),
            f"{what}, {len(tiles)} of {tc.shape[0]} range tiles ({real.shape[0]} ranges; "
            f"the first and last of each class), the path's {plan['splits']} split(s) of "
            f"{width} columns", search_bytes(real.shape[0], prep["b4_cols"].shape[0], k,
                                            prep["sa_s"] is not None),
            plain_reps=1, real=real)
        check(mk.search_classed2d_cuda.plan["splits"] == plan["splits"],
              f"{what}: the sample ran {mk.search_classed2d_cuda.plan['splits']} splits")
        sampled = keep.repeat_interleave(br)
        check(bitwise(full[0][sampled], q_k[sampled]) and bitwise(full[1][sampled], i_k[sampled]),
              f"{what}: the path's K2 differs from its plain version on the sampled tiles")
        if c.rms_threshold > 0:  # the sorted sums exist with the frontier
            report_frontier(key, c, q_k[real], prep["sa_s"][real], prep["sa2_s"][real], pairs,
                            what)

    print("     K2 against K1 on the same prep (route by the JAX package's rule; "
          "these times are for routing by speed)")
    for n in (512, 2048):
        ranges, sa, sa2, cb, rcls, dcls = level_inputs(planes[n], cfg)
        k1_vs_k2(tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, cfg), cfg, f"{n}^2 default")
    masks, covered = [], None
    for l in qres_big.levels:  # each level's coverage mask, as the encoder builds it
        ny = 2048 // l.range_size
        masks.append(None if covered is None else ~covered.reshape(-1))
        acc = l.accepted.reshape(ny, ny)
        covered = acc if covered is None else covered | acc
        covered = covered.repeat_interleave(2, 0).repeat_interleave(2, 1)
    for l, mask in zip(qres_big.levels, masks):
        c = dataclasses.replace(cfg, source_size=l.domain_size, target_size=l.range_size)
        ranges, sa, sa2, cb, rcls, dcls = level_inputs(big, c)
        prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, c, range_mask=mask)
        searched = ranges.shape[0] if mask is None else int(mask.sum())
        k1_vs_k2(prep, c, f"2048^2 quadtree {l.range_size} px level ({searched} ranges "
                          "searched)")

    # the 8192^2 paths: the JAX package's pair list overflows there, so both
    # route to K2
    n8 = 8192
    huge = natural_plane(n8, SEED + n8)
    huge_t = torch.from_numpy(huge)
    for name, argv, expect in (("8192 default", [], ("ls", 16, False)),
                               ("8192 --rms 10", RMS, ("ls", 16, True))):
        res, out, counts = drive(kernels, name, huge, argv, [("search_classed2d", *expect)],
                                 f"{name} cuda")
        k1 = [n for n in counts if n.startswith("search_classed_")]
        check(not k1 and counts == {kernels.records[("search_classed2d", *expect)]["name"]: 1},
              f"{name}: launches {counts}, not K2's {expect} once")
        plan = mk.search_classed2d_cuda.plan
        check_uniform(res, out, n8, f"{n8}^2 {name}")
        _, c, dcfg_p = parse(["--device", "cuda", *argv])
        enc_ms, dec_ms, (d, iters, _) = wall_times(
            lambda: encode_plane(huge, c, device="cuda"), lambda e: decode_plane(e, dcfg_p),
            reps=1)
        check(np.array_equal(d.cpu().numpy(), out), f"repeat {name} decode differs")
        db = float(psnr(huge_t, d.cpu()))
        check(db > 20.0, f"{name} PSNR {db:.4f} dB is implausibly low")
        ranges, sa, sa2, cb, rcls, dcls = level_inputs(huge, c)
        prep = tm.classed_prep(ranges, sa, sa2, cb, rcls, dcls, c)
        check(prep["route"] == "search_classed2d",
              f"{name}: route {prep['route']}, n_pairs {prep['n_pairs']}")
        _, _, plan_p, full = k1_vs_k2(prep, c, f"{n8}^2 {name[5:]} prep", reps=1)
        k2_sampled(prep, c, plan_p, full, f"{n8}^2 {name[5:]} prep")
        del prep, ranges, cb, full
        print(f"     {n8}^2 {name[5:]}: launches {counts}; route K2 (worst_pairs "
              f"{tm._classed_statics((n8 // 4) ** 2, ((n8 - 16) // 8 + 1) ** 2 * 4)[4]}, "
              f"n_pairs above the cap {mk.PAIR_CAP}); {plan['splits']} split(s) of "
              f"{plan['width']} columns, partials {plan['partial_bytes']} bytes; encode "
              f"{enc_ms:.3f} ms, decode {dec_ms:.3f} ms ({iters} full-res steps, one warm "
              f"run, host clock); PSNR {db:.4f} dB")
    name = "8192 --quadtree"
    qres, qout, counts = drive(kernels, name, huge, ["--quadtree"], [], f"{name} cuda")
    check_quadtree(qres, qout, n8, qcfg, f"{n8}^2 --quadtree")
    routes = []
    for l in qres.levels:
        k = l.range_size ** 2
        took = [kern for kern in ("search_classed", "search_classed2d")
                if counts.get(kernels.records[(kern, "ls", k, False)]["name"])]
        check(len(took) == 1, f"{name} {l.range_size} px level: launched {took}")
        routes.append(f"{l.range_size}px:{took[0]}")
    db = float(psnr(huge_t, torch.from_numpy(qout)))
    check(db > 20.0, f"{name} PSNR {db:.4f} dB is implausibly low")
    leaves = " ".join(f"{l.range_size}px:{int(l.accepted.sum())}" for l in qres.levels)
    print(f"     {n8}^2 --quadtree: routes {' '.join(routes)}; launches {counts}; leaves "
          f"{leaves}; PSNR {db:.4f} dB")
    print(f"     phase 18 took {time.perf_counter() - t18:.1f} s")

    # -- 19. K4 and K5: the pair-list step microbenchmark
    print("[19] K4/K5 (the pair-list step microbenchmark), kernel vs plain")
    t19 = time.perf_counter()
    micro_phase(kernels)
    print(f"     phase 19 took {time.perf_counter() - t19:.1f} s")

    records = list(kernels.records.values())
    for rec in records:
        # K2 runs where the JAX package routes to it: at 8192^2 only its 'ls'
        # instances at K = 16; the others report the launches they had
        if not rec["name"].startswith("search_classed2d"):
            check(rec["launches"] > 0, f"{rec['name']} was launched by no path")
        check("ms" in rec and "bound_ms" in rec, f"{rec['name']} was not timed")
    check(len(records) == 59, f"{len(records)} kernel records, not 59")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
