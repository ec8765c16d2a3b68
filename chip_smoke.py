#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fractencode_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp4a DIR   # also time every kernel against DIR's build

Phases, each of which must pass (any failure exits non-zero):
  1. build the CUDA kernels from csrc/ (search_classed.cu, K1,
     search_classed2d.cu, K2, search_dense.cu, K3, and micro_step.cu, K4
     and K5: one nvcc each, in parallel, into build/kernels/), print each
     instantiation's registers and spills from ptxas' report, one line per
     library (all four on the tensor-core mainloop) with its SASS counts of
     tensor-core (IMMA, HGMMA, IGMMA) and dp4a (IDP.4A) instructions, of
     which it must hold some IMMA and no dp4a, and the card's name and power
     limit; with --dp4a DIR also DIR's builds' counts, and for each search
     library (K1, K2, K3) whether its SASS is identical to DIR's build of
     the same source, or how many lines differ;
  2. K1 parity at K = 16: the search kernel against its plain PyTorch
     version on the same class-sorted tensors at 512^2 and 2048^2, (q, idx)
     bitwise equal, with both times (CUDA events, median of 5 after a
     warmup); then K1's block order: the range tiles in the grid's order
     against longest class segment first (the same kernel on a copy of the
     prep whose tiles are permuted on the card), timed in turns, (q, idx)
     bitwise the same rows, at 512^2, 2048^2, the 2048^2 8 and 16 px
     quadtree levels and 2048^2 --compat;
  3. the CLI's encode -> pyramid-decode path (cli._encode_one) at 512^2 on
     the card, bitwise equal to the same call on the CPU;
  4. the same path at 2048^2 on the card, with the kernel's launch count, the
     encode and decode wall times and the PSNR; then the encode by stage
     (inputs, prep, the search, post; each alone, device and host ms) and
     the card's busy share of a whole encode (torch.profiler);
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
     (bitwise, CUDA events, median of 5; with --dp4a each also in turns with
     its dp4a design) at 512^2 and 2048^2 and on the
     2048^2 quadtree's levels with their coverage masks, and on its masked
     8 px and 4 px levels K2 with the width it picks on the device against
     one split a segment (in turns); then at 8192^2
     the default and --rms 10 paths through cli._encode_one (the counted
     route, which the JAX package's pair-list overflow decides on the
     device, taking K2: K2 and K1, over empty segments, launch once each),
     with K2 against K1 on their preps, encode and decode wall times, PSNR,
     the split count and the partials' bytes, and K2 against its plain
     version at the path's own split plan on a sample of the range tiles
     (the first and last of each class: the plain version of the whole
     plane would take minutes); and --quadtree at 8192^2 with the route
     each level took (K1 at every level, K2 too where it is counted);
 19. K4 and K5, the pair-list step microbenchmark (ops/micro_kernels.py):
     at the JAX script's shapes and draws (fractencode_tpu_torch.scripts.
     micro_kernel: 8 x 64 tiles of 512 x 4096 at K = 16), each of the five
     instances against its plain version at 1 and 4 repetitions of the
     list, (q, idx) bitwise; K5 against K4 'full' and 4 repetitions against
     1, bitwise; every instance on a small list of ties; the five timed in
     turns (1 and 4 repetitions, medians of 7), and the split of K1's step
     they give: products ('matmul'), key ('noargpass' - 'matmul'), argmax
     ('full' - 'noargpass'), the one-pass argmax ('packed' - 'noargpass')
     and K5's transposed staging (K5 - 'full'), in us a step and as shares
     of 'full'; then the microbenchmark's main (the path `micro_kernel`),
     whose lines it prints;
 20. the batch forms at BENCH_r05's batch shapes on distinct natural-like
     frames: encode_batch_stacked of 16 x 512^2 (every frame bitwise equal
     to encode_plane on the card, frames 0 and 15 to the CPU's encode, K1's
     launches 16 times the single frame's), decode_batch_stacked of it with
     the CLI's pyramid (pixels, iterations and MSE equal to decode_plane's
     per frame) and encode_batch_quadtree_stacked of 8 x 1024^2 (every
     level equal to encode_plane_quadtree's per frame, K1's launches the
     single frames' sum); then per form the host ms a frame, the card's
     busy share under torch.profiler (one warm run) and the host syncs a
     frame with their lines (torch.cuda.set_sync_debug_mode("warn"));
     encode_batch_stacked and decode_batch_stacked must replay their CUDA
     graphs (utils.graphs) for every frame of a warm call and sync at most
     once a call (the frames' upload; the MSEs' read);
 21. --vq-classes 4: the CLI path card == CPU at 512^2; the VQ labels and
     codebook steps card == CPU at 512^2, 2048^2 and 4096^2 (the subsample
     branch); then the 2048^2 and 4096^2 paths (K1 at 2048^2; the route's
     K1 or K2 at 4096^2), with encode ms, PSNR and codebook steps beside
     the classifier's;
 22. `python -m fractencode_tpu_torch` on a 512^2 PNG on the card, three
     processes side by side: --log --profile DIR (the phase table, and a
     trace in DIR that names K1's kernel), --quadtree --log (the phase table
     and the progress line) and --vq-classes 3; each must exit 0;
 23. sharding (fractencode_tpu_torch.parallel), on meshes that repeat cuda:0
     (one card: host ms beside the single-device forms' are the sharding's
     overhead, not scaling), every field bitwise against the single-device
     functions on the card: each of K3's 18 masked instances (every key and
     K, plain and `_thr`: the shards' domain masks as classes) on a 'domains'
     path at 256^2 and against its plain version at that path's last band;
     encode_batch_sharded of phase 20's 16 x 512^2 frames on (2, 4) by each
     strategy, default and --rms 10, and without the classifier by 'domains'
     and 'ring' (K3 masked), against encode_batch_stacked; its decode, flat
     and pyramid, against decode_batch_stacked; encode_plane_sharded_image
     at 2048^2 on (1, 4), replicate and ring, with and without the classifier
     and --rms 10, and at 4096^2 by ring, against encode_plane, with the
     codebook bytes a shard holds at its peak (from the tensors' sizes); K3
     `ls16` masked, plain and `_thr`, timed at the 2048^2 --noclassifier
     halo band (± --rms 10); the quadtree pair on (4, 2) at 8 x 1024^2
     against the stacked form; the pod driver (scripts/encode_pod.py) as
     one process and as two
     (gloo, localhost) for each strategy, whose checksums must agree; and
     dryrun_multichip on cuda:0 x 8.  No sharded path may run a plain search
     on the card.  Then the sharded forms on their step graphs
     (parallel.sharded: one CUDA graph for each (step, config, shapes,
     device), the shard index an input): the three strategies at 16 x 512^2
     on (2, 4), the 2048^2 halo plane on (1, 4) by replicate and ring, and
     the sharded decodes (flat, pyramid, the quadtree's pyramid), each eager
     against graph in turns (host ms a frame, the graph's busy share, host
     syncs a call:
     the upload only for an encode, one read a call plus one a flat-loop
     chunk for a decode), a warm graph call's graphs.calls by step (every
     step a replay), the graphs held (a ring at most 4) and the K1 ls16 and
     K3 masked launches on the replays (--noclassifier 'domains' and
     --noclassifier --rms 10 'ring' too), and the card memory after the
     phase and after graphs.clear();
 24. every range size the JAX CLI accepts (range_phase): the padded
     instances (n = 4, 36, 100: K = 16, 64, 256 over operands zero past n)
     and the K-slab form (n = 1024).  The quadtree from 32 px down to 2 px
     at 2048^2 (default, --noclassifier, --compat, --smax 0.9, --rms 10),
     card == CPU at 256^2 on every level, with each level's instance, the
     leaves, times and PSNR; the grid at --source 8 --target 2, 12/6, 20/10
     and 64/32, with and without the classifier, card == CPU at 256^2
     (252^2, 240^2), times and PSNR at 2048^2 (2040^2); each new instance
     of K1, K2 and K3 under each key, plain and `_thr`, launched by a CLI
     path at 512^2 (504^2, 500^2) and against its plain version at that
     path's config (K2 on the forced route; `_thr` also on a smooth plane,
     where it must hit), K3's masked ones on 'domains' paths of the sharded
     batch encode; the files (--out, --decode-file) of the --qt-min 2
     --qt-max 32 path and of --source 8 --target 2 at 512^2, card == CPU
     byte for byte;
 25. the main path on its CUDA graphs (graph_phase; utils.graphs, one
     graph for each (shape, config, device), the counterpart of the JAX
     package's jitted encode and decode): every path of GRAPH_PATHS
     (default, --compat, --smax 0.9, --rms 10, --noclassifier, config 1,
     --source 8 --target 2) at 512^2 and the default at 2048^2, where the
     predicate (matcher.replays_graph) must take the graph: encode_plane's
     first call (eager), its second (the capture and a replay) and a third
     replay on another plane, bitwise equal to the eager encode and (at
     512^2) the CPU's, one launch of the path's kernel a call, the last one
     seen by torch.profiler as that one kernel instance, the earlier result
     unchanged by the later call; the CLI's pyramid decode of it, eager then
     captured and replayed, equal to the eager decode and (at 512^2) the
     CPU's; then the eager and the graph forms in turns (host clock, medians
     of 7) of the 16 x 512^2 encode_batch_stacked and decode_batch_stacked
     and the 2048^2 encode_plane, each with the card's busy share and its host
     syncs a frame by line; a graph form may sync once a call at most; the
     card memory held by the graphs and tables, and after graphs.clear();
 26. the JAX package's remaining device loops on CUDA graphs (loop_phase):
     the quadtree pyramid (encode_plane_quadtree, one graph where
     quadtree._replays holds) for default, --noclassifier, --compat, --smax
     0.9, --rms 10 at 512^2 and 2048^2 and --qt-min 2 at 512^2: the first
     call eager, the second the capture and a replay, a third a replay on
     another plane, every level bitwise equal to the per-level eager encode
     and (512^2) the CPU's, K1/K3 launches a call equal to the eager
     encode's, torch.profiler naming the instances the third call ran, the
     earlier result unchanged; its pyramid and flat decodes graph == eager
     (== CPU); the flat loop (graphs.while_loop: chunks of predicated steps,
     the exit flag read once a chunk) of decode_batch_stacked and
     decode_plane on phase 20's 16 x 512^2 frames (--compat and default
     encodes) and on 64^2 crops of the golden Lenna and a noise plane,
     graph == eager chunks (== CPU), with exits on the epsilon, the period-2
     cycle, the stall and max_iterations; --vq-classes 4 at 512^2 and 2048^2
     (the k-means' start, its chunks and the encode as graphs): codebook,
     labels, steps and winners graph == eager == CPU (winners at 512^2);
     then eager and graph forms in turns (host ms, busy share, host syncs a
     frame by line) of the 8 x 1024^2 encode_batch_quadtree_stacked, the
     2048^2 quadtree encode and its pyramid decode, the 2048^2 flat decode
     and the 2048^2 VQ encode; the chunk length's sweep (flat decode: 1, 4,
     8, 16 and eager 1; VQ: 1, 8, 32); the card memory the graphs hold;
 27. the counted and K2 routes on CUDA graphs (counted_phase): at 512^2
     and 2048^2 with PAIR_CAP patched just below the smallest search's
     n_pairs (K2 taken) and to the largest (K1 taken), encode_plane and
     encode_plane_quadtree: the first call eager, the capture, a replay on
     another plane, bitwise equal to the eager encode and (512^2) the
     CPU's, K1 and K2 launched by each counted search; at 4096^2
     encode_plane, encode_plane_quadtree, --vq-classes 4 and a 2 x 4096^2
     encode_batch_stacked, and at 8192^2 the default and --rms 10
     encode_plane and encode_plane_quadtree: the graph bitwise equal to the
     eager form, then both in turns (host ms, busy share, host syncs a call;
     medians of 5 at 4096^2, 3 at 8192^2), with the card memory after each
     capture and after graphs.clear(); the counted route's untaken kernel
     alone over its empty segments on the 4096^2 (K2) and 8192^2 (K1)
     preps; K2 ls16 on the 8192^2 prep with the width it picks on the
     device against the width its class counts give on the host (in turns,
     at most 1.05x).
 28. the decoder step's kernel (decode_step_phase; csrc/decode_step.cu)
     against the plain torch step at the decode cell's shapes, the
     pyramid's 1024^2 step (2 px ranges) and 2048^2 step (4 px ranges) on a
     2048^2 encode's maps: bitwise, then in turns beside the byte bound
     (the image read and written once, 16 B of maps a range, 3.35 TB/s).
Every path is driven with the launch counts set to 0 just before it and
read just after; each must launch the kernels it names, and each decode
on the card the decoder step's (csrc/decode_step.cu).  A graph's capture
launches nothing and counts nothing; each replay adds the launches its
capture recorded (utils.graphs), so a call counts alike on either form, and
phase 25 holds one replay's count against what torch.profiler saw run.  Each search
kernel's record keeps the times of its last parity check, which is at the
shape of a path that launches it, and its bound there: the larger of 2n
int8 operations per (range, column) pair the search needs (n the range's
pixel count, not the padded width) (the data's own
count with the frontier; the class layout's padding rows and columns are
not counted) over the H100 SXM's 1,979 TOP/s and the bytes of its ranges,
columns and results (``search_bytes``) over 3.35 TB/s.  K4's and K5's
records: the time of one repetition of the list (CUDA events, the median in
turns), the per-step µs from 4 repetitions and 1, and the bound of one
repetition (every range tile against every column tile once).
K2 `ls16`'s record times the 8192^2 default path's whole launch against its
bound; its plain time is the sample's (the plain version of the whole
plane would take minutes), kept with the sample's kernel time and bound as
sample_ms and sample_bound_ms.  With --dp4a DIR (a csrc/ directory holding
search_classed.cu, search_classed2d.cu, search_dense.cu and micro_step.cu
of an earlier design, e.g. `git archive 7d5a7d9 fractencode_tpu_torch/csrc`,
where micro_step.cu is still the dp4a design and the searches are this
mainloop, or 033dc3f's, where all four are the dp4a design), each kernel's
time is also taken in turns with DIR's build (this, DIR's, DIR's, this;
medians of 5; K4 and K5 at 1 and 4 repetitions), whose time goes into
dp4a_ms (K4/K5 also dp4a_step_us), and the two must agree bitwise.
No single PyTorch call gives a search's (q, idx), so library_ms is null;
K4 'matmul''s is torch._int_mm's int8 products of each range tile against
all columns with the row max, which writes the products out.  Plain timings
at 2048^2 are one run each, the parity run itself (which also counts the
pairs scanned), to keep the script short.
The planes are natural-like synthetic textures made with numpy from a seed
(the batch forms' frames each from its own seed).
K3's masked instances (the class mask) have records of their own, their
times at the sharded path that launches them (`ls16` masked, plain and
`_thr`, at the 2048^2 halo band).
The last two lines are the kernels' JSON record and the device JSON line.
Without a CUDA device it exits non-zero and prints no result.  Its files
go to build/smoke/ in the checkout, which it removes at the end.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import gzip
import io
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
           "micro_step": "fractencode_tpu_torch/csrc/micro_step.cu",
           "decode_step": "fractencode_tpu_torch/csrc/decode_step.cu"}
# the sources on the tensor-core mainloop (csrc/search_mma.cuh): phase 1
# counts their SASS instructions, and --dp4a times them against the build
# of the same source in DIR in turns; of these, the searches' SASS is also
# compared with DIR's
MMA_SOURCES = ("search_classed", "search_classed2d", "search_dense", "micro_step")
SEARCH_SOURCES = MMA_SOURCES[:3]
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
# phase 24's range sizes by instance width: (--source, --target, the plane
# size of the full-width path, a multiple of the range and of the domain
# step): the padded instances at n = 4, 36 and 100, the K-slab form at 1024
RANGE_GRIDS = {"16p": (8, 2, 2048), "64p": (12, 6, 2040), "256p": (20, 10, 2040),
               "_slab": (64, 32, 2048)}
# phase 24's keys, by the CLI flags that select them
RANGE_KEYS = {"ls": [], "raw": ["--compat"], "general": ["--smax", "0.9"]}
QT_WIDE = ["--quadtree", "--qt-min", "2", "--qt-max", "32"]


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
# phase 25's paths: every CLI config whose encode replays a CUDA graph
# (matcher.replays_graph), each with the kernel instance it launches
GRAPH_PATHS = {
    "default": ([], ("search_classed", "ls", 16, False)),
    "--compat": (["--compat"], ("search_classed", "raw", 16, False)),
    "--smax 0.9": (["--smax", "0.9"], ("search_classed", "general", 16, False)),
    "--rms 10": (RMS, ("search_classed", "ls", 16, True)),
    "--noclassifier": (["--noclassifier"], ("search_dense", "ls", 16, False)),
    "config 1": ([*CONFIG1, "--noclassifier"], ("search_dense", "ls", 64, False)),
    "2x2 ranges": (["--source", "8", "--target", "2"], ("search_classed", "ls", "16p", False)),
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
    name, template arguments (K, key, the geometry: padded or the K-slab
    form, for K3 the class mask, and the frontier; K4/K5: the variant and the
    [K, M] layout), registers and spills."""
    lines, name, spill = [], None, ("?", "?")
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if m:  # a (nested) mangled name: length-prefixed parts, then <K, M, ...>
            rest = m.group(1)
            while d := re.match(r"\d+", rest):
                end = d.end() + int(d.group())
                name, rest = rest[d.end():end], rest[end:]
            targs = re.findall(r"L(?:[ib]|N\w+?E)(\d+)E", rest)  # int, bool, enum
            if targs and name.startswith("decode_step"):
                ts, mean = targs[:2]
                name += (f" ts={'any' if ts == '0' else ts}"
                         + (" o_is_mean" if mean == "1" else ""))
            elif targs and name.startswith("micro_step"):
                variant, transposed = targs[:2]
                name += (f" {('full', 'noargpass', 'packed', 'matmul')[int(variant)]}"
                         + (" [K, M] layout" if transposed == "1" else ""))
            elif targs:  # the reduce kernels have none
                k, mode, geom, *flags = targs
                masked, frontier = (flags[:2] if name.startswith("search_dense")
                                    else ("0", *flags[:1]))
                name += (f" K={k} {('ls', 'raw', 'general')[int(mode)]}"
                         + ("", " padded", " K-slab")[int(geom)]
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


def sass(lib) -> str:
    """A built library's SASS (``cuobjdump -sass``, from the toolkit beside
    nvcc)."""
    from fractencode_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def sass_diff(lib, other) -> int:
    """The lines by which two libraries' SASS differ (each kernel's name, its
    instructions and their encodings; 0: identical).  The hashes that nvcc
    puts in an anonymous namespace's name, which follow the source's path,
    are left out."""
    import difflib

    def code(lib):
        return [re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}",
                       r"_GLOBAL__N__\1", line.strip())
                for line in sass(lib).splitlines()
                if re.match(r"\s*(Function :|/\*[0-9a-f]{4,}\*/|/\* 0x)", line)]

    a, b = code(lib), code(other)
    if a == b:
        return 0
    return sum(1 for line in difflib.unified_diff(a, b, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---")))


def sass_counts(lib) -> dict:
    """The tensor-core and dp4a instructions in a built library's SASS."""
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     sass(lib), re.M)
    heads = [op.split(".")[0] for op in ops]
    counts = {name: heads.count(name) for name in ("IMMA", "HMMA", "HGMMA", "IGMMA")}
    # dp4a is IDP.4A in Hopper's SASS
    counts["IDP4A"] = sum(op.startswith(("IDP.4A", "IDP4A")) for op in ops)
    counts.update({name: heads.count(name) for name in ("LDSM", "LDGSTS")})
    return counts


@contextlib.contextmanager
def dp4a_kernels(csrc):
    """Launches of MMA_SOURCES go to their build from ``csrc`` (the wrappers
    load their library by name on each launch)."""
    from fractencode_tpu_torch.ops import _build

    load = _build.load_library
    _build.load_library = lambda name: (load(name, csrc=csrc) if name in MMA_SOURCES
                                        else load(name))
    try:
        yield
    finally:
        _build.load_library = load


def turns(run, what, csrc, reps=5):
    """(the kernel's ms, the ms of its build from ``csrc``): medians of
    ``reps`` (CUDA events) in turns kernel, csrc's, csrc's, kernel, each the
    mean of its two; the (q, idx) of csrc's build must equal the kernel's
    bitwise.  A launch shorter than 4 ms gets medians of as many launches as
    take ~20 ms, up to 51 (sub-ms launches spread by ±25% over 5)."""
    probe, _ = cuda_ms(run, 1)
    reps = max(reps, min(51, int(20.0 / max(probe, 0.01))))
    new1, out = cuda_ms(run, reps)
    with dp4a_kernels(csrc):
        old1, old = cuda_ms(run, reps)
        old2, _ = cuda_ms(run, reps)
    new2, _ = cuda_ms(run, reps)
    check(bitwise(out[0], old[0]) and bitwise(out[1], old[1]),
          f"the --dp4a build differs from this one at {what}")
    return (new1 + new2) / 2, (old1 + old2) / 2


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
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges, range_sums

    n = img.shape[0]
    p = torch.from_numpy(img).cuda()
    pf = p.to(torch.float32)
    dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
    cb = build_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(pf, cfg.target_size)
    return (ranges, *range_sums(ranges), cb, classify_grid(p, rg), classify_grid(p, dg))


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


# K3's masked instances: the TPU kernel's class mask (`use_classes`), before
# its frontier
MASK_LINE = 215


def record_key(kernel: str, key: tuple) -> tuple:
    """A wrapper's launch key as a record's: (kernel, mode, K, frontier), and
    "masked" after K3's masked instances (K3 counts by (mode, K, frontier,
    masked))."""
    if kernel == "search_dense":
        return (kernel, *key[:3]) + (("masked",) if key[3] else ())
    return (kernel, *key)


def replaced_line(kernel: str, mode: str, width, thr: bool) -> int:
    """The line of the TPU kernel's branch an instance replaces: its frontier
    for `_thr`, its f32 branch for n > 64 (K = 256, padded to 256, the
    K-slab form), else its int8 branch ('ls' at K = 16 and 64: ls_fast)."""
    lines = _LINES[kernel]
    k = int(str(width).rstrip("p")) if width != "_slab" else None
    if thr:
        return lines["thr"]
    if k is None or k == 256:
        return lines["f32"]
    return lines[f"ls{k}"] if mode == "ls" else lines[mode]


def width_of(c):
    """The instance width config c searches with (matcher_kernels.WIDTHS):
    n itself at n = 16, 64, 256, else the padded width or the K-slab form."""
    from fractencode_tpu_torch.ops import matcher_kernels as mk

    n = c.target_size ** 2
    return mk.instance_width(n, mk.kernel_width(n))


class Kernels:
    """The kernels' records and launch counts, by (kernel, mode, width,
    frontier) for the searches (width: K, or the padded and K-slab tags of
    matcher_kernels.WIDTHS), with "masked" after K3's masked instances,
    ("micro_step", variant) for K4 and K5, and ("decode_step",) for the
    decoder step (every range size and o_is_mean together)."""

    def __init__(self, dp4a=None):
        from fractencode_tpu_torch.ops import decode_kernels as dk
        from fractencode_tpu_torch.ops import matcher_kernels as mk
        from fractencode_tpu_torch.ops import micro_kernels as mt

        # a csrc/ directory with earlier designs of MMA_SOURCES, timed in
        # turns; None: not timed
        self.dp4a = dp4a
        self.wrappers = {"search_classed": mk.search_classed_cuda,
                         "search_classed2d": mk.search_classed2d_cuda,
                         "search_dense": mk.search_dense_cuda}
        self.micro = mt.micro_step_cuda
        self.decoder = dk.decode_step_cuda
        self.records = {}
        for kernel in self.wrappers:
            for mode, ks in mk.KERNEL_KEYS.items():
                for k in ks:
                    for thr in (False, True):
                        line = replaced_line(kernel, mode, k, thr)
                        for masked in ((False, True) if kernel == "search_dense"
                                       else (False,)):
                            name = (f"{kernel}_{mode}{k}" + ("_masked" if masked else "")
                                    + ("_thr" if thr else ""))
                            self.records[(kernel, mode, k, thr) + (("masked",) if masked
                                                                  else ())] = dict(
                                name=name, route="cuda", source=SOURCES[kernel],
                                replaces="fractencode_tpu/ops/matcher_pallas.py:"
                                         f"{MASK_LINE if masked else line}",
                                launches=0, max_abs_err=0.0, library_ms=None,
                                launches_by_path={})
        for variant in mt.VARIANTS:  # K5 is 'full_t'; K4 the other four
            self.records[("micro_step", variant)] = dict(
                name="micro_t_full" if variant == "full_t" else f"micro_{variant}",
                route="cuda", source=SOURCES["micro_step"],
                replaces=f"scripts/micro_kernel.py:{208 if variant == 'full_t' else 96}",
                launches=0, max_abs_err=0.0, library_ms=None, launches_by_path={})
        # the decoder step, which replaces no TPU kernel
        self.records[("decode_step",)] = dict(
            name="decode_step", route="cuda", source=SOURCES["decode_step"],
            replaces="none (fractencode_tpu/decode/decoder.py:_decode_step, XLA-lowered)",
            launches=0, max_abs_err=0.0, library_ms=None, launches_by_path={})

    def zero(self):
        for w in (*self.wrappers.values(), self.micro, self.decoder):
            for key in w.launches:
                w.launches[key] = 0

    def read(self, path, expect):
        """Add the counts since ``zero`` to the records under ``path``;
        every key in ``expect`` must have launched."""
        counts = {record_key(kernel, key): n for kernel, w in self.wrappers.items()
                  for key, n in w.launches.items()}
        counts.update({("micro_step", v): n for v, n in self.micro.launches.items()})
        counts[("decode_step",)] = sum(self.decoder.launches.values())
        for key in expect:
            check(counts[key] > 0, f"the {path} path launched no {self.records[key]['name']}")
        for key, n in counts.items():
            if n:
                self.records[key]["launches"] += n
                self.records[key]["launches_by_path"][path] = n
        return {self.records[key]["name"]: n for key, n in counts.items() if n}

    def parity(self, key, run, plain, what, nbytes, plain_reps=5, real=None, n=None):
        """Kernel ``run()`` against plain ``plain(scanned)``: (q, idx)
        bitwise; both times, and the bound from ``nbytes`` and the pairs the
        plain version counts in ``scanned`` for the rows ``real`` (the rows
        that hold a range; all rows when None), at 2n operations a pair (n:
        the range's pixels; the K of a fixed instance by default), go into
        the record of ``key``.  Only a fixed instance (an int K) is timed
        against the --dp4a build: the earlier builds have no other.  Returns
        the kernel's (q, idx) and the pairs."""
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
        earlier = None
        if self.dp4a and key[0] in MMA_SOURCES and isinstance(key[2], int):
            ms, earlier = turns(run, what, self.dp4a)
        if plain_reps > 1:
            plain_ms, _ = cuda_ms(plain, reps=plain_reps)
        pairs = int((scanned if real is None else scanned[real]).sum())
        bound_ms, bound_by = bound(pairs, key[2] if n is None else n, nbytes)
        print(f"    {name} at {what}: {q_k.shape[0]} rows, (q, idx) bitwise equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + ("" if plain_reps > 1 else " (one run)")
              + ("" if earlier is None else f", --dp4a build {earlier:.4f} ms in turns")
              + f"; {pairs} pairs, bound {bound_ms:.4f} ms ({bound_by})")
        rec = self.records[key]
        rec.update(max_abs_err=max(rec["max_abs_err"], err), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if earlier is not None:
            rec["dp4a_ms"] = earlier
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
    just before and read just after; besides ``expect`` its decode must
    launch the decoder step's kernel; (result, pixels, counts)."""
    from fractencode_tpu_torch import cli

    args, cfg, dcfg = parse(["--device", "cuda", *argv])
    kernels.zero()
    res, out = cli._encode_one(img, args, cfg, dcfg, label=f" [{label}]")
    return res, out, kernels.read(path, [*expect, ("decode_step",)])


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


def encode_stages(img, cfg, reps=5):
    """The default encode of ``img`` on the card in encode_plane's stages:
    inputs (2x2 sums, codebook, ranges and their sums, integral image,
    classes), prep (matcher.classed_prep), search (matcher.classed_kernel:
    K1 on its route) and post (matcher.classed_post).  Each stage runs alone,
    ended by a synchronize: (device ms by CUDA events, host-clock ms) per
    stage, medians of ``reps`` warm runs after one warmup; and the search
    result, which must equal encode_plane's."""
    import torch

    from fractencode_tpu_torch.core.classify import classify_grid
    from fractencode_tpu_torch.core.grid import uniform_grid
    from fractencode_tpu_torch.core.stats import block_sums_nonoverlapping, integral_image
    from fractencode_tpu_torch.encode import matcher as tm
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges

    plane = torch.from_numpy(img).cuda()
    n = plane.shape[0]
    k, area = cfg.target_size ** 2, cfg.source_size ** 2

    def inputs(_):
        pf = plane.to(torch.float32)
        dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
        rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
        sums2x2 = block_sums_nonoverlapping(plane, 2)
        cb = build_codebook(pf, dg, cfg.target_size, cfg.num_transforms,
                            half=sums2x2.to(torch.float32) * 0.25)
        ranges = extract_ranges(pf, cfg.target_size)
        ii = integral_image(plane)
        return (ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
                classify_grid(plane, rg, ii=ii, sums2x2=sums2x2),
                classify_grid(plane, dg, ii=ii, sums2x2=sums2x2))

    def post(x):
        (ranges, sa, sa2, cb, *_), prep, (q_s, idx_s) = x
        return tm.classed_post(q_s, idx_s, prep["rpos"], prep["inv_col"], ranges, sa, sa2,
                               cb, cfg, b4_cols=prep["b4_cols"], inv_dom=prep["inv_dom"])

    stages = {"inputs": inputs,
              "prep": lambda x: (x, tm.classed_prep(*x, cfg)),
              "search": lambda x: (*x, tm.classed_kernel(x[1], k, area, cfg)),
              "post": post}
    times = {name: [] for name in stages}
    for rep in range(reps + 1):
        out = None
        for name, stage in stages.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = stage(out)
            end.record()
            torch.cuda.synchronize()
            if rep:
                times[name].append((start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)))
    return {name: tuple(statistics.median(t[i] for t in ts) for i in range(2))
            for name, ts in times.items()}, out


def device_busy(fn, reps=3):
    """(share of the host-clock window in which the card ran kernels, the
    window's ms) over ``reps`` warm runs of fn(), each ending in a
    synchronize, by torch.profiler's device times; None where the profiler
    saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return (busy_us / wall_us if busy_us > 0 else None), wall_us / 1e3 / reps


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


def in_turns(runs, rounds=7):
    """{key: ms}: the median over ``rounds`` of one timed run (CUDA events)
    of each of ``runs`` (key -> fn), taken in turns, forward then backward,
    after one warmup each."""
    for fn in runs.values():
        fn()
    samples = {key: [] for key in runs}
    order = list(runs)
    for r in range(rounds):
        for key in order if r % 2 == 0 else order[::-1]:
            samples[key].append(cuda_ms(runs[key], reps=1)[0])
    return {key: statistics.median(v) for key, v in samples.items()}


def decode_step_phase(kernels):
    """Phase 28: the decoder step's kernel (csrc/decode_step.cu) against the
    plain torch step at the decode cell's shapes, the pyramid's two steps of
    a 2048^2 frame on a real encode's maps: 1024^2 with 2 px ranges and
    2048^2 with 4 px ones.  Bitwise, then in turns (CUDA events, medians of
    7 rounds, each the replay of a CUDA graph of 20 steps each way, so that
    no host launch is timed), beside the byte bound: the u8 image read and
    written once and 16 B of maps a range over 3.35 TB/s."""
    import torch

    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.encode import encode_plane

    rec = kernels.records[("decode_step",)]
    res = encode_plane(natural_plane(2048, SEED + 28), device="cuda")
    s = torch.where(res.valid, res.s, 0.0)
    o = torch.where(res.valid, res.o, 0.0)
    reps = 20
    for f in (2, 1):
        n, ts = 2048 // f, res.target_size // f
        geo = (res.domain_idx, res.transform, n, n, res.source_size // f, ts,
               res.domain_step // f, res.num_transforms)
        cells, plain_tables = dec._step_tables(*geo), dec.build_decode_tables(*geo)
        img = torch.from_numpy(natural_plane(n, SEED + 28 + f)).cuda()
        kernel = lambda: dec._decode_step(img, cells, s, o, n, n, ts)  # noqa: E731
        plain = lambda: dec._decode_step_torch(img, plain_tables, s, o, n, n, ts)  # noqa: E731
        kernels.zero()
        check(bitwise(kernel(), plain()), f"the decode step's kernel differs at {n}^2")
        counts = kernels.read(f"decode_step_phase {n}^2", [("decode_step",)])
        check(counts == {"decode_step": 1}, f"the step at {n}^2 launched {counts}")
        runs = {}
        for name, fn in (("kernel", kernel), ("plain", plain)):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    fn()
            runs[name] = graph.replay
        ms = in_turns(runs)
        nbytes = 2 * n * n + 16 * s.numel()
        bound_ms = nbytes / 3.35e12 * 1e3
        print(f"    decode_step at {n}^2, {ts} px ranges: kernel {ms['kernel'] / reps:.4f} ms, "
              f"plain {ms['plain'] / reps:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes} bytes); bitwise equal, one launch")
        key = "half" if f == 2 else "full"
        rec.update({f"{key}_ms": ms["kernel"] / reps, f"{key}_plain_ms": ms["plain"] / reps,
                    f"{key}_bound_ms": bound_ms})
    rec.update(ms=rec["full_ms"], plain_ms=rec["full_plain_ms"], bound_ms=rec["full_bound_ms"],
               bound_by="bytes")


def micro_phase(kernels):
    """Phase 19: K4's four instances and K5's against their plain version at
    the JAX script's shapes and on ties; their times in turns and the split
    of K1's step they give (with --dp4a each also in turns with its --dp4a
    build); then the microbenchmark's main."""
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
    steps = mkb.NI * mkb.NJ * 3  # between 4 repetitions of the list and 1
    runs = {(v, reps): (lambda v=v, reps=reps: micro(mt.micro_step_cuda, ins, v, *lists[reps]))
            for v in mt.VARIANTS for reps in lists}
    out = {}
    for variant in mt.VARIANTS:
        key = ("micro_step", variant)
        rec = kernels.records[key]
        for reps, (words, n) in lists.items():
            q_k, i_k = runs[variant, reps]()
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
        rec["plain_ms"], _ = cuda_ms(
            lambda: micro(mt.micro_step_torch, ins, variant, *lists[1]))
    check(bitwise(out["full_t", 1][0], out["full", 1][0])
          and bitwise(out["full_t", 1][1], out["full", 1][1]), "K5 differs from K4 'full'")
    print("    every instance: (q, idx) bitwise equal to plain at 1 and 4 repetitions and on "
          "the ties, 4 repetitions == 1; K5 == K4 'full'")

    ms = in_turns(runs)
    us = {v: (ms[v, 4] - ms[v, 1]) / steps * 1e3 for v in mt.VARIANTS}
    for variant in mt.VARIANTS:
        rec = kernels.records[("micro_step", variant)]
        rec.update(ms=ms[variant, 1], bound_ms=bound_ms, bound_by=bound_by,
                   step_us=us[variant], step_bound_us=bound_ms / (mkb.NI * mkb.NJ) * 1e3)
        line = (f"    {rec['name']}: kernel {ms[variant, 1]:.4f} ms a repetition "
                f"({mkb.NI * mkb.NJ} steps; 4 repetitions {ms[variant, 4]:.4f} ms), "
                f"{us[variant]:.4f} us a step (the five in turns, medians of 7), plain "
                f"{rec['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
                f"{rec['step_bound_us']:.4f} us a step")
        if kernels.dp4a:
            new1, old1 = turns(runs[variant, 1], f"{rec['name']}, 1 repetition", kernels.dp4a)
            new4, old4 = turns(runs[variant, 4], f"{rec['name']}, 4 repetitions", kernels.dp4a)
            rec.update(dp4a_ms=old1, dp4a_step_us=(old4 - old1) / steps * 1e3)
            line += (f"; against the --dp4a build in turns: {new1:.4f} vs {old1:.4f} ms a "
                     f"repetition, {(new4 - new1) / steps * 1e3:.4f} vs "
                     f"{rec['dp4a_step_us']:.4f} us a step, (q, idx) bitwise equal")
        print(line)
    split = {"products": us["matmul"], "key": us["noargpass"] - us["matmul"],
             "argmax": us["full"] - us["noargpass"],
             "one-pass argmax": us["packed"] - us["noargpass"],
             "transposed staging": us["full_t"] - us["full"]}
    kernels.records[("micro_step", "full")]["split_us"] = split
    print("    K1's step split by K4's variants on the mainloop (us a step, share of 'full'): "
          + "; ".join(f"{part} {v:.4f} ({v / us['full']:.1%})" for part, v in split.items())
          + " (products: 'matmul'; key: 'noargpass' - 'matmul'; argmax: 'full' - "
          "'noargpass'; one-pass argmax: 'packed' - 'noargpass'; transposed staging: K5 - "
          "'full')")

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


def host_syncs(fn):
    """(fn()'s result, Counter of the host syncs it made by file:line), as
    torch's sync debug mode reports them (each a warning from the Python
    line whose op waited for the card)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    def site(w):
        path = w.filename
        path = (os.path.relpath(path, ROOT) if path.startswith(ROOT)
                else path.split("site-packages/")[-1])
        return f"{path}:{w.lineno}"

    # the mode's own warning on being switched on ("Synchronization debug
    # mode is a prototype feature ...") is no sync
    sites = collections.Counter(site(w) for w in caught
                                if "synchroniz" in str(w.message)
                                and "prototype" not in str(w.message))
    return out, sites


def k1_launches(counts):
    """K1's launches in a ``Kernels.read`` result, by instance name."""
    return {name: n for name, n in counts.items() if name.startswith("search_classed_")}


def batch_form(name, fn, frames):
    """One batch form on the card: host ms per frame (median of 3 warm runs
    ending in a synchronize), the card's busy share under torch.profiler
    over one warm run (the profiler's own processing of a run's events
    takes seconds), and the host syncs per frame with their sites; prints
    them."""
    import torch

    def run():
        out = fn()
        torch.cuda.synchronize()
        return out

    ms, _ = host_ms(run)
    busy, window = device_busy(run, reps=1)
    _, sites = host_syncs(fn)
    per = sum(sites.values()) / frames
    print(f"     {name}: {ms / frames:.3f} host ms a frame ({ms:.3f} ms for {frames}); card "
          + ("busy not measured (the profiler saw no device time)" if busy is None
             else f"busy {busy:.4f} of a {window:.3f} ms run")
          + f"; {per:g} host syncs a frame: "
          + ", ".join(f"{site} x{n / frames:g}" for site, n in sites.most_common()))
    return sum(sites.values())


def batch_phase(kernels, cfg, dcfg):
    """Phase 20: the batch forms at BENCH_r05's batch shapes on distinct
    natural-like frames: every frame bitwise equal to the single-plane
    function on the card, two encoded frames to the CPU's, K1's launches B
    times the single frames', and each form's host cost a frame."""
    import torch

    from fractencode_tpu_torch import (decode_batch_stacked, decode_plane,
                                       encode_batch_stacked, encode_plane)
    from fractencode_tpu_torch.encode.quadtree import (QuadtreeConfig,
                                                       encode_batch_quadtree_stacked,
                                                       encode_plane_quadtree)
    from fractencode_tpu_torch.utils import graphs

    k1 = ("search_classed", "ls", 16, False)
    frames = np.stack([natural_plane(512, SEED + 1000 + i) for i in range(16)])
    kernels.zero()
    singles = [encode_plane(p, cfg, device="cuda") for p in frames]
    single = k1_launches(kernels.read("batch16 single frames", [k1]))
    kernels.zero()
    stacked = encode_batch_stacked(frames, cfg, device="cuda")
    batch = k1_launches(kernels.read("batch16 encode_batch_stacked", [k1]))
    check(batch == single and batch[kernels.records[k1]["name"]] == 16,
          f"encode_batch_stacked launched K1 {batch}, 16 single frames {single}")
    fields = ("domain_idx", "transform", "s", "o", "distance", "valid")
    for i, res in enumerate(singles):
        for f in fields:
            check(bitwise(getattr(stacked, f)[i], getattr(res, f)),
                  f"encode_batch_stacked frame {i} {f} differs from encode_plane")
    for i in (0, 15):
        cpu = encode_plane(frames[i], cfg, device="cpu")
        for f in fields:
            check(bitwise(getattr(stacked, f)[i], getattr(cpu, f)),
                  f"encode_batch_stacked frame {i} {f}: card differs from CPU")
    kernels.zero()
    outs, iters, mses = decode_batch_stacked(stacked, dcfg)
    kernels.read("batch16 decode_batch_stacked", [("decode_step",)])
    kernels.zero()
    for i, res in enumerate(singles):
        out, it, mse = decode_plane(res, dcfg)
        check(bitwise(outs[i], out) and (int(iters[i]), float(mses[i])) == (it, mse),
              f"decode_batch_stacked frame {i} differs from decode_plane")
    kernels.read("batch16 decode_plane", [("decode_step",)])
    print("     16 x 512^2 encode_batch_stacked and decode_batch_stacked: every frame "
          "bitwise equal to encode_plane and decode_plane (pixels, iterations, MSE) on "
          f"the card, frames 0 and 15 to the CPU's encode; K1 launches {batch} = 16 x 1")
    del singles

    qcfg = QuadtreeConfig()
    qframes = np.stack([natural_plane(1024, SEED + 2000 + i) for i in range(8)])
    kernels.zero()
    qsingles = [encode_plane_quadtree(p, cfg, qcfg, device="cuda") for p in qframes]
    qsingle = k1_launches(kernels.read("batch8 quadtree single frames", []))
    kernels.zero()
    qstacked = encode_batch_quadtree_stacked(qframes, cfg, qcfg, device="cuda")
    qbatch = k1_launches(kernels.read("batch8 encode_batch_quadtree_stacked", [k1]))
    check(qbatch == qsingle, f"encode_batch_quadtree_stacked launched K1 {qbatch}, "
                             f"8 single frames {qsingle}")
    for i, res in enumerate(qsingles):
        for ls, l1 in zip(qstacked.levels, res.levels, strict=True):
            for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
                check(bitwise(getattr(ls, f)[i], getattr(l1, f)),
                      f"encode_batch_quadtree_stacked frame {i} {l1.range_size} px {f} "
                      "differs from encode_plane_quadtree")
    print("     8 x 1024^2 encode_batch_quadtree_stacked: every level of every frame "
          f"bitwise equal to encode_plane_quadtree on the card; K1 launches {qbatch}, "
          "the 8 single frames' sum")
    del qsingles

    print("     per form (host clock; busy share by torch.profiler; host syncs by "
          "torch.cuda.set_sync_debug_mode, by port line):")
    for name, fn in (("encode_batch_stacked 16 x 512^2",
                      lambda: encode_batch_stacked(frames, cfg, device="cuda")),
                     ("decode_batch_stacked 16 x 512^2 (pyramid)",
                      lambda: decode_batch_stacked(stacked, dcfg))):
        # on their CUDA graphs (phase 25): every frame of a warm call
        # replays, and a call syncs once at most (the frames' upload, or the
        # MSEs' read)
        form = "encode_plane" if name.startswith("encode") else "decode_plane"
        before = graphs.calls[form, "replay"]
        syncs = batch_form(name, fn, 16)
        check(syncs <= 1, f"{name}: {syncs} host syncs in a call, above one")
        check(graphs.calls[form, "replay"] - before >= 16 * 3,
              f"{name}: its frames did not replay the graph")
    batch_form("encode_batch_quadtree_stacked 8 x 1024^2",
               lambda: encode_batch_quadtree_stacked(qframes, cfg, qcfg, device="cuda"), 8)


def host_turns(runs, rounds=7):
    """{key: host-clock ms}: the median over ``rounds`` of one run of each of
    ``runs`` (key -> fn, each ending in a synchronize), taken in turns,
    forward then backward, after one warmup each."""
    for fn in runs.values():
        fn()
    samples = {key: [] for key in runs}
    order = list(runs)
    for r in range(rounds):
        for key in order if r % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            runs[key]()
            samples[key].append(1e3 * (time.perf_counter() - t0))
    return {key: statistics.median(v) for key, v in samples.items()}


def search_launches():
    """The search wrappers' launch counts (K1, K2, K3), summed."""
    from fractencode_tpu_torch.ops import matcher_kernels as mk

    return sum(sum(f.launches.values()) for f in (
        mk.search_classed_cuda, mk.search_classed2d_cuda, mk.search_dense_cuda))


def search_kernels_run(fn):
    """(fn()'s result, Counter of the search kernels (K1, K2, K3) the card
    ran in it, by name, as torch.profiler saw them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ran = collections.Counter()
    for e in prof.key_averages():
        if re.search(r"::search_\w+_kernel<", e.key):
            ran[e.key] += e.count
    return out, ran


def kernel_template(key):
    """The kernel template instance a GRAPH_PATHS key launches, as the
    profiler names it (csrc/search_classed.cu, search_dense.cu)."""
    kernel, mode, k, thr = key
    args = [str(k).rstrip("p"), str(("ls", "raw", "general").index(mode)),
            "1" if str(k).endswith("p") else "0"]  # fe::Mode, fe::Geom
    if kernel == "search_dense":
        args.append("false")  # no class mask
    args.append("true" if thr else "false")
    return f"{kernel}_kernel<{', '.join(args)}>"


def timed_forms(name, frames_n, make, graph_syncs=1, rounds=7, busy_forms=("eager", "graph")):
    """One form's eager and graph runs in turns (``make(graph)`` gives each,
    a function of no arguments; medians of ``rounds``): host ms a frame,
    busy share (of the forms in ``busy_forms``: the profiler takes tens of
    seconds over an eager call of tens of thousands of ops), host syncs a
    frame with their lines; prints them and returns {form: (host ms a
    frame, busy share, host syncs a call)}.  The graph form syncs
    ``graph_syncs`` times a call at most."""
    import torch

    runs = {form: make(form == "graph") for form in ("eager", "graph")}
    synced = {}
    for form, fn in runs.items():
        def run(fn=fn):
            out = fn()
            torch.cuda.synchronize()
            return out
        synced[form] = run
        run()  # a graph's first call of a key is eager; host_turns' warmup captures
    ms = host_turns(synced, rounds)
    line = [f"     {name}:"]
    out = {}
    for form, fn in runs.items():
        busy = device_busy(synced[form], reps=1)[0] if form in busy_forms else None
        _, sites = host_syncs(fn)
        per = sum(sites.values()) / frames_n
        out[form] = (ms[form] / frames_n, busy, sum(sites.values()))
        line.append(f"{form} {ms[form] / frames_n:.3f} host ms a frame, busy "
                    + ("not measured" if busy is None else f"{busy:.4f}")
                    + f", {per:g} host syncs a frame ("
                    + (", ".join(f"{site} x{k / frames_n:g}"
                                 for site, k in sites.most_common()) or "none") + ");")
    print(" ".join(line))
    check(out["graph"][2] <= graph_syncs, f"{name}: the graph form synced "
                                          f"{out['graph'][2]} times in a call, above "
                                          f"{graph_syncs}")
    return out



def graph_phase(kernels):
    """Phase 25: the main path on its CUDA graphs (utils.graphs).  Every
    path of GRAPH_PATHS at 512^2, and the default at 2048^2: the predicate
    takes it; encode_plane's first call (eager), its second (the capture
    and a replay) and a third replay (on another plane, which must leave the
    earlier result unchanged) equal the eager encode and, at 512^2, the
    CPU's, bitwise, with one launch of the path's kernel per call, and
    torch.profiler sees the third call run that one kernel instance; then
    the CLI's pyramid decode of the result, its eager call and its capture
    and replay equal to the eager decode and the CPU's.  Then the eager and graph forms in turns (host clock,
    medians of 7) of the 16 x 512^2 encode_batch_stacked and
    decode_batch_stacked and the 2048^2 encode_plane, each with the card's
    busy share (torch.profiler) and its host syncs by line, and the card
    memory the graphs and tables hold."""
    import torch

    from fractencode_tpu_torch import decode_plane, encode_plane
    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.encode import encoder as enc
    from fractencode_tpu_torch.utils import graphs, tables

    fields = ("domain_idx", "transform", "s", "o", "distance", "valid")
    pyramid = parse(["--device", "cuda"])[2]  # the CLI's pyramid decode

    def same(a, b):
        return all(bitwise(getattr(a, f), getattr(b, f)) for f in fields)

    cases = [(name, argv, key, 512) for name, (argv, key) in GRAPH_PATHS.items()]
    for name, argv, key, n in cases + [("default", [], GRAPH_PATHS["default"][1], 2048)]:
        _, cfg, _ = parse(["--device", "cuda", *argv])
        img, other = natural_plane(n, SEED + 2500), natural_plane(n, SEED + 2501)
        check(enc._replays(n, n, cfg, torch.device("cuda")),
              f"{name} at {n}^2: the predicate refuses the graph")
        eager = [enc._result(enc._encode_arrays(torch.from_numpy(p).cuda(), cfg), n, n, cfg)
                 for p in (img, other)]
        graphs.clear()
        before = collections.Counter(graphs.calls)
        kernels.zero()
        first = encode_plane(img, cfg, device="cuda")
        second = encode_plane(img, cfg, device="cuda")
        kept = dataclasses.replace(second, **{f: getattr(second, f).clone() for f in fields})
        added = search_launches()
        third, ran = search_kernels_run(lambda: encode_plane(other, cfg, device="cuda"))
        added = search_launches() - added
        counts = kernels.read(f"graph {name} {n}^2", [key])
        form = {f: graphs.calls["encode_plane", f] - before["encode_plane", f]
                for f in ("eager", "capture", "replay")}
        check(form == {"eager": 1, "capture": 1, "replay": 2},
              f"{name} at {n}^2: encode_plane took {form}, not an eager call, a capture "
              "and 2 replays")
        check(counts == {kernels.records[key]["name"]: 3},
              f"{name} at {n}^2: launches {counts}, not one a call")
        # the replay's count is the capture's; the profiler sees what ran
        check(sum(ran.values()) == added == 1
              and all(kernel_template(key) in k for k in ran),
              f"{name} at {n}^2: a replay counted {added} launches, the profiler saw "
              f"{dict(ran)}, not one {kernel_template(key)}")
        check(same(first, eager[0]) and same(second, eager[0]) and same(third, eager[1]),
              f"{name} at {n}^2: the graph's encode differs from the eager one")
        check(same(second, kept), f"{name} at {n}^2: a later call changed an earlier result")
        cpu = encode_plane(img, cfg, device="cpu") if n == 512 else None
        check(cpu is None or same(second, cpu), f"{name} at {n}^2: card differs from CPU")
        kernels.zero()
        d_eager = dec._decode_core(second, pyramid)
        d_graph = [decode_plane(second, pyramid) for _ in range(2)]
        kernels.read(f"graph {name} {n}^2 pyramid decode", [("decode_step",)])
        d_cpu = [decode_plane(cpu, pyramid)] if cpu is not None else []
        for out, it, mse in d_graph + d_cpu:
            check(bitwise(out, d_eager[0]) and (it, mse) == d_eager[1:],
                  f"{name} at {n}^2: the pyramid decode differs from the eager one")
        dform = {f: graphs.calls["decode_plane", f] - before["decode_plane", f]
                 for f in ("eager", "capture", "replay")}
        check(dform == {"eager": 1, "capture": 1, "replay": 1},
              f"{name} at {n}^2: decode_plane took {dform}, not an eager call, a capture "
              "and a replay")
        print(f"     {name} at {n}^2: form graph (1 eager call, then 1 capture, 2 replays); "
              "encode == eager" + (" == CPU" if cpu is not None else "")
              + f" bitwise, launches {counts}; the profiler saw the last replay run "
              f"{dict(ran)}; pyramid decode graph (1 eager call, then 1 capture, 1 replay) "
              "== eager"
              + (" == CPU" if cpu is not None else "")
              + f" ({d_eager[1]} steps, mse {d_eager[2]:.6g})")
    graphs.clear()

    cfg = parse(["--device", "cuda"])[1]
    frames = np.stack([natural_plane(512, SEED + 1000 + i) for i in range(16)])  # phase 20's
    stacked = enc.encode_batch_stacked(frames, cfg, device="cuda")
    big = natural_plane(2048, SEED + 2048)

    print("     eager and graph forms in turns (host clock, medians of 7; busy share by "
          "torch.profiler; host syncs by torch.cuda.set_sync_debug_mode):")
    timed_forms("encode_batch_stacked 16 x 512^2", 16, lambda graph: lambda: enc._encode_batch(
        enc.plane_on_device(frames, "cuda"), cfg, graph))
    timed_forms("decode_batch_stacked 16 x 512^2 (pyramid)", 16,
                lambda graph: lambda: dec._decode_batch(stacked, pyramid, graph))
    timed_forms("encode_plane 2048^2", 1, lambda graph: (
        lambda: encode_plane(big, cfg, device="cuda")) if graph else (
        lambda: enc._encode_arrays(enc.plane_on_device(big, "cuda"), cfg)))
    check(enc._replays(2048, 2048, cfg, torch.device("cuda")), "2048^2 takes no graph")
    held = (f"{len(graphs._GRAPHS)} graphs and {len(tables._TABLES)} tables "
            f"({sum(t.nbytes for t in tables._TABLES.values())} bytes) kept: card memory "
            f"allocated {torch.cuda.memory_allocated()}, reserved "
            f"{torch.cuda.memory_reserved()} bytes")
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"     after the timings, {held}; after graphs.clear() (graphs, their pools and "
          f"the tables): allocated {torch.cuda.memory_allocated()}, reserved "
          f"{torch.cuda.memory_reserved()} bytes")


# phase 26's quadtree paths: each CLI config whose pyramid replays one CUDA
# graph (quadtree._replays), at 512^2 and 2048^2 ("--qt-min 2" at 512^2)
QT_GRAPH_PATHS = {"default": [], "--noclassifier": ["--noclassifier"],
                  "--compat": ["--compat"], "--smax 0.9": ["--smax", "0.9"],
                  "--rms 10": ["--rms", "10"], "--qt-min 2": ["--qt-min", "2"]}


def qt_config(argv):
    """(EncoderConfig, QuadtreeConfig, DecoderConfig) the CLI parses from
    ``--quadtree`` and ``argv``."""
    from fractencode_tpu_torch.encode.quadtree import QuadtreeConfig

    args, cfg, dcfg = parse(["--device", "cuda", "--quadtree", *argv])
    return cfg, QuadtreeConfig(min_size=args.qt_min, max_size=args.qt_max,
                               error_threshold=args.qt_threshold), dcfg


def launch_keys(kernels):
    """The search wrappers' launches since ``kernels.zero``, by record key."""
    return collections.Counter({record_key(kernel, key): n
                                for kernel, w in kernels.wrappers.items()
                                for key, n in w.launches.items() if n})


@contextlib.contextmanager
def prep_routes(routes):
    """Append (route, take_k2, n_pairs) of each classed_prep made inside
    to ``routes`` (the last two read back; None off the counted route).
    Eager calls only: a read would break a capture."""
    from fractencode_tpu_torch.encode import matcher as tm

    prep = tm.classed_prep

    def spy(*args, **kwargs):
        out = prep(*args, **kwargs)
        counted = out["route"] == "counted"
        routes.append((out["route"], bool(out["take_k2"]) if counted else None,
                       int(out["n_pairs"]) if counted else None))
        return out

    tm.classed_prep = spy
    try:
        yield routes
    finally:
        tm.classed_prep = prep


def level_arrays(res):
    """A QuadtreeResult's level arrays, coarse to fine, as one list."""
    from fractencode_tpu_torch.encode.quadtree import LEVEL_ARRAY_FIELDS

    return [getattr(l, f) for l in res.levels for f in LEVEL_ARRAY_FIELDS]


def flat_exit(dcfg, it, mse, rerun):
    """Which of the flat loop's tests ended a decode of ``it`` iterations
    and final ``mse``: "epsilon", "max_iterations" (no test met), "cycle"
    or "stall" (``rerun(dcfg)`` decodes again: without the stall test, a
    decode that stalled runs on)."""
    if np.float32(mse) < np.float32(dcfg.epsilon):
        return "epsilon"
    if it == dcfg.max_iterations:
        return "max_iterations"
    if dcfg.stall_window == 0:
        return "cycle"
    return "stall" if rerun(dataclasses.replace(dcfg, stall_window=0))[1] > it else "cycle"


def quadtree_graphs(kernels):
    """Phase 26's quadtree part: each QT_GRAPH_PATHS config on its graph,
    three calls against the per-level eager encode, and its decodes."""
    import torch

    from fractencode_tpu_torch.encode import quadtree as tq
    from fractencode_tpu_torch.utils import graphs

    cuda = torch.device("cuda")
    flat_dcfg = parse(["--device", "cuda", "--compat"])[2]
    check(not flat_dcfg.pyramid, "--compat's decode is not the flat loop")
    for name, argv in QT_GRAPH_PATHS.items():
        for n in (512,) if name == "--qt-min 2" else (512, 2048):
            cfg, qcfg, dcfg = qt_config(argv)
            img, other = natural_plane(n, SEED + 2600), natural_plane(n, SEED + 2601)
            check(tq._replays(n, n, cfg, qcfg, cuda),
                  f"--quadtree {name} at {n}^2: the predicate refuses the graph")
            graphs.clear()
            kernels.zero()
            eager = [tq._quadtree_arrays(torch.from_numpy(img).cuda(), cfg, qcfg)]
            per_call = launch_keys(kernels)
            eager.append(tq._quadtree_arrays(torch.from_numpy(other).cuda(), cfg, qcfg))
            per_other = launch_keys(kernels) - per_call
            kernels.zero()
            before = collections.Counter(graphs.calls)
            first = tq.encode_plane_quadtree(img, cfg, qcfg, device="cuda")
            check(launch_keys(kernels) == per_call, f"--quadtree {name} at {n}^2: the "
                  f"first call launched {launch_keys(kernels)}, eager {per_call}")
            second = tq.encode_plane_quadtree(img, cfg, qcfg, device="cuda")
            kept = [x.clone() for x in level_arrays(second)]
            two = launch_keys(kernels)
            third, ran = search_kernels_run(
                lambda: tq.encode_plane_quadtree(other, cfg, qcfg, device="cuda"))
            added = launch_keys(kernels) - two
            counts = kernels.read(f"quadtree graph {name} {n}^2", list(per_call))
            form = {f: graphs.calls["encode_plane_quadtree", f]
                    - before["encode_plane_quadtree", f] for f in ("eager", "capture", "replay")}
            check(form == {"eager": 1, "capture": 1, "replay": 2},
                  f"--quadtree {name} at {n}^2: {form}, not an eager call, a capture and "
                  "2 replays")
            check(two == per_call + per_call and added == per_other,
                  f"--quadtree {name} at {n}^2: the calls launched {two}, then {added}; the "
                  f"eager encodes {per_call}, {per_other}")
            want = collections.Counter({kernel_template(k): c for k, c in added.items()})
            seen = collections.Counter()
            for key, c in ran.items():
                seen.update({t: c for t in want if t in key})
            check(seen == want and sum(ran.values()) == sum(added.values()),
                  f"--quadtree {name} at {n}^2: the profiler saw {dict(ran)} in the third "
                  f"call, which counted {dict(want)}")
            for res, arrays, what in ((first, eager[0], "first"), (second, eager[0], "second"),
                                      (third, eager[1], "third")):
                check(all(bitwise(a, b) for a, b in zip(level_arrays(res), arrays, strict=True)),
                      f"--quadtree {name} at {n}^2: the {what} call differs from the eager "
                      "encode")
            check(all(bitwise(a, b) for a, b in zip(level_arrays(second), kept)),
                  f"--quadtree {name} at {n}^2: a later call changed an earlier result")
            cpu = tq.encode_plane_quadtree(img, cfg, qcfg, device="cpu") if n == 512 else None
            check(cpu is None or all(bitwise(a, b) for a, b in zip(level_arrays(cpu), eager[0])),
                  f"--quadtree {name} at {n}^2: card differs from CPU")
            decodes = []
            for d in dict.fromkeys((dcfg, flat_dcfg)):
                kernels.zero()
                img_e, it_e, mse_e = tq._decode(second, d, graph=False)
                want_d = (int(it_e), float(mse_e))
                outs = [tq.decode_plane_quadtree(second, d) for _ in range(3)]
                outs += [tq.decode_plane_quadtree(cpu, d)] if cpu is not None else []
                for out, it, mse in outs:
                    check(bitwise(out, img_e) and (it, mse) == want_d,
                          f"--quadtree {name} at {n}^2: decode_plane_quadtree "
                          f"(pyramid={d.pyramid}) differs from its eager form")
                kernels.read(f"quadtree graph {name} {n}^2 decode pyramid={d.pyramid}",
                             [("decode_step",)])
                decodes.append(f"{'pyramid' if d.pyramid else 'flat'} {want_d[0]} steps, "
                               f"mse {want_d[1]:.6g}")
            print(f"     --quadtree {name} at {n}^2: graph (1 eager call, 1 capture, 2 "
                  "replays), every level == the per-level eager encode"
                  + (" == CPU" if cpu is not None else "")
                  + f" bitwise; launches {dict(counts)} in 3 calls, as eager; the profiler "
                  f"saw the third call run {dict(seen)}; decodes graph == eager"
                  + (" == CPU" if cpu is not None else "") + ": " + "; ".join(decodes))
    graphs.clear()


def flat_decodes():
    """Phase 26's flat loop: decode_plane (--compat) and decode_batch_stacked
    of phase 20's 16 x 512^2 frames on the graph, equal to the eager chunks,
    with the exit each decode took, and the golden Lenna crops' decodes
    whose exits are the cycle and the stall."""
    import torch

    from fractencode_tpu_torch import decode_plane, encode_batch_stacked, encode_plane
    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.image import load_gray
    from fractencode_tpu_torch.params import DecoderConfig

    frames = np.stack([natural_plane(512, SEED + 1000 + i) for i in range(16)])  # phase 20's
    exits = collections.Counter()
    for argv in (["--compat"], []):
        _, cfg, dcfg = parse(["--device", "cuda", *argv])
        dcfg = dataclasses.replace(dcfg, pyramid=False)
        stacked = encode_batch_stacked(frames, cfg, device="cuda")
        outs, iters, mses = dec._decode_batch(stacked, dcfg, graph=True)
        e_outs, e_iters, e_mses = dec._decode_batch(stacked, dcfg, graph=False)
        check(bitwise(outs, e_outs) and bitwise(iters, e_iters) and bitwise(mses, e_mses),
              f"{argv}: the flat decode_batch_stacked differs from its eager chunks")
        frame0 = dataclasses.replace(stacked, **{f: getattr(stacked, f)[0] for f in (
            "domain_idx", "transform", "s", "o", "distance", "valid")})
        one = decode_plane(frame0, dcfg)
        check(bitwise(one[0], outs[0]) and one[1:] == (int(iters[0]), float(mses[0])),
              f"{argv}: decode_plane of frame 0 differs from the batch's")
        for i in range(16):
            frame = dataclasses.replace(frame0, **{f: getattr(stacked, f)[i] for f in (
                "domain_idx", "transform", "s", "o", "valid")})
            exits[flat_exit(dcfg, int(iters[i]), float(mses[i]),
                            lambda d, frame=frame: decode_plane(frame, d))] += 1
        print(f"     16 x 512^2 {' '.join(argv) or 'default'} encode, flat decode "
              f"(stall window {dcfg.stall_window}): decode_batch_stacked graph == eager "
              f"chunks (pixels, iterations, MSE); iterations {iters.tolist()}")
    lenna = load_gray(os.path.join(GOLDEN, "lenna128_input.png"))
    cases = (("lenna 64^2 crop at (0, 0)", lenna[:64, :64], DecoderConfig(stall_window=0)),
             ("64^2 noise", np.random.default_rng(1).integers(0, 256, (64, 64), np.uint8),
              DecoderConfig()),
             ("lenna 64^2 crop at (32, 32)", lenna[32:96, 32:96], DecoderConfig(max_iterations=3)))
    for what, img, d in cases:
        res = encode_plane(img, parse(["--device", "cuda"])[1], device="cuda")
        out, it, mse = decode_plane(res, d)
        e_img, e_it, e_mse = dec._flat_decode(res, d, graph=False)
        cpu = decode_plane(res, d, device="cpu")
        check(bitwise(out, e_img) and bitwise(out, cpu[0]) and (it, mse) == cpu[1:]
              == (int(e_it), float(e_mse)), f"{what}: the flat decode's forms differ")
        exit_ = flat_exit(d, it, mse, lambda d2, res=res: decode_plane(res, d2))
        exits[exit_] += 1
        print(f"     {what}: flat decode graph == eager == CPU, {it} iterations, mse "
              f"{mse:.6g}, exit {exit_}")
    check(all(exits[e] for e in ("epsilon", "cycle", "stall", "max_iterations")),
          f"the flat decodes' exits {dict(exits)} miss a test")
    print(f"     exits of the flat decodes above: {dict(exits)}")
    return frames


def vq_graphs():
    """Phase 26's VQ part: --vq-classes 4 at 512^2 and 2048^2 on the graphs,
    labels, codebook, steps and winners against the eager stages and the
    CPU."""
    import torch

    from fractencode_tpu_torch import encode_plane
    from fractencode_tpu_torch.encode import encoder as enc, vq
    from fractencode_tpu_torch.utils import graphs
    from fractencode_tpu_torch.utils.prng import prng_key

    _, cfg, _ = parse(["--device", "cuda", "--vq-classes", "4"])
    for n in (512, 2048):
        img = natural_plane(n, SEED + n)  # the main planes'
        p = torch.from_numpy(img).cuda()
        check(enc._replays(n, n, cfg, torch.device("cuda")), f"VQ at {n}^2 takes no graph")
        start = enc._vq_start(p, cfg)
        cb_e, steps_e = vq._kmeans(*start, vq.MAX_STEPS, vq.EPSILON, graph=False)
        eager = enc._encode_arrays(p, cfg, cb_e)
        graphs.clear()
        before = collections.Counter(graphs.calls)
        results = [encode_plane(img, cfg, device="cuda") for _ in range(3)]
        form = {k: graphs.calls[k] - before[k] for k in graphs.calls if graphs.calls[k] - before[k]}
        for res in results:
            check(all(bitwise(getattr(res, f), x) for f, x in zip(enc.ARRAY_FIELDS, eager)),
                  f"VQ at {n}^2: the graph's encode differs from the eager stages")
        labels = {}
        for dev in ("cuda", "cpu"):
            pf = torch.from_numpy(img).to(dev)
            cb, ranges, *_ = enc._inputs(pf, cfg)
            dvec, _ = enc._vq_vectors(ranges, cb)
            book, dcls, steps = vq.train_codebook(dvec, prng_key(cfg.vq_seed), cfg.vq_classes,
                                                  sample_limit=enc._vq_limit(dvec.shape[0], cfg))
            labels[dev] = (book, enc._vq_labels(ranges, cb, book), steps)
        (b_g, (r_g, d_g), s_g), (b_c, (r_c, d_c), s_c) = labels["cuda"], labels["cpu"]
        check(s_g == s_c == int(steps_e) and bitwise(b_g, b_c) and bitwise(b_g, cb_e)
              and bitwise(r_g, r_c) and bitwise(d_g, d_c),
              f"VQ at {n}^2: codebook, labels or steps differ between the graph, the eager "
              "loop and the CPU")
        cpu = encode_plane(img, cfg, device="cpu") if n == 512 else None
        check(cpu is None or all(bitwise(getattr(cpu, f), x)
                                 for f, x in zip(enc.ARRAY_FIELDS, eager)),
              f"VQ at {n}^2: card differs from CPU")
        print(f"     --vq-classes 4 at {n}^2: {s_g} k-means steps; codebook, labels and "
              "steps graph == eager == CPU; winners of 3 encode_plane calls (graphs "
              f"{form}) == eager" + (" == CPU" if cpu is not None else "") + " bitwise")
    graphs.clear()


def loop_phase(kernels):
    """Phase 26: the JAX package's remaining device loops on CUDA graphs:
    the quadtree pyramid and its decodes (quadtree_graphs), the flat decode
    (flat_decodes), VQ's k-means (vq_graphs); then the eager and graph
    forms in turns, the chunk length's sweep, and the card memory the graphs
    hold."""
    import torch

    from fractencode_tpu_torch import decode_plane, encode_plane
    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.encode import encoder as enc, quadtree as tq, vq
    from fractencode_tpu_torch.utils import graphs, tables

    quadtree_graphs(kernels)
    flat_decodes()
    vq_graphs()

    big = natural_plane(2048, SEED + 2048)
    cfg, qcfg, pyr = qt_config([])
    qframes = np.stack([natural_plane(1024, SEED + 2000 + i) for i in range(8)])  # phase 20's
    qres = tq.encode_plane_quadtree(big, cfg, qcfg, device="cuda")
    _, ccfg, flat = parse(["--device", "cuda", "--compat"])
    res = enc.encode_plane(big, ccfg, device="cuda")
    kernels.zero()
    _, it, _ = decode_plane(res, flat)
    kernels.read("decode_plane 2048 --compat (flat)", [("decode_step",)])
    _, vcfg, _ = parse(["--device", "cuda", "--vq-classes", "4"])
    p_big = torch.from_numpy(big).cuda()
    _, vq_steps = vq._kmeans(*enc._vq_start(p_big, vcfg), vq.MAX_STEPS, vq.EPSILON, graph=False)
    vq_steps = int(vq_steps)

    def vq_eager():
        p = enc.plane_on_device(big, "cuda")
        book, _ = vq._kmeans(*enc._vq_start(p, vcfg), vq.MAX_STEPS, vq.EPSILON, graph=False)
        return enc._encode_arrays(p, vcfg, book)

    print("     eager and graph forms in turns (host clock, medians of 7; busy share by "
          "torch.profiler; host syncs by torch.cuda.set_sync_debug_mode; the flat loops "
          f"read their exit flag once a chunk of {dec._CHUNK} steps):")
    timed_forms("encode_batch_quadtree_stacked 8 x 1024^2", 8, lambda graph: lambda: (
        tq._encode_batch(enc.plane_on_device(qframes, "cuda"), cfg, qcfg, graph)))
    timed_forms("encode_plane_quadtree 2048^2", 1, lambda graph: (
        lambda: tq.encode_plane_quadtree(big, cfg, qcfg, device="cuda")) if graph else (
        lambda: tq._quadtree_arrays(enc.plane_on_device(big, "cuda"), cfg, qcfg)))
    timed_forms("decode_plane_quadtree 2048^2 (pyramid)", 1, lambda graph: (
        lambda: tq.decode_plane_quadtree(qres, pyr)) if graph else (
        lambda: float(tq._decode(qres, pyr, graph=False)[2])))
    steps = min(it + 1, flat.max_iterations)  # the exit step runs, uncounted
    timed_forms(f"decode_plane 2048^2 --compat (flat, {it} iterations)", 1, lambda graph: (
        lambda: decode_plane(res, flat)) if graph else (
        lambda: [float(x) for x in dec._flat_decode(res, flat, graph=False)[1:]]),
        graph_syncs=-(-steps // dec._CHUNK) + 2)
    timed_forms(f"encode_plane 2048^2 --vq-classes 4 ({vq_steps} k-means steps)", 1,
                lambda graph: (lambda: encode_plane(big, vcfg, device="cuda")) if graph
                else vq_eager, graph_syncs=-(-vq_steps // vq._CHUNK) + 1)

    def chunked(module, c, fn):
        def run():
            module._CHUNK = c
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    chunk = (dec._CHUNK, vq._CHUNK)
    try:
        ms = host_turns({c: chunked(dec, c, lambda: decode_plane(res, flat))
                         for c in (1, 4, 8, 16)}
                        | {"eager 1": chunked(dec, 1, lambda: float(
                            dec._flat_decode(res, flat, graph=False)[2]))})
        print(f"     chunk length, 2048^2 flat decode (host ms, in turns, medians of 7): "
              + ", ".join(f"{c} {t:.3f}" for c, t in ms.items()))
        ms = host_turns({c: chunked(vq, c, lambda: encode_plane(big, vcfg, device="cuda"))
                         for c in (1, 8, 32)})
        print(f"     chunk length, 2048^2 --vq-classes 4 encode: "
              + ", ".join(f"{c} {t:.3f}" for c, t in ms.items()))
    finally:
        dec._CHUNK, vq._CHUNK = chunk
    held = (f"{len(graphs._GRAPHS)} graphs and {len(tables._TABLES)} tables "
            f"({sum(t.nbytes for t in tables._TABLES.values())} bytes) kept: card memory "
            f"allocated {torch.cuda.memory_allocated()}, reserved "
            f"{torch.cuda.memory_reserved()} bytes")
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"     after the timings, {held}; after graphs.clear(): allocated "
          f"{torch.cuda.memory_allocated()}, reserved {torch.cuda.memory_reserved()} bytes")


def result_arrays(res):
    """An EncodeResult's arrays (encoder.ARRAY_FIELDS) as one list."""
    from fractencode_tpu_torch.encode.encoder import ARRAY_FIELDS

    return [getattr(res, f) for f in ARRAY_FIELDS]


def graph_memory(what):
    """Print the card memory allocated and reserved (torch.cuda) after
    ``what``."""
    import torch

    print(f"     memory after {what}: allocated {torch.cuda.memory_allocated()}, reserved "
          f"{torch.cuda.memory_reserved()} bytes")


def counted_forms():
    """{form: (the eager arrays of a numpy plane, the public call of a numpy
    plane on a device -> its arrays as one list)} of phase 27(a)'s encodes:
    the grid and the quadtree, default config."""
    import torch

    from fractencode_tpu_torch import encode_plane
    from fractencode_tpu_torch.encode import encoder as enc, quadtree as tq

    cfg, qcfg, _ = qt_config([])
    return {"encode_plane": (
        lambda p: list(enc._encode_arrays(torch.from_numpy(p).cuda(), cfg)),
        lambda p, dev="cuda": result_arrays(encode_plane(p, cfg, device=dev))),
        "encode_plane_quadtree": (
        lambda p: list(tq._quadtree_arrays(torch.from_numpy(p).cuda(), cfg, qcfg)),
        lambda p, dev="cuda": level_arrays(tq.encode_plane_quadtree(p, cfg, qcfg,
                                                                    device=dev)))}


def counted_parity(kernels):
    """Phase 27(a): at 512^2 and 2048^2, with PAIR_CAP patched just below
    the smallest search's n_pairs of two planes (every search K2), to the
    largest (K1), and for the grid to the smaller plane's n_pairs where the
    two differ (the capture takes one branch and a replay the other),
    encode_plane and encode_plane_quadtree on their graphs: the first call
    (eager), the capture and a replay on the other plane bitwise equal to
    the eager encode and (512^2) the CPU's, each counted search launching K1
    and K2."""
    from fractencode_tpu_torch.ops import matcher_kernels as mk
    from fractencode_tpu_torch.utils import graphs

    cap = mk.PAIR_CAP
    try:
        for n in (512, 2048):
            img, other = natural_plane(n, SEED + 2700), natural_plane(n, SEED + 2701)
            for form, (eager, call) in counted_forms().items():
                mk.PAIR_CAP = 4
                pairs = []
                for p in (img, other):
                    found = []
                    with prep_routes(found):
                        eager(p)
                    pairs.append([r[2] for r in found])
                every = pairs[0] + pairs[1]
                caps = [("K2", min(every) - 1), ("K1", max(every))]
                if form == "encode_plane" and pairs[0] != pairs[1]:
                    caps.append(("both", min(pairs[0][0], pairs[1][0])))
                for branch, c in caps:
                    mk.PAIR_CAP = c
                    graphs.clear()
                    routes = []
                    with prep_routes(routes):
                        want = [eager(p) for p in (img, other)]
                    searches = len(routes) // 2
                    counted = sum(r[0] == "counted" for r in routes) // 2
                    taken = {r[1] for r in routes if r[0] == "counted"}
                    check(counted and all(r[0] in ("counted", "search_classed") for r in routes)
                          and taken == {"K2": {True}, "K1": {False}, "both": {False, True}}[branch],
                          f"{form} {n}^2 cap {c}: routes {routes}, not {branch} taken")
                    before = collections.Counter(graphs.calls)
                    kernels.zero()
                    got = [call(p) for p in (img, img, other)]
                    counts = launch_keys(kernels)
                    kernels.read(f"counted {form} {n}^2 {branch}", [])
                    calls = {f: graphs.calls[form, f] - before[form, f]
                             for f in ("eager", "capture", "replay")}
                    check(calls == {"eager": 1, "capture": 1, "replay": 2},
                          f"{form} {n}^2 {branch}: {calls}, not an eager call, a capture "
                          "and 2 replays")
                    k1 = sum(v for k, v in counts.items() if k[0] == "search_classed")
                    k2 = sum(v for k, v in counts.items() if k[0] == "search_classed2d")
                    check((k1, k2) == (3 * searches, 3 * counted),
                          f"{form} {n}^2 {branch}: K1 {k1}, K2 {k2} launches in 3 calls, "
                          f"not {3 * searches} and {3 * counted}")
                    cpu = [call(img, "cpu")] if n == 512 else []
                    for res, exp in zip(got + cpu, [want[0], want[0], want[1], want[0]]):
                        check(all(bitwise(a, b) for a, b in zip(res, exp, strict=True)),
                              f"{form} {n}^2 {branch}: the graph's encode differs from "
                              "the eager encode or the CPU's")
                    print(f"     {form} {n}^2, PAIR_CAP {c} ({branch} taken; n_pairs "
                          f"{pairs[0]}, other plane {pairs[1]}): {counted} of {searches} "
                          "searches counted; graph (1 eager call, 1 capture, 2 replays) == "
                          "eager" + (" == CPU" if cpu else "") + f" bitwise; K1 {k1}, K2 {k2} "
                          "launches in 3 calls")
    finally:
        mk.PAIR_CAP = cap
        graphs.clear()


def untaken_launch(prep, c, what):
    """The counted route's untaken kernel alone on ``prep``, over the empty
    class segments matcher._counted gives it (CUDA events, median of 5),
    beside the taken one's time; every row keeps (-3e38, 0)."""
    from fractencode_tpu_torch.encode import matcher as tm
    from fractencode_tpu_torch.ops import matcher_kernels as mk

    k, area = c.target_size ** 2, c.source_size ** 2
    args, kw = tm._search_args(prep, k, area, c, {})
    empty = (prep["col_tile_start"] * prep["block_m"]).contiguous()
    k2 = bool(prep["take_k2"])
    untaken = mk.search_classed_cuda if k2 else mk.search_classed2d_cuda
    ms, (q, idx) = cuda_ms(lambda: untaken(*args[:7], empty, *args[8:], **kw))
    check(bool((q == -3.0e38).all()) and not bool(idx.any()),
          f"{what}: the untaken kernel's empty launch wrote a result")
    taken_ms, _ = cuda_ms(lambda: tm.classed_kernel(
        dict(prep, route="search_classed2d" if k2 else "search_classed"), k, area, c), 1)
    print(f"     {what}: the untaken K{1 if k2 else 2}'s empty launch {ms:.4f} ms (median "
          f"of 5), the taken K{2 if k2 else 1} {taken_ms:.4f} ms (one run)")
    return ms


def k2_plan(prep):
    """The last K2 launch's plan (search_classed2d_cuda.plan) read back: the
    host's shape plan, the device's split width, the splits of ``prep``'s
    longest segment and the work items."""
    from fractencode_tpu_torch.ops import matcher_kernels as mk

    plan = dict(mk.search_classed2d_cuda.plan)
    plan.update(width=int(plan["width"]), splits=int(plan["splits"].max()),
                work=int(plan["work"]))
    return plan


def k2_plan_turns(prep, c, what, other, other_width, rounds=3):
    """K2 on ``prep`` with the width it picks on the device against the
    width ``other_width`` given on the host (named ``other``), in turns
    (device, other, other, device; CUDA events, medians of ``rounds``),
    (q, idx) bitwise equal; returns both means."""
    from fractencode_tpu_torch.encode import matcher as tm

    k, area = c.target_size ** 2, c.source_size ** 2
    k2 = dict(prep, route="search_classed2d")
    runs = {"device": lambda: tm.classed_kernel(k2, k, area, c),
            other: lambda: tm.classed_kernel(k2, k, area, c, splits=other_width)}
    ms, out, plans = {name: [] for name in runs}, {}, {}
    for name in ("device", other, other, "device"):
        t, out[name] = cuda_ms(runs[name], rounds)
        ms[name].append(t)
        plans[name] = k2_plan(k2)
    check(bitwise(out["device"][0], out[other][0]) and bitwise(out["device"][1],
                                                                out[other][1]),
          f"{what}: K2 with the device's width differs from {other}")
    mine, theirs = (statistics.mean(ms[name]) for name in runs)
    p, q = plans["device"], plans[other]
    print(f"     {what}: K2 with the device's width {mine:.4f} ms ({p['splits']} split(s) "
          f"of {p['width']} columns, {p['work']} of {p['items']} work items), {other} "
          f"{theirs:.4f} ms ({q['splits']} split(s) of {q['width']} columns, {q['work']} of "
          f"{q['items']}), ratio {mine / theirs:.4f} (in turns, medians of {rounds}); "
          "(q, idx) bitwise")
    return mine, theirs


def counts_width(prep, c):
    """The split width K2 picks from ``prep``'s class counts, on the host
    (the plan before the device picked it)."""
    import torch

    from fractencode_tpu_torch.ops import matcher_kernels as mk

    seg = (prep["col_end"].long() - prep["col_tile_start"].long() * prep["block_m"]).clamp_min(0)
    total = int(seg[prep["tile_class"].long()].sum())
    m_pad, sms = prep["ch_s"].shape[0], torch.cuda.get_device_properties(0).multi_processor_count
    step, _ = mk._k2_plan(prep["tile_class"].shape[0], m_pad, prep["block_r"],
                          c.target_size ** 2, c.rms_threshold > 0, c.num_transforms, None, sms)
    return int(mk._k2_width(torch.tensor(total), step, prep["block_r"], m_pad, sms))


def one_split_width(prep, c):
    """A split width that gives ``prep``'s longest segment one split (whole
    groups with the frontier)."""
    seg = prep["col_end"].long() - prep["col_tile_start"].long() * prep["block_m"]
    t_n = c.num_transforms
    return -(-max(int(seg.max()), 1) // t_n) * t_n


def counted_phase(kernels, planes):
    """Phase 27: the counted and K2 routes on CUDA graphs: (a)
    counted_parity; (b) at 4096^2 encode_plane, encode_plane_quadtree,
    --vq-classes 4 and a 2 x 4096^2 encode_batch_stacked, eager and graph
    in turns (medians of 5), the graph bitwise equal to the eager form; (c)
    at 8192^2 the default and --rms 10 encode_plane and the quadtree the
    same (medians of 3), then K2 ls16 with the device's width against the
    counts' width on the host; (d)
    the card memory after each size's captures and after graphs.clear().
    ``planes``: natural planes by side, made here where missing."""
    import torch

    from fractencode_tpu_torch import encode_plane
    from fractencode_tpu_torch.encode import encoder as enc, matcher as tm, quadtree as tq, vq
    from fractencode_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    counted_parity(kernels)
    print(f"     (a) took {time.perf_counter() - t0:.1f} s")
    cfg, qcfg, _ = qt_config([])
    _, vcfg, _ = parse(["--device", "cuda", "--vq-classes", "4"])
    _, rcfg, _ = parse(["--device", "cuda", *RMS])
    cuda = torch.device("cuda")
    results = {}

    def same_forms(name, eager, graph_call):
        """The graph form's second call (a capture and a replay) bitwise
        equal to the eager form, the memory after the capture."""
        want = eager()
        graph_call()
        got = graph_call()
        check(all(bitwise(a, b) for a, b in zip(got, want, strict=True)),
              f"{name}: the graph's encode differs from the eager one")
        graph_memory(f"the {name} capture")

    def plane_forms(name, img, c, rounds, syncs=1):
        check(enc._replays(img.shape[0], img.shape[1], c, cuda), f"{name} takes no graph")
        same_forms(name, lambda: enc._encode_arrays(enc.plane_on_device(img, "cuda"), c),
                   lambda: result_arrays(encode_plane(img, c, device="cuda")))
        results[name] = timed_forms(name, 1, lambda graph: (
            lambda: encode_plane(img, c, device="cuda")) if graph else (
            lambda: enc._encode_arrays(enc.plane_on_device(img, "cuda"), c)),
            graph_syncs=syncs, rounds=rounds)

    def quadtree_forms(name, img, rounds):
        check(tq._replays(img.shape[0], img.shape[1], cfg, qcfg, cuda), f"{name} takes no graph")
        same_forms(name, lambda: tq._quadtree_arrays(enc.plane_on_device(img, "cuda"), cfg, qcfg),
                   lambda: level_arrays(tq.encode_plane_quadtree(img, cfg, qcfg, device="cuda")))
        results[name] = timed_forms(name, 1, lambda graph: (
            lambda: tq.encode_plane_quadtree(img, cfg, qcfg, device="cuda")) if graph else (
            lambda: tq._quadtree_arrays(enc.plane_on_device(img, "cuda"), cfg, qcfg)),
            rounds=rounds)

    print("     (b) 4096^2, eager and graph forms in turns (host clock, medians of 5; busy "
          "share by torch.profiler; host syncs by torch.cuda.set_sync_debug_mode):")
    t0 = time.perf_counter()
    n4 = 4096
    img4 = planes.get(n4)
    img4 = natural_plane(n4, SEED + n4) if img4 is None else img4
    graphs.clear()
    plane_forms(f"encode_plane {n4}^2", img4, cfg, 5)
    quadtree_forms(f"encode_plane_quadtree {n4}^2", img4, 5)
    p4 = torch.from_numpy(img4).cuda()
    _, steps = vq._kmeans(*enc._vq_start(p4, vcfg), vq.MAX_STEPS, vq.EPSILON, graph=False)
    steps = int(steps)
    del p4

    def vq_eager():
        p = enc.plane_on_device(img4, "cuda")
        book, _ = vq._kmeans(*enc._vq_start(p, vcfg), vq.MAX_STEPS, vq.EPSILON, graph=False)
        return list(enc._encode_arrays(p, vcfg, book))

    same_forms(f"encode_plane {n4}^2 --vq-classes 4", vq_eager,
               lambda: result_arrays(encode_plane(img4, vcfg, device="cuda")))
    results["vq"] = timed_forms(
        f"encode_plane {n4}^2 --vq-classes 4 ({steps} k-means steps)", 1,
        lambda graph: (lambda: encode_plane(img4, vcfg, device="cuda")) if graph else vq_eager,
        graph_syncs=-(-steps // vq._CHUNK) + 1, rounds=5)
    frames = np.stack([img4, img4[::-1]])  # two distinct frames
    same_forms(f"encode_batch_stacked 2 x {n4}^2",
               lambda: result_arrays(enc._encode_batch(enc.plane_on_device(frames, "cuda"),
                                                       cfg, False)),
               lambda: result_arrays(enc._encode_batch(enc.plane_on_device(frames, "cuda"),
                                                       cfg, True)))
    results["batch"] = timed_forms(f"encode_batch_stacked 2 x {n4}^2", 2, lambda graph: (
        lambda: enc._encode_batch(enc.plane_on_device(frames, "cuda"), cfg, graph)), rounds=5)
    del frames
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    graph_memory(f"graphs.clear() after {n4}^2")
    prep = tm.classed_prep(*level_inputs(img4, cfg), cfg)
    check(prep["route"] == "counted", f"{n4}^2: route {prep['route']}")
    untaken_launch(prep, cfg, f"{n4}^2")
    del prep
    print(f"     (b) took {time.perf_counter() - t0:.1f} s")

    print("     (c) 8192^2, eager and graph forms in turns (medians of 3):")
    t0 = time.perf_counter()
    n8 = 8192
    img8 = planes.get(n8)
    img8 = natural_plane(n8, SEED + n8) if img8 is None else img8
    plane_forms(f"encode_plane {n8}^2", img8, cfg, 3)
    plane_forms(f"encode_plane {n8}^2 --rms 10", img8, rcfg, 3)
    quadtree_forms(f"encode_plane_quadtree {n8}^2", img8, 3)
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    graph_memory(f"graphs.clear() after {n8}^2")
    prep = tm.classed_prep(*level_inputs(img8, cfg), cfg)
    check(prep["route"] == "counted" and bool(prep["take_k2"]),
          f"{n8}^2: route {prep['route']}, take_k2 {prep['take_k2']}")
    untaken_launch(prep, cfg, f"{n8}^2")
    mine, counts_ms = k2_plan_turns(prep, cfg, f"K2 ls16 at {n8}^2", "the counts' width",
                                    counts_width(prep, cfg))
    check(mine <= 1.05 * counts_ms, f"K2 at {n8}^2: the device's width {mine:.4f} ms "
                                    f"above 1.05x the counts' {counts_ms:.4f} ms")
    del prep
    gc.collect()
    torch.cuda.empty_cache()
    print(f"     (c) took {time.perf_counter() - t0:.1f} s")
    return results


def vq_labels(img, cfg, device):
    """(range labels, domain labels, codebook steps) of the encoder's VQ
    bins for ``img`` on ``device``: the steps of encoder._vq_classes, with
    the codebook's training steps kept."""
    import torch

    from fractencode_tpu_torch.core.grid import uniform_grid
    from fractencode_tpu_torch.encode import encoder as te
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges
    from fractencode_tpu_torch.encode.vq import assign_codes, train_codebook
    from fractencode_tpu_torch.utils.prng import prng_key

    n = img.shape[0]
    pf = torch.from_numpy(img).to(device).float()
    cb = build_codebook(pf, uniform_grid(n, n, cfg.source_size, cfg.domain_step),
                        cfg.target_size, cfg.num_transforms)
    dvec = te._normalize_affine(cb.values[:, 0, :])
    limit = cfg.vq_sample_limit if cfg.vq_sample_limit < dvec.shape[0] else None
    codebook, dcls, steps = train_codebook(dvec, prng_key(cfg.vq_seed), cfg.vq_classes,
                                           sample_limit=limit)
    rcls = assign_codes(te._normalize_affine(extract_ranges(pf, cfg.target_size)), codebook)
    return rcls - 1, dcls - 1, steps


def vq_phase(kernels, planes):
    """Phase 21: --vq-classes 4 on the card: labels and codebook steps equal
    to the CPU's at 512^2, 2048^2 and 4096^2 (the subsample branch), the
    whole CLI path card == CPU at 512^2, then the 2048^2 and 4096^2 paths
    launching K1, with encode ms and PSNR beside the classifier's."""
    import torch

    from fractencode_tpu_torch.core.metrics import psnr
    from fractencode_tpu_torch.decode import decode_plane
    from fractencode_tpu_torch.encode import encode_plane

    vq = ["--vq-classes", "4"]
    k1 = ("search_classed", "ls", 16, False)
    card_equals_cpu(planes[512], vq, "512 --vq-classes 4")
    print("     512^2 --vq-classes 4: card and CPU EncodeResult and pixels bitwise equal")
    steps = {}
    for n, img in ((512, planes[512]), (2048, planes[2048]), (4096, planes[4096])):
        _, cfg, _ = parse(["--device", "cuda", *vq])
        g, c = vq_labels(img, cfg, "cuda"), vq_labels(img, cfg, "cpu")
        steps[n] = g[2]
        check(g[2] == c[2] and bitwise(g[0], c[0]) and bitwise(g[1], c[1]),
              f"{n}^2 VQ labels or steps: card differs from CPU")
        print(f"     {n}^2: {g[1].numel()} domains, VQ labels and {g[2]} codebook steps "
              "bitwise equal, card against CPU"
              + (" (trained on a 65,536-vector subsample)" if g[1].numel() > 65536 else ""))
    for n in (2048, 4096):
        img = planes[n]
        plane_t = torch.from_numpy(img)
        rows = []
        for label, argv in (("--vq-classes 4", vq), ("classifier", [])):
            # the JAX package's route: K1 at 2048^2; at 4096^2 its pair list
            # may overflow, and then K2
            res, out, counts = drive(kernels, f"{n} {label}", img, argv,
                                     [k1] if n == 2048 else [], f"{n} {label} cuda")
            check(any(name.startswith(("search_classed_ls16", "search_classed2d_ls16"))
                      for name in counts), f"{n}^2 {label}: launches {counts}")
            check_uniform(res, out, n, f"{n}^2 {label}")
            _, c, d = parse(["--device", "cuda", *argv])
            enc_ms, _, (dec, _, _) = wall_times(lambda: encode_plane(img, c, device="cuda"),
                                                lambda e: decode_plane(e, d),
                                                reps=3 if n == 2048 else 1)
            check(np.array_equal(dec.cpu().numpy(), out), f"repeat {n}^2 {label} decode")
            db = float(psnr(plane_t, torch.from_numpy(out)))
            check(db > 20.0, f"{n}^2 {label} PSNR {db:.4f} dB is implausibly low")
            rows.append(f"{label}: encode {enc_ms:.3f} ms, PSNR {db:.4f} dB"
                        + (f", {steps[n]} codebook steps" if c.vq_classes else "")
                        + f", launches {counts}")
        print(f"     {n}^2 ({'median of 3 warm runs' if n == 2048 else 'one warm run'}, "
              "host clock): " + "; ".join(rows))


def cli_phase(kernels, planes):
    """Phase 22: ``python -m fractencode_tpu_torch`` on the card, as users
    run it: --log --profile DIR (the phase table; DIR holds a trace that
    names K1's kernel), --quadtree --log, and --vq-classes 3; each exits 0."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "gray512.png")
    Image.fromarray(planes[512]).save(src)
    prof = os.path.join(work, "prof")
    runs = {"--log --profile": ["--log", "--profile", prof],
            "--quadtree --log": ["--quadtree", "--log"],
            "--vq-classes 3": ["--vq-classes", "3"]}
    env = {**os.environ, "PYTHONPATH": ROOT}

    def run(name):
        out = os.path.join(work, name.replace(" ", "").replace("-", "") + ".png")
        return subprocess.run([sys.executable, "-m", "fractencode_tpu_torch", src,
                               *runs[name], "--result", out], cwd=work, env=env,
                              capture_output=True, text=True, timeout=300)

    with ThreadPoolExecutor(len(runs)) as pool:
        procs = dict(zip(runs, pool.map(run, runs)))
    for name, proc in procs.items():
        check(proc.returncode == 0, f"the CLI with {name}: exit {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
    for name in ("--log --profile", "--quadtree --log"):
        lines = procs[name].stdout.splitlines()
        check("-- phases --" in lines, f"{name}: no phase table")
        table = lines[lines.index("-- phases --") + 1:-1]
        check([l.split(":")[0] for l in table] == ["load", "encode", "decode", "total"],
              f"{name}: phase table {table}")
        print(f"     {name}: exit 0; phases " + ", ".join(table))
    check("100%" in procs["--quadtree --log"].stdout, "--quadtree --log: no progress line")
    check(f"profile trace written to {prof}" in procs["--log --profile"].stdout,
          "--profile: no trace line")
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"--profile wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if "search_classed_kernel" in str(e.get("name", ""))]
    check(k1, "the --profile trace names no K1 kernel (search_classed_kernel)")
    print(f"     --profile: {traces[0]}, {len(events)} events, K1 kernel "
          f"'{k1[0]['name'][:60]}...' {k1[0]['dur']} us; --vq-classes 3: exit 0, "
          + next(l for l in procs["--vq-classes 3"].stdout.splitlines()
                 if l.startswith("psnr:")))
    shutil.rmtree(work)


def hit_share(q, sa, sa2, c):
    """Share of ranges whose winner meets the threshold: exactly the rows
    that hit (a row that hits wins at or above its hit column's key)."""
    import torch

    from fractencode_tpu_torch.encode import matcher as tm
    from fractencode_tpu_torch.ops import matcher_kernels as mk

    k = c.target_size ** 2
    dist = mk.rank_to_dist(q, sa2, sa, criterion=c.criterion, so_mode=c.so_mode,
                           s_max=c.s_max, inv_norm=tm.inv_norm(c, k, c.source_size ** 2),
                           n=float(k))
    return float((dist <= torch.tensor(c.rms_threshold, dtype=torch.float32,
                                       device=dist.device)).double().mean())


@contextlib.contextmanager
def recorded(module, name, calls):
    """Calls of ``module.name`` appended to ``calls`` as (args, kwargs),
    but those a CUDA graph captures: their tensors hold no data."""
    import torch

    fn = getattr(module, name)

    def record(*args, **kwargs):
        if not torch.cuda.is_current_stream_capturing():
            calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def no_plain_search():
    """A plain search on CUDA tensors raises while this is on: the sharded
    paths must launch the kernels."""
    from fractencode_tpu_torch.ops import matcher_kernels as mk

    def refuse(*_, **__):
        raise RuntimeError("a sharded path ran the plain search on CUDA tensors")

    plain = mk._plain_search
    mk._plain_search = refuse
    try:
        yield
    finally:
        mk._plain_search = plain


def timed(fn):
    """(host-clock ms of fn(), ended by a synchronize; its result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def search_key(c, masked=False):
    """The record of the search that config c runs: K1 with the classifier,
    else K3 (masked: the sharded searches' class mask)."""
    from fractencode_tpu_torch.encode import matcher as tm

    key = (tm.rank_mode(c.criterion, c.so_mode, c.s_max), width_of(c), c.rms_threshold > 0)
    if c.use_classifier:
        return ("search_classed", *key)
    return ("search_dense", *key) + (("masked",) if masked else ())


def k3_config(mode, k, thr):
    """The no-classifier config of K3's (mode, K) on the CLI paths (the
    quadtree's at its level's geometry), with --rms 10 for ``thr``."""
    argv = ({16: [], 64: [*CONFIG1], 256: ["--quadtree"]}[k] if mode == "ls"
            else KEY_PATHS[(mode, k)])
    return path_config([*argv, "--noclassifier", *(RMS if thr else [])], mode, k)


def masked_parity(kernels, call, what, plain_reps=5):
    """K3 masked on the inputs of a recorded ``sharded.search_dense`` call
    (a shard's search, its domain mask as classes) against its plain
    version: (q, idx) bitwise, the times and the bound into the record;
    with the frontier its hit share too."""
    import dataclasses as dc

    from fractencode_tpu_torch.encode import matcher as tm

    (ranges, sa, sa2, cb, rcls, dcls, c), _ = call
    k, area = c.target_size ** 2, c.source_size ** 2
    prep = tm.dense_prep(ranges, sa, sa2, cb, rcls, dcls, c)
    check(prep["rcls"] is not None, f"{what}: no class mask")
    key = search_key(dc.replace(c, use_classifier=False), masked=True)
    cols = prep["ch"].shape[0]
    nbytes = search_bytes(ranges.shape[0], cols, k, prep["sa"] is not None, True)
    q, _, pairs = kernels.parity(
        key, lambda: tm.dense_kernel(prep, k, area, c),
        lambda scanned=None: tm.dense_kernel(prep, k, area, dc.replace(c, backend="torch"),
                                             scanned=scanned),
        f"{what}, {ranges.shape[0]} rows x {cols} columns, {int((dcls < 0).sum())} of "
        f"{dcls.shape[0]} domains masked", nbytes, plain_reps, n=k)
    if c.rms_threshold > 0:
        share = hit_share(q, sa, sa2, c)
        kernels.hits(key, share)
        print(f"      {share:.4f} of the rows hit; {pairs} pairs scanned up to each "
              "row's frontier")


def eager_search_calls(frames, c, mesh):
    """The K3 searches of a sharded 'domains' encode of ``frames`` under
    config c, each shard's inputs, recorded from its eager steps (on the
    graphs a replay makes no Python call): calls of ``sharded.search_dense``
    as ``recorded`` lists them."""
    from fractencode_tpu_torch.parallel import sharded as ts

    calls = []
    with no_plain_search(), recorded(ts, "search_dense", calls):
        ts._encode_batch(frames, c, mesh, "domains", graph=False)
    return calls


def codebook_bytes(w: int, c, rows_per: int) -> int:
    """The bytes of one codebook band of ``rows_per`` domain rows: values
    [D, T, K] f32, SumB, SumB2 and 1/var_b [D, T] f32, and the classes [D]
    i32 with the classifier."""
    nx = (w - c.source_size) // c.domain_step + 1
    d, t, k = rows_per * nx, c.num_transforms, c.target_size ** 2
    return d * t * k * 4 + 3 * d * t * 4 + (4 * d if c.use_classifier else 0)


def pod_phase(device="cuda"):
    """The pod driver as users launch it, on the card: for each strategy one
    process of 8 shards and two processes of 4 (gloo, a localhost
    rendezvous), a (2, 4) mesh of cuda:0 either way, 8 x 512^2 with the
    decode; all nine processes side by side.  The checksums must agree."""
    import socket

    from fractencode_tpu_torch.parallel import STRATEGIES

    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "fractencode_tpu_torch.scripts.encode_pod", "--batch", "8",
            "--size", "512", "--decode", "--reps", "1", "--n-data", "2", "--device", device]

    def port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def start(argv):
        return subprocess.Popen(base + argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    runs = {}
    for st in STRATEGIES:
        runs[(st, 1)] = [start(["--strategy", st, "--shards", "8"])]
        at = port()
        runs[(st, 2)] = [start(["--strategy", st, "--shards", "4", "--coordinator",
                                f"127.0.0.1:{at}", "--num-processes", "2", "--process-id",
                                str(i), "--init-timeout", "120"]) for i in (0, 1)]
    outs = {}
    try:
        for key, procs in runs.items():
            outs[key] = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for (st, n), texts in outs.items():
        for p, text in zip(runs[(st, n)], texts):
            check(p.returncode == 0, f"encode_pod {st}, {n} process(es): exit {p.returncode}: "
                                     f"{text[-2000:]}")
    for st in STRATEGIES:
        sums = {}
        for n in (1, 2):
            text = outs[(st, n)][0]
            sums[n] = [re.search(rf"^{what}: (\d+)$", text, re.M) for what in
                       ("checksum", "decode checksum")]
            check(all(sums[n]), f"encode_pod {st}, {n} process(es): no checksum: {text}")
            sums[n] = [int(m.group(1)) for m in sums[n]]
            check(f"mesh={{'data': 2, 'search': 4}} hosts={n}" in text,
                  f"encode_pod {st}, {n} process(es): {text}")
            lines = [l for l in text.splitlines() if l.startswith(("encode:", "decode:"))]
            print(f"     encode_pod {st}, {n} process(es): " + "; ".join(lines))
        check(sums[1] == sums[2], f"encode_pod {st}: checksums {sums[1]} (one process) "
                                  f"!= {sums[2]} (two)")
        print(f"     encode_pod {st}: checksum {sums[1][0]}, decode checksum {sums[1][1]}, "
              "equal for one process and two")


def shard_phase(kernels, cfg, planes, card="cuda:0"):
    """Phase 23: the sharded drivers on meshes of cuda:0 repeated, every
    field bitwise against the single-device functions on the card: config
    5's 16 x 512^2 batch on (2, 4) by each strategy (default, --rms 10, and
    without the classifier under 'domains' and 'ring': K3 masked, plain and
    `_thr`) and its decode (flat, pyramid); config 4's halo-sharded plane on
    (1, 4) at 2048^2 (replicate and ring; the classifier and
    --noclassifier, each with and without --rms 10) and 4096^2 (ring); the
    quadtree pair on (4, 2) at 8 x 1024^2; every masked K3 instance on a
    sharded path ('domains', 256^2) and against its plain version there,
    then ls16 masked, plain and `_thr`, at the 2048^2 halo band; the pod
    driver in one process and two; the dry run."""
    import dataclasses as dc

    import torch

    from fractencode_tpu_torch import (DecoderConfig, decode_batch_stacked,
                                       encode_batch_stacked, encode_plane)
    from fractencode_tpu_torch.encode import quadtree as tq
    from fractencode_tpu_torch.graft_entry import dryrun_multichip
    from fractencode_tpu_torch.ops import matcher_kernels as mk
    from fractencode_tpu_torch.parallel import (STRATEGIES, decode_batch_sharded,
                                                encode_batch_sharded,
                                                encode_plane_sharded_image, make_mesh)
    from fractencode_tpu_torch.parallel import sharded as ts

    card = torch.device(card)
    mesh = lambda nd, ns: make_mesh(nd, ns, devices=[card] * (nd * ns))
    fields = ("domain_idx", "transform", "s", "o", "distance", "valid")
    variants = lambda c: {"": c, " --rms 10": dc.replace(c, rms_threshold=10.0)}
    start = time.perf_counter()

    def lap(what):
        print(f"     ({what}: {time.perf_counter() - start:.1f} s into phase 23)")

    print("     every mesh here repeats cuda:0, so its shards share one card: host ms "
          "are the sharding's overhead, not its scaling (one warm run each)")

    def sharded(path, expect, fn, calls=None):
        """fn() as one path: counts zeroed before and read after, no plain
        search on the card; (host ms, result, launch counts)."""
        kernels.zero()
        with no_plain_search(), recorded(ts, "search_dense",
                                         [] if calls is None else calls):
            ms, out = timed(fn)
        return ms, out, kernels.read(path, expect)

    # every masked K3 instance on a sharded path and against its plain
    # version at that path's last band
    small, m14 = planes[256], mesh(1, 4)
    for mode in mk.KERNEL_KEYS:
        for k in LEVELS:  # the fixed instances (phase 24: the others)
            for thr in (False, True):
                c = k3_config(mode, k, thr)
                name = f"{mode}{k}" + ("_thr" if thr else "")
                calls = eager_search_calls(small[None], c, m14)
                _, res, _ = sharded(f"sharded domains 256 nocls {name}",
                                    [search_key(c, masked=True)],
                                    lambda: encode_batch_sharded(small[None], c, m14, "domains"))
                single = encode_plane(small, c, device=card)
                for f in fields:
                    check(bitwise(getattr(res[0], f), getattr(single, f)),
                          f"sharded domains 256^2 {name} {f} differs from encode_plane")
                masked_parity(kernels, calls[-1], f"256^2 sharded 'domains' {name}, band 3")
    print("     256^2 'domains' on (1, 4) without the classifier, every (key, K) plain "
          "and --rms 10: equal to encode_plane, each launching its masked K3 instance")

    lap("the masked instances")
    # config 5: 16 distinct 512^2 frames (phase 20's) on (2, 4)
    frames = np.stack([natural_plane(512, SEED + 1000 + i) for i in range(16)])
    m24 = mesh(2, 4)
    for c_name, c0 in (("default", cfg), ("--noclassifier", dc.replace(cfg, use_classifier=False))):
        for suffix, c in variants(c0).items():
            name = c_name + suffix
            st_ms, stacked = timed(lambda: encode_batch_stacked(frames, c, device=card))
            row = [f"encode_batch_stacked {st_ms / 16:.3f}"]
            for strategy in STRATEGIES:
                if strategy == "ranges" and not c.use_classifier:
                    continue
                masked = not c.use_classifier
                ms, res, counts = sharded(
                    f"sharded {strategy} 16x512 {name}", [search_key(c, masked)],
                    lambda: encode_batch_sharded(frames, c, m24, strategy))
                check(not masked or all("_masked" in n for n in counts),
                      f"{strategy} {name}: launches {counts}")
                for i in range(16):
                    for f in fields:
                        check(bitwise(getattr(res[i], f), getattr(stacked, f)[i]),
                              f"sharded {strategy} {name} frame {i} {f} differs from "
                              "encode_batch_stacked")
                row.append(f"{strategy} {ms / 16:.3f} (launches {counts})")
                if name == "default" and strategy == "ranges":
                    base, base_stacked = res, stacked
            print(f"     16 x 512^2 {name}, (2, 4): every frame and field bitwise equal to "
                  "encode_batch_stacked; host ms a frame: " + "; ".join(row))
    for pyramid in (False, True):
        d = DecoderConfig(pyramid=pyramid)
        st_ms, (so, si, sm) = timed(lambda: decode_batch_stacked(base_stacked, d))
        ms, (ho, hi, hm), _ = sharded(
            f"decode_batch_sharded {'pyramid' if pyramid else 'flat'} 16x512", [("decode_step",)],
            lambda: decode_batch_sharded(base, m24, pyramid=pyramid))
        # the flat loop counts the step that met its exit too (as the JAX
        # package's sharded decode does)
        want = si if pyramid else (si + 1).clamp(max=d.max_iterations)
        check(bitwise(ho, so) and bitwise(hm, sm) and torch.equal(hi, want),
              f"decode_batch_sharded pyramid={pyramid} differs from decode_batch_stacked")
        print(f"     decode_batch_sharded {'pyramid' if pyramid else 'flat'}, (2, 4): pixels, "
              f"MSE and iterations equal to decode_batch_stacked's; host ms a frame "
              f"{ms / 16:.3f} against {st_ms / 16:.3f}")

    lap("the 16 x 512^2 batch and its decodes")
    # config 4: the halo-sharded plane on (1, 4)
    halo_calls = {}
    for n_px in (2048, 4096):
        img = planes[n_px]
        cases = ([(cls + suffix, c) for cls, c0 in (("classifier", cfg), (
            "--noclassifier", dc.replace(cfg, use_classifier=False)))
            for suffix, c in variants(c0).items()] if n_px == 2048 else [("classifier", cfg)])
        for name, c in cases:
            base_ms, single = timed(lambda: encode_plane(img, c, device=card))
            row = [f"encode_plane {base_ms:.3f}"]
            for codebook in ("replicate", "ring") if n_px == 2048 else ("ring",):
                calls = []
                ms, res, counts = sharded(
                    f"halo {codebook} {n_px} {name}",
                    [search_key(c, True)] if n_px == 2048 else [],
                    lambda: encode_plane_sharded_image(img, c, m14, codebook), calls)
                check(any(n.startswith(("search_classed_ls16", "search_classed2d_ls16",
                                        "search_dense_ls16_masked")) for n in counts),
                      f"halo {codebook} {n_px} {name}: launches {counts}")
                for f in fields:
                    check(bitwise(getattr(res, f), getattr(single, f)),
                          f"halo {codebook} {n_px}^2 {name} {f} differs from encode_plane")
                row.append(f"{codebook} {ms:.3f} (launches {counts})")
                if (n_px, codebook) == (2048, "replicate") and not c.use_classifier:
                    halo_calls[name] = calls[0]
            hs = n_px // 4
            band = codebook_bytes(n_px, c, hs // c.domain_step)
            print(f"     {n_px}^2 {name}, (1, 4): bitwise equal to encode_plane; host ms "
                  + "; ".join(row) + f"; codebook bytes a shard holds at its peak: "
                  f"replicate {5 * band} (its band and the gathered 4), ring {2 * band} "
                  "(its band and the one arriving), from the tensors' sizes")
    for name, call in halo_calls.items():
        masked_parity(kernels, call, f"2048^2 {name} halo band 0 (replicate: 4 gathered "
                      "bands)", plain_reps=1)

    lap("the halo plane")
    # the quadtree pair on (4, 2): phase 20's 8 x 1024^2 frames
    qcfg = tq.QuadtreeConfig()
    qframes = np.stack([natural_plane(1024, SEED + 2000 + i) for i in range(8)])
    m42 = mesh(4, 2)
    st_ms, qst = timed(lambda: tq.encode_batch_quadtree_stacked(qframes, cfg, qcfg,
                                                                 device=card))
    ms, qsh, counts = sharded("sharded quadtree 8x1024", [("search_classed", "ls", 16, False)],
                              lambda: tq.encode_batch_quadtree_sharded(qframes, cfg, qcfg, m42))
    singles = []
    for i in range(8):
        levels = [dc.replace(l, **{f: getattr(l, f)[i] for f in tq.LEVEL_ARRAY_FIELDS})
                  for l in qst.levels]
        singles.append(tq.QuadtreeResult(levels=levels, width=qst.width, height=qst.height))
        for ls, l1 in zip(qsh[i].levels, levels, strict=True):
            for f in tq.LEVEL_ARRAY_FIELDS:
                check(bitwise(getattr(ls, f), getattr(l1, f)),
                      f"sharded quadtree frame {i} {l1.range_size} px {f} differs")
    dcfg = DecoderConfig(pyramid=True)
    d_st, outs = timed(lambda: [tq.decode_plane_quadtree(q, dcfg) for q in singles])
    d_sh, (ho, hi, hm), _ = sharded("decode_batch_quadtree_sharded 8x1024", [("decode_step",)],
                                    lambda: tq.decode_batch_quadtree_sharded(qsh, m42, dcfg))
    for i, (out, it, mse) in enumerate(outs):
        check(bitwise(ho[i], out) and (int(hi[i]), float(hm[i])) == (it, float(np.float32(mse))),
              f"decode_batch_quadtree_sharded frame {i} differs")
    print(f"     8 x 1024^2 quadtree, (4, 2): every level of every frame equal to "
          f"encode_batch_quadtree_stacked's, the pyramid decode to decode_plane_quadtree's; "
          f"host ms a frame: encode {ms / 8:.3f} against {st_ms / 8:.3f}, decode "
          f"{d_sh / 8:.3f} against {d_st / 8:.3f}; launches {counts}")

    lap("the quadtree pair")
    shard_graphs(kernels, cfg, frames, base, qsh, planes[2048], card)
    lap("the step graphs")
    pod_phase(card.type)
    lap("encode_pod")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(8, devices=[card] * 8)
    print(f"     {buf.getvalue().strip()} (devices: cuda:0 x 8)")


def shard_graph_form(kernels, name, frames_n, make, expect, graph_syncs=1, rounds=5):
    """One sharded form on its step graphs (``make(graph)`` gives its eager
    and graph calls, functions of no arguments), the graph cache cleared
    first: a warm graph call with the launch counts zeroed before and read
    after, in which every graph step must replay, then eager and graph in
    turns (``timed_forms``).  Prints the warm call's graphs.calls by step,
    the graphs the form holds, the card memory then and the launches;
    returns (the timings, the graph keys held)."""
    import torch

    from fractencode_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    graphs.clear()
    run = make(True)
    run()  # each key's first call runs eagerly, its second captures
    torch.cuda.synchronize()
    before = collections.Counter(graphs.calls)
    kernels.zero()
    with no_plain_search():
        run()
    torch.cuda.synchronize()
    counts = kernels.read(f"{name}, graph", expect)
    steps = dict(graphs.calls - before)
    check(steps and all(form == "replay" for _, form in steps),
          f"{name}: a warm graph call took {steps}, not replays only")
    out = timed_forms(name, frames_n, make, graph_syncs, rounds, busy_forms=("graph",))
    keys = list(graphs._GRAPHS)
    print(f"       graphs.calls of a warm graph call by step: "
          + ", ".join(f"{step} x{n}" for (step, _), n in sorted(steps.items()))
          + f"; {len(keys)} graphs held ({', '.join(k[0] for k in keys)}), card memory "
          f"allocated {torch.cuda.memory_allocated()}, reserved "
          f"{torch.cuda.memory_reserved()} bytes; launches on the replays {counts} "
          f"({time.perf_counter() - t0:.1f} s)")
    return out, keys


def shard_graphs(kernels, cfg, frames, results, qresults, big, card):
    """Phase 23's sharded forms on their step graphs, eager against graph in
    turns: the three strategies on phase 20's 16 x 512^2 ``frames`` on
    (2, 4), the 2048^2 halo plane ``big`` on (1, 4) by replicate and ring,
    the sharded decodes of ``results`` (flat and pyramid, (2, 4)) and of the
    quadtree's ``qresults`` (pyramid, (4, 2)); then the K3 masked forms'
    launches on the replays, and the card memory after the phase and after
    graphs.clear()."""
    import dataclasses as dc

    import torch

    from fractencode_tpu_torch import DecoderConfig, encode_batch_stacked
    from fractencode_tpu_torch.decode import decoder as dec
    from fractencode_tpu_torch.encode import quadtree as tq
    from fractencode_tpu_torch.parallel import STRATEGIES, make_mesh
    from fractencode_tpu_torch.parallel import sharded as ts
    from fractencode_tpu_torch.utils import graphs

    mesh = lambda nd, ns: make_mesh(nd, ns, devices=[card] * (nd * ns))  # noqa: E731
    m24, m14, m42 = mesh(2, 4), mesh(1, 4), mesh(4, 2)
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    graph_memory("graphs.clear() before the step graphs")
    print("     the sharded forms on their step graphs (meshes of cuda:0: host overhead, "
          "not scaling), eager and graph in turns (host clock, medians of 5; the graph "
          "form's busy share by torch.profiler; host syncs by "
          "torch.cuda.set_sync_debug_mode; card memory with the form's graphs):")
    k1 = [search_key(cfg)]
    for strategy in STRATEGIES:
        _, keys = shard_graph_form(
            kernels, f"encode_batch_sharded {strategy} 16 x 512^2 (2, 4)", 16,
            lambda graph, st=strategy: lambda: ts._encode_batch(frames, cfg, m24, st, graph), k1)
        check(strategy != "ring" or len(keys) <= 4,
              f"ring at 16 x 512^2 holds {len(keys)} graph keys for 4 shards x 4 hops")
    for codebook in ("replicate", "ring"):
        shard_graph_form(kernels, f"encode_plane_sharded_image {codebook} 2048^2 (1, 4)", 1,
                         lambda graph, cb=codebook: lambda: ts._encode_image(
                             big, cfg, m14, cb, graph), k1)
    nocls = dc.replace(cfg, use_classifier=False)
    stacked = encode_batch_stacked(frames, nocls, device=card)
    for strategy, c in (("domains", nocls), ("ring", dc.replace(nocls, rms_threshold=10.0))):
        name = f"encode_batch_sharded {strategy} 16 x 512^2 (2, 4) --noclassifier" + (
            " --rms 10" if c.rms_threshold else "")
        kernels.zero()
        with no_plain_search():
            ts._encode_batch(frames, c, m24, strategy, True)
            before = collections.Counter(graphs.calls)
            kernels.zero()
            res = ts._encode_batch(frames, c, m24, strategy, True)
        counts = kernels.read(f"{name}, graph", [search_key(c, masked=True)])
        steps = dict(graphs.calls - before)
        check(all(form == "replay" for _, form in steps), f"{name}: took {steps}")
        if not c.rms_threshold:
            for i in range(16):
                for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
                    check(bitwise(getattr(res[i], f), getattr(stacked, f)[i]),
                          f"{name} frame {i} {f} differs from encode_batch_stacked")
        print(f"     {name}: a warm graph call replays every step "
              f"({', '.join(f'{k} x{n}' for (k, _), n in sorted(steps.items()))}) "
              f"and launches {counts}"
              + ("" if c.rms_threshold else "; every frame equal to encode_batch_stacked"))
    for pyramid in (False, True):
        d = DecoderConfig(pyramid=pyramid)
        _, iters, _ = ts._decode_batch(results, m24, d, True)
        chunks = 0 if pyramid else int((-(-iters // dec._CHUNK)).sum())
        shard_graph_form(kernels, f"decode_batch_sharded {'pyramid' if pyramid else 'flat'} "
                         "16 x 512^2 (2, 4)", 16,
                         lambda graph, d=d: lambda: ts._decode_batch(results, m24, d, graph),
                         [("decode_step",)], graph_syncs=1 + chunks)
    qd = DecoderConfig(pyramid=True)
    shard_graph_form(kernels, "decode_batch_quadtree_sharded pyramid 8 x 1024^2 (4, 2)", 8,
                     lambda graph: lambda: tq._decode_batch_sharded(qresults, m42, qd, graph),
                     [("decode_step",)])
    graph_memory(f"the sharded forms ({len(graphs._GRAPHS)} graphs held)")
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    graph_memory("graphs.clear() and torch.cuda.empty_cache()")


def range_phase(kernels, planes, k1_parity, k2_parity, k3_parity):
    """Phase 24: every range size the JAX CLI accepts.  (a) the quadtree
    from 32 px down to 2 px (levels of n = 1024, 256, 64, 16 and 4) at
    2048^2, default, --noclassifier, --compat, --smax 0.9 and --rms 10: card
    == CPU at 256^2 on every level, then each level's instance launched, the
    leaves, times and PSNR; (b) the grid at 2x2, 6x6, 10x10 and 32x32 ranges
    (n = 4, 36, 100, 1024), with and without the classifier: card == CPU at
    256^2 (240^2 for 6x6 and 10x10), then at 2048^2 (2040^2) the launches,
    times and PSNR; (c) each padded and K-slab instance driven by a CLI path
    at 512^2 (480^2) that launches it, and against its plain version at that
    path's config (K1, K2 on the forced route, K3; `_thr` also on a smooth
    plane, where its ranges hit), then K3's masked instances on 256^2 (240^2)
    'domains' paths of the sharded batch encode; (d) the files of the
    --qt-min 2 --qt-max 32 path and of --source 8 --target 2 at 512^2, card
    == CPU byte for byte."""
    import dataclasses as dc

    import torch
    from PIL import Image

    from fractencode_tpu_torch.core.metrics import psnr
    from fractencode_tpu_torch.encode import matcher as tm
    from fractencode_tpu_torch.encode.quadtree import (QuadtreeConfig,
                                                       decode_plane_quadtree,
                                                       encode_plane_quadtree)
    from fractencode_tpu_torch.parallel import encode_batch_sharded, make_mesh
    from fractencode_tpu_torch.decode import decode_plane
    from fractencode_tpu_torch.encode import encode_plane

    def crop(img, t):  # the largest square of img that ranges and domain steps tile
        m = img.shape[0] - img.shape[0] % (2 * t)
        return np.ascontiguousarray(img[:m, :m])

    def launched(counts, c, what, route=None):
        """The search instance config c selects: K3 without the classifier,
        else K1 or K2 (the JAX package's route), or on the counted route
        (``route``: prep_routes' record) both, K2 taken or not."""
        mode, width = tm.rank_mode(c.criterion, c.so_mode, c.s_max), width_of(c)
        thr = c.rms_threshold > 0
        kerns = (("search_dense",) if not c.use_classifier
                 else ("search_classed", "search_classed2d"))
        took = [k for k in kerns if counts.get(kernels.records[(k, mode, width, thr)]["name"])]
        tag = f"_{mode}{width}" + ("_thr" if thr else "")
        if route is not None and route[0] == "counted":
            check(took == list(kerns), f"{what}: launched {took} on the counted route")
            return f"counted (K{2 if route[1] else 1} taken){tag}"
        check(len(took) == 1, f"{what}: launched {took} of {kerns} at {mode}{width}")
        return took[0] + tag

    # (a) the quadtree at every level from 32 px to 2 px
    big = planes[2048]
    big_t = torch.from_numpy(big)
    for flags in ([], ["--noclassifier"], ["--compat"], ["--smax", "0.9"], RMS):
        argv = [*QT_WIDE, *flags]
        name = " ".join(argv)
        card_equals_cpu(planes[256], argv, f"256 {name}")
        routes = []
        with prep_routes(routes):
            qres, qout, counts = drive(kernels, name, big, argv, [], f"2048 {name}")
        _, c, dcfg = parse(["--device", "cuda", *argv])
        qcfg = QuadtreeConfig(min_size=2, max_size=32)
        check_quadtree(qres, qout, 2048, qcfg, f"2048^2 {name}")
        routes = routes or [None] * len(qres.levels)  # none without the classifier
        took = [launched(counts, dc.replace(c, source_size=l.domain_size,
                                            target_size=l.range_size),
                         f"{name} {l.range_size} px", route)
                for l, route in zip(qres.levels, routes, strict=True)]
        enc_ms, dec_ms, (d, iters, _) = wall_times(
            lambda: encode_plane_quadtree(big, c, qcfg, device="cuda"),
            lambda e: decode_plane_quadtree(e, dcfg), reps=1)
        check(np.array_equal(d.cpu().numpy(), qout), f"{name}: repeat decode differs")
        db = float(psnr(big_t, d.cpu()))
        check(db > 20.0, f"{name} PSNR {db:.4f} dB is implausibly low")
        leaves = " ".join(f"{l.range_size}px:{int(l.accepted.sum())}" for l in qres.levels)
        print(f"     {name}: card == CPU at 256^2 on every level; at 2048^2 leaves {leaves}; "
              f"instances {', '.join(took)}; launches {counts}; encode {enc_ms:.3f} ms, "
              f"decode {dec_ms:.3f} ms ({iters} steps, one warm run, host clock); "
              f"PSNR {db:.4f} dB")

    # (b) the grid at the other range sizes
    for width, (source, target, full) in RANGE_GRIDS.items():
        for nocls in ([], ["--noclassifier"]):
            argv = ["--source", str(source), "--target", str(target), *nocls]
            name = " ".join(argv)
            small = crop(planes[256], target)
            card_equals_cpu(small, argv, f"{small.shape[0]} {name}")
            img = crop(planes[2048], target)
            check(img.shape[0] == full, f"{name}: plane {img.shape[0]}")
            routes = []
            with prep_routes(routes):
                res, out, counts = drive(kernels, name, img, argv, [], f"{full} {name}")
            _, c, dcfg = parse(["--device", "cuda", *argv])
            check_uniform(res, out, full, f"{full}^2 {name}")
            took = launched(counts, c, name, routes[0] if routes else None)
            enc_ms, dec_ms, (d, iters, _) = wall_times(
                lambda: encode_plane(img, c, device="cuda"), lambda e: decode_plane(e, dcfg),
                reps=1)
            check(np.array_equal(d.cpu().numpy(), out), f"{name}: repeat decode differs")
            db = float(psnr(torch.from_numpy(img), d.cpu()))
            check(db > 15.0, f"{name} PSNR {db:.4f} dB is implausibly low")
            print(f"     {name}: card == CPU at {small.shape[0]}^2; at {full}^2 {took}, "
                  f"launches {counts}; encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms "
                  f"({iters} steps, one warm run, host clock); PSNR {db:.4f} dB")

    # (c) each padded and K-slab instance: a path that launches it, then its
    # parity at that path's config; K3 masked on a sharded 'domains' path
    smooth = smooth_plane(512, SEED + 24)
    mesh = make_mesh(1, 4, devices=[torch.device("cuda:0")] * 4)
    fields = ("domain_idx", "transform", "s", "o", "distance", "valid")
    for width, (source, target, _) in RANGE_GRIDS.items():
        img, sm = crop(planes[512], target), crop(smooth, target)
        for mode, key_flags in RANGE_KEYS.items():
            for thr in (False, True):
                for nocls in ([], ["--noclassifier"]):
                    argv = ["--source", str(source), "--target", str(target), *key_flags,
                            *nocls, *(RMS if thr else [])]
                    name = " ".join(argv)
                    _, _, counts = drive(kernels, name, img, argv, [], f"{img.shape[0]} {name}")
                    _, c, _ = parse(["--device", "cuda", *argv])
                    launched(counts, c, name)
                    what = f"{img.shape[0]}^2 {name}"
                    if nocls:
                        k3_parity(img, c, what, plain_reps=1)
                        if thr:
                            k3_parity(sm, c, f"smooth {what}", plain_reps=1)
                        continue
                    k1_parity(img, c, what, plain_reps=1)
                    k2_parity(img, c, f"{what}, forced K2", plain_reps=1)
                    if thr:
                        k1_parity(sm, c, f"smooth {what}", plain_reps=1)
                        k2_parity(sm, c, f"smooth {what}, forced K2", plain_reps=1)
                # K3 masked: a 'domains' path of the sharded batch encode
                c = dc.replace(c, use_classifier=False)
                frames = np.stack([crop(planes[256], target), crop(smooth[:256, :256], target)])
                calls = eager_search_calls(frames, c, mesh)
                kernels.zero()
                with no_plain_search():
                    res = encode_batch_sharded(frames, c, mesh, "domains")
                name = f"sharded domains {frames.shape[1]} {mode}{width}" + ("_thr" if thr else "")
                kernels.read(name, [search_key(c, masked=True)])
                for j in range(frames.shape[0]):
                    single = encode_plane(frames[j], c, device="cuda")
                    for f in fields:
                        check(bitwise(getattr(res[j], f), getattr(single, f)),
                              f"{name} frame {j} {f} differs from encode_plane")
                masked_parity(kernels, calls[-1], f"{name}, last call", plain_reps=1)
    for key, rec in kernels.records.items():
        if len(key) > 2 and not isinstance(key[2], int) and key[3]:
            check(rec.get("max_hit_share", 0.0) > 0, f"{rec['name']}: no range hit")
    print("     every padded and K-slab instance launched by its path and bitwise equal "
          "to its plain version; each `_thr` instance hit in one check")

    # (d) the files
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "range512.png")
    Image.fromarray(planes[512]).save(src)
    for argv in (QT_WIDE, ["--source", "8", "--target", "2"]):
        name = " ".join(argv)
        blobs, decoded = {}, {}
        for device in ("cuda", "cpu"):
            file = os.path.join(work, f"range_{device}.ft")
            rc, _ = run_cli([src, *argv, "--device", device, "--out", file,
                             "--result", os.path.join(work, "range_enc.png")])
            check(rc == 0, f"{name} --out on {device}: exit {rc}")
            with open(file, "rb") as f:
                blobs[device] = f.read()
            rc, _ = run_cli(["--decode-file", file, "--device", device,
                             "--result", os.path.join(work, f"range_dec_{device}.png")])
            check(rc == 0, f"{name} --decode-file on {device}: exit {rc}")
            decoded[device] = np.asarray(Image.open(os.path.join(work,
                                                                 f"range_dec_{device}.png")))
        check(blobs["cuda"] == blobs["cpu"], f"512^2 {name}: the card's file differs")
        check(np.array_equal(decoded["cuda"], decoded["cpu"]),
              f"512^2 {name}: the card's decode of the file differs")
        print(f"     512^2 {name}: --out on the card and the CPU, {len(blobs['cuda'])} "
              "bytes each, equal; their --decode-file equal")
    shutil.rmtree(work)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--dp4a", metavar="DIR", help="a csrc/ directory with earlier designs "
                    "of search_classed.cu, search_classed2d.cu, search_dense.cu and "
                    "micro_step.cu (e.g. micro_step.cu's dp4a design), timed against "
                    "these in turns")
    args = ap.parse_args(argv)
    dp4a = args.dp4a
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
    for name in MMA_SOURCES:
        counts = sass_counts(_build._library(name))
        print(f"    {name} SASS: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
        check(counts["IMMA"] > 0 and counts["IDP4A"] == 0,
              f"{name}: {counts['IMMA']} IMMA, {counts['IDP4A']} IDP4A")
    if dp4a:
        _build.build(*MMA_SOURCES, csrc=dp4a)
        for name in MMA_SOURCES:
            counts = sass_counts(_build._library(name, dp4a))
            print(f"    {name} ({dp4a}) SASS: "
                  + ", ".join(f"{op} {n}" for op, n in counts.items()))
        for name in SEARCH_SOURCES:
            n = sass_diff(_build._library(name), _build._library(name, dp4a))
            print(f"    {name} SASS against {dp4a}'s build: "
                  + ("identical" if n == 0 else f"{n} lines differ"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    kernels = Kernels(dp4a)
    _, cfg, dcfg = parse(["--device", "cuda"])
    planes = {n: natural_plane(n, SEED + n) for n in (256, 512, 2048)}
    big = planes[2048]

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
        key = ("search_classed", tm.rank_mode(c.criterion, c.so_mode, c.s_max), width_of(c),
               c.rms_threshold > 0)
        nbytes = search_bytes(ranges.shape[0], cb.values.shape[0] * cb.values.shape[1], k,
                              prep["sa_s"] is not None)
        rows = prep["rpos"].long()
        q, _, pairs = kernels.parity(
            key, lambda: tm.classed_kernel(prep, k, area, c),
            lambda scanned=None: tm.classed_kernel(prep, k, area, plain_c, scanned=scanned),
            f"{what}, {prep['ai_s'].shape[0]} sorted rows x {prep['ch_s'].shape[0]} "
            "sorted columns", nbytes, plain_reps, real=rows, n=k)
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
        key = ("search_dense", tm.rank_mode(c.criterion, c.so_mode, c.s_max), width_of(c),
               c.rms_threshold > 0) + (("masked",) if masked else ())
        nbytes = search_bytes(ranges.shape[0], prep["ch"].shape[0], k,
                              prep["sa"] is not None, masked)
        q, _, pairs = kernels.parity(
            key, lambda: tm.dense_kernel(prep, k, area, c),
            lambda scanned=None: tm.dense_kernel(prep, k, area, plain_c, scanned=scanned),
            f"{what}, {prep['ch'].shape[0]} columns"
            + (", class mask" if masked else ""), nbytes, plain_reps, n=k)
        report_frontier(key, c, q, sa, sa2, pairs, what)

    def block_order(img, c, what):
        """K1 with its range tiles in the grid's order and longest class
        segment first: the same kernel on a copy of the prep whose tiles are
        permuted on the card (a stable descending argsort of their segments'
        lengths, then gathers of their rows), timed in turns (grid, longest,
        longest, grid; medians of 5).  The permuted (q, idx) must be the
        grid order's rows in the permuted order, bitwise.  Without the
        frontier only: row_end holds positions in the grid's order."""
        check(c.rms_threshold == 0, "block order without the frontier only")
        k, area = c.target_size ** 2, c.source_size ** 2
        prep = tm.classed_prep(*level_inputs(img, c), c)
        check(prep["route"] == "search_classed", f"{what}: route {prep['route']}")
        br, tc = prep["block_r"], prep["tile_class"]
        seg = (prep["col_end"].long() - prep["col_tile_start"].long() * prep["block_m"])
        per_tile = seg.clamp_min(0)[tc.long()]

        def permutation():
            order = torch.argsort(per_tile, descending=True, stable=True)
            rows = (order[:, None] * br + torch.arange(br, device=order.device)).reshape(-1)
            return order, rows

        sort_ms, (order, rows) = cuda_ms(permutation)
        take = lambda t: None if t is None else t[rows].contiguous()
        longest = dict(prep, ai_s=take(prep["ai_s"]), sa_s=take(prep["sa_s"]),
                       sa2_s=take(prep["sa2_s"]), tile_class=tc[order].contiguous())
        run = {"grid": lambda: tm.classed_kernel(prep, k, area, c),
               "longest": lambda: tm.classed_kernel(longest, k, area, c)}
        ms = {name: [] for name in run}
        out = {}
        for name in ("grid", "longest", "longest", "grid"):
            t, out[name] = cuda_ms(run[name])
            ms[name].append(t)
        check(bitwise(out["grid"][0][rows], out["longest"][0])
              and bitwise(out["grid"][1][rows], out["longest"][1]),
              f"K1 in longest-first order differs at {what}")
        grid_ms, longest_ms = (statistics.mean(ms[name]) for name in run)
        print(f"    {what}: K1 grid order {grid_ms:.4f} ms, longest segment first "
              f"{longest_ms:.4f} ms ({grid_ms / longest_ms:.4f}x; in turns, medians of 5), "
              f"(q, idx) bitwise the same rows; the argsort and row indices {sort_ms:.4f} "
              f"ms; {tc.shape[0]} range tiles of {br} rows, segments "
              f"{int(per_tile.min())}-{int(per_tile.max())} columns")

    # -- 2. K1 parity and times at K = 16
    print("[2] K1 at K = 16 (default path), kernel vs plain")
    for n in (512, 2048):
        k1_parity(planes[n], cfg, f"{n}^2")
    print("    K1's block order: the grid's against longest class segment first")
    block_order(planes[512], cfg, "512^2")
    block_order(big, cfg, "2048^2")
    for k in (64, 256):
        ds, rs = LEVELS[k]
        block_order(big, dataclasses.replace(cfg, source_size=ds, target_size=rs),
                    f"2048^2, {rs} px level")
    block_order(big, path_config(KEY_PATHS[("raw", 16)], "raw", 16), "2048^2, --compat")

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
    stages, staged = encode_stages(big, cfg)
    check(bitwise(staged.domain_idx, res.domain_idx) and bitwise(staged.s, res.s),
          "the staged encode differs from encode_plane")
    busy, window = device_busy(lambda: (encode_plane(big, cfg, device="cuda"),
                                        torch.cuda.synchronize()))
    print("    2048^2 encode by stage, each alone (device ms by CUDA events / host ms, "
          "medians of 5): " + ", ".join(f"{name} {dev:.4f} / {host:.3f}"
                                        for name, (dev, host) in stages.items())
          + f"; sum {sum(d for d, _ in stages.values()):.4f} / "
          f"{sum(h for _, h in stages.values()):.3f}; the whole encode under the profiler "
          f"{window:.3f} ms a run, device busy "
          + ("not measured (the profiler saw no device time)" if busy is None
             else f"{busy:.4f} of it"))

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
        kernels.read(f"golden {name}", [(kernel, "raw", 16, "--rms" in flags),
                                        ("decode_step",)])
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
        plain = [n for n in counts if n.startswith("search") and not n.endswith("_thr")]
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
        key = ("search_classed2d", tm.rank_mode(c.criterion, c.so_mode, c.s_max), width_of(c),
               c.rms_threshold > 0)
        nbytes = search_bytes(ranges.shape[0], cb.values.shape[0] * cb.values.shape[1], k,
                              prep["sa_s"] is not None)
        rows = prep["rpos"].long()
        q, _, pairs = kernels.parity(
            key, lambda: tm.classed_kernel(prep, k, area, c, splits=splits),
            lambda scanned=None: tm.classed_kernel(prep, k, area, plain_c, scanned=scanned,
                                                   splits=splits),
            f"{what}, {prep['ai_s'].shape[0]} sorted rows x {prep['ch_s'].shape[0]} "
            "sorted columns", nbytes, plain_reps, real=rows, n=k)
        plan = k2_plan(prep)
        print(f"      {plan['splits']} splits of {plan['width']} columns, {plan['work']} of "
              f"{plan['items']} work items, partials {plan['partial_bytes']} bytes")
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

    def k1_vs_k2(prep, c, what, reps=5, k1_reps=None):
        """K1 and K2 on the same prep, (q, idx) bitwise, with both times (K1
        over ``k1_reps`` runs, ``reps`` by default; with --dp4a each also in
        turns with its --dp4a build)."""
        k, area = c.target_size ** 2, c.source_size ** 2
        k1 = dict(prep, route="search_classed")
        k2 = dict(prep, route="search_classed2d")
        run1 = lambda: tm.classed_kernel(k1, k, area, c)
        run2 = lambda: tm.classed_kernel(k2, k, area, c)
        ms1, (q1, i1) = cuda_ms(run1, k1_reps or reps)
        ms2, (q2, i2) = cuda_ms(run2, reps)
        check(bitwise(q1, q2) and bitwise(i1, i2), f"K2 differs from K1 at {what}")
        plan = k2_plan(prep)
        earlier = earlier1 = None
        if kernels.dp4a:
            ms1, earlier1 = turns(run1, what, kernels.dp4a, k1_reps or reps)
            ms2, earlier = turns(run2, what, kernels.dp4a)
        rows = prep["rpos"].long()
        seg = (prep["col_end"] - prep["col_tile_start"] * prep["block_m"]).long()
        pairs = int(seg[prep["tile_class"].long()[rows // prep["block_r"]]].sum())
        bound_ms, bound_by = bound(pairs, k, search_bytes(
            rows.shape[0], prep["b4_cols"].shape[0], k, prep["sa_s"] is not None))
        print(f"    {what}: K1 {ms1:.4f} ms"
              + ("" if earlier1 is None else f" (--dp4a build {earlier1:.4f} ms in turns)")
              + f", K2 {ms2:.4f} ms"
              + ("" if earlier is None else f" (--dp4a build {earlier:.4f} ms in turns)")
              + f" ({plan['splits']} splits of "
              f"{plan['width']} columns, {plan['work']} of {plan['items']} work items, "
              f"partials {plan['partial_bytes']} bytes; K1 "
              f"{'median of 5' if (k1_reps or reps) > 1 else 'one run'}, K2 "
              f"{'median of 5' if reps > 1 else 'one run'}); (q, idx) bitwise equal; "
              f"{rows.shape[0]} rows, {pairs} same-class pairs, bound {bound_ms:.4f} ms "
              f"({bound_by}{', without the frontier' if c.rms_threshold > 0 else ''})")
        return dict(k1_ms=ms1, k1_dp4a_ms=earlier1, ms=ms2, dp4a_ms=earlier, bound_ms=bound_ms,
                    bound_by=bound_by, plan=plan, out=(q2, i2))

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
        ran = k2_plan(sub)["splits"]
        check(ran == plan["splits"], f"{what}: the sample ran {ran} splits")
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
        if mask is not None and l.range_size <= 8:
            # the fine levels' few searched tiles: the splits fill the card
            k2_plan_turns(prep, c, f"2048^2 quadtree {l.range_size} px level", "one split",
                          one_split_width(prep, c), rounds=5)

    # the 8192^2 paths: the JAX package's pair list may overflow there, and
    # overflows on these planes, so the counted route takes K2: K1 launches
    # too, over empty segments (the lax.cond's untaken branch)
    n8 = 8192
    huge = planes[n8] = natural_plane(n8, SEED + n8)
    huge_t = torch.from_numpy(huge)
    for name, argv, expect in (("8192 default", [], ("ls", 16, False)),
                               ("8192 --rms 10", RMS, ("ls", 16, True))):
        routes = []
        with prep_routes(routes):
            res, out, counts = drive(kernels, name, huge, argv,
                                     [("search_classed2d", *expect),
                                      ("search_classed", *expect)], f"{name} cuda")
        check([r[:2] for r in routes] == [("counted", True)]
              and {n: v for n, v in counts.items() if n != "decode_step"}
              == {kernels.records[(kern, *expect)]["name"]: 1
                  for kern in ("search_classed", "search_classed2d")},
              f"{name}: routes {routes}, launches {counts}, not K2 taken and K1 and "
              f"K2's {expect} once each")
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
        check(prep["route"] == "counted" and bool(prep["take_k2"]),
              f"{name}: route {prep['route']}, n_pairs {prep['n_pairs']}")
        prep_pairs = prep["n_pairs"]
        whole = k1_vs_k2(prep, c, f"{n8}^2 {name[5:]} prep", k1_reps=1)
        plan = whole["plan"]
        key = ("search_classed2d", *expect)
        k2_sampled(prep, c, whole["plan"], whole["out"], f"{n8}^2 {name[5:]} prep")
        if not expect[2]:
            # the record times the path's whole launch against its bound; the
            # plain version, too slow for the whole plane, keeps the sample's
            rec = kernels.records[key]
            rec.update(sample_ms=rec["ms"], sample_bound_ms=rec["bound_ms"],
                       sample_bound_by=rec["bound_by"], ms=whole["ms"],
                       bound_ms=whole["bound_ms"], bound_by=whole["bound_by"])
            if whole["dp4a_ms"] is not None:
                rec.update(sample_dp4a_ms=rec.get("dp4a_ms"), dp4a_ms=whole["dp4a_ms"])
        del prep, ranges, cb, whole
        print(f"     {n8}^2 {name[5:]}: launches {counts}; route counted, K2 taken "
              f"(worst_pairs "
              f"{tm._classed_statics((n8 // 4) ** 2, ((n8 - 16) // 8 + 1) ** 2 * 4)[4]}, "
              f"n_pairs {int(prep_pairs)} above the cap {mk.PAIR_CAP}); {plan['splits']} "
              f"split(s) of "
              f"{plan['width']} columns, partials {plan['partial_bytes']} bytes; encode "
              f"{enc_ms:.3f} ms, decode {dec_ms:.3f} ms ({iters} full-res steps, one warm "
              f"run, host clock); PSNR {db:.4f} dB")
    name = "8192 --quadtree"
    level_routes = []
    with prep_routes(level_routes):
        qres, qout, counts = drive(kernels, name, huge, ["--quadtree"], [], f"{name} cuda")
    check_quadtree(qres, qout, n8, qcfg, f"{n8}^2 --quadtree")
    routes = []
    for l, route in zip(qres.levels, level_routes, strict=True):
        # K1 launches at every level; K2 too where the route is counted
        k = l.range_size ** 2
        launched = {kern: counts.get(kernels.records[(kern, "ls", k, False)]["name"], 0)
                    for kern in ("search_classed", "search_classed2d")}
        check(launched == {"search_classed": 1,
                           "search_classed2d": int(route[0] == "counted")},
              f"{name} {l.range_size} px level: route {route}, launched {launched}")
        routes.append(f"{l.range_size}px:" + ("K1" if route[0] == "search_classed" else
                                              f"counted, K{2 if route[1] else 1} taken"))
    db = float(psnr(huge_t, torch.from_numpy(qout)))
    check(db > 20.0, f"{name} PSNR {db:.4f} dB is implausibly low")
    leaves = " ".join(f"{l.range_size}px:{int(l.accepted.sum())}" for l in qres.levels)
    print(f"     {n8}^2 --quadtree: routes {'; '.join(routes)}; launches {counts}; leaves "
          f"{leaves}; PSNR {db:.4f} dB")
    print(f"     phase 18 took {time.perf_counter() - t18:.1f} s")

    # -- 19. K4 and K5: the pair-list step microbenchmark
    print("[19] K4/K5 (the pair-list step microbenchmark), kernel vs plain")
    t19 = time.perf_counter()
    micro_phase(kernels)
    print(f"     phase 19 took {time.perf_counter() - t19:.1f} s")

    # -- 20. the batch forms
    print("[20] the batch forms on the card, frame by frame against the single-plane "
          "functions")
    t20 = time.perf_counter()
    batch_phase(kernels, cfg, dcfg)
    print(f"     phase 20 took {time.perf_counter() - t20:.1f} s")

    # -- 21. VQ pruning
    print("[21] --vq-classes 4 on the card, against the CPU and the classifier")
    t21 = time.perf_counter()
    planes[4096] = natural_plane(4096, SEED + 4096)
    vq_phase(kernels, planes)
    print(f"     phase 21 took {time.perf_counter() - t21:.1f} s")

    # -- 22. the CLI as users run it
    print("[22] python -m fractencode_tpu_torch with --log, --profile, --quadtree, "
          "--vq-classes on the card")
    t22 = time.perf_counter()
    cli_phase(kernels, planes)
    print(f"     phase 22 took {time.perf_counter() - t22:.1f} s")

    # -- 23. sharding
    print("[23] the sharded drivers on meshes of cuda:0, against the single-device "
          "functions")
    t23 = time.perf_counter()
    shard_phase(kernels, cfg, planes)
    print(f"     phase 23 took {time.perf_counter() - t23:.1f} s")

    # -- 24. every range size
    print("[24] range sizes: the padded instances (n = 4, 36, 100) and the K-slab form "
          "(n = 1024)")
    t24 = time.perf_counter()
    range_phase(kernels, planes, k1_parity, k2_parity, k3_parity)
    print(f"     phase 24 took {time.perf_counter() - t24:.1f} s")

    # -- 25. the main path on CUDA graphs
    print("[25] the encode and the pyramid decode on their CUDA graphs, against the "
          "eager forms and the CPU")
    t25 = time.perf_counter()
    graph_phase(kernels)
    print(f"     phase 25 took {time.perf_counter() - t25:.1f} s")

    # -- 26. the JAX package's remaining device loops on CUDA graphs
    print("[26] the quadtree pyramid and its batch, the flat decode (grid and quadtree) "
          "and VQ's k-means on CUDA graphs, against their eager forms and the CPU")
    t26 = time.perf_counter()
    loop_phase(kernels)
    print(f"     phase 26 took {time.perf_counter() - t26:.1f} s")

    # -- 27. the counted and K2 routes on CUDA graphs
    print("[27] the counted and K2 routes on CUDA graphs: the 4096^2 and 8192^2 "
          "encodes as one device program")
    t27 = time.perf_counter()
    counted_phase(kernels, planes)
    print(f"     phase 27 took {time.perf_counter() - t27:.1f} s")

    # -- 28. the decoder step's kernel
    print("[28] the decoder step's kernel against the plain step at the decode cell's shapes")
    t28 = time.perf_counter()
    decode_step_phase(kernels)
    print(f"     phase 28 took {time.perf_counter() - t28:.1f} s")

    records = list(kernels.records.values())
    for rec in records:
        # K2 runs where the JAX package routes to it: at 8192^2 only its 'ls'
        # instances at K = 16; the others report the launches they had
        if not rec["name"].startswith("search_classed2d"):
            check(rec["launches"] > 0, f"{rec['name']} was launched by no path")
        check("ms" in rec and "bound_ms" in rec, f"{rec['name']} was not timed")
    check(len(records) == 174, f"{len(records)} kernel records, not 174")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
