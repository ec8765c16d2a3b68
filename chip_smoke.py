#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fractencode_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. build the CUDA kernels from csrc/ (into build/kernels/) and print the
     card's name and power limit;
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
     the leaves per level, the encode and decode wall times and the PSNR.
The planes are natural-like synthetic textures made with numpy from a seed.
The last two lines are the kernels' JSON record and the device JSON line.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20240611
KERNEL_SOURCE = "fractencode_tpu_torch/csrc/search_classed.cu"
# _pairs_kernel; at K = 64 its ls_fast int8 branch, at K = 256 its f32 branch
REPLACES = {16: "fractencode_tpu/ops/matcher_pallas.py:508",
            64: "fractencode_tpu/ops/matcher_pallas.py:556",
            256: "fractencode_tpu/ops/matcher_pallas.py:568"}
# (domain, range) sizes of the quadtree's levels by K (CLI defaults)
LEVELS = {16: (16, 4), 64: (32, 8), 256: (64, 16)}


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


def cuda_ms(fn, reps=5):
    """Median device time of fn() in ms (CUDA events), after one warmup."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def prep_on_card(img, cfg):
    """Class-sorted search inputs of one plane, built on the card."""
    import torch

    from fractencode_tpu_torch.core.classify import classify_grid
    from fractencode_tpu_torch.core.grid import uniform_grid
    from fractencode_tpu_torch.encode.codebook import build_codebook, extract_ranges
    from fractencode_tpu_torch.encode.matcher import classed_prep

    n = img.shape[0]
    p = torch.from_numpy(img).cuda()
    pf = p.to(torch.float32)
    dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
    cb = build_codebook(pf, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(pf, cfg.target_size)
    return classed_prep(ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
                        classify_grid(p, rg), classify_grid(p, dg), cfg)


def k1_parity(prep, k, domain_area, cfg, plain_cfg, what):
    """Kernel against plain version on one prepped input: (q, idx) bitwise;
    returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from fractencode_tpu_torch.encode.matcher import classed_kernel

    q_k, i_k = classed_kernel(prep, k, domain_area, cfg)
    q_p, i_p = classed_kernel(prep, k, domain_area, plain_cfg)
    torch.cuda.synchronize()
    err = float((q_k.double() - q_p.double()).abs().max())
    check(torch.equal(q_k.view(torch.int32), q_p.view(torch.int32)),
          f"K1 q differs from the plain version at {what} (max abs {err})")
    check(torch.equal(i_k, i_p), f"K1 idx differs from the plain version at {what}")
    ms = cuda_ms(lambda: classed_kernel(prep, k, domain_area, cfg))
    plain_ms = cuda_ms(lambda: classed_kernel(prep, k, domain_area, plain_cfg))
    print(f"    K1 K={k} at {what}: {prep['ai_s'].shape[0]} sorted rows x "
          f"{prep['ch_s'].shape[0]} sorted columns, (q, idx) bitwise equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    import dataclasses

    from fractencode_tpu_torch import cli
    from fractencode_tpu_torch.core.metrics import psnr
    from fractencode_tpu_torch.decode import decode_plane
    from fractencode_tpu_torch.encode import encode_plane
    from fractencode_tpu_torch.encode.quadtree import (QuadtreeConfig,
                                                       decode_plane_quadtree,
                                                       encode_plane_quadtree)
    from fractencode_tpu_torch.ops import _build
    from fractencode_tpu_torch.ops import matcher_kernels as mk
    from fractencode_tpu_torch.params import DecoderConfig

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # -- 1. build
    t0 = time.perf_counter()
    _build.load_library("search_classed")
    print(f"[1] built search_classed (K = 16, 64, 256) in "
          f"{time.perf_counter() - t0:.3f} s")
    for log in sorted(_build.BUILD_DIR.glob("libsearch_classed-*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    args_gpu = cli.build_parser().parse_args(["--device", "cuda"])
    args_cpu = cli.build_parser().parse_args(["--device", "cpu"])
    cfg = cli._config_from_args(args_gpu)
    plain_cfg = dataclasses.replace(cfg, backend="torch")
    dcfg = DecoderConfig(pyramid=True)  # what cli.main runs without --compat
    planes = {n: natural_plane(n, SEED + n) for n in (512, 2048)}

    records = {k: dict(name=f"search_classed_ls{k}", route="cuda",
                       source=KERNEL_SOURCE, replaces=REPLACES[k], launches=0,
                       max_abs_err=0.0) for k in LEVELS}

    # -- 2. K1 parity and times at K = 16
    print("[2] K1 at K = 16 (default path), kernel vs plain")
    for n, img in planes.items():
        err, ms, plain_ms = k1_parity(prep_on_card(img, cfg), 16, 256, cfg,
                                      plain_cfg, f"{n}^2")
        records[16].update(max_abs_err=max(records[16]["max_abs_err"], err),
                           ms=ms, plain_ms=plain_ms)

    # -- 3. main path at 512^2: card == CPU, bitwise
    img = planes[512]
    res_g, out_g = cli._encode_one(img, args_gpu, cfg, dcfg, label=" [512 cuda]")
    res_c, out_c = cli._encode_one(img, args_cpu, cfg, dcfg, label=" [512 cpu]")
    for f in ("domain_idx", "transform", "valid", "distance", "s", "o"):
        a, b = getattr(res_g, f).cpu(), getattr(res_c, f)
        same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
            if a.dtype == torch.float32 else torch.equal(a, b)
        check(same, f"512^2 EncodeResult.{f}: card differs from CPU")
    check(np.array_equal(out_g, out_c), "512^2 decoded pixels: card differs from CPU")
    print("[3] 512^2 main path: card and CPU EncodeResult and pixels bitwise equal")

    # -- 4. main path at 2048^2 on the card
    img = planes[2048]
    for k in mk.KERNEL_K:
        mk.search_classed_cuda.launches[k] = 0
    res, out = cli._encode_one(img, args_gpu, cfg, dcfg, label=" [2048 cuda]")
    launches = mk.search_classed_cuda.launches[16]
    check(launches > 0, "the 2048^2 main path launched no search kernel")
    records[16]["launches"] = launches
    records[16]["launches_by_path"] = {"default": launches}
    r = (2048 // 4) ** 2
    check(out.shape == (2048, 2048) and out.dtype == np.uint8, "decoded shape")
    for f in ("s", "o", "distance"):
        t = getattr(res, f)
        check(t.shape == (r,) and bool(torch.isfinite(t).all()), f"{f} finite [R]")
    # valid is False exactly where no domain shares the range's class
    from fractencode_tpu_torch.core.classify import classify_grid

    plane_t = torch.from_numpy(img)
    rcls = classify_grid(plane_t, res.range_grid)
    dh = torch.bincount(classify_grid(plane_t, res.domain_grid) + 1, minlength=7)
    check(torch.equal(res.valid.cpu(), dh[rcls + 1] > 0), "valid flags")

    def encode():
        e = encode_plane(img, cfg, device="cuda")
        torch.cuda.synchronize()
        return e

    enc_s, dec_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        e = encode()
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        d, iters, _ = decode_plane(e, dcfg)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
    db = float(psnr(torch.from_numpy(img), d.cpu()))
    check(np.array_equal(d.cpu().numpy(), out), "repeat decode differs")
    check(db > 20.0, f"2048^2 PSNR {db:.4f} dB is implausibly low")
    print(f"[4] 2048^2 main path: {launches} K1 launches; encode "
          f"{1e3 * statistics.median(enc_s):.3f} ms, decode "
          f"{1e3 * statistics.median(dec_s):.3f} ms ({iters} full-res steps, "
          f"median of 3 warm runs, host clock); PSNR {db:.4f} dB")

    # -- 5. K1 parity and times at K = 64 and 256 (quadtree level inputs)
    print("[5] K1 at K = 64 and 256 (quadtree 8 and 16 px levels), kernel vs plain")
    for k in (64, 256):
        ds, rs = LEVELS[k]
        lcfg = dataclasses.replace(cfg, source_size=ds, target_size=rs, lattice=2)
        err, ms, plain_ms = k1_parity(
            prep_on_card(planes[2048], lcfg), k, ds * ds, lcfg,
            dataclasses.replace(lcfg, backend="torch"), f"2048^2, {rs} px level")
        records[k].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # -- 6. quadtree path at 512^2: card == CPU, bitwise
    qargs_gpu = cli.build_parser().parse_args(["--device", "cuda", "--quadtree"])
    qargs_cpu = cli.build_parser().parse_args(["--device", "cpu", "--quadtree"])
    img = planes[512]
    qres_g, qout_g = cli._encode_one_quadtree(img, qargs_gpu, cfg, dcfg,
                                              label=" [512 quadtree cuda]")
    qres_c, qout_c = cli._encode_one_quadtree(img, qargs_cpu, cfg, dcfg,
                                              label=" [512 quadtree cpu]")
    for lg, lc in zip(qres_g.levels, qres_c.levels, strict=True):
        for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
            a, b = getattr(lg, f).cpu(), getattr(lc, f)
            same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
                if a.dtype == torch.float32 else torch.equal(a, b)
            check(same, f"512^2 quadtree {lg.range_size} px {f}: card differs from CPU")
    check(np.array_equal(qout_g, qout_c),
          "512^2 quadtree decoded pixels: card differs from CPU")
    print("[6] 512^2 quadtree path: card and CPU levels and pixels bitwise equal")

    # -- 7. quadtree path at 2048^2 on the card
    img = planes[2048]
    qcfg = QuadtreeConfig()  # what the CLI's --qt-* defaults give
    for k in mk.KERNEL_K:
        mk.search_classed_cuda.launches[k] = 0
    qres, qout = cli._encode_one_quadtree(img, qargs_gpu, cfg, dcfg,
                                          label=" [2048 quadtree cuda]")
    qlaunch = dict(mk.search_classed_cuda.launches)
    for k in mk.KERNEL_K:
        check(qlaunch[k] > 0, f"the 2048^2 quadtree path launched no K = {k} kernel")
    records[16]["launches"] += qlaunch[16]
    records[16]["launches_by_path"]["quadtree"] = qlaunch[16]
    for k in (64, 256):
        records[k]["launches"] = qlaunch[k]
        records[k]["launches_by_path"] = {"quadtree": qlaunch[k]}
    check(qout.shape == (2048, 2048) and qout.dtype == np.uint8, "quadtree decoded shape")
    area = 0
    for l in qres.levels:
        r = (2048 // l.range_size) ** 2
        for f in ("s", "o"):
            t = getattr(l, f)
            check(t.shape == (r,) and bool(torch.isfinite(t).all()),
                  f"{l.range_size} px {f} finite [R]")
        area += int(l.accepted.sum()) * l.range_size ** 2
    for l in qres.levels[:-1]:  # the finest level takes every block left over
        check(bool((l.error[l.accepted] <= qcfg.error_threshold).all()),
              f"{l.range_size} px leaves above the error threshold")
    check(area == 2048 * 2048, f"quadtree leaves cover {area} pixels, not the plane")

    enc_s, dec_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        e = encode_plane_quadtree(img, cfg, qcfg, device="cuda")
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        d, iters, _ = decode_plane_quadtree(e, dcfg)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
    db = float(psnr(torch.from_numpy(img), d.cpu()))
    check(np.array_equal(d.cpu().numpy(), qout), "repeat quadtree decode differs")
    check(db > 20.0, f"2048^2 quadtree PSNR {db:.4f} dB is implausibly low")
    leaves = " ".join(f"{l.range_size}px:{int(l.accepted.sum())}" for l in e.levels)
    print(f"[7] 2048^2 quadtree path: K1 launches {qlaunch}; leaves {leaves}; "
          f"encode {1e3 * statistics.median(enc_s):.3f} ms, decode "
          f"{1e3 * statistics.median(dec_s):.3f} ms ({iters} full-res steps, "
          f"median of 3 warm runs, host clock); PSNR {db:.4f} dB")

    print(json.dumps({"kernels": [records[k] for k in sorted(records)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
