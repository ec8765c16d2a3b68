"""Command-line entry point of the port (mirrors ``fractencode_tpu/cli.py``).

Encodes one grayscale plane (or the three YUV planes with ``--color``),
decodes it and prints the reference CLI's statistics plus PSNR, for the flags
the port covers; ``--out`` writes the compressed file (FTC1 for the uniform
grid, FTQ1 for the quadtree, FTCC around three planes) and ``--decode-file``
decodes one.  ``--log`` adds progress and a per-phase timing table,
``--profile DIR`` a torch.profiler trace of the encode and decode.

Usage:
    python -m fractencode_tpu_torch input.png [--device cuda|cpu] [flags]
    python -m fractencode_tpu_torch input.png --out out.ftc
    python -m fractencode_tpu_torch --decode-file in.ftc --result out.png
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fractencode_tpu_torch", description=__doc__)
    p.add_argument("input", nargs="?", help="input image (png/jpg)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (the default) or cpu")
    p.add_argument("--decode", type=int, default=-1, help="max decode iterations")
    p.add_argument("--source", type=int, default=16, help="domain block size")
    p.add_argument("--target", type=int, default=4, help="range block size")
    p.add_argument("--rms", type=float, default=0.0,
                   help="early-accept MSE threshold (0 = off)")
    p.add_argument("--smax", type=float, default=-1.0, help="|s| clamp (<=0 off)")
    p.add_argument("--debug_decode", action="store_true", help="dump decode iterates")
    p.add_argument("--transforms", type=int, default=4, choices=range(1, 9),
                   help="number of dihedral isometries to search (reference: 4)")
    p.add_argument("--criterion", choices=["affine", "raw"], default="affine")
    p.add_argument("--so-mode", choices=["ls", "reference"], default="ls")
    p.add_argument("--compat", action="store_true",
                   help="bit-parity with the C++ reference (raw + reference + 4)")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"], default="auto",
                   help="the search's route, by the JAX CLI's names: auto (the "
                        "kernels on the card, the plain versions on the CPU), jnp "
                        "(the plain PyTorch versions) or pallas (the CUDA kernels)")
    p.add_argument("--result", default="result.png", help="decoded output image path")
    p.add_argument("--decode-rms", type=float, default=1e-5)
    p.add_argument("--quadtree", action="store_true",
                   help="adaptive quadtree ranges (the reference parsed this "
                        "flag but never implemented it)")
    p.add_argument("--qt-min", type=int, default=4, help="finest range size")
    p.add_argument("--qt-max", type=int, default=16, help="coarsest range size")
    p.add_argument("--qt-threshold", type=float, default=50.0,
                   help="per-pixel MSE acceptance threshold per level")
    p.add_argument("--noclassifier", action="store_true",
                   help="search every (range, domain) pair, with no class prune")
    p.add_argument("--color", action="store_true", help="encode all 3 YUV planes")
    p.add_argument("--out", help="write the compressed bitstream to this path")
    p.add_argument("--decode-file", help="decode a bitstream instead of encoding")
    p.add_argument("--log", action="store_true",
                   help="per-phase wall-clock timing + progress reporting")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace into DIR")
    p.add_argument("--vq-classes", type=int, default=0, metavar="N",
                   help="replace the brightness classifier with an N-bin "
                        "learned LBG codebook prune (1..7; 0 = off)")
    return p


def _config_from_args(args):
    from .bridge import _BACKENDS
    from .params import REFERENCE_COMPAT, EncoderConfig

    kw = dict(source_size=args.source, target_size=args.target,
              rms_threshold=args.rms, s_max=args.smax,
              use_classifier=not args.noclassifier, backend=_BACKENDS[args.backend])
    if args.compat:
        return REFERENCE_COMPAT(**kw)
    return EncoderConfig(criterion=args.criterion, so_mode=args.so_mode,
                         num_transforms=args.transforms, vq_classes=args.vq_classes, **kw)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _maybe_phase(timer, name):
    """Timer phase context, or a no-op when --log is off."""
    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def _encode_one_quadtree(plane, args, cfg, dcfg, label="", timer=None):
    """Quadtree-encode and decode one numpy u8 plane on ``args.device``,
    printing the leaves per level and the PSNR as the JAX CLI does; returns
    (QuadtreeResult, decoded numpy plane)."""
    from .core.metrics import psnr
    from .encode.quadtree import (QuadtreeConfig, decode_plane_quadtree,
                                  encode_plane_quadtree)
    from .utils.progress import NullReporter, StdoutReporter

    device = args.device
    reporter = StdoutReporter() if args.log else NullReporter()
    qcfg = QuadtreeConfig(min_size=args.qt_min, max_size=args.qt_max,
                          error_threshold=args.qt_threshold)
    t0 = time.perf_counter()
    with _maybe_phase(timer, f"encode{label}"):
        res = encode_plane_quadtree(plane, cfg, qcfg, reporter, device=device)
        _sync(device)
    print(f"encoded{label} in {time.perf_counter() - t0:.4g} s.")
    leaves = [int(l.accepted.sum()) for l in res.levels]
    print(f"{res.num_leaves} leaves "
          + " ".join(f"{l.range_size}px:{n}" for l, n in zip(res.levels, leaves)))

    t0 = time.perf_counter()
    with _maybe_phase(timer, f"decode{label}"):
        out, iters, mse = decode_plane_quadtree(res, dcfg)
        _sync(device)
    print(f"decoded{label} in {time.perf_counter() - t0:.4g} s.")
    print(f"decode stats: {iters} steps, rms: {mse:.6g}")
    plane_t = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.uint8))
    print(f"psnr: {float(psnr(plane_t, out.cpu())):.4f} dB")
    return res, out.cpu().numpy()


def _encode_one(plane, args, cfg, dcfg, label="", timer=None):
    """Encode and decode one numpy u8 plane on ``args.device``, printing the
    reference CLI's statistics; returns (EncodeResult, decoded numpy plane).
    ``timer`` (a PhaseTimer, with --log) times the encode and the decode."""
    if args.quadtree:
        return _encode_one_quadtree(plane, args, cfg, dcfg, label, timer)
    from .core.classify import classify_grid
    from .core.metrics import psnr
    from .decode import decode_plane, decode_steps_py
    from .encode import encode_plane
    from .encode.encoder import encode_stats

    device = args.device
    t0 = time.perf_counter()
    with _maybe_phase(timer, f"encode{label}"):
        res = encode_plane(plane, cfg, device=device)
        _sync(device)
    print(f"encoded{label} in {time.perf_counter() - t0:.4g} s.")
    print(f"{res.num_ranges} elements.")
    plane_t = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.uint8))
    if cfg.use_classifier and cfg.vq_classes == 0:
        # classifier rejection statistics (Encoder2.hpp:21-23), O(R + D);
        # brightness bins only, as in the JAX CLI
        st = encode_stats(res, classify_grid(plane_t, res.range_grid).numpy(),
                          classify_grid(plane_t, res.domain_grid).numpy())
        total, rejected = st["total_mappings"], st["rejected_mappings"]
        print(f"classifier rejected {rejected} out of {total} comparisons "
              f"({100.0 * rejected / total:.4g})%")

    if args.debug_decode:
        from .image import save_plane
        from .utils.progress import StdoutReporter

        rep = StdoutReporter() if args.log else None
        for i, img in decode_steps_py(res, dcfg, reporter=rep):
            save_plane(img.cpu().numpy(), f"decode_debug{i}.png")

    t0 = time.perf_counter()
    with _maybe_phase(timer, f"decode{label}"):
        out, iters, mse = decode_plane(res, dcfg)
        _sync(device)
    print(f"decoded{label} in {time.perf_counter() - t0:.4g} s.")
    print(f"decode stats: {iters} steps, rms: {mse:.6g}")
    print(f"psnr: {float(psnr(plane_t, out.cpu())):.4f} dB")
    _stats(res)
    return res, out.cpu().numpy()


def _stats(res):
    """Quantization statistics (cf. encode_data_statistics, main.cpp:106-140)."""
    from .codec.quantize import DEFAULT_O_BITS, DEFAULT_S_BITS, quantize

    s = res.s.cpu().numpy().astype(np.float64)
    o = res.o.cpu().numpy().astype(np.float64)
    print("----")
    print(f"grid element count: {len(s)}")
    print(f"contrast: {s.min():.6g}:{s.max():.6g}")
    print(f"brightness: {o.min():.6g}:{o.max():.6g}")
    sq = quantize(s, s.min(), s.max(), DEFAULT_S_BITS)
    oq = quantize(o, o.min(), o.max(), DEFAULT_O_BITS)
    print("contrast / brightness quantization: "
          f"{len(np.unique(sq))} {len(np.unique(oq))}")
    print("----")


def _decoder_config(args):
    from .params import DecoderConfig

    # --compat pins the strict reference decode: flat start, no stall exit
    return DecoderConfig(
        max_iterations=args.decode if args.decode > 0 else 300,
        epsilon=args.decode_rms,
        pyramid=not args.compat,
        stall_window=0 if args.compat else DecoderConfig.stall_window,
    )


def _decode_file(args, dcfg) -> int:
    """``--decode-file``: decode a bare FTC1 or FTQ1 plane or an FTCC
    container of three on ``args.device`` and save the image; exit 2 on a
    file that does not parse or decode."""
    from .codec import is_container, unpack_container, unpack_quadtree, unpack_result
    from .decode import decode_plane
    from .encode.quadtree import decode_plane_quadtree
    from .image import save_plane, save_yuv

    def decode_blob(blob):
        if blob[:4] == b"FTQ1":
            return decode_plane_quadtree(unpack_quadtree(blob, args.device), dcfg)
        return decode_plane(unpack_result(blob, args.device), dcfg)

    try:
        with open(args.decode_file, "rb") as f:
            data = f.read()
        blobs = unpack_container(data) if is_container(data) else [data]
        decoded = [decode_blob(b) for b in blobs]
    except Exception as e:  # struct.error / ValueError / truncated file
        print(f"error: not a valid bitstream: {args.decode_file} ({e})", file=sys.stderr)
        return 2
    planes = [out.cpu().numpy() for out, _, _ in decoded]
    if len(planes) == 3:
        save_yuv(*planes, args.result)  # cf. main.cpp:192-200
    else:
        save_plane(planes[0], args.result)
    for _, iters, mse in decoded:
        print(f"decoded {args.decode_file}: {iters} steps, rms {mse:.6g}")
    return 0


def _write_file(args, results) -> None:
    """``--out``: one bare FTC1 or FTQ1 plane, or three in an FTCC container,
    with o stored as each block's mean (``plane``); prints the size, its
    ratio to one byte per pixel and plane (the JAX CLI's line), and the rate
    in bits per pixel of the image."""
    from .codec import pack_container, pack_quadtree, pack_result

    pack = pack_quadtree if args.quadtree else pack_result
    blobs = [pack(res, plane=plane) for res, plane in results]
    blob = blobs[0] if len(blobs) == 1 else pack_container(blobs)
    with open(args.out, "wb") as f:
        f.write(blob)
    pixels = results[0][1].size
    raw = pixels * len(results)
    print(f"bitstream: {len(blob)} bytes ({raw / max(len(blob), 1):.1f}x)")
    print(f"bpp: {8 * len(blob) / pixels:.4f}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.input and not args.decode_file:
        print("no input image", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if args.backend == "pallas" and torch.device(args.device).type != "cuda":
        print(f"error: --backend pallas runs the CUDA kernels, which need --device "
              f"cuda, not --device {args.device}", file=sys.stderr)
        return 2
    dcfg = _decoder_config(args)
    if args.decode_file:
        return _decode_file(args, dcfg)
    try:
        cfg = _config_from_args(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)  # cf. main.cpp:99-102
        return 2

    from .image import load_planes, save_plane, save_yuv
    from .utils.profiling import PhaseTimer, device_trace

    timer = PhaseTimer() if args.log else None
    trace = (device_trace(args.profile, args.device) if args.profile
             else contextlib.nullcontext())
    total0 = time.perf_counter()
    with _maybe_phase(timer, "load"):
        y, u, v = load_planes(args.input)
    try:
        try:
            with trace:
                if args.color:
                    outs = [_encode_one(p, args, cfg, dcfg, f" [{name}]", timer)
                            for name, p in (("Y", y), ("U", u), ("V", v))]
                    save_yuv(*(out for _, out in outs), args.result)
                    results = [(res, p) for (res, _), p in zip(outs, (y, u, v))]
                else:
                    res, out = _encode_one(y, args, cfg, dcfg, timer=timer)
                    save_plane(out, args.result)
                    results = [(res, y)]
        finally:
            if args.profile:
                print(f"profile trace written to {args.profile}")
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.out:
        _write_file(args, results)
    if timer is not None:
        print("-- phases --")
        print(timer.report())
    print(f"total time: {time.perf_counter() - total0:.4g} s.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
