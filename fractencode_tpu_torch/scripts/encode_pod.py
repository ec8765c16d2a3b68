"""Pod-scale batch encode driver (BASELINE config 5; port of
``scripts/encode_pod.py``).

Runs the multi-image batch encode and the fixed-point decode over a
(data x search) device mesh, in one process or in many (SPMD: the same
command once per process), and reports frames/s and checksums.

One process (on the card; ``--device cpu`` for the CPU):

    python -m fractencode_tpu_torch.scripts.encode_pod --batch 16 --size 512

Several processes, here two on one host (the same command on every host,
each with its own ``--process-id``; the data axis spans the processes):

    python -m fractencode_tpu_torch.scripts.encode_pod --batch 8 --size 512 \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 &
    python -m fractencode_tpu_torch.scripts.encode_pod --batch 8 --size 512 \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 1

The encode is ``parallel.sharded.encode_batch_sharded``: the mesh's ``data``
axis spans the processes (each encodes its own slice of the batch), the
``search`` axis stays inside a process, on the devices ``--device`` and
``--shards`` name.  The processes exchange host-side results only, over
gloo (``parallel.distributed``): the per-process batch split and the
checksums, exact int64 sums of every frame's domain and transform indices
(``checksum``) and decoded pixels (``decode checksum``), equal for any
process count.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..parallel.sharded import STRATEGIES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16,
                   help="GLOBAL batch size (must divide evenly over processes)")
    p.add_argument("--size", type=int, default=512, help="square frame size")
    p.add_argument("--image", default=None,
                   help="replicate this image (tiled to --size) as the batch "
                        "(default: random frames)")
    p.add_argument("--strategy", choices=STRATEGIES, default="ranges")
    p.add_argument("--n-data", type=int, default=None,
                   help="mesh data-axis size (default: one per process, or the "
                        "device count if that leaves no search axis)")
    p.add_argument("--reps", type=int, default=3, help="timing repetitions")
    p.add_argument("--decode", action="store_true",
                   help="also run the sharded fixed-point decode")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the card) or 'cpu'")
    p.add_argument("--shards", type=int, default=None,
                   help="mesh devices of this process: --device repeated this "
                        "many times, its shards then sharing it (default: every "
                        "visible card once, or one CPU device)")
    # multi-process bring-up (also honours MASTER_ADDR/MASTER_PORT, WORLD_SIZE
    # and RANK)
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--init-timeout", type=float, default=None,
                   help="seconds to wait for the other processes before failing")
    return p


def resolve_mesh_shape(n_devices: int, n_hosts: int, n_data: int | None):
    """(n_data, n_search) for the global mesh."""
    if n_data is None:
        n_data = n_hosts if n_devices > n_hosts else n_devices
    if n_devices % n_data:
        raise ValueError(f"--n-data {n_data} does not divide {n_devices} devices")
    return n_data, n_devices // n_data


def load_frames(args, per_host: int) -> np.ndarray:
    """--image tiled to --size, or the JAX script's random frame; repeated
    over this process's frames."""
    if args.image:
        from ..image import load_gray

        base = np.asarray(load_gray(args.image))
        reps = -(-args.size // min(base.shape))
        base = np.tile(base, (reps, reps))[: args.size, : args.size]
    else:
        base = np.random.default_rng(0).integers(0, 256, size=(args.size, args.size),
                                                 dtype=np.uint8)
    return np.stack([base] * per_host)


def _local_devices(args) -> list[torch.device]:
    if args.shards is not None:
        return [torch.device(args.device)] * args.shards
    if torch.device(args.device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(args.device)]


def _synchronize(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2

    import torch.distributed as dist

    from ..params import EncoderConfig
    from ..parallel import decode_batch_sharded, encode_batch_sharded, make_mesh
    from ..parallel.distributed import host_local_batch, initialize_multihost, is_multihost

    if args.coordinator or args.num_processes or os.environ.get("MASTER_ADDR"):
        info = initialize_multihost(args.coordinator, args.num_processes,
                                    args.process_id, args.init_timeout)
        print(f"multihost up: {info}")
    multi = is_multihost()
    rank, n_hosts = (dist.get_rank(), dist.get_world_size()) if multi else (0, 1)

    def reduce(x, op="sum"):
        """An exact reduction over the processes (gloo, CPU int64 or f64)."""
        t = torch.tensor([x], dtype=torch.int64 if isinstance(x, int) else torch.float64)
        if multi:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return t.item()

    devices = _local_devices(args)
    n_data, n_search = resolve_mesh_shape(len(devices) * n_hosts, n_hosts, args.n_data)
    if n_data % n_hosts:
        raise ValueError(f"--n-data {n_data} does not split over {n_hosts} processes")
    mesh = make_mesh(n_data // n_hosts, n_search, devices)
    cfg = EncoderConfig()

    per_host, _ = host_local_batch(args.batch)
    local = torch.from_numpy(load_frames(args, per_host))

    def encode():
        out = encode_batch_sharded(local, cfg, mesh, args.strategy)
        _synchronize(devices)
        return out

    results = encode()  # warmup (builds and loads the kernels)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        results = encode()
        times.append(reduce(time.perf_counter() - t0, "max"))
    dt = min(times)
    frames_s = args.batch / dt
    mpix_s = frames_s * args.size * args.size / 1e6
    chk = reduce(sum(int(r.domain_idx.sum(dtype=torch.int64)) +
                     int(r.transform.sum(dtype=torch.int64)) for r in results))
    shape = {"data": n_data, "search": n_search}
    if rank == 0:
        print(f"encode: {args.batch}x{args.size}^2 strategy={args.strategy} "
              f"mesh={shape} hosts={n_hosts}: "
              f"{dt:.4f} s -> {frames_s:.2f} frames/s, {mpix_s:.1f} Mpix/s")
        print(f"checksum: {chk}")

    if args.decode:
        decode_batch_sharded(results, mesh)  # warmup
        _synchronize(devices)
        t0 = time.perf_counter()
        outs, iters, _ = decode_batch_sharded(results, mesh)
        _synchronize(devices)
        dt = reduce(time.perf_counter() - t0, "max")
        iters_sum = reduce(int(iters.sum(dtype=torch.int64)))
        out_chk = reduce(int(outs.sum(dtype=torch.int64)))
        if rank == 0:
            print(f"decode: {dt:.4f} s -> {args.batch / dt:.2f} frames/s "
                  f"(mean iters={iters_sum / args.batch:.1f})")
            print(f"decode checksum: {out_chk}")
    if multi:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
