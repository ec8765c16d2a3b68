"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m codec_bench.calibrate --workload <cell> --seeds 12 --control-seeds 3
        [--seconds 2] [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds: the cell's pool from that seed, a short
window of requests at the cell's own load (``--seconds``), and the check's
numbers over ``harness.CHECK`` of them, as a run makes them (the sound
readings: their worst is each number's lower reading).  Then for each of
``--control-seeds`` further seeds: the control (``control.py``: the reference
in bfloat16 in the program's place) for the same requests, judged the same
way (the upper readings).  One JSON line a seed on standard output and in
``--out``.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import harness

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2_200_000_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = harness.resolve(args.workload, bench)
    keep = harness.CHECK
    out = open(args.out, "a") if args.out else None
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds + args.control_seeds)]
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        entry = harness.make_entry(cell, seed, "cuda")
        if k < args.seeds:
            harness.warm(entry)
            win = harness.requests(entry, args.seconds, keep, seed)
            numbers, frames = harness.judge(entry, win.kept)
            line = dict(side="program", seed=seed, requests=len(win.latencies),
                        failed=win.failed, numbers=numbers)
        else:
            frames = []
            for i in range(keep):
                frames += entry.judge(i, entry.control(i))
            numbers = harness.check.worst(frames)
            line = dict(side="control", seed=seed, numbers=numbers)
        line.update(cell=cell.name, frames=len(frames), seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
