"""Run one cell of the benchmark once, on the card this process sees.

    python3 -m codec_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each number
the comparison judged beside its limit, which also end standard error.
Exits 1 with no result where there is no card, or where a module of JAX or
of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "fractencode_tpu")
ROOT = Path(__file__).resolve().parent


def fail(msg: str) -> int:
    print(f"codec_bench: {msg}", file=sys.stderr, flush=True)
    return 1


def loaded_banned() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def end_to_end(name: str, kind: str, win, setup_s: float, mpix_done: float):
    """The value of an end-to-end metric: ``setup_s``, ``<kind>_mpix_s``
    (megapixels of the window's completed requests over its seconds) or
    ``<kind>_p<q>_ms`` (the q-th percentile of every request's latency)."""
    import numpy as np

    if name == "setup_s":
        return setup_s
    if name == f"{kind}_mpix_s":
        return mpix_done / win.seconds
    if name.startswith(f"{kind}_p") and name.endswith("_ms"):
        q = float(name[len(kind) + 2:-3])
        return 1e3 * float(np.percentile(win.latencies, q))
    raise KeyError(f"{name}: not an end-to-end metric of an {kind} cell")


def measure(cell, seed: int, seconds: float, traced: int, device, chips: int = 1):
    """One run of ``cell`` on ``device`` after the look for a card: set-up,
    the window, the metrics and the check.  Returns (the result's object,
    the numbers compared, their limits)."""
    import torch

    from . import check, harness, trace

    cuda = device.type == "cuda"
    entry = harness.make_entry(cell, seed, device)
    if cuda:  # the peak is the program's: warm-up and window, not the inputs' generation
        torch.cuda.reset_peak_memory_stats(device)
    harness.warm(entry)
    setup_s = time.perf_counter() - T_START
    keep = harness.CHECK
    if traced:
        win = harness.traced_requests(entry, min(seconds, cell.traffic["trace_seconds"]),
                                      keep, seed)
    else:
        win = harness.requests(entry, seconds, keep, seed)
    done = len(win.latencies) - win.failed
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    if traced:
        ctx = trace.Context(kind=entry.kind, trace=win.trace, requests=len(win.latencies),
                            mpix=len(win.latencies) * entry.mpix, calls=win.calls,
                            syncs=win.syncs, search_bound_s=win.bound_s)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], entry.kind, win, setup_s,
                                                    done * entry.mpix),
                               "unit": m["unit"]} for m in cell.end_to_end}

    # the check runs once the window has closed and the peak is read
    kept = win.kept
    del win.kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, _ = harness.judge(entry, kept)
    limits = cell.config["limits"]
    numbers = {k: numbers.get(k, math.nan) for k in check.NUMBERS[entry.check_kind]}
    correct = (check.verdict(numbers, {k: limits[k] for k in numbers})
               and win.failed == 0 and done > 0)
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(win.latencies), "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info.update(busy_s=win.trace.busy_s(), window_s=win.trace.window_s)
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": limits[k]}
                        for k, v in numbers.items()}
    return result, numbers, limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        return fail("no CUDA device: the benchmark runs on the card only")
    try:
        import fractencode_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(f"the program is not in this checkout: {exc}")

    from . import harness

    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = harness.resolve(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == cell.name)
    if torch.cuda.device_count() < chips:
        return fail(f"{cell.name} needs {chips} cards, {torch.cuda.device_count()} seen")
    result, numbers, limits = measure(cell, args.seed, args.seconds, args.trace,
                                      torch.device("cuda", 0), chips)
    found = loaded_banned()
    if found:
        return fail(f"JAX or the JAX package loaded: {', '.join(found)}")
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT.parent / "build" / "triton"))
    sys.exit(main())
