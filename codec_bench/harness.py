"""The benchmark's general harness, driven by data.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` resolves to
``configs/<config>.json`` (the deployment: encoder, decoder and quadtree
settings, the comparison's limits) and ``traffic/<traffic>.json`` (the
entry form, the plane size, the batch, the pool of distinct inputs, how
many ranges a frame the check searches in full, and how long the trace
runs).  Each per-layer metric
is read by ``metrics/<name>.py``'s ``read(ctx)``.  A later cell, mix or
metric is added by adding such files and entries.

A run: make the pool of inputs from the seed on the device and hand it to
the host once; warm the entry on the cell's own shapes; run requests one
after another (a closed loop, one client) for the window; check a sample of
the window's results, drawn from the seed, against the plain reference.
A request starts when the host calls the entry with its input in host memory
and ends when the outputs a consumer reads are in host memory.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import random
import re
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from . import arith, check, control, planes, trace
from .reference import blocks

ROOT = Path(__file__).resolve().parent
# the arrays a bitstream packer reads (codec/bitstream.py, bitstream_quadtree.py)
ENCODE_FIELDS = ("domain_idx", "transform", "s", "o")
LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "accepted")
# requests before the window: a graph key's first call runs eagerly, its
# second captures, later ones replay
WARM = 4
# requests of the window the check judges, a sample drawn from the seed
CHECK = 2


# ---------------------------------------------------------------------------
# cells


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    readers: dict  # per-layer metric name -> read(ctx)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "codec_bench.metrics." + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(name: str, bench: dict, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark ``bench``, its files under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=per_layer,
                readers={m["name"]: _reader(root / "metrics" / f"{m['name']}.py")
                         for m in per_layer})


# ---------------------------------------------------------------------------
# entry forms


class Entry:
    """One entry form of the program: its inputs (a pool from the seed, cut
    into requests), its call, and the check of its outputs."""

    kind = "encode"  # what the window's requests do
    check_kind = "encode"  # which numbers judge them (check.NUMBERS)

    def __init__(self, cell: Cell, seed: int, device):
        import fractencode_tpu_torch as T

        self.T, self.device, self.seed = T, torch.device(device), seed
        self._buffers: dict = {}
        self.config, self.traffic = cell.config, cell.traffic
        self.enc = self.config["encoder"]
        self.cfg = T.EncoderConfig(**self.enc)
        unjudged = check.unjudged(self.cfg)
        if unjudged:
            raise ValueError(f"{cell.name}: the plain reference cannot judge this "
                             f"configuration: {'; '.join(unjudged)}")
        tr = self.traffic
        self.batch, self.size = tr["batch"], tr["size"]
        gen = planes.generator(seed, self.device)
        pool = planes.natural_planes(tr["pool"], self.size, gen, self.device)
        self.requests_in_pool = tr["pool"] // self.batch
        self.pool = pool.cpu().numpy()
        self._make_inputs(pool)

    def _make_inputs(self, pool):
        b = self.batch
        self.inputs = [np.ascontiguousarray(self.pool[j * b:(j + 1) * b])
                       for j in range(self.requests_in_pool)]

    def frames(self, i: int) -> range:
        j = i % self.requests_in_pool
        return range(j * self.batch, (j + 1) * self.batch)

    @property
    def mpix(self) -> float:
        return self.batch * self.size * self.size / 1e6

    def call(self, i: int):
        """One request: (the program's result on the device, the outputs in
        host memory)."""
        raise NotImplementedError

    def finish(self, result, host: dict) -> dict:
        """The rest of a kept request's outputs, for the check (after the
        window)."""
        return host

    def judge(self, i: int, outputs: dict) -> list[dict]:
        """The check's numbers of each frame of request ``i``."""
        raise NotImplementedError

    def control(self, i: int) -> dict:
        """Request ``i``'s outputs from the control, as ``finish`` gives the
        program's."""
        raise NotImplementedError

    def bound_s(self, i: int, host: dict) -> float:
        """The least seconds of request ``i``'s searches: ``arith.bound_s`` of
        the pairs its classes need (rows x columns without the classifier)."""
        return 0.0

    def _plane(self, f: int) -> torch.Tensor:
        return torch.from_numpy(self.pool[f]).to(self.device)

    def _to_host(self, key, x: torch.Tensor) -> torch.Tensor:
        """``x`` copied into this request's host buffer ``key``: pinned
        memory on a card's machine, allocated at the first call (in the
        warm-up) and reused, as a consumer that packs results reuses its
        buffers; a fresh pageable buffer each request pays page faults whose
        cost swings from run to run."""
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(x.shape, dtype=x.dtype,
                                                   pin_memory=self.device.type == "cuda")
        return buf.copy_(x)

    def _gap_rows(self, i: int, f: int, r: int):
        k = self.traffic.get("gap_ranges")
        if not k or k >= r:
            return None
        g = torch.Generator().manual_seed((self.seed * 1000003 + i * 1009 + f) % (1 << 63))
        return torch.randperm(r, generator=g)[:k].to(self.device)


def _dev(x: dict, device) -> dict:
    return {k: v.to(device) for k, v in x.items()}


class _GridEncode(Entry):
    def finish(self, result, host):
        return dict(host, distance=result.distance.cpu(), valid=result.valid.cpu())

    def _rows(self, outputs: dict, k: int) -> dict:
        return {f: v[k] if v.dim() > 1 else v for f, v in outputs.items()}

    def judge(self, i, outputs):
        r = (self.size // self.enc["target_size"]) ** 2
        return [check.grid_frame(self._plane(f), _dev(self._rows(outputs, k), self.device),
                                 self.enc, self._gap_rows(i, f, r))
                for k, f in enumerate(self.frames(i))]

    def control(self, i):
        outs = [control.grid(self._plane(f), self.enc) for f in self.frames(i)]
        return {k: torch.stack([o[k] for o in outs]).cpu() for k in outs[0]}

    def bound_s(self, i, host):
        total = 0.0
        tw, sw = self.enc["target_size"], self.enc["source_size"]
        n = tw * tw
        classed = self.enc.get("use_classifier", True)
        for f in self.frames(i):
            plane = self._plane(f)
            rcls = blocks.search_classes(plane, tw, tw, classed)
            dcls = blocks.search_classes(plane, sw, sw // self.enc["lattice"], classed)
            ccls = dcls.repeat_interleave(self.enc["num_transforms"])
            nbytes = arith.search_bytes(rcls.numel(), ccls.numel(), arith.width(n), False)
            total += arith.bound_s(arith.needed_pairs(rcls, ccls), n, nbytes)
        return total


class EncodePlane(_GridEncode):
    """``encode_plane`` of one [H, W] plane a request."""

    def call(self, i):
        res = self.T.encode_plane(self.inputs[i % self.requests_in_pool][0], self.cfg,
                                  device=self.device)
        return res, {f: self._to_host(f, getattr(res, f)) for f in ENCODE_FIELDS}


class EncodeBatch(_GridEncode):
    """``encode_batch_stacked`` of a [B, H, W] batch a request."""

    def call(self, i):
        res = self.T.encode_batch_stacked(self.inputs[i % self.requests_in_pool], self.cfg,
                                          device=self.device)
        return res, {f: self._to_host(f, getattr(res, f)) for f in ENCODE_FIELDS}


class QuadtreeBatch(Entry):
    """``encode_batch_quadtree_stacked`` of a [B, H, W] batch a request."""

    check_kind = "quadtree"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from fractencode_tpu_torch.encode import quadtree

        self.qt = self.config["quadtree"]
        self.quadtree = quadtree
        self.qcfg = quadtree.QuadtreeConfig(**self.qt)

    def call(self, i):
        res = self.quadtree.encode_batch_quadtree_stacked(
            self.inputs[i % self.requests_in_pool], self.cfg, self.qcfg, device=self.device)
        return res, {"levels": [{f: self._to_host((k, f), getattr(l, f)) for f in LEVEL_FIELDS}
                                for k, l in enumerate(res.levels)]}

    def finish(self, result, host):
        return {"levels": [dict(h, error=l.error.cpu())
                           for h, l in zip(host["levels"], result.levels)]}

    def judge(self, i, outputs):
        return [check.quadtree_frame(self._plane(f),
                                     [_dev({k: v[j] for k, v in l.items()}, self.device)
                                      for l in outputs["levels"]], self.enc, self.qt,
                                     self.config["leaf_band"])
                for j, f in enumerate(self.frames(i))]

    def control(self, i):
        frames = [control.quadtree(self._plane(f), self.enc, self.qt) for f in self.frames(i)]
        return {"levels": [{k: torch.stack([fr[l][k] for fr in frames]).cpu()
                            for k in frames[0][l]} for l in range(len(frames[0]))]}

    def bound_s(self, i, host):
        total = 0.0
        t_count = self.enc["num_transforms"]
        classed = self.enc.get("use_classifier", True)
        for j, f in enumerate(self.frames(i)):
            plane = self._plane(f)
            covered = None
            for l, level in enumerate(host["levels"]):
                rs = self.qt["max_size"] >> l
                ds = rs * self.qt["domain_ratio"]
                rcls = blocks.search_classes(plane, rs, rs, classed)
                dcls = blocks.search_classes(plane, ds, ds // self.qt["lattice"], classed)
                ccls = dcls.repeat_interleave(t_count)
                rows = rcls if covered is None else rcls[~covered.reshape(-1)]
                acc = level["accepted"][j].to(self.device).reshape(
                    self.size // rs, self.size // rs)
                total += arith.bound_s(arith.needed_pairs(rows, ccls), rs * rs,
                                       arith.search_bytes(rows.numel(), ccls.numel(),
                                                          arith.width(rs * rs), False))
                covered = acc if covered is None else covered | acc
                covered = covered.repeat_interleave(2, 0).repeat_interleave(2, 1)
        return total


class DecodeBatch(Entry):
    """``decode_batch_stacked`` of B frames' maps a request (pyramid mode)."""

    kind = check_kind = "decode"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.dcfg = self.T.DecoderConfig(**self.config["decoder"])
        d = self.config["decoder"]
        self.geometry = dict(height=self.size, width=self.size, sw=self.enc["source_size"],
                             tw=self.enc["target_size"],
                             st=self.enc["source_size"] // self.enc["lattice"],
                             coarse_steps=d["pyramid_steps"], full_steps=d["pyramid_full_steps"],
                             initial=d["initial_value"])

    def _make_inputs(self, pool):
        maps = [planes.searched_maps(p, self.enc) for p in pool]
        self.maps = [{k: v.cpu() for k, v in m.items()} for m in maps]
        if self.device.type == "cuda":
            # the search's matmuls left cuBLAS's workspace in the allocator,
            # where it would count in the program's peak
            torch._C._cuda_clearCublasWorkspaces()
        b = self.batch

        def stacked(j: int, k: str) -> torch.Tensor:
            # a viewer's maps, read from files into (pinned) host memory once
            x = torch.stack([m[k] for m in self.maps[j * b:(j + 1) * b]])
            return x.pin_memory() if self.device.type == "cuda" else x

        self.inputs = [{k: stacked(j, k) for k in self.maps[0]}
                       for j in range(self.requests_in_pool)]
        self.t_count = self.enc["num_transforms"]

    def call(self, i):
        x = self.inputs[i % self.requests_in_pool]
        res = self.T.EncodeResult(
            **{k: v.to(self.device) for k, v in x.items()}, distance=None,
            width=self.size, height=self.size, source_size=self.enc["source_size"],
            target_size=self.enc["target_size"],
            domain_step=self.enc["source_size"] // self.enc["lattice"],
            num_transforms=self.enc["num_transforms"])
        pixels, _, _ = self.T.decode_batch_stacked(res, self.dcfg)
        return pixels, {"pixels": self._to_host("pixels", pixels)}

    def _maps(self, f: int) -> dict:
        return dict(_dev(self.maps[f], self.device), t_count=self.t_count)

    def judge(self, i, outputs):
        return [check.decode_frame(self._maps(f), outputs["pixels"][k].to(self.device),
                                   self.geometry)
                for k, f in enumerate(self.frames(i))]

    def control(self, i):
        return {"pixels": torch.stack([control.decode(self._maps(f), self.geometry)
                                       for f in self.frames(i)]).cpu()}


ENTRIES = {"encode_plane": EncodePlane, "encode_batch_stacked": EncodeBatch,
           "encode_batch_quadtree_stacked": QuadtreeBatch,
           "decode_batch_stacked": DecodeBatch}


def make_entry(cell: Cell, seed: int, device) -> Entry:
    return ENTRIES[cell.traffic["entry"]](cell, seed, device)


# ---------------------------------------------------------------------------
# the window


@dataclasses.dataclass
class Window:
    latencies: list  # seconds of each request
    seconds: float  # from the first request's start to the last one's end
    failed: int
    kept: dict  # request index -> (result, host outputs), a sample from the seed
    bound_s: float = 0.0
    trace: trace.Trace | None = None
    calls: collections.Counter | None = None
    syncs: int = 0


def warm(entry: Entry) -> None:
    """Run the entry on its own shapes until its graphs replay: the first
    call of a key runs eagerly, the second captures, later ones replay."""
    for i in range(WARM):
        entry.call(i)
    _sync(entry.device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _own(host):
    """A copy of a request's host outputs, which the next request's copies
    overwrite."""
    if isinstance(host, dict):
        return {k: _own(v) for k, v in host.items()}
    if isinstance(host, list):
        return [_own(v) for v in host]
    return host.clone()


def requests(entry: Entry, seconds: float, keep: int, seed: int,
             hold=None) -> Window:
    """Requests one after another until ``seconds`` have passed; keeps
    ``keep`` of them (a uniform sample, drawn from the seed); ``hold(i,
    host)`` sees every request's host outputs."""
    rng = random.Random(seed)
    lat, kept, failed, i = [], {}, 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            result, host = entry.call(i)
        except Exception as exc:  # a failed request counts, and the run goes on
            failed += 1
            result = host = None
            print(f"request {i} failed: {exc!r}", flush=True, file=sys.stderr)
        te = time.perf_counter()
        lat.append(te - ts)
        if host is not None:
            if hold is not None:
                hold(i, host)
            if len(kept) < keep:
                kept[i] = (result, _own(host))
            else:
                r = rng.randrange(i + 1)
                if r < keep:
                    kept.pop(sorted(kept)[r])
                    kept[i] = (result, _own(host))
        i += 1
        if te - t0 >= seconds:
            return Window(lat, te - t0, failed, kept)


def traced_requests(entry: Entry, seconds: float, keep: int, seed: int) -> Window:
    """``requests`` under torch.profiler and torch's sync debug mode, with
    ``utils.graphs.calls`` counted over the window and the least seconds of
    the window's searches."""
    from fractencode_tpu_torch.utils import graphs

    firsts: dict = {}
    counts = collections.Counter()

    def hold(i, host):
        j = i % entry.requests_in_pool
        counts[j] += 1
        if j not in firsts:
            firsts[j] = (i, _own(host))

    before = collections.Counter(graphs.calls)
    cuda = entry.device.type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            win, tr = trace.capture(lambda: requests(entry, seconds, keep, seed, hold))
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    win.trace = tr
    win.calls = collections.Counter(graphs.calls)
    win.calls.subtract(before)
    win.calls = +win.calls
    win.syncs = sum("synchroniz" in str(w.message) for w in caught)
    win.bound_s = sum(counts[j] * entry.bound_s(i, host) for j, (i, host) in firsts.items())
    return win


def judge(entry: Entry, kept: dict) -> tuple[dict, list]:
    """The worst of each number over the kept requests' frames."""
    frames = []
    for i in sorted(kept):
        result, host = kept[i]
        frames += entry.judge(i, entry.finish(result, host))
    return check.worst(frames), frames
