"""Driver entry points (the counterpart of the JAX package's
``__graft_entry__.py``).

``entry()``                  — the single-plane encode step and its input.
``dryrun_multichip(n, ...)`` — one full sharded encode/decode sequence over
                               an n-device mesh at tiny shapes.
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """Returns (fn, example_args): the encode of one 512x512 plane under the
    flagship configuration (the default search), on ``device`` (default:
    the card; see ``encode.encoder.default_device``)."""
    from .encode.encoder import default_device, encode_plane
    from .params import EncoderConfig

    cfg = EncoderConfig()
    rng = np.random.default_rng(0)
    plane = torch.from_numpy(rng.integers(0, 256, size=(512, 512), dtype=np.uint8))
    plane = plane.to(default_device(device))

    def fn(p):
        res = encode_plane(p, cfg)
        return res.domain_idx, res.transform, res.s, res.o, res.distance

    return fn, (plane,)


def _equal(a, b, what: str) -> None:
    if not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"dryrun_multichip: {what} differ")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one full sharded encode/decode sequence on an ``n_devices``-device
    mesh over ``devices`` (default: every visible card; a list may repeat
    one device, e.g. ``[torch.device("cpu")] * 8``), at tiny shapes: the
    three search strategies (held equal), the halo-sharded plane with the
    replicated and the ring-streamed codebook (held equal), the flat and the
    pyramid decode, and the quadtree batch encode (its coverage mask must
    engage) and decode."""
    from .params import DecoderConfig, EncoderConfig
    from .parallel import (decode_batch_sharded, encode_batch_sharded,
                           encode_plane_sharded_image, make_mesh)
    from .encode.quadtree import (QuadtreeConfig, decode_batch_quadtree_sharded,
                                  encode_batch_quadtree_sharded)

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=, e.g. "
                               "[torch.device('cpu')] * n_devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n_devices:
        raise ValueError(f"{len(devices)} devices for a {n_devices}-device mesh")
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_search = n_devices // n_data
    mesh = make_mesh(n_data, n_search, devices)

    cfg = EncoderConfig(source_size=16, target_size=4)
    rng = np.random.default_rng(0)
    # tiny shapes: enough ranges (16x16 = 256) to split over the search axis
    imgs = rng.integers(0, 256, size=(n_data, 64, 64), dtype=np.uint8)
    results = encode_batch_sharded(imgs, cfg, mesh, strategy="ranges")
    results_d = encode_batch_sharded(imgs, cfg, mesh, strategy="domains")
    results_r = encode_batch_sharded(imgs, cfg, mesh, strategy="ring")
    for a, b, c in zip(results, results_d, results_r):
        _equal(a.domain_idx, b.domain_idx, "ranges and domains winners")
        _equal(a.domain_idx, c.domain_idx, "ranges and ring winners")
    # the halo-exchange single-image row sharding (BASELINE config 4's
    # mechanics), with the codebook replicated and ring-streamed
    halo_mesh = make_mesh(1, n_search, devices[:n_search])
    img_tall = rng.integers(0, 256, size=(32 * n_search, 64), dtype=np.uint8)
    res_halo = encode_plane_sharded_image(img_tall, cfg, halo_mesh)
    res_halo_ring = encode_plane_sharded_image(img_tall, cfg, halo_mesh, codebook="ring")
    _equal(res_halo.domain_idx, res_halo_ring.domain_idx, "halo replicate and ring winners")
    # the data-parallel fixed-point decode, flat and coarse-to-fine
    _, iters, _ = decode_batch_sharded(results, mesh, max_iterations=5)
    decode_batch_sharded(results, mesh, pyramid=True)
    # the quadtree: smooth ramps, so coarse levels accept and the coverage
    # mask of the finer levels engages (noise would leave it all False)
    qcfg = QuadtreeConfig(min_size=4, max_size=16)
    ys, xs = np.mgrid[0:64, 0:64]
    ramp = ((xs * 2 + ys) % 256).astype(np.uint8)
    qimgs = np.stack([ramp, ramp[::-1].copy()])[:n_data]
    if qimgs.shape[0] < n_data:
        qimgs = np.tile(qimgs, (n_data, 1, 1))[:n_data]
    qres = encode_batch_quadtree_sharded(qimgs, cfg, qcfg, mesh)
    if int(qres[0].levels[0].accepted.sum()) == 0:
        raise AssertionError("dryrun_multichip: the coverage mask never engaged")
    _, qiters, _ = decode_batch_quadtree_sharded(qres, mesh, DecoderConfig(max_iterations=5))
    print(f"dryrun_multichip ok: mesh={mesh.shape} imgs={imgs.shape} "
          "strategies=ranges/domains/ring/halo "
          f"decode_iters={iters.tolist()} quadtree_decode_iters={qiters.tolist()}")
