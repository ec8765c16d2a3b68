"""Device mesh (port of ``fractencode_tpu/parallel/mesh.py``).

A ``Mesh`` is a [n_data, n_search] grid of ``torch.device`` driven by one
controller, as ``shard_map`` drives every local device of a host:

  * ``data``   — independent images (the batch): the pure data-parallel
    axis, and the one that spans processes (``parallel.distributed``);
  * ``search`` — within one image, range tiles or domain-codebook shards
    (see ``sharded.py``).

The collectives of the sharded functions are explicit tensor moves between
these devices (``all_gather``: a concatenation of ``.to(device)`` copies in
shard order; ``ppermute``: a rotation of the list of shard tensors).  A
Python loop over the shards enqueues their launches (on the card, their
steps' graph replays, ``sharded.py``) asynchronously, so on several cards
the shards overlap.  A device may appear more than once when
the caller passes the list (``devices=[torch.device("cuda:0")] * 8``), the
counterpart of the JAX package's virtual CPU devices: the shards then share
it and run one after another.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Mesh", "make_mesh", "DATA_AXIS", "SEARCH_AXIS"]

DATA_AXIS = "data"
SEARCH_AXIS = "search"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """[n_data][n_search] devices; ``devices[i][j]`` holds data shard i's
    search shard j."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), SEARCH_AXIS: len(self.devices[0])}

    def frame_devices(self, batch: int) -> list[tuple[torch.device, ...]]:
        """The search devices of each frame of a batch: frame i goes to data
        shard i // (batch / n_data), as a batch sharded over 'data'."""
        n_data = len(self.devices)
        if batch % n_data:
            raise ValueError(f"batch {batch} does not split evenly over {n_data} data shards")
        return [self.devices[i // (batch // n_data)] for i in range(batch)]


def make_mesh(n_data: int = 1, n_search: int | None = None, devices=None) -> Mesh:
    """Build a (data, search) mesh over ``devices`` (default: every visible
    card, each once; never the CPU unless the list names it), row-major:
    the first ``n_search`` devices are data shard 0's."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=, e.g. "
                               "[torch.device('cpu')] * 8, to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_search is None:
        n_search = len(devices) // n_data
    if n_data * n_search > len(devices):
        raise ValueError(f"mesh {n_data}x{n_search} exceeds {len(devices)} devices")
    if n_data < 1 or n_search < 1:
        raise ValueError(f"mesh {n_data}x{n_search} has no device")
    return Mesh(tuple(tuple(devices[i * n_search:(i + 1) * n_search])
                      for i in range(n_data)))
