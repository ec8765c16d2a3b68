"""Host tables kept on the device.

The encode and the decode read small index tables built on the host from the
geometry alone (tap offsets, grid origins, the classifier's order-code
table).  Each is uploaded once for each (build function, arguments, dtype, device)
and kept, so an encode or a decode copies nothing from the host: a CUDA
graph (``utils.graphs``) cannot capture such a copy.  The numpy build functions keep
their own ``functools.lru_cache``; this cache holds the uploads.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

__all__ = ["device_table", "recorded", "clear"]

# tables kept at once (a few for each geometry); the least recently used is
# dropped.  A CUDA graph keeps the tables it reads (``recorded``), so a
# dropped table's memory stays valid while a graph reads it.
_MAX_TABLES = 64

_TABLES: collections.OrderedDict = collections.OrderedDict()
_RECORDERS: list = []


def _resolve(device) -> torch.device:
    """``device`` as a torch.device, a card given its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_table(build, *args, device, dtype=torch.int64) -> torch.Tensor:
    """``build(*args)`` (a numpy array; ``build`` a module-level function of
    hashable arguments) as a ``dtype`` tensor on ``device``, built and
    uploaded on the first call and the same tensor on every later one while
    it is kept.  Callers only read it."""
    key = (build, args, dtype, _resolve(device))
    table = _TABLES.pop(key, None)
    if table is None:
        table = torch.as_tensor(np.asarray(build(*args)), dtype=dtype, device=key[3])
        while len(_TABLES) >= _MAX_TABLES:
            _TABLES.popitem(last=False)
    _TABLES[key] = table
    for tables in _RECORDERS:
        tables[key] = table
    return table


@contextlib.contextmanager
def recorded(tables: dict | None = None):
    """A dict of the tables ``device_table`` returns inside the block, by
    key.  ``tables`` (such a dict) go back into the cache first, so a block
    that reads no others uploads nothing."""
    tables = dict(tables or {})
    _TABLES.update(tables)
    _RECORDERS.append(tables)
    try:
        yield tables
    finally:
        _RECORDERS.remove(tables)


def clear() -> None:
    """Drop every table."""
    _TABLES.clear()
