"""Carry encodes and configs across the two packages as plain numpy data.

The JAX package's ``EncodeResult`` and ``QuadtreeResult`` become this
package's (and back) through numpy arrays plus their static fields, so
either package decodes the other's encodes; a batch form's stacked result
(arrays with a leading [B] axis) crosses the same way.  Nothing here imports
jax: the JAX side is handed over as numpy arrays and dicts
(``dataclasses.asdict`` of its configs).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encode.encoder import ARRAY_FIELDS, EncodeResult, default_device
from .encode.quadtree import LEVEL_ARRAY_FIELDS, QuadtreeLevel, QuadtreeResult
from .params import DecoderConfig, EncoderConfig

__all__ = ["ARRAY_FIELDS", "META_FIELDS", "LEVEL_ARRAY_FIELDS",
           "LEVEL_META_FIELDS", "result_from_numpy", "result_to_numpy",
           "quadtree_from_numpy", "quadtree_to_numpy", "config_from_jax_fields"]

META_FIELDS = ("width", "height", "source_size", "target_size", "domain_step",
               "o_is_mean", "num_transforms")
LEVEL_META_FIELDS = ("range_size", "domain_size", "domain_step", "o_is_mean",
                     "num_transforms")
_DTYPES = dict(domain_idx=np.int32, transform=np.int32, s=np.float32,
               o=np.float32, distance=np.float32, valid=np.bool_,
               error=np.float32, accepted=np.bool_)


def _tensors(arrays, names, device):
    device = default_device(device)
    return {name: torch.from_numpy(np.array(arrays[name], dtype=_DTYPES[name]))
            .to(device) for name in names}

# the JAX package's backend names -> this package's
_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def result_from_numpy(arrays, meta, device=None) -> EncodeResult:
    """EncodeResult on ``device`` (default: the card, see
    ``encoder.default_device``) from per-range arrays, [R] or stacked [B, R]
    (any array-likes, e.g. ``np.asarray`` of the JAX result's fields), and
    its static fields."""
    return EncodeResult(**_tensors(arrays, ARRAY_FIELDS, device),
                        **{name: meta[name] for name in META_FIELDS if name in meta})


def result_to_numpy(res: EncodeResult):
    """(arrays, meta): numpy arrays of the per-range fields ([R], or [B, R]
    for a stacked result) and a dict of the static fields, enough to rebuild
    either package's EncodeResult."""
    arrays = {name: getattr(res, name).cpu().numpy() for name in ARRAY_FIELDS}
    meta = {name: getattr(res, name) for name in META_FIELDS}
    return arrays, meta


def quadtree_from_numpy(levels, width: int, height: int,
                        device=None) -> QuadtreeResult:
    """QuadtreeResult on ``device`` (default: the card, see
    ``encoder.default_device``) from one (arrays, meta) pair per level,
    coarse to fine, as ``quadtree_to_numpy`` gives them (any array-likes,
    e.g. ``np.asarray`` of the JAX levels' fields; [R_l], or [B, R_l] for a
    stacked result)."""
    return QuadtreeResult(
        levels=[QuadtreeLevel(**_tensors(arrays, LEVEL_ARRAY_FIELDS, device),
                              **{name: meta[name] for name in LEVEL_META_FIELDS
                                 if name in meta})
                for arrays, meta in levels],
        width=width, height=height)


def quadtree_to_numpy(res: QuadtreeResult):
    """(levels, width, height): per level, numpy arrays of its fields and a
    dict of its static fields; enough to rebuild either package's result."""
    levels = [({name: getattr(l, name).cpu().numpy() for name in LEVEL_ARRAY_FIELDS},
               {name: getattr(l, name) for name in LEVEL_META_FIELDS})
              for l in res.levels]
    return levels, res.width, res.height


def config_from_jax_fields(fields):
    """This package's EncoderConfig or DecoderConfig from the JAX package's
    config (a dataclass instance or a dict of its fields); the kind follows
    the field names, and JAX backend names map to this package's."""
    if dataclasses.is_dataclass(fields):
        fields = dataclasses.asdict(fields)
    fields = dict(fields)
    if "source_size" in fields:
        fields["backend"] = _BACKENDS[fields.get("backend", "auto")]
        return EncoderConfig(**fields)
    return DecoderConfig(**fields)
