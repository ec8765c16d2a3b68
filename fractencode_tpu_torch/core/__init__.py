from .transform import TransformType, NUM_TRANSFORMS
from .grid import Grid, uniform_grid
from . import sampler, stats, classify, metrics

__all__ = [
    "TransformType",
    "NUM_TRANSFORMS",
    "Grid",
    "uniform_grid",
    "sampler",
    "stats",
    "classify",
    "metrics",
]
