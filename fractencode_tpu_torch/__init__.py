"""fractencode_tpu_torch — the PyTorch and CUDA port of fractencode_tpu.

A second package beside the JAX one, which stays the reference: the same
encode -> decode path on tensors, with the JAX package's module layout and
names.  A CUDA tensor runs the hand-written Hopper kernel of the search
(``ops/matcher_kernels.py``, ``csrc/search_classed.cu``); a CPU tensor runs
its plain PyTorch version.
"""
import torch

from .params import EncoderConfig, DecoderConfig, REFERENCE_COMPAT
from .encode import EncodeResult, encode_plane, encode_batch, encode_batch_stacked
from .decode import decode_plane, decode_batch_stacked

# Exactness: the plain search's SumAB matmul is exact in full f32 only.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "EncoderConfig",
    "DecoderConfig",
    "REFERENCE_COMPAT",
    "EncodeResult",
    "encode_plane",
    "encode_batch",
    "encode_batch_stacked",
    "decode_plane",
    "decode_batch_stacked",
    "__version__",
]
