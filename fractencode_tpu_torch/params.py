"""Encoder/decoder configuration of the PyTorch port.

The same frozen dataclasses as ``fractencode_tpu/params.py`` (field names,
defaults and validation), so a configuration carries across the two packages
field for field (see ``bridge.config_from_jax_fields``).  Only ``backend``
differs: it names the port's routes.

  * ``'auto'``  — route on the tensors' device: a CUDA tensor launches the
    hand-written kernel, a CPU tensor runs the plain PyTorch version;
  * ``'torch'`` — force the plain PyTorch version on any device;
  * ``'cuda'``  — require the kernel (tensors must lie on a CUDA device).

See ``fractencode_tpu/params.py`` for what each mode flag means.
"""
from __future__ import annotations

import dataclasses

__all__ = ["EncoderConfig", "DecoderConfig", "REFERENCE_COMPAT", "BACKENDS"]

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # Geometry (reference defaults: encode_parameters.h:6-8)
    source_size: int = 16  # domain block edge
    target_size: int = 4  # range block edge
    lattice: int = 2  # domain step = source_size // lattice (main.cpp:147)

    # Search space
    num_transforms: int = 4  # reference searches Id/90/180/270 only
    rms_threshold: float = 0.0  # early-accept threshold, MSE units
    s_max: float = -1.0  # |s| clamp; <=0 disables
    use_classifier: bool = True  # brightness-block 6-class equality prune

    # Semantics
    criterion: str = "affine"  # 'affine' | 'raw'
    so_mode: str = "ls"  # 'ls' | 'reference'

    # Learned pruning: LBG codeword ids as the class bins (encode/vq.py)
    vq_classes: int = 0
    vq_sample_limit: int = 65536
    vq_seed: int = 0

    # Execution
    range_chunk: int = 2048  # ranges per chunk of the dense oracle matcher.search
    backend: str = "auto"  # 'auto' | 'torch' | 'cuda'
    # Kept for field parity.  The port always searches with the exact int8
    # decomposition for K <= INT8_MAX_K, which the JAX package documents as
    # bit-identical to its f32 path.
    int8_matmul: bool = True

    def __post_init__(self):
        if self.target_size >= self.source_size or self.target_size < 2:
            raise ValueError("invalid source/target size")  # main.cpp:99-102
        if self.source_size % self.lattice:
            raise ValueError("source_size must be divisible by lattice")
        if self.criterion not in ("affine", "raw"):
            raise ValueError(f"bad criterion {self.criterion}")
        if self.so_mode not in ("ls", "reference"):
            raise ValueError(f"bad so_mode {self.so_mode}")
        if not 1 <= self.num_transforms <= 8:
            raise ValueError("num_transforms must be in 1..8")
        if not 0 <= self.vq_classes <= 7:
            raise ValueError("vq_classes must be 0 (off) or 1..7 (the classed "
                             "kernel layout carries 7 class bins)")
        if self.backend not in BACKENDS:
            raise ValueError(f"bad backend {self.backend}")

    @property
    def domain_step(self) -> int:
        return self.source_size // self.lattice


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    max_iterations: int = 300  # Encoder2.hpp:62
    epsilon: float = 1e-5  # inter-iterate MSE stop (main.cpp:34)
    initial_value: int = 100  # flat start image (Encoder2.hpp:69)
    # Stop when the inter-iterate MSE has not improved by stall_rtol over the
    # best seen for stall_window steps (0 disables: strict reference count).
    stall_window: int = 8
    stall_rtol: float = 0.02
    # "flat" (reference start image) or "means" (block-mean fixed point).
    initial: str = "flat"
    mean_init_iters: int = 30
    # Coarse-to-fine start, then exactly min(pyramid_full_steps,
    # max_iterations) full-resolution steps.  Off by default (reference
    # parity); the CLI turns it on.
    pyramid: bool = False
    pyramid_steps: int = 8  # iterations at the coarsest scale
    pyramid_refine_steps: int = 4  # iterations at intermediate scales
    pyramid_levels: int = 1
    pyramid_full_steps: int = 6


def REFERENCE_COMPAT(**overrides) -> EncoderConfig:
    """Config matching the reference C++ encoder bit-for-bit in ranking and
    (s, o) semantics."""
    base = dict(criterion="raw", so_mode="reference", num_transforms=4)
    base.update(overrides)
    return EncoderConfig(**base)
