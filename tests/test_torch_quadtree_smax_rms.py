"""Port parity, the quadtree with the early-accept frontier under the
'general' key (``--quadtree --smax 0.9 --rms 10``), with and without the
classifier, against the JAX package on the CPU; the rules of
test_torch_quadtree_compat.py.
"""
import dataclasses

import pytest

from test_torch_quadtree_compat import (CONFIGS, PLANES, check_decode, check_encode,
                                        encodes)

import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.bridge import config_from_jax_fields


@pytest.mark.parametrize("classifier", [True, False], ids=["cls", "nocls"])
def test_quadtree_matches_jax(classifier):
    """Every level against the JAX package's, and the threshold is not
    vacuous: it changes some winner of the port's encode."""
    check_encode("wave128", "smax", classifier, 10.0)
    _, rt = encodes("wave128", "smax", classifier, 10.0)
    off = config_from_jax_fields(CONFIGS["smax"](use_classifier=classifier))
    r0 = tq.encode_plane_quadtree(PLANES["wave128"], off, tq.QuadtreeConfig(), device="cpu")
    assert any(bool((l.domain_idx != l0.domain_idx).any())
               for l, l0 in zip(rt.levels, r0.levels)), "vacuous: no winner changed"


@pytest.mark.parametrize("classifier", [True, False], ids=["cls", "nocls"])
def test_decode_matches_jax(classifier):
    check_decode("smax", classifier, 10.0)
