"""Port parity, the quadtree under the 'general' key (``--quadtree --smax
0.9``), with and without the classifier, against the JAX package on the
CPU; the rules of test_torch_quadtree_compat.py.
"""
import pytest

from test_torch_quadtree_compat import check_decode, check_encode


@pytest.mark.parametrize("classifier", [True, False], ids=["cls", "nocls"])
@pytest.mark.parametrize("pname", ["lenna128", "wave128"])
def test_quadtree_matches_jax(pname, classifier):
    check_encode(pname, "smax", classifier)


@pytest.mark.parametrize("classifier", [True, False], ids=["cls", "nocls"])
def test_decode_matches_jax(classifier):
    check_decode("smax", classifier)
