"""Port parity at n = 36 and 49 (6x6 and 7x7 ranges, padded to K = 64): the
plain K1 and K3 against the JAX package's interpret-mode Pallas kernels and
its jnp oracle, bitwise but for the 'general' key's caveat (the rules and
helpers: test_torch_range_sizes.py)."""
import pytest

from test_torch_range_sizes import KEYS, check_k1, check_k3, check_oracle

NS = [36, 49]


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", NS)
def test_plain_k1_matches_fused_search_pairs(n, key, frontier):
    check_k1(n, key, frontier)


@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", NS)
def test_plain_k3_matches_fused_search(n, key, frontier):
    check_k3(n, key, frontier)


@pytest.mark.parametrize("classifier", [True, False], ids=["classed", "dense"])
@pytest.mark.parametrize("frontier", [False, True], ids=["plain", "thr"])
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", NS)
def test_search_matches_oracle(n, key, frontier, classifier):
    check_oracle(n, key, frontier, classifier)
