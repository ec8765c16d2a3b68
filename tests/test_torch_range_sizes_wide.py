"""Port parity at n = 100, 144 and 1024 (10x10 and 12x12 ranges, padded to K = 256, and 32x32 ones, the K-slab form at K = 1024): the
plain K1 and K3 against the JAX package's interpret-mode Pallas kernels and
its jnp oracle, to the tolerances of each range of n (the rules and
helpers: test_torch_range_sizes.py)."""
import pytest

from test_torch_range_sizes import KEYS, check_k1, check_k3, check_oracle

NS = [100, 144, 1024]


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
