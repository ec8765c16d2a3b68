"""Port parity, VQ pruning (``--vq-classes``): the numpy copy of JAX's PRNG
draws (``utils/prng.py``), ``encode/vq.py`` and the encoder's VQ bins,
against the JAX package on the CPU.

The PRNG copy is bitwise.  The k-means is not promised bitwise: XLA's dot at
HIGHEST, its segment sum and ``lax.rsqrt`` (an approximation, up to 2 ulp
from the correctly rounded value) have their own roundings, and the port
fixes its own (a loop over D, exact fixed-point cluster sums, one f64
rounding of 1/sqrt).  Measured on this file's planes (lenna128, the 64^2 and
128^2 noise planes, the smooth 128^2 plane; N = 1, 3, 4 and 7; and the
subsample branch): every domain and range label agrees with the JAX
package's, the codebooks to a few ulp and the step counts exactly.  The
closest call is a range of the 128^2 noise plane at N = 4, whose two nearest
codewords differ by 2.2e-5 relative (~190 times f32's epsilon), so no label
here is a near-tie (test_no_label_is_a_near_tie).  Given the same labels, the port's classed search and the whole
encode are bitwise equal to the JAX package's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, lenna128, random_plane

import fractencode_tpu as J
import fractencode_tpu.encode.encoder as je
import fractencode_tpu.encode.vq as jv
import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.encoder as te
import fractencode_tpu_torch.encode.quadtree as tq
import fractencode_tpu_torch.encode.vq as tv
from fractencode_tpu_torch.utils import prng

FIELDS = ("domain_idx", "transform", "s", "o", "distance", "valid")


def _smooth128() -> np.ndarray:
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:128, 0:128] / 128
    img = np.full((128, 128), 70.0)
    for _ in range(3):
        fx, fy = rng.uniform(0.3, 2.0, 2)
        img += rng.uniform(10, 18) * np.cos(2 * np.pi * (fx * xx + fy * yy)
                                            + rng.uniform(0, 2 * np.pi))
    return np.clip(img + rng.normal(0, 2, (128, 128)), 0, 255).astype(np.uint8)


PLANES = {"lenna128": lenna128, "rand64": lambda: random_plane(64, 1),
          "rand128": lambda: random_plane(128, 3), "smooth128": _smooth128}


# -- the PRNG copy, bitwise


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -5])
def test_prng_key_split_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert_bitwise(np.asarray(key), prng.prng_key(seed), "PRNGKey")
    for num in (2, 5):
        assert_bitwise(np.asarray(jax.random.split(key, num)),
                       prng.split(prng.prng_key(seed), num), f"split {num}")
    for n in (1, 2, 1001):
        assert_bitwise(np.asarray(jax.random.bits(key, (n,), jnp.uint32)),
                       prng.random_bits(prng.prng_key(seed), n), f"bits {n}")


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1625, 1626, 3969, 65536, 70000])
def test_permutation_and_choice_match_jax(n):
    """Through 1,625 one shuffle round, from 1,626 two (65,536 draws of 32
    bits collide, so the stable sort matters)."""
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        assert_bitwise(np.asarray(jax.random.permutation(key, n)),
                       prng.permutation(prng.prng_key(seed), n), f"permutation {seed}")
        k = min(n, 7)
        assert_bitwise(np.asarray(jax.random.choice(key, n, shape=(k,), replace=False)),
                       prng.choice(prng.prng_key(seed), n, k), f"choice {seed}")
    with pytest.raises(ValueError):
        prng.choice(prng.prng_key(0), n, n + 1)


# -- the k-means against the JAX package's


@functools.lru_cache(maxsize=None)
def _vectors(name: str):
    """(JAX, port) normalized identity-isometry domain vectors and range
    vectors of a plane, each package's own."""
    from fractencode_tpu.core.grid import uniform_grid as jgrid
    from fractencode_tpu.encode.codebook import build_codebook as jcb
    from fractencode_tpu.encode.codebook import extract_ranges as jranges
    from fractencode_tpu_torch.core.grid import uniform_grid as tgrid
    from fractencode_tpu_torch.encode.codebook import build_codebook as tcb
    from fractencode_tpu_torch.encode.codebook import extract_ranges as tranges

    img = PLANES[name]()
    n = img.shape[0]
    pj = jnp.asarray(img, jnp.float32)
    pt = torch.from_numpy(img).float()
    dj = je._normalize_affine(jcb(pj, jgrid(n, n, 16, 8), 4, 4).values[:, 0, :])
    dt = te._normalize_affine(tcb(pt, tgrid(n, n, 16, 8), 4, 4).values[:, 0, :])
    return ((np.asarray(dj), np.asarray(je._normalize_affine(jranges(pj, 4)))),
            (dt, te._normalize_affine(tranges(pt, 4))))


def test_normalize_affine_within_a_few_ulp_of_jax():
    """The JAX package's f32 sum of squares and its approximate rsqrt put
    its normalized vectors up to 5 ulp from the port's on these planes (most
    equal: 2,390 of lenna128's 3,600 domain entries); held at 8."""
    for name in PLANES:
        (dj, rj), (dt, rt) = _vectors(name)
        for a, b in ((dj, dt), (rj, rt)):
            ulps = np.abs(a.view(np.int32).astype(np.int64) - b.numpy().view(np.int32))
            assert ulps.max() <= 8, (name, ulps.max())


def test_fixed_point_sums_are_exact_for_the_encoders_vectors():
    """Each normalized domain vector entry is a multiple of 2^-shift, so the
    cluster sums are exact integers and their order cannot matter."""
    for name in PLANES:
        (_, _), (dt, _) = _vectors(name)
        shift = tv._fixed_point_shift(dt)
        xi = torch.round(dt.double() * 2.0 ** shift)
        assert torch.equal(xi * 2.0 ** -shift, dt.double())
        assert float(xi.abs().sum(0).max()) < 2.0 ** 62  # any cluster's sum fits


@pytest.mark.parametrize("name", sorted(PLANES))
@pytest.mark.parametrize("num_codes", [1, 3, 4, 7])
def test_train_codebook_and_labels_match_jax(name, num_codes):
    """Codebook to a few ulp, steps exactly, and every domain and range
    label equal to the JAX package's (none of these is a near-tie)."""
    (dj, rj), (dt, rt) = _vectors(name)
    cb_j, asg_j, steps_j = jv.train_codebook(jnp.asarray(dj), jax.random.PRNGKey(0),
                                             num_codes)
    cb_t, asg_t, steps_t = tv.train_codebook(dt, prng.prng_key(0), num_codes)
    assert steps_t == int(steps_j)
    np.testing.assert_allclose(cb_t.numpy(), np.asarray(cb_j), rtol=1e-5, atol=1e-6)
    assert asg_t.dtype == torch.int32
    assert_bitwise(np.asarray(asg_j), asg_t, "domain labels")
    assert_bitwise(np.asarray(jv.assign_codes(jnp.asarray(rj), cb_j)),
                   tv.assign_codes(rt, cb_t), "range labels")


def test_no_label_is_a_near_tie():
    """Every vector's two nearest codewords differ by more than 1e-5
    relative (~84 times f32's epsilon), so no ulp-level difference in the
    distances can flip a label; the closest call is 2.2e-5, a range of the
    128^2 noise plane at N = 4."""
    closest = []
    for name in PLANES:
        (_, _), (dt, rt) = _vectors(name)
        for num_codes in (3, 4, 7):
            cb, _, _ = tv.train_codebook(dt, prng.prng_key(0), num_codes)
            for x in (dt, rt):
                d = tv._pairwise_sq_dists(x, cb).double().sort(1).values
                closest.append(float(((d[:, 1] - d[:, 0]) / d[:, 1].abs()).min()))
    assert min(closest) > 1e-5, min(closest)


def test_train_codebook_subsample_matches_jax():
    """sample_limit below the vector count takes the subsample branch: the
    split key's draw, then the seeds from the other half."""
    (dj, _), (dt, _) = _vectors("lenna128")
    for limit in (50, 100):
        cb_j, asg_j, steps_j = jv.train_codebook(
            jnp.asarray(dj), jax.random.PRNGKey(3), 4, sample_limit=limit)
        cb_t, asg_t, steps_t = tv.train_codebook(dt, prng.prng_key(3), 4, sample_limit=limit)
        assert steps_t == int(steps_j)
        np.testing.assert_allclose(cb_t.numpy(), np.asarray(cb_j), rtol=1e-5, atol=1e-6)
        assert_bitwise(np.asarray(asg_j), asg_t, f"labels at limit {limit}")


def test_train_codebook_on_separated_data_matches_jax():
    """Gaussian data, as the JAX package's own VQ tests train on."""
    x = np.random.default_rng(0).standard_normal((3000, 16)).astype(np.float32)
    cb_j, asg_j, steps_j = jv.train_codebook(jnp.asarray(x), jax.random.PRNGKey(0), 5)
    cb_t, asg_t, steps_t = tv.train_codebook(torch.from_numpy(x), prng.prng_key(0), 5)
    assert steps_t == int(steps_j) == 70
    np.testing.assert_allclose(cb_t.numpy(), np.asarray(cb_j), rtol=1e-5, atol=1e-6)
    assert_bitwise(np.asarray(asg_j), asg_t, "labels")


def test_train_codebook_stops_at_max_steps_and_keeps_empty_clusters():
    x = np.random.default_rng(1).uniform(0, 10, (200, 4)).astype(np.float32)
    cb_j, _, steps_j = jv.train_codebook(jnp.asarray(x), jax.random.PRNGKey(2), 6,
                                         max_steps=3)
    cb_t, _, steps_t = tv.train_codebook(torch.from_numpy(x), prng.prng_key(2), 6,
                                         max_steps=3)
    assert steps_t == int(steps_j) == 3
    np.testing.assert_allclose(cb_t.numpy(), np.asarray(cb_j), rtol=1e-5, atol=1e-6)
    # two equal vectors seeded twice: one cluster takes both, the other stays
    y = np.array([[0.0, 0.0], [0.0, 0.0], [5.0, 5.0], [6.0, 6.0]], np.float32)
    cb, asg, _ = tv.train_codebook(torch.from_numpy(y), prng.prng_key(0), 4)
    assert torch.isfinite(cb).all() and asg.shape == (4,)


def test_assign_codes_is_nearest_with_ties_to_the_lowest():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 10, size=(50, 3)).astype(np.float32)
    cb = rng.uniform(0, 10, size=(4, 3)).astype(np.float32)
    got = tv.assign_codes(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ((x[:, None] - cb[None]) ** 2).sum(-1).argmin(1))
    np.testing.assert_array_equal(got, np.asarray(jv.assign_codes(x, cb)))
    twice = np.concatenate([cb[2:3], cb, cb[2:3]])  # codeword 2 at ids 0, 3 and 5
    got = tv.assign_codes(torch.from_numpy(x), torch.from_numpy(twice)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jv.assign_codes(x, twice)))
    assert not np.isin(got, [3, 5]).any()


# -- the encoder's VQ bins


def test_vq_classes_1_gives_the_noclassifier_winners():
    """One bin: the classed search over every pair equals the search without
    the classifier (mirrors the JAX package's tests/test_vq.py)."""
    img = random_plane(64, 9)
    base = T.EncoderConfig(use_classifier=False)
    r0 = T.encode_plane(img, base, device="cpu")
    r1 = T.encode_plane(img, dataclasses.replace(base, vq_classes=1), device="cpu")
    for f in ("domain_idx", "transform", "s", "o", "valid"):
        assert_bitwise(getattr(r0, f), getattr(r1, f), f)


def _jax_labels(img, cfg_j):
    from fractencode_tpu.core.grid import uniform_grid
    from fractencode_tpu.encode.codebook import build_codebook, extract_ranges

    n = img.shape[0]
    pf = jnp.asarray(img, jnp.float32)
    cb = build_codebook(pf, uniform_grid(n, n, cfg_j.source_size, cfg_j.domain_step),
                        cfg_j.target_size, cfg_j.num_transforms)
    return tuple(torch.from_numpy(np.array(c)) for c in
                 je._vq_classes(extract_ranges(pf, cfg_j.target_size), cb, cfg_j))


@pytest.mark.parametrize("name,num_codes", [("lenna128", 3), ("lenna128", 7),
                                            ("rand128", 4), ("smooth128", 4)])
def test_classed_search_bitwise_given_jax_labels(name, num_codes, monkeypatch):
    """The part after the labels: the port's encode on the JAX package's VQ
    labels equals the JAX encode, winners, s, o and distance bitwise; and
    so does the port's own encode, whose labels agree here."""
    img = PLANES[name]()
    cfg_j = J.EncoderConfig(backend="jnp", vq_classes=num_codes)
    cfg_t = T.EncoderConfig(vq_classes=num_codes)
    rj = J.encode_plane(img, cfg_j)
    own = T.encode_plane(img, cfg_t, device="cpu")
    labels = _jax_labels(img, cfg_j)
    monkeypatch.setattr(te, "_vq_classes", lambda ranges, cb, cfg: labels)
    given = T.encode_plane(img, cfg_t, device="cpu")
    for f in FIELDS:
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(given, f), f"given labels {f}")
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(own, f), f"own labels {f}")


def test_vq_encode_subsample_matches_jax():
    """vq_sample_limit below the domain count (225 at 128^2) reaches the
    subsample branch in the encoder, as 4096^2 does at the default limit."""
    img = lenna128()
    rj = J.encode_plane(img, J.EncoderConfig(backend="jnp", vq_classes=4,
                                             vq_sample_limit=100, vq_seed=7))
    rt = T.encode_plane(img, T.EncoderConfig(vq_classes=4, vq_sample_limit=100, vq_seed=7),
                        device="cpu")
    for f in FIELDS:
        assert_bitwise(np.asarray(getattr(rj, f)), getattr(rt, f), f)


def test_quadtree_ignores_vq_classes():
    img = random_plane(64, 5)
    a = tq.encode_plane_quadtree(img, T.EncoderConfig(), device="cpu")
    b = tq.encode_plane_quadtree(img, T.EncoderConfig(vq_classes=3), device="cpu")
    for la, lb in zip(a.levels, b.levels, strict=True):
        for f in ("domain_idx", "transform", "s", "o", "error", "accepted"):
            assert_bitwise(getattr(la, f), getattr(lb, f), f)
