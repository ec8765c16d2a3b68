"""Port parity, the sharded quadtree: ``encode_batch_quadtree_sharded`` and
``decode_batch_quadtree_sharded`` against the JAX package's on a (2, 4)
mesh (conftest's 8 virtual CPU devices; the port's mesh repeats
``torch.device("cpu")``), on ``dryrun_multichip``'s smooth ramp frames, whose
coarse levels accept so that the finer levels' coverage mask engages; and
the port's ``dryrun_multichip`` on 8 CPU devices.

Every level is bitwise but the 16 px one (K = 256), which the parity
contract holds to tolerances (test_torch_quadtree.py); the winners, the
leaves and the decoded pixels are bitwise everywhere.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise

import fractencode_tpu as J
import fractencode_tpu.encode.quadtree as jq
from fractencode_tpu.parallel import make_mesh as j_make_mesh

import fractencode_tpu_torch as T
import fractencode_tpu_torch.encode.quadtree as tq
from fractencode_tpu_torch.graft_entry import dryrun_multichip
from fractencode_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")
LEVEL_FIELDS = ("domain_idx", "transform", "s", "o", "error", "accepted")
# K = 256 (the 16 px level): test_torch_quadtree.py's tolerances
K256_TOL = dict(s=(5e-5, 1e-5), o=(5e-5, 1e-5), error=(1.2e-4, 1e-4))
QCFG = dict(min_size=4, max_size=16)


def _ramps() -> np.ndarray:
    """dryrun_multichip's quadtree frames: a ramp and its vertical flip."""
    ys, xs = np.mgrid[0:64, 0:64]
    ramp = ((xs * 2 + ys) % 256).astype(np.uint8)
    return np.stack([ramp, ramp[::-1].copy()])


def _mesh():
    return make_mesh(2, 4, devices=[CPU] * 8)


@functools.lru_cache(maxsize=None)
def _jax():
    mesh = j_make_mesh(2, 4)
    res = jq.encode_batch_quadtree_sharded(_ramps(), J.EncoderConfig(),
                                           jq.QuadtreeConfig(**QCFG), mesh)
    return res, jq.decode_batch_quadtree_sharded(res, mesh, J.DecoderConfig(pyramid=True))


@functools.lru_cache(maxsize=None)
def _port():
    return tq.encode_batch_quadtree_sharded(_ramps(), T.EncoderConfig(),
                                            tq.QuadtreeConfig(**QCFG), _mesh())


def test_encode_batch_quadtree_sharded_matches_jax():
    rj, rt = _jax()[0], _port()
    assert len(rt) == len(rj) == 2
    for i in range(2):
        assert [l.range_size for l in rt[i].levels] == [16, 8, 4]
        for lj, lt in zip(rj[i].levels, rt[i].levels, strict=True):
            for f in LEVEL_FIELDS:
                a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
                if lt.range_size == 16 and f in K256_TOL:
                    rtol, atol = K256_TOL[f]
                    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                               err_msg=f"frame {i} {f}")
                else:
                    assert_bitwise(a, b, f"frame {i} {lt.range_size} px {f}")
    # the coverage mask engaged: coarse leaves exist, so finer levels skip
    assert int(rt[0].levels[0].accepted.sum()) > 0


def test_decode_batch_quadtree_sharded_matches_jax():
    """The pyramid decode of the JAX package's own encodes, brought into the
    port: pixels, iterations and MSE bitwise."""
    from fractencode_tpu_torch.bridge import quadtree_from_numpy

    rj, (oj, ij, mj) = _jax()
    levels = [[({f: np.asarray(getattr(l, f)) for f in LEVEL_FIELDS},
                {f: getattr(l, f) for f in ("range_size", "domain_size", "domain_step",
                                            "o_is_mean", "num_transforms")})
               for l in r.levels] for r in rj]
    rt = [quadtree_from_numpy(lv, 64, 64, device="cpu") for lv in levels]
    ot, it, mt = tq.decode_batch_quadtree_sharded(rt, _mesh(), T.DecoderConfig(pyramid=True))
    assert_bitwise(np.asarray(oj), ot, "pixels")
    assert_bitwise(np.asarray(ij), it, "iterations")
    assert_bitwise(np.asarray(mj), mt, "mse")


@pytest.mark.parametrize("pyramid", [False, True], ids=["flat", "pyramid"])
def test_quadtree_sharded_equals_single_frames(pyramid):
    """Each frame of the sharded encode and decode equals
    encode_plane_quadtree and decode_plane_quadtree on it, bitwise."""
    cfg, qcfg, dcfg = T.EncoderConfig(), tq.QuadtreeConfig(**QCFG), T.DecoderConfig(
        pyramid=pyramid)
    outs, iters, mses = tq.decode_batch_quadtree_sharded(_port(), _mesh(), dcfg)
    for i, plane in enumerate(_ramps()):
        single = tq.encode_plane_quadtree(plane, cfg, qcfg, device="cpu")
        for ls, l1 in zip(_port()[i].levels, single.levels, strict=True):
            for f in LEVEL_FIELDS:
                assert_bitwise(getattr(ls, f), getattr(l1, f), f"frame {i} {f}")
        out, it, mse = tq.decode_plane_quadtree(single, dcfg)
        assert_bitwise(outs[i], out, f"frame {i} pixels")
        assert (int(iters[i]), float(mses[i])) == (it, np.float32(mse))


def test_dryrun_multichip_on_cpu_devices(capsys):
    """The port's dry run on 8 CPU devices: the three strategies, the halo
    modes, both decodes and the quadtree pair, as the JAX package's runs on
    8 virtual devices; the same summary line."""
    dryrun_multichip(8, devices=[CPU] * 8)
    out = capsys.readouterr().out
    assert ("dryrun_multichip ok: mesh={'data': 2, 'search': 4} imgs=(2, 64, 64) "
            "strategies=ranges/domains/ring/halo decode_iters=[5, 5]") in out, out
    with pytest.raises(ValueError, match="4 devices for a 8-device mesh"):
        dryrun_multichip(8, devices=[CPU] * 4)
