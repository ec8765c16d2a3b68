"""The decoder step's kernel (``ops/decode_kernels.py``,
``csrc/decode_step.cu``) on the CPU: the host table it reads and a numpy
emulation of its indexing and arithmetic against the plain torch step, at
every table kind, the grid's and the quadtree's geometries at both pyramid
scales, and ``o_is_mean`` at K = 4 to 1024; and the dispatch, which sends a
CPU tensor through the plain step.  The kernel itself runs in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from _torch_parity import DECODE_STEP_GEOMETRIES, assert_bitwise, decode_step_case, mean_maps

from fractencode_tpu_torch.decode import decoder
from fractencode_tpu_torch.ops import decode_kernels as dk
from fractencode_tpu_torch.utils import graphs


def _plain(geometry, img, dom, tr, s, o, o_is_mean):
    """(kind, samples [R, K], u8 image) of the plain torch step."""
    sw, ts, step, t_n, n = DECODE_STEP_GEOMETRIES[geometry]
    tables = decoder.build_decode_tables(torch.from_numpy(dom), torch.from_numpy(tr), n, n,
                                         sw, ts, step, t_n)
    x = torch.from_numpy(img)
    out = decoder._decode_step_torch(x, tables, torch.from_numpy(s), torch.from_numpy(o),
                                     n, n, ts, o_is_mean)
    return tables[0], decoder.sample_domains(x, tables), out


def _emulate(geometry, img, dom, tr, s, o, o_is_mean, divide=False):
    """(samples [R, K] f32, u8 image) as the kernel forms them: range
    (ry, rx)'s domain origin, the 2x2 cell at each ``cell_corners`` offset
    past it summed as an integer, the range's tap sums over its ts rows for
    the mean, s*v + o in float64 rounded once to f32, and thread (ry, i,
    rx)'s row of ts bytes stored at (ry*ts + i)*W + rx*ts.  The mean is the
    sum times f32(1/K); with ``divide`` the sum over K, torch's CPU ``mean``,
    as a check that the tests see the difference."""
    sw, ts, step, _, n = DECODE_STEP_GEOMETRIES[geometry]
    w = n
    cells = dk.cell_corners(sw, ts, w)
    assert cells.shape == (8, ts * ts) and cells.dtype == np.int32
    nxd = (w - sw) // step + 1
    flat = img.reshape(-1).astype(np.int64)
    origin = (dom.astype(np.int64) // nxd) * step * w + (dom % nxd) * step
    c = origin[:, None] + cells[tr]
    tap = flat[c] + flat[c + 1] + flat[c + w] + flat[c + w + 1]
    samples = tap.astype(np.float32) * np.float32(0.25)
    v = samples
    if o_is_mean:
        total = tap.sum(1).astype(np.float32) * np.float32(0.25)
        mean = (total / np.float32(ts * ts) if divide
                else total * (np.float32(1) / np.float32(ts * ts)))
        v = v - mean[:, None]
    y = s.astype(np.float64)[:, None] * v.astype(np.float64) + o.astype(np.float64)[:, None]
    px = np.floor(np.clip(y.astype(np.float32), 0.0, 255.0)).astype(np.uint8)
    out = np.zeros(n * n, np.uint8)
    ry, rx = np.divmod(np.arange(len(dom)), w // ts)
    for i in range(ts):
        dst = (ry * ts + i) * w + rx * ts
        out[dst[:, None] + np.arange(ts)] = px[:, i * ts:(i + 1) * ts]
    return samples, out.reshape(n, n)


def test_geometries_cover_every_table_kind():
    kinds = {_plain(g, *decode_step_case(g, 0), False)[0] for g in DECODE_STEP_GEOMETRIES}
    assert kinds == {"cb", "half", "full"}


@pytest.mark.parametrize("geometry", list(DECODE_STEP_GEOMETRIES))
def test_cell_corners_reproduce_sample_domains(geometry):
    """The kernel's samples, from ``cell_corners`` and the maps, equal
    ``sample_domains``' for the table kind the plain step takes."""
    case = decode_step_case(geometry, 11)
    kind, want, _ = _plain(geometry, *case, False)
    got, _ = _emulate(geometry, *case, False)
    assert_bitwise(torch.from_numpy(got), want, f"{geometry} ({kind}) samples")


@pytest.mark.parametrize("geometry", list(DECODE_STEP_GEOMETRIES))
def test_emulated_step_equals_plain(geometry):
    """Pixels driven past 0 and 255, invalid ranges (s = o = 0)."""
    case = decode_step_case(geometry, 12)
    _, _, want = _plain(geometry, *case, False)
    _, got = _emulate(geometry, *case, False)
    assert_bitwise(torch.from_numpy(got), want, geometry)
    assert (want == 0).any() and (want == 255).any()


# o_is_mean at K = 4, 9, 16, 25, 64, 256, 1024
MEAN_GEOMETRIES = ["grid_half", "ts3", "grid", "ts5", "qt8", "qt16", "ts32"]


@pytest.mark.parametrize("geometry", MEAN_GEOMETRIES)
def test_emulated_mean_step_equals_plain(geometry):
    """The range mean as the sum of its rows' tap sums times f32(1/K), as
    the plain step forms it."""
    case = decode_step_case(geometry, 13, o_is_mean=True)
    _, _, want = _plain(geometry, *case, True)
    _, got = _emulate(geometry, *case, True)
    assert_bitwise(torch.from_numpy(got), want, f"{geometry} o_is_mean")


@pytest.mark.parametrize("geometry", ["ts3", "ts5"])
def test_mean_maps_see_the_means_rounding(geometry):
    """On ``mean_maps`` a pixel falls one grey level lower where a step's
    mean is one ulp off: the plain step and the emulation agree, and a mean
    formed by a division by K (torch's CPU ``mean``) would not."""
    img, dom, tr, s, o = decode_step_case(geometry, 16, o_is_mean=True)
    _, samples, _ = _plain(geometry, img, dom, tr, s, o, True)
    s, o = mean_maps(samples)
    _, _, want = _plain(geometry, img, dom, tr, s, o, True)
    _, got = _emulate(geometry, img, dom, tr, s, o, True)
    assert_bitwise(torch.from_numpy(got), want, f"{geometry} mean maps")
    _, off = _emulate(geometry, img, dom, tr, s, o, True, divide=True)
    assert (off != want.numpy()).any()


def test_cpu_tensor_takes_the_plain_step(monkeypatch):
    """``_step_tables`` gives a CPU map set the plain tables, and
    ``_decode_step`` runs the plain body on them; the kernel is never
    called."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(decoder, "decode_step_cuda", refuse)
    sw, ts, step, t_n, n = DECODE_STEP_GEOMETRIES["grid"]
    img, dom, tr, s, o = (torch.from_numpy(a) for a in decode_step_case("grid", 14))
    tables = decoder._step_tables(dom, tr, n, n, sw, ts, step, t_n)
    assert tables[0] == "cb"
    got = decoder._decode_step(img, tables, s, o, n, n, ts)
    want = decoder._decode_step_torch(img, tables, s, o, n, n, ts)
    assert_bitwise(got, want, "dispatch")


def test_kernel_wrapper_refuses_cpu_tensors():
    img, dom, tr, s, o = (torch.from_numpy(a) for a in decode_step_case("grid", 15))
    cells = torch.from_numpy(dk.cell_corners(16, 4, 64))
    with pytest.raises(ValueError, match="device"):
        dk.decode_step_cuda(img, dom, tr, s, o, cells, target_size=4, domain_cols=7,
                            domain_step=8)


def test_replays_count_the_kernels_launches():
    """``graphs._counters`` holds the kernel's counter, so a replay adds
    the launches its capture made."""
    assert any(c is dk.decode_step_cuda.launches for c in graphs._counters())
