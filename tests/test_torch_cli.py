"""The port's package boundary and CLI: no jax import anywhere in the port,
the CLI's output against the JAX CLI's on the in-repo Lenna crop, the card
as the default device, and chip_smoke.py's behaviour without a card."""
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_parity import GOLDEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENNA = os.path.join(GOLDEN, "lenna128_input.png")


def _run(args, cwd, env_extra=None):
    env = {**os.environ, "PYTHONPATH": REPO, **(env_extra or {})}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _run_both(*runs):
    """``_run`` for each (args, cwd, env_extra), side by side; the results."""
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(_run, *run) for run in runs]
        return [f.result() for f in futures]


def test_port_never_imports_jax(tmp_path):
    """Every module of the port (and chip_smoke.py) imports without jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fractencode_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert 'fractencode_tpu_torch.cli' in names and "
        "'fractencode_tpu_torch.ops.matcher_kernels' in names, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fractencode_tpu' or m.startswith('fractencode_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def _psnr(stdout):
    m = re.search(r"psnr: ([0-9.]+) dB", stdout)
    assert m, stdout
    return float(m.group(1))


@pytest.mark.parametrize("flags", [[], ["--compat"], ["--noclassifier"],
                                   ["--noclassifier", "--compat"], ["--rms", "10"],
                                   ["--compat", "--rms", "10"]])
def test_cli_psnr_matches_jax_cli(tmp_path, flags):
    """The port's CLI on the CPU prints the JAX CLI's PSNR and statistics."""
    port, ref = _run_both(
        (["-m", "fractencode_tpu_torch", LENNA, "--device", "cpu",
          "--result", str(tmp_path / "t.png"), *flags], tmp_path),
        (["-m", "fractencode_tpu", LENNA, "--result", str(tmp_path / "j.png"),
          *flags], tmp_path, dict(JAX_PLATFORMS="cpu")))
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert abs(_psnr(port.stdout) - _psnr(ref.stdout)) <= 1e-4
    keep = ("elements", "classifier rejected", "decode stats", "contrast",
            "brightness", "grid element count")
    lines = lambda out: [l for l in out.splitlines() if l.startswith(keep)]
    assert lines(port.stdout) == lines(ref.stdout)
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                          np.asarray(Image.open(tmp_path / "j.png")))


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _port_args(*args):
    return ["-m", "fractencode_tpu_torch", *args, "--device", "cpu"]


def _jax_run(args, cwd):
    return (["-m", "fractencode_tpu", *args], cwd, dict(JAX_PLATFORMS="cpu"))


def _ok(*procs):
    for proc in procs:
        assert proc.returncode == 0, proc.stderr


def test_cli_quadtree_compat_matches_jax_cli(tmp_path):
    """--quadtree --compat (the 'raw' key at K = 256 on the 16 px level): the
    port's CLI on the CPU prints the JAX CLI's leaves per level, decode stats
    and PSNR, and writes its pixels."""
    flags = [LENNA, "--quadtree", "--compat"]
    port, ref = _run_both(
        (_port_args(*flags, "--result", str(tmp_path / "t.png")), tmp_path),
        _jax_run([*flags, "--result", str(tmp_path / "j.png")], tmp_path))
    _ok(port, ref)
    keep = ("decode stats", "psnr")
    lines = lambda out: [l for l in out.splitlines()
                         if l.startswith(keep) or " leaves 16px:" in l]
    assert len(lines(ref.stdout)) == 3
    assert lines(port.stdout) == lines(ref.stdout)
    assert np.array_equal(_png(tmp_path / "t.png"), _png(tmp_path / "j.png"))


def _decode_both_ways(tmp_path, files):
    """Each CLI decodes each file in ``files`` ({name: path}), side by side;
    returns {(package, name): pixels} after checking the runs."""
    runs, keys = [], []
    for name, path in files.items():
        for pkg in ("t", "j"):
            out = str(tmp_path / f"dec_{pkg}_{name}.png")
            args = ["--decode-file", str(path), "--result", out]
            runs.append((_port_args(*args), tmp_path) if pkg == "t"
                        else _jax_run(args, tmp_path))
            keys.append((pkg, name, out))
    procs = _run_both(*runs)
    _ok(*procs)
    for proc, (_, name, _) in zip(procs, keys):
        assert f"decoded {files[name]}: " in proc.stdout
    return {(pkg, name): _png(out) for pkg, name, out in keys}


@pytest.mark.parametrize("quadtree", [False, True], ids=["grid", "quadtree"])
def test_cli_out_then_decode_file_matches_jax_cli(tmp_path, quadtree):
    """--out, then --decode-file.  The grid: the port's file is the JAX CLI's
    byte for byte.  The quadtree: the files may differ in the 16 px level's
    s and o (the K = 256 parity rule; tests/test_torch_codec.py), so each CLI
    decodes both files and the two packages decode each file to the same
    pixels.  Both print the JAX CLI's bitstream line and the port a bpp line."""
    ext = ".ftq" if quadtree else ".ftc"
    flags = [LENNA, *(["--quadtree"] if quadtree else [])]
    files = {"t": tmp_path / f"t{ext}", "j": tmp_path / f"j{ext}"}
    port, ref = _run_both(
        (_port_args(*flags, "--out", str(files["t"]), "--result",
                    str(tmp_path / "t.png")), tmp_path),
        _jax_run([*flags, "--out", str(files["j"]), "--result", str(tmp_path / "j.png")],
                 tmp_path))
    _ok(port, ref)
    size = lambda p: os.path.getsize(p)
    assert f"bitstream: {size(files['t'])} bytes" in port.stdout
    assert f"bitstream: {size(files['j'])} bytes" in ref.stdout
    assert re.search(r"^bpp: ([0-9.]+)$", port.stdout, re.M).group(1) == \
        f"{8 * size(files['t']) / 128 ** 2:.4f}"
    if not quadtree:
        assert files["t"].read_bytes() == files["j"].read_bytes()
        files.pop("j")
    decoded = _decode_both_ways(tmp_path, files)
    for name in files:
        assert np.array_equal(decoded["t", name], decoded["j", name]), name


def test_cli_color_out_round_trip(tmp_path):
    """--color --out writes an FTCC container of three FTC1 planes, the JAX
    CLI's bytes; --decode-file gives each CLI the same RGB pixels, and the
    encodes' own --result images are equal.  The planes are noise: on a range
    with an exact match (distance 0, as on flat blocks) the JAX CLI's CPU
    search (its jnp oracle) takes the first transform, and its Pallas
    kernels and the port the last (ROADMAP.md, parity contract)."""
    rgb = np.random.default_rng(8).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    from PIL import Image

    src = tmp_path / "rgb.png"
    Image.fromarray(rgb).save(src)
    port, ref = _run_both(
        (_port_args(str(src), "--color", "--out", str(tmp_path / "t.ftcc"),
                    "--result", str(tmp_path / "t.png")), tmp_path),
        _jax_run([str(src), "--color", "--out", str(tmp_path / "j.ftcc"),
                  "--result", str(tmp_path / "j.png")], tmp_path))
    _ok(port, ref)
    blob = (tmp_path / "t.ftcc").read_bytes()
    assert blob[:4] == b"FTCC" and blob == (tmp_path / "j.ftcc").read_bytes()
    assert [l for l in port.stdout.splitlines() if l.startswith("psnr")] == \
        [l for l in ref.stdout.splitlines() if l.startswith("psnr")]
    assert port.stdout.count("[U]") and port.stdout.count("[V]")
    decoded = _decode_both_ways(tmp_path, {"t": tmp_path / "t.ftcc"})
    assert decoded["t", "t"].shape == (64, 64, 3)
    assert np.array_equal(decoded["t", "t"], decoded["j", "t"])
    assert np.array_equal(_png(tmp_path / "t.png"), _png(tmp_path / "j.png"))


@pytest.mark.parametrize("kind", ["garbage", "truncated", "empty"])
def test_cli_decode_file_rejects_a_bad_file(tmp_path, capsys, kind):
    """A file that is no bitstream, one cut short, or an empty one: exit 2 and
    'error: not a valid bitstream', with no image written."""
    from fractencode_tpu_torch.cli import main

    good = tmp_path / "good.ftq"
    assert main([LENNA, "--device", "cpu", "--quadtree", "--out", str(good),
                 "--result", str(tmp_path / "r.png")]) == 0
    blob = good.read_bytes()
    bad = {"garbage": b"NOPE" + bytes(range(200)), "truncated": blob[:len(blob) // 2],
           "empty": b""}[kind]
    path = tmp_path / "bad.ftq"
    path.write_bytes(bad)
    capsys.readouterr()
    out = tmp_path / "bad.png"
    assert main(["--decode-file", str(path), "--device", "cpu", "--result", str(out)]) == 2
    assert "error: not a valid bitstream" in capsys.readouterr().err
    assert not out.exists()


def test_cli_needs_a_card_unless_asked_for_the_cpu(capsys):
    """--device defaults to cuda: with no card the CLI exits non-zero and
    names --device cpu, and never falls back to the CPU by itself."""
    import torch

    from fractencode_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert main([LENNA]) != 0
    assert "--device cpu" in capsys.readouterr().err


def test_encode_plane_needs_a_card_for_numpy():
    """A numpy plane with no device goes to the card; with none, the entry
    points raise rather than run on the CPU."""
    import torch

    import fractencode_tpu_torch as T
    from fractencode_tpu_torch.encode.quadtree import encode_plane_quadtree

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    plane = np.zeros((64, 64), np.uint8)
    for encode in (T.encode_plane, encode_plane_quadtree):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            encode(plane)
    res = T.encode_plane(torch.from_numpy(plane))  # a CPU tensor asks for the CPU
    assert res.s.device.type == "cpu"


def test_bridge_needs_a_card_unless_asked_for_the_cpu():
    """The bridge's imports default to the card too: with none they raise,
    and device='cpu' asks for the CPU."""
    import torch

    import fractencode_tpu_torch as T
    from fractencode_tpu_torch.bridge import (quadtree_from_numpy, quadtree_to_numpy,
                                              result_from_numpy, result_to_numpy)
    from fractencode_tpu_torch.encode.quadtree import encode_plane_quadtree

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    plane = np.random.default_rng(3).integers(0, 256, (64, 64), dtype=np.uint8)
    arrays, meta = result_to_numpy(T.encode_plane(plane, device="cpu"))
    levels, w, h = quadtree_to_numpy(encode_plane_quadtree(plane, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        result_from_numpy(arrays, meta)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quadtree_from_numpy(levels, w, h)
    assert result_from_numpy(arrays, meta, "cpu").s.device.type == "cpu"
    assert quadtree_from_numpy(levels, w, h, "cpu").levels[0].s.device.type == "cpu"


def test_cli_debug_decode_and_bad_config(tmp_path, capsys, monkeypatch):
    from fractencode_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main([LENNA, "--device", "cpu", "--compat", "--decode", "3",
                 "--debug_decode", "--result", "r.png"]) == 0
    assert sorted(p.name for p in tmp_path.glob("decode_debug*.png")) == \
        [f"decode_debug{i}.png" for i in range(4)]
    assert main([LENNA, "--device", "cpu", "--source", "4", "--target", "4"]) == 2
    assert "invalid source/target size" in capsys.readouterr().err


def test_chip_smoke_needs_a_card(tmp_path):
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line; alone in a directory it cannot import the port either."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for proc in _run_both(([os.path.join(REPO, "chip_smoke.py")], tmp_path),
                          (["chip_smoke.py"], alone, dict(PYTHONPATH=""))):
        assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_cli_backend_jnp_matches_default(tmp_path, capsys):
    """--backend jnp (the plain versions) prints the default's PSNR and
    writes its pixels."""
    from fractencode_tpu_torch.cli import main

    psnr = {}
    for name, flags in (("auto", []), ("jnp", ["--backend", "jnp"])):
        assert main([LENNA, "--device", "cpu", *flags,
                     "--result", str(tmp_path / f"{name}.png")]) == 0
        psnr[name] = _psnr(capsys.readouterr().out)
    assert psnr["jnp"] == psnr["auto"]
    assert np.array_equal(_png(tmp_path / "jnp.png"), _png(tmp_path / "auto.png"))


def test_cli_backend_pallas_needs_the_card(tmp_path, capsys):
    """--backend pallas with --device cpu exits 2 and names the device,
    without a traceback and without writing an image."""
    from fractencode_tpu_torch.cli import main

    out = tmp_path / "r.png"
    assert main([LENNA, "--device", "cpu", "--backend", "pallas", "--result", str(out)]) == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err and "Traceback" not in err
    assert not out.exists()


def test_cli_parses_every_jax_backend():
    """Every --backend choice of the JAX CLI parses, and maps to the port's
    route (bridge._BACKENDS)."""
    from fractencode_tpu.cli import build_parser as jax_parser

    from fractencode_tpu_torch import cli
    from fractencode_tpu_torch.bridge import _BACKENDS

    action = next(a for a in jax_parser()._actions if "--backend" in a.option_strings)
    assert set(action.choices) == set(_BACKENDS)
    for choice in action.choices:
        args = cli.build_parser().parse_args([LENNA, "--backend", choice])
        assert cli._config_from_args(args).backend == _BACKENDS[choice]
