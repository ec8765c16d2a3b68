"""The port's package boundary and CLI: no jax import anywhere in the port,
the CLI's output against the JAX CLI's on the in-repo Lenna crop, refused
flags, the card as the default device, and chip_smoke.py's behaviour without
a card."""
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


@pytest.mark.parametrize("flag", [["--quadtree", "--compat"], ["--vq-classes", "3"],
                                  ["--out", "x.ftc"], ["--decode-file", "x.ftc"],
                                  ["--color"], ["--log"], ["--profile", "p"]])
def test_cli_refuses_unported_flags(flag, capsys):
    from fractencode_tpu_torch.cli import main

    assert main([LENNA, "--device", "cpu", *flag]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md" in err


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
