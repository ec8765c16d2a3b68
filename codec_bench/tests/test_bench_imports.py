"""Nothing the benchmark runs loads JAX or the JAX package, whose name the
program's (``fractencode_tpu_torch``) begins with: top-level module names
are compared whole."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from codec_bench import run

ROOT = Path(__file__).resolve().parents[1]


def test_run_loads_no_jax_in_a_fresh_process():
    code = ("import sys, codec_bench.run, codec_bench.harness, codec_bench.calibrate, "
            "fractencode_tpu_torch; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True,
                         text=True, check=True).stdout
    names = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "fractencode_tpu_torch" in names and "codec_bench" in names
    assert not names & set(run.BANNED), names & set(run.BANNED)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    sources = [p for p in ROOT.rglob("*.py") if "tests" not in p.parts]
    assert len(sources) > 15
    bad = {str(p): _imports(p) & set(run.BANNED) for p in sources}
    assert not any(bad.values()), bad


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "reference").glob("*.py"):
        assert not _imports(p) & {"fractencode_tpu_torch", *run.BANNED}, p
    assert "fractencode_tpu_torch" not in _imports(ROOT / "control.py")


def test_loaded_banned_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fractencode_tpu_torch_extra", sys)
    assert run.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.loaded_banned() == ["jax"]


def test_no_card_exits_1_with_no_result(tmp_path):
    r = subprocess.run([sys.executable, "-m", "codec_bench.run", "--workload",
                        "grid-default.enc-4096", "--seed", "3000000019", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT.parent, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert r.returncode == 1 and r.stdout == ""
    assert "CUDA" in r.stderr
