"""Port parity, profiling and progress (``utils/``) and the CLI's ``--log``,
``--profile`` and ``--vq-classes``: the reporters' output and calls against
the JAX package's, the torch.profiler trace, and the CLI's standard output
against the JAX CLI's on the in-repo Lenna crop, timings excepted.
"""
import functools
import io
import json
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_parity import GOLDEN, random_plane

import fractencode_tpu as J
import fractencode_tpu.decode.decoder as jd
import fractencode_tpu.encode.quadtree as jq
import fractencode_tpu.utils as ju
import fractencode_tpu_torch as T
import fractencode_tpu_torch.decode.decoder as td
import fractencode_tpu_torch.encode.quadtree as tq
import fractencode_tpu_torch.utils as tu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENNA = os.path.join(GOLDEN, "lenna128_input.png")


class Calls(tu.ProgressReporter):
    def __init__(self):
        self.calls = []

    def log(self, done, total):
        self.calls.append((done, total))


def test_utils_exports_match_jax():
    assert tu.__all__ == ju.__all__


@pytest.mark.parametrize("interval", [0.0, 1e9], ids=["every", "throttled"])
def test_stdout_reporter_writes_what_jax_writes(interval):
    streams = []
    for pkg in (ju, tu):
        buf = io.StringIO()
        rep = pkg.StdoutReporter(interval=interval, stream=buf)
        for done in (1, 2, 3, 3, 1, 4):
            rep.log(done, 4)
        pkg.NullReporter().log(1, 2)
        streams.append(buf.getvalue())
    assert streams[0] == streams[1]
    assert streams[1].endswith("100%\n")


def test_phase_timer_report_has_jax_layout():
    reports = []
    for pkg in (ju, tu):
        timer = pkg.PhaseTimer()
        for name in ("load", "encode", "load"):
            with timer.phase(name):
                pass
        assert list(timer.phases) == ["load", "encode"]
        reports.append([re.sub(r"[0-9.]+ ms", "ms", l) for l in timer.report().splitlines()])
    assert reports[0] == reports[1] == ["load: ms", "encode: ms", "total: ms"]


def test_device_trace_writes_a_cpu_trace(tmp_path):
    with tu.device_trace(str(tmp_path), device="cpu"):
        T.encode_plane(random_plane(64, 2), device="cpu")
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_quadtree_reporter_calls_match_jax():
    img = random_plane(64, 6)
    jr, tr = Calls(), Calls()
    jq.encode_plane_quadtree(img, J.EncoderConfig(), jq.QuadtreeConfig(), reporter=jr)
    tq.encode_plane_quadtree(img, T.EncoderConfig(), tq.QuadtreeConfig(), tr, device="cpu")
    assert tr.calls == jr.calls == [(1, 3), (2, 3), (3, 3)]


@pytest.mark.parametrize("max_iterations", [3, 300])
def test_decode_steps_reporter_calls_match_jax(max_iterations):
    """Every step against max_iterations, and the final (max, max) where
    the epsilon test stops the loop early."""
    img = random_plane(64, 7)
    rj = J.encode_plane(img, J.EncoderConfig())
    rt = T.encode_plane(img, T.EncoderConfig(), device="cpu")
    jr, tr = Calls(), Calls()
    steps_j = [i for i, _ in jd.decode_steps_py(
        rj, J.DecoderConfig(max_iterations=max_iterations), reporter=jr)]
    steps_t = [i for i, _ in td.decode_steps_py(
        rt, T.DecoderConfig(max_iterations=max_iterations), reporter=tr)]
    assert steps_t == steps_j
    assert tr.calls == jr.calls
    assert tr.calls[-1] == (max_iterations, max_iterations)


# -- the CLI against the JAX CLI

CLI_CASES = {
    "log": ["--log"],
    "log_quadtree": ["--log", "--quadtree"],
    "vq3": ["--vq-classes", "3"],
    "vq4_log_noclassifier": ["--vq-classes", "4", "--log", "--noclassifier"],
    "profile": ["--profile", "prof", "--log"],
    "debug_decode_log": ["--debug_decode", "--log", "--decode", "3", "--compat"],
}
# lines that carry a time
TIMED = re.compile(r"^(encoded|decoded) in |^total time: |^[A-Za-z ]+: [0-9.]+ ms$")


def _run(args, cwd, env_extra):
    env = {**os.environ, "PYTHONPATH": REPO, **env_extra}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@functools.lru_cache(maxsize=None)
def _cli_runs(root):
    """Every case through both CLIs, side by side: {(case, "port" or "jax"):
    (completed process, its working directory)}."""
    runs = {}
    for case, flags in CLI_CASES.items():
        for pkg in ("port", "jax"):
            cwd = os.path.join(root, case, pkg)
            os.makedirs(cwd)
            if pkg == "port":
                args = ["-m", "fractencode_tpu_torch", LENNA, "--device", "cpu", *flags]
                runs[(case, pkg)] = (args, cwd, {})
            else:
                runs[(case, pkg)] = (["-m", "fractencode_tpu", LENNA, *flags], cwd,
                                     dict(JAX_PLATFORMS="cpu"))
    with ThreadPoolExecutor(6) as pool:
        done = {key: pool.submit(_run, *run) for key, run in runs.items()}
        return {key: (f.result(), runs[key][1]) for key, f in done.items()}


def _untimed(stdout):
    """The lines without a time; a progress line as its last update (the
    reporter rewinds with backspaces and throttles by the clock)."""
    return [line.split("\b")[-1] for line in stdout.splitlines() if not TIMED.search(line)]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    return _cli_runs(str(tmp_path_factory.mktemp("cli")))


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_flags_match_jax_cli(case, cli_runs):
    (port, port_dir), (ref, ref_dir) = cli_runs[(case, "port")], cli_runs[(case, "jax")]
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert _untimed(port.stdout) == _untimed(ref.stdout)
    flags = CLI_CASES[case]
    if "--log" in flags:
        lines = port.stdout.splitlines()
        table = lines[lines.index("-- phases --") + 1:-1]
        assert [l.split(":")[0] for l in table] == ["load", "encode", "decode", "total"]
        if "--quadtree" in flags or "--debug_decode" in flags:
            assert "100%" in port.stdout
    if "--profile" in flags:
        assert "profile trace written to prof" in port.stdout
        assert list((pathlib.Path(port_dir) / "prof").glob("*.pt.trace.json"))
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(os.path.join(port_dir, "result.png"))),
                          np.asarray(Image.open(os.path.join(ref_dir, "result.png"))))


def test_cli_vq_skips_the_classifier_statistics(cli_runs):
    port, _ = cli_runs[("vq3", "port")]
    assert "classifier rejected" not in port.stdout
    assert "classifier rejected" in cli_runs[("log", "port")][0].stdout

