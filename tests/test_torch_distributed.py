"""The port's multi-process pod driver (``python -m
fractencode_tpu_torch.scripts.encode_pod``) on the CPU: two localhost
processes joined over gloo (``parallel.distributed``) run the encode and
decode of one global batch and print the checksums of a single process's run
of the same global config, as tests/test_distributed.py holds the JAX
package's driver; the bring-up fails with its context; and the driver's
mesh arithmetic and output lines.
"""
import os
import re
import socket
import subprocess
import sys

import pytest

from fractencode_tpu_torch.scripts import encode_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # three small processes side by side
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    return env


def _pod(args):
    return [sys.executable, "-m", "fractencode_tpu_torch.scripts.encode_pod",
            "--device", "cpu", *args]


def _checksums(out: str) -> dict:
    found = {}
    for key, pattern in (("encode", r"^checksum: (-?\d+)$"),
                         ("decode", r"^decode checksum: (-?\d+)$")):
        m = re.search(pattern, out, re.M)
        if m:
            found[key] = int(m.group(1))
    return found


@pytest.mark.parametrize("strategy", ["ranges", "domains"])
def test_two_process_pod_matches_single_process(strategy):
    """Two processes of two CPU shards each (a global (2, 2) mesh, one data
    shard a process) against one process of four shards: the same encode
    and decode checksums, exact int64 sums."""
    port = _free_port()
    common = ["--batch", "4", "--size", "64", "--reps", "1", "--n-data", "2",
              "--strategy", strategy, "--decode"]
    procs = [subprocess.Popen(
        _pod([*common, "--shards", "2", "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", "2", "--process-id", str(i), "--init-timeout", "60"]),
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    single = subprocess.run(_pod([*common, "--shards", "4"]), env=_env(), cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    assert all(p.returncode == 0 for p in procs), outs
    assert "multihost up" in outs[0] and "'process_count': 2" in outs[0], outs[0]
    assert "mesh={'data': 2, 'search': 2} hosts=2" in outs[0], outs[0]
    chk2 = _checksums(outs[0])
    assert set(chk2) == {"encode", "decode"}, outs
    assert not _checksums(outs[1]), outs[1]  # only process 0 prints
    assert single.returncode == 0, single.stdout + single.stderr
    assert "mesh={'data': 2, 'search': 2} hosts=1" in single.stdout, single.stdout
    assert _checksums(single.stdout) == chk2


def test_initialize_multihost_failure_is_contextual():
    """An unreachable coordinator fails within the timeout, with the
    coordinator and the process id in the message (the JAX package's
    distributed.py:48-56), not a raw backend traceback."""
    r = subprocess.run(
        _pod(["--batch", "2", "--size", "64", "--reps", "1", "--coordinator", "127.0.0.1:1",
              "--num-processes", "2", "--process-id", "1", "--init-timeout", "2"]),
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    blob = r.stdout + r.stderr
    assert "multi-host initialization failed (coordinator=127.0.0.1:1, pid=1)" in blob, \
        blob[-2000:]


def test_resolve_mesh_shape():
    assert encode_pod.resolve_mesh_shape(8, 2, None) == (2, 4)
    assert encode_pod.resolve_mesh_shape(8, 1, 8) == (8, 1)
    assert encode_pod.resolve_mesh_shape(4, 4, None) == (4, 1)
    assert encode_pod.resolve_mesh_shape(1, 1, None) == (1, 1)
    with pytest.raises(ValueError):
        encode_pod.resolve_mesh_shape(8, 1, 3)


@pytest.mark.parametrize("strategy", ["ranges", "ring"])
def test_encode_pod_single_process(strategy, capsys):
    """main() in this process, on a (2, 4) mesh of CPU shards: the encode
    and decode lines; and without a card and --device cpu it exits 2."""
    rc = encode_pod.main(["--batch", "2", "--size", "64", "--n-data", "2", "--reps", "1",
                          "--decode", "--strategy", strategy, "--device", "cpu",
                          "--shards", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "frames/s" in out and "decode:" in out
    assert f"strategy={strategy} mesh={{'data': 2, 'search': 4}} hosts=1" in out
    assert set(_checksums(out)) == {"encode", "decode"}


def test_encode_pod_without_a_card_exits_2(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert encode_pod.main(["--batch", "2", "--size", "64"]) == 2
    assert "--device cpu" in capsys.readouterr().err
