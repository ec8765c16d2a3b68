"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/`` at the repository root, named by a hash
of its source, the headers it includes from ``csrc/`` and the flags, so an
edited source or header rebuilds; it is loaded with ``ctypes``.  The sources
include no PyTorch headers, so a build takes seconds.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load_library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _library(name: str, csrc: Path = _CSRC) -> Path:
    """The library's path: a hash of the source, every header it includes
    from ``csrc`` (transitively) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [f"{name}.cu"], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = (Path(csrc) / path).read_bytes()
        digest.update(path.encode() + b"\0" + text)
        todo += [m.decode() for m in _LOCAL_INCLUDE.findall(text)]
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str, csrc: Path = _CSRC) -> None:
    """Compile the named sources of ``csrc`` (the package's own by default)
    whose builds are missing, one ``nvcc`` each, all at once.  The
    compiler's report (registers, shared memory, spills) is kept beside each
    library as ``<library>.log``."""
    jobs = []
    for name in names:
        lib = _library(name, csrc)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        src = Path(csrc) / f"{name}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{out}")
            continue
        lib.with_name(lib.name + ".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_library(name: str, csrc: Path = _CSRC) -> ctypes.CDLL:
    """Compile ``<csrc>/<name>.cu`` if its build is missing, then load it."""
    build(name, csrc=csrc)
    return ctypes.CDLL(str(_library(name, csrc)))
