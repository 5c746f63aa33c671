"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each kernel source under ``src/repro_torch/csrc/`` exposes a plain C entry
point.  At first use it is compiled for Hopper (``sm_90a``) into a shared
library under ``build/repro_torch/`` at the root of the checkout, named by
a hash of its source, of every header it includes from ``csrc/`` and of
the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  ``build_all`` compiles several sources at
once, one ``nvcc`` process each.  There is no fallback: a missing
``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: nvcc's diagnostics (``-Xptxas -v``: registers, spills) per library built
#: by this process.
BUILD_LOGS: dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file it includes from ``csrc/``
    (``#include "..."``), transitively, each once."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built: named
    by a hash of the flags and of each source file's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        data = path.read_bytes()
        h.update(f"\0{path.name}\0{len(data)}\0".encode() + data)
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> list[Path]:
    """Compile every ``csrc/<name>.cu`` not built yet, one ``nvcc`` per
    source, all started together; raise if any build fails."""
    outs = [library_path(n) for n in names]
    jobs = []
    try:
        for name, out in zip(names, outs):
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs.append((name, out, tmp, subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu:\n{log}")
                continue
            BUILD_LOGS[name] = log
            os.replace(tmp, out)    # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[0]))
        _LOADED[name] = lib
    return lib
