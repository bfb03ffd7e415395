"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is never served by a stale
build. Builds go to ``paddle_tpu_torch/_build/``
(git-ignored), from the sources in the checkout only. ``load`` builds what
is missing and returns the loaded library; the kernel's module keeps it.
``build`` compiles several sources at once, one nvcc process each, all
started together. ``BUILD_INFO[name]`` keeps each build's wall seconds and
ptxas report (registers, shared memory, spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["BUILD_DIR", "build", "load", "BUILD_INFO"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every ``csrc/<name>.cu`` that has no current build, all
    nvcc processes started together, then wait for each. Raises with the
    compiler's output on the first failure. The caller serializes calls
    for one name."""
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, compiling it first if no
    current build exists."""
    build([name])
    return ctypes.CDLL(str(_target(name)))
