"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Libraries land
in ``tpushare_torch/_build/`` (git-ignored), named by a digest of the
source and flags, so an edited source rebuilds and an unchanged one
loads. Nothing is built at import time: the first wrapper call on a
CUDA tensor builds its kernel, or a caller builds all of them at once
with :func:`build_all` (one ``nvcc`` per source, started together).

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("flash_prefill", "paged_decode", "paged_verify", "q8_expert",
           "flash_decode", "flash_bwd")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from tpushare_torch/csrc at "
                       "first use")


def _target(name: str) -> str:
    """Library path keyed by the source, the shared headers and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built.
    Returns (target, Popen or None)."""
    out = _target(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp",
           os.path.join(CSRC, name + ".cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc) -> str:
    """Wait for a started build; keep its compiler log beside the
    library (ptxas -v: registers, shared memory, spills)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    with open(out + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(out + ".tmp", out)
    return log


def build_all(names=KERNELS) -> Dict[str, str]:
    """Build every kernel library in parallel (one nvcc per source,
    all started together). Returns {name: compiler log} ("" for a
    library that was already built)."""
    started: List = [(n, *_start(n)) for n in names]
    return {n: _finish(n, out, proc) for n, out, proc in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        out, proc = _start(name)
        _finish(name, out, proc)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
