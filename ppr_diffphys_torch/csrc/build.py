"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``ppr_diffphys_torch/build/`` (listed
in ``.gitignore``) at first use and loaded with ``ctypes``. The library
file name carries a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded. No PyTorch headers are
included, which keeps a build to seconds.

``--use_fast_math`` is deliberately absent: it turns on approximate
division, sqrt and flush-to-zero, which would move the kernels' results
away from their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels need it")


def library_path(name: str) -> Path:
    # the source, every shared header it may include, and the flags
    src = (SRC_DIR / (name + ".cu")).read_bytes()
    for header in sorted(SRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ("lib%s-%s.so" % (name, h))


def _start(name: str, ptxas_verbose: bool):
    """Start one nvcc (returns (popen, tmp, out) or None when built)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".%d.tmp" % os.getpid())
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if ptxas_verbose:
        cmd.append("-Xptxas=-v")
    cmd += ["-o", str(tmp), str(SRC_DIR / (name + ".cu"))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names, ptxas_verbose: bool = False) -> dict:
    """Compile every named kernel, one nvcc per source, all started together.
    Returns {name: compiler output ('' when the library was already built)}.
    Raises if a build fails."""
    jobs = {n: _start(n, ptxas_verbose) for n in names}
    logs = {}
    for n, job in jobs.items():
        if job is None:
            logs[n] = ""
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s.cu:\n%s" % (n, text))
        os.replace(tmp, out)  # atomic: a half-written library is never loaded
        logs[n] = text
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(status: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError("CUDA kernel %s failed: cudaError_t %d" % (name, status))
