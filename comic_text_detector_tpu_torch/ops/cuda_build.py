"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` call into a plain-C shared
library, all calls started together, on first use; the library's name
carries a hash of its source and flags, so an edited source never loads a
stale build.  Builds go to ``comic_text_detector_tpu_torch/build/``, each
to a temporary name first and then renamed, so that processes building at
once do not collide.  ``native.py`` builds the host library
(``csrc/ctdnative.cpp``) with the same helpers.  Nothing here runs when
the package is imported: a machine without ``nvcc`` imports the port and
runs its plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("cc.cu", "finalize.cu", "scan.cu", "morph.cu", "refine.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def hashed_path(source: str, flags) -> str:
    """Where the library built from ``csrc/<source>`` with ``flags`` lives:
    its name carries a hash of both."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libctd_{stem}_{digest}.so")


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    return hashed_path(source, NVCC_FLAGS)


def start_build(compiler: str, flags, source: str, out: str):
    """Start compiling ``csrc/<source>`` into a temporary name beside
    ``out``; ``finish_build`` waits for it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, os.path.join(CSRC_DIR, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def finish_build(started, out: str) -> str:
    """Wait for a ``start_build``; on success move its library to ``out``
    and return "", else return the compiler's output."""
    proc, tmp = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return log or f"exit code {proc.returncode}"
    os.replace(tmp, out)
    return ""


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns the seconds each build took (0.0 for one that
    was already built); raises if any build fails."""
    t0 = time.perf_counter()
    running = {}
    seconds = {}
    for source in SOURCES:
        out = library_path(source)
        if os.path.exists(out):
            seconds[source] = 0.0
            continue
        running[source] = (start_build(_nvcc(), NVCC_FLAGS, source, out), out)
    failed = {}
    for source, (started, out) in running.items():
        log = finish_build(started, out)
        if log:
            failed[source] = log
            continue
        seconds[source] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(f"{k}:\n{v}" for k, v in failed.items()))
    return seconds


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, building every source first
    if needed."""
    if not os.path.exists(library_path(source)):
        build_all()
    return ctypes.CDLL(library_path(source))
