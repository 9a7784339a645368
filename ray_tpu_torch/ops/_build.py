"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The library's file name carries a hash of its source, of every
header (``*.cuh``) beside it and of the compiler flags, so an edited
source or header rebuilds and an unchanged tree is reused. Libraries land
in ``ray_tpu_torch/_build/`` (listed in ``.gitignore``). Different sources
may build at the same time, from different threads.

Nothing here runs at import time: ``load()`` builds at the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_source_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# source -> nvcc/ptxas report of builds done by this process.
build_log: Dict[str, str] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): "
        "the port's CUDA kernels are built from source at first use")


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR,
                        f"lib{stem}_{digest.hexdigest()[:16]}.so")


def _compile(source: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {source} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: another process sees all or none
    build_log[source] = proc.stdout


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if it is missing."""
    with _lock:
        lock = _source_locks.setdefault(source, threading.Lock())
    with lock:
        if source not in _libs:
            out = _lib_path(source)
            if not os.path.exists(out):
                _compile(source, out)
            _libs[source] = ctypes.CDLL(out)
        return _libs[source]
