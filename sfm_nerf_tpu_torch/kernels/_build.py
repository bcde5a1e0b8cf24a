"""Build the CUDA sources under ``csrc/`` on first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``_build/<name>-<hash>.so`` beside this file (git-ignored) and loaded with
ctypes.  The hash covers the source, every header under ``csrc/`` and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded.  ``build_all`` starts one nvcc per source at once.  nvcc's
``-Xptxas -v`` report (registers, shared memory, spills) is kept next to the
library as ``<name>-<hash>.log``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.join(BUILD_DIR, f"{name}-{digest}")
    return src, stem + ".so", stem + ".log"


def build_all(names: Iterable[str]) -> None:
    """Build the libraries of ``names`` that do not exist yet, one nvcc per
    source, all started together.  A failed build raises."""
    running = []
    for name in names:
        src, so, log = _paths(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, so, log))
    errors = []
    for name, proc, tmp, so, log in running:
        out = proc.communicate()[0]
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """nvcc's report for the current source of ``name`` ('' if not built)."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(_paths(name)[1])
        return _libs[name]
