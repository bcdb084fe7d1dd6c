"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) at first use into
``presto_tpu_torch/build/lib<name>.so`` and loaded with ``ctypes``. A
library is rebuilt when its source is newer; every build writes a
per-process temporary file and renames it into place, so concurrent
builders never load a half-written library (``build``, which
``native.py`` shares for the host C++ loops). Nothing here runs at
import time, and a failed build raises: there is no fallback. Each
``nvcc`` run that ``load`` makes is held for the thread that made it
(``take_builds``); the runner counts it as a compile on the device plane
and on the query whose run made it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: per thread, the ms of each ``nvcc`` run of ``load`` not yet taken
_builds = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(src: Path, so: Path, compiler: List[str]) -> bool:
    """Compile ``src`` into the shared library ``so`` with ``compiler``
    (its program and flags) when ``so`` is missing or older than
    ``src``; True when the compiler ran. Raises when the compiler is
    missing or fails."""
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [*compiler, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler[0]} failed for {src.name}:\n{proc.stdout}")
    os.replace(tmp, so)
    return True


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        so = BUILD / f"lib{name}.so"
        # one-time lazy build under the load lock, so two first callers
        # never race one compile
        t0 = time.perf_counter()
        if build(  # lint: disable=blocking-under-lock
            CSRC / f"{name}.cu", so, [_nvcc(), *NVCC_FLAGS]
        ):
            ms = (time.perf_counter() - t0) * 1000.0
            _builds.ms = [*getattr(_builds, "ms", ()), ms]
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib


def take_builds() -> List[float]:
    """The ms of each ``nvcc`` run that ``load`` made on this thread
    since the last take; a cached library's load adds none. The runner
    takes them with each run's control read, so a build shows on the
    query whose run made it."""
    ms = getattr(_builds, "ms", None)
    if not ms:
        return []
    _builds.ms = []
    return ms
