"""The port's host C++ loops, loaded through ctypes.

Two plain C libraries, the port's own copies of the reference's:

- ``csrc/host/genstream.cpp``: the generators' splitmix stream and
  modulo fused into one loop (``gen_uniform``), behind
  ``connectors.tpch._uniform``;
- ``csrc/host/dict_codec.cpp``: the string -> dictionary-id encoder
  (``encode_strings``), behind ``page.encode_strings``.

Each is compiled with ``g++`` at first use into
``presto_tpu_torch/build/lib<name>.so`` by ``kernels.build`` (the same
stale check and atomic rename as the CUDA kernels), never at import.
This is host code, not a device kernel, so a host that cannot build
keeps the numpy path, with the same output bit for bit; ``status()``
says which path runs and why. ``gen_uniform.calls`` and
``encode_strings.calls`` count the calls that ran the native loop.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from presto_tpu_torch import kernels

HOST = kernels.CSRC / "host"
GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

#: below this many rows the ctypes call costs more than the fused loop
#: saves (the reference's threshold)
GEN_MIN_ROWS = 65_536

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_why: Dict[str, str] = {}


def _configure_genstream(lib: ctypes.CDLL) -> None:
    lib.gen_uniform.restype = None
    lib.gen_uniform.argtypes = [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    lib.is_affine.restype = ctypes.c_int64
    lib.is_affine.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 3


def _configure_dict_codec(lib: ctypes.CDLL) -> None:
    lib.dict_encode.restype = ctypes.c_int64
    lib.dict_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]


_CONFIGURE = {
    "genstream": _configure_genstream,
    "dict_codec": _configure_dict_codec,
}


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The library ``name``, built first if stale; None (and the reason
    kept for ``status``) when it cannot be built or loaded."""
    with _lock:
        if name not in _libs:
            so = kernels.BUILD / f"lib{name}.so"
            try:
                kernels.build(HOST / f"{name}.cpp", so, GXX)
                lib = ctypes.CDLL(str(so))
                _CONFIGURE[name](lib)
            except (OSError, RuntimeError) as e:  # no g++, or it failed
                lib = None
                _why[name] = f"{type(e).__name__}: {e}".splitlines()[0]
            _libs[name] = lib
        return _libs[name]


def status() -> str:
    """``"native"`` when both libraries are built and loaded, else
    ``"numpy: <reason>"`` (which library, and why it is missing)."""
    missing = [f"{n}: {_why[n]}" for n in _CONFIGURE if _load(n) is None]
    return "numpy: " + "; ".join(missing) if missing else "native"


def _affine_of(lib: ctypes.CDLL, idx: np.ndarray) -> Optional[Tuple[int, int]]:
    """(start, step) when idx is exactly start + step * arange(n): the
    ends in Python integers, every step in one pass of ``is_affine``."""
    n = len(idx)
    if n == 0:
        return None
    start = int(idx[0])
    if n == 1:
        return start, 1
    step = int(idx[1]) - start
    if int(idx[-1]) != start + step * (n - 1):
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if not lib.is_affine(idx.ctypes.data, n, start, step):
        return None
    return start, step


def gen_uniform(
    tag: int, idx: np.ndarray, lo: int, hi: int
) -> Optional[np.ndarray]:
    """``connectors.tpch._uniform`` by the fused loop: int64 uniform in
    [lo, hi] for each row index. None (the caller takes numpy) for fewer
    than ``GEN_MIN_ROWS`` rows, a sequence that is not affine, or a host
    without the library."""
    if len(idx) < GEN_MIN_ROWS:
        return None
    lib = _load("genstream")
    if lib is None:
        return None
    aff = _affine_of(lib, idx)
    if aff is None:
        return None
    start, step = aff
    out = np.empty(len(idx), dtype=np.int64)
    lib.gen_uniform(tag, start, step, len(idx), lo, hi, out.ctypes.data)
    with _lock:
        gen_uniform.calls += 1
    return out


gen_uniform.calls = 0


def encode_strings(
    values: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """An object array of str/None -> (int32 ids with -1 for NULL, valid
    mask, sorted unique values), as ``page.encode_strings``' numpy path
    computes them; None on a host without the library."""
    lib = _load("dict_codec")
    if lib is None:
        return None
    n = len(values)
    encs = []
    offsets = np.zeros(n + 1, dtype=np.int64)
    valid = np.ones(n, dtype=np.uint8)
    pos = 0
    for i, v in enumerate(values):
        if v is None:
            valid[i] = 0
        else:
            b = str(v).encode("utf-8")
            encs.append(b)
            pos += len(b)
        offsets[i + 1] = pos
    ids = np.empty(n, dtype=np.int32)
    repr_rows = np.empty(max(n, 1), dtype=np.int64)
    n_unique = lib.dict_encode(
        b"".join(encs), offsets.ctypes.data, n, valid.ctypes.data,
        ids.ctypes.data, repr_rows.ctypes.data,
    )
    if n_unique < 0:
        raise RuntimeError(f"dict_encode failed on {n} strings")
    uniq = np.asarray(
        [str(values[int(r)]) for r in repr_rows[:n_unique]], dtype=object
    )
    with _lock:
        encode_strings.calls += 1
    return ids, valid.astype(bool), uniq


encode_strings.calls = 0
