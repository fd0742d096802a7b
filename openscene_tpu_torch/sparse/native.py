"""ctypes bindings of the C++ kernel-map builder (``csrc/kernel_map.cpp``).

The port's counterpart of ``openscene_tpu/sparse/native.py``.  The source is
compiled at first use with ``g++`` into ``build/native/`` beside the package
(``.gitignore`` lists ``build/``), under a name that hashes the source, the
flags and the host's CPU (``-march=native``), so a changed source is
rebuilt and a library built for another CPU is never loaded.
A tiny self test runs in a child process first, so that a binary the host
cannot execute kills the child, not the caller.

Without a compiler (or when the build or the self test fails) the NumPy
builder of ``sparse/geometry.py`` plans alone: :func:`available` is False and
the log says so once.  Both builders give the same arrays bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import sys
import threading
from os.path import abspath, dirname, exists, join
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_PKG = dirname(dirname(abspath(__file__)))
SOURCE = join(_PKG, "csrc", "kernel_map.cpp")
BUILD_DIR = join(dirname(_PKG), "build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SELF_TEST = r'''
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
lib.build_self_plan.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p,
                                ctypes.c_int64, i32p]
coords = np.array([[0, 0, 0, 0], [0, 0, 0, 1]], dtype=np.int32)
offs = np.array([[0, 0, -1], [0, 0, 0], [0, 0, 1]], dtype=np.int32)
fwd = np.full((3, 4), 3, dtype=np.int32)
lib.build_self_plan(coords, 2, 4, offs, 3, fwd)
assert fwd[1, 0] == 0 and fwd[1, 1] == 1, fwd
assert fwd[2, 0] == 1 and fwd[0, 1] == 0, fwd
'''


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (Linux), what
    ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    keys = (b"model name", b"flags", b"Features", b"CPU part")
    seen = {}
    for line in lines:
        key = line.split(b":", 1)[0].strip()
        if key in keys and key not in seen:
            seen[key] = line
    return b"\n".join(seen[k] for k in keys if k in seen)


def library_path() -> str:
    """The library of this source: its name hashes the source, the flags
    and the host CPU."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_id())
    return join(BUILD_DIR, f"kernel_map_{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                   capture_output=True, timeout=300)
    proc = subprocess.run([sys.executable, "-c", _SELF_TEST, tmp],
                          capture_output=True, timeout=120)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"self test failed (rc={proc.returncode}): "
                           f"{proc.stderr.decode(errors='replace')[-2000:]}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log.warning("native kernel-map builder unavailable (%s); the "
                        "NumPy builder plans on the host", e)
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.build_self_plan.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                        i32p, ctypes.c_int64, i32p]
        lib.build_self_plan.restype = None
        lib.build_down_edge.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                        i32p, i32p, i32p, i32p]
        lib.build_down_edge.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """True when the C++ builder is built, self-tested and loaded."""
    return _load() is not None


def build_self_plan_native(coords: np.ndarray, n: int, cap: int,
                           offsets: np.ndarray, fwd: np.ndarray) -> None:
    """Fill ``fwd`` (K, cap) in place at the valid rows' neighbours that
    exist; the caller pre-fills the null rows."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native kernel-map builder is unavailable")
    coords = np.ascontiguousarray(coords[:n], dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    if not (fwd.flags.c_contiguous and fwd.dtype == np.int32
            and fwd.shape == (offsets.shape[0], cap) and n <= cap):
        raise ValueError(f"fwd must be C-contiguous int32 "
                         f"({offsets.shape[0]}, {cap})")
    lib.build_self_plan(coords, n, cap, offsets, offsets.shape[0], fwd)


def build_down_edge_native(coords: np.ndarray, n: int, cap_parent: int):
    """The down edge of ``coords[:n]`` in first-appearance order of the
    parents: ``(parent_coords (n_parent, 4), child_parent (n,),
    child_offset (n,))``.  Raises OverflowError when the parents need more
    than ``cap_parent - 1`` rows."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native kernel-map builder is unavailable")
    coords = np.ascontiguousarray(coords[:n], dtype=np.int32)
    if coords.shape != (n, 4):
        raise ValueError(f"coords must be (n, 4), got {coords.shape}")
    parent_coords = np.empty((cap_parent, 4), dtype=np.int32)
    child_parent = np.empty(n, dtype=np.int32)
    child_offset = np.empty(n, dtype=np.int32)
    # the library also scatters the (8, cap_parent) plan in first-appearance
    # order; the caller rebuilds it in lex order
    fwd = np.empty((8, cap_parent), dtype=np.int32)
    n_parent = lib.build_down_edge(coords, n, cap_parent, parent_coords,
                                   child_parent, child_offset, fwd)
    if n_parent < 0:
        raise OverflowError(f"down edge needs more than {cap_parent - 1} "
                            "parent rows")
    return parent_coords[:n_parent], child_parent, child_offset
