"""Build and load the port's CUDA kernels.

Every ``openscene_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` at
first use into a shared library with a plain C interface, loaded with
``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>_<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source is rebuilt and a stale
library is never loaded.  The build goes
under ``build/kernels/`` beside the package (``.gitignore`` lists
``build/``); ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``.log``.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from os.path import abspath, dirname, exists, join
from typing import Dict, List

_PKG = dirname(dirname(abspath(__file__)))
CSRC = join(_PKG, "csrc")
BUILD_DIR = join(dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                      "bin", "nvcc")):
        if cand and exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME); the port's CUDA kernels are "
                       "built from source at first use")


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``: its name hashes the source, every
    shared header of ``csrc/`` and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [name + ".cu"] + headers:
        with open(join(CSRC, path), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return join(BUILD_DIR, f"{name}_{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists.  Returns
    (process, temporary output, log file) or None."""
    out = library_path(name)
    if exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(out[:-3] + ".log", "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, join(CSRC, name + ".cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, log


def _finish(name: str, job) -> None:
    proc, tmp, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n"
                           f"{build_log(name)}")
    os.replace(tmp, library_path(name))


def build_all() -> Dict[str, str]:
    """Build every source at once (one nvcc each, all started together);
    returns {name: library path}."""
    jobs = {n: _start(n) for n in sources()}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: library_path(n) for n in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    path = library_path(name)[:-3] + ".log"
    if not exists(path):
        return ""
    with open(path) as f:
        return f.read()

