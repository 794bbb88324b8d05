"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
into its own shared library under ``kernels/_build/`` (git-ignored), named
by a hash of the sources, at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

``build_all()`` starts one nvcc per source at once and waits for all of
them.  Libraries are loaded with ctypes; every pointer argument and the
stream are declared ``c_void_p`` so no pointer is cut to 32 bits.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "_build"
SOURCES = ("dsa_decode", "dsa_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of the last build, per source
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)              # atomic: concurrent builds agree


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns seconds spent."""
    t0 = time.monotonic()
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs: List = [(n, *_start(n)) for n in names if not _lib_path(n).exists()]
    try:
        for job in jobs:
            _finish(*job)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
