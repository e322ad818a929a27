"""Build and load the port's native code: the hand-written CUDA kernels
(``ops/csrc/*.cu``) and the host C++ of the frame decoder
(``data/csrc/*.cpp``).

A kernel source is compiled on first use with ``nvcc -shared -Xcompiler
-fPIC`` for ``sm_90a``; a host source with the system's C++ compiler
(``c++ -O3 -shared -fPIC``), which nvcc needs on a CUDA machine anyway.
Both go into ``iris_style_transfer_tpu_torch/_build/`` (listed in
``.gitignore``) and are loaded with :mod:`ctypes`.  The library name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  An ``fcntl`` lock per source
serializes concurrent builds of one library; different sources build in
parallel.  A failed build raises with the compiler's stderr; nothing falls
back.  The sources expose plain C entry points, so no PyTorch header is
compiled and a build takes seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
# per-source build record: {"seconds": float, "log": str, "path": str};
# seconds is 0.0 when an already-built library was loaded
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def _host_cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on the PATH: the frame decoder's helper needs one to build")
    return path


def _build_and_load(key: str, src: str, compiler, flags: tuple[str, ...]) -> ctypes.CDLL:
    """Build ``src`` with ``compiler()`` and ``flags`` into ``_build/``
    unless a library of the same source and flags is there; load it once
    per process under ``key``."""
    if key in _LOADED:
        return _LOADED[key]
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    info = {"seconds": 0.0, "log": "", "path": so}
    if not os.path.exists(so):
        with open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(so):  # another process may have built it meanwhile
                tmp = f"{so}.{os.getpid()}.tmp"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [compiler(), *flags, "-o", tmp, src],
                    capture_output=True, text=True, check=False,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"{os.path.basename(compiler())} failed to build {key}:\n{proc.stderr}")
                os.replace(tmp, so)
                info = {"seconds": time.perf_counter() - t0, "log": proc.stderr, "path": so}
    lib = ctypes.CDLL(so)
    BUILD_INFO[key] = info
    _LOADED[key] = lib
    return lib


def load_library(source: str) -> ctypes.CDLL:
    """Build (once) and load the CUDA kernels of ``ops/csrc/<source>``."""
    return _build_and_load(source, os.path.join(CSRC_DIR, source), _nvcc, NVCC_FLAGS)


def load_host_library(path: str) -> ctypes.CDLL:
    """Build (once) and load the host C++ source at ``path``."""
    return _build_and_load(os.path.relpath(path, _PKG_DIR), path, _host_cxx, HOST_FLAGS)
