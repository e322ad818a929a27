"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled on first use with ``nvcc -shared -Xcompiler -fPIC``
for ``sm_90a`` into ``iris_style_transfer_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with :mod:`ctypes`.  The library name carries a
hash of the source and the flags, so an edited kernel is rebuilt and a
stale library is never loaded.  An ``fcntl`` lock per source serializes
concurrent builders of one library; different sources build in parallel.  A failed build raises with nvcc's stderr; nothing falls back.
The sources expose plain C entry points, so no PyTorch header is compiled
and a build takes seconds.
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

_LOADED: dict[str, ctypes.CDLL] = {}
# per-source build record: {"seconds": float, "log": str, "path": str};
# seconds is 0.0 when an already-built library was loaded
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def load_library(source: str) -> ctypes.CDLL:
    """Build (once) and load ``ops/csrc/<source>``; returns the CDLL."""
    if source in _LOADED:
        return _LOADED[source]
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
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
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True, text=True, check=False,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stderr}")
                os.replace(tmp, so)
                info = {"seconds": time.perf_counter() - t0, "log": proc.stderr, "path": so}
    lib = ctypes.CDLL(so)
    BUILD_INFO[source] = info
    _LOADED[source] = lib
    return lib
