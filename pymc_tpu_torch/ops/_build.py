"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` file has a plain C interface. It is compiled with `nvcc`
for Hopper (`sm_90a`) into a shared library under `<repo>/build/
pymc_tpu_torch/`, named by a hash of its source and flags so that an edit
rebuilds, and loaded with `ctypes`. Nothing is built at import: the first
call that needs a kernel builds it (a few seconds for a file this size).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["NVCC_FLAGS", "library_path", "load_library", "build_seconds", "build_log"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "pymc_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded = {}
# seconds spent in nvcc by this process, per source file name
build_seconds = {}
# ptxas register/shared-memory report of the last build, per source file name
build_log = {}


def library_path(name):
    """Where `csrc/<name>.cu` builds to: keyed by source and flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of pymc_tpu_torch cannot be built"
    )


def load_library(name):
    """ctypes handle of `csrc/<name>.cu`, built first if needed."""
    if name in _loaded:
        return _loaded[name]
    path = library_path(name)
    if not os.path.exists(path):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
